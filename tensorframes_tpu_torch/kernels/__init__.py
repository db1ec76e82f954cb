"""Hand-written CUDA kernels for Hopper (``sm_90a``) on the verbs' path.

Each kernel replaces one Pallas TPU kernel of the reference package:

* ``segment_reduce`` (:mod:`.segment_reduce`) — every (column, op) of a
  keyed ``aggregate`` in one launch pair: sum/mean (f32 or exact i32
  accumulation), min/max, and the count table of means;
* ``segment_sum`` (:func:`tensorframes_tpu_torch.ops.segment.segment_sum_kernel`)
  — the single-op segment sum of the per-op ``aggregate`` route, built
  from the same device code;
* ``ragged_gather`` (:mod:`.ragged_gather`) — device-side staging of
  ragged ``map_rows`` rows out of one flat buffer.

The sources live in ``tensorframes_tpu_torch/csrc/``. They compile with
``nvcc`` into one shared library with a plain C interface, on first use,
under ``build/torch_kernels/`` beside the package (one ``nvcc -c`` per
source, all started together, then one link), and load through
``ctypes``. Every C entry point launches on the caller's stream, allocates
nothing, and returns ``cudaGetLastError()``; the Python wrappers check
device, dtype, shape and contiguity first and raise on a nonzero return.
Nothing here falls back: a build or launch failure raises.

On CPU tensors each wrapper computes its plain PyTorch version instead —
that is how the CPU tests run; a CUDA tensor always launches the kernel.
Every launch adds one to the kernel's plain-integer count
(:data:`LAUNCHES`) and to ``tftpu_kernels_dispatch_total{kernel=}``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

from ..observability.metrics import counter as _counter

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
_SOURCES = ("segment_reduce.cu", "ragged_gather.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


@dataclasses.dataclass(frozen=True)
class KernelInfo:
    name: str
    source: str     # CUDA source, relative to the repository root
    replaces: str   # the reference package's Pallas kernel, file:line
    wrapper: str    # the Python entry point that launches it


KERNELS: Dict[str, KernelInfo] = {
    k.name: k for k in (
        KernelInfo(
            "segment_reduce",
            "tensorframes_tpu_torch/csrc/segment_reduce.cu",
            "tensorframes_tpu/kernels/segment_reduce.py:335",
            "tensorframes_tpu_torch.kernels.segment_reduce.segment_reduce",
        ),
        KernelInfo(
            "segment_sum",
            "tensorframes_tpu_torch/csrc/segment_reduce.cu",
            "tensorframes_tpu/ops/segment.py:70",
            "tensorframes_tpu_torch.ops.segment.segment_sum_kernel",
        ),
        KernelInfo(
            "ragged_gather",
            "tensorframes_tpu_torch/csrc/ragged_gather.cu",
            "tensorframes_tpu/kernels/ragged_gather.py:80",
            "tensorframes_tpu_torch.kernels.ragged_gather.ragged_gather_rows",
        ),
    )
}

DISPATCHES = {
    k: _counter(
        "tftpu_kernels_dispatch_total",
        "Hand-written kernel launches, by kernel",
        labels={"kernel": k},
    )
    for k in KERNELS
}


class LaunchCounts:
    """Plain-integer launch count per kernel: a wrapper adds one where it
    launches its kernel, and nowhere else (plain-version calls on CPU
    tensors do not count)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._n = {k: 0 for k in KERNELS}

    def note(self, kernel: str) -> None:
        with self._lock:
            self._n[kernel] += 1
        DISPATCHES[kernel].inc()

    def reset(self) -> None:
        with self._lock:
            for k in self._n:
                self._n[k] = 0

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._n)


LAUNCHES = LaunchCounts()

_lib_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
BUILD_LOG = BUILD_DIR / "nvcc.log"


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
        "cannot be built"
    )


def _run(*cmd) -> subprocess.Popen:
    return subprocess.Popen(
        [str(c) for c in cmd], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )


def _build() -> Path:
    """Compile the sources (one ``nvcc`` each, started together, so the
    build time is the slowest source's as sources are added) and link one
    shared library; reuse it while the sources and flags are unchanged."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in _SOURCES:
        h.update((CSRC / s).read_bytes())
    so = BUILD_DIR / f"libtftorch_kernels-{h.hexdigest()[:16]}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tmp = _nvcc(), so.with_suffix(f".{os.getpid()}.tmp")
    objs = [tmp.with_name(f"{Path(s).stem}-{os.getpid()}.o") for s in _SOURCES]
    steps = [(f"nvcc {s}", _run(nvcc, *NVCC_FLAGS, "-c", CSRC / s, "-o", o))
             for s, o in zip(_SOURCES, objs)]
    steps = [(what, p, p.communicate()[0]) for what, p in steps]
    if all(p.returncode == 0 for _, p, _ in steps):
        link = _run(nvcc, *NVCC_FLAGS[:2], "-shared", *objs, "-o", tmp)
        steps.append(("link", link, link.communicate()[0]))
    BUILD_LOG.write_text("\n".join(f"== {w} (rc {p.returncode})\n{out}" for w, p, out in steps))
    for o in objs:
        o.unlink(missing_ok=True)
    failed = [(w, out) for w, p, out in steps if p.returncode != 0]
    if failed:
        raise RuntimeError(f"{failed[0][0]} failed:\n{failed[0][1]}")
    os.replace(tmp, so)
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build()))
            vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
            ip = ctypes.POINTER(ctypes.c_int)
            vpp = ctypes.POINTER(ctypes.c_void_p)
            lib.tft_segment_reduce.argtypes = [
                vp, i64, i32, i32, vpp, ip, ip, ip, i32, i32, vp, vp, i32, vp,
            ]
            lib.tft_segment_sum.argtypes = [
                vp, i64, i32, vp, i32, i32, i32, vp, vp, i32, vp,
            ]
            lib.tft_ragged_gather.argtypes = [
                vp, i64, vp, i32, i32, i32, vp, i32, vp,
            ]
            for f in (lib.tft_segment_reduce, lib.tft_segment_sum,
                      lib.tft_ragged_gather):
                f.restype = ctypes.c_int
            lib.tft_error_string.argtypes = [ctypes.c_int]
            lib.tft_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(kernel: str, rc: int) -> None:
    """Raise if a C entry point returned a CUDA error; else count the
    launch."""
    if rc != 0:
        msg = library().tft_error_string(rc).decode()
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {rc} ({msg})")
    LAUNCHES.note(kernel)


def launch_target(device) -> tuple:
    """The ``(device index, stream)`` pair a C entry point launches on:
    the tensor's CUDA device and PyTorch's current stream there."""
    import torch

    index = device.index if device.index is not None else torch.cuda.current_device()
    return index, ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
