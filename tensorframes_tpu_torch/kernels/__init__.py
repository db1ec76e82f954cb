"""Hand-written CUDA kernels for Hopper (``sm_90a``).

Each kernel replaces one Pallas TPU kernel of the reference package. On
the verbs' path:

* ``segment_reduce`` (:mod:`.segment_reduce`) — every (column, op) of a
  keyed ``aggregate`` in one launch pair: sum/mean (f32 or exact i32
  accumulation), min/max, and the count table of means. One coalesced
  pass: row chunks streamed by bulk copies, each folded into a
  shared-memory table (a row alone in its segment in a tile by its own
  thread, the others by the warp that owns the segment, in row order),
  then the chunks' tables folded in chunk order; no float atomics, the
  order of every sum a function of the feed alone
  (:func:`.segment_reduce.segment_sum_in_kernel_order` reproduces it);
* ``segment_sum`` (:func:`tensorframes_tpu_torch.ops.segment.segment_sum_kernel`)
  — the single-op segment sum of the per-op ``aggregate`` route, built
  from the same device code;
* ``ragged_gather`` (:mod:`.ragged_gather`) — device-side staging of
  ragged ``map_rows`` rows out of one flat buffer: every shape group of
  a call in one launch (one per 256 MiB of padded output), threads on
  the output's 16-byte chunks.

On the decode server's path:

* ``decode_attention`` (:mod:`.decode_attention`) — one layer's paged
  int8-KV attention for every running slot;
* ``int8_matmul`` (:func:`tensorframes_tpu_torch.ops.quantize.matmul_int8`)
  — ``x @`` an int8 per-output-channel weight, every weight product of
  the quantized model, in two builds: bf16 ``x`` whose rows, and the
  weight's, a tensor map can take goes to the tensor-core kernel, split
  over k across a thread-block cluster (``csrc/int8_matmul_mma.cu``),
  f32 and the rest to the scalar one (``csrc/int8_matmul.cu``), by
  :func:`tensorframes_tpu_torch.ops.quantize.int8_matmul_build`.

On the encoder's path (``attention_impl="flash"``, BERT through
``map_rows``/``map_blocks``):

* ``flash_attention`` (:mod:`.flash_attention`) — attention forward with
  an online softmax, one launch per layer, in two builds: bf16 inputs
  whose rows it can copy 16 bytes at a time go to the tensor-core kernel
  (``csrc/flash_attention_mma.cu``), everything else to the scalar one
  (``csrc/flash_attention.cu``), by
  :func:`.flash_attention.forward_build`; ``int8_matmul`` again when the
  weights are quantized.

On the training path (``attention_impl="flash"``, gpt_small through
``training.train_on_frame``), the flash forward again (it then also
writes each row's softmax statistics) and its gradient:

* ``flash_attention_bwd_dkv`` and ``flash_attention_bwd_dq``
  (:mod:`.flash_attention`, both reached from the flash op's gradient,
  :func:`.flash_attention.flash_attention_backward`) — dK/dV and dQ, one
  launch each per layer per step, in two builds each: bf16 inputs whose
  rows it can copy 16 bytes at a time go to the tensor-core kernels
  (``csrc/flash_attention_bwd_mma.cu``), everything else to the scalar
  ones (``csrc/flash_attention_bwd.cu``), by
  :func:`.flash_attention.backward_build`.

The encoder's two wrappers are custom ops (``tftpu::``) with a fake
implementation for shape analysis and a vmap rule that folds the vmapped
dim into the kernel's batch, so ``map_rows`` launches each kernel once
per layer per block; the flash op's gradient calls two more custom ops,
one per backward kernel.

The sources live in ``tensorframes_tpu_torch/csrc/``. They compile with
one ``nvcc`` call each, all at once, linked into one shared library with
a plain C interface, on first use, under ``build/torch_kernels/`` beside the package, and load
through ``ctypes``. Every C entry point launches on the caller's stream,
allocates nothing, and returns ``cudaGetLastError()``; the Python
wrappers check device, dtype, shape and contiguity first and raise on a
nonzero return.
Nothing here falls back: a build or launch failure raises.

On CPU tensors each wrapper computes its plain PyTorch version instead —
that is how the CPU tests run; a CUDA tensor always launches the kernel.
Every launch adds one to the kernel's plain-integer count
(:data:`LAUNCHES`) and to ``tftpu_kernels_dispatch_total{kernel=}``; a
launch of one of a kernel's builds (:data:`BUILDS`) also adds one to
that build's count (:meth:`LaunchCounts.builds`).
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
_SOURCES = (
    "segment_reduce.cu", "ragged_gather.cu", "decode_attention.cu", "int8_matmul.cu",
    "int8_matmul_mma.cu", "flash_attention.cu", "flash_attention_mma.cu",
    "flash_attention_bwd.cu", "flash_attention_bwd_mma.cu",
)
_HEADERS = ("mma_common.cuh",)  # shared device helpers, included by four of the sources
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


@dataclasses.dataclass(frozen=True)
class KernelInfo:
    name: str
    source: str     # CUDA source, relative to the repository root
    replaces: str   # the Pallas kernel it replaces, file:line (jax/...: upstream JAX's)
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
            "tensorframes_tpu_torch.kernels.ragged_gather.ragged_gather_groups",
        ),
        KernelInfo(
            "decode_attention",
            "tensorframes_tpu_torch/csrc/decode_attention.cu",
            "tensorframes_tpu/kernels/decode_attention.py:39",
            "tensorframes_tpu_torch.kernels.decode_attention.paged_decode_attention",
        ),
        KernelInfo(
            "int8_matmul",  # the tensor-core build; the scalar one is csrc/int8_matmul.cu
            "tensorframes_tpu_torch/csrc/int8_matmul_mma.cu",
            "tensorframes_tpu/ops/quantize.py:130",
            "tensorframes_tpu_torch.ops.quantize.matmul_int8",
        ),
        KernelInfo(
            "flash_attention",  # the tensor-core build; the scalar one is csrc/flash_attention.cu
            "tensorframes_tpu_torch/csrc/flash_attention_mma.cu",
            "tensorframes_tpu/ops/attention.py:132",
            "tensorframes_tpu_torch.kernels.flash_attention.flash_attention",
        ),
        KernelInfo(
            "flash_attention_bwd_dkv",  # tensor cores; scalar: csrc/flash_attention_bwd.cu
            "tensorframes_tpu_torch/csrc/flash_attention_bwd_mma.cu",
            "jax/experimental/pallas/ops/tpu/flash_attention.py:941",
            "tensorframes_tpu_torch.kernels.flash_attention.flash_attention_bwd_dkv",
        ),
        KernelInfo(
            "flash_attention_bwd_dq",  # tensor cores; scalar: csrc/flash_attention_bwd.cu
            "tensorframes_tpu_torch/csrc/flash_attention_bwd_mma.cu",
            "jax/experimental/pallas/ops/tpu/flash_attention.py:1287",
            "tensorframes_tpu_torch.kernels.flash_attention.flash_attention_bwd_dq",
        ),
    )
}

# builds of a kernel counted on their own as well: build -> kernel
BUILDS = {
    "int8_matmul_mma": "int8_matmul",
    "flash_attention_mma": "flash_attention",
    "flash_attention_bwd_dkv_mma": "flash_attention_bwd_dkv",
    "flash_attention_bwd_dq_mma": "flash_attention_bwd_dq",
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
    tensors do not count). A launch of a build in :data:`BUILDS` counts
    under the kernel and under the build."""

    def __init__(self):
        self._lock = threading.Lock()
        self._n = {k: 0 for k in KERNELS}
        self._builds = {b: 0 for b in BUILDS}

    def note(self, kernel: str, build: Optional[str] = None) -> None:
        with self._lock:
            self._n[kernel] += 1
            if build is not None:
                self._builds[build] += 1
        DISPATCHES[kernel].inc()

    def reset(self) -> None:
        with self._lock:
            for counts in (self._n, self._builds):
                for k in counts:
                    counts[k] = 0

    def snapshot(self) -> Dict[str, int]:
        """Launches per kernel, every build included."""
        with self._lock:
            return dict(self._n)

    def builds(self) -> Dict[str, int]:
        """Launches per build of :data:`BUILDS`."""
        with self._lock:
            return dict(self._builds)


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


def _build() -> Path:
    """Compile every source into an object with one ``nvcc`` each, all
    started together, link them into one shared library, then move it
    into place; reuse it while the sources and flags are unchanged. The
    compilers' output goes to :data:`BUILD_LOG`, in source order."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in (*_SOURCES, *_HEADERS):
        h.update((CSRC / s).read_bytes())
    so = BUILD_DIR / f"libtftorch_kernels-{h.hexdigest()[:16]}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    objs = [tmp.with_name(f"{tmp.name}.{Path(s).stem}.o") for s in _SOURCES]
    cmds = [[_nvcc(), *NVCC_FLAGS, "-c", str(CSRC / s), "-o", str(o)]
            for s, o in zip(_SOURCES, objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    runs = [(c, p.communicate()[0], p.returncode) for c, p in zip(cmds, procs)]
    link = [_nvcc(), *NVCC_FLAGS, "-shared", *(str(o) for o in objs), "-o", str(tmp)]
    if all(rc == 0 for _, _, rc in runs):
        res = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        runs.append((link, res.stdout, res.returncode))
    BUILD_LOG.write_text("".join(f"== {' '.join(c)} (rc {rc})\n{out}" for c, out, rc in runs))
    for o in objs:
        o.unlink(missing_ok=True)
    failed = [(c, out, rc) for c, out, rc in runs if rc != 0]
    if failed:
        tmp.unlink(missing_ok=True)
        c, out, rc = failed[0]
        raise RuntimeError(f"nvcc failed (rc {rc}): {' '.join(c)}\n{out}")
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
            lib.tft_ragged_gather.argtypes = [vp, i64, vp, vp, i32, i64, i32, vp, i32, vp]
            lib.tft_paged_decode_attention.argtypes = [
                vp, i64, i64, vp, vp, vp, vp, vp, vp, vp,
                i32, i32, i32, i32, i32, i32, i32, i32, ctypes.c_float, i32, i32, vp,
            ]
            lib.tft_int8_matmul.argtypes = [vp, vp, vp, vp, i32, i32, i32, i32, i32, vp]
            lib.tft_int8_matmul_mma.argtypes = [vp, vp, vp, vp, i32, i32, i32, i32, i32, vp]
            lib.tft_flash_attention.argtypes = [
                vp, vp, vp, vp, vp, vp, i32, i32, i32, i32, i32, *([i64] * 12),
                ctypes.c_float, i32, i32, i32, vp,
            ]
            lib.tft_flash_attention_mma.argtypes = [
                vp, vp, vp, vp, vp, vp, i32, i32, i32, i32, i32, *([i64] * 12),
                ctypes.c_float, i32, i32, vp,
            ]
            lib.tft_flash_attention_bwd_dkv.argtypes = [
                *([vp] * 9), i32, i32, i32, i32, i32, *([i64] * 18),
                ctypes.c_float, i32, i32, i32, vp,
            ]
            lib.tft_flash_attention_bwd_dq.argtypes = [
                *([vp] * 8), i32, i32, i32, i32, i32, *([i64] * 15),
                ctypes.c_float, i32, i32, i32, vp,
            ]
            lib.tft_flash_attention_bwd_dkv_mma.argtypes = [
                *([vp] * 9), i32, i32, i32, i32, i32, *([i64] * 18),
                ctypes.c_float, i32, i32, vp,
            ]
            lib.tft_flash_attention_bwd_dq_mma.argtypes = [
                *([vp] * 8), i32, i32, i32, i32, i32, *([i64] * 15),
                ctypes.c_float, i32, i32, vp,
            ]
            for f in (lib.tft_segment_reduce, lib.tft_segment_sum,
                      lib.tft_ragged_gather, lib.tft_paged_decode_attention,
                      lib.tft_int8_matmul, lib.tft_int8_matmul_mma,
                      lib.tft_flash_attention, lib.tft_flash_attention_mma,
                      lib.tft_flash_attention_bwd_dkv, lib.tft_flash_attention_bwd_dq,
                      lib.tft_flash_attention_bwd_dkv_mma, lib.tft_flash_attention_bwd_dq_mma):
                f.restype = ctypes.c_int
            lib.tft_error_string.argtypes = [ctypes.c_int]
            lib.tft_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(kernel: str, rc: int, build: Optional[str] = None) -> None:
    """Raise if a C entry point returned a CUDA error; else count the
    launch (and the build's, when one is named)."""
    if rc != 0:
        msg = library().tft_error_string(rc).decode()
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {rc} ({msg})")
    LAUNCHES.note(kernel, build)


def launch_target(device) -> tuple:
    """The ``(device index, stream)`` pair a C entry point launches on:
    the tensor's CUDA device and PyTorch's current stream there."""
    import torch

    index = device.index if device.index is not None else torch.cuda.current_device()
    return index, ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
