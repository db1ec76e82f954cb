"""Native marshalling layer: C++ passes for the row ⇄ column hot loops.

The reference package's ``native/``: one pass gathers scalar cells out of
row dicts into contiguous buffers (viewed as numpy arrays without a copy,
from which the verbs copy to the GPU), one materializes result rows from
column buffers, one dictionary-encodes key cells, one stacks equal-shape
cells, and one parses unquoted CSV bytes. ``rowpack.cpp`` is the
reference's source, copied into the port.

The extension is compiled on first use with ``g++`` (plain CPython C API,
no pybind11) into ``build/native/`` beside the package, under a name that
hashes the source, the flags and the Python version, so a stale build is
never loaded. A failed build or import raises, naming the compiler's log;
nothing falls back to Python silently. ``TFS_TPU_DISABLE_NATIVE=1`` (the
reference's knob) turns the native passes off, and every call site then
takes its pure-Python path. Cells a pass does not take — dtypes outside
:data:`_DTYPE_CODES`, vector or mixed cells, quoted CSV, delimiters longer
than one byte — take the pure-Python path by documented eligibility.
"""

from __future__ import annotations

import hashlib
import importlib.util
import os
import subprocess
import sys
import sysconfig
import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..utils import get_logger

logger = get_logger(__name__)

_DTYPE_CODES = {
    np.dtype(np.float64): 0,
    np.dtype(np.float32): 1,
    np.dtype(np.int32): 2,
    np.dtype(np.int64): 3,
}

SOURCE = Path(__file__).resolve().parent / "rowpack.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_mod = None
#: Seconds the last build took (None: no build in this process).
build_seconds: Optional[float] = None


def _so_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(FLAGS).encode())
    h.update(sys.version.encode())
    return BUILD_DIR / f"_rowpack-{h.hexdigest()[:16]}.so"


def _log_path() -> Path:
    return BUILD_DIR / "rowpack.log"


def _build(so: Path) -> None:
    """Compile ``rowpack.cpp`` to ``so`` with g++ (to a temporary name,
    renamed into place, so an interrupted build never leaves a truncated
    library under the final name). Raises on failure."""
    import time

    global build_seconds
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(so.name + f".tmp{os.getpid()}")
    cmd = ["g++", *FLAGS, f"-I{sysconfig.get_paths()['include']}",
           str(SOURCE), "-o", str(tmp)]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        _log_path().write_text(f"== {' '.join(cmd)}\n{e}\n")
        raise RuntimeError(
            f"native rowpack build failed ({e}); g++ log: {_log_path()}"
        ) from e
    _log_path().write_text(
        f"== {' '.join(cmd)} (rc {proc.returncode})\n{proc.stdout}{proc.stderr}")
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"native rowpack build failed (g++ rc {proc.returncode}); "
            f"g++ log: {_log_path()}")
    os.replace(tmp, so)
    build_seconds = time.perf_counter() - t0
    logger.info("native rowpack built in %.2fs -> %s", build_seconds, so)


def _load():
    """The extension module, built on first use; None when
    ``TFS_TPU_DISABLE_NATIVE=1``. Raises when it cannot be built or
    imported."""
    global _mod
    if os.environ.get("TFS_TPU_DISABLE_NATIVE", "") == "1":
        return None
    if _mod is not None:
        return _mod
    with _lock:
        if _mod is not None:
            return _mod
        so = _so_path()
        if not so.exists():
            _build(so)
        spec = importlib.util.spec_from_file_location(f"{__name__}._rowpack", so)
        try:
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
        except ImportError as e:
            # a damaged artifact: remove it so the next call rebuilds,
            # but fail this one loudly
            so.unlink(missing_ok=True)
            raise RuntimeError(
                f"native rowpack module {so} failed to import ({e}); it was "
                f"removed and rebuilds on the next call; g++ log: {_log_path()}"
            ) from e
        _mod = mod
        return _mod


def available() -> bool:
    """True unless ``TFS_TPU_DISABLE_NATIVE=1``; builds on first use."""
    return _load() is not None


def supported_dtype(np_dtype) -> bool:
    return np.dtype(np_dtype) in _DTYPE_CODES


def gather_column(
    rows: Sequence[Dict[str, object]], name: str, np_dtype
) -> Optional[np.ndarray]:
    """Pack ``rows[i][name]`` scalars into a 1-D array in one native pass.
    None when disabled; raises on missing keys or cells that do not
    convert (the caller takes the pure path for that column)."""
    mod = _load()
    if mod is None:
        return None
    dtype = np.dtype(np_dtype)
    buf = mod.gather_column(rows, name, _DTYPE_CODES[dtype])
    return np.frombuffer(buf, dtype=dtype)


def dict_encode(values) -> Optional[tuple]:
    """One native hash pass over hashable cells: ``(codes int32 ndarray,
    uniques list)`` with codes in first-appearance order. None when
    disabled."""
    mod = _load()
    if mod is None:
        return None
    buf, uniques = mod.dict_encode(
        values if isinstance(values, (list, tuple)) else list(values)
    )
    return np.frombuffer(buf, dtype=np.int32), uniques


def stack_cells(cells: Sequence[np.ndarray]) -> Optional[np.ndarray]:
    """Stack equal-shape contiguous ndarray cells into ``[len(cells),
    *cell_shape]`` in one memcpy pass. None when disabled, or when the
    first cell is not a contiguous dense array. Mismatched cells raise
    ``ValueError`` (a dtype mismatch too, where ``np.stack`` would
    promote)."""
    mod = _load()
    if mod is None or len(cells) == 0:
        return None
    c0 = cells[0]
    if not isinstance(c0, np.ndarray) or c0.dtype.hasobject:
        return None
    if not c0.flags.c_contiguous:
        return None
    buf = mod.stack_cells(cells)
    return np.frombuffer(buf, dtype=c0.dtype).reshape(
        (len(cells),) + c0.shape
    )


def columns_to_rows(
    names: Sequence[str], arrays: Sequence[np.ndarray]
) -> Optional[List[Dict[str, object]]]:
    """Row dicts from scalar column arrays in one native pass. None when
    disabled, for zero columns, or when a column is not a supported 1-D
    numeric array."""
    mod = _load()
    if mod is None or not names:
        return None
    bufs = []
    codes = []
    for a in arrays:
        a = np.ascontiguousarray(a)
        if a.ndim != 1 or a.dtype not in _DTYPE_CODES:
            return None
        bufs.append(a)
        codes.append(_DTYPE_CODES[a.dtype])
    return mod.scatter_rows(tuple(names), tuple(bufs), tuple(codes))


def parse_csv(body: bytes, delimiter: str, codes: Sequence[int]) -> Optional[tuple]:
    """One pass over unquoted CSV bytes (no header): per column code
    (0 float64, 3 int64, 4 string) a buffer of packed values or a list of
    str, then the row count. None when disabled."""
    mod = _load()
    if mod is None:
        return None
    return mod.parse_csv(body, ord(delimiter), list(codes))
