"""Trace context: the (run_id, process_index) identity of this process.

A fleet of per-process telemetry files is unmergeable unless each one
says which *run* it belongs to and which *process* wrote it. This module
owns that identity, as the reference package's ``observability/context.py``:

* ``run_id()`` — one id per logical run, shared by every process of a
  multi-process launch. ``TFTPU_RUN_ID`` wins (the launcher exports it to
  the whole fleet); otherwise a random 12-hex id is minted once per
  process. A parent forking workers calls :func:`child_env` to hand them
  its id.
* ``process_index()`` — this process's rank. Resolution order: an
  explicit :func:`bind` > ``TFTPU_PROCESS_INDEX`` > ``RANK`` (what
  ``torchrun`` exports) > the rank of an initialized ``torch.distributed``
  group > 0.

The context is stamped onto every exported telemetry artifact: trace
shards (``events.save``/``save_shard`` metadata), step-log lines and
flight-recorder records.
"""

from __future__ import annotations

import os
import threading
import uuid
from typing import Dict, Optional

__all__ = [
    "run_id",
    "set_run_id",
    "process_index",
    "num_processes",
    "bind",
    "snapshot",
    "child_env",
    "TRACE_HEADER",
    "bind_request",
    "clear_request",
    "current_request",
    "request_scope",
    "trace_header_value",
    "parse_trace_header",
]

_lock = threading.Lock()
_run_id: Optional[str] = None
_process_index: Optional[int] = None
_num_processes: Optional[int] = None


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    if v is None or v == "":
        return None
    try:
        return int(v)
    except ValueError:
        return None


def run_id() -> str:
    """The logical run id (stable for the life of this process)."""
    global _run_id
    with _lock:
        if _run_id is None:
            _run_id = os.environ.get("TFTPU_RUN_ID") or uuid.uuid4().hex[:12]
        return _run_id


def set_run_id(rid: str) -> None:
    """Pin the run id (launchers that mint their own ids)."""
    global _run_id
    if not rid:
        raise ValueError("run_id must be non-empty")
    with _lock:
        _run_id = str(rid)


def _dist() -> Optional[object]:
    """``torch.distributed`` when a process group is initialized, else
    None. Never initializes anything: a telemetry stamp must not."""
    try:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return dist
    except Exception:  # pragma: no cover - exotic builds
        pass
    return None


def process_index() -> int:
    """This process's rank within the run (0 on single-process runs)."""
    with _lock:
        if _process_index is not None:
            return _process_index
    idx = _env_int("TFTPU_PROCESS_INDEX")
    if idx is None:
        idx = _env_int("RANK")
    if idx is None:
        dist = _dist()
        idx = int(dist.get_rank()) if dist is not None else None
    return idx if idx is not None else 0


def num_processes() -> Optional[int]:
    """Process count of the run, when known (None otherwise)."""
    with _lock:
        if _num_processes is not None:
            return _num_processes
    n = _env_int("TFTPU_NUM_PROCESSES") or _env_int("WORLD_SIZE")
    if n is None:
        dist = _dist()
        n = int(dist.get_world_size()) if dist is not None else None
    return n


def bind(
    process_index: Optional[int] = None,
    num_processes: Optional[int] = None,
    run_id: Optional[str] = None,
) -> None:
    """Authoritatively set context fields (launchers and tests); ``None``
    fields are left as they are."""
    global _process_index, _num_processes, _run_id
    with _lock:
        if process_index is not None:
            _process_index = int(process_index)
        if num_processes is not None:
            _num_processes = int(num_processes)
        if run_id is not None:
            _run_id = str(run_id)


def snapshot() -> Dict[str, object]:
    """``{"run_id", "process_index"}`` — the stamp every telemetry
    exporter attaches."""
    return {"run_id": run_id(), "process_index": process_index()}


def child_env(index: Optional[int] = None) -> Dict[str, str]:
    """Env vars a launcher hands a forked/spawned worker so its shards
    join this run: the shared ``TFTPU_RUN_ID`` plus (when ``index`` is
    given) the worker's ``TFTPU_PROCESS_INDEX``."""
    env = {"TFTPU_RUN_ID": run_id()}
    if index is not None:
        env["TFTPU_PROCESS_INDEX"] = str(int(index))
    return env


# ---------------------------------------------------------------------------
# cross-hop request tracing: one request id from ingress through a
# replica's batcher flush
# ---------------------------------------------------------------------------

#: HTTP header carrying ``<request_id>;run=<run_id>`` across a hop.
TRACE_HEADER = "X-Tftpu-Trace"

_request_tls = threading.local()


def bind_request(request_id: Optional[str]) -> None:
    """Bind the current thread's request id (None unbinds)."""
    _request_tls.request_id = request_id or None


def clear_request() -> None:
    _request_tls.request_id = None


def current_request() -> Optional[str]:
    """The request id bound to this thread, or None."""
    return getattr(_request_tls, "request_id", None)


class request_scope:
    """``with request_scope(rid):`` — bind/restore around one request's
    handling on this thread (exception-safe)."""

    def __init__(self, request_id: Optional[str]):
        self._rid = request_id

    def __enter__(self):
        self._prev = current_request()
        bind_request(self._rid)
        return self._rid

    def __exit__(self, *exc):
        bind_request(self._prev)
        return False


def trace_header_value(request_id: str) -> str:
    """Serialize the trace context stamped onto a hop."""
    return f"{request_id};run={run_id()}"


def parse_trace_header(value: Optional[str]):
    """``(request_id, run_id)`` from a received header value; both None
    when the header is absent or garbled (tracing degrades to per-process
    timelines, never to an error)."""
    if not value or not isinstance(value, str) or len(value) > 256:
        return None, None
    head, _, rest = value.partition(";")
    rid = head.strip() or None
    run = None
    for part in rest.split(";"):
        k, _, v = part.partition("=")
        if k.strip() == "run" and v.strip():
            run = v.strip()
    return rid, run


def _reset_for_tests() -> None:
    """Forget bound/minted context (test hygiene only)."""
    global _run_id, _process_index, _num_processes
    with _lock:
        _run_id = None
        _process_index = None
        _num_processes = None
    clear_request()


def _after_fork_in_child() -> None:
    # a parent-bound rank is wrong in a forked worker: drop it so the
    # child re-resolves from its env; the minted run_id is kept (the fork
    # family is one run). No lock: the child is single-threaded here and
    # the parent's lock state is unreliable across fork.
    global _process_index
    _process_index = None


if hasattr(os, "register_at_fork"):  # pragma: no branch - posix
    os.register_at_fork(after_in_child=_after_fork_in_child)
