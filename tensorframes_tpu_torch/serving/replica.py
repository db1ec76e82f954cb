"""Replica-side runner for the serving fleet.

One fleet replica is one ordinary single-process
:class:`~tensorframes_tpu_torch.serving.Server` (push-mode batcher,
warm-up ladder, decode engines) wrapped with the pieces the fleet layer
above needs:

* a **heartbeat publisher** into the fleet rendezvous dir
  (``TFTPU_FLEET_DIR``; :class:`~tensorframes_tpu_torch.resilience.fleet.Heartbeater`),
  started BEFORE warm-up, so a replica loading its model for seconds
  reads alive, not dead;
* a **replica card** — one atomic JSON file publishing this replica's
  HTTP address, pid and attempt: the service-discovery record the router
  scans (heartbeats say *alive*, cards say *where*);
* the **hardened HTTP sidecar** (:func:`~tensorframes_tpu_torch.serving.serve_http`),
  whose ``/healthz`` carries the lifecycle state the router keys on and
  whose ``/admin/drain`` is the rolling-restart hook;
* a supervised **main loop** carrying the ``serving.replica`` kill chaos
  site, and a SIGTERM handler that drains instead of dropping in-flight
  work.

A restarted replica runs no ``nvcc``: the kernel library is
content-hashed under ``build/torch_kernels/`` and loaded as built (its
``/healthz`` reads ``process.kernel_builds == 0``).

``python -m tensorframes_tpu_torch.serving.replica_main --demo`` runs a
deterministic built-in endpoint (``score``: ``y = tanh(x @ w)`` with
seed-0 weights, identical in every replica, so a redriven request gets
the same answer from any survivor).
"""

from __future__ import annotations

import os
import signal
import threading
import time
from typing import Dict, Optional

from ..observability import context as _context
from ..observability import flight as _flight
from ..resilience.faults import kill_point
from ..resilience.fleet import Heartbeater, read_latest_records, write_json_atomic
from ..utils import get_logger
from .http import serve_http
from .server import Server

logger = get_logger(__name__)

__all__ = [
    "publish_card", "read_cards", "card_addr", "serve_replica",
    "demo_server", "main",
]


# ---------------------------------------------------------------------------
# replica cards (service discovery: heartbeats say alive, cards say where)
# ---------------------------------------------------------------------------

def _card_path(directory: str, run_id: str, rank: int) -> str:
    return os.path.join(directory, f"replica_{run_id}_p{rank}.json")


def publish_card(
    directory: str,
    *,
    rank: int,
    addr: str,
    port: int,
    run_id: Optional[str] = None,
    attempt: int = 0,
) -> str:
    """Atomically publish this replica's address card into the rendezvous
    dir (tmp-write + rename, like heartbeats: a router scan never sees a
    torn card). A restarted replica overwrites its rank's card with the
    new ephemeral port."""
    run_id = run_id or _context.run_id()
    rec = {
        "run_id": run_id,
        "rank": int(rank),
        "addr": str(addr),
        "port": int(port),
        "pid": os.getpid(),
        "attempt": int(attempt),
        "ts": time.time(),
    }
    os.makedirs(directory, exist_ok=True)
    return write_json_atomic(_card_path(directory, run_id, rank), rec)


def card_addr(card: dict) -> str:
    """The ``host:port`` a replica card advertises — one formatting of the
    card schema, shared by the router's discovery and the fleet's drain."""
    return f"{card.get('addr', '127.0.0.1')}:{card['port']}"


def read_cards(directory: str, run_id: Optional[str] = None) -> Dict[int, dict]:
    """Every published replica card (``{rank: record}``), filtered to
    ``run_id`` when given: the newest per rank, read as tolerantly as the
    heartbeat files."""
    pattern = f"replica_{run_id}_p*.json" if run_id else "replica_*_p*.json"
    return read_latest_records(directory, pattern, run_id, rank_field="rank")


# ---------------------------------------------------------------------------
# the replica main loop
# ---------------------------------------------------------------------------

def serve_replica(
    server: Server,
    *,
    addr: str = "127.0.0.1",
    port: int = 0,
    fleet_dir: Optional[str] = None,
    rank: Optional[int] = None,
    poll_s: float = 0.05,
    http_kwargs: Optional[dict] = None,
) -> int:
    """Run ``server`` as one fleet replica until it is drained or
    terminated; returns the exit code (0 = clean). Blocks the calling
    thread: this is the replica process's main loop.

    The heartbeat starts **before** ``server.start()`` (warm-up takes
    seconds; the supervisor must read the replica as alive and the router
    reads ``state=starting`` from healthz), the card publishes **after**
    the HTTP port is bound (a card never points at an unbound port).
    SIGTERM drains (in-flight and queued work completes, the state walks
    ``draining`` → ``stopped``); the loop also exits when a ``POST
    /admin/drain`` lands. Either way the last heartbeat is a clean
    ``stopped`` beat. A failure anywhere (warm-up included) returns 1 and
    leaves no ``stopped`` beat: the fleet counts it as a crash. The loop
    carries the ``serving.replica`` kill site: an armed
    :class:`~tensorframes_tpu_torch.resilience.faults.KillRank` SIGKILLs
    this replica."""
    fleet_dir = fleet_dir or os.environ.get("TFTPU_FLEET_DIR") or None
    rank = _context.process_index() if rank is None else int(rank)
    attempt = int(os.environ.get("TFTPU_FLEET_ATTEMPT", "0") or 0)
    hb: Optional[Heartbeater] = None
    if fleet_dir:
        hb = Heartbeater(fleet_dir, rank=rank).start()
    stop_evt = threading.Event()

    def _on_term(signum, frame):  # noqa: ARG001 - signal API
        logger.info("replica %d: SIGTERM — draining", rank)
        stop_evt.set()

    try:
        signal.signal(signal.SIGTERM, _on_term)
    except ValueError:  # pragma: no cover - not the main thread (tests)
        pass
    httpd = None
    rc = 0
    try:
        server.start()
        httpd = serve_http(server, port=port, addr=addr, **(http_kwargs or {}))
        bound_port = int(httpd.server_address[1])
        if fleet_dir:
            publish_card(fleet_dir, rank=rank, addr=addr, port=bound_port, attempt=attempt)
        _flight.record("serving.replica_up", rank=rank, port=bound_port,
                       attempt=attempt, endpoints=server.endpoints())
        logger.info("replica %d up on %s:%d (attempt %d)", rank, addr, bound_port, attempt)
        while True:
            # the kill chaos site: an armed KillRank SIGKILLs this process,
            # the stand-in for an OOM-killed or preempted replica
            kill_point("serving.replica")
            if stop_evt.is_set():
                server.stop(drain=True)
                break
            if server.state == "stopped":
                break  # drained externally (POST /admin/drain)
            time.sleep(poll_s)
    except Exception as e:
        logger.error("replica %d failed: %s", rank, e)
        _flight.record("serving.replica_error", rank=rank, error=type(e).__name__,
                       message=str(e))
        rc = 1
    finally:
        if httpd is not None:
            httpd.shutdown()
        if hb is not None:
            # the final graceful beat only on a clean exit: a crash must
            # read as dead, not departed
            hb.stop(graceful=(rc == 0))
        _flight.record("serving.replica_down", rank=rank, rc=rc)
    return rc


# ---------------------------------------------------------------------------
# the demo replica (what the fleet tests spawn)
# ---------------------------------------------------------------------------

def demo_server(width: int = 8, max_batch_rows: int = 8, max_latency_s: float = 0.002,
                max_queue_rows: int = 1024, device=None) -> Server:
    """A deterministic one-endpoint server: ``score`` computes ``y =
    tanh(x @ w)`` with seed-0 weights (the reference's numpy draw), so
    every replica holds the same weights and a redriven request is
    answered identically by any survivor. ``device`` as every server's
    (default ``config.device``)."""
    import numpy as np
    import torch

    from .. import dtypes
    from ..ops.verbs import compile_program
    from ..schema import ColumnInfo, Schema
    from ..shape import Shape, Unknown
    from .server import ServingConfig

    rng = np.random.default_rng(0)
    w = (rng.standard_normal((width, width)) / np.sqrt(width)).astype(np.float32)
    srv = Server(ServingConfig(max_batch_rows=max_batch_rows, max_latency_s=max_latency_s,
                               max_queue_rows=max_queue_rows), device=device)
    wt = torch.from_numpy(w).to(srv.device)
    holder = type("S", (), {"schema": Schema([
        ColumnInfo("x", dtypes.float32, Shape((Unknown, width)))])})()
    prog = compile_program(lambda x: {"y": torch.tanh(x @ wt)}, holder, block=False,
                           device=srv.device)
    srv.register("score", prog)
    return srv


def main(argv=None) -> int:
    """``python -m tensorframes_tpu_torch.serving.replica_main --demo
    [--device cpu]`` — run the demo replica under the current fleet
    environment (the entry lives in ``replica_main.py``, which the package
    never imports, so ``-m`` does not execute this module twice). The
    replica runs on the card unless ``--device cpu`` asks for the CPU.
    Chaos arming by environment, for drills:
    ``TFTPU_SERVING_CHAOS_KILL_AFTER=<n>`` SIGKILLs this replica after
    *n* main-loop beats, on attempt 0 only (the restarted incarnation must
    survive), when this rank matches ``TFTPU_SERVING_CHAOS_KILL_RANK``
    (default 1)."""
    import argparse
    import contextlib

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--demo", action="store_true",
                        help="serve the built-in deterministic endpoint")
    parser.add_argument("--width", type=int, default=8)
    parser.add_argument("--max-batch-rows", type=int, default=8)
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--addr", default="127.0.0.1")
    parser.add_argument("--device", default=None,
                        help="where the endpoint runs (default: config.device, the card)")
    args = parser.parse_args(argv)
    if not args.demo:
        parser.error("only --demo is runnable standalone; real apps "
                     "call serve_replica(server) from their own worker")
    stack = contextlib.ExitStack()
    kill_after = int(os.environ.get("TFTPU_SERVING_CHAOS_KILL_AFTER", 0))
    kill_rank = int(os.environ.get("TFTPU_SERVING_CHAOS_KILL_RANK", 1))
    attempt = int(os.environ.get("TFTPU_FLEET_ATTEMPT", "0") or 0)
    if kill_after > 0 and attempt == 0 and _context.process_index() == kill_rank:
        from ..resilience import faults

        stack.enter_context(faults.inject("serving.replica", faults.KillRank,
                                          after=kill_after, max_times=1))
    with stack:
        srv = demo_server(width=args.width, max_batch_rows=args.max_batch_rows,
                          device=args.device)
        return serve_replica(srv, addr=args.addr, port=args.port)
