"""The in-process serving front: ``Server.submit()`` → futures.

The reference package's ``serving/server.py``, with its decode endpoints:
``register_decode`` puts a :class:`~tensorframes_tpu_torch.serving.DecodeEngine`
behind a name, ``submit(name, {"prompt": tokens})`` resolves to
``{"tokens": [1, max_new_tokens]}``, and the server owns the engines'
lifecycle (``start()`` warms each engine's bucket grid before admission
opens; ``stop(drain=True)`` completes queued work), default deadline and
``stats()``.

The server runs on ``device`` (default ``config.device``, ``"cuda"``;
asking for CUDA with no GPU raises). Flush endpoints over programs
(``register``), registered queries (``register_query``), the HTTP
adapter, the router and the fleet wait (ROADMAP queue 1).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional

from ..config import resolve_device
from ..validation import ValidationError
from . import metrics as m
from .batcher import ResultFuture

__all__ = ["ServingConfig", "Server", "UnknownEndpointError"]


class UnknownEndpointError(ValidationError):
    """``submit()`` to an endpoint name that was never registered."""


@dataclasses.dataclass
class ServingConfig:
    """Server-wide knobs (the reference's names and defaults).

    ``default_deadline_s`` — deadline applied when a request carries none
    (None = no deadline); decode endpoints inherit it at registration.
    ``warmup`` — warm each endpoint at ``start()``. The reference's
    coalescing and dedup fields come with flush endpoints.
    """

    default_deadline_s: Optional[float] = None
    warmup: bool = True


class Server:
    """The serving front: ``register_decode()``, ``start()``, ``submit()``."""

    def __init__(self, config: Optional[ServingConfig] = None, device=None):
        self.config = config or ServingConfig()
        self.device = resolve_device(device)
        self._decode: Dict[str, object] = {}  # name -> DecodeEngine
        self._lock = threading.Lock()
        self._running = False
        self._starting = False
        self._draining = False

    # -- registration -------------------------------------------------------

    def register_decode(self, name: str, model_cfg, params, decode_config=None):
        """Register an iterative decode endpoint: a
        :class:`~tensorframes_tpu_torch.serving.DecodeEngine` over
        ``model_cfg``/``params`` with a paged int8 KV pool, on the server's
        device. On a running server the engine warms and starts at once."""
        from .decode import DecodeConfig, DecodeEngine

        if not name or "/" in name:
            raise ValueError(f"endpoint name must be non-empty and '/'-free, got {name!r}")
        cfg = decode_config or DecodeConfig()
        if cfg.default_deadline_s is None:
            cfg = dataclasses.replace(cfg, default_deadline_s=self.config.default_deadline_s)
        cfg = dataclasses.replace(cfg, warmup=cfg.warmup and self.config.warmup)
        engine = DecodeEngine(name, model_cfg, params, cfg, device=self.device)
        with self._lock:
            if name in self._decode:
                raise ValueError(f"endpoint {name!r} already registered")
            self._decode[name] = engine
            live = self._running or self._starting
        if live:
            try:
                engine.start()
            except BaseException:
                with self._lock:
                    self._decode.pop(name, None)
                engine.stop(drain=False)
                raise
        return engine

    def endpoints(self) -> List[str]:
        with self._lock:
            return sorted(self._decode)

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "Server":
        """Warm and start every engine, then open admission."""
        with self._lock:
            if self._running or self._starting:
                return self
            self._starting = True
            engines = list(self._decode.values())
        try:
            for eng in engines:
                eng.start()
            with self._lock:
                self._running = True
        finally:
            with self._lock:
                self._starting = False
        return self

    def stop(self, drain: bool = True, timeout: Optional[float] = None) -> None:
        """Close admission and stop the engines: ``drain=True`` completes
        every queued request first, ``drain=False`` fails them. Submits
        during and after shutdown get a counted ``closed`` rejection."""
        with self._lock:
            if not self._running and not self._decode:
                return
            self._running = False
            self._draining = drain
            engines = list(self._decode.values())
        try:
            for eng in engines:
                eng.stop(drain=drain, timeout=timeout)
        finally:
            with self._lock:
                self._draining = False

    def __enter__(self) -> "Server":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop(drain=True)

    @property
    def running(self) -> bool:
        return self._running

    @property
    def state(self) -> str:
        """``starting`` | ``running`` | ``draining`` | ``stopped``."""
        with self._lock:
            if self._starting:
                return "starting"
            if self._draining:
                return "draining"
            return "running" if self._running else "stopped"

    # -- request path -------------------------------------------------------

    def submit(self, endpoint: str, feeds, deadline_s: Optional[float] = None) -> ResultFuture:
        """Admit one request; returns a :class:`ResultFuture`. Raises
        :class:`RejectedError` on backpressure/closed/oversize (never
        blocks), :class:`ValidationError` on malformed feeds and
        :class:`UnknownEndpointError` on an unknown name."""
        eng = self._decode.get(endpoint)
        if eng is None:
            raise UnknownEndpointError(
                f"unknown endpoint {endpoint!r}; registered: {self.endpoints()}"
            )
        return eng.submit(feeds, deadline_s=deadline_s)

    def call(self, endpoint: str, feeds, deadline_s: Optional[float] = None,
             timeout: Optional[float] = None):
        """Synchronous convenience: ``submit(...).result(timeout)``."""
        return self.submit(endpoint, feeds, deadline_s).result(timeout)

    # -- introspection ------------------------------------------------------

    def stats(self) -> Dict[str, object]:
        """Queue depths, THIS server's admission counters, per-endpoint
        latency quantiles and decode state."""
        with self._lock:
            engines = dict(self._decode)
            running = self._running
        state = self.state
        queues: Dict[str, int] = {}
        latency: Dict[str, Dict[str, float]] = {}
        decode: Dict[str, Dict[str, int]] = {}
        totals = {
            "admitted_requests": 0,
            "admitted_rows": 0,
            "rejected": {r: 0 for r in m.REJECT_REASONS},
            "deadline_expired": 0,
        }
        for name, eng in engines.items():
            snap = eng.counters()
            queues[name] = snap["queued_rows"]
            totals["admitted_requests"] += snap["admitted_requests"]
            totals["admitted_rows"] += snap["admitted_rows"]
            for r, c in snap["rejected"].items():
                totals["rejected"][r] += c
            totals["deadline_expired"] += snap["deadline_expired"]
            if snap.get("latency"):
                latency[name] = snap["latency"]
            decode[name] = {
                "running_slots": snap["running_slots"],
                "free_pages": snap["free_pages"],
            }
        out = {
            "running": running,
            "state": state,
            "endpoints": sorted(queues),
            "queued_rows": queues,
            "latency": latency,
            **totals,
        }
        if decode:
            out["decode"] = decode
        return out
