"""Fleet router: one fault-tolerant ingress over N replica servers.

A single HTTP ingress that owns **placement** (which live replica gets
the next request) and **failure** (what happens to a request whose
replica died mid-flight), while each replica below it keeps its own fast
path — warmed bucket ladder, push-mode batcher, no new dispatch key in
steady state — untouched.

Three contracts, stated once:

* **placement** — dispatch goes to the live ``state=running`` replica
  with the smallest load (scraped ``queued_rows`` from each replica's
  healthz, plus this router's own in-flight count per replica, which
  covers the scrape staleness window). A replica that is ``starting``,
  ``draining``, ``stopped``, heartbeat-stale, or scrape-dead is **never**
  picked: readiness and heartbeats are one verdict.
* **redrive** — a dispatch whose replica fails mid-request (connection
  refused/reset/dropped, or a ``closed`` 503 from a draining race) is
  re-dispatched to a surviving replica under the request's ORIGINAL
  deadline, carrying the same **idempotency key**: a replica that
  already admitted the first attempt joins it to the original future
  (``Server.submit`` dedup) instead of executing twice. Every admitted
  ingress request gets exactly one response — success or a counted
  error, never silence.
* **boundedness** — no live replica → counted 503 ``no_replica``; the
  deadline lapsing mid-redrive → counted 504 ``deadline``; a request
  without a deadline gets a bounded redrive budget instead of an
  unbounded retry loop.

The ``router.dispatch`` fault site sits on the dispatch path: an
injected ``Delay`` stalls a proxied dispatch (deadline-expiry chaos),
any other injected error fails the attempt exactly like a replica
connection failure.

Observability: ``tftpu_router_*`` metrics (serving/metrics.py), the
flight-recorder ``router.*`` family (``router.start`` / ``redrive`` /
``replica_dead`` / ``replica_ready`` / ``no_replica`` / ``stop``) and,
with the tracer on, one ``router.request`` span per ingress request whose
``request_id`` (the idempotency key, also sent in the ``X-Tftpu-Trace``
header) joins the serving replica's spans in a merged timeline.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import os
import threading
import time
from typing import Dict, Optional, Tuple

from ..config import get_config
from ..observability import context as _context
from ..observability import events as _events
from ..observability import flight as _flight
from ..resilience.faults import delay_point
from ..resilience.fleet import read_heartbeats
from ..utils import get_logger
from . import metrics as m
from .http import (
    DEFAULT_MAX_BODY_BYTES,
    DEFAULT_MAX_CONNECTIONS,
    DEFAULT_READ_TIMEOUT_S,
    make_hardened_http_server,
    parse_json_object,
    read_bounded_body,
    reply_json,
)
from .replica import card_addr, read_cards

logger = get_logger(__name__)

__all__ = ["RouterConfig", "ReplicaHandle", "Router", "http_json"]


@dataclasses.dataclass
class RouterConfig:
    """Router knobs. ``poll_s`` — healthz scrape + heartbeat/card scan
    cadence (the staleness bound on queue depths and readiness).
    ``scrape_timeout_s`` — per-scrape HTTP timeout. ``scrape_fails_dead``
    — consecutive scrape failures before a replica is marked dead
    (heartbeat staleness and a fleet ``mark_dead`` act immediately).
    ``default_deadline_s`` — applied to ingress requests that carry
    none (``None`` = no deadline; such requests get
    ``redrive_budget`` dispatch attempts instead of a clock).
    ``redrive_wait_s`` — pause before re-picking when every known
    replica is excluded (a restarting replica may rejoin)."""

    poll_s: float = 0.1
    scrape_timeout_s: float = 2.0
    scrape_fails_dead: int = 3
    heartbeat_timeout_s: Optional[float] = None
    default_deadline_s: Optional[float] = None
    redrive_budget: int = 4
    redrive_wait_s: float = 0.05
    no_replica_wait_s: float = 2.0
    #: HTTP timeout for DEADLINE-LESS dispatches (a deadline-carrying
    #: request is bounded by its own remaining budget instead). Large
    #: on purpose: a long-but-legitimate batch must not be aborted and
    #: re-executed; a wedged replica is caught by heartbeats/scrapes,
    #: not this bound.
    dispatch_timeout_s: float = 300.0
    max_body_bytes: int = DEFAULT_MAX_BODY_BYTES
    read_timeout_s: Optional[float] = DEFAULT_READ_TIMEOUT_S
    max_connections: int = DEFAULT_MAX_CONNECTIONS


class ReplicaHandle:
    """The router's view of one replica: where it is, whether it is
    routable, and how loaded it looks."""

    def __init__(self, rank: int, addr: str):
        self.rank = int(rank)
        self.addr = str(addr)  # "host:port"
        self.state = "unknown"  # scraped lifecycle state, or unknown/dead
        self.queued_rows = 0
        self.inflight = 0  # this router's not-yet-answered dispatches
        self.scrape_fails = 0
        self.scraping = False  # a scrape of this handle is in flight
        #: has this replica EVER scraped as running? Gates the
        #: scrape-failure dead verdict: a freshly-spawned replica is
        #: connection-refused for seconds while it warms (not dead),
        #: but one that WAS serving and stops answering is.
        self.ever_running = False
        self.beat_age_s: Optional[float] = None
        self.pid: Optional[int] = None
        self.attempt = 0
        self.dead_reason: Optional[str] = None
        self.process: Dict[str, int] = {}  # process counters (dispatch keys, kernel builds), last scrape

    @property
    def routable(self) -> bool:
        return self.state == "running"

    def load(self) -> int:
        return self.queued_rows + self.inflight

    def snapshot(self) -> dict:
        return {
            "rank": self.rank, "addr": self.addr, "state": self.state,
            "queued_rows": self.queued_rows, "inflight": self.inflight,
            "attempt": self.attempt, "pid": self.pid,
            "beat_age_s": self.beat_age_s,
            "dead_reason": self.dead_reason,
            "ever_running": self.ever_running,
            "process": dict(self.process),
        }


class Router:
    """The ingress: keep a live replica registry, pick by queue depth,
    redrive on failure. Discovery modes compose: a static ``replicas``
    list/dict of ``host:port`` addresses, and/or a fleet rendezvous
    ``fleet_dir`` whose replica cards + heartbeats are scanned every
    poll (the :class:`~tensorframes_tpu_torch.serving.ServingFleet` mode —
    restarted replicas republish their card and rejoin automatically).
    """

    def __init__(self, replicas=None, *, fleet_dir: Optional[str] = None,
                 run_id: Optional[str] = None,
                 config: Optional[RouterConfig] = None):
        self.config = config or RouterConfig()
        self.fleet_dir = fleet_dir
        self.run_id = run_id or (_context.run_id() if fleet_dir else None)
        self._lock = threading.Lock()
        self._replicas: Dict[int, ReplicaHandle] = {}
        self._counters = {
            "requests": 0, "redrives": 0,
            "rejected": {r: 0 for r in m.ROUTER_REJECT_REASONS},
        }
        self._seq = itertools.count()
        self._poller: Optional[threading.Thread] = None
        self._scrape_pool = None  # lazy ThreadPoolExecutor
        self._stop = threading.Event()
        self._httpd = None
        if replicas is not None:
            pairs = (
                replicas.items() if isinstance(replicas, dict)
                else enumerate(replicas)
            )
            for rank, addr in pairs:
                self.set_replica(int(rank), str(addr))

    # -- registry -----------------------------------------------------------

    def set_replica(self, rank: int, addr: str, *,
                    pid: Optional[int] = None, attempt: int = 0) -> None:
        """Register (or re-register after a restart) a replica. State
        starts ``unknown`` — it becomes routable only once a scrape
        reads ``running`` from its healthz."""
        with self._lock:
            h = self._replicas.get(rank)
            if h is None or h.addr != addr or h.attempt != attempt:
                h = ReplicaHandle(rank, addr)
                h.pid = pid
                h.attempt = int(attempt)
                self._replicas[rank] = h

    def mark_dead(self, rank: int, reason: str = "reaped") -> None:
        """Immediate death verdict (the fleet supervisor reaped the
        process): stop routing to it NOW, without waiting for a scrape
        or heartbeat timeout. In-flight dispatches to it fail on their
        sockets and redrive."""
        with self._lock:
            h = self._replicas.get(rank)
            if h is None or h.state == "dead":
                return
            h.state = "dead"
            h.dead_reason = reason
        m.ROUTER_REPLICA_DEAD.inc()
        _flight.record("router.replica_dead", rank=rank, reason=reason)
        logger.warning("router: replica %d dead (%s)", rank, reason)

    def replicas(self) -> Dict[int, dict]:
        with self._lock:
            return {r: h.snapshot() for r, h in self._replicas.items()}

    def live_count(self) -> int:
        with self._lock:
            return sum(1 for h in self._replicas.values() if h.routable)

    # -- polling ------------------------------------------------------------

    def start(self) -> "Router":
        if self._poller is None:
            self._stop.clear()
            self._poll_once()  # ready replicas visible before first pick
            self._poller = threading.Thread(
                target=self._poll_loop, daemon=True, name="tfs-router-poll"
            )
            self._poller.start()
            _flight.record(
                "router.start", replicas=sorted(self._replicas),
                fleet_dir=self.fleet_dir,
            )
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._poller is not None:
            self._poller.join(timeout=self.config.poll_s * 4 + 2.0)
            self._poller = None
        if self._scrape_pool is not None:
            self._scrape_pool.shutdown(wait=False)
            self._scrape_pool = None
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd = None
        _flight.record("router.stop")

    def _poll_loop(self) -> None:
        while not self._stop.wait(self.config.poll_s):
            try:
                self._poll_once()
            except Exception as e:  # pragma: no cover - must keep polling
                logger.debug("router poll failed: %s", e)

    def _poll_once(self) -> None:
        if self.fleet_dir:
            for rank, card in read_cards(self.fleet_dir, self.run_id).items():
                self.set_replica(
                    rank, card_addr(card),
                    pid=card.get("pid"), attempt=card.get("attempt", 0),
                )
            timeout = (
                self.config.heartbeat_timeout_s
                if self.config.heartbeat_timeout_s is not None
                else get_config().heartbeat_timeout_s
            )
            try:
                beats = read_heartbeats(self.fleet_dir, self.run_id)
            except OSError:  # pragma: no cover - transient fs wobble
                beats = {}
            now = time.time()
            with self._lock:
                handles = list(self._replicas.values())
            for h in handles:
                rec = beats.get(h.rank)
                if rec is None:
                    continue
                age = max(0.0, now - float(rec.get("ts", now)))
                with self._lock:
                    h.beat_age_s = round(age, 3)
                if rec.get("stopped"):
                    with self._lock:
                        if h.state not in ("dead", "stopped"):
                            h.state = "stopped"
                elif age > timeout and h.state != "dead":
                    self.mark_dead(
                        h.rank,
                        f"heartbeat stale {age:.2f}s (timeout {timeout:g}s)",
                    )
        with self._lock:
            # DEAD handles are scraped too: dead is a routing verdict,
            # not a tombstone — an alive-but-stalled replica whose
            # healthz recovers (transient GIL stall, connection flood)
            # must resurrect instead of being blacklisted forever (a
            # truly reaped process just keeps refusing the connection,
            # and its restart arrives as a NEW card/attempt anyway).
            # Skip handles whose previous scrape is STILL in flight (a
            # wedged replica pinning a pool thread): overlapping
            # scrapes of one handle could interleave verdicts.
            handles = [
                h for h in self._replicas.values() if not h.scraping
            ]
            for h in handles:
                h.scraping = True
        if len(handles) == 1:
            self._scrape(handles[0])
        elif handles:
            # scrape CONCURRENTLY: one wedged replica (accepts, never
            # answers — a scrape_timeout_s stall) must not stretch the
            # poll cadence by 2s per wedged peer, delaying readiness
            # and death detection for the whole fleet
            import concurrent.futures as _cf

            pool = self._scrape_pool
            if pool is None:
                pool = self._scrape_pool = _cf.ThreadPoolExecutor(
                    max_workers=8, thread_name_prefix="tfs-router-scrape"
                )
            futs = [pool.submit(self._scrape, h) for h in handles]
            _cf.wait(futs, timeout=self.config.scrape_timeout_s + 1.0)
        m.ROUTER_REPLICAS_LIVE.set(self.live_count())

    def _scrape(self, h: ReplicaHandle) -> None:
        """One healthz read: lifecycle state + queue depth + process
        counters. Scrape failures accumulate toward a dead
        verdict (connection refused on a freshly-spawned replica is
        normal — the fails threshold and heartbeats arbitrate). The
        caller marked ``h.scraping``; cleared here in ``finally``."""
        try:
            self._scrape_inner(h)
        finally:
            with self._lock:
                h.scraping = False

    def _scrape_inner(self, h: ReplicaHandle) -> None:
        status, body = http_json(
            h.addr, "GET", "/healthz", None, self.config.scrape_timeout_s
        )
        became_ready = False
        with self._lock:
            if status != 200 or not isinstance(body, dict):
                h.scrape_fails += 1
                if h.state == "running":
                    h.state = "unknown"  # suspect: stop routing NOW
                # the dead verdict needs BOTH repeated failures and a
                # replica that has ever served: a freshly-spawned one
                # is connection-refused for seconds while warming (not
                # dead — it stays un-routable until it answers), but
                # one that WAS running and keeps failing scrapes is
                dead = (
                    h.ever_running
                    and h.scrape_fails >= self.config.scrape_fails_dead
                )
            else:
                was = h.state
                h.scrape_fails = 0
                h.state = str(body.get("state", "unknown"))
                if h.state == "running":
                    h.ever_running = True
                    h.dead_reason = None  # resurrection: verdict undone
                h.queued_rows = int(
                    sum((body.get("queued_rows") or {}).values())
                )
                proc = body.get("process")
                if isinstance(proc, dict):
                    h.process = {k: int(v) for k, v in proc.items()}
                became_ready = was != "running" and h.state == "running"
                dead = False
        if status == 200 and became_ready:
            _flight.record(
                "router.replica_ready", rank=h.rank, addr=h.addr,
                attempt=h.attempt, process=dict(h.process),
            )
            logger.info("router: replica %d ready at %s", h.rank, h.addr)
        if dead:
            self.mark_dead(
                h.rank,
                f"healthz unreachable x{h.scrape_fails}",
            )

    # -- dispatch -----------------------------------------------------------

    def _pick(self, excluded) -> Optional[ReplicaHandle]:
        with self._lock:
            live = [
                h for h in self._replicas.values()
                if h.routable and h.rank not in excluded
            ]
            if not live:
                return None
            h = min(live, key=lambda h: (h.load(), h.rank))
            h.inflight += 1
            return h

    def _release(self, h: ReplicaHandle) -> None:
        with self._lock:
            h.inflight = max(0, h.inflight - 1)

    def dispatch(self, endpoint: str, payload: dict,
                 deadline_s: Optional[float] = None) -> Tuple[int, dict]:
        """Route one ingress request; returns ``(status, body)`` to
        relay. ``payload`` is the replica-API body (``inputs`` etc.);
        the router stamps an ``idempotency_key`` (preserving a
        client-provided one) and rewrites ``deadline_s`` to the
        REMAINING budget on every attempt, so a redrive runs under the
        original deadline, not a fresh one."""
        t0 = time.perf_counter()
        m.ROUTER_REQUESTS.inc()
        with self._lock:
            self._counters["requests"] += 1
            seq = next(self._seq)
        key = payload.get("idempotency_key") or (
            f"rt-{self.run_id or _context.run_id()}-{os.getpid()}-{seq}"
        )
        payload = dict(payload)
        payload["idempotency_key"] = key
        # cross-hop trace context: the request id IS the idempotency key,
        # stable across a redrive, so the merged timeline shows one id
        # from ingress through whichever replica finally served it
        trace_val = _context.trace_header_value(key)
        m.REQUEST_TRACE.inc()
        if deadline_s is None:
            deadline_s = payload.get("deadline_s")
        if deadline_s is None:
            deadline_s = self.config.default_deadline_s
        if deadline_s is not None:
            # validated HERE, not trusted from the ingress body: a
            # malformed deadline must be a clean 400, never an uncaught
            # handler-thread error that drops the connection silently
            try:
                deadline_s = float(deadline_s)
            except (TypeError, ValueError):
                return 400, {
                    "error": (
                        f"deadline_s must be a number, got "
                        f"{payload.get('deadline_s')!r}"
                    ),
                }
            if deadline_s <= 0:
                return 400, {
                    "error": (
                        f"deadline_s must be > 0 (got {deadline_s}) — "
                        "the RetryPolicy.deadline_s contract"
                    ),
                }
        abs_deadline = (
            None if deadline_s is None else t0 + deadline_s
        )
        excluded: set = set()
        attempts = 0
        no_replica_since: Optional[float] = None
        try:
            while True:
                now = time.perf_counter()
                if abs_deadline is not None and now >= abs_deadline:
                    return self._reject(
                        "deadline", endpoint,
                        f"deadline of {deadline_s:g}s lapsed after "
                        f"{attempts} dispatch attempt(s)",
                    )
                if abs_deadline is None and attempts >= \
                        self.config.redrive_budget:
                    return self._reject(
                        "deadline", endpoint,
                        f"redrive budget ({self.config.redrive_budget} "
                        "attempts) exhausted for a deadline-less request",
                    )
                rep = self._pick(excluded)
                if rep is None and excluded:
                    # every known replica tried: start a fresh round —
                    # a restarted replica may have rejoined by now
                    excluded.clear()
                    time.sleep(self.config.redrive_wait_s)
                    continue
                if rep is None:
                    if no_replica_since is None:
                        no_replica_since = now
                    waited = now - no_replica_since
                    bound = self.config.no_replica_wait_s
                    if abs_deadline is not None:
                        bound = min(bound, max(0.0, abs_deadline - now))
                    if waited >= bound:
                        return self._reject(
                            "no_replica", endpoint,
                            "no live replica (all dead, draining, or "
                            "still starting)",
                        )
                    time.sleep(
                        min(self.config.redrive_wait_s, 0.05)
                    )
                    continue
                no_replica_since = None
                attempts += 1
                t_att = time.perf_counter()
                lapsed = False
                try:
                    delay_point("router.dispatch")
                    # remaining budget computed AFTER the fault site: a
                    # stalled dispatch (Delay chaos, scheduler pause)
                    # must shrink the replica-side deadline, not reset it
                    if abs_deadline is not None:
                        remaining = abs_deadline - time.perf_counter()
                        if remaining <= 0:
                            lapsed = True
                        else:
                            payload["deadline_s"] = remaining
                    if not lapsed:
                        timeout = self.config.dispatch_timeout_s
                        if abs_deadline is not None:
                            timeout = remaining + 1.0
                        status, body = http_json(
                            rep.addr, "POST", f"/v1/{endpoint}",
                            payload, timeout,
                            headers={_context.TRACE_HEADER: trace_val},
                        )
                except Exception as e:
                    # an injected router.dispatch error counts as a
                    # failed attempt, exactly like a dead socket.
                    # Exception, NOT BaseException: a KeyboardInterrupt
                    # mid-dispatch must interrupt the retry loop, not
                    # be counted as a replica failure and redriven
                    status, body = None, {"error": str(e)}
                finally:
                    self._release(rep)
                    m.ROUTER_DISPATCH_SECONDS.observe(
                        time.perf_counter() - t_att
                    )
                if lapsed:
                    return self._reject(
                        "deadline", endpoint,
                        f"deadline of {deadline_s:g}s lapsed during "
                        f"dispatch attempt {attempts}",
                    )
                if status is None:
                    # network-level failure: the replica died (or the
                    # connection did) mid-request — redrive to a
                    # survivor under the same key + remaining deadline
                    excluded.add(rep.rank)
                    with self._lock:
                        if rep.state == "running":
                            rep.state = "unknown"  # suspect until rescape
                        self._counters["redrives"] += 1
                    m.ROUTER_REDRIVES.inc()
                    _flight.record(
                        "router.redrive", endpoint=endpoint,
                        from_rank=rep.rank, key=key, attempt=attempts,
                        error=str(body.get("error"))[:200],
                    )
                    logger.warning(
                        "router: redriving %s after replica %d failed "
                        "(%s)", endpoint, rep.rank, body.get("error"),
                    )
                    continue
                if status == 503 or status == 429:
                    # closed (draining race) or backpressure: another
                    # replica may take it; relay only when there is no
                    # alternative left this round
                    with self._lock:
                        alternatives = any(
                            h.routable and h.rank not in excluded
                            and h.rank != rep.rank
                            for h in self._replicas.values()
                        )
                    if alternatives:
                        excluded.add(rep.rank)
                        with self._lock:
                            self._counters["redrives"] += 1
                        m.ROUTER_REDRIVES.inc()
                        _flight.record(
                            "router.redrive", endpoint=endpoint,
                            from_rank=rep.rank, key=key,
                            attempt=attempts, status=status,
                        )
                        continue
                if isinstance(body, dict):
                    body.setdefault("replica", rep.rank)
                return status, body
        finally:
            dur = time.perf_counter() - t0
            m.ROUTER_REQUEST_LATENCY.observe(dur)
            if _events.TRACER.enabled:
                # the ingress half of the cross-process request span:
                # merge joins it to the replica's serving.* spans via
                # the shared request_id arg
                _events.TRACER.emit_complete(
                    "router.request", t0, dur,
                    args={"request_id": key, "endpoint": endpoint,
                          "attempts": attempts},
                    cat="serving",
                )

    def _reject(self, reason: str, endpoint: str,
                message: str) -> Tuple[int, dict]:
        m.router_rejected(reason).inc()
        with self._lock:
            self._counters["rejected"][reason] += 1
        _flight.record(
            "router.no_replica" if reason == "no_replica"
            else "router.deadline",
            endpoint=endpoint, message=message,
        )
        code = 503 if reason == "no_replica" else 504
        return code, {"error": message, "reason": reason}

    # -- introspection ------------------------------------------------------

    def counters(self) -> dict:
        with self._lock:
            return {
                "requests": self._counters["requests"],
                "redrives": self._counters["redrives"],
                "rejected": dict(self._counters["rejected"]),
            }

    def status(self) -> dict:
        return {
            "role": "router",
            "replicas": self.replicas(),
            "live": self.live_count(),
            **self.counters(),
        }

    # -- the ingress HTTP front ---------------------------------------------

    def serve(self, port: int = 0, addr: str = "127.0.0.1"):
        """Expose the router over HTTP (the single fleet ingress):
        ``POST /v1/<endpoint>`` proxied through :meth:`dispatch`,
        ``GET /healthz`` → :meth:`status`. Same hardening bounds as the
        replica sidecar (413 / read timeout / connection cap). Returns
        the bound ``ThreadingHTTPServer``."""
        from http.server import BaseHTTPRequestHandler

        router = self
        cfg = self.config

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            timeout = cfg.read_timeout_s

            def _reply(self, code: int, payload: dict) -> None:
                reply_json(self, code, payload)

            def do_GET(self):  # noqa: N802 - http.server API
                if self.path.split("?")[0] in ("/", "/healthz"):
                    self._reply(200, router.status())
                else:
                    self._reply(404, {"error": "not found"})

            def do_POST(self):  # noqa: N802 - http.server API
                path = self.path.split("?")[0]
                if not path.startswith("/v1/"):
                    self._reply(404, {"error": "not found"})
                    return
                endpoint = path[len("/v1/"):]
                raw = read_bounded_body(
                    self, cfg.max_body_bytes, cfg.read_timeout_s
                )
                if raw is None:
                    return
                req = parse_json_object(self, raw)
                if req is None:
                    return
                try:
                    status, body = router.dispatch(endpoint, req)
                except Exception as e:
                    # the exactly-one-response contract: an unexpected
                    # dispatch error must become a 500, never a dropped
                    # connection from a dead handler thread
                    logger.warning("router ingress error: %s", e)
                    status, body = 500, {
                        "error": f"{type(e).__name__}: {e}"
                    }
                self._reply(status, body)

            def log_message(self, *args):  # noqa: D102
                pass

        httpd = make_hardened_http_server(
            (addr, port), Handler, cfg.max_connections
        )
        t = threading.Thread(
            target=httpd.serve_forever, daemon=True,
            name="tfs-router-http",
        )
        t.start()
        self._httpd = httpd
        return httpd


def http_json(addr: str, method: str, path: str,
               payload: Optional[dict], timeout: float,
               headers: Optional[Dict[str, str]] = None,
               ) -> Tuple[Optional[int], dict]:
    """One bounded HTTP exchange with a replica. Returns
    ``(status, parsed body)``; ``(None, {"error": ...})`` on any
    network-level failure (refused, reset, timeout, torn reply) — the
    caller's signal to redrive. ``headers`` adds/overrides request
    headers (the router's trace-context stamp)."""
    import http.client

    host, _, port = addr.rpartition(":")
    conn = http.client.HTTPConnection(
        host or "127.0.0.1", int(port), timeout=timeout
    )
    try:
        body = None
        headers = dict(headers or {})
        if payload is not None:
            body = json.dumps(payload).encode()
            headers["Content-Type"] = "application/json"
        conn.request(method, path, body=body, headers=headers)
        resp = conn.getresponse()
        raw = resp.read()
        try:
            parsed = json.loads(raw) if raw else {}
            if not isinstance(parsed, dict):
                parsed = {"body": parsed}
        except ValueError:
            parsed = {"error": f"unparseable reply ({len(raw)} bytes)"}
        return resp.status, parsed
    except (OSError, http.client.HTTPException) as e:
        return None, {"error": f"{type(e).__name__}: {e}"}
    finally:
        conn.close()
