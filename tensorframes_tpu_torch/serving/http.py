"""Thin, hardened HTTP adapter over :class:`~tensorframes_tpu_torch.serving.Server`.

The in-process future API is the real surface; this adapter lets a
sidecar, a load generator or a fleet router speak to a server without
linking Python — a daemon-thread ``ThreadingHTTPServer``, stdlib only.

Routes:

* ``POST /v1/<endpoint>`` — body ``{"inputs": {col: value | nested list},
  "deadline_s": float?, "idempotency_key": str?}`` (a decode endpoint's
  inputs are ``{"prompt": [...]}``); each handler thread blocks on its
  request's future, and the batcher coalesces across concurrent handlers.
  Replies ``{"outputs": {...}, "rows": n, "latency_s": ...}``. The
  idempotency key rides into ``Server.submit``: a redriven dispatch joins
  the original future instead of running again.
* ``GET /healthz`` — ``Server.stats()``: the lifecycle ``state``
  (``starting|running|draining|stopped``), queue depths, admission
  counters and the process's dispatch accounting.
* ``POST /admin/drain`` — ``Server.drain()`` (admission closes, queued
  work completes); replies 202 with the state. Poll ``/healthz`` for
  ``draining`` → ``stopped``.

Status mapping: 400 malformed or invalid, 404 unknown endpoint, 408 read
timeout, 413 body over the ingress limit, 429 ``queue_full`` /
``too_large`` (retry with backoff), 503 ``closed`` (draining or stopped)
or the connection bound reached, 504 deadline expired, 500 dispatch
error.

Ingress hardening: request bodies over ``max_body_bytes`` get 413, a
connection whose read stalls past ``read_timeout_s`` is closed (408 when a
reply is still possible), and connections beyond ``max_connections`` get
an immediate 503 — each counted by reason in
``tftpu_serving_rejections_total{reason=}``. A request that carries the
``X-Tftpu-Trace`` header runs under that request id.
"""

from __future__ import annotations

import json
import socket
import threading
import time
from typing import Optional

from ..observability import context as _context
from ..utils import get_logger
from ..validation import ValidationError
from . import metrics as m
from .batcher import DeadlineExceededError, RejectedError
from .server import Server, UnknownEndpointError

logger = get_logger(__name__)

__all__ = [
    "serve_http", "make_hardened_http_server", "read_bounded_body",
    "reply_json", "parse_json_object",
    "DEFAULT_MAX_BODY_BYTES", "DEFAULT_READ_TIMEOUT_S", "DEFAULT_MAX_CONNECTIONS",
]

#: Ingress defaults: generous for row-batch JSON, bounded for a server
#: that must survive a misbehaving client.
DEFAULT_MAX_BODY_BYTES = 8 << 20
DEFAULT_READ_TIMEOUT_S = 30.0
DEFAULT_MAX_CONNECTIONS = 128

_CONN_LIMIT_BODY = json.dumps({
    "error": "concurrent connection limit reached — retry with backoff",
    "reason": "conn_limit",
}).encode()
_CONN_LIMIT_RESPONSE = (
    b"HTTP/1.1 503 Service Unavailable\r\n"
    b"Content-Type: application/json\r\n"
    b"Content-Length: " + str(len(_CONN_LIMIT_BODY)).encode() + b"\r\n"
    b"Connection: close\r\n\r\n" + _CONN_LIMIT_BODY
)


def reply_json(handler, code: int, payload: dict) -> None:
    """Write one JSON response on a ``BaseHTTPRequestHandler``."""
    body = json.dumps(payload).encode()
    handler.send_response(code)
    handler.send_header("Content-Type", "application/json")
    handler.send_header("Content-Length", str(len(body)))
    handler.end_headers()
    handler.wfile.write(body)


def parse_json_object(handler, raw: bytes) -> Optional[dict]:
    """Parse a request body that must be a JSON object; on anything else
    reply 400 and return None."""
    try:
        req = json.loads(raw or b"{}")
        if not isinstance(req, dict):
            raise TypeError(f"body must be a JSON object, got {type(req).__name__}")
        return req
    except (ValueError, TypeError) as e:
        handler._reply(400, {"error": f"malformed request: {e}"})
        return None


def read_bounded_body(handler, max_body_bytes: int,
                      read_timeout_s: Optional[float]) -> Optional[bytes]:
    """Read ``handler``'s request body under the ingress bounds. Returns
    the raw bytes, or ``None`` when a refusal already replied (413 over
    the byte limit, 408 on a stalled read, 400 on a malformed
    Content-Length) and marked the connection for close."""
    try:
        length = int(handler.headers.get("Content-Length", 0) or 0)
    except (TypeError, ValueError):
        length = -1
    if length < 0:
        handler._reply(400, {"error": "malformed Content-Length"})
        handler.close_connection = True
        return None
    if length > max_body_bytes:
        m.http_rejected("body_too_large").inc()
        handler._reply(413, {
            "error": (f"request body of {length} bytes exceeds the ingress limit of "
                      f"{max_body_bytes}"),
            "reason": "body_too_large",
        })
        # the unread body is still in flight: close instead of draining it
        handler.close_connection = True
        return None
    try:
        return handler.rfile.read(length)
    except TimeoutError:  # socket.timeout: a stalled read
        m.http_rejected("read_timeout").inc()
        handler.close_connection = True
        try:
            handler._reply(408, {
                "error": f"connection read stalled past {read_timeout_s:g}s",
                "reason": "read_timeout",
            })
        except OSError:  # pragma: no cover - peer already gone
            pass
        return None


def _reject_conn(server, request, slots) -> None:
    """Send the raw conn-limit 503 and close, off the accept thread. The
    drain of the client's unread bytes (closing with data buffered resets
    the socket, which can discard the 503) has a total deadline.
    ``slots`` bounds how many of these threads exist at once."""
    try:
        request.settimeout(0.5)
        request.sendall(_CONN_LIMIT_RESPONSE)
        request.shutdown(socket.SHUT_WR)
        deadline = time.monotonic() + 0.5
        while time.monotonic() < deadline and request.recv(65536):
            pass
    except OSError:
        pass
    finally:
        try:
            server.close_request(request)
        except OSError:  # pragma: no cover - already closed
            pass
        slots.release()


def make_hardened_http_server(addr, handler_cls, max_connections: int):
    """A ``ThreadingHTTPServer`` with a concurrent-connection bound and a
    bounded reject path. Its listen queue holds ``max_connections``
    connections (socketserver's default holds 5): past a full queue the
    kernel drops a connect, and the client retries it only after 1 s,
    then 3 s and 7 s, while the accept loop waits for the interpreter
    lock behind a busy flush worker."""
    from http.server import ThreadingHTTPServer

    class _Bounded(ThreadingHTTPServer):
        daemon_threads = True

        def __init__(self, server_address, RequestHandlerClass):
            self.request_queue_size = int(max_connections)  # read by listen()
            super().__init__(server_address, RequestHandlerClass)
            self._conn_lock = threading.Lock()
            self._active_conns = 0
            self.max_connections = int(max_connections)
            self._reject_slots = threading.BoundedSemaphore(8)

        def process_request(self, request, client_address):
            with self._conn_lock:
                admit = self._active_conns < self.max_connections
                if admit:
                    self._active_conns += 1
            if not admit:
                # shed at the accept edge with a raw 503, on a short-lived
                # thread: a slow peer must never stall the accept loop
                m.http_rejected("conn_limit").inc()
                if self._reject_slots.acquire(blocking=False):
                    threading.Thread(target=_reject_conn,
                                     args=(self, request, self._reject_slots),
                                     daemon=True, name="tfs-http-conn-reject").start()
                else:
                    self.shutdown_request(request)
                return
            try:
                super().process_request(request, client_address)
            except BaseException:
                # the handler thread never started: release its slot, or
                # the counter would ratchet up to the cap
                with self._conn_lock:
                    self._active_conns -= 1
                raise

        def process_request_thread(self, request, client_address):
            try:
                super().process_request_thread(request, client_address)
            finally:
                with self._conn_lock:
                    self._active_conns -= 1

        def handle_error(self, request, client_address):
            # a peer dropping mid-request is normal operation here
            import sys

            exc = sys.exc_info()[1]
            if isinstance(exc, (ConnectionError, TimeoutError)):
                return
            super().handle_error(request, client_address)

    return _Bounded(addr, handler_cls)


def serve_http(server: Server, port: int = 0, addr: str = "127.0.0.1",
               request_timeout_s: Optional[float] = None,
               max_body_bytes: int = DEFAULT_MAX_BODY_BYTES,
               read_timeout_s: Optional[float] = DEFAULT_READ_TIMEOUT_S,
               max_connections: int = DEFAULT_MAX_CONNECTIONS):
    """Serve ``server`` over HTTP from a daemon thread. ``port=0`` binds an
    ephemeral port — read it back from ``httpd.server_address[1]``.
    Returns the ``ThreadingHTTPServer``; call ``.shutdown()`` (then
    ``.server_close()``) to stop it. The adapter owns no lifecycle of the
    :class:`Server` (``POST /admin/drain`` lets an operator trigger one).
    ``request_timeout_s`` bounds each handler's wait for its result."""
    from http.server import BaseHTTPRequestHandler

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        # applied to the connection socket: a stalled client cannot pin
        # a handler thread forever
        timeout = read_timeout_s

        def _reply(self, code: int, payload: dict) -> None:
            reply_json(self, code, payload)

        def _read_body(self) -> Optional[bytes]:
            return read_bounded_body(self, max_body_bytes, read_timeout_s)

        def do_GET(self):  # noqa: N802 - http.server API
            if self.path.split("?")[0] in ("/", "/healthz"):
                self._reply(200, server.stats())
            else:
                self._reply(404, {"error": "not found"})

        def do_POST(self):  # noqa: N802 - http.server API
            path = self.path.split("?")[0]
            if path == "/admin/drain":
                if self._read_body() is None:
                    return
                server.drain()
                self._reply(202, {"state": server.state})
                return
            if not path.startswith("/v1/"):
                self._reply(404, {"error": "not found"})
                return
            endpoint = path[len("/v1/"):]
            raw = self._read_body()
            if raw is None:
                return
            req = parse_json_object(self, raw)
            if req is None:
                return
            inputs = req.get("inputs")
            deadline_s = req.get("deadline_s")
            idem_key = req.get("idempotency_key")
            trace_id, _ = _context.parse_trace_header(self.headers.get(_context.TRACE_HEADER))
            if trace_id:
                m.REQUEST_TRACE.inc()
            t0 = time.perf_counter()
            try:
                with _context.request_scope(trace_id):
                    fut = server.submit(endpoint, inputs, deadline_s=deadline_s,
                                        idempotency_key=idem_key)
            except UnknownEndpointError as e:
                self._reply(404, {"error": str(e)})
                return
            except ValidationError as e:
                self._reply(400, {"error": str(e)})
                return
            except RejectedError as e:
                self._reply(503 if e.reason == "closed" else 429,
                            {"error": str(e), "reason": e.reason})
                return
            except (ValueError, TypeError) as e:
                # submit()'s own argument errors are client faults; a
                # dispatch-time ValueError through fut.result() is a 500
                self._reply(400, {"error": str(e)})
                return
            try:
                outs = fut.result(request_timeout_s)
            except RejectedError as e:
                self._reply(503 if e.reason == "closed" else 429,
                            {"error": str(e), "reason": e.reason})
                return
            except DeadlineExceededError as e:
                self._reply(504, {"error": str(e)})
                return
            except Exception as e:  # dispatch failure: the 500 class
                logger.warning("serving http dispatch error: %s", e)
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})
                return
            self._reply(200, {
                "outputs": {k: (v.tolist() if hasattr(v, "tolist") else list(v))
                            for k, v in outs.items()},
                "rows": len(next(iter(outs.values()))) if outs else 0,
                "latency_s": round(time.perf_counter() - t0, 6),
            })

        def log_message(self, *args):  # load generators must not spam
            pass

    httpd = make_hardened_http_server((addr, port), Handler, max_connections)
    threading.Thread(target=httpd.serve_forever, daemon=True,
                     name="tfs-serving-http").start()
    return httpd
