"""The port's flush server front against the JAX package's on the CPU: a
tiny ``tanh(x @ w)`` program registered in both (``Server.register``),
requests from numpy seeds.

* Results: the port's rows within f32 rtol 1e-5 of the JAX server's (two
  frameworks' matmuls sum in other orders), and bit for bit the port's own
  solo dispatch however they were coalesced.
* The warmed ladder: mixed request sizes dispatch with zero new
  dispatch keys (``tftpu_executor_jit_cache_misses_total``).
* Admission and lifecycle: deadline expiry in the queue and while a
  flush is stalled by the ``serving.flush`` delay site, ``queue_full``,
  ``too_large``, drain, stop without drain, an injected flush fault
  resolving every future, per-server stats, idempotency dedup and its TTL.
* Errors: feed and register validation raise the JAX package's classes
  with its messages, and the HTTP adapter answers the same requests with
  the same status codes (``/admin/drain`` included).

Sleeps stay at or under 0.2 s; HTTP binds port 0 on 127.0.0.1 and every
client call has a timeout.
"""

import json
import socket
import threading
import time
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensorframes_tpu as tfs
import tensorframes_tpu_torch as tft
from tensorframes_tpu.resilience import faults as jfaults
from tensorframes_tpu.serving import Server as JServer
from tensorframes_tpu.serving import ServingConfig as JServingConfig
from tensorframes_tpu.serving import serve_http as jserve_http
from tensorframes_tpu_torch.ops.executor import _JIT_MISSES
from tensorframes_tpu_torch.resilience import faults as tfaults
from tensorframes_tpu_torch.serving import (
    ContinuousBatcher,
    DeadlineExceededError,
    RejectedError,
    Server,
    ServingConfig,
    ServingError,
    serve_http,
)
from tensorframes_tpu_torch.serving import metrics as sm

CPU = "cpu"
WIDTH, OUT = 8, 4
W = np.random.default_rng(7).standard_normal((WIDTH, OUT)).astype(np.float32)
HTTP_TIMEOUT = 10


def _holder(pkg, width=WIDTH, dims=None):
    shape = pkg.Shape(dims if dims is not None else (pkg.Unknown, width))
    return type("F", (), {"schema": pkg.Schema([pkg.ColumnInfo("x", pkg.dtypes.float32,
                                                               shape)])})()


def _tprogram():
    wt = torch.from_numpy(W)
    return tft.compile_program(lambda x: {"y": torch.tanh(x @ wt)}, _holder(tft),
                               block=False, device=CPU)


def _jprogram():
    wj = jnp.asarray(W)
    return tfs.compile_program(lambda x: {"y": jnp.tanh(x @ wj)}, _holder(tfs), block=False)


def _req(rows, seed):
    return {"x": np.random.default_rng(seed).standard_normal((rows, WIDTH)).astype(np.float32)}


def _tserver(**kw):
    kw.setdefault("max_batch_rows", 16)
    kw.setdefault("max_latency_s", 0.002)
    srv = Server(ServingConfig(**kw), device=CPU)
    srv.register("tanh", _tprogram())
    return srv


def _jserver(**kw):
    kw.setdefault("max_batch_rows", 16)
    kw.setdefault("max_latency_s", 0.002)
    srv = JServer(JServingConfig(**kw))
    srv.register("tanh", _jprogram())
    return srv


# ---------------------------------------------------------------------------
# results
# ---------------------------------------------------------------------------

def test_coalesced_equal_solo_and_jax():
    reqs = [_req(1 + (i % 5), seed=i) for i in range(24)]
    srv, jsrv = _tserver(), _jserver()
    srv.start()
    jsrv.start()
    try:
        f0 = sum(c.value for c in sm.FLUSHES.values())
        outs = [f.result(10) for f in [srv.submit("tanh", r) for r in reqs]]
        flushes = sum(c.value for c in sm.FLUSHES.values()) - f0
        want = [f.result(10) for f in [jsrv.submit("tanh", r) for r in reqs]]
    finally:
        srv.stop(drain=True, timeout=10)
        jsrv.stop(drain=True, timeout=10)
    assert flushes < len(reqs)  # coalescing happened
    solo = _tprogram().compiled()
    for r, out, w in zip(reqs, outs, want):
        assert out["y"].shape == (r["x"].shape[0], OUT) and out["y"].dtype == np.float32
        np.testing.assert_array_equal(out["y"], solo.run_rows_bucketed(dict(r), CPU)["y"])
        np.testing.assert_allclose(out["y"], np.asarray(w["y"]), rtol=1e-5, atol=1e-6)


def test_bare_cell_is_one_row_and_results_keep_order():
    srv = _tserver()
    with srv:
        futs = [srv.submit("tanh", {"x": np.full((WIDTH,), 0.1 * i, np.float32)})
                for i in range(10)]
        for i, f in enumerate(futs):
            want = np.tanh(np.full((1, WIDTH), 0.1 * i, np.float32) @ W)
            np.testing.assert_allclose(f.result(10)["y"], want, rtol=1e-5, atol=1e-6)


def test_warmed_ladder_zero_dispatch_key_misses():
    srv = _tserver(max_batch_rows=32, max_latency_s=0.001, max_queue_rows=512)
    srv.start()
    try:
        assert srv.warmup_reports["tanh"]["buckets"] == [8, 16, 32]
        m0 = _JIT_MISSES.value
        for round_ in range(4):
            futs = [srv.submit("tanh", _req(rows, seed=round_ * 100 + rows))
                    for rows in (1, 2, 3, 5, 8, 13, 21, 32)]
            for f in futs:
                f.result(10)
        assert _JIT_MISSES.value - m0 == 0
        assert srv.stats()["process"]["xla_compiles"] == int(_JIT_MISSES.value)
    finally:
        srv.stop(drain=True, timeout=10)


def test_padding_rows_metric_counts_ladder_roundup():
    srv = _tserver(max_latency_s=0.0, warmup=False)
    with srv:
        p0 = sm.PADDING_ROWS.value
        srv.call("tanh", _req(3, seed=0), timeout=10)
        assert sm.PADDING_ROWS.value - p0 == 8 - 3


# ---------------------------------------------------------------------------
# deadlines, admission, lifecycle
# ---------------------------------------------------------------------------

def test_deadline_expires_in_queue():
    srv = _tserver(max_batch_rows=64, max_latency_s=30.0, warmup=False)
    srv.start()
    try:
        d0 = sm.DEADLINE_EXPIRED.value
        t0 = time.perf_counter()
        fut = srv.submit("tanh", _req(2, seed=0), deadline_s=0.05)
        with pytest.raises(DeadlineExceededError):
            fut.result(10)
        assert time.perf_counter() - t0 < 5.0
        assert sm.DEADLINE_EXPIRED.value - d0 == 1
        assert srv.stats()["deadline_expired"] == 1
        with pytest.raises(ValueError, match="deadline_s"):
            srv.submit("tanh", _req(1, seed=1), deadline_s=0.0)
    finally:
        srv.stop(drain=False)


def test_deadline_expires_while_flush_stalled_by_delay_site():
    """A ``Delay`` at ``serving.flush`` stalls the worker inside a flush;
    a request queued behind it expires on the clock, mid-flush."""
    srv = _tserver(max_batch_rows=4, max_latency_s=0.0, warmup=False)
    srv.start()
    try:
        with tfaults.inject("serving.flush", tfaults.Delay(0.2), max_times=1):
            first = srv.submit("tanh", _req(1, seed=0))
            time.sleep(0.02)  # the worker is now asleep inside the flush
            t0 = time.perf_counter()
            late = srv.submit("tanh", _req(1, seed=1), deadline_s=0.05)
            with pytest.raises(DeadlineExceededError):
                late.result(5)
            assert time.perf_counter() - t0 < 0.19  # before the stall ended
        assert first.result(5)["y"].shape == (1, OUT)
    finally:
        srv.stop(drain=True, timeout=10)


def test_backpressure_queue_full_and_too_large():
    release, entered = threading.Event(), threading.Event()

    def blocking_dispatch(feeds, rows):
        entered.set()
        assert release.wait(30)
        return {"y": np.asarray(feeds["x"]) * 2.0}

    b = ContinuousBatcher("blocked", blocking_dispatch, max_batch_rows=4, max_latency_s=0.0,
                          max_queue_rows=8)
    b.start()
    try:
        first = b.offer(_req(1, seed=0), 1, None)
        assert entered.wait(10)
        queued = [b.offer(_req(4, seed=i), 4, None) for i in (1, 2)]
        r0, t0 = sm.rejected("queue_full").value, sm.rejected("too_large").value
        with pytest.raises(RejectedError) as ei:
            b.offer(_req(1, seed=3), 1, None)
        assert ei.value.reason == "queue_full"
        with pytest.raises(RejectedError) as ei:
            b.offer(_req(5, seed=4), 5, None)
        assert ei.value.reason == "too_large"
        assert (sm.rejected("queue_full").value - r0, sm.rejected("too_large").value - t0) == (1, 1)
        assert b.counters()["rejected"] == {"queue_full": 1, "closed": 0, "too_large": 1}
    finally:
        release.set()
        b.stop(drain=True, timeout=10)
    for f in [first] + queued:
        assert f.result(10)["y"].shape[1] == WIDTH


def test_drain_completes_queued_work_then_sheds_closed():
    srv = _tserver(max_batch_rows=64, max_latency_s=30.0, warmup=False)
    srv.start()
    reqs = [_req(2, seed=i) for i in range(5)]
    futs = [srv.submit("tanh", r) for r in reqs]
    assert not any(f.done() for f in futs)
    d0 = sm.FLUSHES["drain"].value
    srv.stop(drain=True, timeout=30)
    assert sm.FLUSHES["drain"].value - d0 >= 1
    solo = _tprogram().compiled()
    for r, f in zip(reqs, futs):
        np.testing.assert_array_equal(f.result(0)["y"], solo.run_rows_bucketed(r, CPU)["y"])
    with pytest.raises(RejectedError) as ei:
        srv.submit("tanh", _req(1, seed=99))
    assert ei.value.reason == "closed" and srv.state == "stopped"


def test_stop_without_drain_fails_pending_loudly():
    srv = _tserver(max_batch_rows=64, max_latency_s=30.0, warmup=False)
    srv.start()
    fut = srv.submit("tanh", _req(1, seed=0))
    srv.stop(drain=False)
    with pytest.raises(ServingError):
        fut.result(5)


def test_injected_flush_fault_resolves_every_future():
    srv = _tserver(max_batch_rows=8, max_latency_s=0.01, warmup=False)
    srv.start()
    try:
        e0 = sm.DISPATCH_ERRORS.value
        with tfaults.inject("serving.flush", RuntimeError("chaos")):
            futs = [srv.submit("tanh", _req(1, seed=i)) for i in range(3)]
            errs = [f.exception(10) for f in futs]
        assert all(isinstance(e, RuntimeError) and str(e) == "chaos" for e in errs)
        assert sm.DISPATCH_ERRORS.value - e0 >= 1
        assert srv.call("tanh", _req(2, seed=9), timeout=10)["y"].shape == (2, OUT)
    finally:
        srv.stop(drain=True, timeout=10)


def test_stats_are_per_server():
    a = _tserver(max_batch_rows=8, max_latency_s=0.001, warmup=False)
    a.start()
    try:
        for i in range(3):
            a.call("tanh", _req(1, seed=i), timeout=10)
        with pytest.raises(RejectedError):
            a.submit("tanh", _req(64, seed=9))
        sa = a.stats()
        assert (sa["admitted_requests"], sa["admitted_rows"]) == (3, 3)
        assert sa["rejected"]["too_large"] == 1 and sa["state"] == "running"
        assert sa["latency"]["tanh"]["p50"] is not None
    finally:
        a.stop(drain=True, timeout=10)
    b = _tserver(max_batch_rows=8, warmup=False)
    sb = b.stats()
    assert (sb["admitted_requests"], sb["admitted_rows"], sb["deadline_expired"]) == (0, 0, 0)
    assert sb["rejected"] == {r: 0 for r in sm.REJECT_REASONS}


def test_idempotency_dedup_and_ttl():
    srv = _tserver(max_batch_rows=8, max_latency_s=0.001, idempotency_ttl_s=0.1, warmup=False)
    srv.start()
    try:
        d0, r0 = sm.IDEMPOTENT_DEDUP.value, sm.ROWS.value
        a = srv.submit("tanh", _req(2, seed=1), idempotency_key="k1")
        b = srv.submit("tanh", _req(2, seed=1), idempotency_key="k1")
        assert b is a and sm.IDEMPOTENT_DEDUP.value - d0 == 1
        assert sm.ROWS.value - r0 == 2  # admitted once
        # the same key on another endpoint is another operation
        srv.register("tanh2", _tprogram())
        c = srv.submit("tanh2", _req(2, seed=1), idempotency_key="k1")
        assert c is not a
        a.result(10)
        time.sleep(0.15)  # past the TTL
        d = srv.submit("tanh", _req(2, seed=1), idempotency_key="k1")
        assert d is not a
        np.testing.assert_array_equal(d.result(10)["y"], a.result(10)["y"])
    finally:
        srv.stop(drain=True, timeout=10)
    assert not srv._idem  # a stopped server keeps no dedup state


# ---------------------------------------------------------------------------
# the JAX package's error classes and messages
# ---------------------------------------------------------------------------

def _outcome(fn):
    try:
        fn()
    except Exception as e:
        return type(e).__name__, str(e)
    return None


BAD_FEEDS = [
    ("nope", _req(1, seed=0)),
    ("tanh", {"z": np.zeros((1, WIDTH), np.float32)}),
    ("tanh", {"x": np.zeros((1, WIDTH + 1), np.float32)}),
    ("tanh", {"x": np.zeros((0, WIDTH), np.float32)}),
    ("tanh", {}),
    ("tanh", {"x": np.zeros((2, 3, WIDTH), np.float32)}),
    ("tanh", {"x": [["a"] * WIDTH]}),
    ("tanh", _req(17, seed=0)),
]


def test_feed_validation_matches_jax():
    srv, jsrv = _tserver(warmup=False), _jserver(warmup=False)
    srv.start()
    jsrv.start()
    try:
        for name, feeds in BAD_FEEDS:
            got = _outcome(lambda: srv.submit(name, feeds))
            want = _outcome(lambda: jsrv.submit(name, feeds))
            assert got is not None and got == want, (name, got, want)
    finally:
        srv.stop(drain=False)
        jsrv.stop(drain=False)


def test_register_validation_matches_jax():
    def cases(pkg, server_cls, cfg_cls, prog, kw):
        srv = server_cls(cfg_cls(warmup=False), **kw)
        srv.register("tanh", prog())
        unknown = pkg.compile_program(lambda x: {"y": x * 2.0},
                                      _holder(pkg, dims=(pkg.Unknown, pkg.Unknown)),
                                      block=False, **({"device": CPU} if kw else {}))
        return [
            _outcome(lambda: srv.register("tanh", prog())),
            _outcome(lambda: srv.register("a/b", prog())),
            _outcome(lambda: srv.register("", prog())),
            _outcome(lambda: srv.register("fn", lambda x: {"y": x})),
            _outcome(lambda: srv.register("ragged", unknown)),
            _outcome(lambda: server_cls(cfg_cls(max_batch_rows=1 << 40), **kw)),
        ]

    got = cases(tft, Server, ServingConfig, _tprogram, {"device": CPU})
    want = cases(tfs, JServer, JServingConfig, _jprogram, {})
    assert all(g is not None for g in got)
    assert got == want


def test_failed_live_register_leaves_no_zombie(monkeypatch):
    srv = _tserver(max_latency_s=0.001)
    srv.start()
    try:
        def boom(self, ep):
            raise RuntimeError("warm failed")

        monkeypatch.setattr(Server, "_warm", boom)
        with pytest.raises(RuntimeError, match="warm failed"):
            srv.register("late", _tprogram())
        assert srv.endpoints() == ["tanh"]
        monkeypatch.undo()
        srv.register("late", _tprogram())  # the name is free again
        assert srv.call("late", _req(1, seed=2), timeout=10)["y"].shape == (1, OUT)
    finally:
        srv.stop(drain=True, timeout=10)


def test_donate_is_accepted_and_warns_once(monkeypatch, caplog):
    """``donate`` keeps the reference's signature and does nothing; a
    ``donate=True`` config says so once a process, and serves as one
    without it."""
    import logging

    from tensorframes_tpu_torch.serving import server as tsrv

    monkeypatch.setattr(tsrv, "_DONATE_WARNED", False)
    with caplog.at_level(logging.WARNING, logger="tensorframes_tpu_torch.serving.server"):
        ServingConfig(donate=False)
        ServingConfig(donate=True)
        ServingConfig(donate=True)
    said = [r for r in caplog.records if "donate=True" in r.getMessage()]
    assert len(said) == 1 and "no effect" in said[0].getMessage()
    outs = []
    for donate in (True, False):
        srv = _tserver(donate=donate)
        with srv:
            outs.append(srv.submit("tanh", _req(3, seed=2)).result(10)["y"])
    np.testing.assert_array_equal(outs[0], outs[1])


def test_register_query_names_the_roadmap():
    """``register_query`` is ported (it raised, naming ROADMAP queue 1,
    before): without a ``QuerySource`` it raises the reference's
    ``ValueError``, whole; the query tests are in
    ``test_torch_registered_query.py``."""
    errs = []
    for srv in (_tserver(warmup=False), _jserver(warmup=False)):
        with pytest.raises(ValueError) as info:
            srv.register_query("q", None, None)
        errs.append(str(info.value))
    assert errs[0] == errs[1] == "register_query() needs a QuerySource, got NoneType"


# ---------------------------------------------------------------------------
# HTTP
# ---------------------------------------------------------------------------

def _post(base, path, body, timeout=HTTP_TIMEOUT, raw=None):
    data = raw if raw is not None else json.dumps(body).encode()
    req = urllib.request.Request(base + path, data=data, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.load(r)
    except urllib.error.HTTPError as e:
        return e.code, json.load(e)


def _get(base, path):
    try:
        with urllib.request.urlopen(base + path, timeout=HTTP_TIMEOUT) as r:
            return r.status, json.load(r)
    except urllib.error.HTTPError as e:
        return e.code, json.load(e)


def _http_statuses(srv, serve, inject):
    """Drive one server through the status taxonomy; returns the codes and
    the successful reply's outputs."""
    httpd = serve(srv, max_body_bytes=4096)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    x = _req(4, seed=5)["x"].tolist()
    codes = {}
    try:
        codes["ok"], ok = _post(base, "/v1/tanh", {"inputs": {"x": x}})
        codes["unknown"], _ = _post(base, "/v1/nope", {"inputs": {"x": x}})
        codes["bad_feed"], _ = _post(base, "/v1/tanh", {"inputs": {"x": [1.0, 2.0]}})
        codes["planted_name"], _ = _post(base, "/v1/tanh",
                                         {"inputs": {"unknown endpoint": [1.0]}})
        codes["not_object"], _ = _post(base, "/v1/tanh", [1.0, 2.0])
        codes["not_json"], _ = _post(base, "/v1/tanh", None, raw=b"{nope")
        codes["bad_deadline"], _ = _post(base, "/v1/tanh", {"inputs": {"x": x},
                                                            "deadline_s": 0})
        codes["too_large"], _ = _post(base, "/v1/tanh", {"inputs": {"x": x * 2}})
        codes["body_too_large"], _ = _post(base, "/v1/tanh", None, raw=b" " * 5000)
        codes["deadline"], _ = _post(base, "/v1/tanh", {"inputs": {"x": x[:1]},
                                                        "deadline_s": 0.05})
        with inject("serving.flush", ValueError("bad operand"), max_times=1):
            codes["dispatch_error"], err = _post(base, "/v1/tanh", {"inputs": {"x": x}})
        assert "ValueError" in err["error"]
        codes["get_unknown"], _ = _get(base, "/nowhere")
        codes["post_unknown"], _ = _post(base, "/v2/tanh", {})
        codes["healthz"], health = _get(base, "/healthz")
        assert health["state"] == "running" and health["endpoints"] == ["tanh"]
        # drain: a stalled flush keeps the server draining while it is read
        with inject("serving.flush", tfaults.Delay(0.2) if serve is serve_http
                    else jfaults.Delay(0.2), max_times=1):
            pending = srv.submit("tanh", _req(1, seed=6))
            codes["drain"], body = _post(base, "/admin/drain", {})
            assert body["state"] == "draining"
            codes["while_draining"], _ = _post(base, "/v1/tanh", {"inputs": {"x": x}})
            states = {_get(base, "/healthz")[1]["state"]}
            deadline = time.time() + 10
            while "stopped" not in states and time.time() < deadline:
                time.sleep(0.02)
                states.add(_get(base, "/healthz")[1]["state"])
        assert states == {"draining", "stopped"}, states
        assert pending.result(5)["y"].shape == (1, OUT)
        codes["after_drain"], _ = _post(base, "/v1/tanh", {"inputs": {"x": x}})
    finally:
        httpd.shutdown()
        httpd.server_close()
        srv.stop(drain=False)
    return codes, ok


def test_http_status_taxonomy_and_drain_match_jax():
    srv = _tserver(max_batch_rows=4, max_latency_s=30.0)
    srv.start()
    got, ok = _http_statuses(srv, serve_http, tfaults.inject)
    jsrv = _jserver(max_batch_rows=4, max_latency_s=30.0)
    jsrv.start()
    want, jok = _http_statuses(jsrv, jserve_http, jfaults.inject)
    assert got == want
    assert got["ok"] == 200 and got["deadline"] == 504 and got["after_drain"] == 503
    assert {got[k] for k in ("unknown", "get_unknown")} == {404}
    assert got["too_large"] == 429 and got["body_too_large"] == 413
    assert got["dispatch_error"] == 500 and got["drain"] == 202
    assert ok["rows"] == 4
    np.testing.assert_allclose(np.asarray(ok["outputs"]["y"], np.float32),
                               np.asarray(jok["outputs"]["y"], np.float32), rtol=1e-5, atol=1e-6)


def test_http_idempotent_post_runs_once_and_trace_header_binds():
    srv = _tserver(max_batch_rows=4, max_latency_s=0.001)
    srv.start()
    httpd = serve_http(srv)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        rows0, d0, t0 = sm.ROWS.value, sm.IDEMPOTENT_DEDUP.value, sm.REQUEST_TRACE.value
        body = {"inputs": {"x": _req(2, seed=3)["x"].tolist()}, "idempotency_key": "once"}
        first = _post(base, "/v1/tanh", body)
        again = _post(base, "/v1/tanh", body)
        assert first[0] == again[0] == 200
        assert first[1]["outputs"] == again[1]["outputs"]
        assert sm.ROWS.value - rows0 == 2 and sm.IDEMPOTENT_DEDUP.value - d0 == 1
        req = urllib.request.Request(base + "/v1/tanh", data=json.dumps(
            {"inputs": {"x": _req(1, seed=4)["x"].tolist()}}).encode(), method="POST",
            headers={"X-Tftpu-Trace": "rid-7;run=abc"})
        with urllib.request.urlopen(req, timeout=HTTP_TIMEOUT) as r:
            assert r.status == 200
        assert sm.REQUEST_TRACE.value - t0 == 1
    finally:
        httpd.shutdown()
        httpd.server_close()
        srv.stop(drain=True, timeout=10)


def test_http_listen_queue_holds_max_connections():
    """With the accept loop not running (as when it waits for the
    interpreter lock behind a flush), 32 connects all complete in the
    listen queue: none is dropped to the client's 1 s SYN retry."""
    from http.server import BaseHTTPRequestHandler

    from tensorframes_tpu_torch.serving.http import make_hardened_http_server

    httpd = make_hardened_http_server(("127.0.0.1", 0), BaseHTTPRequestHandler, 64)
    socks = []
    try:
        assert httpd.request_queue_size == 64
        for _ in range(32):
            socks.append(socket.create_connection(httpd.server_address[:2], timeout=0.5))
    finally:
        for c in socks:
            c.close()
        httpd.server_close()


def test_http_serves_a_decode_endpoint():
    """``POST /v1/<decode endpoint>`` with ``{"prompt": [...]}`` answers the
    engine's tokens (its in-process answer, which ``test_torch_serving``
    holds to the JAX package's), as the JAX adapter does."""
    from tensorframes_tpu_torch.models import generation as tgen
    from tensorframes_tpu_torch.models import transformer as ttr

    pt = ttr.quantize_params(ttr.init_params(tgen.gpt_tiny(), seed=0, device=CPU))
    srv = Server(ServingConfig(), device=CPU)
    srv.register_decode("gen", tgen.gpt_tiny(), pt, tft.DecodeConfig(
        max_slots=2, page_size=4, max_prompt_len=8, max_new_tokens=4, warmup=False))
    srv.register("tanh", _tprogram())
    srv.start()
    httpd = serve_http(srv)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        prompt = np.arange(6, dtype=np.int32)
        code, body = _post(base, "/v1/gen", {"inputs": {"prompt": prompt.tolist()}})
        assert code == 200 and body["rows"] == 1
        want = srv.call("gen", {"prompt": prompt}, timeout=60)["tokens"]
        np.testing.assert_array_equal(np.asarray(body["outputs"]["tokens"]), want)
        assert _post(base, "/v1/gen", {"inputs": {"prompt": list(range(9))}})[0] == 429
        assert _post(base, "/v1/gen", {"inputs": {"bad": [1]}})[0] == 400
        st = _get(base, "/healthz")[1]
        assert set(st["endpoints"]) == {"gen", "tanh"} and "gen" in st["decode"]
    finally:
        httpd.shutdown()
        httpd.server_close()
        srv.stop(drain=True, timeout=60)
