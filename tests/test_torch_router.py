"""The port's fleet router, replica cards and heartbeats against the JAX
package's, on the CPU, with in-process replicas (the port's ``Server`` on
``device="cpu"`` behind ``serve_http``) and crash stubs:

* placement: pick by load, never a draining, dead, starting or stopped
  replica; no replica → a counted 503;
* redrive exactly once through both crash windows (the request never
  ran; it ran and its answer was lost — joined by its idempotency key),
  the ``router.dispatch`` delay site expiring a deadline, a once-running
  replica marked dead after scrape failures and resurrected when its
  healthz returns, a malformed deadline answered 400;
* one request id across a redrive: the router's ``router.request`` span
  and the surviving replica's ``serving.request`` span carry it;
* parity: both routers' refusals (status and whole body), the demo
  replica's ``score`` on one seeded input, and heartbeats, fleet status
  and cards written by either package read back equal in the other.

Every wait has a deadline; HTTP binds port 0 on 127.0.0.1.
"""

import json
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import tensorframes_tpu_torch as tft
from tensorframes_tpu.resilience import faults as jfaults
from tensorframes_tpu.resilience import fleet as jfleet
from tensorframes_tpu.serving import Router as JRouter
from tensorframes_tpu.serving import RouterConfig as JRouterConfig
from tensorframes_tpu.serving import replica as jreplica
from tensorframes_tpu_torch.observability import context, events
from tensorframes_tpu_torch.resilience import faults
from tensorframes_tpu_torch.resilience import fleet as tfleet
from tensorframes_tpu_torch.serving import (
    Router,
    RouterConfig,
    Server,
    ServingConfig,
    serve_http,
)
from tensorframes_tpu_torch.serving import metrics as sm
from tensorframes_tpu_torch.serving import replica as treplica
from tensorframes_tpu_torch.serving.replica import publish_card, read_cards
from tensorframes_tpu_torch.serving.router import ReplicaHandle

WIDTH = 4
CPU = "cpu"


def _program(width=WIDTH):
    holder = type("F", (), {"schema": tft.Schema([
        tft.ColumnInfo("x", tft.dtypes.float32, tft.Shape((tft.Unknown, width)))])})()
    return tft.compile_program(lambda x: {"y": x * 2.0 + 1.0}, holder, block=False,
                               device=CPU)


def _server(**cfg_kwargs) -> Server:
    cfg = dict(max_batch_rows=8, max_latency_s=0.002, max_queue_rows=128)
    cfg.update(cfg_kwargs)
    srv = Server(ServingConfig(**cfg), device=CPU)
    srv.register("score", _program())
    return srv


def _post(url, body=None, raw=None, timeout=20):
    data = raw if raw is not None else json.dumps(body or {}).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _wait(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.02)
    return cond()


# ---------------------------------------------------------------------------
# placement (no HTTP)
# ---------------------------------------------------------------------------

def _handle(rank, state, queued=0, inflight=0):
    h = ReplicaHandle(rank, f"127.0.0.1:{9000 + rank}")
    h.state = state
    h.queued_rows = queued
    h.inflight = inflight
    return h


def test_pick_prefers_lowest_load_and_skips_non_running():
    r = Router()
    r._replicas = {
        0: _handle(0, "running", queued=10),
        1: _handle(1, "running", queued=2, inflight=1),
        2: _handle(2, "draining"),
        3: _handle(3, "dead"),
        4: _handle(4, "starting"),
        5: _handle(5, "stopped"),
    }
    h = r._pick(set())
    assert h.rank == 1  # lowest queued + in-flight among the running
    assert h.inflight == 2  # _pick charged one in-flight unit
    r._release(h)
    assert h.inflight == 1
    assert r._pick({0, 1}) is None  # every running replica excluded


def test_pick_none_when_no_replicas():
    r = Router(config=RouterConfig(no_replica_wait_s=0.1))
    status, body = r.dispatch("score", {"inputs": {}})
    assert status == 503
    assert body["reason"] == "no_replica"


# ---------------------------------------------------------------------------
# redrive exactly once: the two crash windows
# ---------------------------------------------------------------------------

class _CrashingReplica:
    """A fake replica: healthz answers as a running replica (so the router
    routes to it); a POST either drops the connection at once
    (``before_dispatch``: the request never ran) or forwards to a real
    replica first and then drops the reply (``after_dispatch``: it ran,
    its answer is lost). Records each POST's trace header."""

    def __init__(self, mode, forward_port=None):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        outer = self
        self.mode = mode
        self.forward_port = forward_port
        self.posts = 0
        self.trace_headers = []

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def do_GET(self):
                body = json.dumps({"state": "running", "running": True,
                                   "queued_rows": {}, "endpoints": ["score"]}).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self):
                outer.posts += 1
                outer.trace_headers.append(self.headers.get(context.TRACE_HEADER))
                raw = self.rfile.read(int(self.headers.get("Content-Length", 0)))
                if outer.mode == "after_dispatch" and outer.forward_port:
                    _post(f"http://127.0.0.1:{outer.forward_port}{self.path}", raw=raw)
                # the socket dies with no reply, as a SIGKILLed replica's
                # does; shutdown() sends the FIN (the handler's file dups
                # keep the descriptor open past close())
                try:
                    self.connection.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                self.close_connection = True

            def log_message(self, *args):
                pass

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.httpd.daemon_threads = True
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()

    @property
    def port(self):
        return self.httpd.server_address[1]

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()


@pytest.mark.parametrize("window", ["before_dispatch", "after_dispatch"])
def test_redrive_exactly_once_through_crash_windows(window, monkeypatch):
    from tensorframes_tpu_torch.serving.server import Endpoint

    executions = []
    orig = Endpoint.dispatch

    def counting(self, feeds, rows):
        executions.append(rows)
        return orig(self, feeds, rows)

    monkeypatch.setattr(Endpoint, "dispatch", counting)
    srv = _server()
    srv.start()
    executions.clear()  # the warm-up's dispatches
    httpd = serve_http(srv)
    real_port = httpd.server_address[1]
    crasher = _CrashingReplica(window, forward_port=real_port)
    router = Router(replicas={0: f"127.0.0.1:{crasher.port}", 1: f"127.0.0.1:{real_port}"},
                    config=RouterConfig(poll_s=0.05))
    router.start()
    try:
        assert _wait(lambda: router.live_count() == 2)
        before = sm.ROUTER_REDRIVES.value
        # rank 0 (the crasher, load 0) wins the tie-break: the first
        # attempt lands in the crash window, the redrive on the survivor
        status, body = router.dispatch("score", {"inputs": {"x": [[1.0] * WIDTH]}},
                                       deadline_s=20.0)
        assert status == 200, body
        np.testing.assert_array_equal(np.asarray(body["outputs"]["y"]), [[3.0] * WIDTH])
        assert body["replica"] == 1
        assert crasher.posts == 1
        assert sm.ROUTER_REDRIVES.value == before + 1
        # one response, and one execution even where the dying replica
        # had already dispatched it (the idempotency key joined it)
        assert len(executions) == 1
        assert router.counters()["redrives"] == 1
    finally:
        router.stop()
        crasher.stop()
        httpd.shutdown()
        srv.stop(drain=True)


def test_router_delay_chaos_expires_deadline():
    srv = _server()
    srv.start()
    httpd = serve_http(srv)
    router = Router(replicas={0: f"127.0.0.1:{httpd.server_address[1]}"},
                    config=RouterConfig(poll_s=0.05))
    router.start()
    try:
        assert _wait(lambda: router.live_count() == 1)
        before = sm.router_rejected("deadline").value
        with faults.inject("router.dispatch", faults.Delay(0.5)):
            status, body = router.dispatch("score", {"inputs": {"x": [[1.0] * WIDTH]}},
                                           deadline_s=0.25)
        # the stalled dispatch consumed the budget: a counted 504, no hang
        assert status == 504
        assert body["reason"] == "deadline"
        assert sm.router_rejected("deadline").value == before + 1
    finally:
        router.stop()
        httpd.shutdown()
        srv.stop(drain=True)


def test_router_never_routes_to_draining_replica():
    srv_a, srv_b = _server(), _server()
    srv_a.start()
    srv_b.start()
    httpd_a, httpd_b = serve_http(srv_a), serve_http(srv_b)
    router = Router(replicas={0: f"127.0.0.1:{httpd_a.server_address[1]}",
                              1: f"127.0.0.1:{httpd_b.server_address[1]}"},
                    config=RouterConfig(poll_s=0.05))
    router.start()
    try:
        assert _wait(lambda: router.live_count() == 2)
        srv_a.drain(wait=True)  # rank 0 retires
        assert _wait(lambda: router.live_count() == 1)
        for i in range(6):
            status, body = router.dispatch("score",
                                           {"inputs": {"x": [[float(i)] * WIDTH]}},
                                           deadline_s=20.0)
            assert status == 200
            assert body["replica"] == 1  # never the drained replica
    finally:
        router.stop()
        httpd_a.shutdown()
        httpd_b.shutdown()
        srv_a.stop(drain=True)
        srv_b.stop(drain=True)


def test_scrape_failures_mark_once_running_replica_dead():
    """A static replica that WAS serving and stops answering healthz is
    marked dead after ``scrape_fails_dead`` failures; a never-reachable
    address only stays un-routable; and a dead replica whose healthz comes
    back at the same address is routable again."""
    srv = _server()
    srv.start()
    httpd = serve_http(srv)
    port = httpd.server_address[1]
    router = Router(replicas={0: f"127.0.0.1:{port}", 1: "127.0.0.1:1"},
                    config=RouterConfig(poll_s=0.05, scrape_timeout_s=0.5,
                                        scrape_fails_dead=2))
    router.start()
    try:
        assert _wait(lambda: router.live_count() == 1)
        time.sleep(0.3)
        assert router.replicas()[1]["state"] != "dead"
        httpd.shutdown()
        httpd.server_close()
        srv.stop(drain=False)
        assert _wait(lambda: router.replicas()[0]["state"] == "dead")
        snap = router.replicas()[0]
        assert "unreachable" in snap["dead_reason"]
        srv2 = _server()
        srv2.start()
        httpd2 = serve_http(srv2, port=port)
        try:
            assert _wait(lambda: router.replicas()[0]["state"] == "running")
            snap = router.replicas()[0]
            assert snap["dead_reason"] is None
            assert router.live_count() == 1
        finally:
            httpd2.shutdown()
            srv2.stop(drain=True)
    finally:
        router.stop()


def test_replica_cards_roundtrip(tmp_path):
    d = str(tmp_path)
    publish_card(d, rank=0, addr="127.0.0.1", port=1234, run_id="r1")
    publish_card(d, rank=1, addr="127.0.0.1", port=1235, run_id="r1")
    time.sleep(0.01)  # a restart republishes rank 1 with a new port: newest wins
    publish_card(d, rank=1, addr="127.0.0.1", port=1299, run_id="r1", attempt=1)
    cards = read_cards(d, "r1")
    assert sorted(cards) == [0, 1]
    assert cards[1]["port"] == 1299
    assert cards[1]["attempt"] == 1
    assert treplica.card_addr(cards[1]) == "127.0.0.1:1299"
    assert read_cards(d, "other-run") == {}


def test_malformed_deadline_is_a_400():
    srv = _server()
    srv.start()
    httpd = serve_http(srv)
    router = Router(replicas={0: f"127.0.0.1:{httpd.server_address[1]}"},
                    config=RouterConfig(poll_s=0.05))
    router.start()
    ingress = router.serve(port=0)
    url = f"http://127.0.0.1:{ingress.server_address[1]}/v1/score"
    try:
        assert _wait(lambda: router.live_count() == 1)
        for bad in ("soon", [1], 0, -2.0):
            status, body = _post(url, {"inputs": {"x": [[1.0] * WIDTH]}, "deadline_s": bad})
            assert status == 400, (bad, body)
            assert "deadline_s must be" in body["error"]
        status, body = _post(url, {"inputs": {"x": [[1.0] * WIDTH]}, "deadline_s": 20.0})
        assert status == 200 and body["replica"] == 0
        with urllib.request.urlopen(url.replace("/v1/score", "/healthz"), timeout=10) as r:
            health = json.loads(r.read())
        assert health["role"] == "router" and health["live"] == 1
    finally:
        router.stop()
        httpd.shutdown()
        srv.stop(drain=True)


def test_router_metrics_preregistered():
    from tensorframes_tpu_torch.observability.metrics import REGISTRY

    names = {m.name for m in REGISTRY.collect()}
    for want in (
        "tftpu_router_requests_total",
        "tftpu_router_redrives_total",
        "tftpu_router_rejected_total",
        "tftpu_router_replicas_live",
        "tftpu_router_replica_dead_total",
        "tftpu_router_replica_restarts_total",
        "tftpu_router_dispatch_seconds",
        "tftpu_router_request_latency_seconds",
        "tftpu_serving_rejections_total",
        "tftpu_serving_idempotent_dedup_total",
        "tftpu_fleet_heartbeats_total",
        "tftpu_fleet_dead_ranks_total",
    ):
        assert want in names, want
    assert set(sm.ROUTER_REJECTED) == {"no_replica", "deadline"}


# ---------------------------------------------------------------------------
# one request id across a redrive
# ---------------------------------------------------------------------------

def _spans(name):
    return [e for e in events.to_chrome_trace()["traceEvents"]
            if e.get("name") == name and e.get("ph") == "X"]


@pytest.fixture
def _tracing():
    was = events.TRACER.enabled
    events.clear()
    events.enable()
    yield
    events.clear()
    if not was:
        events.disable()


def test_redrive_keeps_one_request_id_across_attempts(_tracing):
    srv = _server()
    srv.start()
    httpd = serve_http(srv)
    crasher = _CrashingReplica("before_dispatch")
    router = Router(replicas={0: f"127.0.0.1:{crasher.port}",
                              1: f"127.0.0.1:{httpd.server_address[1]}"},
                    config=RouterConfig(poll_s=0.05))
    router.start()
    try:
        assert _wait(lambda: router.live_count() == 2)
        status, body = router.dispatch("score", {"inputs": {"x": [[1.0] * WIDTH]}},
                                       deadline_s=20.0)
        assert status == 200, body
        assert body["replica"] == 1
        # the crashed attempt carried a parseable header
        assert len(crasher.trace_headers) == 1
        rid0, run0 = context.parse_trace_header(crasher.trace_headers[0])
        assert rid0 and run0 == context.run_id()
        # the ingress span names the same id, two attempts
        ingress = _spans("router.request")
        assert len(ingress) == 1
        assert ingress[0]["args"]["request_id"] == rid0
        assert ingress[0]["args"]["attempts"] == 2
        # and the surviving replica's span joins on it
        served = [e for e in _spans("serving.request")
                  if e["args"].get("request_id") == rid0]
        assert len(served) == 1
    finally:
        router.stop()
        crasher.stop()
        httpd.shutdown()
        srv.stop(drain=True)


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------

def _refusals(router_cls, config_cls, crash_ports):
    """Every refusal a router makes, as (status, body): no replica, a
    malformed and a non-positive deadline, a deadline lapsed by the delay
    site, and a deadline-less request's redrive budget spent on crashing
    replicas."""
    out = []
    r = router_cls(config=config_cls(no_replica_wait_s=0.1))
    out.append(r.dispatch("score", {"inputs": {}}))
    out.append(r.dispatch("score", {"inputs": {}, "deadline_s": "soon"}))
    out.append(r.dispatch("score", {"inputs": {}, "deadline_s": -1}))
    r = router_cls(replicas={i: f"127.0.0.1:{p}" for i, p in enumerate(crash_ports)},
                   config=config_cls(poll_s=0.05, redrive_budget=2, redrive_wait_s=0.01))
    r.start()
    try:
        assert _wait(lambda: r.live_count() == len(crash_ports))
        out.append(r.dispatch("score", {"inputs": {"x": [[1.0] * WIDTH]}}))
    finally:
        r.stop()
    return out


def test_router_refusals_match_jax():
    crashers = [_CrashingReplica("before_dispatch") for _ in range(2)]
    try:
        ports = [c.port for c in crashers]
        got = _refusals(Router, RouterConfig, ports)
        want = _refusals(JRouter, JRouterConfig, ports)
    finally:
        for c in crashers:
            c.stop()
    assert got == want
    assert [s for s, _ in got] == [503, 400, 400, 504]
    # the delay site's lapse, one attempt each
    srv = _server()
    srv.start()
    httpd = serve_http(srv)
    addr = {0: f"127.0.0.1:{httpd.server_address[1]}"}
    lapsed = []
    try:
        for router_cls, config_cls, fmod in ((Router, RouterConfig, faults),
                                             (JRouter, JRouterConfig, jfaults)):
            r = router_cls(replicas=addr, config=config_cls(poll_s=0.05))
            r.start()
            try:
                assert _wait(lambda: r.live_count() == 1)
                with fmod.inject("router.dispatch", fmod.Delay(0.3)):
                    lapsed.append(r.dispatch("score", {"inputs": {"x": [[1.0] * WIDTH]}},
                                             deadline_s=0.1))
            finally:
                r.stop()
    finally:
        httpd.shutdown()
        srv.stop(drain=True)
    assert lapsed[0] == lapsed[1]
    assert lapsed[0] == (504, {"error": "deadline of 0.1s lapsed during dispatch attempt 1",
                               "reason": "deadline"})


def test_demo_server_score_matches_jax():
    x = np.random.default_rng(3).standard_normal((5, 8)).astype(np.float32)
    srv = treplica.demo_server(device=CPU)
    jsrv = jreplica.demo_server()
    srv.start()
    jsrv.start()
    try:
        got = srv.call("score", {"x": x}, timeout=30)["y"]
        want = np.asarray(jsrv.call("score", {"x": x}, timeout=30)["y"])
    finally:
        srv.stop(drain=True)
        jsrv.stop(drain=True)
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == (5, 8) and got.dtype == np.float32
    # rtol 1e-6 of max |y|: the two frameworks sum x @ w in other orders,
    # one f32 rounding apart before the tanh
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def test_heartbeats_and_cards_read_back_equal_across_packages(tmp_path):
    d = str(tmp_path)
    for pkg in (tfleet, jfleet):
        pkg.write_beat(d, seq=3, rank=7, interval_s=0.5)
    # one run id for both (the processes' contexts differ): the port's
    # write names the port's run, the reference's its own
    from tensorframes_tpu.observability import context as jcontext

    runs = {context.run_id(), jcontext.run_id()}
    hb_t = tfleet.read_heartbeats(d)
    hb_j = jfleet.read_heartbeats(d)
    assert hb_t == hb_j
    for run in runs:
        assert tfleet.read_heartbeats(d, run) == jfleet.read_heartbeats(d, run)
        rec = tfleet.read_heartbeats(d, run)[7]
        assert set(rec) == {"run_id", "process_index", "pid", "seq", "ts", "interval_s",
                            "stopped"}
        assert (rec["seq"], rec["interval_s"], rec["stopped"]) == (3, 0.5, False)
        assert (tmp_path / f"hb_{run}_p7.json").is_file()
    # a graceful stop reads as stopped in both packages' status
    hb = tfleet.Heartbeater(d, interval_s=0.05, rank=2).start()
    hb.stop(graceful=True)
    # a live rank whose next beat falls after both reads: a beat between
    # them would give the two packages' statuses different ages
    jhb = jfleet.Heartbeater(d, interval_s=30.0, rank=3).start()
    time.sleep(0.1)
    now = time.time()
    for run in runs:
        st_t = tfleet.fleet_status(d, run_id=run, num_processes=9, timeout_s=60.0, now=now)
        st_j = jfleet.fleet_status(d, run_id=run, num_processes=9, timeout_s=60.0, now=now)
        assert vars(st_t) == vars(st_j)
    jhb.stop(graceful=True)
    # cards: either package's publish reads back equal in both
    treplica.publish_card(d, rank=0, addr="127.0.0.1", port=4000, run_id="rc", attempt=2)
    jreplica.publish_card(d, rank=1, addr="127.0.0.1", port=4001, run_id="rc")
    assert treplica.read_cards(d, "rc") == jreplica.read_cards(d, "rc")
    assert sorted(treplica.read_cards(d, "rc")) == [0, 1]
    assert [treplica.card_addr(c) for c in treplica.read_cards(d, "rc").values()] == \
        [jreplica.card_addr(c) for c in jreplica.read_cards(d, "rc").values()]
    # the abort signal: first writer wins, either reads it
    tfleet.signal_abort(d, "lost rank 1", dead_ranks=[1], run_id="ra")
    jfleet.signal_abort(d, "cascade", dead_ranks=[0], run_id="ra")
    assert tfleet.abort_requested(d, "ra") == jfleet.abort_requested(d, "ra")
    assert tfleet.abort_requested(d, "ra")["reason"] == "lost rank 1"
    assert tfleet.clear_fleet(d, "ra") == 1 and jfleet.abort_requested(d, "ra") is None


def test_heartbeat_fault_site_drops_beats(tmp_path):
    hb = tfleet.Heartbeater(str(tmp_path), interval_s=0.05, rank=0)
    assert hb.beat_once()
    with faults.inject("fleet.heartbeat", RuntimeError):
        assert not hb.beat_once()
    assert hb.skipped == 1 and hb.seq == 1
    assert "fleet.heartbeat" in faults.list_sites()
    assert {"router.dispatch", "serving.replica"} <= set(faults.list_sites())


# ---------------------------------------------------------------------------
# one kernel build across processes (a fleet started on a cold build dir)
# ---------------------------------------------------------------------------

_NVCC_STUB = """#!{python}
import os, sys, time
with open({log!r}, "a") as f:
    f.write(("link" if "-shared" in sys.argv else "compile") + "\\n")
if "-c" in sys.argv:
    time.sleep(1.0)
out = sys.argv[sys.argv.index("-o") + 1]
with open(out, "w") as f:
    f.write("built\\n")
"""

_BUILD_WORKER = """
import json, os, sys, time
from pathlib import Path
import tensorframes_tpu_torch.kernels as k

build_dir, nvcc, go = sys.argv[1:4]
k.BUILD_DIR = Path(build_dir)
k.BUILD_LOG = k.BUILD_DIR / "nvcc.log"
k._nvcc = lambda: nvcc
print("ready", flush=True)
deadline = time.monotonic() + 60
while not os.path.exists(go) and time.monotonic() < deadline:
    time.sleep(0.01)
so = k._build()
print(json.dumps({"so": str(so), "builds": k.KERNEL_BUILDS.value}), flush=True)
"""


def test_kernel_build_runs_once_across_processes(tmp_path):
    """Two processes that reach ``kernels._build`` together on an empty
    build dir run the nvcc jobs once: the second waits on the lock, finds
    the library and counts no build."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    log, nvcc, go = tmp_path / "calls.log", tmp_path / "nvcc", tmp_path / "go"
    nvcc.write_text(_NVCC_STUB.format(python=sys.executable, log=str(log)))
    nvcc.chmod(0o755)
    build_dir = tmp_path / "build"
    env = dict(os.environ, PYTHONPATH=str(repo), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_WORKER, str(build_dir), str(nvcc),
                               str(go)], env=env, cwd=str(repo), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(2)]
    try:
        for p in procs:
            assert p.stdout.readline().strip() == "ready", p.stderr.read()
        go.touch()
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert [p.returncode for p in procs] == [0, 0], [o[1][-2000:] for o in outs]
    got = [json.loads(o[0].strip().splitlines()[-1]) for o in outs]
    assert got[0]["so"] == got[1]["so"] and Path(got[0]["so"]).is_file()
    assert sorted(g["builds"] for g in got) == [0, 1]
    calls = log.read_text().split()
    assert calls.count("compile") == len(tft.kernels._SOURCES) and calls.count("link") == 1
    assert sorted(p.name for p in build_dir.iterdir()) == sorted(
        ["build.lock", "nvcc.log", Path(got[0]["so"]).name])


def test_chip_smoke_replica_mode_refuses_without_gpu_and_alone(tmp_path):
    """``chip_smoke.py --fleet-replica`` (the fleet leg's replica) exits
    nonzero with nothing on stdout where there is no card, and alone in a
    directory."""
    import os
    import shutil
    import subprocess
    import sys
    from pathlib import Path

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the replica mode runs for real there")
    root = Path(__file__).resolve().parents[1]
    shutil.copy(root / "chip_smoke.py", tmp_path / "chip_smoke.py")
    for script, cwd in ((root / "chip_smoke.py", root), ("chip_smoke.py", tmp_path)):
        out = subprocess.run([sys.executable, str(script), "--fleet-replica"], cwd=cwd,
                             env=dict(os.environ), capture_output=True, text=True, timeout=300)
        assert out.returncode != 0 and out.stdout == "", (out.returncode, out.stdout)
