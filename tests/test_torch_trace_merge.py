"""The port's cross-process trace merge, bench snapshots, metric
exporters and the ``observability`` command line, against the JAX
package's on the CPU:

* N worker processes of one run (port verbs on ``device="cpu"``) each
  write a shard; ``merge`` reassembles one JSON-valid Chrome trace with a
  track per process (the CLI too);
* merge semantics on hand-made shards: clocks realigned by each shard's
  wall-clock anchor, mixed runs and duplicate ranks refused unless
  forced;
* a router (this process) and a replica (a subprocess) of one run merge
  into one timeline where a single request id spans both processes;
* parity: ``merge_traces`` over the same shard files, ``load_metrics``
  and ``diff_metrics`` over the committed ``BENCH_r01``–``r05`` rounds,
  ``quantile_from_cumulative``, the exporters' text, and the CLI's exit
  codes and stdout for ``report``, ``merge`` and ``diff`` equal the JAX
  package's (the merged trace's ``producer`` names each package).
"""

import contextlib
import io
import json
import os
import subprocess
import sys
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from tensorframes_tpu.observability import cli as jcli
from tensorframes_tpu.observability import merge as jmerge
from tensorframes_tpu.observability import metrics as jmetrics
from tensorframes_tpu.observability import snapshot as jsnapshot
from tensorframes_tpu_torch.observability import cli, context, events, merge, metrics, snapshot
from tensorframes_tpu_torch.observability.metrics import MetricsRegistry
from tensorframes_tpu_torch.serving import Router, RouterConfig

_REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
BENCH_ROUNDS = [os.path.join(_REPO, f"BENCH_r{i:02d}.json") for i in range(1, 6)]


def _env(run_id, rank):
    env = dict(os.environ)
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["TFTPU_RUN_ID"] = run_id
    env["TFTPU_PROCESS_INDEX"] = str(rank)
    env["OMP_NUM_THREADS"] = "1"
    return env


# one process of the run: real verb dispatches land executor spans on the
# timeline, then the shard is written into the shared directory
_WORKER = """
import os, sys
import numpy as np
import tensorframes_tpu_torch as tft
from tensorframes_tpu_torch.observability import events
events.enable()
df = tft.frame_from_arrays({"x": np.arange(64.0)}, num_blocks=2)
tft.map_blocks(lambda x: {"y": x * 2.0 + 1.0}, df, device="cpu").collect()
events.instant("worker.done", rank=int(os.environ["TFTPU_PROCESS_INDEX"]))
print("SHARD", events.save_shard(sys.argv[1]), flush=True)
"""


def _run_fleet(shard_dir, n, run_id="mergetest"):
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, shard_dir], env=_env(run_id, i),
                              cwd=_REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for i in range(n)]
    for i, p in enumerate(procs):
        try:
            out, err = p.communicate(timeout=120)
        finally:
            if p.poll() is None:
                p.kill()
        assert p.returncode == 0, f"worker {i} rc={p.returncode}\n{out}\n{err}"
        assert "SHARD" in out


def _check_merged(merged, n, run_id="mergetest"):
    merged = json.loads(json.dumps(merged))  # strict JSON, as Perfetto wants
    evs = merged["traceEvents"]
    assert {e["pid"] for e in evs} == set(range(n))
    names = {e["pid"]: e["args"]["name"] for e in evs
             if e.get("ph") == "M" and e["name"] == "process_name"}
    assert set(names) == set(range(n))
    for rank, label in names.items():
        assert label.startswith(f"process {rank}")
    for rank in range(n):
        rank_names = {e["name"] for e in evs if e["pid"] == rank}
        assert "executor.run_block" in rank_names
        assert "worker.done" in rank_names
    assert all(e["ts"] >= 0 for e in evs if "ts" in e)
    other = merged["otherData"]
    assert other["run_id"] == run_id
    assert other["num_shards"] == n
    assert len(other["processes"]) == n


def _without_producer(merged):
    other = dict(merged["otherData"])
    producer = other.pop("producer")
    return {**merged, "otherData": other}, producer


@pytest.fixture(scope="module")
def two_process_shards(tmp_path_factory):
    shard_dir = str(tmp_path_factory.mktemp("shards"))
    _run_fleet(shard_dir, 2)
    return shard_dir


def test_two_process_run_merges_into_one_timeline(two_process_shards, tmp_path):
    shards = merge.find_shards(two_process_shards, run_id="mergetest")
    assert [os.path.basename(p) for p in shards] == [
        "trace_mergetest_p0.json", "trace_mergetest_p1.json"]
    for i, p in enumerate(shards):
        other = json.load(open(p))["otherData"]
        assert other["run_id"] == "mergetest"
        assert other["process_index"] == i
        assert other["trace_epoch_unix_us"] > 0
    out_path = str(tmp_path / "merged.json")
    rc = cli.main(["merge", "--dir", two_process_shards, "--run-id", "mergetest",
                   "-o", out_path])
    assert rc == 0
    _check_merged(json.load(open(out_path)), 2)


def test_merge_matches_jax_on_the_same_shards(two_process_shards, tmp_path):
    shards = merge.find_shards(two_process_shards, run_id="mergetest")
    assert shards == jmerge.find_shards(two_process_shards, run_id="mergetest")
    extra = [_fake_shard(tmp_path, "mergetest", 5, 1_000_000),
             _fake_shard(tmp_path, "mergetest", 3, 2_500_000)]
    got, p_got = _without_producer(merge.merge_traces(shards + extra))
    want, p_want = _without_producer(jmerge.merge_traces(shards + extra))
    assert got == want
    assert (p_got, p_want) == ("tensorframes_tpu_torch.observability.merge",
                               "tensorframes_tpu.observability.merge")


# ---------------------------------------------------------------------------
# merge semantics (hand-made shards)
# ---------------------------------------------------------------------------

def _fake_shard(directory, run_id, rank, epoch_us, name="ev"):
    shard = {
        "traceEvents": [{"ph": "X", "name": name, "cat": "t", "ts": 10.0, "dur": 5.0,
                         "pid": 9999 + rank, "tid": 1}],
        "otherData": {"run_id": run_id, "process_index": rank, "pid": 9999 + rank,
                      "trace_epoch_unix_us": epoch_us, "dropped_events": rank},
    }
    path = directory / f"trace_{run_id}_p{rank}.json"
    path.write_text(json.dumps(shard))
    return str(path)


def test_merge_realigns_clocks_and_sums_drops(tmp_path):
    a = _fake_shard(tmp_path, "r1", 0, epoch_us=1_000_000)
    b = _fake_shard(tmp_path, "r1", 1, epoch_us=1_250_000)
    merged = merge.merge_traces([a, b])
    xs = {e["pid"]: e for e in merged["traceEvents"] if e["ph"] == "X"}
    assert xs[0]["ts"] == 10.0
    assert xs[1]["ts"] == 250_010.0  # shard 1 started 0.25 s later
    assert merged["otherData"]["dropped_events"] == 1


@pytest.mark.parametrize("case", ["mixed_runs", "duplicate_ranks"])
def test_merge_refusals_unless_forced_match_jax(tmp_path, case):
    a = _fake_shard(tmp_path, "runA", 0, 1_000_000)
    sub = tmp_path / "sub"
    sub.mkdir()
    if case == "mixed_runs":
        b = _fake_shard(sub, "runB", 1, 1_000_000)
        match = "different runs"
    else:
        b = _fake_shard(sub, "runA", 0, 2_000_000)
        match = "duplicate process_index"
    with pytest.raises(ValueError, match=match) as got:
        merge.merge_traces([a, b])
    with pytest.raises(ValueError) as want:
        jmerge.merge_traces([a, b])
    assert str(got.value) == str(want.value)
    forced, _ = _without_producer(merge.merge_traces([a, b], force=True))
    assert forced == _without_producer(jmerge.merge_traces([a, b], force=True))[0]
    if case == "mixed_runs":
        assert forced["otherData"]["run_id"] == ["runA", "runB"]


def test_load_shard_refuses_non_trace_json(tmp_path):
    p = tmp_path / "trace_x_p0.json"
    p.write_text(json.dumps({"events": []}))
    with pytest.raises(ValueError, match="not a Chrome trace"):
        merge.load_shard(str(p))
    with pytest.raises(ValueError, match="no shard paths"):
        merge.merge_traces([])


def test_context_env_binding(monkeypatch):
    monkeypatch.setenv("TFTPU_PROCESS_INDEX", "5")
    saved = (context._run_id, context._process_index, context._num_processes)
    context._reset_for_tests()
    try:
        assert context.process_index() == 5
        context.bind(process_index=2, num_processes=4)
        assert context.process_index() == 2  # an explicit bind beats the env
        assert context.num_processes() == 4
        env = context.child_env(3)
        assert env["TFTPU_PROCESS_INDEX"] == "3"
        assert env["TFTPU_RUN_ID"] == context.run_id()
    finally:
        context._reset_for_tests()
        context.bind(run_id=saved[0], process_index=saved[1], num_processes=saved[2])


def test_shard_metadata_rides_save(tmp_path):
    was_enabled = events.TRACER.enabled
    events.enable()
    try:
        with events.span("meta-probe"):
            pass
        path = events.save_shard(str(tmp_path))
        other = json.load(open(path))["otherData"]
        assert other["run_id"] == context.run_id()
        assert other["process_index"] == context.process_index()
        assert other["trace_epoch_unix_us"] > 0
        assert os.path.basename(path) == (
            f"trace_{context.run_id()}_p{context.process_index()}.json")
    finally:
        if not was_enabled:
            events.disable()


# ---------------------------------------------------------------------------
# a router and a replica process: one request id across both
# ---------------------------------------------------------------------------

# the replica process: one scoring endpoint over HTTP with the tracer on;
# writes its bound port for the parent and saves its shard once the
# parent's done file appears
_REPLICA = """
import os, sys, time
import tensorframes_tpu_torch as tft
from tensorframes_tpu_torch.observability import events
from tensorframes_tpu_torch.serving import Server, ServingConfig, serve_http

shard_dir, port_file, done_file = sys.argv[1:4]
events.enable()
holder = type("F", (), {"schema": tft.Schema([
    tft.ColumnInfo("x", tft.dtypes.float32, tft.Shape((tft.Unknown, 4)))])})()
program = tft.compile_program(lambda x: {"y": x * 2.0 + 1.0}, holder, block=False,
                              device="cpu")
srv = Server(ServingConfig(max_batch_rows=8, max_latency_s=0.002, max_queue_rows=128),
             device="cpu")
srv.register("score", program)
srv.start()
httpd = serve_http(srv)
with open(port_file + ".tmp", "w") as f:
    f.write(str(httpd.server_address[1]))
os.replace(port_file + ".tmp", port_file)
deadline = time.monotonic() + 60.0
while not os.path.exists(done_file) and time.monotonic() < deadline:
    time.sleep(0.02)
httpd.shutdown()
srv.stop(drain=True)
print("SHARD", events.save_shard(shard_dir), flush=True)
"""


def _spans(name):
    return [e for e in events.to_chrome_trace()["traceEvents"]
            if e.get("name") == name and e.get("ph") == "X"]


def test_two_process_trace_merges_with_one_request_id(tmp_path):
    run_id = "tracehop"
    shard_dir = str(tmp_path / "shards")
    os.makedirs(shard_dir)
    port_file, done_file = str(tmp_path / "port"), str(tmp_path / "done")
    proc = subprocess.Popen([sys.executable, "-c", _REPLICA, shard_dir, port_file, done_file],
                            env=_env(run_id, 1), cwd=_REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    saved = (context._run_id, context._process_index, context._num_processes)
    context._reset_for_tests()
    context.bind(run_id=run_id, process_index=0)
    was_enabled = events.TRACER.enabled
    events.clear()
    events.enable()
    router = None
    try:
        deadline = time.monotonic() + 60.0
        while not os.path.exists(port_file):
            assert time.monotonic() < deadline, "replica never came up"
            assert proc.poll() is None, proc.communicate()[1]
            time.sleep(0.02)
        port = int(open(port_file).read())
        router = Router(replicas={1: f"127.0.0.1:{port}"}, config=RouterConfig(poll_s=0.05))
        router.start()
        while router.live_count() < 1 and time.monotonic() < deadline:
            time.sleep(0.02)
        status, body = router.dispatch("score", {"inputs": {"x": [[1.0] * 4]}},
                                       deadline_s=30.0)
        assert status == 200, body
        router.stop()
        router = None
        ingress = _spans("router.request")
        assert len(ingress) == 1
        rid = ingress[0]["args"]["request_id"]
        events.save_shard(shard_dir)
        open(done_file, "w").close()
        out, err = proc.communicate(timeout=60)
        assert proc.returncode == 0, f"stdout: {out}\nstderr: {err}"
        assert "SHARD" in out
    finally:
        if router is not None:
            router.stop()
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
        events.clear()
        if not was_enabled:
            events.disable()
        context._reset_for_tests()
        context.bind(run_id=saved[0], process_index=saved[1], num_processes=saved[2])

    shards = merge.find_shards(shard_dir, run_id=run_id)
    assert len(shards) == 2
    merged = json.loads(json.dumps(merge.merge_traces(shards)))
    evs = merged["traceEvents"]
    assert merged["otherData"]["run_id"] == run_id
    # one request id spans both processes: the ingress span on pid 0, the
    # replica's request and flush spans on pid 1
    ingress = [e for e in evs if e.get("name") == "router.request"
               and e["args"].get("request_id") == rid]
    served = [e for e in evs if e.get("name") == "serving.request"
              and e["args"].get("request_id") == rid]
    flushes = [e for e in evs if e.get("name") == "serving.flush"
               and rid in e["args"].get("request_ids", [])]
    assert len(ingress) == 1 and ingress[0]["pid"] == 0
    assert len(served) == 1 and served[0]["pid"] == 1
    assert len(flushes) == 1 and flushes[0]["pid"] == 1


# ---------------------------------------------------------------------------
# exporters and quantiles
# ---------------------------------------------------------------------------

def _fill(reg):
    reg.counter("t_ops_total", "ops help", labels={"site": 'a"b\\c'}).inc(3)
    reg.gauge("t_depth", "depth help").set(1.5)
    h = reg.histogram("t_lat_seconds", buckets=(0.1, 1.0))
    for v in (0.5, 0.05, 7.0):
        h.observe(v)
    return reg


def test_prometheus_exposition_format_matches_jax():
    text = _fill(MetricsRegistry()).to_prometheus()
    assert text == _fill(jmetrics.MetricsRegistry()).to_prometheus()
    lines = text.splitlines()
    assert "# HELP t_ops_total ops help" in lines
    assert "# TYPE t_ops_total counter" in lines
    assert 't_ops_total{site="a\\"b\\\\c"} 3' in lines
    assert "t_depth 1.5" in lines
    assert 't_lat_seconds_bucket{le="0.1"} 1' in lines
    assert 't_lat_seconds_bucket{le="1"} 2' in lines
    assert 't_lat_seconds_bucket{le="+Inf"} 3' in lines
    assert "t_lat_seconds_sum 7.55" in lines
    assert "t_lat_seconds_count 3" in lines
    assert lines.index("# TYPE t_ops_total counter") < lines.index(
        't_ops_total{site="a\\"b\\\\c"} 3')


def test_jsonl_round_trips_and_carries_run_context(tmp_path):
    reg = _fill(MetricsRegistry())
    rows = [json.loads(line) for line in reg.to_jsonl().splitlines()]
    by_name = {r["name"]: r for r in rows}
    assert by_name["t_ops_total"]["value"] == 3
    assert by_name["t_lat_seconds"]["buckets"]["+Inf"] == 3
    assert all(r["run_id"] == context.run_id() and "ts" in r for r in rows)
    jrows = [json.loads(line) for line in _fill(jmetrics.MetricsRegistry()).to_jsonl()
             .splitlines()]
    strip = ("ts", "run_id", "process_index")
    assert [{k: v for k, v in r.items() if k not in strip} for r in rows] == \
        [{k: v for k, v in r.items() if k not in strip} for r in jrows]
    # either package's loader reads the port's export the same way
    path = tmp_path / "metrics.jsonl"
    reg.write_jsonl(str(path))
    assert snapshot.load_metrics(str(path)) == jsnapshot.load_metrics(str(path))
    assert snapshot.load_metrics(str(path))[0]["t_lat_seconds.p50"] == pytest.approx(0.55)


def test_metrics_server_serves_prometheus_and_jsonl():
    reg = MetricsRegistry()
    reg.counter("t_scraped_total").inc(9)
    server = metrics.metrics_server(port=0, registry=reg)
    try:
        port = server.server_address[1]
        body = urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                      timeout=10).read().decode()
        assert "t_scraped_total 9" in body
        jl = urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics.json",
                                    timeout=10).read().decode()
        assert json.loads(jl.splitlines()[0])["name"] == "t_scraped_total"
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"http://127.0.0.1:{port}/nope", timeout=10)
    finally:
        server.shutdown()
        server.server_close()


def test_histogram_quantile_interpolates():
    reg = MetricsRegistry()
    h = reg.histogram("t_lat_q", buckets=(0.1, 0.2, 0.4, 1.0))
    assert h.quantile(0.5) is None
    for v in (0.05,) * 50 + (0.15,) * 30 + (0.3,) * 15 + (0.8,) * 5:
        h.observe(v)
    assert h.quantile(0.5) == pytest.approx(0.1)
    assert h.quantile(0.8) == pytest.approx(0.2)
    assert h.quantile(0.95) == pytest.approx(0.4)
    assert h.quantile(0.9) == pytest.approx(0.2 + 0.2 * (10 / 15))
    with pytest.raises(ValueError):
        h.quantile(1.5)
    h2 = reg.histogram("t_lat_q2", buckets=(0.1,))
    h2.observe(5.0)
    assert h2.quantile(0.99) == 0.1  # +Inf clamps to the largest finite bound


def test_quantile_from_cumulative_matches_jax():
    rng = np.random.default_rng(11)
    for trial in range(50):
        bounds = np.sort(rng.uniform(0.001, 10.0, size=rng.integers(1, 8)))
        counts = np.cumsum(rng.integers(0, 20, size=len(bounds)))
        total = int(counts[-1]) + int(rng.integers(0, 5))
        cum = [(float(b), int(c)) for b, c in zip(bounds, counts)]
        if trial % 2:
            cum.append((float("inf"), total))
        for q in (0.01, 0.5, 0.9, 0.95, 0.99):
            got = metrics.quantile_from_cumulative(cum, total, q)
            assert got == jmetrics.quantile_from_cumulative(cum, total, q)
    assert metrics.quantile_from_cumulative([], 0, 0.5) is None
    assert metrics.quantile_from_cumulative([(float("inf"), 3)], 3, 0.5) is None


# ---------------------------------------------------------------------------
# snapshots and the diff
# ---------------------------------------------------------------------------

def test_load_and_diff_bench_rounds_match_jax():
    loaded = {}
    for path in BENCH_ROUNDS:
        got = snapshot.load_metrics(path)
        assert got == jsnapshot.load_metrics(path)
        assert got[1]["source"] == "bench-round" and got[0]
        loaded[path] = got[0]
    for old in BENCH_ROUNDS:
        for new in BENCH_ROUNDS:
            for kw in ({}, {"threshold": 0.1, "per_metric": {"headline.value": 0.01}}):
                assert snapshot.diff_metrics(loaded[old], loaded[new], **kw) == \
                    jsnapshot.diff_metrics(loaded[old], loaded[new], **kw)
    assert loaded[BENCH_ROUNDS[4]]["gpt_tiny_decode_tokens_per_sec"] == 31166.0


def test_snapshot_round_trip_and_bench_text(tmp_path):
    path = snapshot.write_snapshot(str(tmp_path / "snap.json"),
                                   {"x_rows_per_sec": 10.0, "note": "text"}, meta={"k": 1})
    got, meta = snapshot.load_metrics(path)
    # the process's latency histograms ride along as latency.<series>.<q>
    assert {k: v for k, v in got.items() if not k.startswith("latency.")} == \
        {"x_rows_per_sec": 10.0}
    assert meta["source"] == "snapshot" and meta["run_id"] == context.run_id()
    assert jsnapshot.load_metrics(path) == (got, meta)
    text = ("# add3_rows_per_sec=123456\n"
            "# latency | verb:map_blocks count=12 p50=0.000120s p95=0.000500s "
            "p99=0.000900s mean=0.000200s\n"
            '{"metric": "headline", "value": 75.5}\n')
    m = snapshot.parse_bench_text(text)
    assert m == jsnapshot.parse_bench_text(text)
    assert m["latency.verb:map_blocks.p50"] == pytest.approx(0.00012)
    assert m["headline.value"] == 75.5
    for name in ("x_rows_per_sec", "chain3_wall_s", "tftpu_x_total", "a.p99", "mystery"):
        assert snapshot.direction(name) == jsnapshot.direction(name)


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------

def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
        try:
            rc = main(argv)
        except SystemExit as e:  # argparse refusals
            rc = e.code
    return rc, out.getvalue()


def _write_snap(path, metrics_, latency=None):
    path.write_text(json.dumps({"schema": snapshot.SCHEMA, "metrics": metrics_,
                                "latency": latency or {}}))
    return str(path)


def _cli_cases(tmp_path, shard_dir):
    a = _write_snap(tmp_path / "a.json", {"chain3_wall_s": 0.02, "x_rows_per_sec": 1000.0},
                    {"verb:map_blocks": {"count": 5, "mean": 0.01, "p50": 0.01,
                                         "p95": 0.02, "p99": 0.03}})
    b = _write_snap(tmp_path / "b.json", {"chain3_wall_s": 0.04, "x_rows_per_sec": 800.0},
                    {"verb:map_blocks": {"count": 5, "mean": 0.02, "p50": 0.02,
                                         "p95": 0.04, "p99": 0.06}})
    c = _write_snap(tmp_path / "c.json", {"right_only_wall_s": 1.0})
    jsonl = tmp_path / "metrics.jsonl"
    _fill(MetricsRegistry()).write_jsonl(str(jsonl))
    empty = tmp_path / "empty.txt"
    empty.write_text("nothing here\n")
    sidecar = tmp_path / "planstats"
    sidecar.mkdir()
    (sidecar / "deadbeef.json").write_text("{not json")
    r1, r5 = BENCH_ROUNDS[0], BENCH_ROUNDS[4]
    merged = str(tmp_path / "merged.json")
    return [
        ["report", r5], ["report", str(jsonl)], ["report", str(empty)], ["report"],
        ["report", "--profile", str(sidecar)],
        ["merge", "--dir", shard_dir, "--run-id", "mergetest", "-o", merged],
        ["merge", "-o", merged], ["merge", "--dir", shard_dir, "--run-id", "nope", "-o", merged],
        ["diff", a, b], ["diff", a, b, "--warn-only"], ["diff", b, a], ["diff", a, a],
        ["diff", a, c], ["diff", a, c, "--warn-only"], ["diff", a, b, "--json"],
        ["diff", a, b, "--metric", "x_rows_per_sec=0.1", "--all"],
        ["diff", r1, r5, "--all"], ["diff", r5, r1, "--json"],
        ["diff", a, b, "--metric", "bad"],
    ]


def test_cli_exit_codes_and_stdout_match_jax(two_process_shards, tmp_path):
    cases = _cli_cases(tmp_path, two_process_shards)
    rcs = []
    for argv in cases:
        got = _run(cli.main, argv)
        want = _run(jcli.main, argv)
        assert got == want, argv
        rcs.append(got[0])
    assert rcs[:-1] == [0, 0, 1, 2, 0, 0, 2, 2, 1, 0, 0, 0, 2, 0, 1, 1, 0, 0]
    assert rcs[-1] == "--metric expects NAME=THRESHOLD (numeric), got 'bad'"


def test_module_entry_point(tmp_path):
    """``python -m tensorframes_tpu_torch.observability`` runs the CLI."""
    a = _write_snap(tmp_path / "a.json", {"x_rows_per_sec": 1000.0})
    out = subprocess.run([sys.executable, "-m", "tensorframes_tpu_torch.observability",
                          "diff", a, a], env=_env("cli", 0), cwd=str(tmp_path),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "# compared 1 common metric(s): 0 regression(s), 0 improvement(s)" in out.stdout
