"""The port's structured event timeline (``observability/events.py``):
Chrome ``trace_event`` JSON with the reference's keys, spans that nest by
time containment, instants, bounded buffers with a counted drop, per-process
shards, the buffer abandoned in a forked child, and the spans the port's
verbs, executor and plan layer emit."""

import json
import os

import numpy as np
import pytest

from tensorframes_tpu.observability import events as jevents

import tensorframes_tpu_torch as tft
from tensorframes_tpu_torch.observability import events
from tensorframes_tpu_torch.observability.metrics import REGISTRY
from tensorframes_tpu_torch.utils import profiling


@pytest.fixture(autouse=True)
def _fresh_tracer():
    was, device = events.TRACER.enabled, tft.get_config().device
    events.clear()
    yield
    events.TRACER.enabled = was
    events.clear()
    tft.configure(device=device)


def _dropped_total():
    for d in REGISTRY.snapshot():
        if d["name"] == "tftpu_trace_events_dropped_total":
            return float(d["value"])
    return 0.0


def test_chrome_trace_has_the_reference_keys():
    events.enable()
    with events.span("outer", rows=3):
        events.instant("mark", step=7)
    trace = events.to_chrome_trace()
    jtrace = jevents.Tracer().to_chrome_trace()
    assert set(trace) == set(jtrace) == {"traceEvents", "displayTimeUnit", "otherData"}
    assert set(trace["otherData"]) == set(jtrace["otherData"])
    assert trace["otherData"]["producer"] == "tensorframes_tpu_torch.observability.events"
    meta, mark, outer = trace["traceEvents"]
    assert meta["ph"] == "M" and meta["name"] == "thread_name"
    assert mark["ph"] == "i" and mark["s"] == "t" and mark["args"] == {"step": 7}
    assert outer["ph"] == "X" and outer["args"] == {"rows": 3}
    for ev in (mark, outer):
        assert {"name", "cat", "ts", "pid", "tid"} <= set(ev)
        assert ev["pid"] == os.getpid()
    json.dumps(trace)  # strict JSON


def test_spans_nest_by_time_containment():
    events.enable()
    with events.span("outer"):
        with events.span("inner"):
            pass
    evs = {e["name"]: e for e in events.to_chrome_trace()["traceEvents"] if e["ph"] == "X"}
    o, i = evs["outer"], evs["inner"]
    assert o["ts"] <= i["ts"] and i["ts"] + i["dur"] <= o["ts"] + o["dur"] + 1e-3
    assert o["tid"] == i["tid"]


def test_disabled_tracer_records_nothing_and_args_are_cleaned():
    with events.span("off"):
        events.instant("off")
    assert events.to_chrome_trace()["traceEvents"] == []
    events.enable()
    events.instant("args", a=np.float32(1.5), b=float("nan"), c=object(), d=None)
    (ev,) = [e for e in events.to_chrome_trace()["traceEvents"] if e["ph"] == "i"]
    assert ev["args"]["a"] == 1.5 and ev["args"]["b"] is None and ev["args"]["d"] is None
    assert isinstance(ev["args"]["c"], str)


def test_full_buffer_drops_and_counts():
    tr = events.Tracer(max_events=3)
    tr.enable()
    d0 = _dropped_total()
    for k in range(5):
        tr.instant(f"e{k}")
    assert len(tr.to_chrome_trace()["traceEvents"]) == 3  # thread_name + 2
    assert tr.dropped == 3 and tr.to_chrome_trace()["otherData"]["dropped_events"] == 3
    assert _dropped_total() == d0 + 3


def test_save_and_save_shard(tmp_path, monkeypatch):
    monkeypatch.setenv("TFTPU_PROCESS_INDEX", "3")
    events.enable()
    events.instant("x")
    path = events.save(str(tmp_path / "trace.json"))
    assert json.load(open(path))["traceEvents"][-1]["name"] == "x"
    shard = events.save_shard(str(tmp_path / "shards"))
    assert os.path.basename(shard) == f"trace_{events.run_id()}_p3.json"
    data = json.load(open(shard))
    assert data["otherData"]["process_index"] == 3
    assert data["otherData"]["run_id"] == events.run_id()


@pytest.mark.skipif(not hasattr(os, "fork"), reason="needs fork")
def test_buffer_abandoned_after_fork():
    """In a fresh single-threaded process (forking this one, which runs
    JAX's threads, is unsafe): a forked child starts with an empty buffer
    and tracing still on; the parent keeps its events."""
    import subprocess
    import sys
    from pathlib import Path

    code = (
        "import json, os\n"
        "from tensorframes_tpu_torch.observability import events\n"
        "events.enable()\n"
        "events.instant('parent')\n"
        "r, w = os.pipe()\n"
        "pid = os.fork()\n"
        "if pid == 0:\n"
        "    events.instant('child')\n"
        "    names = [e['name'] for e in events.to_chrome_trace()['traceEvents'] if e['ph'] != 'M']\n"
        "    os.write(w, json.dumps([names, events.TRACER.enabled]).encode())\n"
        "    os._exit(0)\n"
        "os.close(w)\n"
        "child = json.loads(os.read(r, 4096).decode())\n"
        "os.waitpid(pid, 0)\n"
        "parent = [e['name'] for e in events.to_chrome_trace()['traceEvents'] if e['ph'] != 'M']\n"
        "print(json.dumps([child, parent]))\n"
    )
    root = Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=root, env=dict(os.environ, PYTHONPATH=str(root)))
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout) == [[["child"], True], ["parent"]]


def test_verbs_executor_and_plan_emit_spans():
    tft.configure(device="cpu")
    events.enable()
    profiling.record("custom", 0.001, rows=4)
    with profiling.span("spanned", rows=2):
        pass
    fr = tft.frame_from_arrays({"x": np.arange(8, dtype=np.float32), "k": np.arange(8) % 2},
                               num_blocks=2)
    f2 = tft.map_blocks(lambda y: {"z": y * 2.0}, tft.map_blocks(lambda x: {"y": x + 1.0}, fr))
    with tft.with_graph():
        z_in = tft.block(f2, "z", tf_name="z_input")
        tft.aggregate(tft.reduce_sum(z_in, axis=0, name="z"), f2.group_by("k")).blocks()
    evs = events.to_chrome_trace()["traceEvents"]
    names = {e["name"] for e in evs}
    assert {"custom", "spanned", "executor.run_block", "aggregate", "plan.execute",
            "plan.cost"} <= names
    cost = [e for e in evs if e["name"] == "plan.cost"]
    assert {e["args"]["decision"] for e in cost} >= {"epilogue_concat"}
    spanned = next(e for e in evs if e["name"] == "spanned")
    assert spanned["cat"] == "profiling" and spanned["args"] == {"rows": 2}
