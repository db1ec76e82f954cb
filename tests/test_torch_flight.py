"""The port's flight recorder (``observability/flight.py``), run context
(``observability/context.py``) and step telemetry (``observability/steps.py``)
on the CPU: the cases of the JAX package's ``test_flight.py`` that need no
fleet or serving — ring, redaction, dispatch records, dump triggers, the
crash excepthook and the kill -9 black box — and the ``StepTelemetry``
cases of its ``test_observability.py``. Record kinds, JSONL keys and metric
names are held against the reference package's.

Tolerances: none."""

import json
import math
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import tensorframes_tpu_torch as tft
from tensorframes_tpu_torch.observability import context, events, flight
from tensorframes_tpu_torch.observability.metrics import REGISTRY, MetricsRegistry
from tensorframes_tpu_torch.observability.steps import StepTelemetry, extract_loss
from tensorframes_tpu_torch.resilience import faults

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"


@pytest.fixture(autouse=True)
def _fresh_recorder():
    saved_dir = flight.RECORDER.spool_dir
    flight.RECORDER.set_spool_dir(None)
    flight.RECORDER.clear()
    yield
    flight.RECORDER.set_spool_dir(saved_dir)
    flight.RECORDER.clear()


# ---------------------------------------------------------------------------
# ring, redaction, dispatch records
# ---------------------------------------------------------------------------

def test_ring_is_bounded_and_ordered():
    rec = flight.FlightRecorder(capacity=5)
    for i in range(12):
        rec.record("tick", i=i)
    got = rec.records()
    assert [r["i"] for r in got] == [7, 8, 9, 10, 11] and rec.total_records == 12
    assert [r["seq"] for r in got] == sorted(r["seq"] for r in got)


def test_redaction_blanks_secrets_and_tensor_contents():
    fields = flight.redact_fields({
        "api_key": "sk-123456", "auth_token": "abc", "weights": torch.arange(1000.0),
        "host": np.arange(10.0), "note": "x" * 500, "n": 7, "frac": 0.5, "bad": math.nan,
    })
    assert fields["api_key"] == fields["auth_token"] == "[redacted]"
    assert fields["weights"] == "<array shape=(1000,) dtype=torch.float32>"
    assert fields["host"].startswith("<array shape=(10,)")
    assert len(fields["note"]) < 250 and fields["n"] == 7 and fields["frac"] == 0.5
    assert fields["bad"] == "nan"
    json.dumps(fields)


def test_dispatches_are_recorded_with_shapes():
    df = tft.frame_from_arrays({"x": np.arange(16.0)}, num_blocks=2)
    tft.map_blocks(lambda x: {"y": x + 1.0}, df, device=CPU).column_values("y")
    dispatches = [r for r in flight.RECORDER.records() if r["kind"] == "dispatch"]
    assert len(dispatches) >= 2
    d = dispatches[-1]
    assert d["entry"] == "block" and "y" in d["outputs"] and d["shapes"]["x"] == [8]
    assert d["seconds"] >= 0


def test_failing_dispatch_recorded_before_error_propagates():
    df = tft.frame_from_arrays({"x": np.arange(8.0)}, num_blocks=1)
    with faults.inject("executor.run_block", RuntimeError("chip fell off")):
        with pytest.raises(RuntimeError):
            tft.map_blocks(lambda x: {"y": x * 2.0}, df, device=CPU).column_values("y")
    kinds = [r["kind"] for r in flight.RECORDER.records()]
    assert "fault.injected" in kinds
    errs = [r for r in flight.RECORDER.records() if r["kind"] == "dispatch.error"]
    assert errs and errs[-1]["error"] == "RuntimeError"
    assert "chip fell off" in errs[-1]["message"] and errs[-1]["shapes"]["x"] == [8]


def test_retry_and_guard_records():
    from tensorframes_tpu_torch.resilience import RetryError, RetryPolicy, StepGuard, retry_call

    with pytest.raises(RetryError):
        retry_call(lambda: (_ for _ in ()).throw(OSError("wobble")),
                   policy=RetryPolicy(max_attempts=2, backoff=0.0, seed=0))
    kinds = [r["kind"] for r in flight.RECORDER.records()]
    assert "retry" in kinds and "retry.exhausted" in kinds
    StepGuard(policy="skip", check="metrics").admit(1, {"w": 1.0}, {"loss": math.nan},
                                                     prev_state={"w": 0.0})
    trips = [r for r in flight.RECORDER.records() if r["kind"] == "guard.trip"]
    assert trips and trips[-1]["policy"] == "skip"


def test_checkpoint_records(tmp_path):
    ck = tft.Checkpointer(str(tmp_path))
    ck.save(1, {"w": torch.ones(2)})
    ck.restore(like={"w": torch.zeros(2)})
    recs = {r["kind"]: r for r in flight.RECORDER.records()}
    assert recs["checkpoint.save"]["step"] == 1 and recs["checkpoint.save"]["bytes"] > 0
    assert recs["checkpoint.restore"]["ok"] is True


# ---------------------------------------------------------------------------
# dump triggers
# ---------------------------------------------------------------------------

def test_manual_dump_writes_header_then_ring(tmp_path):
    flight.record("tick", i=1)
    flight.record("tick", i=2)
    path = str(tmp_path / "pm.jsonl")
    assert flight.dump(path, reason="test", exc=ValueError("boom")) == path
    rows = [json.loads(ln) for ln in open(path)]
    assert rows[0]["kind"] == "postmortem" and rows[0]["reason"] == "test"
    assert rows[0]["error"] == "ValueError"
    assert rows[0]["run_id"] == context.run_id()
    assert rows[0]["process_index"] == context.process_index()
    assert [r["i"] for r in rows[1:] if r["kind"] == "tick"] == [1, 2]


def test_dump_without_spool_dir_is_a_noop():
    flight.record("tick")
    assert flight.dump(reason="nowhere-to-write") is None


def test_repeated_dumps_never_overwrite(tmp_path):
    flight.set_spool_dir(str(tmp_path))
    flight.record("tick", i=1)
    p1 = flight.dump(reason="guard-raise")
    flight.record("tick", i=2)
    p2 = flight.dump(reason="crash")
    assert p1 != p2 and os.path.exists(p1) and os.path.exists(p2)
    first = [json.loads(ln) for ln in open(p1)]
    assert first[0]["reason"] == "guard-raise" and [r.get("i") for r in first[1:]] == [1]


def test_guard_raise_dumps_postmortem(tmp_path):
    from tensorframes_tpu_torch.resilience import NonFiniteError, StepGuard

    flight.set_spool_dir(str(tmp_path))
    with pytest.raises(NonFiniteError):
        StepGuard(policy="raise", check="metrics").admit(3, {"w": 1.0}, {"loss": math.inf},
                                                         prev_state={"w": 0.0})
    dumps = [f for f in os.listdir(tmp_path) if f.startswith("postmortem_")]
    assert len(dumps) == 1
    rows = [json.loads(ln) for ln in open(tmp_path / dumps[0])]
    assert rows[0]["reason"] == "guard-raise" and rows[0]["error"] == "NonFiniteError"
    assert any(r["kind"] == "guard.trip" for r in rows[1:])


def test_spool_rotation_bounds_disk(tmp_path):
    rec = flight.FlightRecorder(capacity=10, spool_dir=str(tmp_path))
    for i in range(55):
        rec.record("tick", i=i)
    files = [f for f in os.listdir(tmp_path) if f.startswith("flight_")]
    assert len(files) == 2
    assert sum(len(open(tmp_path / f).read().splitlines()) for f in files) <= 20


# the executor's block dispatch, called directly (the verbs' program
# analysis would add seconds to each subprocess)
_CRASHER = """
import sys, time
import numpy as np
from tensorframes_tpu_torch import dtypes, program, shape
from tensorframes_tpu_torch.ops.executor import CompiledProgram
from tensorframes_tpu_torch.resilience import faults
mode = sys.argv[1]
spec = lambda n: program.TensorSpec(n, dtypes.by_name("float64"), shape.Shape([-1]))
compiled = CompiledProgram(program.Program(lambda f: {"y": f["x"] * 3.0}, [spec("x")], [spec("y")]))
run = lambda: compiled.run_block({"x": np.arange(8.0)}, "cpu")
run()
print("READY", flush=True)
if mode == "uncaught":
    with faults.inject("executor.run_block", RuntimeError("injected loss")):
        run()
else:
    while True:
        run()
        time.sleep(0.01)
"""


def _spawn_crasher(flight_dir, mode):
    env = dict(os.environ, PYTHONPATH=str(ROOT), TFTPU_FLIGHT_DIR=flight_dir,
               TFTPU_RUN_ID="flighttest")
    return subprocess.Popen([sys.executable, "-c", _CRASHER, mode], env=env, cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def test_uncaught_fault_injection_leaves_postmortem_with_dispatch(tmp_path):
    fdir = str(tmp_path / "flight")
    proc = _spawn_crasher(fdir, "uncaught")
    out, err = proc.communicate(timeout=60)
    assert proc.returncode != 0 and "READY" in out
    dumps = [f for f in os.listdir(fdir) if f.startswith("postmortem_")]
    assert len(dumps) == 1, (os.listdir(fdir), err)
    rows = [json.loads(ln) for ln in open(os.path.join(fdir, dumps[0]))]
    assert rows[0]["reason"] == "crash" and rows[0]["run_id"] == "flighttest"
    assert rows[0]["error"] == "RuntimeError"
    kinds = [r["kind"] for r in rows[1:]]
    assert "dispatch" in kinds and "fault.injected" in kinds
    errs = [r for r in rows[1:] if r["kind"] == "dispatch.error"]
    assert errs and "injected loss" in errs[-1]["message"]


def test_kill9_leaves_recoverable_blackbox(tmp_path):
    fdir = str(tmp_path / "flight")
    proc = _spawn_crasher(fdir, "spin")
    try:
        deadline = time.time() + 60
        while time.time() < deadline:
            if os.path.isdir(fdir) and any(
                    os.path.getsize(os.path.join(fdir, f)) > 500
                    for f in os.listdir(fdir) if f.startswith("flight_")):
                break
            if proc.poll() is not None:
                out, err = proc.communicate(timeout=60)
                raise AssertionError(f"crasher exited early ({proc.returncode})\n{out}\n{err}")
            time.sleep(0.02)
        os.kill(proc.pid, signal.SIGKILL)
        proc.communicate(timeout=60)
        assert proc.returncode == -signal.SIGKILL
    finally:
        if proc.poll() is None:  # pragma: no cover
            proc.kill()
            proc.wait(timeout=60)
    records = flight.read_blackbox(fdir)
    dispatches = [r for r in records if r["kind"] == "dispatch"]
    assert dispatches and dispatches[-1]["entry"] == "block"
    assert dispatches[-1]["shapes"]["x"] == [8]
    assert [r["seq"] for r in records] == sorted(r["seq"] for r in records)


# ---------------------------------------------------------------------------
# run context
# ---------------------------------------------------------------------------

def test_context_resolution_bind_and_child_env(monkeypatch):
    context._reset_for_tests()
    try:
        monkeypatch.setenv("TFTPU_RUN_ID", "r1")
        monkeypatch.setenv("RANK", "5")
        monkeypatch.delenv("TFTPU_PROCESS_INDEX", raising=False)
        assert context.snapshot() == {"run_id": "r1", "process_index": 5}
        monkeypatch.setenv("TFTPU_PROCESS_INDEX", "2")
        assert context.process_index() == 2
        context.bind(process_index=3, num_processes=4)
        assert (context.process_index(), context.num_processes()) == (3, 4)
        assert context.child_env(1) == {"TFTPU_RUN_ID": "r1", "TFTPU_PROCESS_INDEX": "1"}
        assert events.run_id() == "r1" and events.process_index() == 3
        with context.request_scope("req-1"):
            assert context.current_request() == "req-1"
        assert context.current_request() is None
        assert context.parse_trace_header(context.trace_header_value("q")) == ("q", "r1")
        assert context.parse_trace_header(None) == (None, None)
    finally:
        context._reset_for_tests()


# ---------------------------------------------------------------------------
# StepTelemetry (the reference's test_observability.py cases)
# ---------------------------------------------------------------------------

def test_step_log_rows_carry_run_context_and_the_reference_keys(tmp_path):
    path = tmp_path / "steps.jsonl"
    with StepTelemetry(jsonl_path=str(path), rows_per_step=8) as t:
        t(1, {"loss": 0.5})
        t(2, torch.tensor(0.25))
        t(3, {"loss": torch.tensor(math.nan)})
    rows = [json.loads(ln) for ln in path.read_text().splitlines()]
    assert [r["step"] for r in rows] == [1, 2, 3]
    assert [r["loss"] for r in rows] == [0.5, 0.25, None]
    for r in rows:
        assert list(r) == ["step", "ts", "step_seconds", "loss", "rows_per_sec", "run_id",
                           "process_index"]
        assert r["run_id"] == context.run_id() and r["rows_per_sec"] > 0


def test_extract_loss():
    assert extract_loss({"loss": torch.tensor(1.5)}) == 1.5
    assert extract_loss(torch.tensor(2.0, dtype=torch.bfloat16)) == 2.0
    assert extract_loss(np.float32(3.0)) == 3.0
    assert extract_loss({"acc": 1.0}) is None
    assert extract_loss(torch.ones(2)) is None and extract_loss("x") is None


def test_step_metrics_names_match_the_reference():
    from tensorframes_tpu.observability import steps as jsteps  # noqa: F401
    from tensorframes_tpu.observability.metrics import REGISTRY as JREG

    names = {"tftpu_train_steps_total", "tftpu_train_step_seconds", "tftpu_train_loss",
             "tftpu_train_rows_per_sec"}
    port = {d["name"]: d["kind"] for d in REGISTRY.snapshot() if d["name"] in names}
    ref = {d["name"]: d["kind"] for d in JREG.snapshot() if d["name"] in names}
    assert port == ref and set(port) == names
    reg = MetricsRegistry()
    t = StepTelemetry(registry=reg, rows_per_step=4)
    t(1, 0.75)
    snap = {d["name"]: d for d in reg.snapshot()}
    assert snap["tftpu_train_steps_total"]["value"] == 1
    assert snap["tftpu_train_loss"]["value"] == 0.75


def test_train_on_frame_emits_full_telemetry(tmp_path):
    """One train_on_frame run with a checkpointer, a guard and telemetry:
    the trace holds train.step and checkpoint.save, the registry the train
    counters, the step log one finite row per step."""
    events.enable()
    events.clear()
    try:
        rng = np.random.default_rng(0)
        frame = tft.frame_from_arrays({
            "x": rng.standard_normal((256, 4)).astype(np.float32),
            "y": rng.standard_normal(256).astype(np.float32)})

        def step(w, batch):
            w = w.clone().requires_grad_(True)
            loss = ((batch["x"] @ w - batch["y"]) ** 2).mean()
            (g,) = torch.autograd.grad(loss, [w])
            w = (w - 0.01 * g).detach()
            return w, {"loss": ((batch["x"] @ w - batch["y"]) ** 2).mean()}

        before = sum(d["value"] for d in REGISTRY.snapshot()
                     if d["name"] == "tftpu_train_steps_total")
        log = tmp_path / "steps.jsonl"
        with StepTelemetry(jsonl_path=str(log)) as telemetry:
            _, ran = tft.training.train_on_frame(
                step, torch.zeros(4), frame, ["x", "y"], batch_size=64, num_steps=4,
                checkpointer=tft.Checkpointer(str(tmp_path / "ck")), save_every=2,
                guard="skip", telemetry=telemetry, device=CPU)
        assert ran == 4
        names = {e["name"] for e in events.to_chrome_trace()["traceEvents"]}
        assert {"train.step", "checkpoint.save"} <= names
        after = sum(d["value"] for d in REGISTRY.snapshot()
                    if d["name"] == "tftpu_train_steps_total")
        assert after - before == 4
        rows = [json.loads(x) for x in log.read_text().splitlines()]
        assert [r["step"] for r in rows] == [1, 2, 3, 4]
        assert all(np.isfinite(r["loss"]) and r["rows_per_sec"] > 0 for r in rows)
    finally:
        events.disable()
        events.clear()
