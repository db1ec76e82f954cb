"""The port's resilience layer (``tensorframes_tpu_torch.resilience``) and
``training.run_resumable`` on the CPU: the cases of the JAX package's
``test_resilience.py`` for fault injection, retries, step guards and
``run_resumable``, the fault sites wired through the executor, the prefetch
and the checkpoint, and the site catalog against ``docs/resilience.md``.

The guard cases run on an in-place step — the port's ``make_train_step``
over ``transformer.adamw`` on ``gpt_tiny`` — where the reference's
immutable arrays would let a kept reference stand for a snapshot: skip and
rollback must bring back the parameters, AdamW's moments and its step
counts, bit for bit against a run that never took the bad step.

Tolerances: none — bits, counts and exact sums."""

import math
import os
import re
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import tensorframes_tpu_torch as tft
from tensorframes_tpu_torch import io as tio
from tensorframes_tpu_torch.checkpoint import Checkpointer
from tensorframes_tpu_torch.models import generation as tgen
from tensorframes_tpu_torch.models import transformer as ttr
from tensorframes_tpu_torch.resilience import (
    AttemptTimeout,
    Delay,
    NonFiniteError,
    RetryError,
    RetryPolicy,
    StepGuard,
    active_sites,
    delay_point,
    fault_point,
    inject,
    kill_point,
    retry_call,
    retryable,
    tree_all_finite,
)
from tensorframes_tpu_torch.resilience import faults as faults_mod
from tensorframes_tpu_torch.training import run_resumable, train_on_frame
from tensorframes_tpu_torch.utils.tree import flatten_with_keys

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"


# ---------------------------------------------------------------------------
# faults.py
# ---------------------------------------------------------------------------

def test_fault_point_noop_when_unarmed():
    fault_point("executor.run_block")
    assert active_sites() == ()


def test_inject_every_n_after_max_times():
    with inject("t.site", OSError, every_n=3) as inj:
        outcomes = []
        for _ in range(9):
            try:
                fault_point("t.site")
                outcomes.append("ok")
            except OSError:
                outcomes.append("err")
    assert outcomes == ["ok", "ok", "err"] * 3 and (inj.hits, inj.fired) == (9, 3)
    fault_point("t.site")  # disarmed on exit
    with inject("t.site", RuntimeError, after=2, max_times=2) as inj:
        fired = 0
        for _ in range(10):
            try:
                fault_point("t.site")
            except RuntimeError:
                fired += 1
    assert fired == inj.fired == 2 and inj.hits == 10


def test_inject_probabilistic_is_reproducible():
    def run():
        hits = []
        with inject("t.site", ValueError, p=0.5, seed=42):
            for _ in range(20):
                try:
                    fault_point("t.site")
                    hits.append(0)
                except ValueError:
                    hits.append(1)
        return hits

    a, b = run(), run()
    assert a == b and 0 < sum(a) < 20


def test_inject_error_instance_vs_class_and_isolation():
    sentinel = OSError("the very one")
    with inject("t.site", sentinel):
        with pytest.raises(OSError) as ei:
            fault_point("t.site")
        assert ei.value is sentinel
    with inject("t.a", ConnectionError):
        assert active_sites() == ("t.a",)
        fault_point("t.b")
        with pytest.raises(ConnectionError, match="t.a"):
            fault_point("t.a")


def test_executor_site_fires_through_verbs():
    frame = tft.frame_from_arrays({"x": np.arange(8.0)}, num_blocks=2)
    with inject("executor.run_block", OSError, every_n=1):
        with pytest.raises(OSError):
            tft.map_blocks(lambda x: {"y": x * 2.0}, frame, device=CPU).column_values("y")
    out = tft.map_blocks(lambda x: {"y": x * 2.0}, frame, device=CPU)
    np.testing.assert_array_equal(out.column_values("y"), np.arange(8.0) * 2)


def test_executor_dispatch_delay_site_stalls_the_dispatch():
    frame = tft.frame_from_arrays({"x": np.arange(4.0)})
    t0 = time.monotonic()
    with inject("executor.dispatch", Delay(0.2)) as inj:
        out = tft.map_blocks(lambda x: {"y": x + 1}, frame, device=CPU).column_values("y")
    assert inj.fired >= 1 and time.monotonic() - t0 >= 0.19
    np.testing.assert_array_equal(out, np.arange(4.0) + 1)


def test_delay_point_and_kill_point_in_process():
    t0 = time.monotonic()
    with inject("unit.delay", Delay(0.15)):
        delay_point("unit.delay")
    assert time.monotonic() - t0 >= 0.14
    with inject("unit.delay", RuntimeError("hard fault")):
        with pytest.raises(RuntimeError, match="hard fault"):
            delay_point("unit.delay")
    kill_point()  # un-armed
    with inject("fleet.rank.kill", RuntimeError("not a kill")):
        with pytest.raises(RuntimeError, match="not a kill"):
            kill_point()


def test_kill_point_sigkills_own_process():
    code = (
        "from tensorframes_tpu_torch.resilience import KillRank, inject, kill_point\n"
        "with inject('fleet.rank.kill', KillRank):\n"
        "    kill_point()\n"
        "print('SURVIVED', flush=True)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == -signal.SIGKILL and "SURVIVED" not in proc.stdout


def test_fault_sites_registered_and_documented():
    """Every literal site at a fault_point/delay_point/kill_point call in
    the port is registered, and every registered site is named in
    docs/resilience.md; the registered sites are the reference's."""
    from tensorframes_tpu.resilience import faults as jfaults

    registered = set(faults_mod.list_sites())
    pat = re.compile(r"(?:fault_point|delay_point|kill_point)\(\s*[\"']([\w.]+)[\"']")
    instrumented = set()
    for path in (ROOT / "tensorframes_tpu_torch").rglob("*.py"):
        instrumented |= set(pat.findall(path.read_text()))
    assert instrumented, "no instrumented site found"
    assert instrumented - registered == set()
    assert set(faults_mod.SITES) <= registered
    docs = (ROOT / "docs" / "resilience.md").read_text()
    assert [s for s in sorted(registered) if s not in docs] == []
    ref = jfaults.list_sites()
    assert {s: ref[s] for s in registered} == faults_mod.list_sites()
    assert registered == {"executor.run_block", "executor.run_rows", "executor.dispatch",
                          "io.prefetch.device_put", "io.save_frame", "io.load_frame",
                          "checkpoint.save", "checkpoint.restore",
                          "fleet.rank.kill", "serving.flush", "blockstore.spill",
                          "fleet.heartbeat", "router.dispatch", "serving.replica",
                          "fleet.barrier", "distributed.init", "shuffle.exchange"}
    with pytest.raises(ValueError):
        faults_mod.register_site("", "nowhere")


# ---------------------------------------------------------------------------
# retry.py
# ---------------------------------------------------------------------------

def test_retry_absorbs_transient_then_succeeds():
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("transient")
        return "done"

    assert retry_call(flaky, policy=RetryPolicy(max_attempts=5, backoff=0.001)) == "done"
    assert len(calls) == 3


def test_retry_exhaustion_and_non_retryable():
    with pytest.raises(RetryError) as ei:
        retry_call(lambda: (_ for _ in ()).throw(ConnectionError("down")),
                   policy=RetryPolicy(max_attempts=3, backoff=0.001))
    assert isinstance(ei.value.__cause__, ConnectionError)
    calls = []

    def bug():
        calls.append(1)
        raise ValueError("a real bug")

    with pytest.raises(ValueError):
        retry_call(bug, policy=RetryPolicy(max_attempts=5, backoff=0.001))
    assert len(calls) == 1
    calls.clear()
    with pytest.raises(ValueError):
        retry_call(bug, policy=None)
    assert len(calls) == 1


def test_retry_backoff_schedule_is_deterministic():
    import random

    pol = RetryPolicy(backoff=0.1, backoff_max=0.5, jitter=0.5, seed=7)
    d1 = [pol.delay(k, random.Random(7)) for k in (1, 2, 3, 4)]
    d2 = [pol.delay(k, random.Random(7)) for k in (1, 2, 3, 4)]
    assert d1 == d2
    assert all(base <= d <= base * 1.5 for d, base in zip(d1, (0.1, 0.2, 0.4, 0.5)))


def test_retry_watchdog_timeout_retried_and_exhausted():
    calls = []

    def sometimes_hangs():
        calls.append(1)
        if len(calls) == 1:
            time.sleep(1.0)  # abandoned by the watchdog
        return "recovered"

    assert retry_call(sometimes_hangs,
                      policy=RetryPolicy(max_attempts=2, backoff=0.001, timeout=0.2)) == "recovered"
    with pytest.raises(RetryError) as ei:
        retry_call(lambda: time.sleep(1.0),
                   policy=RetryPolicy(max_attempts=2, backoff=0.001, timeout=0.05))
    assert isinstance(ei.value.__cause__, AttemptTimeout)


def test_retryable_decorator_and_on_retry_hook():
    calls = []

    @retryable(max_attempts=4, backoff=0.001)
    def op(x):
        calls.append(x)
        if len(calls) < 2:
            raise OSError("blip")
        return x + 1

    assert op(41) == 42 and calls == [41, 41]
    with pytest.raises(ValueError):
        retryable(RetryPolicy(), max_attempts=2)
    seen = []

    def flaky():
        if len(seen) < 2:
            raise OSError("x")
        return True

    assert retry_call(flaky, policy=RetryPolicy(max_attempts=5, backoff=0.001),
                      on_retry=lambda a, e: seen.append((a, type(e).__name__)))
    assert seen == [(1, "OSError"), (2, "OSError")]


def test_retry_deadline_caps_total_elapsed_and_blocked_attempts():
    calls = []

    def always_flaky():
        calls.append(1)
        raise OSError("coordinator not up")

    t0 = time.monotonic()
    with pytest.raises(RetryError, match="deadline_s=0.3 exceeded"):
        retry_call(always_flaky, policy=RetryPolicy(max_attempts=10**6, backoff=0.02,
                                                    deadline_s=0.3), describe="flaky")
    assert time.monotonic() - t0 < 3.0 and len(calls) >= 2
    t0 = time.monotonic()
    with pytest.raises(RetryError, match="deadline_s"):
        retry_call(lambda: time.sleep(5), policy=RetryPolicy(max_attempts=3, backoff=0.01,
                                                             deadline_s=0.2))
    assert time.monotonic() - t0 < 3.0
    with pytest.raises(ValueError, match="deadline_s"):
        RetryPolicy(deadline_s=0)
    assert retry_call(lambda: 17, policy=RetryPolicy(deadline_s=5.0)) == 17
    with pytest.raises(RetryError, match="all 2 attempts failed"):
        retry_call(lambda: (_ for _ in ()).throw(OSError("x")),
                   policy=RetryPolicy(max_attempts=2, backoff=0.001, deadline_s=30.0))


def test_retry_and_fault_counters():
    from tensorframes_tpu_torch.observability.metrics import REGISTRY

    def value(name):
        return sum(d["value"] for d in REGISTRY.snapshot() if d["name"] == name)

    a0, e0, f0 = (value("tftpu_retry_attempts_total"), value("tftpu_retry_exhaustions_total"),
                  value("tftpu_fault_injections_fired_total"))
    with pytest.raises(RetryError):
        retry_call(lambda: (_ for _ in ()).throw(OSError("w")),
                   policy=RetryPolicy(max_attempts=3, backoff=0.0, seed=0))
    with inject("obs.test.site", OSError("boom")):
        with pytest.raises(OSError):
            fault_point("obs.test.site")
    assert value("tftpu_retry_attempts_total") - a0 == 2
    assert value("tftpu_retry_exhaustions_total") - e0 == 1
    assert value("tftpu_fault_injections_fired_total") - f0 == 1


# ---------------------------------------------------------------------------
# prefetch: the io.prefetch.device_put site inside the retry scope
# ---------------------------------------------------------------------------

def test_prefetch_retry_absorbs_device_put_faults():
    frame = tft.frame_from_arrays({"x": np.arange(16.0)})
    with inject("io.prefetch.device_put", OSError, every_n=2) as inj:
        out = list(tio.prefetch_to_device(tio.iterate_batches(frame, batch_size=4), size=2,
                                          device=CPU,
                                          retry=RetryPolicy(max_attempts=3, backoff=0.001)))
    assert len(out) == 4 and inj.fired >= 1
    np.testing.assert_array_equal(torch.cat([b["x"] for b in out]).numpy(), np.arange(16.0))
    with inject("io.prefetch.device_put", OSError, every_n=1):
        with pytest.raises(OSError):
            list(tio.prefetch_to_device(tio.iterate_batches(frame, batch_size=4), size=2,
                                        device=CPU))


# ---------------------------------------------------------------------------
# guards.py
# ---------------------------------------------------------------------------

def test_tree_all_finite():
    assert tree_all_finite({"a": torch.ones(3), "b": [np.arange(2), "str"], "c": 1.5})
    assert not tree_all_finite({"a": torch.tensor([1.0, math.nan])})
    assert not tree_all_finite({"a": np.array([np.inf])})
    assert not tree_all_finite([float("inf")])
    assert tree_all_finite({"i": torch.tensor([1, 2])})
    assert not tree_all_finite({"b": torch.tensor([1.0, math.nan], dtype=torch.bfloat16)})
    assert tree_all_finite({"big": torch.tensor([1e300], dtype=torch.float64)})
    assert tree_all_finite({"empty": torch.zeros(0), "scalar": torch.tensor(2.0)})


def test_guard_plain_tree_semantics():
    """On trees a step does not write in place, the reference's semantics:
    skip returns the pre-step state, rollback the last admitted one, and
    raise stops (also after max_consecutive)."""
    g = StepGuard(policy="skip", max_consecutive=5)
    good = {"w": torch.ones(2)}
    bad = {"w": torch.tensor([1.0, math.nan])}
    state, admitted = g.admit(1, bad, {"loss": 0.5}, prev_state=good)
    assert not admitted and state is good and g.skipped == 1
    state, admitted = g.admit(2, good, {"loss": 0.4}, prev_state=good)
    assert admitted and g.admitted == 1
    g = StepGuard(policy="rollback", max_consecutive=5)
    s1, s2 = {"w": torch.full((2,), 1.0)}, {"w": torch.full((2,), 2.0)}
    g.admit(1, s1, {"loss": 1.0}, prev_state={"w": torch.zeros(2)})
    g.admit(2, s2, {"loss": 0.9}, prev_state=s1)
    nan = {"w": torch.full((2,), math.nan)}
    state, admitted = g.admit(3, nan, {"loss": math.nan}, prev_state=nan)
    assert not admitted and g.rollbacks == 1 and state["w"].tolist() == [2.0, 2.0]
    with pytest.raises(NonFiniteError):
        StepGuard(policy="raise").admit(1, {"w": torch.tensor([math.nan])}, {}, prev_state=None)
    g = StepGuard(policy="skip", max_consecutive=3)
    for i in (1, 2):
        g.admit(i, bad, {}, prev_state=good)
    with pytest.raises(NonFiniteError, match="3 consecutive"):
        g.admit(3, bad, {}, prev_state=good)


def test_guard_metrics_only_check_coerce_and_validation():
    g = StepGuard(policy="skip", check="metrics")
    bad_state = {"w": torch.tensor([math.nan])}
    state, admitted = g.admit(1, bad_state, {"loss": 1.0}, prev_state=None)
    assert admitted and state is bad_state
    _, admitted = g.admit(2, bad_state, {"loss": float("inf")}, prev_state={})
    assert not admitted
    assert StepGuard.coerce("skip").policy == "skip"
    assert StepGuard.coerce(g) is g
    with pytest.raises(ValueError, match="policy"):
        StepGuard(policy="explode")
    with pytest.raises(TypeError):
        StepGuard.coerce(42)


def test_guard_trip_counter_by_policy():
    from tensorframes_tpu_torch.observability.metrics import REGISTRY

    def trips(policy):
        return sum(d["value"] for d in REGISTRY.snapshot()
                   if d["name"] == "tftpu_guard_trips_total" and d["labels"] == {"policy": policy})

    before = trips("skip")
    StepGuard(policy="skip", check="metrics").admit(1, {"w": 1.0}, {"loss": math.nan},
                                                     prev_state={"w": 0.0})
    assert trips("skip") - before == 1
    assert {d["labels"]["policy"] for d in REGISTRY.snapshot()
            if d["name"] == "tftpu_guard_trips_total"} == {"raise", "skip", "rollback"}


# -- the in-place step: gpt_tiny under AdamW -------------------------------

CFG = tgen.gpt_tiny(attention_impl="dense")


def _frame(rows=8, seq=12, seed=3):
    toks, tg = ttr.synthetic_batch(CFG, rows, seq, seed=seed)
    return tft.frame_from_arrays({"tokens": toks, "targets": tg})


def _batches(frame, n, bs=4):
    out = []
    epoch = 0
    while len(out) < n:
        out += list(tio.iterate_batches(frame, ["tokens", "targets"], bs, shuffle=True,
                                        seed=epoch, drop_remainder=True))
        epoch += 1
    return [{k: torch.from_numpy(v) for k, v in b.items()} for b in out[:n]]


_LOSS_SCALE = [1.0]


@pytest.fixture(autouse=True)
def _poisonable_loss(monkeypatch):
    """``transformer.loss_fn`` times ``_LOSS_SCALE[0]``: the train step
    looks it up at call time, so a step can be poisoned from outside."""
    plain = ttr.loss_fn
    monkeypatch.setattr(ttr, "loss_fn", lambda *a: plain(*a) * _LOSS_SCALE[0])
    yield
    _LOSS_SCALE[0] = 1.0


def _train_state(poison_at=(), seed=0):
    """``(params, opt)`` and a step_fn over the port's in-place
    ``make_train_step`` under ``transformer.adamw``; the steps in
    ``poison_at`` (1-based, by call) multiply their loss by NaN, which
    writes NaN into the parameters and moments in place."""
    params = ttr.init_params(CFG, seed=seed, device=CPU)
    opt = ttr.adamw(params, 1e-2)
    step = ttr.make_train_step(CFG, opt)
    calls = [0]

    def step_fn(state, batch):
        calls[0] += 1
        _LOSS_SCALE[0] = math.nan if calls[0] in poison_at else 1.0
        p, o = state
        _, _, loss = step(p, o.state, batch["tokens"], batch["targets"])
        return (p, o), loss

    return (params, opt), step_fn


def _assert_states_equal(a, b):
    fa, fb = dict(flatten_with_keys(a)), dict(flatten_with_keys(b))
    assert list(fa) == list(fb)
    for k in fa:
        assert torch.equal(fa[k], fb[k]), k


@pytest.mark.parametrize("policy", ["skip", "rollback"])
def test_guard_restores_params_moments_and_step_counts_in_place(policy):
    """A NaN at step 3 under skip / rollback leaves parameters, moments
    and AdamW step counts equal, bit for bit, to a run whose stream left
    out batch 3 — and the live tensors are the ones the optimizer holds."""
    frame = _frame()
    state, step_fn = _train_state(poison_at=(3,))
    held = ttr.tree_leaves(state[0])
    guard = StepGuard(policy)
    out, ran = train_on_frame(step_fn, state, frame, ["tokens", "targets"], batch_size=4,
                              num_steps=5, guard=guard, prefetch=0, device=CPU)
    assert ran == 5 and (guard.skipped, guard.rollbacks) == ((1, 0) if policy == "skip"
                                                            else (0, 1))
    assert out[1] is state[1] and all(a is b for a, b in zip(ttr.tree_leaves(out[0]), held))
    ref, ref_fn = _train_state()
    for i, b in enumerate(_batches(frame, 5)):
        if i != 2:
            ref, _ = ref_fn(ref, b)
    _assert_states_equal(out, ref)
    first = out[1].param_groups[0]["params"][0]
    assert float(out[1].state[first]["step"]) == 4.0


def test_guard_skip_of_the_first_step_starts_the_optimizer_afresh():
    frame = _frame()
    state, step_fn = _train_state(poison_at=(1,))
    out, _ = train_on_frame(step_fn, state, frame, ["tokens", "targets"], batch_size=4,
                            num_steps=3, guard="skip", prefetch=0, device=CPU)
    ref, ref_fn = _train_state()
    for b in _batches(frame, 3)[1:]:
        ref, _ = ref_fn(ref, b)
    _assert_states_equal(out, ref)


def test_guard_raise_emergency_checkpoint_is_finite(tmp_path):
    """guard='raise' in run_resumable: NonFiniteError, and the emergency
    checkpoint holds the last admitted state (step 2), finite, bit-equal
    to a clean 2-step run — not the NaN written in place."""
    frame = _frame()
    batches = _batches(frame, 4)
    state, step_fn = _train_state(poison_at=(3,))
    ck = Checkpointer(str(tmp_path / "run"))
    with pytest.raises(NonFiniteError):
        run_resumable(step_fn, state, ck, batches, num_steps=4, save_every=0, guard="raise")
    assert ck.all_steps() == [2]
    saved = ck.restore()
    assert all(bool(torch.isfinite(v).all()) for v in saved.values() if v.is_floating_point())
    ref, ref_fn = _train_state()
    for b in batches[:2]:
        ref, _ = ref_fn(ref, b)
    want = dict(flatten_with_keys(ref))
    assert list(saved) == list(want)
    assert all(torch.equal(saved[k], want[k]) for k in want)


def test_run_resumable_guard_rollback_escalates(tmp_path):
    frame = _frame()
    state, step_fn = _train_state(poison_at=(2, 3, 4))
    ck = Checkpointer(str(tmp_path / "run"))
    with pytest.raises(NonFiniteError, match="3 consecutive"):
        run_resumable(step_fn, state, ck, _batches(frame, 5), num_steps=5, save_every=0,
                      guard=StepGuard(policy="rollback", max_consecutive=3))
    # steps 2 and 3 were rolled back (batches consumed, the state of step
    # 1 kept); the raise at step 4 writes step 1's state back before the
    # emergency checkpoint labels it with the batches consumed, as the
    # reference does
    assert ck.all_steps() == [3] and tree_all_finite(state)
    ref, ref_fn = _train_state()
    ref, _ = ref_fn(ref, _batches(frame, 1)[0])
    _assert_states_equal(state, ref)


def test_guard_every_n_and_snapshot_every():
    g = StepGuard(policy="rollback", every_n=2, snapshot_every=2)
    s = {"w": torch.zeros(1)}
    g.seed(0, s)
    assert g.admit(1, {"w": torch.tensor([math.nan])}, {}, prev_state=s)[1]  # unchecked
    s2 = {"w": torch.ones(1)}
    assert g.admit(2, s2, {}, prev_state=s)[1]
    out, ok = g.admit(4, {"w": torch.tensor([math.nan])}, {}, prev_state=s2)
    assert not ok and out["w"].tolist() == [1.0]


@pytest.mark.parametrize("policy", ["skip", "raise"])
def test_guard_every_n_trip_lands_on_the_pre_step_state_plain_tree(policy):
    """every_n=2 under skip / raise: a trip at a checked step lands on the
    state of the unchecked step before it (the reference's prev_state),
    not on the last checked one."""
    g = StepGuard(policy=policy, every_n=2)
    s0 = {"w": torch.zeros(2)}
    g.seed(0, s0)
    s1 = {"w": torch.ones(2)}
    assert g.admit(1, s1, {}, prev_state=s0)[1]  # unchecked
    nan = {"w": torch.full((2,), math.nan)}
    if policy == "raise":
        with pytest.raises(NonFiniteError):
            g.admit(2, nan, {"loss": math.nan}, prev_state=s1)
        out = nan  # the live tree holds the last admitted state
    else:
        out, ok = g.admit(2, nan, {"loss": math.nan}, prev_state=s1)
        assert not ok and g.skipped == 1
    assert out["w"].tolist() == [1.0, 1.0]


def test_guard_every_n_skip_in_place():
    """every_n=2 under skip on the in-place step: a NaN at (checked) step 4
    leaves the bits of a run whose stream left out batch 4, though step 3
    was admitted unchecked."""
    frame = _frame()
    state, step_fn = _train_state(poison_at=(4,))
    guard = StepGuard("skip", every_n=2)
    out, ran = train_on_frame(step_fn, state, frame, ["tokens", "targets"], batch_size=4,
                              num_steps=5, guard=guard, prefetch=0, device=CPU)
    assert ran == 5 and guard.skipped == 1 and guard.admitted == 4
    ref, ref_fn = _train_state()
    for i, b in enumerate(_batches(frame, 5)):
        if i != 3:
            ref, _ = ref_fn(ref, b)
    _assert_states_equal(out, ref)


# ---------------------------------------------------------------------------
# run_resumable (the reference's test_training.py and test_resilience.py)
# ---------------------------------------------------------------------------

def _add_step(state, batch):
    new = {"w": state["w"] * 1.01 + batch, "count": state["count"] + 1}
    return new, {"loss": new["w"].sum()}


def _plain_batches(n):
    return [torch.full((2,), float(i)) for i in range(n)]


def _init():
    return {"w": torch.zeros(2), "count": torch.tensor(0, dtype=torch.int32)}


def test_full_run_and_final_checkpoint(tmp_path):
    ck = Checkpointer(str(tmp_path / "run"))
    seen = []
    state, ran = run_resumable(_add_step, _init(), ck, _plain_batches(10), num_steps=10,
                               save_every=4, on_step=lambda s, m: seen.append(s))
    assert ran == 10 and int(state["count"]) == 10 and seen == list(range(1, 11))
    assert ck.all_steps() == [4, 8, 10]


def test_crash_and_resume_matches_uninterrupted(tmp_path):
    calls = []

    def flaky(state, batch):
        if len(calls) == 6 and not flaky.resumed:
            raise RuntimeError("preempted")
        calls.append(1)
        return _add_step(state, batch)

    flaky.resumed = False
    ck = Checkpointer(str(tmp_path / "run"))
    with pytest.raises(RuntimeError, match="preempted"):
        run_resumable(flaky, _init(), ck, _plain_batches(10), num_steps=10, save_every=3)
    assert ck.latest_step() == 6  # the emergency checkpoint: the state was not written
    flaky.resumed = True
    state, ran = run_resumable(flaky, _init(), ck, _plain_batches(10), num_steps=10,
                               save_every=3)
    assert ran == 4
    ref, _ = run_resumable(_add_step, _init(), Checkpointer(str(tmp_path / "ref")),
                           _plain_batches(10), num_steps=10, save_every=100)
    assert torch.equal(state["w"], ref["w"]) and int(state["count"]) == 10


def test_no_emergency_checkpoint_of_a_state_written_in_place(tmp_path):
    """A step that raises after writing the state in place leaves no
    emergency checkpoint: the relaunch resumes from the previous one."""
    def tearing(state, batch):
        if int(state["count"]) == 4:
            state["w"].add_(1000.0)  # half an update
            raise RuntimeError("died mid-update")
        return _add_step(state, batch)

    ck = Checkpointer(str(tmp_path / "run"))
    with pytest.raises(RuntimeError, match="mid-update"):
        run_resumable(tearing, _init(), ck, _plain_batches(8), num_steps=8, save_every=3)
    assert ck.all_steps() == [3]


def test_resume_with_short_dataset_raises_and_complete_run_is_noop(tmp_path):
    ck = Checkpointer(str(tmp_path / "run"))
    run_resumable(_add_step, _init(), ck, _plain_batches(10), num_steps=6, save_every=3)
    with pytest.raises(ValueError, match="shorter than the original"):
        run_resumable(_add_step, _init(), ck, _plain_batches(4), num_steps=10, save_every=3)

    def exploding():
        raise AssertionError("iterator must not be consumed")
        yield  # pragma: no cover

    state, ran = run_resumable(_add_step, _init(), ck, exploding(), num_steps=6, save_every=3)
    assert ran == 0 and int(state["count"]) == 6


def test_run_resumable_resumes_past_corrupted_newest(tmp_path):
    ck = Checkpointer(str(tmp_path / "run"))
    run_resumable(_add_step, _init(), ck, _plain_batches(10), num_steps=6, save_every=2)
    payload = tmp_path / "run" / "step_6" / "arrays.npz"
    payload.write_bytes(payload.read_bytes()[:10])
    got, ran = run_resumable(_add_step, _init(), ck, _plain_batches(10), num_steps=10,
                             save_every=2)
    assert ran == 6
    ref, _ = run_resumable(_add_step, _init(), Checkpointer(str(tmp_path / "ref")),
                           _plain_batches(10), num_steps=10, save_every=100)
    assert torch.equal(got["w"], ref["w"])


def test_run_resumable_survives_transient_save_faults(tmp_path):
    ck = Checkpointer(str(tmp_path / "run"), retry=RetryPolicy(max_attempts=3, backoff=0.001))
    with inject("checkpoint.save", OSError, every_n=2) as inj:
        got, ran = run_resumable(_add_step, _init(), ck, _plain_batches(8), num_steps=8,
                                 save_every=2)
    assert ran == 8 and inj.fired >= 1 and ck.latest_step() == 8
    ref, _ = run_resumable(_add_step, _init(), Checkpointer(str(tmp_path / "ref")),
                           _plain_batches(8), num_steps=8, save_every=100)
    assert torch.equal(got["w"], ref["w"])


def test_run_resumable_guard_skips_poison_batch(tmp_path):
    clean = _plain_batches(6)
    poisoned = list(clean)
    poisoned[3] = torch.full((2,), math.nan)
    guard = StepGuard(policy="skip", max_consecutive=3)
    got, ran = run_resumable(lambda s, b: ({"w": s["w"] + b}, {"loss": (s["w"] + b).sum()}),
                             {"w": torch.zeros(2)}, Checkpointer(str(tmp_path / "a")), poisoned,
                             num_steps=6, save_every=0, guard=guard)
    assert ran == 6 and guard.skipped == 1
    assert got["w"].tolist() == [float(sum(i for i in range(6) if i != 3))] * 2


def test_run_resumable_refuses_a_fleet(tmp_path, monkeypatch):
    monkeypatch.setenv("TFTPU_FLEET_DIR", str(tmp_path / "fleet"))
    with pytest.raises(RuntimeError, match="fleet-supervision slice"):
        run_resumable(_add_step, _init(), Checkpointer(str(tmp_path / "run")),
                      _plain_batches(2), num_steps=2)
