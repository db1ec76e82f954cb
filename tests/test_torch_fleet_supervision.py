"""The port's fleet supervision against the JAX package's, on the CPU.

* The monitor and enrolment units, each run by both packages over the
  same rendezvous files: dead ranks and stragglers, a never-started rank
  declared dead after the startup grace, a monitor that never judges its
  own rank, an abort seen once; ``enroll`` without a fleet dir and
  enrolled twice; the ``tftpu_fleet_*`` families registered at import.
  Verdicts, counter moves and flight records (less their clocks) agree.
* Cross-package reads: the port's monitor over the reference's
  ``Heartbeater`` and the reverse.
* ``supervise`` runs of subprocess fleets (children at the reference's
  fast cadence, beats every 0.1 s, a death verdict at 1.5 s): a clean
  single attempt; a spent restart budget, whose ``SuperviseError`` text
  and ``SuperviseResult`` equal the reference's for the same command; a
  failed partial spawn; a kill -9 of rank 1 mid-``run_resumable`` that
  converges bit for bit; a dropped heartbeat that the peer detects.
* The executor's dispatch deadline (the reference's
  ``tests/test_fleet.py::test_dispatch_deadline_trips_on_delayed_executor_dispatch``).
* A data-parallel gloo fleet of two CPU ranks training a 2-layer,
  64-wide transformer on a ``{"dp": 2}`` mesh through a kill -9 between
  saves and a SIGSTOPped rank: every incarnation starts with both ranks'
  newest checkpoints on one step, and the final state equals an
  uninterrupted fleet's bit for bit.
"""

import json
import os
import signal
import socket
import sys
import time
from dataclasses import asdict

import numpy as np
import pytest
import torch

import tensorframes_tpu_torch as tft
from tensorframes_tpu.observability import REGISTRY as REF_REGISTRY
from tensorframes_tpu.observability import context as ref_context
from tensorframes_tpu.observability import flight as ref_flight
from tensorframes_tpu.resilience import fleet as ref_fleet
from tensorframes_tpu.resilience import supervisor as ref_supervisor
from tensorframes_tpu_torch.observability import REGISTRY as PORT_REGISTRY
from tensorframes_tpu_torch.observability import context as port_context
from tensorframes_tpu_torch.observability import flight as port_flight
from tensorframes_tpu_torch.resilience import faults, fleet, supervisor

_REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
PACKAGES = (("reference", ref_fleet, ref_flight), ("port", fleet, port_flight))


def _fleet_env(extra=None):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["OMP_NUM_THREADS"] = "1"
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    # the reference's fast chaos cadence: beats every 0.1 s, death at 1.5 s
    env["TFTPU_HEARTBEAT_INTERVAL_S"] = "0.1"
    env["TFTPU_HEARTBEAT_TIMEOUT_S"] = "1.5"
    env.update(extra or {})
    return env


def _beat(d, run, rank, age, stopped=False):
    """A beat of ``rank`` written straight through the file protocol,
    ``age`` seconds old."""
    rec = {"run_id": run, "process_index": rank, "pid": 1, "seq": 1, "ts": time.time() - age,
           "interval_s": 0.1, "stopped": stopped}
    with open(os.path.join(d, f"hb_{run}_p{rank}.json"), "w") as f:
        json.dump(rec, f)


def _fleet_records(flt, since):
    """The ``fleet.*`` flight records after seq ``since``, without their
    clocks (``ts``, ``seq``, a beat's measured ``age_s``)."""
    return [{k: v for k, v in r.items() if k not in ("ts", "seq", "age_s")}
            for r in flt.RECORDER.records()
            if r["seq"] > since and r["kind"].startswith("fleet.")]


def _last_seq(flt):
    recs = flt.RECORDER.records()
    return recs[-1]["seq"] if recs else 0


def _counters(fl):
    return (fl.DEAD_RANKS.value, fl.MISSED_BEATS.value, fl._STRAGGLERS.value)


def _moved(before, after):
    return tuple(b - a for a, b in zip(before, after))


@pytest.fixture
def member_hygiene():
    yield
    for _, fl, _ in PACKAGES:
        fl._reset_member_for_tests()


# ---------------------------------------------------------------------------
# the monitor and enrolment, both packages over the same files
# ---------------------------------------------------------------------------

def test_monitor_dead_and_straggler_verdicts_match_the_reference(tmp_path):
    d, run = str(tmp_path), "montest"
    for rank, age in ((1, 0.8), (2, 3.0)):
        _beat(d, run, rank, age)
    got = {}
    for name, fl, flt in PACKAGES:
        dead, stragglers = [], []
        seq, before = _last_seq(flt), _counters(fl)
        mon = fl.FleetMonitor(
            d, run_id=run, timeout_s=2.0, straggler_s=0.5, self_rank=0,
            on_dead=lambda rs, st, out=dead: out.extend(rs),
            on_straggler=lambda rs, st, out=stragglers: out.extend(rs),
        )
        mon.check_once()
        mon.check_once()  # a second scan reports nothing again
        got[name] = (dead, stragglers, _moved(before, _counters(fl)), _fleet_records(flt, seq))
    assert got["port"] == got["reference"]
    assert got["port"][:3] == ([2], [1], (1, 2, 1))
    assert [r["kind"] for r in got["port"][3]] == ["fleet.straggler", "fleet.heartbeat_lost"]
    assert got["port"][3][1] == {"kind": "fleet.heartbeat_lost", "rank": 2, "timeout_s": 2.0,
                                 "never_started": False}


def test_monitor_declares_never_started_rank_dead_after_grace(tmp_path):
    d, run = str(tmp_path), "gracetest"
    _beat(d, run, 0, 0.0)
    got = {}
    for name, fl, flt in PACKAGES:
        dead = []
        seq = _last_seq(flt)
        mon = fl.FleetMonitor(
            d, run_id=run, num_processes=3, timeout_s=30.0, self_rank=0, startup_grace_s=0.2,
            on_dead=lambda rs, st, out=dead: out.extend(rs),
        )
        mon.check_once()
        inside = list(dead)  # inside the grace: not yet judged
        time.sleep(0.25)
        mon.check_once()
        mon.check_once()  # reported once
        got[name] = (inside, dead, _fleet_records(flt, seq))
    assert got["port"] == got["reference"]
    assert got["port"][:2] == ([], [1, 2])
    assert {r["rank"]: r["never_started"] for r in got["port"][2]} == {1: True, 2: True}


def test_monitor_defaults_are_the_references(tmp_path):
    mons = [fl.FleetMonitor(str(tmp_path), run_id="defaults", timeout_s=3.0, self_rank=0)
            for _, fl, _ in PACKAGES]
    for mon in mons:
        assert mon.startup_grace_s == 20.0 and mon.straggler_s == 1.5
    ref, port = mons
    assert (port.poll_s, port.timeout_s) == (ref.poll_s, ref.timeout_s)
    big = fleet.FleetMonitor(str(tmp_path), run_id="defaults", timeout_s=8.0, self_rank=0)
    assert big.startup_grace_s == 32.0


def test_monitor_never_judges_self(tmp_path):
    d, run = str(tmp_path), "selftest"
    _beat(d, run, 0, 100.0)
    for _, fl, _ in PACKAGES:
        dead, stragglers = [], []
        fl.FleetMonitor(d, run_id=run, timeout_s=1.0, self_rank=0,
                        on_dead=lambda rs, st, out=dead: out.extend(rs),
                        on_straggler=lambda rs, st, out=stragglers: out.extend(rs)).check_once()
        assert dead == [] and stragglers == []


def test_monitor_sees_an_abort_once_from_either_package(tmp_path):
    d = str(tmp_path)
    got = {}
    for name, fl, _ in PACKAGES:
        aborts = []
        fl.FleetMonitor(d, run_id="abtest", self_rank=0, on_abort=aborts.append).check_once()
        got[name] = [list(aborts)]
    # the reference signals; both monitors see its record once
    ref_fleet.signal_abort(d, "down we go", dead_ranks=[1], run_id="abtest")
    for name, fl, flt in PACKAGES:
        aborts = []
        seq = _last_seq(flt)
        mon = fl.FleetMonitor(d, run_id="abtest", self_rank=0, on_abort=aborts.append)
        mon.check_once()
        mon.check_once()
        got[name] += [[(a["reason"], a["ranks"]) for a in aborts], _fleet_records(flt, seq)]
    assert got["port"] == got["reference"]
    assert got["port"][:2] == [[], [("down we go", [1])]]
    assert got["port"][2][0]["kind"] == "fleet.abort_seen"
    assert got["port"][2][0]["ranks"] == [1]


def test_enroll_is_a_noop_without_a_fleet_dir(monkeypatch, member_hygiene):
    monkeypatch.delenv("TFTPU_FLEET_DIR", raising=False)
    for _, fl, _ in PACKAGES:
        assert fl.enroll() is None
        assert fl.current_member() is None


def test_enroll_is_idempotent_and_heartbeats(tmp_path, monkeypatch, member_hygiene):
    monkeypatch.setenv("TFTPU_FLEET_DIR", str(tmp_path))
    members = []
    for _, fl, _ in PACKAGES:
        m1 = fl.enroll(monitor=False, interval_s=0.05)
        m2 = fl.enroll(monitor=False)
        assert m1 is m2 and fl.current_member() is m1
        assert m1.monitor is None and m1.directory == str(tmp_path)
        members.append(m1)
    time.sleep(0.3)
    # each package beats under its own run id into the one dir
    for m, ctx in zip(members, (ref_context, port_context)):
        beats = fleet.read_heartbeats(str(tmp_path), ctx.run_id())
        assert beats[m.heartbeater.rank]["seq"] >= 2
        assert not beats[m.heartbeater.rank]["stopped"]
    fleet._reset_member_for_tests()
    assert fleet.current_member() is None


def test_enroll_starts_the_monitor_with_the_default_policy(tmp_path, monkeypatch,
                                                           member_hygiene):
    monkeypatch.setenv("TFTPU_FLEET_DIR", str(tmp_path))
    m = fleet.enroll(abort_on_dead=False, num_processes=2, timeout_s=0.5, interval_s=0.05)
    assert m.abort_on_dead is False
    assert m.monitor is not None and m.monitor.num_processes == 2
    assert m.monitor.timeout_s == 0.5 and m.monitor._thread is not None
    m.leave()
    assert m.monitor._thread is None
    assert fleet.read_heartbeats(str(tmp_path))[m.heartbeater.rank]["stopped"]


def test_fleet_metrics_registered_at_import():
    names = {}
    for name, reg in (("reference", REF_REGISTRY), ("port", PORT_REGISTRY)):
        names[name] = {m.name for m in reg.collect() if m.name.startswith("tftpu_fleet_")}
    assert names["port"] == names["reference"]
    for expected in (
        "tftpu_fleet_heartbeats_total", "tftpu_fleet_heartbeats_skipped_total",
        "tftpu_fleet_missed_beats_total", "tftpu_fleet_stragglers_total",
        "tftpu_fleet_dead_ranks_total", "tftpu_fleet_aborts_total",
        "tftpu_fleet_hung_dispatches_total", "tftpu_fleet_deadline_exemptions_total",
        "tftpu_fleet_restarts_total", "tftpu_fleet_recovery_seconds",
        "tftpu_fleet_alive_ranks",
    ):
        assert expected in names["port"], expected
    assert fleet.ABORT_EXIT_CODE == ref_fleet.ABORT_EXIT_CODE == 43


# ---------------------------------------------------------------------------
# cross-package reads of one rendezvous dir
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer,reader", [(ref_fleet, fleet), (fleet, ref_fleet)],
                         ids=["port-reads-reference", "reference-reads-port"])
def test_a_monitor_reads_the_other_packages_heartbeater(tmp_path, writer, reader):
    d = str(tmp_path)
    run = (ref_context if writer is ref_fleet else port_context).run_id()
    hb = writer.Heartbeater(d, interval_s=0.05, rank=1).start()
    dead = []
    mon = reader.FleetMonitor(d, run_id=run, num_processes=2, timeout_s=0.4, self_rank=0,
                              on_dead=lambda rs, st: dead.extend(rs))
    try:
        time.sleep(0.15)
        st = mon.check_once()
        assert st.alive == [1] and st.missing == [0] and dead == []
        hb.stop(graceful=False)  # silent, not departed
        time.sleep(0.5)
        st = mon.check_once()
        assert st.dead == [1] and dead == [1]
        writer.write_beat(d, rank=1, stopped=True)
        assert reader.fleet_status(d, run_id=run).stopped == [1]
    finally:
        hb.stop(graceful=False)


# ---------------------------------------------------------------------------
# supervise(): subprocess fleets
# ---------------------------------------------------------------------------

def test_supervise_clean_single_attempt(tmp_path):
    script = ("import time\n"
              "from tensorframes_tpu_torch.resilience import fleet\n"
              "assert fleet.enroll() is not None\n"
              "time.sleep(0.5)\n")
    result = tft.supervise([sys.executable, "-c", script], 2,
                           rendezvous_dir=str(tmp_path / "f"), max_restarts=0,
                           env=_fleet_env(), inherit_env=False)
    assert isinstance(result, supervisor.SuperviseResult)
    assert result.ok and result.attempts == 1 and result.restarts == 0
    assert result.exit_codes == [{0: 0, 1: 0}] and result.failures == []
    assert result.recovery_seconds == 0.0
    # both ranks heartbeat and left a clean final beat
    beats = fleet.read_heartbeats(str(tmp_path / "f"), result.run_id)
    assert sorted(beats) == [0, 1] and all(b["stopped"] for b in beats.values())


def _budget_cmd(rank):
    # rank 0 fails at once; rank 1 would run on and is torn down
    src = "import sys; sys.exit(9)" if rank == 0 else "import time; time.sleep(60)"
    return [sys.executable, "-c", src]


def test_supervise_spent_budget_matches_the_reference(tmp_path):
    outcomes = {}
    for name, sup in (("reference", ref_supervisor), ("port", supervisor)):
        restarts0 = sup._RESTARTS.value
        with pytest.raises(sup.SuperviseError) as ei:
            sup.supervise(_budget_cmd, 2, rendezvous_dir=str(tmp_path / name),
                          max_restarts=1, grace_s=0.3, env=_fleet_env(), inherit_env=False,
                          run_id="budget")
        res = asdict(ei.value.result)
        assert res.pop("rendezvous_dir") == str(tmp_path / name)
        assert res.pop("recovery_seconds") > 0
        outcomes[name] = (str(ei.value), res, sup._RESTARTS.value - restarts0)
    assert outcomes["port"] == outcomes["reference"]
    text, res, restarts = outcomes["port"]
    assert text == ("fleet failed 2 time(s) (restart budget 1 exhausted); last failure: "
                    "rank 0 exited rc=9")
    assert res["attempts"] == 2 and res["restarts"] == 1 and not res["ok"] and restarts == 1
    assert res["exit_codes"] == [{0: 9, 1: -signal.SIGTERM}] * 2
    assert [f["kind"] for f in res["failures"]] == ["exit", "exit"]
    assert isinstance(ei.value, fleet.FleetError)


def test_supervise_rejects_bad_arguments():
    with pytest.raises(ValueError, match="num_processes"):
        supervisor.supervise(["true"], 0)
    with pytest.raises(ValueError, match="max_restarts"):
        supervisor.supervise(["true"], 1, max_restarts=-1)


def test_supervise_partial_spawn_failure_reaps_started_ranks(tmp_path):
    pid_file = str(tmp_path / "rank0.pid")
    sleeper = (f"import os, time\nopen({pid_file!r}, 'w').write(str(os.getpid()))\n"
               "time.sleep(120)\n")

    def cmd(rank):
        if rank == 1:
            deadline = time.monotonic() + 60
            while not os.path.exists(pid_file):
                assert time.monotonic() < deadline, "rank 0 never started"
                time.sleep(0.05)
            raise RuntimeError("no argv for rank 1")
        return [sys.executable, "-c", sleeper]

    with pytest.raises(RuntimeError, match="no argv for rank 1"):
        supervisor.supervise(cmd, 2, rendezvous_dir=str(tmp_path / "f"), env=_fleet_env(),
                             inherit_env=False)
    pid = int(open(pid_file).read())
    deadline = time.monotonic() + 15
    while time.monotonic() < deadline:
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            break
        time.sleep(0.05)
    else:
        os.kill(pid, signal.SIGKILL)
        raise AssertionError(f"rank 0 (pid {pid}) left running")


# each rank trains its own float32 multiply-accumulate replica (the replay
# order changes the bits, so a wrong resume point shows); rank `kill_rank`
# SIGKILLs itself at the `kill_after` loop edge of its first incarnation
_TRAINER = """
import contextlib, os, sys, time
ckroot, num_steps, save_every, kill_rank, kill_after, slow0 = (
    sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), int(sys.argv[5]),
    float(sys.argv[6]))
import numpy as np
import torch
from tensorframes_tpu_torch.checkpoint import Checkpointer
from tensorframes_tpu_torch.resilience import KillRank, inject
from tensorframes_tpu_torch.training import run_resumable

rank = int(os.environ["TFTPU_PROCESS_INDEX"])
attempt = int(os.environ.get("TFTPU_FLEET_ATTEMPT", "0"))
stack = contextlib.ExitStack()
if rank == kill_rank and attempt == 0 and kill_after > 0:
    stack.enter_context(inject("fleet.rank.kill", KillRank, after=kill_after, max_times=1))
sleep_s = slow0 if rank == 0 else 0.01
factor = torch.tensor(1.01, dtype=torch.float32)

def step(state, batch):
    time.sleep(sleep_s)
    new = {"w": state["w"] * factor + batch}
    return new, {"loss": new["w"].sum()}

batches = [torch.full((4,), float(i % 7)) for i in range(num_steps)]
ck = Checkpointer(os.path.join(ckroot, f"rank{rank}"))
state, ran = run_resumable(step, {"w": torch.zeros(4)}, ck, batches, num_steps=num_steps,
                           save_every=save_every)
np.save(os.path.join(ckroot, f"final_rank{rank}.npy"), state["w"].numpy())
print("DONE", rank, ran, flush=True)
"""


def _mac_reference(num_steps):
    w = np.zeros(4, np.float32)
    for i in range(num_steps):
        w = w * np.float32(1.01) + np.full(4, float(i % 7), np.float32)
    return w


def _supervise_trainer(tmp_path, *, n, kill_rank, num_steps=40, save_every=2, kill_after=3):
    ckroot = str(tmp_path / "ck")
    os.makedirs(ckroot, exist_ok=True)
    bdir = str(tmp_path / "blackbox")
    result = supervisor.supervise(
        [sys.executable, "-c", _TRAINER, ckroot, str(num_steps), str(save_every),
         str(kill_rank), str(kill_after), "0.1"],
        n, rendezvous_dir=str(tmp_path / "fleet"), flight_dir=bdir, max_restarts=2,
        heartbeat_timeout_s=5.0, grace_s=5.0, env=_fleet_env(), inherit_env=False,
    )
    return result, ckroot, bdir


def test_kill9_rank_mid_run_resumable_restarts_and_converges(tmp_path):
    result, ckroot, bdir = _supervise_trainer(tmp_path, n=2, kill_rank=1)
    assert result.ok and result.restarts == 1 and result.attempts == 2
    assert result.exit_codes[0][1] == -signal.SIGKILL
    assert result.exit_codes[0][0] == fleet.ABORT_EXIT_CODE  # the survivor's coordinated abort
    assert result.failures[0].rank == 1 and result.failures[0].kind in ("signal", "abort")
    assert result.exit_codes[1] == {0: 0, 1: 0}
    assert result.recovery_seconds > 0
    ref = _mac_reference(40)
    for rank in range(2):
        np.testing.assert_array_equal(np.load(os.path.join(ckroot, f"final_rank{rank}.npy")), ref)
    records = port_flight.read_blackbox(bdir)
    assert "fault.kill_rank" in {r.get("kind") for r in records}
    aborts = [r for r in records if r.get("kind") == "fleet.abort_seen"]
    assert aborts and aborts[0]["ranks"] == [1]
    assert [f for f in os.listdir(bdir) if f.startswith("postmortem_") and "_p0_" in f]


@pytest.mark.slow
def test_kill9_on_4_process_fleet_converges(tmp_path):
    result, ckroot, _ = _supervise_trainer(tmp_path, n=4, kill_rank=2, num_steps=60)
    assert result.ok and result.restarts == 1
    assert result.exit_codes[0][2] == -signal.SIGKILL
    ref = _mac_reference(60)
    for rank in range(4):
        np.testing.assert_array_equal(np.load(os.path.join(ckroot, f"final_rank{rank}.npy")), ref)


_SILENT_WORKER = """
import contextlib, time
from tensorframes_tpu_torch.resilience import faults, fleet
stack = contextlib.ExitStack()
# beats 1..3 publish, then every beat is dropped: alive but silent
stack.enter_context(faults.inject("fleet.heartbeat", RuntimeError, after=3))
fleet.enroll(monitor=False)
time.sleep(60)
"""

_WATCHER_WORKER = """
import sys, time
from tensorframes_tpu_torch.resilience import fleet
assert fleet.enroll(abort_on_dead=True) is not None
time.sleep(60)  # the monitor thread aborts this process long before
print("UNDETECTED", flush=True)
sys.exit(1)
"""


def test_drop_heartbeat_detected_and_peer_aborts(tmp_path):
    import subprocess

    fdir, bdir = str(tmp_path / "fleet"), str(tmp_path / "blackbox")
    env = _fleet_env({"TFTPU_RUN_ID": "droptest", "TFTPU_FLEET_DIR": fdir,
                      "TFTPU_NUM_PROCESSES": "2", "TFTPU_FLIGHT_DIR": bdir})
    procs = []
    for i, src in enumerate((_SILENT_WORKER, _WATCHER_WORKER)):
        procs.append(subprocess.Popen([sys.executable, "-c", src],
                                      env={**env, "TFTPU_PROCESS_INDEX": str(i)}, cwd=_REPO,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    try:
        t0 = time.monotonic()
        out1, err1 = procs[1].communicate(timeout=120)
        elapsed = time.monotonic() - t0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert procs[1].returncode == fleet.ABORT_EXIT_CODE, f"rc={procs[1].returncode}\n{err1}"
    assert "UNDETECTED" not in out1 and elapsed < 30
    ab = fleet.abort_requested(fdir, "droptest")
    assert ab is not None and ab["ranks"] == [0] and "heartbeat" in ab["reason"]
    # the reference package reads the port's abort record the same
    assert ref_fleet.abort_requested(fdir, "droptest") == ab
    records = port_flight.read_blackbox(bdir)
    lost = [r for r in records if r.get("kind") == "fleet.heartbeat_lost"]
    assert lost and lost[0]["rank"] == 0 and lost[0]["never_started"] is False
    posts = [f for f in os.listdir(bdir) if f.startswith("postmortem_") and "_p1_" in f]
    assert posts
    header = json.loads(open(os.path.join(bdir, sorted(posts)[0])).readline())
    assert header["reason"] == "fleet_abort"


# ---------------------------------------------------------------------------
# the executor's dispatch deadline
# ---------------------------------------------------------------------------

def test_dispatch_deadline_trips_on_delayed_executor_dispatch(tmp_path):
    """A Delay at the executor's dispatch site under a dispatch deadline
    raises HungDispatchError and dumps a postmortem naming the dispatch,
    as the reference's executor does; no dispatch is exempted."""
    df = tft.frame_from_arrays({"x": np.arange(16.0)}, num_blocks=1)
    program = tft.compile_program(lambda x: {"y": x + 1.0}, df, device="cpu")
    before, exempt = fleet._HUNG_DISPATCHES.value, fleet._DEADLINE_EXEMPTIONS.value
    prev_spool = port_flight.RECORDER.spool_dir
    port_flight.set_spool_dir(str(tmp_path))
    tft.configure(dispatch_deadline_s=0.4)
    try:
        t0 = time.monotonic()
        with faults.inject("executor.dispatch", faults.Delay(10.0), max_times=1):
            with pytest.raises(fleet.HungDispatchError, match="deadline"):
                tft.map_blocks(program, df, device="cpu").collect()
        assert time.monotonic() - t0 < 5.0
        # the next dispatch, bounded, gives the plain call's values
        bounded = tft.map_blocks(program, df, device="cpu").column_values("y")
    finally:
        tft.configure(dispatch_deadline_s=0.0)
        port_flight.set_spool_dir(prev_spool)
    np.testing.assert_array_equal(
        bounded, tft.map_blocks(program, df, device="cpu").column_values("y"))
    np.testing.assert_array_equal(bounded, np.arange(16.0) + 1.0)
    assert fleet._HUNG_DISPATCHES.value == before + 1
    assert fleet._DEADLINE_EXEMPTIONS.value == exempt
    posts = [f for f in os.listdir(str(tmp_path)) if f.startswith("postmortem_")]
    assert posts
    lines = [json.loads(line) for line in open(os.path.join(str(tmp_path), sorted(posts)[-1]))]
    assert lines[0]["reason"] == "hung_dispatch"
    hung = [r for r in lines if r.get("kind") == "fleet.hung_dispatch"]
    assert hung and hung[0]["entry"] == "executor.run_block[y]"


# ---------------------------------------------------------------------------
# a supervised data-parallel gloo fleet through a kill -9 and a wedged rank
# ---------------------------------------------------------------------------

DP_STEPS, DP_SAVE_EVERY, DP_KILL_AFTER, DP_STOP_AFTER = 8, 2, 3, 5

# One gloo rank on the CPU: a 2-layer, 64-wide causal transformer on a
# {"dp": 2} mesh, AdamW, run_resumable over the 16-row frame's batches of
# 8 (4 rows a rank), checkpointing into its own dir. argv: the work dir, a
# port for each incarnation, and "1" to drill: rank 1 is killed at the
# loop edge after DP_KILL_AFTER steps in the first incarnation and stops
# itself (SIGSTOP) after DP_STOP_AFTER steps in the second. Each rank logs
# its newest checkpoint at start and every step it completes.
_DP_TRAINER = """
import contextlib, functools, json, os, signal, sys
import torch
torch.set_num_threads(1)
import tensorframes_tpu_torch as tft
from tensorframes_tpu_torch.checkpoint import Checkpointer
from tensorframes_tpu_torch.models import generation as gen, transformer as tr
from tensorframes_tpu_torch.parallel import distributed, init_distributed, make_mesh
from tensorframes_tpu_torch.resilience import KillRank, inject
from tensorframes_tpu_torch.utils.tree import flatten_with_keys

work, ports, drill = sys.argv[1], sys.argv[2].split(","), sys.argv[3] == "1"
steps, save_every, kill_after, stop_after = (int(a) for a in sys.argv[4:8])
rank = int(os.environ["TFTPU_PROCESS_INDEX"])
attempt = int(os.environ["TFTPU_FLEET_ATTEMPT"])

def log(**rec):
    with open(os.path.join(work, f"log{rank}.jsonl"), "a") as f:
        f.write(json.dumps({"rank": rank, "attempt": attempt, **rec}) + "\\n")

init_distributed(f"localhost:{ports[attempt]}", 2, rank, backend="gloo", device="cpu")
cfg = gen.gpt_tiny(hidden=64, num_heads=4, num_layers=2, max_seq_len=16)
tokens, targets = tr.synthetic_batch(cfg, 16, 16, seed=0)
frame = tft.frame_from_arrays({"tokens": tokens, "targets": targets})
batches = []
for epoch in range(steps):
    batches += list(tft.io.iterate_batches(frame, ["tokens", "targets"], 8, shuffle=True,
                                           seed=epoch, drop_remainder=True))
mesh = make_mesh({"dp": 2})
step, _, _, init_opt = tr.make_sharded_train_step(
    cfg, mesh, functools.partial(tr.adamw, learning_rate=1e-2))
params = tr.shard_params(cfg, tr.init_params(cfg, seed=0, device="cpu"), mesh)
opt = init_opt(params)
shards = [tr.shard_batch(mesh, b["tokens"], b["targets"]) for b in batches[:steps]]

def step_fn(state, b):
    p, o = state
    _, _, loss = step(p, o, *b)
    return (p, o), loss

def on_step(i, loss):
    log(step=i, loss=float(loss))
    if drill and rank == 1 and attempt == 1 and i == stop_after:
        os.kill(os.getpid(), signal.SIGSTOP)  # wedged: no beat, no collective

ck = Checkpointer(os.path.join(work, f"rank{rank}"))
log(latest=ck.latest_step())
with contextlib.ExitStack() as stack:
    if drill and rank == 1 and attempt == 0:
        stack.enter_context(inject("fleet.rank.kill", KillRank(), after=kill_after))
    state, ran = tft.training.run_resumable(step_fn, (params, opt), ck, shards,
                                            num_steps=steps, save_every=save_every,
                                            on_step=on_step)
torch.save({k: v.detach().clone() for k, v in flatten_with_keys(state)},
           os.path.join(work, f"final{rank}.pt"))
distributed.shutdown_distributed()
"""


def _free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("localhost", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def _dp_fleet(work, drill):
    os.makedirs(work)
    ports = ",".join(str(p) for p in _free_ports(3))
    argv = [sys.executable, "-c", _DP_TRAINER, work, ports, "1" if drill else "0",
            str(DP_STEPS), str(DP_SAVE_EVERY), str(DP_KILL_AFTER), str(DP_STOP_AFTER)]
    # the supervisor detects the wedged rank (1.5 s); the survivor's own
    # monitor, at twice that, is the backstop and leaves the verdict to it
    result = supervisor.supervise(
        argv, 2, rendezvous_dir=os.path.join(work, "fleet"),
        flight_dir=os.path.join(work, "blackbox"), max_restarts=2, heartbeat_timeout_s=1.5,
        grace_s=1.0, env=_fleet_env({"TFTPU_HEARTBEAT_TIMEOUT_S": "3.0"}), inherit_env=False,
    )
    logs = [json.loads(line) for r in range(2)
            for line in open(os.path.join(work, f"log{r}.jsonl"))]
    finals = [torch.load(os.path.join(work, f"final{r}.pt")) for r in range(2)]
    return result, logs, finals


def test_gloo_data_parallel_fleet_resumes_every_rank_from_one_step(tmp_path):
    result, logs, finals = _dp_fleet(str(tmp_path / "drill"), drill=True)
    assert result.ok and result.attempts == 3 and result.restarts == 2, result
    assert result.exit_codes[0][1] == -signal.SIGKILL
    assert result.exit_codes[1][1] == -signal.SIGKILL  # stopped, then killed by the teardown
    # the survivor ended through the coordinated abort, with no checkpoint
    # newer than its dead peer's
    assert [codes[0] for codes in result.exit_codes[:2]] == [fleet.ABORT_EXIT_CODE] * 2
    assert result.exit_codes[2] == {0: 0, 1: 0}
    assert result.failures[0].rank == 1 and result.failures[0].kind in ("signal", "abort")
    assert result.failures[1].rank == 1 and result.failures[1].kind == "heartbeat"
    starts = {(r["attempt"], r["rank"]): r["latest"] for r in logs if "latest" in r}
    assert starts == {(0, 0): None, (0, 1): None, (1, 0): 2, (1, 1): 2, (2, 0): 4, (2, 1): 4}
    for attempt, first in ((1, 3), (2, 5)):
        assert min(r["step"] for r in logs if r["attempt"] == attempt and "step" in r) == first
    records = port_flight.read_blackbox(str(tmp_path / "drill" / "blackbox"))
    kinds = [r.get("kind") for r in records]
    assert "fault.kill_rank" in kinds and "fleet.peer_lost" in kinds
    seen = [r for r in records if r.get("kind") == "fleet.abort_seen"]
    assert seen and all(r["ranks"] == [1] for r in seen)

    plain, plain_logs, plain_finals = _dp_fleet(str(tmp_path / "plain"), drill=False)
    assert plain.ok and plain.attempts == 1
    assert max(r["step"] for r in plain_logs if "step" in r) == DP_STEPS
    for got in finals + plain_finals[1:]:
        assert got.keys() == plain_finals[0].keys()
        bad = [k for k in got if not torch.equal(got[k], plain_finals[0][k])]
        assert not bad, bad
