"""Crash/resume on the CPU: a training subprocess of the port is SIGKILLed
mid-loop (no atexit, no exception path, no emergency checkpoint),
relaunched, and must reach exactly the state an uninterrupted run reaches —
the port of the JAX package's ``test_crash_resume.py``. The step is a
float32 multiply-accumulate, so a wrong resume point changes the bits.

Tolerances: none — the final state is compared bit for bit."""

import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
WAIT_S = 60

_TRAINER = """
import os, sys, time
ckdir, num_steps, sleep_s, save_every = (
    sys.argv[1], int(sys.argv[2]), float(sys.argv[3]), int(sys.argv[4]))
import numpy as np
import torch
from tensorframes_tpu_torch.checkpoint import Checkpointer
from tensorframes_tpu_torch.training import run_resumable

def step(state, batch):
    time.sleep(sleep_s)   # slow the loop so the SIGKILL lands mid-run
    new = {"w": state["w"] * torch.tensor(1.01, dtype=torch.float32) + batch}
    return new, {"loss": new["w"].sum()}

batches = [torch.full((4,), float(i % 7)) for i in range(num_steps)]
state, ran = run_resumable(step, {"w": torch.zeros(4)}, Checkpointer(ckdir), batches,
                           num_steps=num_steps, save_every=save_every)
np.save(os.path.join(ckdir, "final.npy"), state["w"].numpy())
print("DONE", ran, flush=True)
"""


def _spawn(ckdir, num_steps, sleep_s, save_every):
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    return subprocess.Popen([sys.executable, "-c", _TRAINER, ckdir, str(num_steps),
                             str(sleep_s), str(save_every)], env=env, cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _steps(ckdir):
    return [int(n.split("_")[1]) for n in os.listdir(ckdir)
            if n.startswith("step_") and "." not in n]


def _wait_for_checkpoint(proc, ckdir, min_step, timeout=WAIT_S):
    deadline = time.time() + timeout
    while time.time() < deadline:
        steps = _steps(ckdir)
        if steps and max(steps) >= min_step:
            return max(steps)
        if proc.poll() is not None:
            out, err = proc.communicate(timeout=WAIT_S)
            raise AssertionError(f"trainer exited (rc={proc.returncode}) before a checkpoint "
                                 f">= {min_step}\nstdout: {out}\nstderr: {err}")
        time.sleep(0.01)
    proc.kill()
    proc.wait(timeout=WAIT_S)
    raise AssertionError(f"no checkpoint >= {min_step} within {timeout}s")


def _kill(proc):
    os.kill(proc.pid, signal.SIGKILL)
    proc.communicate(timeout=WAIT_S)
    assert proc.returncode == -signal.SIGKILL


def _run_to_completion(ckdir, num_steps, save_every):
    proc = _spawn(ckdir, num_steps, 0.0, save_every)
    out, err = proc.communicate(timeout=WAIT_S)
    assert proc.returncode == 0 and "DONE" in out, f"stdout: {out}\nstderr: {err}"
    return np.load(os.path.join(ckdir, "final.npy"))


def _reference(num_steps):
    w = torch.zeros(4)
    for i in range(num_steps):
        w = w * torch.tensor(1.01, dtype=torch.float32) + torch.full((4,), float(i % 7))
    return w.numpy()


def test_kill9_mid_training_resumes_to_identical_state(tmp_path):
    """SIGKILL after the first checkpoint lands, relaunch: the final state
    equals an uninterrupted run's bit for bit."""
    ckdir = str(tmp_path / "run")
    os.makedirs(ckdir)
    num_steps, save_every = 40, 2
    proc = _spawn(ckdir, num_steps, 0.05, save_every)
    try:
        killed_at = _wait_for_checkpoint(proc, ckdir, min_step=save_every)
        _kill(proc)
    finally:
        if proc.poll() is None:  # pragma: no cover - cleanup on test bugs
            proc.kill()
            proc.wait(timeout=WAIT_S)
    assert killed_at < num_steps
    assert not os.path.exists(os.path.join(ckdir, "final.npy"))
    final = _run_to_completion(ckdir, num_steps, save_every)
    assert final.tobytes() == _reference(num_steps).tobytes()


@pytest.mark.slow
def test_repeated_kill9_still_converges(tmp_path):
    """Three preemptions at whatever instants the scheduler deals, possibly
    mid-save, then a clean finish: still the uninterrupted run's bits."""
    ckdir = str(tmp_path / "run")
    os.makedirs(ckdir)
    num_steps, save_every = 60, 2
    for _ in range(3):
        proc = _spawn(ckdir, num_steps, 0.04, save_every)
        try:
            prev = _steps(ckdir)
            target = (max(prev) if prev else 0) + save_every
            if target >= num_steps:
                break
            _wait_for_checkpoint(proc, ckdir, min_step=target)
            _kill(proc)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=WAIT_S)
    final = _run_to_completion(ckdir, num_steps, save_every)
    assert final.tobytes() == _reference(num_steps).tobytes()
