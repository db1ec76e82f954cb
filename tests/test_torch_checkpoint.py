"""The port's checkpoints (``tensorframes_tpu_torch.checkpoint``) on the CPU:
the cases of the JAX package's ``test_checkpoint.py`` (npz) and the
checkpoint cases of its ``test_resilience.py`` — CRC and size manifests,
truncated and corrupt newest steps, a corrupt manifest, ``verify``, temp-dir
GC, crashed-swap healing, retried fault sites — then the shared format: a
tree saved by either package restores bit for bit in the other, bf16
included, and a bf16 checkpoint saves and restores with ``ml_dtypes``
blocked. Train states (a tree holding its optimizer) restore in place.

Tolerances: none — every comparison is of bits."""

import json
import os
import subprocess
import sys
import zlib
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorframes_tpu.checkpoint import Checkpointer as JCheckpointer
from tensorframes_tpu_torch import checkpoint as ckp
from tensorframes_tpu_torch.checkpoint import CheckpointCorruptionError, Checkpointer
from tensorframes_tpu_torch.models import generation as tgen
from tensorframes_tpu_torch.models import transformer as ttr
from tensorframes_tpu_torch.resilience import RetryPolicy, inject

ROOT = Path(__file__).resolve().parents[1]


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "params": {"w": torch.randn(8, 4, generator=g), "b": torch.zeros(4)},
        "step": torch.tensor(7, dtype=torch.int32),
        "layers": [{"scale": torch.ones(3)}, {"scale": torch.full((3,), 2.0)}],
    }


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _assert_tree_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


def _save_steps(root, steps):
    ck = Checkpointer(str(root))
    for s in steps:
        ck.save(s, {"w": torch.full((4,), float(s))})
    return ck


# ---------------------------------------------------------------------------
# the reference's test_checkpoint.py cases
# ---------------------------------------------------------------------------

def test_roundtrip_returns_new_tensors(tmp_path):
    ckpt = Checkpointer(str(tmp_path / "run"))
    state = _state()
    ckpt.save(10, state)
    like = _state(seed=1)
    before = [t.clone() for t in _leaves(like)]
    restored = ckpt.restore(like=like)
    _assert_tree_equal(state, restored)
    assert all(torch.equal(a, b) for a, b in zip(before, _leaves(like)))  # like untouched
    assert ckpt.backend == "npz"


def test_latest_and_retention(tmp_path):
    ckpt = Checkpointer(str(tmp_path / "run"), keep=2)
    for step in (5, 10, 15):
        ckpt.save(step, _state(seed=step))
    assert ckpt.latest_step() == 15
    assert ckpt.all_steps() == [10, 15]
    _assert_tree_equal(_state(seed=10), ckpt.restore(step=10, like=_state()))


def test_restore_missing_raises(tmp_path):
    ckpt = Checkpointer(str(tmp_path / "empty"))
    with pytest.raises(FileNotFoundError):
        ckpt.restore()
    with pytest.raises(FileNotFoundError):
        ckpt.restore(step=99)


def test_template_mismatch_raises(tmp_path):
    ckpt = Checkpointer(str(tmp_path / "run"))
    ckpt.save(1, {"a": torch.ones(2)})
    with pytest.raises(ValueError):
        ckpt.restore(like={"a": torch.ones(2), "b": torch.ones(2)})
    with pytest.raises(ValueError, match="lacks"):
        ckpt.restore(like={})


def test_overwrite_same_step(tmp_path):
    ckpt = Checkpointer(str(tmp_path / "run"))
    ckpt.save(1, {"a": torch.ones(2)})
    ckpt.save(1, {"a": torch.full((2,), 5.0)})
    assert ckpt.restore(step=1, like={"a": torch.zeros(2)})["a"].tolist() == [5.0, 5.0]


def test_bfloat16_and_zero_dim_roundtrip(tmp_path):
    ckpt = Checkpointer(str(tmp_path / "run"))
    state = {"w": torch.full((3, 2), 1.5, dtype=torch.bfloat16),
             "step": torch.tensor(7, dtype=torch.int32), "s": 2.5}
    ckpt.save(1, state)
    got = ckpt.restore(like={"w": torch.zeros(3, 2, dtype=torch.bfloat16),
                             "step": torch.tensor(0, dtype=torch.int32), "s": 0.0})
    assert got["w"].dtype == torch.bfloat16 and torch.equal(got["w"], state["w"])
    assert got["step"].shape == () and int(got["step"]) == 7
    assert isinstance(got["s"], np.ndarray) and got["s"].shape == () and float(got["s"]) == 2.5
    manifest = json.loads((tmp_path / "run" / "step_1" / "manifest.json").read_text())
    assert [(e["key"], e["dtype"], e["shape"]) for e in manifest] == [
        ("['s']", "float64", []), ("['step']", "int32", []), ("['w']", "bfloat16", [3, 2])]


def test_orbax_backend_refused(tmp_path):
    with pytest.raises(ValueError, match="JAX package's checkpoint format"):
        Checkpointer(str(tmp_path), backend="orbax")
    with pytest.raises(ValueError, match="unknown"):
        Checkpointer(str(tmp_path), backend="zarr")


def test_restore_like_none_is_flat_keystr_dict(tmp_path):
    ckpt = Checkpointer(str(tmp_path))
    ckpt.save(1, {"b": [torch.ones(1), torch.zeros(2)], "a": torch.arange(3)})
    got = ckpt.restore()
    assert list(got) == ["['a']", "['b'][0]", "['b'][1]"]
    assert torch.equal(got["['a']"], torch.arange(3))


# ---------------------------------------------------------------------------
# integrity: the reference's test_resilience.py checkpoint cases
# ---------------------------------------------------------------------------

def test_manifest_records_crc_and_size(tmp_path):
    _save_steps(tmp_path / "run", [1])
    entry = json.loads((tmp_path / "run" / "step_1" / "manifest.json").read_text())[0]
    assert entry["nbytes"] == 16 and entry["dtype"] == "float32" and entry["key"] == "['w']"
    assert entry["crc32"] == zlib.crc32(np.full((4,), 1.0, np.float32).tobytes())


def test_truncated_newest_falls_back_to_previous(tmp_path):
    ck = _save_steps(tmp_path / "run", [1, 2, 3])
    payload = tmp_path / "run" / "step_3" / "arrays.npz"
    payload.write_bytes(payload.read_bytes()[: payload.stat().st_size // 2])
    assert ck.restore(like={"w": torch.zeros(4)})["w"].tolist() == [2.0] * 4


def test_crc_mismatch_falls_back(tmp_path):
    """A payload that is still a valid zip is caught by the per-array CRC."""
    ck = _save_steps(tmp_path / "run", [1, 2])
    np.savez_compressed(tmp_path / "run" / "step_2" / "arrays.npz", a0=np.zeros(16, np.uint8))
    assert ck.restore(like={"w": torch.zeros(4)})["w"].tolist() == [1.0] * 4
    assert ck.latest_intact_step() == 1


def test_explicit_step_corruption_raises(tmp_path):
    ck = _save_steps(tmp_path / "run", [1, 2])
    (tmp_path / "run" / "step_2" / "arrays.npz").write_bytes(b"garbage")
    with pytest.raises(CheckpointCorruptionError):
        ck.restore(step=2, like={"w": torch.zeros(4)})
    assert ck.restore(step=1, like={"w": torch.zeros(4)})["w"].tolist() == [1.0] * 4


def test_all_steps_corrupt_raises(tmp_path):
    ck = _save_steps(tmp_path / "run", [1, 2])
    for s in (1, 2):
        (tmp_path / "run" / f"step_{s}" / "arrays.npz").write_bytes(b"x")
    with pytest.raises(CheckpointCorruptionError, match="no intact checkpoint"):
        ck.restore(like={"w": torch.zeros(4)})


@pytest.mark.parametrize("damage", ["bad_json", "missing"])
def test_corrupt_manifest_falls_back(tmp_path, damage):
    ck = _save_steps(tmp_path / "run", [1, 2])
    manifest = tmp_path / "run" / "step_2" / "manifest.json"
    if damage == "bad_json":
        manifest.write_text("{not json")
    else:
        manifest.unlink()
    assert ck.restore(like={"w": torch.zeros(4)})["w"].tolist() == [1.0] * 4
    assert ck.verify(2)[2]["ok"] is False


def test_verify_audit_mode(tmp_path):
    ck = _save_steps(tmp_path / "run", [1, 2, 3])
    (tmp_path / "run" / "step_2" / "arrays.npz").write_bytes(b"zzz")
    report = ck.verify()
    assert report[1]["ok"] is True and report[3]["ok"] is True
    assert report[2]["ok"] is False and report[2]["errors"]
    assert ck.all_steps() == [1, 2, 3]  # read-only


def test_verify_returns_report_on_transient_read_errors(tmp_path, monkeypatch):
    _save_steps(tmp_path / "run", [1])
    ck = Checkpointer(str(tmp_path / "run"), retry=RetryPolicy(max_attempts=2, backoff=0.001))
    monkeypatch.setattr(type(ck), "_read_npz_payload",
                        lambda self, path: (_ for _ in ()).throw(OSError("EIO")))
    report = ck.verify()
    assert report[1]["ok"] is None
    assert any("transient read error" in e for e in report[1]["errors"])


def test_tmp_gc_liveness_rules(tmp_path):
    """Init-time GC spares a live writer's temp and this process's
    registered in-flight temp; it collects dead writers' and unregistered
    same-pid temps (a restarted container reuses its pid)."""
    root = tmp_path / "run"
    _save_steps(root, [1])
    stale = root / f"step_7.tmp{os.getpid()}_deadbeef"
    in_flight = root / f"step_9.tmp{os.getpid()}_cafef00d"
    dead_pid = subprocess.run([sys.executable, "-c", "import os; print(os.getpid())"],
                              capture_output=True, text=True, timeout=60).stdout.strip()
    dead = root / f"step_8.tmp{dead_pid}_cafebabe"
    for d in (stale, in_flight, dead):
        d.mkdir()
    (dead / "arrays.npz").write_bytes(b"partial")
    ckp._live_tmps.add(str(in_flight))
    try:
        ck = Checkpointer(str(root))
        assert not stale.exists() and not dead.exists() and in_flight.exists()
        assert ck.all_steps() == [1]
    finally:
        ckp._live_tmps.discard(str(in_flight))


def test_crashed_publish_heals_on_init(tmp_path):
    root = tmp_path / "run"
    _save_steps(root, [2, 4])
    os.rename(root / "step_4", root / "step_4.old")  # killed inside the swap
    ck = Checkpointer(str(root))
    assert ck.all_steps() == [2, 4]
    assert ck.restore(like={"w": torch.zeros(4)})["w"].tolist() == [4.0] * 4
    _save_steps(root, [6])
    (root / "step_6.old").mkdir()
    Checkpointer(str(root))
    assert not (root / "step_6.old").exists() and (root / "step_6").exists()


def test_resave_same_step_never_leaves_gap(tmp_path):
    ck = _save_steps(tmp_path / "run", [3])
    ck.save(3, {"w": torch.full((4,), 99.0)})
    assert ck.restore(step=3, like={"w": torch.zeros(4)})["w"].tolist() == [99.0] * 4
    assert not (tmp_path / "run" / "step_3.old").exists()


def test_save_restore_under_injected_io_faults(tmp_path):
    ck = Checkpointer(str(tmp_path / "run"), retry=RetryPolicy(max_attempts=3, backoff=0.001))
    with inject("checkpoint.save", OSError, every_n=2) as inj:
        for s in (1, 2, 3, 4):
            ck.save(s, {"w": torch.full((2,), float(s))})
    assert inj.fired >= 1 and ck.all_steps() == [1, 2, 3, 4]
    with inject("checkpoint.restore", OSError, every_n=2) as inj:
        for s in (1, 2, 3, 4):
            assert ck.restore(step=s, like={"w": torch.zeros(2)})["w"].tolist() == [float(s)] * 2
    assert inj.fired >= 1


def test_unretried_fault_propagates(tmp_path):
    ck = Checkpointer(str(tmp_path / "run"))
    with inject("checkpoint.save", OSError, every_n=1):
        with pytest.raises(OSError):
            ck.save(1, {"w": torch.ones(2)})
    assert ck.all_steps() == []


def test_checkpoint_metrics_and_crc_failures(tmp_path):
    from tensorframes_tpu_torch.observability.metrics import REGISTRY

    def snap():
        return {(d["name"]): d for d in REGISTRY.snapshot() if d["name"].startswith(
            "tftpu_checkpoint")}

    before = snap()
    ck = Checkpointer(str(tmp_path))
    state = {"w": torch.arange(8.0), "b": torch.tensor(2.0, dtype=torch.float64)}
    ck.save(1, state)
    ck.save(2, state)
    ck.restore(like=state)
    npz = tmp_path / "step_2" / "arrays.npz"
    npz.write_bytes(npz.read_bytes()[:-7])
    assert ck.restore_latest(like=state)[0] == 1
    after = snap()
    assert after["tftpu_checkpoint_save_seconds"]["count"] - \
        before["tftpu_checkpoint_save_seconds"]["count"] == 2
    assert after["tftpu_checkpoint_save_bytes_total"]["value"] > \
        before["tftpu_checkpoint_save_bytes_total"]["value"]
    assert after["tftpu_checkpoint_restore_seconds"]["count"] - \
        before["tftpu_checkpoint_restore_seconds"]["count"] == 3
    assert after["tftpu_checkpoint_crc_failures_total"]["value"] > \
        before["tftpu_checkpoint_crc_failures_total"]["value"]


# ---------------------------------------------------------------------------
# train states: restored in place
# ---------------------------------------------------------------------------

def _trained(seed, steps=2):
    cfg = tgen.gpt_tiny(attention_impl="dense")
    params = ttr.init_params(cfg, seed=seed, device="cpu")
    opt = ttr.adamw(params, 1e-3)
    step = ttr.make_train_step(cfg, opt)
    toks, tg = ttr.synthetic_batch(cfg, 2, 8, seed=seed)
    for _ in range(steps):
        step(params, opt.state, torch.from_numpy(toks), torch.from_numpy(tg))
    return params, opt


def test_train_state_restores_in_place_with_moments_and_step_counts(tmp_path):
    params, opt = _trained(0)
    ck = Checkpointer(str(tmp_path))
    ck.save(2, (params, opt))
    manifest = json.loads((tmp_path / "step_2" / "manifest.json").read_text())
    assert manifest[-1]["key"] == f"[1]['state'][{len(opt.state) - 1}]['step']"
    fresh = ttr.init_params(tgen.gpt_tiny(attention_impl="dense"), seed=5, device="cpu")
    fresh_opt = ttr.adamw(fresh, 1e-3)  # empty state, as in a new process
    held = ttr.tree_leaves(fresh)
    out = ck.restore(like=(fresh, fresh_opt))
    assert out[1] is fresh_opt and all(a is b for a, b in zip(ttr.tree_leaves(out[0]), held))
    assert all(torch.equal(a, b) for a, b in zip(held, ttr.tree_leaves(params)))
    want, got = opt.state_dict()["state"], fresh_opt.state_dict()["state"]
    assert set(got) == set(want)
    for i in want:
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(got[i][k], want[i][k]), (i, k)
    # the optimizer steps the tensors it holds, from the restored moments
    cfg = tgen.gpt_tiny(attention_impl="dense")
    toks, tg = ttr.synthetic_batch(cfg, 2, 8, seed=9)
    ttr.make_train_step(cfg, opt)(params, opt.state, torch.from_numpy(toks), torch.from_numpy(tg))
    ttr.make_train_step(cfg, fresh_opt)(fresh, fresh_opt.state, torch.from_numpy(toks),
                                        torch.from_numpy(tg))
    assert all(torch.equal(a, b) for a, b in zip(ttr.tree_leaves(fresh), ttr.tree_leaves(params)))


def test_train_state_mismatch_writes_nothing(tmp_path):
    params, opt = _trained(0, steps=1)
    ck = Checkpointer(str(tmp_path))
    ck.save(1, (params, opt))
    other = ttr.init_params(tgen.gpt_tiny(attention_impl="dense", hidden=16), seed=3,
                            device="cpu")
    before = [t.clone() for t in ttr.tree_leaves(other)]
    with pytest.raises(ValueError):
        ck.restore(like=(other, ttr.adamw(other, 1e-3)))
    assert all(torch.equal(a, b) for a, b in zip(before, ttr.tree_leaves(other)))


def test_optimizer_state_dict_without_the_optimizer_is_refused(tmp_path):
    params, opt = _trained(0, steps=1)
    with pytest.raises(TypeError, match="Optimizer itself"):
        Checkpointer(str(tmp_path)).save(1, (params, opt.state))


# ---------------------------------------------------------------------------
# one format, both packages
# ---------------------------------------------------------------------------

def _mixed_numpy(seed=0):
    rng = np.random.default_rng(seed)
    import ml_dtypes

    return {
        "f32": rng.standard_normal((3, 5)).astype(np.float32),
        "f64": rng.standard_normal(4),
        "bf16": rng.standard_normal((2, 3)).astype(ml_dtypes.bfloat16),
        "i32": rng.integers(-(2**31), 2**31 - 1, (6,), dtype=np.int32),
        "mask": rng.integers(0, 2, (2, 2)).astype(bool),
        "scalar": np.asarray(7, np.int32),
        "nested": [{"a": rng.standard_normal(2).astype(np.float32)}, (np.float32(1.25),)],
    }


def _torch_of(tree):
    if isinstance(tree, dict):
        return {k: _torch_of(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_torch_of(v) for v in tree)
    arr = np.asarray(tree)
    if str(arr.dtype) == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(arr.copy())


def _bits(x):
    if torch.is_tensor(x):
        x = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        return x.numpy().tobytes(), list(x.shape)
    arr = np.asarray(x)
    return arr.tobytes(), list(arr.shape)


def test_jax_checkpoint_restores_bit_for_bit_in_the_port(tmp_path):
    tree = _mixed_numpy()
    JCheckpointer(str(tmp_path), backend="npz").save(3, {k: (jnp.asarray(v) if k != "nested"
                                                             else v) for k, v in tree.items()})
    like = _torch_of(_mixed_numpy(seed=1))
    got = Checkpointer(str(tmp_path)).restore(like=like)
    want = _torch_of(tree)
    for g, w in zip(_leaves(got), _leaves(want)):
        assert g.dtype == w.dtype and _bits(g) == _bits(w)


def test_port_checkpoint_restores_bit_for_bit_in_jax(tmp_path):
    tree = _mixed_numpy()
    Checkpointer(str(tmp_path)).save(3, _torch_of(tree))
    like = {k: (jnp.asarray(v) if k != "nested" else v) for k, v in _mixed_numpy(seed=1).items()}
    got = JCheckpointer(str(tmp_path), backend="npz").restore(like=like)
    import jax

    for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(tree)):
        assert np.asarray(g).dtype == np.asarray(w).dtype and _bits(g) == _bits(w)
    # the manifests agree entry for entry, CRCs included
    JCheckpointer(str(tmp_path / "j"), backend="npz").save(
        3, {k: (jnp.asarray(v) if k != "nested" else v) for k, v in tree.items()})
    port = json.loads((tmp_path / "step_3" / "manifest.json").read_text())
    ref = json.loads((tmp_path / "j" / "step_3" / "manifest.json").read_text())
    assert port == ref


def test_bf16_checkpoint_without_ml_dtypes(tmp_path):
    """The card's machine has no ml_dtypes: with it blocked, a bf16 tree
    saves and restores, and the bytes equal the JAX package's bf16."""
    code = (
        "import sys\n"
        "sys.modules['ml_dtypes'] = None\n"
        "import torch\n"
        "from tensorframes_tpu_torch.checkpoint import Checkpointer\n"
        "w = (torch.arange(6, dtype=torch.float32) / 3).to(torch.bfloat16).reshape(2, 3)\n"
        f"ck = Checkpointer({str(tmp_path)!r})\n"
        "ck.save(1, {'w': w, 'n': torch.tensor(3)})\n"
        "got = ck.restore(like={'w': torch.zeros(2, 3, dtype=torch.bfloat16), 'n': torch.tensor(0)})\n"
        "assert got['w'].dtype == torch.bfloat16 and torch.equal(got['w'], w), got\n"
        "assert 'ml_dtypes' not in [m for m in sys.modules if sys.modules[m] is not None]\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=60)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
    import ml_dtypes

    got = JCheckpointer(str(tmp_path), backend="npz").restore(
        like={"n": jnp.asarray(0), "w": jnp.zeros((2, 3), jnp.bfloat16)})
    want = (np.arange(6, dtype=np.float32) / 3).astype(ml_dtypes.bfloat16).reshape(2, 3)
    assert np.asarray(got["w"]).tobytes() == want.tobytes()
