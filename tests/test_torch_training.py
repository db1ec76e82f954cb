"""The port's training path against the JAX package's on the CPU: the loss,
the train step under AdamW, rematerialisation, ``iterate_batches``,
``prefetch_to_device`` and ``train_on_frame``. The reference's weights are
carried across by ``params_from_jax``; tokens and frames come from numpy.

Tolerances, per check:
- the optimizer alone, on the same gradients: |got - want| <= 1e-6·|want|
  + 1e-9 (``torch.optim.AdamW`` and ``optax.adamw`` take the same steps in
  f32, grouped differently).
- f32 train steps (``tiny``, ``gpt_tiny``, flash): losses rtol 1e-5 (the
  two sides sum in other orders; ~1e-7 seen). Parameters after 3 steps
  rtol 1e-5 plus atol 5e-5 = 0.05·lr: Adam divides each gradient by its
  running RMS, so an entry whose gradient is near eps moves by another
  fraction of lr on each side (one entry in ~10^4 does; the worst seen is
  2.1e-5).
- bf16, 2 layers 768 wide: XLA and PyTorch round bf16 at other places,
  and flash rounds p and dS to bf16 where the JAX package's CPU flash
  (blockwise) keeps f32: loss within 1e-3 relative (8e-5 seen), each
  leaf's gradient within 5e-2·max|grad| (the worst seen is 1.7e-2).
- ``iterate_batches``, the prefetched batches, remat: exact.
- ``train_on_frame``: losses per step rtol 1e-5, as the train step.
"""

import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import tensorframes_tpu as jt
import tensorframes_tpu_torch as tft
from tensorframes_tpu import io as jio
from tensorframes_tpu import training as jtraining
from tensorframes_tpu.models import generation as jgen
from tensorframes_tpu.models import transformer as jtr
from tensorframes_tpu.checkpoint import Checkpointer as jCheckpointer
from tensorframes_tpu_torch import io as tio
from tensorframes_tpu_torch import training as ttraining
from tensorframes_tpu_torch.checkpoint import Checkpointer as tCheckpointer
from tensorframes_tpu_torch.observability.steps import StepTelemetry as tStepTelemetry
from tensorframes_tpu_torch.models import generation as tgen
from tensorframes_tpu_torch.models import transformer as ttr

CPU = "cpu"
LR = 1e-3
CONFIGS = {
    "tiny": (lambda: jtr.tiny(dtype=jnp.float32, attention_impl="flash"),
             lambda **kw: ttr.tiny(dtype=torch.float32, attention_impl="flash", **kw), 16),
    "gpt_tiny": (lambda: jgen.gpt_tiny(attention_impl="flash"),
                 lambda **kw: tgen.gpt_tiny(attention_impl="flash", **kw), 48),
}


def _carry(pj):
    return ttr.params_from_jax(jax.tree_util.tree_map(np.asarray, pj), CPU)


def _leaves_close(got_tree, want_tree, rtol, atol):
    got = ttr.tree_leaves(got_tree)
    want = jax.tree_util.tree_leaves(want_tree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=rtol, atol=atol)


def test_adamw_matches_optax_on_the_same_gradients():
    """``transformer.adamw`` against ``optax.adamw(lr)`` for 3 steps of
    the same seeded gradients: the same decoupled weight decay and
    bias-corrected moments."""
    rng = np.random.default_rng(0)
    tree = {"a": rng.standard_normal((5, 7)).astype(np.float32),
            "b": [rng.standard_normal(3).astype(np.float32)]}
    grads = [jax.tree_util.tree_map(lambda x: rng.standard_normal(x.shape).astype(np.float32),
                                    tree) for _ in range(3)]
    tx = optax.adamw(LR)
    pj, state = jax.tree_util.tree_map(jnp.asarray, tree), tx.init(tree)
    pt = _carry(tree)
    opt = ttr.adamw(pt, LR)
    assert [t for t in ttr.tree_leaves(pt)] == opt.param_groups[0]["params"]
    for g in grads:
        updates, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), state, pj)
        pj = optax.apply_updates(pj, updates)
        for leaf, gl in zip(ttr.tree_leaves(pt), jax.tree_util.tree_leaves(g)):
            leaf.grad = torch.from_numpy(gl)
        opt.step()
    _leaves_close(pt, pj, 1e-6, 1e-9)


def test_loss_matches_jax_f32():
    cj, ct, seq = (f() if i < 2 else f for i, f in enumerate(CONFIGS["gpt_tiny"]))
    pj = jtr.init_params(cj, seed=1)
    toks, tg = jtr.synthetic_batch(cj, 3, seq, seed=1)
    want = float(jtr.loss_fn(cj, pj, jnp.asarray(toks), jnp.asarray(tg)))
    got = ttr.loss_fn(ct, _carry(pj), torch.from_numpy(toks), torch.from_numpy(tg))
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), want, rtol=1e-6)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_train_step_matches_jax_f32(name):
    """3 steps of ``make_train_step`` under AdamW(1e-3) from the same
    weights on the same batches: the losses and every parameter after."""
    jcfg, tcfg, seq = CONFIGS[name]
    cj, ct = jcfg(), tcfg()
    pj = jtr.init_params(cj, seed=0)
    pt = _carry(pj)
    tx = optax.adamw(LR)
    sj = tx.init(pj)
    jstep = jax.jit(jtr.make_train_step(cj, tx))
    opt = ttr.adamw(pt, LR)
    tstep = ttr.make_train_step(ct, opt)
    st = opt.state
    for i in range(3):
        toks, tg = jtr.synthetic_batch(cj, 4, seq, seed=i)
        pj, sj, lj = jstep(pj, sj, jnp.asarray(toks), jnp.asarray(tg))
        out = tstep(pt, st, torch.from_numpy(toks), torch.from_numpy(tg))
        assert out[0] is pt and out[1] is st  # updated in place
        np.testing.assert_allclose(float(out[2]), float(lj), rtol=1e-5)
    _leaves_close(pt, pj, 1e-5, 5e-2 * LR)


W768 = dict(num_layers=2, vocab_size=1024, max_seq_len=128)


def test_train_step_gradients_768_wide_bf16():
    """A 2-layer 768-wide bf16 flash model: one step's loss and every
    leaf's gradient against ``jax.value_and_grad`` of the reference's
    ``loss_fn``."""
    cj = jtr.TransformerConfig(attention_impl="flash", causal=True, **W768)
    ct = ttr.TransformerConfig(attention_impl="flash", causal=True, **W768)
    pj = jtr.init_params(cj, seed=0)
    toks, tg = jtr.synthetic_batch(cj, 2, 64, seed=2)
    lj, gj = jax.value_and_grad(lambda p: jtr.loss_fn(cj, p, jnp.asarray(toks),
                                                      jnp.asarray(tg)))(pj)
    pt = _carry(pj)
    leaves = ttr.tree_leaves(pt)
    for leaf in leaves:
        leaf.requires_grad_(True)
    lt = ttr.loss_fn(ct, pt, torch.from_numpy(toks), torch.from_numpy(tg))
    gt = torch.autograd.grad(lt, leaves)
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-3)
    for g, w in zip(gt, jax.tree_util.tree_leaves(gj)):
        w = np.asarray(w, np.float64)
        diff = np.abs(g.numpy().astype(np.float64) - w).max()
        assert diff <= 5e-2 * np.abs(w).max(), (diff, np.abs(w).max())


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_remat_gives_the_same_gradients(impl):
    """``remat=True`` recomputes each layer in the backward pass and gives
    the bits of ``remat=False``."""
    ct = tgen.gpt_tiny(attention_impl=impl)
    toks, tg = ttr.synthetic_batch(ct, 3, 20, seed=4)
    grads = []
    for remat in (False, True):
        pt = ttr.init_params(ct, seed=4, device=CPU)
        leaves = ttr.tree_leaves(pt)
        for leaf in leaves:
            leaf.requires_grad_(True)
        cfg = tgen.gpt_tiny(attention_impl=impl, remat=remat)
        loss = ttr.loss_fn(cfg, pt, torch.from_numpy(toks), torch.from_numpy(tg))
        grads.append((loss, torch.autograd.grad(loss, leaves)))
    (l0, g0), (l1, g1) = grads
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


def _frames(n=10, seed=5):
    rng = np.random.default_rng(seed)
    cols = {"tokens": rng.integers(0, 97, (n, 12)).astype(np.int32),
            "targets": rng.integers(0, 97, (n, 12)).astype(np.int32),
            "w": rng.standard_normal((n, 3)).astype(np.float32)}
    return jt.frame_from_arrays(cols), tft.frame_from_arrays(cols)


@pytest.mark.parametrize("shuffle,drop,bs,cols", [
    (False, False, 4, None), (True, False, 3, None), (True, True, 4, ["targets", "w"]),
    (True, True, 10, ["w"]),
])
def test_iterate_batches_matches_jax(shuffle, drop, bs, cols):
    jf, tf = _frames()
    want = list(jio.iterate_batches(jf, cols, bs, shuffle=shuffle, seed=3, drop_remainder=drop))
    got = list(tio.iterate_batches(tf, cols, bs, shuffle=shuffle, seed=3, drop_remainder=drop))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for c in w:
            assert g[c].dtype == w[c].dtype
            np.testing.assert_array_equal(g[c], w[c])


def test_prefetch_delivers_every_batch_in_order_on_cpu():
    _, tf = _frames()
    batches = list(tio.iterate_batches(tf, None, 3, shuffle=True, seed=1))
    got = list(tio.prefetch_to_device(iter(batches), size=2, device=CPU))
    assert len(got) == len(batches)
    for g, w in zip(got, batches):
        assert set(g) == set(w)
        for c in w:
            assert isinstance(g[c], torch.Tensor) and g[c].device.type == "cpu"
            np.testing.assert_array_equal(g[c].numpy(), w[c])


def test_prefetch_reraises_a_worker_error_after_the_staged_batches():
    def source():
        yield {"x": np.zeros(2)}
        yield {"x": np.ones(2)}
        raise RuntimeError("reader failed")

    it = tio.prefetch_to_device(source(), size=4, device=CPU)
    assert float(next(it)["x"].sum()) == 0.0
    assert float(next(it)["x"].sum()) == 2.0
    with pytest.raises(RuntimeError, match="reader failed"):
        next(it)


def test_prefetch_close_joins_the_worker():
    def endless():
        i = 0
        while True:
            yield {"x": np.full(2, i)}
            i += 1

    before = {t.ident for t in threading.enumerate()}
    it = tio.prefetch_to_device(endless(), size=2, device=CPU)
    assert float(next(it)["x"][0]) == 0.0
    it.close()
    assert not [t for t in threading.enumerate()
                if t.ident not in before and t.name == "tftorch-prefetch"]
    with pytest.raises(ValueError, match="size must be >= 1"):
        tio.prefetch_to_device(endless(), size=0, device=CPU)


@pytest.mark.parametrize("prefetch", [0, 2])
def test_train_on_frame_matches_jax(prefetch):
    """5 steps of batch 4 over 10 rows (two batches an epoch, reshuffled
    each epoch): the per-step losses of the reference's ``train_on_frame``
    over its jitted ``make_train_step``."""
    jf, tf = _frames()
    cj, ct = jgen.gpt_tiny(attention_impl="flash"), tgen.gpt_tiny(attention_impl="flash")
    pj = jtr.init_params(cj, seed=6)
    tx = optax.adamw(LR)
    jstep = jax.jit(jtr.make_train_step(cj, tx))

    def jfn(state, batch):
        p, s, loss = jstep(*state, batch["tokens"], batch["targets"])
        return (p, s), loss

    want = []
    jtraining.train_on_frame(jfn, (pj, tx.init(pj)), jf, ["tokens", "targets"], batch_size=4,
                             num_steps=5, seed=2, on_step=lambda i, l: want.append(float(l)))
    pt = _carry(pj)
    opt = ttr.adamw(pt, LR)
    tstep = ttr.make_train_step(ct, opt)

    def tfn(state, batch):
        p, s, loss = tstep(*state, batch["tokens"], batch["targets"])
        return (p, s), loss

    got, steps = [], []
    state, ran = ttraining.train_on_frame(
        tfn, (pt, opt.state), tf, ["tokens", "targets"], batch_size=4, num_steps=5, seed=2,
        prefetch=prefetch, on_step=lambda i, l: (steps.append(i), got.append(float(l))),
        device=CPU)
    assert ran == 5 and steps == [1, 2, 3, 4, 5] and state[0] is pt
    np.testing.assert_allclose(got, want, rtol=1e-5)


class _Crash(RuntimeError):
    pass


def _gpt_tiny_frame_run(pkg, cfg, state, step_fn, frame, ckdir, num_steps, crash_after=None,
                        **kw):
    """``train_on_frame`` with a checkpointer (save_every=2): per-step
    losses; ``crash_after`` raises from ``on_step`` after that step, as a
    preemption between steps would."""
    losses = []

    def on_step(i, loss):
        losses.append((i, float(loss)))
        if i == crash_after:
            raise _Crash(f"preempted after step {i}")

    ck = (jCheckpointer(ckdir, backend="npz") if pkg == "jax" else tCheckpointer(ckdir))
    train = jtraining.train_on_frame if pkg == "jax" else ttraining.train_on_frame
    try:
        train(step_fn, state, frame, ["tokens", "targets"], batch_size=4, num_steps=num_steps,
              checkpointer=ck, save_every=2, seed=2, on_step=on_step, **kw)
    except _Crash:
        pass
    return losses, ck


def test_train_on_frame_crashed_and_resumed_matches_jax(tmp_path):
    """gpt_tiny off a frame with a checkpointer, crashed by an exception
    after step 3 and resumed to step 6: the emergency checkpoint lands at
    3, the resume runs steps 4-6, and every step's loss is within rtol
    1e-5 of the JAX package's same run. The resumed port run also equals
    an uninterrupted port run bit for bit."""
    jf, tf = _frames()
    cj, ct = jgen.gpt_tiny(attention_impl="flash"), tgen.gpt_tiny(attention_impl="flash")
    pj = jtr.init_params(cj, seed=6)
    tx = optax.adamw(LR)
    jstep = jax.jit(jtr.make_train_step(cj, tx))

    def jfn(state, batch):
        p, s, loss = jstep(*state, batch["tokens"], batch["targets"])
        return (p, s), loss

    want = []
    for crash in (3, None):
        got, jck = _gpt_tiny_frame_run("jax", cj, (pj, tx.init(pj)), jfn, jf,
                                       str(tmp_path / "j"), 6, crash_after=crash)
        want += got
    assert jck.all_steps() == [2, 3, 4, 6]

    def port_state():
        pt = _carry(pj)
        opt = ttr.adamw(pt, LR)
        step = ttr.make_train_step(ct, opt)

        def fn(state, batch):
            _, _, loss = step(state[0], state[1].state, batch["tokens"], batch["targets"])
            return state, loss

        return (pt, opt), fn

    got = []
    for crash in (3, None):
        state, fn = port_state()  # a fresh process: fresh weights, empty AdamW state
        losses, tck = _gpt_tiny_frame_run("port", ct, state, fn, tf, str(tmp_path / "t"), 6,
                                          crash_after=crash, device=CPU)
        got += losses
    assert tck.all_steps() == [2, 3, 4, 6]
    assert [i for i, _ in got] == [i for i, _ in want] == [1, 2, 3, 4, 5, 6]
    np.testing.assert_allclose([l for _, l in got], [l for _, l in want], rtol=1e-5)
    whole, fn = port_state()
    _, wck = _gpt_tiny_frame_run("port", ct, whole, fn, tf, str(tmp_path / "w"), 6, device=CPU)
    a, b = tck.restore(step=6), wck.restore(step=6)
    assert list(a) == list(b) and all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("prefetch", [0, 2])
def test_train_on_frame_resumes_past_corrupted_newest(tmp_path, prefetch):
    """The host-side replay skip goes to the step that restores (the
    intact one), not to the torn newest."""
    frame = tft.frame_from_arrays({"x": np.arange(64, dtype=np.float32).reshape(16, 4)})

    def step(state, batch):
        new = {"w": state["w"] * 1.01 + batch["x"].sum()}
        return new, {"loss": new["w"].sum()}

    init = {"w": torch.zeros((), dtype=torch.float32)}
    ck = tCheckpointer(str(tmp_path / "run"))
    ttraining.train_on_frame(step, init, frame, ["x"], batch_size=4, num_steps=3,
                             checkpointer=ck, save_every=1, shuffle=False, prefetch=prefetch,
                             device=CPU)
    payload = tmp_path / "run" / "step_3" / "arrays.npz"
    payload.write_bytes(payload.read_bytes()[:10])
    got, ran = ttraining.train_on_frame(step, init, frame, ["x"], batch_size=4, num_steps=4,
                                        checkpointer=ck, save_every=1, shuffle=False,
                                        prefetch=prefetch, device=CPU)
    assert ran == 2
    ref, _ = ttraining.train_on_frame(step, init, frame, ["x"], batch_size=4, num_steps=4,
                                      checkpointer=tCheckpointer(str(tmp_path / "ref")),
                                      save_every=100, shuffle=False, prefetch=prefetch,
                                      device=CPU)
    assert torch.equal(got["w"], ref["w"])


def test_train_on_frame_with_checkpointer_guard_and_telemetry(tmp_path):
    """The three options the port's train_on_frame now takes at once: a
    run relaunched at step 7 runs 5 more, with the guard seeded from the
    restore and one telemetry row per step (global step numbers)."""
    frame = tft.frame_from_arrays(
        {"x": np.random.default_rng(0).standard_normal((64, 4)).astype(np.float32)})
    w0 = {"w": torch.zeros(4)}

    def step(state, batch):
        w = state["w"].clone().requires_grad_(True)
        loss = ((batch["x"] @ w - 1.0) ** 2).mean()
        (g,) = torch.autograd.grad(loss, [w])
        return {"w": (w - 0.1 * g).detach()}, loss.detach()

    ck = tCheckpointer(str(tmp_path / "ck"))
    log = tmp_path / "steps.jsonl"
    with tStepTelemetry(jsonl_path=str(log)) as tel:
        _, ran1 = ttraining.train_on_frame(step, w0, frame, ["x"], batch_size=16, num_steps=7,
                                           checkpointer=ck, save_every=5, shuffle=False,
                                           guard="skip", telemetry=tel, device=CPU)
        _, ran2 = ttraining.train_on_frame(step, w0, frame, ["x"], batch_size=16, num_steps=12,
                                           checkpointer=ck, save_every=5, shuffle=False,
                                           guard="rollback", telemetry=tel, device=CPU)
    assert (ran1, ran2) == (7, 5) and ck.all_steps() == [5, 7, 10, 12]
    rows = [json.loads(x) for x in log.read_text().splitlines()]
    assert [r["step"] for r in rows] == list(range(1, 13))
    assert all(r["rows_per_sec"] > 0 and np.isfinite(r["loss"]) for r in rows)
    assert tel.rows_per_step == 16


def test_train_on_frame_logreg_converges():
    """The reference's logreg case: frame columns → minibatch stream →
    a step over Adam(1e-2); 30 steps cut the loss by at least 10%."""
    from tensorframes_tpu_torch.models import logreg

    x, y = logreg.make_synthetic_mnist(512, seed=0)
    frame = tft.frame_from_arrays({"features": x, "label_true": y})
    params = logreg.init_params(seed=0, device=CPU)
    for leaf in params.values():
        leaf.requires_grad_(True)
    opt = torch.optim.Adam(list(params.values()), lr=1e-2)

    def loss_fn(p, batch):
        logp = torch.log_softmax(batch["features"] @ p["w"] + p["b"], dim=-1)
        return -logp.gather(-1, batch["label_true"][:, None]).mean()

    step = ttraining.make_grad_accum_step(loss_fn, opt, 1)

    def step_fn(state, batch):
        p, s, loss = step(state[0], state[1], batch)
        return (p, s), loss

    losses = []
    _, ran = ttraining.train_on_frame(step_fn, (params, opt.state), frame,
                                      ["features", "label_true"], batch_size=128, num_steps=30,
                                      on_step=lambda i, l: losses.append(float(l)), device=CPU)
    assert ran == 30
    assert losses[-1] < losses[0] * 0.9, (losses[0], losses[-1])


def test_grad_accum_matches_jax_linear_sgd():
    """The reference's linear model under SGD: make_grad_accum_step with 1
    and 4 microbatches against the JAX package's, loss and parameters
    within rtol 1e-5, and 4 microbatches against 1."""
    rng = np.random.default_rng(0)
    w0 = rng.standard_normal(4).astype(np.float32)
    x = rng.standard_normal((8, 4)).astype(np.float32)
    y = rng.standard_normal(8).astype(np.float32)

    def jloss(params, batch):
        bx, by = batch
        return jnp.mean((bx @ params["w"] - by) ** 2)

    def tloss(params, batch):
        bx, by = batch
        return torch.mean((bx @ params["w"] - by) ** 2)

    got = {}
    for accum in (1, 4):
        tx = optax.sgd(0.1)
        jw = {"w": jnp.asarray(w0)}
        pj, _, lj = jtraining.make_grad_accum_step(jloss, tx, accum)(
            jw, tx.init(jw), (jnp.asarray(x), jnp.asarray(y)))
        pt = {"w": torch.from_numpy(w0.copy()).requires_grad_(True)}
        opt = torch.optim.SGD([pt["w"]], lr=0.1)
        out, st, lt = ttraining.make_grad_accum_step(tloss, opt, accum)(
            pt, opt.state, (torch.from_numpy(x), torch.from_numpy(y)))
        assert out is pt and st is opt.state and lt.dtype == torch.float32
        np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5)
        np.testing.assert_allclose(pt["w"].detach().numpy(), np.asarray(pj["w"]), rtol=1e-5)
        got[accum] = (float(lt), pt["w"].detach().clone())
    np.testing.assert_allclose(got[4][0], got[1][0], rtol=1e-6)
    np.testing.assert_allclose(got[4][1].numpy(), got[1][1].numpy(), rtol=1e-5, atol=1e-6)


def test_grad_accum_gpt_tiny_adamw_matches_jax():
    """make_grad_accum_step(accum_steps=2) over the port's AdamW on
    gpt_tiny against the JAX package's over optax.adamw: the loss rtol
    1e-5, the parameters as the train step's (rtol 1e-5, atol 0.05·lr)."""
    cj, ct = jgen.gpt_tiny(attention_impl="flash"), tgen.gpt_tiny(attention_impl="flash")
    pj = jtr.init_params(cj, seed=3)
    toks, tg = jtr.synthetic_batch(cj, 4, 16, seed=3)
    tx = optax.adamw(LR)
    jstep = jtraining.make_grad_accum_step(
        lambda p, b: jtr.loss_fn(cj, p, b[0], b[1]), tx, 2)
    pj2, _, lj = jstep(pj, tx.init(pj), (jnp.asarray(toks), jnp.asarray(tg)))
    pt = _carry(pj)
    opt = ttr.adamw(pt, LR)
    tstep = ttraining.make_grad_accum_step(lambda p, b: ttr.loss_fn(ct, p, b[0], b[1]), opt, 2)
    _, _, lt = tstep(pt, opt.state, (torch.from_numpy(toks), torch.from_numpy(tg)))
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5)
    _leaves_close(pt, pj2, 1e-5, 5e-2 * LR)


def test_grad_accum_validates_and_float64_loss():
    with pytest.raises(ValueError, match="accum_steps"):
        ttraining.make_grad_accum_step(lambda p, b: 0.0, torch.optim.SGD([torch.zeros(1)], 0.1), 0)
    w = {"w": torch.ones(2, requires_grad=True)}
    step = ttraining.make_grad_accum_step(lambda p, b: b[0].mean() * p["w"].sum(),
                                          torch.optim.SGD([w["w"]], 0.1), 3)
    with pytest.raises(ValueError, match="not divisible"):
        step(w, None, (torch.ones(8, 2),))
    w64 = {"w": torch.ones(3, dtype=torch.float64, requires_grad=True)}
    step = ttraining.make_grad_accum_step(lambda p, b: ((b[0] @ p["w"]) ** 2).mean(),
                                          torch.optim.SGD([w64["w"]], 0.01), 2)
    _, _, loss = step(w64, None, (torch.ones(4, 3, dtype=torch.float64),))
    assert loss.dtype == torch.float32 and np.isfinite(float(loss))


def test_mixed_precision_step_keeps_f32_masters():
    """compute_dtype='bfloat16': the loss sees bf16 parameters, the
    gradients land in f32 on the f32 masters, the step follows the f32
    one to bf16 tolerance (rtol 5e-2 loss, 0.1 / 5e-3 parameters, the
    reference's), and ten steps train."""
    rng = np.random.default_rng(1)
    w0 = rng.standard_normal(8).astype(np.float32)
    x = torch.from_numpy(rng.standard_normal((16, 8)).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal(16).astype(np.float32))
    seen = []

    def loss_fn(params, batch):
        bx, by = batch
        seen.append(params["w"].dtype)
        return ((bx.to(params["w"].dtype) @ params["w"]).float() - by).pow(2).mean()

    def run(dtype):
        p = {"w": torch.from_numpy(w0.copy()).requires_grad_(True)}
        opt = torch.optim.SGD([p["w"]], lr=0.05)
        return p, opt, ttraining.make_grad_accum_step(loss_fn, opt, 2, compute_dtype=dtype)

    p32, _, s32 = run(None)
    _, _, l32 = s32(p32, None, (x, y))
    seen.clear()
    pmp, opt, smp = run("bfloat16")
    _, _, lmp = smp(pmp, None, (x, y))
    assert torch.bfloat16 in seen and pmp["w"].dtype == torch.float32
    assert pmp["w"].grad.dtype == torch.float32
    np.testing.assert_allclose(float(lmp), float(l32), rtol=5e-2)
    np.testing.assert_allclose(pmp["w"].detach().numpy(), p32["w"].detach().numpy(), rtol=0.1,
                               atol=5e-3)
    losses = [float(smp(pmp, None, (x, y))[2]) for _ in range(10)]
    assert losses[-1] < losses[0] * 0.7, losses


def test_cast_float_leaves():
    tree = {"a": torch.ones(2), "b": [torch.arange(3), torch.zeros(1, dtype=torch.float64)],
            "c": 1.5}
    out = ttraining.cast_float_leaves(tree, "bfloat16")
    assert out["a"].dtype == out["b"][1].dtype == torch.bfloat16
    assert out["b"][0].dtype == torch.int64 and out["c"] == 1.5
    assert ttraining.cast_float_leaves(tree, torch.float16)["a"].dtype == torch.float16
