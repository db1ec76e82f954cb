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
from tensorframes_tpu_torch import io as tio
from tensorframes_tpu_torch import training as ttraining
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


@pytest.mark.parametrize("arg", ["checkpointer", "guard", "telemetry"])
def test_train_on_frame_unported_options_raise(arg):
    _, tf = _frames()
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1"):
        ttraining.train_on_frame(lambda s, b: (s, 0.0), None, tf, ["w"], batch_size=2,
                                 num_steps=1, device=CPU, **{arg: object()})


def test_cast_float_leaves():
    tree = {"a": torch.ones(2), "b": [torch.arange(3), torch.zeros(1, dtype=torch.float64)],
            "c": 1.5}
    out = ttraining.cast_float_leaves(tree, "bfloat16")
    assert out["a"].dtype == out["b"][1].dtype == torch.bfloat16
    assert out["b"][0].dtype == torch.int64 and out["c"] == 1.5
    assert ttraining.cast_float_leaves(tree, torch.float16)["a"].dtype == torch.float16
