"""The model half of the decode server: the JAX package's transformer and
generation functions against the port's on the CPU, with the reference's
weights carried across by ``params_from_jax`` and inputs from numpy
seeds.

Tolerances, per op:
- ``params_from_jax``: exact, int8 values and scales of quantized leaves
  included.
- f32 (``gpt_tiny``): the paged pool's int8 K/V exact; its f32 scales
  rtol 2e-6 (the K/V feeding them differ in the last f32 bits, from
  another matmul summation order); hidden states and logits rtol 1e-4 /
  atol 1e-5·max|ref|; greedy tokens exact, each step's top-2 logit gap
  first asserted to exceed 1e-4 so that a failure names a divergence,
  not a tie.
- bf16 (2 layers, 768 wide): XLA and PyTorch round bf16 at other places
  (layer norm, GELU, the bf16 matmul outputs), so a K/V value may sit one
  bf16 step apart before quantization: int8 K/V within 2 and equal for
  >= 90% of the written entries (~93% measured), scales within 2^-6
  relative, logits within 2e-2·max|ref|, the greedy tokens equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensorframes_tpu_torch as tft
from tensorframes_tpu.models import generation as jgen
from tensorframes_tpu.models import transformer as jtr
from tensorframes_tpu.ops import attention as jatt
from tensorframes_tpu.ops import quantize as jq
from tensorframes_tpu_torch.models import generation as tgen
from tensorframes_tpu_torch.models import transformer as ttr
from tensorframes_tpu_torch.ops import attention as tatt
from tensorframes_tpu_torch.ops import quantize as tq

W768 = dict(num_layers=2, vocab_size=1024, max_seq_len=128)
CPU = "cpu"


def _models(name, quant=True):
    if name == "tiny":
        cj, ct = jgen.gpt_tiny(), tgen.gpt_tiny()
    else:
        cj, ct = jgen.gpt_small(**W768), tgen.gpt_small(**W768)
    pj = jtr.init_params(cj, seed=0)
    if quant:
        pj = jtr.quantize_params(pj)
    return cj, ct, pj, ttr.params_from_jax(jax.tree_util.tree_map(np.asarray, pj), CPU)


@pytest.fixture(scope="module")
def tiny():
    return _models("tiny")


def _close(got, want, rtol=1e-4, frac=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=frac * np.abs(want).max())


def test_params_from_jax_round_trip_exact(tiny):
    _, _, pj, pt = tiny
    jleaves = jax.tree_util.tree_leaves(pj, is_leaf=lambda x: isinstance(x, jq.QuantizedTensor))
    tleaves = tq.tree_leaves(pt)
    assert len(jleaves) == len(tleaves)
    for a, b in zip(jleaves, tleaves):
        if isinstance(a, jq.QuantizedTensor):
            assert isinstance(b, tq.QuantizedTensor)
            np.testing.assert_array_equal(b.q.numpy(), np.asarray(a.q))
            np.testing.assert_array_equal(b.scale.numpy(), np.asarray(a.scale))
        else:
            assert b.dtype == torch.float32
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert tq.tree_nbytes(pt) == jq.tree_nbytes(pj)
    # the port's own quantize_params quantizes the same leaves, exactly
    plain = ttr.params_from_jax(jax.tree_util.tree_map(np.asarray, jtr.init_params(
        jgen.gpt_tiny(), seed=0)), CPU)
    requant = ttr.quantize_params(plain)
    for a, b in zip(tq.tree_leaves(requant), tleaves):
        assert type(a) is type(b)
        if isinstance(a, tq.QuantizedTensor):
            assert torch.equal(a.q, b.q) and torch.equal(a.scale, b.scale)
    with pytest.raises(ValueError):
        ttr.params_from_jax({"w": np.zeros(3)}, CPU)


def test_init_params_layout():
    cfg = ttr.tiny()
    p = ttr.init_params(cfg, seed=1, device=CPU)
    pj = jtr.init_params(jtr.tiny(), seed=1)
    shapes = sorted(tuple(x.shape) for x in tq.tree_leaves(p))
    assert shapes == sorted(tuple(x.shape) for x in jax.tree_util.tree_leaves(pj))
    assert torch.equal(ttr.init_params(cfg, seed=1, device=CPU)["embed"]["tok"], p["embed"]["tok"])
    assert abs(float(p["layers"][0]["attn"]["qkv"].std()) - cfg.hidden ** -0.5) < 0.02


@pytest.mark.parametrize("causal", [False, True])
def test_dense_attention_matches_jax(causal):
    rng = np.random.default_rng(2)
    q, k, v = (rng.standard_normal((2, 3, 7, 8)).astype(np.float32) for _ in range(3))
    mask = np.ones((2, 7), bool)
    mask[1, 5:] = False
    want = jatt.dense_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                                padding_mask=jnp.asarray(mask))
    got = tatt.dense_attention(*(torch.from_numpy(a) for a in (q, k, v)), causal=causal,
                               padding_mask=torch.from_numpy(mask))
    _close(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("quant", [False, True])
def test_forward_matches_jax(quant):
    cj, ct = jtr.tiny(dtype=jnp.float32), ttr.tiny(dtype=torch.float32)
    pj = jtr.init_params(cj, seed=3)
    if quant:
        pj = jtr.quantize_params(pj)
    pt = ttr.params_from_jax(jax.tree_util.tree_map(np.asarray, pj), CPU)
    toks = np.random.default_rng(3).integers(0, cj.vocab_size, (2, 9)).astype(np.int32)
    mask = np.ones((2, 9), bool)
    mask[0, 6:] = False
    want = jtr.forward(cj, pj, jnp.asarray(toks), mask=jnp.asarray(mask))
    got = ttr.forward(ct, pt, torch.from_numpy(toks), mask=torch.from_numpy(mask))
    _close(got.numpy(), np.asarray(want))
    # flash attention (the kernel's plain version on the CPU) against the
    # reference's flash path, unpadded
    cj, ct = (dataclasses.replace(c, attention_impl="flash") for c in (cj, ct))
    want = jtr.forward(cj, pj, jnp.asarray(toks))
    _close(ttr.forward(ct, pt, torch.from_numpy(toks)).numpy(), np.asarray(want))


def _gap_ok(logits, tol=1e-4):
    top2 = np.sort(np.asarray(logits, np.float64), axis=-1)[..., -2:]
    return np.all(top2[..., 1] - top2[..., 0] > tol)


def _step_logits(cfg, params, prompt, generated):
    """The port's logits at each generation step, by one cached pass over
    prompt + generated[:-1]."""
    seq = np.concatenate([prompt, generated[:-1]])[None]
    cache = tgen.init_kv_cache(cfg, 1, length=seq.shape[1], quant=True, device=CPU)
    hs, _ = tgen._forward_cached(cfg, params, torch.from_numpy(seq).long(), cache, 0)
    return tgen._logits(cfg, params, hs[0, len(prompt) - 1:]).numpy()


def test_generate_kv_quant_tokens_equal_jax(tiny):
    cj, ct, pj, pt = tiny
    rng = np.random.default_rng(17)
    prompts = rng.integers(0, cj.vocab_size, (3, 9)).astype(np.int32)
    got = tgen.generate(ct, pt, prompts, 10, kv_quant=True)
    assert got.dtype == torch.int32 and tuple(got.shape) == (3, 10)
    for p, g in zip(prompts, got.numpy()):
        assert _gap_ok(_step_logits(ct, pt, p, g)), "a near-tie: pick another seed"
    want = np.asarray(jgen.generate(cj, pj, prompts, 10, kv_quant=True))
    np.testing.assert_array_equal(got.numpy(), want)


def test_generate_dense_cache_and_naive_equal_jax(tiny):
    cj, ct, pj, pt = tiny
    prompts = np.random.default_rng(19).integers(0, cj.vocab_size, (2, 7)).astype(np.int32)
    np.testing.assert_array_equal(tgen.generate(ct, pt, prompts, 6).numpy(),
                                  np.asarray(jgen.generate(cj, pj, prompts, 6)))
    naive = tgen.generate_naive(ct, pt, prompts, 6).numpy()
    np.testing.assert_array_equal(naive, np.asarray(jgen.generate_naive(cj, pj, prompts, 6)))
    np.testing.assert_array_equal(naive, tgen.generate(ct, pt, prompts, 6).numpy())
    with pytest.raises(ValueError):
        tgen.generate(ct, pt, prompts, 0)
    with pytest.raises(ValueError):
        tgen.generate(ct, pt, prompts, 60)


def test_generate_sampling_is_seeded(tiny):
    _, ct, _, pt = tiny
    prompts = np.random.default_rng(23).integers(0, ct.vocab_size, (2, 5)).astype(np.int32)
    a = tgen.generate(ct, pt, prompts, 6, temperature=1.0, seed=4)
    b = tgen.generate(ct, pt, prompts, 6, temperature=1.0, seed=4)
    assert torch.equal(a, b) and int(a.min()) >= 0 and int(a.max()) < ct.vocab_size


def test_generate_program_through_map_blocks(tiny):
    cj, ct, pj, pt = tiny
    prompts = np.random.default_rng(29).integers(0, cj.vocab_size, (6, 8)).astype(np.int32)
    df = tft.frame_from_arrays({"prompts": prompts}, num_blocks=2)
    out = tft.map_blocks(tgen.generate_program(ct, pt, 5, kv_quant=True), df, device="cpu")
    got = out.column_values("generated")
    assert got.dtype == np.int32 and got.shape == (6, 5)
    np.testing.assert_array_equal(got, np.asarray(jgen.generate(cj, pj, prompts, 5,
                                                                kv_quant=True)))


@pytest.mark.parametrize("name", ["tiny", "w768"])
def test_paged_prefill_and_decode_step_match_jax(name):
    cj, ct, pj, pt = _models(name)
    page = 8 if name == "tiny" else 16
    rng = np.random.default_rng(5)
    L, T, maxp = 11, 16, 3
    toks = np.zeros(T, np.int32)
    toks[:L] = rng.integers(0, cj.vocab_size, L)
    table = np.array([3, 5, 0], np.int32)
    poolj, fj = jgen.paged_prefill_fn(cj, page, maxp)(
        pj, jgen.init_paged_kv(cj, 8, page), jnp.asarray(toks), jnp.int32(L), jnp.asarray(table))
    poolt = tgen.init_paged_kv(ct, 8, page, CPU)
    poolt2, ft = tgen.paged_prefill_fn(ct, page, maxp)(pt, poolt, toks, L, table)
    assert poolt2 is poolt  # updated in place
    assert int(ft) == int(fj)
    pages = [3, 5] if name == "tiny" else [3]
    for k in ("k", "v", "k_scale", "v_scale"):
        a = np.asarray(poolj[k])[pages].astype(np.float64)
        b = poolt[k].numpy()[pages].astype(np.float64)
        if k in ("k", "v") and name == "tiny":
            np.testing.assert_array_equal(b, a)
        elif k in ("k", "v"):
            a, b = a[..., :L, :], b[..., :L, :]
            assert np.abs(a - b).max() <= 2 and np.mean(a != b) < 0.1
        else:
            np.testing.assert_allclose(b, a, rtol=2e-6 if name == "tiny" else 2.0 ** -6)
    # one decode step (plus a padding slot): its logits against the JAX
    # dense int8 cache at the same position (the paged formulation's oracle)
    cache = jgen.init_kv_cache(cj, 1, length=T + 8, quant=True)
    _, cache = jgen._forward_cached(cj, pj, jnp.asarray(toks[None, :L]), cache, 0)
    hs, _ = jgen._forward_cached(cj, pj, jnp.asarray([[int(fj)]]), cache, L)
    want = np.asarray(jgen._logits(cj, pj, hs[:, -1]))[0]
    tabs = np.stack([table, np.zeros(3, np.int32)])
    _, nxt, logits = tgen.paged_decode_step_fn(ct, page, maxp)(
        pt, poolt, np.array([int(ft), 0], np.int32), np.array([L, 0], np.int32), tabs,
        return_logits=True)
    got = logits[0].numpy()
    if name == "tiny":
        _close(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=2e-2 * np.abs(want).max())
    assert _gap_ok(want, 2e-2 * np.abs(want).max() if name != "tiny" else 1e-4)
    assert int(nxt[0]) == int(want.argmax())
    _, nj = jgen.paged_decode_step_fn(cj, page, maxp)(
        pj, poolj, jnp.asarray([int(fj), 0], jnp.int32), jnp.asarray([L, 0], jnp.int32),
        jnp.asarray(tabs))
    assert int(nxt[0]) == int(np.asarray(nj)[0])


def test_decode_step_plain_path_equals_kernel_path_on_cpu(tiny):
    """On CPU tensors the step's kernel wrappers compute their plain
    versions; the explicit plain path (int8 plain matmul) agrees to f32
    rounding and picks the same tokens."""
    _, ct, _, pt = tiny
    pool = tgen.init_paged_kv(ct, 6, 8, CPU)
    pre = tgen.paged_prefill_fn(ct, 8, 3)
    toks = np.random.default_rng(31).integers(0, ct.vocab_size, 16).astype(np.int32)
    _, first = pre(pt, pool, toks, 13, np.array([1, 2, 0], np.int32))
    args = (np.array([int(first)], np.int32), np.array([13], np.int32),
            np.array([[1, 2, 0]], np.int32))
    snap = {k: v.clone() for k, v in pool.items()}
    _, a, la = tgen.paged_decode_step_fn(ct, 8, 3, logits_rows=8)(pt, pool, *args,
                                                                  return_logits=True)
    _, b, lb = tgen.paged_decode_step_fn(ct, 8, 3, plain=True)(pt, snap, *args,
                                                               return_logits=True)
    assert torch.equal(a, b) and la.shape == (1, ct.vocab_size)
    _close(la.numpy(), lb.numpy())


def test_paged_pool_layout_and_nbytes_match_jax(tiny):
    cj, ct, _, _ = tiny
    pj, pt = jgen.init_paged_kv(cj, 5, 8), tgen.init_paged_kv(ct, 5, 8, CPU)
    for k in pj:
        assert tuple(pt[k].shape) == tuple(pj[k].shape)
        np.testing.assert_array_equal(pt[k].numpy(), np.asarray(pj[k]))
    assert tgen.paged_kv_nbytes(pt) == jgen.paged_kv_nbytes(pj)
    with pytest.raises(ValueError):
        tgen.init_paged_kv(ct, 1, 8, CPU)
    with pytest.raises(ValueError):
        tgen.init_paged_kv(ct, 4, 0, CPU)


@pytest.mark.parametrize("entry", [
    "init_params", "params_from_jax", "init_kv_cache", "init_paged_kv", "PagedKVPool",
    "logreg.init_params", "logreg.params_from_jax",
])
def test_model_entry_points_default_to_the_configured_device(entry, monkeypatch):
    """Every model-layer entry point puts its tensors on ``config.device``
    when the caller names no device, and so raises with no GPU visible
    (never a silent CPU); an explicit ``device="cpu"`` runs."""
    from tensorframes_tpu_torch.models import logreg as tlogreg
    from tensorframes_tpu_torch.serving import PagedKVPool

    cfg = tgen.gpt_tiny()
    logreg_np = {"w": np.zeros((784, 10), np.float32), "b": np.zeros(10, np.float32)}
    calls = {
        "init_params": lambda **kw: ttr.init_params(cfg, **kw)["embed"]["tok"],
        "params_from_jax": lambda **kw: ttr.params_from_jax({"w": np.ones(3, np.float32)},
                                                            **kw)["w"],
        "init_kv_cache": lambda **kw: tgen.init_kv_cache(cfg, 1, 8, quant=True, **kw)["k"],
        "init_paged_kv": lambda **kw: tgen.init_paged_kv(cfg, 4, 8, **kw)["k"],
        "PagedKVPool": lambda **kw: PagedKVPool(cfg, 5, 8, 3, **kw).columns["k"],
        "logreg.init_params": lambda **kw: tlogreg.init_params(**kw)["w"],
        "logreg.params_from_jax": lambda **kw: tlogreg.params_from_jax(logreg_np, **kw)["w"],
    }
    assert calls[entry](device=CPU).device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tft.get_config().device == "cuda"
    with pytest.raises(RuntimeError, match="is_available"):
        calls[entry]()
