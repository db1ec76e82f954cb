"""The encoder's inference path — ``forward`` with blockwise and flash
attention, and BERT-style embeddings through ``map_rows``/``map_blocks``
— against the JAX package on the CPU, with the reference's weights
carried across by ``params_from_jax`` and tokens from its own numpy draw.

Tolerances, per op:
- ``synthetic_batch``: exact (the same numpy draw).
- f32 (``tiny``): hidden states and embeddings rtol 1e-4 / atol
  1e-5·max|want| (the two sides sum in other orders; with flash the
  scale is applied to the product, in blockwise to q).
- bf16 (2 layers, 768 wide): XLA and PyTorch round bf16 at other places
  (layer norm, GELU, the bf16 matmul outputs; flash also rounds p before
  P·V), so hidden states agree within 2e-2·max|want| (~0.8% measured).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensorframes_tpu as jt
import tensorframes_tpu_torch as tft
from tensorframes_tpu.models import transformer as jtr
from tensorframes_tpu_torch.kernels import flash_attention as kfa
from tensorframes_tpu_torch.models import transformer as ttr

W768 = dict(num_layers=2, vocab_size=1024, max_seq_len=128)
CPU = "cpu"


def _close(got, want, rtol=1e-4, frac=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=frac * np.abs(want).max())


def _carry(pj):
    return ttr.params_from_jax(jax.tree_util.tree_map(np.asarray, pj), CPU)


@pytest.fixture(scope="module")
def w768():
    pj = jtr.init_params(jtr.TransformerConfig(**W768), seed=0)
    return pj, _carry(pj)


@pytest.mark.parametrize("batch,seq,seed", [(4, 16, 0), (1024, 128, 0), (3, 7, 5)])
def test_synthetic_batch_is_exact(batch, seq, seed):
    for a, b in zip(jtr.synthetic_batch(jtr.bert_base(), batch, seq, seed),
                    ttr.synthetic_batch(ttr.bert_base(), batch, seq, seed)):
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("impl", ["blockwise", "flash"])
def test_forward_matches_jax_tiny_f32(impl):
    cj = jtr.tiny(dtype=jnp.float32, attention_impl=impl)
    ct = ttr.tiny(dtype=torch.float32, attention_impl=impl)
    pj = jtr.init_params(cj, seed=3)
    toks = np.random.default_rng(3).integers(0, cj.vocab_size, (2, 13)).astype(np.int32)
    got = ttr.forward(ct, _carry(pj), torch.from_numpy(toks))
    _close(got.numpy(), np.asarray(jtr.forward(cj, pj, jnp.asarray(toks))))


@pytest.mark.parametrize("impl", ["blockwise", "flash"])
def test_forward_matches_jax_768_wide_bf16(w768, impl):
    pj, pt = w768
    toks = jtr.synthetic_batch(jtr.TransformerConfig(**W768), 2, 64, seed=1)[0]
    want = jtr.forward(jtr.TransformerConfig(attention_impl=impl, **W768), pj, jnp.asarray(toks))
    cfg = ttr.TransformerConfig(attention_impl=impl, **W768)
    got = ttr.forward(cfg, pt, torch.from_numpy(toks))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (2, 64, 768)
    want = np.asarray(want.astype(jnp.float32), np.float64)
    diff = np.abs(got.float().numpy() - want).max()
    assert diff <= 2e-2 * np.abs(want).max(), diff


@pytest.mark.parametrize("impl,err,match", [
    ("blockwise", NotImplementedError, "padding mask"),
    ("flash", NotImplementedError, "padding mask"),
    ("ring", ValueError, "requires a mesh with an 'sp' axis"),
    ("ulysses", ValueError, "requires a mesh with an 'sp' axis"),
    ("sparse", ValueError, "Unknown attention_impl"),
])
def test_attention_impl_errors(impl, err, match):
    """A padding mask needs dense attention (as the reference); sequence
    parallelism needs a mesh with an 'sp' axis (as the reference); an
    unknown impl is refused."""
    cfg = ttr.tiny(dtype=torch.float32, attention_impl=impl)
    params = ttr.init_params(cfg, seed=0, device=CPU)
    toks = torch.zeros((2, 5), dtype=torch.long)
    mask = torch.ones((2, 5), dtype=torch.bool) if impl in ("blockwise", "flash") else None
    with pytest.raises(err, match=match):
        ttr.forward(cfg, params, toks, mask=mask)


def _frames(cj, n, s, seed=0):
    toks = jtr.synthetic_batch(cj, n, s, seed)[0]
    return (jt.frame_from_arrays({"tokens": toks}, num_blocks=1),
            tft.frame_from_arrays({"tokens": toks}, num_blocks=1))


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("verb", ["map_rows", "map_blocks"])
def test_embed_programs_match_jax_verbs(verb, quant):
    """BASELINE config 5 at ``tiny``: ``embed_row_program`` through
    ``map_rows`` (compiled with ``block=False``, as the reference's bench)
    and ``embed_program`` through ``map_blocks``, flash attention, plain
    and int8 weights, against the JAX package's verbs."""
    cj = jtr.tiny(dtype=jnp.float32, attention_impl="flash")
    ct = ttr.tiny(dtype=torch.float32, attention_impl="flash")
    pj = jtr.init_params(cj, seed=0)
    if quant:
        pj = jtr.quantize_params(pj)
    pt = _carry(pj)
    fj, ft = _frames(cj, 6, 16)
    if verb == "map_rows":
        jprog = jtr.embed_row_program(cj, pj)
        want = jt.map_rows(jt.compile_program(lambda tokens: jprog(tokens), fj, block=False), fj)
        got = tft.map_rows(tft.compile_program(ttr.embed_row_program(ct, pt), ft, block=False,
                                               device=CPU), ft, device=CPU)
    else:
        want = jt.map_blocks(jtr.embed_program(cj, pj), fj)
        got = tft.map_blocks(ttr.embed_program(ct, pt), ft, device=CPU)
    got, want = got.column_values("embedding"), want.column_values("embedding")
    assert got.dtype == np.float32 and got.shape == (6, 32)
    np.testing.assert_array_equal(got.shape, want.shape)
    _close(got, want)


def test_verbs_call_flash_once_per_layer(monkeypatch):
    """Both verbs run the encoder as one batch per block: the flash op is
    called once per layer with every row of the block, ``map_rows``
    through its vmap rule; the two verbs' embeddings are equal."""
    ct = ttr.tiny(dtype=torch.float32, attention_impl="flash")
    params = ttr.init_params(ct, seed=0, device=CPU)
    _, ft = _frames(jtr.tiny(), 8, 16)
    calls = []
    plain = kfa.flash_attention_reference

    def counted(q, *a):
        calls.append(tuple(q.shape))
        return plain(q, *a)

    monkeypatch.setattr(kfa, "flash_attention_reference", counted)
    rows = tft.map_rows(tft.compile_program(ttr.embed_row_program(ct, params), ft, block=False,
                                            device=CPU), ft, device=CPU)
    rows = rows.column_values("embedding")
    assert calls == [(8, ct.num_heads, 16, ct.head_dim)] * ct.num_layers
    calls.clear()
    blocks = tft.map_blocks(ttr.embed_program(ct, params), ft, device=CPU)
    blocks = blocks.column_values("embedding")
    assert calls == [(8, ct.num_heads, 16, ct.head_dim)] * ct.num_layers
    np.testing.assert_array_equal(rows, blocks)
