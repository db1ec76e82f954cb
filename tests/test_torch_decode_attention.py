"""Paged int8-KV decode attention: the JAX package's Pallas kernel (run in
interpret mode, as its own tests run it) and its XLA reference chain
against the port's plain version on the CPU, inputs from numpy seeds.

Tolerance: in f32 the two sides differ in the order of the f32 sums and
in exp's last bits: rtol 1e-5 / atol 1e-5·max|ref|. In bf16 a weight or an output
may round to the neighbouring bf16 value: 2^-7 relative plus
1e-3·max|ref|.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorframes_tpu.kernels import decode_attention as jda
from tensorframes_tpu_torch.kernels import decode_attention as tda


def _inputs(S, maxp, page, nh, hd, seed):
    rng = np.random.default_rng(seed)
    P, L = maxp * S + 1, 2
    q = rng.standard_normal((S, nh, hd)).astype(np.float32)
    kp = rng.integers(-127, 128, (P, L, nh, page, hd)).astype(np.int8)
    vp = rng.integers(-127, 128, (P, L, nh, page, hd)).astype(np.int8)
    ks = rng.uniform(0.01, 0.1, (P, L, nh, page, 1)).astype(np.float32)
    vs = rng.uniform(0.01, 0.1, (P, L, nh, page, 1)).astype(np.float32)
    tables = rng.integers(1, P, (S, maxp)).astype(np.int32)
    tables[-1] = 0  # padding slot: all-null table
    pos = rng.integers(0, maxp * page, S).astype(np.int32)
    pos[-1] = 0
    return q, kp, vp, ks, vs, tables, pos


def _close(got, want, dtype):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    else:
        tol = 2.0 ** -7 * np.abs(want) + 1e-3 * np.abs(want).max()
        assert np.all(np.abs(got - want) <= tol), np.abs(got - want).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,maxp,page,nh,hd", [
    (1, 1, 4, 2, 8), (5, 3, 8, 4, 16), (8, 2, 16, 2, 4), (3, 4, 16, 12, 64), (16, 2, 4, 3, 8),
])
def test_plain_version_matches_interpreted_kernel(dtype, S, maxp, page, nh, hd):
    q, kp, vp, ks, vs, tables, pos = _inputs(S, maxp, page, nh, hd, S * 7 + maxp)
    jargs = [jnp.asarray(a) for a in (kp, vp, ks, vs)]
    targs = [torch.from_numpy(a) for a in (kp, vp, ks, vs)]
    jq_ = jnp.asarray(q, getattr(jnp, dtype))
    tq_ = torch.from_numpy(q).to(getattr(torch, dtype))
    for li in range(2):
        want = jda.paged_decode_attention(jq_, *jargs, li, jnp.asarray(tables), jnp.asarray(pos),
                                          interpret=True)
        ref = jda.paged_attention_reference(jq_, *jargs, li, jnp.asarray(tables),
                                            jnp.asarray(pos))
        got = tda.paged_attention_reference(tq_, *targs, li, torch.from_numpy(tables),
                                            torch.from_numpy(pos))
        # on CPU tensors the kernel's wrapper computes the plain version
        wrapped = tda.paged_decode_attention(tq_, *targs, li, torch.from_numpy(tables),
                                             torch.from_numpy(pos))
        assert torch.equal(wrapped, got)
        assert got.dtype == tq_.dtype and tuple(got.shape) == tuple(want.shape)
        _close(got.float().numpy(), np.asarray(want.astype(jnp.float32)), dtype)
        _close(got.float().numpy(), np.asarray(ref.astype(jnp.float32)), dtype)


def test_masked_positions_and_null_page_never_reach_the_output():
    """Garbage (huge values) in the null page and past ``pos`` changes
    nothing for a real slot."""
    q, kp, vp, ks, vs, tables, pos = _inputs(4, 3, 8, 2, 16, 5)
    tables = np.arange(1, 13, dtype=np.int32).reshape(4, 3)  # no page shared
    tables[:, -1] = 0
    pos[:3] = [3, 10, 15]
    args = [torch.from_numpy(a) for a in (kp, vp, ks, vs)]
    before = tda.paged_attention_reference(torch.from_numpy(q), *args, 0,
                                           torch.from_numpy(tables), torch.from_numpy(pos))
    ks2, vs2 = ks.copy(), vs.copy()
    ks2[0], vs2[0] = 1e6, 1e6
    for s in range(3):
        for j in range(pos[s] + 1, 3 * 8):
            pg = tables[s, j // 8]
            if pg:
                ks2[pg, 0, :, j % 8], vs2[pg, 0, :, j % 8] = 1e6, 1e6
    args2 = [torch.from_numpy(a) for a in (kp, vp, ks2, vs2)]
    after = tda.paged_attention_reference(torch.from_numpy(q), *args2, 0,
                                          torch.from_numpy(tables), torch.from_numpy(pos))
    assert torch.equal(before[:3], after[:3])
