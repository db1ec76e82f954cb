"""The flash backward's gate on the CPU: the term E that the f32 summation
order of dP = dO·vᵀ adds to the gap between a backward kernel and its
plain version (``kfa.flash_attention_bwd_order_bound``), shown on a plain
backward that sums dP in another fixed f32 order; and the one rule that
chooses between the tensor-core and the scalar backward kernels.

The gate, as ``chip_smoke.py`` and the on-card tests apply it, is
|got − ref| ≤ rtol·(|ref| + A) + E with rtol 2^-6 in bf16, A the
backward's sums over absolute values (``kfa.flash_attention_bwd_bound``).
A reordered dP, a legitimate change, must stay within A + E everywhere,
and must fall outside A alone where dP − di cancels (the causal first
row, whose o is v's first row); each deliberately broken backward of
``chip_smoke.broken_bwd_versions`` must fall outside A + E by more than
``chip_smoke.BROKEN_BWD_MIN``. Inputs come from numpy seeds.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tensorframes_tpu_torch.kernels import flash_attention as kfa

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

RTOL = chip_smoke.FLASH_BWD_RTOL["bfloat16"]


def _case(shape, sk=None, seed=0, causal=True):
    """bf16 q, k, v, dO from a seed, the plain forward's o, l, m, di."""
    b, h, sq, d = shape
    rng = np.random.default_rng(seed)
    kv = (b, h, sk or sq, d)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(torch.bfloat16)
                   for s in (shape, kv, kv, shape))
    scale = kfa.default_scale(d)
    o, l, m = kfa.flash_attention_fwd_reference(q, k, v, causal, scale)
    return q, k, v, do, o, l, m, kfa.flash_attention_di(o, do), scale


def _split_dp_backward(q, k, v, l, m, do, di, causal, scale):
    """The plain backward with dP summed in another fixed f32 order: the
    two halves of head_dim apart, then added; everything else as
    ``kfa.flash_attention_bwd_*_reference``."""
    h = q.shape[-1] // 2
    p = kfa._p(q, k, l, m, causal, scale)
    dp = (torch.einsum("bhqd,bhkd->bhqk", do[..., :h].float(), v[..., :h].float())
          + torch.einsum("bhqd,bhkd->bhqk", do[..., h:].float(), v[..., h:].float()))
    ds = (dp - di[..., None]) * p * scale
    dq = torch.einsum("bhqk,bhkd->bhqd", ds.to(k.dtype).float(), k.float()).to(q.dtype)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds.to(do.dtype).float(), q.float()).to(k.dtype)
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(do.dtype).float(), do.float()).to(v.dtype)
    return dq, dk, dv


def _plain(q, k, v, l, m, do, di, causal, scale):
    dk, dv = kfa.flash_attention_bwd_dkv_reference(q, k, v, l, m, do, di, causal, scale)
    return kfa.flash_attention_bwd_dq_reference(q, k, v, l, m, do, di, causal, scale), dk, dv


def _shares(got, ref, bound, order=None):
    """Per gradient, |got − ref| / (rtol·(|ref| + A) [+ E]) entrywise, an
    equal entry 0 (also where its tolerance is 0)."""
    out = []
    for i, (g, r, a) in enumerate(zip(got, ref, bound)):
        diff = (g.double() - r.double()).abs()
        tol = RTOL * (r.double().abs() + a.double())
        if order is not None:
            tol = tol + order[i].double()
        out.append(torch.where(diff == 0, 0.0, diff / tol))
    return out


@pytest.mark.parametrize("shape,sk", [
    ((2, 8, 64, 64), None),
    ((2, 8, 77, 64), None),
    ((1, 4, 100, 128), None),
    ((2, 8, 70, 64), 50),
])
def test_reordered_dp_stays_within_a_plus_e_and_leaves_a_alone(shape, sk):
    q, k, v, do, o, l, m, di, scale = _case(shape, sk)
    ref = _plain(q, k, v, l, m, do, di, True, scale)
    got = _split_dp_backward(q, k, v, l, m, do, di, True, scale)
    bound = kfa.flash_attention_bwd_bound(q, k, v, o, l, m, do, True, scale)
    order = kfa.flash_attention_bwd_order_bound(q, k, v, l, m, do, True, scale)
    with_e = _shares(got, ref, bound, order)
    assert max(float(s.max()) for s in with_e) <= 1.0
    # dQ of the causal first row reads dS of key 0 alone, where dP − di cancels
    a_alone = _shares(got, ref, bound)
    assert int((a_alone[0][:, :, 0] > 1.0).sum()) >= 1
    assert float(order[2].abs().max()) == 0.0  # dV reads no dP


@pytest.mark.parametrize("shape,sk,causal", [
    ((2, 8, 64, 64), None, True),
    ((2, 4, 77, 128), None, True),
    ((2, 4, 96, 64), 70, False),
])
def test_broken_versions_fall_outside_a_plus_e(shape, sk, causal):
    q, k, v, do, o, l, m, di, scale = _case(shape, sk, seed=3, causal=causal)
    ref = _plain(q, k, v, l, m, do, di, causal, scale)
    bound = kfa.flash_attention_bwd_bound(q, k, v, o, l, m, do, causal, scale)
    order = kfa.flash_attention_bwd_order_bound(q, k, v, l, m, do, causal, scale)
    broken = chip_smoke.broken_bwd_versions(causal)
    assert len(broken) == (3 if causal else 2)
    for what, fn in broken.items():
        bad = fn(q, k, v, l, m, do, di, causal, scale)
        share = max(float(s.max()) for s in _shares(bad, ref, bound, order))
        assert share > chip_smoke.BROKEN_BWD_MIN, what


def test_order_bound_formula():
    """E at one entry by hand: e = c·γ_d·(|dO|·|v|ᵀ)·p·sm_scale, E_dq = e·|k|."""
    q, k, v, do, o, l, m, di, scale = _case((1, 1, 3, 16))
    e_dq, e_dk, e_dv = kfa.flash_attention_bwd_order_bound(q, k, v, l, m, do, True, scale)
    d, u = 16, 2.0 ** -24
    gamma = d * u / (1 - d * u)
    p = kfa._p(q, k, l, m, True, scale)[0, 0].double()
    e = (kfa.DP_ORDER_C * gamma * (do[0, 0].double().abs() @ v[0, 0].double().abs().T)
         * p * scale)
    np.testing.assert_allclose(e_dq[0, 0].double(), e @ k[0, 0].double().abs(), rtol=1e-6)
    np.testing.assert_allclose(e_dk[0, 0].double(), e.T @ q[0, 0].double().abs(), rtol=1e-6)
    assert e_dv.shape == v.shape and not bool(e_dv.any())
    assert kfa.DP_ORDER_C == 4
    assert float(e_dq[0, 0, 0].min()) > 0  # the first row: key 0 alone, p = 1


def test_order_bound_raises_where_it_does_not_hold():
    q, k, v, do, o, l, m, di, scale = _case((1, 2, 8, 16))
    with pytest.raises(ValueError, match="bfloat16"):
        kfa.flash_attention_bwd_order_bound(q.float(), k.float(), v.float(), l, m, do.float(),
                                            True, scale)
    # s's summation order then moves p by more than A covers
    big = (q.float() * 64).to(torch.bfloat16)
    with pytest.raises(ValueError, match="2\\^-9"):
        kfa.flash_attention_bwd_order_bound(big, big, v, l, m, do, True, scale)


def _views(b, s, h, d, dtype):
    """q/k/v/dO as the training path passes them: views of [b, s, 3, h, d]
    and a [b, s, h, d] → [b, h, s, d] dO."""
    qkv = torch.zeros((b, s, 3, h, d), dtype=dtype)
    do = torch.zeros((b, s, h, d), dtype=dtype).permute(0, 2, 1, 3)
    return (*(qkv[:, :, i].permute(0, 2, 1, 3) for i in range(3)), do)


def _off_by_one(shape, dtype):
    """A contiguous tensor whose data starts one element past a 16-byte
    boundary."""
    return torch.zeros(int(np.prod(shape)) + 1, dtype=dtype)[1:].view(shape)


def _same(shape, dtype=torch.bfloat16):
    return (torch.zeros(shape, dtype=dtype),) * 4


@pytest.mark.parametrize("what,make,build", [
    ("the training path's bf16 views", lambda: _views(2, 1024, 12, 64, torch.bfloat16), "mma"),
    ("the encoder's bf16 views", lambda: _views(4, 128, 12, 64, torch.bfloat16), "mma"),
    ("bf16 head_dim 128", lambda: _same((2, 8, 1000, 128)), "mma"),
    ("bf16 head_dim 80", lambda: _same((2, 6, 333, 80)), "mma"),
    ("bf16 head_dim 8, one row", lambda: _same((1, 2, 1, 8)), "mma"),
    ("bf16 sq != sk", lambda: (torch.zeros((2, 6, 333, 64), dtype=torch.bfloat16),
                               *(torch.zeros((2, 6, 200, 64), dtype=torch.bfloat16),) * 2,
                               torch.zeros((2, 6, 333, 64), dtype=torch.bfloat16)), "mma"),
    ("f32 views", lambda: _views(4, 128, 12, 64, torch.float32), "scalar"),
    ("f32 head_dim 128", lambda: _same((3, 4, 1000, 128), torch.float32), "scalar"),
    ("bf16 head_dim 36", lambda: _same((2, 3, 77, 36)), "scalar"),
    ("bf16 views of a head_dim-36 qkv", lambda: _views(2, 16, 3, 36, torch.bfloat16), "scalar"),
    ("bf16 rows off a 16-byte boundary", lambda: (_off_by_one((2, 3, 77, 64),
                                                              torch.bfloat16),) * 4, "scalar"),
    ("bf16 dO alone off a 16-byte boundary", lambda: (
        *(torch.zeros((2, 3, 77, 64), dtype=torch.bfloat16),) * 3,
        _off_by_one((2, 3, 77, 64), torch.bfloat16)), "scalar"),
    ("bf16 with a sequence stride of 12 elements", lambda: (
        torch.zeros((1, 1, 16, 12), dtype=torch.bfloat16)[..., :8],) * 4, "scalar"),
])
def test_backward_build_chooses_the_kernel(what, make, build):
    """The one rule between the two backward builds: bf16 whose rows of q,
    k, v and dO can be copied 16 bytes at a time takes the tensor cores,
    the rest the scalar kernels (the rule reads dtypes, shapes, strides
    and data pointers, so CPU tensors exercise it)."""
    q, k, v, do = make()
    assert kfa.backward_build(q, k, v, do) == build, what
