"""The gradient of the port's attention ops against the JAX package's on
the CPU: the flash backward's plain version (what a CPU tensor computes,
and what the card's dK/dV and dQ kernels are held to) against ``jax.vjp``
of upstream's pure-JAX attention, the custom op's gradient against that
plain version, and the dense and blockwise gradients against the JAX
package's ``jax.grad``. Inputs come from numpy seeds and go to both
packages.

Tolerances, per check:
- f32, the algorithms: |got - want| <= 1e-5·max|want| per gradient. Both
  sides take the same sums in other orders (XLA's einsums against
  PyTorch's, the scale on the product or on q), a few f32 ulps apart
  (4e-7·max seen).
- the custom op's gradient against the plain backward: exact (the CPU op
  computes that plain version on the same inputs).
- bf16 blockwise/flash against the JAX package's flash (its blockwise
  path, differentiated through ``lax.scan``): the two round at other
  places (flash rounds p and dS to bf16, blockwise keeps them in f32; XLA
  and PyTorch round their bf16 products apart), so each gradient agrees
  within 2e-2·max|want| (the worst seen is 7.4e-3·max).
- gradients of the gradient: an error, as upstream's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas.ops.tpu.flash_attention import mha_reference_no_custom_vjp

from tensorframes_tpu.ops import attention as jatt
from tensorframes_tpu_torch.kernels import flash_attention as kfa
from tensorframes_tpu_torch.ops import attention as tatt

_JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _arrays(shape, seed, n=4):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy().astype(np.float64)
    return np.asarray(jnp.asarray(x, jnp.float32), np.float64)


def _close(got, want, frac):
    got, want = _np(got), _np(want)
    diff = np.abs(got - want).max()
    assert diff <= frac * np.abs(want).max(), (diff, np.abs(want).max())


@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("s", [16, 77])
@pytest.mark.parametrize("causal", [False, True])
def test_plain_backward_matches_upstream_vjp(causal, s, d):
    """``flash_attention_bwd_reference`` (with the plain forward's o, l, m)
    against ``jax.vjp`` of upstream's ``mha_reference_no_custom_vjp``, f32."""
    q, k, v, do = _arrays((2, 3, s, d), seed=s + d)
    scale = kfa.default_scale(d)
    _, vjp = jax.vjp(lambda a, b, c: mha_reference_no_custom_vjp(
        a, b, c, causal=causal, sm_scale=scale), *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    o, l, m = kfa.flash_attention_fwd_reference(tq, tk, tv, causal, scale)
    got = kfa.flash_attention_bwd_reference(tq, tk, tv, o, l, m, tdo, causal, scale)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == (2, 3, s, d)
        _close(g, w, 1e-5)
    # the forward's residuals are upstream's too
    _, jl, jm = mha_reference_no_custom_vjp(*(jnp.asarray(a) for a in (q, k, v)), causal=causal,
                                            sm_scale=scale, save_residuals=True)
    _close(l, jl, 1e-5)
    _close(m, jm, 1e-5)


def _qkv_views(b, s, h, d, dtype, seed):
    """q/k/v as ``[b, h, s, d]`` views of one ``[b, s, 3, h, d]`` leaf, as
    the model passes them."""
    rng = np.random.default_rng(seed)
    qkv = torch.from_numpy(rng.standard_normal((b, s, 3, h, d)).astype(np.float32)).to(dtype)
    qkv.requires_grad_(True)
    return qkv, [qkv[:, :, i].permute(0, 2, 1, 3) for i in range(3)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
def test_op_gradient_is_the_plain_backward(causal, dtype):
    """``torch.autograd.grad`` through ``tftpu::flash_attention`` on the
    CPU, with q/k/v strided views of one tensor, gives the plain backward's
    bits; the forward kept l and m and gave the plain forward's o."""
    qkv, (q, k, v) = _qkv_views(2, 77, 3, 16, dtype, seed=1)
    do = torch.from_numpy(_arrays((2, 3, 77, 16), seed=2, n=1)[0]).to(dtype)
    out = kfa.flash_attention(q, k, v, causal=causal)
    dq, dk, dv = torch.autograd.grad(out, (q, k, v), do)
    scale = kfa.default_scale(16)
    qd, kd, vd = (t.detach() for t in (q, k, v))
    o, l, m = kfa.flash_attention_fwd_reference(qd, kd, vd, causal, scale)
    assert torch.equal(out.detach(), o)
    want = kfa.flash_attention_bwd_reference(qd, kd, vd, o, l, m, do, causal, scale)
    for g, w in zip((dq, dk, dv), want):
        assert g.dtype == dtype and torch.equal(g, w)
    # the gradient of the shared leaf is the three stacked along its axis 2
    (dqkv,) = torch.autograd.grad(kfa.flash_attention(q, k, v, causal=causal), qkv, do)
    assert torch.equal(dqkv, torch.stack([w.permute(0, 2, 1, 3) for w in want], dim=2))


def test_forward_keeps_statistics_only_for_a_gradient():
    """Without a gradient to take (no input requiring grad, or grad mode
    off) the op keeps no l/m; with one it keeps both, under shape analysis
    too."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    q = torch.from_numpy(_arrays((2, 3, 9, 8), seed=3, n=1)[0])
    assert kfa._flash_op(q, q, q, False, 0.5, False)[1].shape == (2, 3, 0)
    o, l, m = kfa.flash_attention_fwd(q, q, q, True, 0.5)
    assert l.shape == m.shape == (2, 3, 9) and l.dtype == m.dtype == torch.float32
    with FakeTensorMode(allow_non_fake_inputs=True):
        fo, fl, fm = kfa.flash_attention_fwd(torch.empty((2, 3, 9, 8)), q, q, True, 0.5)
        assert fl.shape == (2, 3, 9) and fo.stride() == o.stride()
        dk, dv = kfa.flash_attention_bwd_dkv(q, q, q, l, m, q, l, True, 0.5)
        assert dk.shape == dv.shape == q.shape and dk.stride() == o.stride()
        assert kfa.flash_attention_bwd_dq(q, q, q, l, m, q, l, True, 0.5).shape == q.shape


def test_gradient_of_gradient_raises():
    q = torch.from_numpy(_arrays((1, 2, 5, 8), seed=4, n=1)[0]).requires_grad_(True)
    out = kfa.flash_attention(q, q, q)
    with pytest.raises(NotImplementedError, match="gradients of the gradient"):
        torch.autograd.grad(out.sum(), q, create_graph=True)


def _jax_grads(fn, arrays, dtype):
    q, k, v, do = (jnp.asarray(a, _JDT[dtype]) for a in arrays)
    _, vjp = jax.vjp(fn, q, k, v)
    return vjp(do)


def _torch_grads(fn, arrays, dtype):
    q, k, v, do = (torch.from_numpy(a).to(dtype) for a in arrays)
    q, k, v = (t.requires_grad_(True) for t in (q, k, v))
    return torch.autograd.grad(fn(q, k, v), (q, k, v), do)


@pytest.mark.parametrize("impl", ["dense", "blockwise", "flash"])
@pytest.mark.parametrize("causal,s", [(False, 64), (True, 64), (True, 60)])
def test_attention_gradients_match_jax_f32(impl, causal, s):
    """Each attention's gradient against the JAX package's same op under
    ``jax.vjp`` (its flash on the CPU is its blockwise path), in f32."""
    arrays = _arrays((2, 3, s, 16), seed=s)
    tfn = {"dense": lambda a, b, c: tatt.dense_attention(a, b, c, causal=causal),
           "blockwise": lambda a, b, c: tatt.blockwise_attention(a, b, c, causal, block_size=16),
           "flash": lambda a, b, c: tatt.flash_attention(a, b, c, causal=causal)}[impl]
    jfn = {"dense": lambda a, b, c: jatt.dense_attention(a, b, c, causal=causal),
           "blockwise": lambda a, b, c: jatt.blockwise_attention(a, b, c, causal, block_size=16),
           "flash": lambda a, b, c: jatt.flash_attention(a, b, c, causal=causal)}[impl]
    for g, w in zip(_torch_grads(tfn, arrays, torch.float32),
                    _jax_grads(jfn, arrays, torch.float32)):
        _close(g, w, 1e-5)


@pytest.mark.parametrize("impl", ["blockwise", "flash"])
@pytest.mark.parametrize("causal", [False, True])
def test_attention_gradients_match_jax_bf16(impl, causal):
    """bf16 gradients of the port's blockwise and flash against the JAX
    package's flash (blockwise through ``lax.scan`` on the CPU)."""
    arrays = _arrays((2, 3, 77, 32), seed=5)
    tfn = {"blockwise": lambda a, b, c: tatt.blockwise_attention(a, b, c, causal, block_size=16),
           "flash": lambda a, b, c: tatt.flash_attention(a, b, c, causal=causal)}[impl]
    want = _jax_grads(lambda a, b, c: jatt.flash_attention(a, b, c, causal=causal, block_size=16),
                      arrays, torch.bfloat16)
    for g, w in zip(_torch_grads(tfn, arrays, torch.bfloat16), want):
        assert g.dtype == torch.bfloat16
        _close(g, w, 2e-2)


@pytest.mark.parametrize("what,kw,match", [
    ("dO dtype", dict(do_dtype=torch.float32), "bfloat16 or float32 q/k/v/dO"),
    ("l shape", dict(l_len=5), "l must be float32"),
])
def test_backward_kernel_inputs_raise_on_cuda_tensors(what, kw, match):
    """A CUDA input the backward kernels cannot take raises (fake CUDA
    tensors reach the same checks without a card)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        q = torch.empty((1, 2, 8, 64), dtype=torch.bfloat16, device="cuda")
        do = torch.empty((1, 2, 8, 64), dtype=kw.get("do_dtype", torch.bfloat16), device="cuda")
        stat = torch.empty((1, 2, 8), device="cuda")
        l = torch.empty((1, 2, kw.get("l_len", 8)), device="cuda")
        with pytest.raises(ValueError, match=match):
            kfa._launch_dkv(q, q, q, l, stat, do, stat, True, 0.125)
