"""The port's attention ops against the JAX package's on the CPU: blockwise
attention, flash attention (the kernel's plain version, which a CPU tensor
computes) and the custom ops' vmap and shape-analysis rules. Inputs come
from numpy seeds and go to both packages.

Tolerances, per op:
- f32: |got - want| <= 1e-5·max|want| (the two sides sum in other orders;
  the flash order scales the f32 product where blockwise scales q).
- bf16 flash against the JAX package's CPU flash (its blockwise path):
  |got - want| <= 2^-7·|want| + 2^-8·max|want|. The flash order rounds p
  to bf16 before P·V, blockwise keeps it in f32, so an output may land one
  bf16 step away (the worst seen is 0.6 of this bound over 36 cases).
- bf16 blockwise against blockwise: the same order of roundings; the
  f32 tolerance scaled to a bf16 step, 2^-8·max|want|.
- The vmap rules: exact against a loop over the rows (the same op on the
  same rows).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas.ops.tpu.flash_attention import mha_reference

from tensorframes_tpu.ops import attention as jatt
from tensorframes_tpu_torch.kernels import flash_attention as kfa
from tensorframes_tpu_torch.ops import attention as tatt
from tensorframes_tpu_torch.ops import quantize as tq

_JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _qkv(shape, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32) for _ in range(3))


def _both(arrays, dtype):
    return ([torch.from_numpy(a).to(dtype) for a in arrays],
            [jnp.asarray(a, _JDT[dtype]) for a in arrays])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy().astype(np.float64)
    return np.asarray(jnp.asarray(x, jnp.float32), np.float64)


def _close(got, want, dtype, flash_vs_blockwise=False):
    got, want = _np(got), _np(want)
    scale = np.abs(want).max()
    if dtype == torch.float32:
        tol = 1e-5 * scale
    elif flash_vs_blockwise:
        tol = 2.0 ** -7 * np.abs(want) + 2.0 ** -8 * scale
    else:
        tol = 2.0 ** -8 * scale
    assert np.all(np.abs(got - want) <= tol), float(np.abs(got - want).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,s", [(False, 64), (True, 64), (False, 60)])
def test_blockwise_matches_jax(causal, s, dtype):
    """As the JAX package's own blockwise tests: non-causal, causal, and a
    length not divisible by the block (the padding path)."""
    (tq_, tk, tv), (jq, jk, jv) = _both(_qkv((2, 4, s, 16)), dtype)
    got = tatt.blockwise_attention(tq_, tk, tv, causal=causal, block_size=16)
    want = jatt.blockwise_attention(jq, jk, jv, causal=causal, block_size=16)
    assert got.dtype == dtype and tuple(got.shape) == (2, 4, s, 16)
    _close(got, want, dtype)
    _close(got, tatt.dense_attention(tq_, tk, tv, causal=causal), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(2, 3, 60, 16), (1, 2, 130, 64), (2, 2, 33, 128)])
def test_flash_matches_jax(shape, causal, dtype):
    """The CPU flash (the kernel's plain version) against the JAX
    package's ``flash_attention`` on the CPU, which is its blockwise path."""
    (tq_, tk, tv), (jq, jk, jv) = _both(_qkv(shape, seed=shape[2]), dtype)
    got = tatt.flash_attention(tq_, tk, tv, causal=causal)
    assert got.dtype == dtype and tuple(got.shape) == shape
    _close(got, jatt.flash_attention(jq, jk, jv, causal=causal), dtype, flash_vs_blockwise=True)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_plain_matches_upstream_mha_reference(causal):
    """The plain version against the upstream kernel's own oracle, in f32."""
    q, k, v = _qkv((2, 3, 130, 64), seed=7)
    scale = kfa.default_scale(64)
    want = mha_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None, causal=causal,
                         sm_scale=float(1.0 / np.sqrt(64)))
    got = kfa.flash_attention_reference(*(torch.from_numpy(a) for a in (q, k, v)), causal, scale)
    _close(got, want, torch.float32)


def test_flash_op_output_layout():
    """The op returns [b, h, s, d] laid out as [b, s, h, d] (the encoder's
    transpose back is then a view), on the CPU as on the card and under
    shape analysis."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    q, k, v = (torch.from_numpy(a) for a in _qkv((2, 3, 5, 8)))
    out = tatt.flash_attention(q, k, v)
    assert out.transpose(1, 2).is_contiguous()
    with FakeTensorMode(allow_non_fake_inputs=True):
        fake = tatt.flash_attention(q, k, v)
    assert fake.shape == out.shape and fake.stride() == out.stride()


def _count_calls(monkeypatch, module, name):
    calls = []
    fn = getattr(module, name)

    def counted(*a, **kw):
        calls.append(tuple(a[0].shape))
        return fn(*a, **kw)

    monkeypatch.setattr(module, name, counted)
    return calls


@pytest.mark.parametrize("causal", [False, True])
def test_flash_op_under_vmap_calls_once(monkeypatch, causal):
    """``torch.func.vmap`` over the op (under inference mode, as
    ``map_rows`` runs it) equals a loop over the rows, and the vmap rule
    calls the op once for the whole batch."""
    q, k, v = (torch.from_numpy(a) for a in _qkv((5, 2, 3, 9, 8), seed=3))
    loop = torch.stack([tatt.flash_attention(*t, causal=causal) for t in zip(q, k, v)])
    calls = _count_calls(monkeypatch, kfa, "flash_attention_reference")
    with torch.inference_mode():
        got = torch.func.vmap(lambda a, b, c: tatt.flash_attention(a, b, c, causal=causal))(q, k, v)
    assert calls == [(10, 3, 9, 8)]
    assert torch.equal(got, loop)
    # an unbatched k/v rides along by expansion
    calls.clear()
    got = torch.func.vmap(lambda a: tatt.flash_attention(a, k[0], v[0], causal=causal))(q)
    assert calls == [(10, 3, 9, 8)]
    assert torch.equal(got, torch.stack([tatt.flash_attention(a, k[0], v[0], causal=causal)
                                         for a in q]))


def test_int8_matmul_op_under_vmap_calls_once(monkeypatch):
    """``quantize.matmul_int8`` (what ``quantize.matmul`` reaches for a
    quantized weight on the card) under vmap equals a loop over the rows,
    in one op call; a vmapped weight is refused."""
    rng = np.random.default_rng(4)
    w = tq.quantize(torch.from_numpy(rng.standard_normal((32, 24)).astype(np.float32)))
    x = torch.from_numpy(rng.standard_normal((6, 1, 7, 32)).astype(np.float32)).bfloat16()
    loop = torch.stack([tq.matmul_int8(r, w) for r in x])
    calls = _count_calls(monkeypatch, tq, "matmul_int8_plain")
    with torch.inference_mode():
        got = torch.func.vmap(lambda r: tq.matmul_int8(r, w))(x)
    assert calls == [(6, 1, 7, 32)]
    assert torch.equal(got, loop) and got.dtype == torch.bfloat16
    qs = torch.stack([w.q, w.q])
    with pytest.raises(NotImplementedError, match="weight must not be vmapped"):
        torch.func.vmap(lambda q: tq.matmul_int8(x[0], tq.QuantizedTensor(q, w.scale)))(qs)


def test_ops_shape_analysis_uses_fake_rules():
    """Under ``FakeTensorMode`` (the program's shape analysis) neither op
    computes: both give the output's shape and dtype."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    w = tq.quantize(torch.ones((16, 8)))
    with FakeTensorMode(allow_non_fake_inputs=True):
        q = torch.empty((2, 3, 5, 64), dtype=torch.bfloat16)
        assert tuple(tatt.flash_attention(q, q, q).shape) == (2, 3, 5, 64)
        y = tq.matmul_int8(torch.empty((4, 2, 16), dtype=torch.bfloat16), w)
        assert tuple(y.shape) == (4, 2, 8) and y.dtype == torch.bfloat16


@pytest.mark.parametrize("what,args,match", [
    ("head_dim", ((1, 2, 8, 160), torch.bfloat16), "head_dim <= 128"),
    ("dtype", ((1, 2, 8, 64), torch.float16), "bfloat16 or float32"),
    ("no keys", ((1, 2, 0, 64), torch.bfloat16), "at least one key"),
])
def test_flash_kernel_limits_raise_on_cuda_inputs(what, args, match):
    """A CUDA input the kernel cannot take raises with its limit (fake
    CUDA tensors reach the same checks without a card)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    shape, dtype = args
    with FakeTensorMode():
        q = torch.empty((1, 2, 8, shape[-1]), dtype=dtype, device="cuda")
        kv = torch.empty(shape, dtype=dtype, device="cuda")
        with pytest.raises(ValueError, match=match):
            tatt.flash_attention(q, kv, kv)


def test_flash_shape_mismatch_raises():
    q = torch.zeros((1, 2, 4, 8))
    with pytest.raises(ValueError, match="do not match"):
        tatt.flash_attention(q, torch.zeros((1, 2, 4, 16)), torch.zeros((1, 2, 4, 16)))


def _qkv_views(b, s, h, d, dtype):
    """Three ``[b, h, s, d]`` views of one ``[b, s, 3, h, d]`` tensor, as
    the encoder and the training path pass them."""
    qkv = torch.zeros((b, s, 3, h, d), dtype=dtype)
    return tuple(qkv[:, :, i].permute(0, 2, 1, 3) for i in range(3))


def _off_by_one(shape, dtype):
    """A contiguous tensor whose data starts one element past a 16-byte
    boundary."""
    return torch.zeros(int(np.prod(shape)) + 1, dtype=dtype)[1:].view(shape)


@pytest.mark.parametrize("what,make,build", [
    ("the encoder's bf16 views", lambda: _qkv_views(4, 128, 12, 64, torch.bfloat16), "mma"),
    ("the training path's bf16 views", lambda: _qkv_views(2, 1024, 12, 64, torch.bfloat16),
     "mma"),
    ("bf16 head_dim 80", lambda: (torch.zeros((2, 8, 333, 80), dtype=torch.bfloat16),) * 3,
     "mma"),
    ("bf16 head_dim 8, one row", lambda: (torch.zeros((1, 2, 1, 8), dtype=torch.bfloat16),) * 3,
     "mma"),
    ("bf16, a length-1 dim's odd stride", lambda: (torch.zeros((1, 2, 5, 64), dtype=torch.bfloat16)
                                                   .as_strided((1, 2, 5, 64), (3, 320, 64, 1)),) * 3,
     "mma"),
    ("f32 views", lambda: _qkv_views(4, 128, 12, 64, torch.float32), "scalar"),
    ("f32 head_dim 128", lambda: (torch.zeros((3, 4, 1000, 128)),) * 3, "scalar"),
    ("bf16 head_dim 36", lambda: (torch.zeros((2, 3, 77, 36), dtype=torch.bfloat16),) * 3,
     "scalar"),
    ("bf16 views of a head_dim-36 qkv", lambda: _qkv_views(2, 16, 3, 36, torch.bfloat16),
     "scalar"),
    ("bf16 rows off a 16-byte boundary", lambda: (_off_by_one((2, 3, 77, 64), torch.bfloat16),) * 3,
     "scalar"),
    ("bf16 k alone off a 16-byte boundary", lambda: (
        torch.zeros((2, 3, 77, 64), dtype=torch.bfloat16),
        _off_by_one((2, 3, 77, 64), torch.bfloat16),
        torch.zeros((2, 3, 77, 64), dtype=torch.bfloat16)), "scalar"),
    ("bf16 with a sequence stride of 12 elements", lambda: (
        torch.zeros((1, 1, 16, 12), dtype=torch.bfloat16)[..., :8],) * 3, "scalar"),
])
def test_forward_build_chooses_the_kernel(what, make, build):
    """The one rule between the two forward kernels: bf16 whose rows can be
    copied 16 bytes at a time takes the tensor cores, the rest the scalar
    kernel (the rule reads dtypes, shapes, strides and data pointers, so
    CPU tensors exercise it)."""
    q, k, v = make()
    assert kfa.forward_build(q, k, v) == build, what
