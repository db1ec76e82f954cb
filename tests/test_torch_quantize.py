"""Weight-only int8 quantization and the int8-weight matmul: the JAX
package against the PyTorch port on the CPU, inputs from numpy seeds.

Tolerances: ``quantize`` int8 values and f32 scales are exact (the same
f32 absmax/127, division and round-half-to-even on both sides). The
structural ``matmul`` (the CPU path of both packages) differs only in the
order of the f32 sums of the product: rtol 2e-5 / atol 2e-5·max|ref| in
f32; in bf16 the product is rounded to bf16 before the scale on both
sides, so outputs may sit one bf16 step apart: 2^-7 relative plus
1e-2·max|ref|. ``matmul_int8_plain`` is held against the Pallas kernel
run in interpret mode (the reference's own CPU route for it) at rtol/atol
2e-5 in f32 and 2^-7 relative plus 1e-3·max|ref| in bf16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorframes_tpu.ops import quantize as jq
from tensorframes_tpu_torch.ops import quantize as tq


def _bf16_close(got, want, atol_frac):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    tol = 2.0 ** -7 * np.abs(want) + atol_frac * np.abs(want).max()
    assert np.all(np.abs(got - want) <= tol), np.abs(got - want).max()


@pytest.mark.parametrize("shape,axis", [
    ((64, 48), -1), ((3, 5, 7), 1), ((4, 2, 6, 8), (0, 1, 2)), ((16,), 0), ((32, 24), 0),
])
def test_quantize_exact(shape, axis):
    rng = np.random.default_rng(len(shape))
    w = (rng.standard_normal(shape) * 3).astype(np.float32)
    w.reshape(-1)[::7] = 0.0
    if len(shape) > 1:
        w[0] = 0.0  # an all-zero slice somewhere: the scale-1 guard
    a = jq.quantize(jnp.asarray(w), axis)
    b = tq.quantize(torch.from_numpy(w), axis)
    assert b.q.dtype == torch.int8 and b.scale.dtype == torch.float32
    np.testing.assert_array_equal(b.q.numpy(), np.asarray(a.q))
    np.testing.assert_array_equal(b.scale.numpy(), np.asarray(a.scale))
    assert b.nbytes == a.nbytes and b.shape == tuple(a.shape)
    np.testing.assert_array_equal(b.dequantize().numpy(), np.asarray(a.dequantize()))


def test_quantize_rounds_half_to_even():
    # absmax 127 makes the scale exactly 1: the halves round to even
    w = np.array([[127.0], [0.5], [1.5], [2.5], [-2.5]], np.float32)
    b = tq.quantize(torch.from_numpy(w), channel_axis=-1)
    assert b.q[:, 0].tolist() == [127, 0, 2, 2, -2]
    a = jq.quantize(jnp.asarray(w), -1)
    np.testing.assert_array_equal(b.q.numpy(), np.asarray(a.q))
    with pytest.raises(TypeError):
        tq.quantize(torch.arange(4))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lead,k,n", [((4,), 96, 160), ((2, 3), 128, 256), ((5,), 70, 100)])
def test_matmul_matches_jax(dtype, lead, k, n):
    rng = np.random.default_rng(k + n)
    x = rng.standard_normal((*lead, k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    want = jq.matmul(jx, jq.quantize(jnp.asarray(w)))
    got = tq.matmul(tx, tq.quantize(torch.from_numpy(w)))
    assert got.dtype == tx.dtype and tuple(got.shape) == tuple(want.shape)
    want = np.asarray(want.astype(jnp.float32))
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5 * np.abs(want).max())
    else:
        _bf16_close(got, want, 1e-2)


def test_matmul_plain_weight_and_nonchannel_scale():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 8)).astype(np.float32)
    w = rng.standard_normal((8, 5)).astype(np.float32)
    np.testing.assert_allclose(tq.matmul(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
                               np.asarray(jq.matmul(jnp.asarray(x), jnp.asarray(w))),
                               rtol=1e-5, atol=1e-5)
    # a scale over the contracted axis dequantizes first, on both sides
    a = jq.quantize(jnp.asarray(w), channel_axis=0)
    b = tq.quantize(torch.from_numpy(w), channel_axis=0)
    np.testing.assert_allclose(tq.matmul(torch.from_numpy(x), b).numpy(),
                               np.asarray(jq.matmul(jnp.asarray(x), a)), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        tq.matmul_int8(torch.from_numpy(x), b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lead,k,n", [((4,), 96, 160), ((2, 3), 128, 256), ((5,), 70, 100),
                                      ((16,), 768, 768)])
def test_matmul_int8_plain_matches_interpreted_pallas(dtype, lead, k, n):
    rng = np.random.default_rng(k * n)
    x = rng.standard_normal((*lead, k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32)
    want = jq.matmul_pallas_int8(jnp.asarray(x, getattr(jnp, dtype)), jq.quantize(jnp.asarray(w)),
                                 interpret=True)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    tw = tq.quantize(torch.from_numpy(w))
    got = tq.matmul_int8_plain(tx, tw)
    # on a CPU tensor the kernel's wrapper computes its plain version
    assert torch.equal(tq.matmul_int8(tx, tw), got)
    assert got.dtype == tx.dtype and tuple(got.shape) == tuple(want.shape)
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5 * np.abs(want).max())
    else:
        _bf16_close(got.float().numpy(), want, 1e-3)


def test_quantize_tree_and_nbytes():
    rng = np.random.default_rng(3)
    tree_np = {
        "embed": {"tok": rng.standard_normal((10, 4)).astype(np.float32)},
        "layers": [{"w": rng.standard_normal((4, 6)).astype(np.float32),
                    "b": rng.standard_normal(6).astype(np.float32),
                    "i": np.arange(6, dtype=np.int32).reshape(2, 3)}],
    }
    jt = jq.quantize_tree(jax.tree_util.tree_map(jnp.asarray, tree_np),
                          predicate=lambda path, _: "embed" not in jax.tree_util.keystr(path))
    tt = tq.quantize_tree(jax.tree_util.tree_map(torch.from_numpy, tree_np),
                          predicate=lambda path, _: "embed" not in path)
    assert isinstance(tt["layers"][0]["w"], tq.QuantizedTensor)
    assert torch.is_tensor(tt["embed"]["tok"]) and torch.is_tensor(tt["layers"][0]["b"])
    assert torch.is_tensor(tt["layers"][0]["i"])
    np.testing.assert_array_equal(tt["layers"][0]["w"].q.numpy(),
                                  np.asarray(jt["layers"][0]["w"].q))
    assert tq.tree_nbytes(tt) == jq.tree_nbytes(jt)
    assert tq.quantize_tree(tt)["layers"][0]["w"] is tt["layers"][0]["w"]  # idempotent
    np.testing.assert_array_equal(tq.asarray(tt["layers"][0]["w"]).numpy(),
                                  np.asarray(jq.asarray(jt["layers"][0]["w"])))
