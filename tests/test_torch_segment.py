"""Parity of the PyTorch port's segment reductions with the JAX package.

The port's ``segment_reduce`` / ``segment_sum`` on CPU tensors compute
their plain PyTorch versions; the JAX side runs its Pallas kernels in
interpret mode and its same-tiling ``*_reference`` twins, as
tests/test_kernels.py does. Inputs come from numpy with a seed.

Tolerances: exact for integer sums (i32 wraparound included), integer
means, counts and min/max; float32 sums and means rtol 1e-5 / atol
1e-5·max|v|·√n, because the sums are taken in another order; bfloat16
rtol 1e-2 (one bf16 ulp is 2^-8 of the value).
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tensorframes_tpu.kernels import segment_reduce as jksr
from tensorframes_tpu.ops import segment as jseg

from tensorframes_tpu_torch import dtypes as tdt
from tensorframes_tpu_torch.kernels import segment_reduce as ksr
from tensorframes_tpu_torch.ops import segment as tseg

_DTYPES = ("float32", "bfloat16", "int8", "int16", "int32", "uint8", "bool")
_OPS = ("reduce_sum", "reduce_mean", "reduce_min", "reduce_max")


def _np_dtype(name):
    return tdt.bfloat16.np_dtype if name == "bfloat16" else np.dtype(name)


def _values(rng, name, shape):
    if name in ("float32", "bfloat16"):
        return rng.standard_normal(shape).astype(np.float32).astype(_np_dtype(name))
    if name == "bool":
        return rng.integers(0, 2, shape).astype(bool)
    if name == "int32":
        # large magnitudes so the i32 sums wrap
        return rng.integers(-(2**30), 2**30, shape).astype(np.int32)
    info = np.iinfo(_np_dtype(name))
    return rng.integers(info.min, int(info.max) + 1, shape).astype(_np_dtype(name))


def _ids(rng, n, s):
    """Unsorted ids with every segment present (integer means of an empty
    segment divide 0/0 — garbage in both packages)."""
    return rng.permutation(np.arange(n) % s).astype(np.int32)


def _torch_cols(cols):
    return {k: tdt.to_torch(v, "cpu") for k, v in cols.items()}


def _assert_close(name, got, want, vmax, n):
    if name == "float32":
        np.testing.assert_allclose(
            got, want, rtol=1e-5, atol=1e-5 * vmax * math.sqrt(n), equal_nan=True
        )
    elif name == "bfloat16":
        np.testing.assert_allclose(
            got.astype(np.float32), want.astype(np.float32),
            rtol=1e-2, atol=1e-5 * vmax * math.sqrt(n), equal_nan=True,
        )
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", _DTYPES)
def test_segment_reduce_plain_matches_pallas_and_reference(name):
    """Every op over 1-D and 2-D columns of one dtype in one call; n = 300
    leaves a ragged last tile of the JAX kernel's 256-row grid."""
    n, s = 300, 7
    rng = np.random.default_rng(_DTYPES.index(name))
    ids = _ids(rng, n, s)
    cols, ops = {}, []
    for op in _OPS:
        for shape in ((n,), (n, 3)):
            key = f"{op}_{len(shape)}d"
            cols[key] = _values(rng, name, shape)
            ops.append((key, op))
    ops = tuple(ops)
    assert jksr.eligible(ops, cols, s)
    assert ksr.eligible(ops, _torch_cols(cols), s)
    pallas = jksr.segment_reduce_pallas(ops, s, cols, ids, interpret=True)
    ref = jksr.segment_reduce_reference(ops, s, cols, ids)
    got = ksr.segment_reduce(ops, s, _torch_cols(cols), torch.from_numpy(ids))
    for key, op in ops:
        g = tdt.to_numpy(got[key])
        assert g.dtype == pallas[key].dtype, (key, g.dtype, pallas[key].dtype)
        assert g.shape == pallas[key].shape, key
        vmax = float(np.abs(cols[key].astype(np.float64)).max())
        exact_class = op in ("reduce_min", "reduce_max") or name not in ("float32", "bfloat16")
        for want in (pallas[key], ref[key]):
            if exact_class:
                np.testing.assert_array_equal(g, want, err_msg=key)
            else:
                _assert_close(name, g, want, vmax, n)


def test_segment_reduce_empty_segments():
    """Segments no row lands in: sums read 0, float means NaN, min/max the
    dtype identity — as in the JAX kernel."""
    ids = np.asarray([0, 0, 2], np.int32)
    cols = {
        "m": np.asarray([1.0, 3.0, 5.0], np.float32),
        "s": np.asarray([1, 2, 3], np.int32),
        "lo": np.asarray([4, 5, 6], np.int8),
        "hi": np.asarray([1.5, -2.0, 3.0], np.float32),
    }
    ops = (("m", "reduce_mean"), ("s", "reduce_sum"),
           ("lo", "reduce_min"), ("hi", "reduce_max"))
    want = jksr.segment_reduce_pallas(ops, 5, cols, ids, interpret=True)
    got = ksr.segment_reduce(ops, 5, _torch_cols(cols), torch.from_numpy(ids))
    for key, _ in ops:
        np.testing.assert_array_equal(tdt.to_numpy(got[key]), want[key], err_msg=key)
    assert np.isnan(tdt.to_numpy(got["m"])[1])
    assert tdt.to_numpy(got["lo"])[1] == 127


@pytest.mark.parametrize("name", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,s,d", [(37, 5, 1), (513, 9, 4), (1000, 64, 8)])
def test_segment_sum_plain_matches_pallas(name, n, s, d):
    rng = np.random.default_rng(n * 7 + s)
    ids = rng.integers(0, s, n).astype(np.int32)
    v = rng.standard_normal((n, d)).astype(np.float32).astype(_np_dtype(name))
    want = np.asarray(jseg.segment_sum_pallas(jnp.asarray(v), jnp.asarray(ids), s,
                                              interpret=True))
    got = tseg.segment_sum_kernel(tdt.to_torch(v, "cpu"), torch.from_numpy(ids), s)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    vmax = float(np.abs(v.astype(np.float32)).max())
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * vmax * math.sqrt(n))


@pytest.mark.parametrize("dtype", ["int64", "float64", "int32"])
def test_segment_sum_other_dtypes_match_scatter(dtype):
    """Outside the kernel's f32/bf16 set, segment_sum is PyTorch's
    index_add_ in the values' dtype — jax.ops.segment_sum's route."""
    rng = np.random.default_rng(5)
    ids = rng.integers(0, 11, 400).astype(np.int32)
    v = (rng.standard_normal((400, 2)) * 1000).astype(dtype)
    want = np.asarray(jax.ops.segment_sum(jnp.asarray(v), jnp.asarray(ids), num_segments=11))
    got = tseg.segment_sum(torch.from_numpy(v), torch.from_numpy(ids), 11).numpy()
    assert got.dtype == want.dtype
    if dtype == "float64":
        np.testing.assert_allclose(got, want, rtol=1e-12)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("op", ["reduce_min", "reduce_max"])
@pytest.mark.parametrize("dtype", ["float64", "int64", "float32", "int8"])
def test_segment_minmax_matches_scatter(op, dtype):
    rng = np.random.default_rng(9)
    ids = rng.integers(0, 6, 200).astype(np.int32)  # segment 6 stays empty
    v = (rng.standard_normal(200) * 50).astype(dtype)
    jfn = jax.ops.segment_min if op == "reduce_min" else jax.ops.segment_max
    want = np.asarray(jfn(jnp.asarray(v), jnp.asarray(ids), num_segments=7))
    got = tseg.segment_minmax(torch.from_numpy(v), torch.from_numpy(ids), 7, op).numpy()
    np.testing.assert_array_equal(got, want)


def test_eligibility_gates():
    f32 = {"v": torch.zeros(4)}
    assert ksr.eligible((("v", "reduce_sum"),), f32, 4096)
    assert not ksr.eligible((("v", "reduce_sum"),), f32, 4097)
    assert not ksr.eligible((("v", "reduce_sum"),), f32, 0)
    assert not ksr.eligible((("v", "reduce_sum"),), {"v": torch.zeros(4, dtype=torch.int64)}, 2)
    assert not ksr.eligible((("v", "reduce_sum"),), {"v": torch.zeros(4, dtype=torch.float64)}, 2)
    many = {f"c{i}": torch.zeros(4) for i in range(17)}
    assert not ksr.eligible(tuple((k, "reduce_sum") for k in many), many, 2)
    # no table lives in shared memory: a wide min the TPU kernel's
    # VMEM budget refused is served
    assert ksr.eligible((("v", "reduce_min"),), {"v": torch.zeros((4, 4096))}, 4096)


def test_cuda_wrappers_raise_on_ineligible_feed(monkeypatch):
    """On a CUDA feed the wrapper launches or raises; it never computes its
    plain version instead (a meta tensor stands in for the device here)."""
    ids = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="not eligible"):
        ksr.segment_reduce((("v", "reduce_sum"),), 2,
                           {"v": torch.zeros(4, dtype=torch.float64, device="meta")}, ids)
    with pytest.raises(ValueError, match="float32/bfloat16"):
        tseg.segment_sum_kernel(torch.zeros((4, 1), dtype=torch.float64, device="meta"), ids, 2)


def test_raw_tables_are_the_kernels_alone():
    """The raw-table entry point (which hands back the kernel's count lane)
    has no plain version: CPU tensors raise instead of computing one."""
    cols = {"v": torch.zeros(4)}
    with pytest.raises(ValueError, match="CUDA tensors only"):
        ksr.segment_reduce_tables((("v", "reduce_mean"),), 2, cols,
                                  torch.zeros(4, dtype=torch.int32))
