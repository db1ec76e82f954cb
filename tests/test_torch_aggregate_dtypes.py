"""Keyed ``aggregate`` over half-precision and bool columns, both packages
on the same frame (the port with ``device="cpu"``).

float16 columns, and bfloat16 columns with more than 4,096 groups, take
the per-op route (``run_segment_fast``), off the fused segment kernel.
The reference sums and counts them on the host in float64
(``np.bincount``) and casts once to the column's dtype; the port sums in
float32 and counts in int64, then casts once. So the two may round to
neighbouring values of the output dtype: the tolerance is one step of
that dtype at the reference's value (2^-10 relative in float16, 2^-7 in
bfloat16). Groups hold more rows than a float16 (2,048) or bfloat16 (256)
accumulator can count, so a sum or count kept in the value dtype lands
far outside it. Each test first holds the reference's own result against
numpy's float64 sums, so a failing reference leg shows as such.

A keyed sum or mean of a bool column raises ``TypeError`` in both
packages.
"""

import numpy as np
import pytest

import tensorframes_tpu as tfs
import tensorframes_tpu_torch as tft

ml_dtypes = pytest.importorskip("ml_dtypes")

_MANTISSA_BITS = {"float16": 10, "bfloat16": 7}


def _np_dtype(name):
    return np.dtype(np.float16) if name == "float16" else np.dtype(ml_dtypes.bfloat16)


def _frame_data(name, groups, big, rows_big, seed):
    """``groups`` keys with one row each, plus ``big`` keys holding
    ``rows_big`` more rows each; values around 1, in dtype ``name``."""
    rng = np.random.default_rng(seed)
    keys = np.concatenate([np.arange(groups), np.repeat(np.arange(big), rows_big)])
    keys = keys[rng.permutation(len(keys))]
    vals = (1.0 + rng.standard_normal(len(keys))).astype(np.float32).astype(_np_dtype(name))
    return {"k": keys.astype(np.int64), "v": vals}


def _aggregate(pkg, data, op):
    df = pkg.frame_from_arrays(dict(data), num_blocks=3)
    with pkg.with_graph():
        fetch = getattr(pkg, op)(pkg.block(df, "v", tf_name="v_input"), name="v")
        out = pkg.aggregate(fetch, df.group_by("k"), **({"device": "cpu"} if pkg is tft else {}))
    return out.column_values("k"), out.column_values("v")


def _exact(data, op, dtype):
    """numpy's float64 sums (or means) per key, in key order, cast once."""
    keys, inv = np.unique(data["k"], return_inverse=True)
    s = np.bincount(inv, weights=data["v"].astype(np.float64), minlength=len(keys))
    if op == "reduce_mean":
        s = s / np.bincount(inv, minlength=len(keys))
    return keys, s.astype(dtype)


def _step(x, name):
    """One step of dtype ``name`` at |x| (its spacing there)."""
    mag = np.maximum(np.abs(x.astype(np.float64)), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(mag)) - _MANTISSA_BITS[name])


@pytest.mark.parametrize("op", ["reduce_sum", "reduce_mean"])
@pytest.mark.parametrize("name,groups,big,rows_big", [
    ("float16", 3, 3, 4_000),      # > 2,048 rows in a group
    ("float16", 40, 2, 2_500),
    ("bfloat16", 4_200, 3, 1_000),  # > 4,096 groups, > 256 rows in a group
    ("bfloat16", 5_000, 2, 300),
])
def test_half_precision_aggregate_matches_reference(name, groups, big, rows_big, op):
    data = _frame_data(name, groups, big, rows_big, seed=groups + rows_big)
    dtype = _np_dtype(name)
    keys, exact = _exact(data, op, dtype)
    jk, jv = _aggregate(tfs, data, op)
    np.testing.assert_array_equal(jk, keys)
    assert jv.dtype == dtype
    np.testing.assert_array_equal(jv.astype(np.float64), exact.astype(np.float64))  # reference leg

    tk, tv = _aggregate(tft, data, op)
    np.testing.assert_array_equal(tk, keys)
    assert tv.dtype == dtype and tv.shape == jv.shape
    ref = jv.astype(np.float64)
    diff = np.abs(tv.astype(np.float64) - ref)
    tol = _step(jv, name)
    worst = int(np.argmax(diff - tol))
    assert bool((diff <= tol).all()), (
        f"key {tk[worst]}: port {float(tv[worst])}, reference {float(jv[worst])}, "
        f"one step {float(tol[worst])}")


def test_bool_mean_raises_like_reference():
    rng = np.random.default_rng(21)
    data = {"k": rng.integers(0, 3, 3_000), "v": rng.integers(0, 2, 3_000).astype(bool)}
    errors = []
    for pkg in (tfs, tft):
        with pytest.raises(TypeError) as info:
            _aggregate(pkg, data, "reduce_mean")
        errors.append(info.value)
    assert type(errors[0]) is type(errors[1])
    assert "bool" in str(errors[0]) and "bool" in str(errors[1])


@pytest.mark.parametrize("groups", [3, 5_000])
def test_bool_mean_raises_before_dispatch(groups):
    """Both routes of the port: the fused segment kernel (at most 4,096
    groups) and the per-op route (more), and ``run_segment_fast`` called
    alone; bool min/max still reduce (a bool sum raises, see
    ``test_bool_sum_raises_like_reference``)."""
    import torch

    from tensorframes_tpu_torch.ops import verbs as tverbs

    rng = np.random.default_rng(groups)
    keys = np.concatenate([np.arange(groups), rng.integers(0, groups, 2_000)])
    data = {"k": keys, "v": rng.integers(0, 2, len(keys)).astype(bool)}
    with pytest.raises(TypeError, match="add does not accept dtype bool"):
        _aggregate(tft, data, "reduce_mean")
    sids = torch.from_numpy(keys.astype(np.int32))
    with pytest.raises(TypeError, match="add does not accept dtype bool"):
        tverbs.run_segment_fast((("v", "reduce_mean"),), groups,
                                {"v": torch.from_numpy(data["v"])}, sids)
    for op in ("reduce_min", "reduce_max"):
        tk, tv = _aggregate(tft, data, op)
        jk, jv = _aggregate(tfs, data, op)
        np.testing.assert_array_equal(tk, jk)
        np.testing.assert_array_equal(tv, jv)


@pytest.mark.parametrize("groups", [3, 5_000])
def test_bool_sum_raises_like_reference(groups):
    """A keyed sum of a bool column raises the reference's ``TypeError`` on
    both routes of the port (the fused kernel at 3 groups, the per-op route
    at 5,000) and in ``run_segment_fast`` called alone, before dispatch;
    the reference's own leg raises first, in the same run."""
    import torch

    from tensorframes_tpu_torch.ops import verbs as tverbs

    rng = np.random.default_rng(groups + 1)
    keys = np.concatenate([[0, 0, 1, 1, 2, 2], np.arange(groups),
                           rng.integers(0, groups, 2_000)])
    vals = np.concatenate([[False, False, True, False, True, True],
                           rng.integers(0, 2, len(keys) - 6).astype(bool)])
    data = {"k": keys, "v": vals}
    with pytest.raises(TypeError, match="add does not accept dtype bool"):
        _aggregate(tfs, data, "reduce_sum")
    with pytest.raises(TypeError, match="add does not accept dtype bool"):
        _aggregate(tft, data, "reduce_sum")
    sids = torch.from_numpy(keys.astype(np.int32))
    with pytest.raises(TypeError, match="add does not accept dtype bool"):
        tverbs.run_segment_fast((("v", "reduce_sum"),), groups,
                                {"v": torch.from_numpy(vals)}, sids)


@pytest.mark.parametrize("groups", [3, 5_000])
@pytest.mark.parametrize("name", ["int8", "uint8", "int32", "int64"])
def test_integer_mean_matches_reference(name, groups):
    """Integer means on both routes (the fused kernel at most 4,096 groups,
    the per-op route above) equal the reference's, groups of 300 rows
    included: the fetch dtype is the column's, so sums wrap on both sides
    alike."""
    rng = np.random.default_rng(groups + len(name))
    keys = np.concatenate([np.arange(groups), np.repeat([0, 1, 2], 300)])
    data = {"k": keys, "v": rng.integers(0, 5, len(keys)).astype(name)}
    jk, jv = _aggregate(tfs, data, "reduce_mean")
    tk, tv = _aggregate(tft, data, "reduce_mean")
    np.testing.assert_array_equal(tk, jk)
    assert tv.dtype == jv.dtype
    np.testing.assert_array_equal(tv, jv)
