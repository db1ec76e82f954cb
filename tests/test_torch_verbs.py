"""The slice as a whole: the same frames and the same DSL graphs, written
once per package, through the five verbs of the JAX package and of the
PyTorch port (``device="cpu"``). Inputs come from numpy with a seed.

Tolerances: keys, group order, dtypes, shapes, integer results and
min/max exact; float sums rtol 1e-5 / atol 1e-5·max|v|·√n (on the CPU the
JAX side sums 1-D floats through np.bincount in float64, the port in
float32 or in another order); logreg scores rtol 1e-5 with TF32 off,
labels exact.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import tensorframes_tpu as tfs
import tensorframes_tpu_torch as tft
from tensorframes_tpu.models import logreg as jlogreg
from tensorframes_tpu_torch.models import logreg as tlogreg

CPU = {"device": "cpu"}


@pytest.fixture(autouse=True)
def _no_tf32():
    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was


def _kw(pkg):
    return CPU if pkg is tft else {}


def _rows(frame):
    return frame.collect()


def _assert_rows_equal(a, b):
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        assert list(ra) == list(rb)
        for k in ra:
            va, vb = np.asarray(ra[k]), np.asarray(rb[k])
            assert va.dtype == vb.dtype, (k, va.dtype, vb.dtype)
            np.testing.assert_array_equal(va, vb, err_msg=k)


# ---------------------------------------------------------------------------
# map_blocks
# ---------------------------------------------------------------------------

def _add3(pkg):
    df = pkg.frame_from_rows([{"x": float(i)} for i in range(10)])
    with pkg.with_graph():
        x = pkg.block(df, "x")
        out = pkg.map_blocks(pkg.add(x, 3, name="z"), df, **_kw(pkg))
    return out


def test_add3_map_blocks_values_and_dtype():
    j, t = _add3(tfs), _add3(tft)
    assert str(t.schema) == str(j.schema)
    _assert_rows_equal(_rows(t), _rows(j))
    assert t.schema["z"].dtype.name == "float64"


def test_map_blocks_trim_and_python_function():
    x = np.arange(12, dtype=np.float64).reshape(6, 2)
    outs = []
    for pkg, lib in ((tfs, jnp), (tft, torch)):
        df = pkg.frame_from_arrays({"x": x}, num_blocks=2)
        outs.append(pkg.map_blocks(lambda x: {"s": lib.sum(x, 1) * 2.0}, df,
                                   trim=True, **_kw(pkg)))
    assert outs[0].schema.names == outs[1].schema.names == ["s"]
    np.testing.assert_array_equal(outs[1].column_values("s"), outs[0].column_values("s"))


_GRAPHS = {
    "int64_plus_float": lambda pkg, c: pkg.add(c, 2.5, name="o"),
    "int_div": lambda pkg, c: pkg.div(c, c, name="o"),
    "int_div_scalar": lambda pkg, c: pkg.div(c, 2, name="o"),
    "mul_const_array": lambda pkg, c: pkg.mul(c, pkg.constant(np.float32(1.5)), name="o"),
    "exp": lambda pkg, c: pkg.exp(c, name="o"),
    "square_minus": lambda pkg, c: pkg.sub(pkg.square(c), 1, name="o"),
}


@pytest.mark.parametrize("graph", sorted(_GRAPHS))
@pytest.mark.parametrize("dtype", ["int64", "int32", "float32"])
def test_dsl_dtype_promotion_matches(graph, dtype):
    """Result dtypes of the same DSL graph agree between the packages
    (the port follows the reference's promotion with 64-bit types on)."""
    col = (np.arange(1, 9) % 5 + 1).astype(dtype)
    outs = []
    for pkg in (tfs, tft):
        df = pkg.frame_from_arrays({"c": col})
        with pkg.with_graph():
            outs.append(pkg.map_blocks(_GRAPHS[graph](pkg, pkg.block(df, "c")), df,
                                       **_kw(pkg)))
    j, t = outs[0].column_values("o"), outs[1].column_values("o")
    assert t.dtype == j.dtype, (t.dtype, j.dtype)
    np.testing.assert_allclose(t, j, rtol=1e-6)


# ---------------------------------------------------------------------------
# reduce_blocks / reduce_rows over double[?,2]
# ---------------------------------------------------------------------------

def _y():
    return np.random.default_rng(1).standard_normal((1000, 2))


@pytest.mark.parametrize("op", ["reduce_sum", "reduce_min"])
def test_reduce_blocks_double_pairs(op):
    y = _y()
    res = []
    for pkg in (tfs, tft):
        df = pkg.frame_from_arrays({"y": y}, num_blocks=3)
        with pkg.with_graph():
            yi = pkg.placeholder(np.float64, (None, 2), name="y_input")
            res.append(pkg.reduce_blocks(getattr(pkg, op)(yi, name="y"), df, **_kw(pkg)))
    assert res[1].dtype == res[0].dtype == np.float64
    np.testing.assert_allclose(res[1], res[0], rtol=1e-12)
    if op == "reduce_min":
        np.testing.assert_array_equal(res[1], res[0])


@pytest.mark.parametrize("op", ["sum", "min"])
def test_reduce_rows_double_pairs(op):
    y = _y()[:64]
    res = []
    for pkg, lib in ((tfs, jnp), (tft, torch)):
        df = pkg.frame_from_arrays({"y": y}, num_blocks=3)
        if op == "sum":
            with pkg.with_graph():
                y1 = pkg.placeholder(np.float64, (2,), name="y_1")
                y2 = pkg.placeholder(np.float64, (2,), name="y_2")
                res.append(pkg.reduce_rows(pkg.add(y1, y2, name="y"), df, **_kw(pkg)))
        else:
            res.append(pkg.reduce_rows(
                lambda y_1, y_2: {"y": lib.minimum(y_1, y_2)}, df, **_kw(pkg)))
    # the same sequential fold order in both packages
    np.testing.assert_array_equal(res[1], res[0])


# ---------------------------------------------------------------------------
# map_rows: fixed and ragged cells
# ---------------------------------------------------------------------------

def test_map_rows_fixed_cells():
    y = _y()
    outs = []
    for pkg in (tfs, tft):
        df = pkg.frame_from_arrays({"y": y}, num_blocks=3)
        with pkg.with_graph():
            r = pkg.row(df, "y")
            outs.append(pkg.map_rows(
                [pkg.add(pkg.mul(r, 2.0), 1.0, name="a"), pkg.reduce_max(r, name="m")],
                df, **_kw(pkg)))
    assert str(outs[1].schema) == str(outs[0].schema)
    for col in ("a", "m"):
        np.testing.assert_array_equal(outs[1].column_values(col), outs[0].column_values(col))


def _ragged_rows(dtype):
    rng = np.random.default_rng(7)
    return [
        {"r": rng.standard_normal(int(n)).astype(dtype), "k": i}
        for i, n in enumerate(rng.integers(1, 9, 60))
    ]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_map_rows_ragged_cells(dtype):
    rows = _ragged_rows(dtype)
    outs = []
    for pkg in (tfs, tft):
        df = pkg.frame_from_rows(rows, num_blocks=3)
        with pkg.with_graph():
            r = pkg.placeholder(dtype, (None,), name="r")
            outs.append(pkg.map_rows(
                [pkg.reduce_max(r, name="m"), pkg.reduce_sum(r, name="s"),
                 pkg.mul(r, 3.0, name="t")], df, **_kw(pkg)))
    j, t = outs
    np.testing.assert_array_equal(t.column_values("m"), j.column_values("m"))
    np.testing.assert_allclose(t.column_values("s"), j.column_values("s"), rtol=1e-6)
    for a, b in zip((r["t"] for r in t.collect()), (r["t"] for r in j.collect())):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(t.column_values("k"), j.column_values("k"))


@pytest.mark.parametrize("min_bucket,doublings", [(8, 30), (3, 4), (1, 0)])
def test_bucket_ladder_and_padding_match(min_bucket, doublings):
    """bucket_rows / bucket_table / pad_lead_dim are the reference's, so
    padded rows match row for row."""
    from tensorframes_tpu import config as jconfig
    from tensorframes_tpu.ops import executor as jex
    from tensorframes_tpu_torch.ops import executor as tex

    knobs = {"min_bucket": min_bucket, "max_bucket_doublings": doublings}
    was = [{k: getattr(cfg, k) for k in knobs} for cfg in (jconfig.get_config(), tft.get_config())]
    tfs.configure(**knobs)
    tft.configure(**knobs)
    try:
        assert tex.bucket_table() == jex.bucket_table()
        for n in list(range(0, 70)) + [1000, 4097, 10**6]:
            assert tex.bucket_rows(n) == jex.bucket_rows(n), n
        feeds = {"a": np.arange(10.0).reshape(5, 2), "b": np.arange(5, dtype=np.int32)}
        target = tex.bucket_rows(5)
        got, want = tex.pad_lead_dim(feeds, 5, target), jex.pad_lead_dim(feeds, 5, target)
        for k in feeds:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]))
    finally:
        tfs.configure(**was[0])
        tft.configure(**was[1])


def test_ragged_map_rows_stages_through_the_gather():
    """A single 1-D ragged column takes the gather route (its plain
    version on CPU tensors; the kernel on the card)."""
    from tensorframes_tpu_torch.kernels import ragged_gather as krg

    calls = []
    real = krg.ragged_gather_rows

    def spy(flat, starts, length):
        calls.append(length)
        return real(flat, starts, length)

    krg.ragged_gather_rows = spy
    try:
        df = tft.frame_from_rows(_ragged_rows("float64"))
        with tft.with_graph():
            r = tft.placeholder("float64", (None,), name="r")
            tft.map_rows(tft.reduce_sum(r, name="s"), df, device="cpu").blocks()
    finally:
        krg.ragged_gather_rows = real
    assert sorted(calls) == list(range(1, 9))


# ---------------------------------------------------------------------------
# aggregate
# ---------------------------------------------------------------------------

def _agg_data(n=3000):
    rng = np.random.default_rng(13)
    return {
        "ki": rng.integers(-5, 20, n),
        "ks": np.asarray([f"key{int(i)}" for i in rng.integers(0, 17, n)], dtype=object),
        "v": rng.standard_normal(n).astype(np.float32),
        "u": rng.standard_normal(n).astype(np.float32),
        "w": rng.standard_normal((n, 3)).astype(np.float32),
        "c": rng.integers(-1000, 1000, n).astype(np.int32),
        "i": rng.integers(-(2**40), 2**40, n),
        "b": rng.integers(0, 2, n).astype(bool),
    }


def _aggregate(pkg, data, keys, fetch_spec):
    df = pkg.frame_from_arrays(
        {k: (list(v) if v.dtype == object else v) for k, v in data.items()}, num_blocks=4
    )
    with pkg.with_graph():
        fetches = [
            getattr(pkg, op)(pkg.block(df, col, tf_name=f"{col}_input"), name=col)
            for col, op in fetch_spec
        ]
        return pkg.aggregate(fetches, df.group_by(*keys), **_kw(pkg))


_KERNEL_FETCHES = [("v", "reduce_sum"), ("u", "reduce_mean"), ("w", "reduce_max"),
                   ("c", "reduce_sum"), ("b", "reduce_min")]
_MIXED_FETCHES = [("v", "reduce_sum"), ("i", "reduce_sum"), ("u", "reduce_mean"),
                  ("c", "reduce_min")]


@pytest.mark.parametrize("keys", [("ki",), ("ks",), ("ks", "ki")])
@pytest.mark.parametrize("fetch_spec", [_KERNEL_FETCHES, _MIXED_FETCHES],
                         ids=["kernel_eligible", "mixed_f32_int64"])
def test_aggregate_matches(keys, fetch_spec):
    data = _agg_data()
    j = _aggregate(tfs, data, keys, fetch_spec)
    t = _aggregate(tft, data, keys, fetch_spec)
    assert str(t.schema) == str(j.schema)
    for k in keys:
        np.testing.assert_array_equal(t.column_values(k), j.column_values(k))
    n = len(data["v"])
    for col, op in fetch_spec:
        a, b = t.column_values(col), j.column_values(col)
        assert a.dtype == b.dtype and a.shape == b.shape, col
        if a.dtype.kind == "f" and op in ("reduce_sum", "reduce_mean"):
            vmax = float(np.abs(data[col]).max())
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5 * vmax * math.sqrt(n))
        else:
            np.testing.assert_array_equal(a, b, err_msg=col)


def test_aggregate_routes_to_the_segment_kernels(monkeypatch):
    """Kernel-eligible fetch sets take one fused segment_reduce call; an
    int64 sum sends the set to the per-op route, whose float32 sum is the
    segment_sum kernel's."""
    from tensorframes_tpu_torch.kernels import segment_reduce as ksr
    from tensorframes_tpu_torch.ops import segment as tseg

    seen = []
    real_reduce, real_sum = ksr.segment_reduce, tseg.segment_sum_kernel
    monkeypatch.setattr(ksr, "segment_reduce",
                        lambda *a: seen.append("segment_reduce") or real_reduce(*a))
    monkeypatch.setattr(tseg, "segment_sum_kernel",
                        lambda *a: seen.append("segment_sum") or real_sum(*a))
    data = _agg_data(500)
    _aggregate(tft, data, ("ki",), _KERNEL_FETCHES)
    assert seen == ["segment_reduce"]
    seen.clear()
    _aggregate(tft, data, ("ki",), [("v", "reduce_sum"), ("i", "reduce_sum")])
    assert seen == ["segment_sum"]


def test_aggregate_non_algebraic_is_not_ported():
    df = tft.frame_from_arrays({"k": np.arange(4) % 2, "v": np.arange(4.0)})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tft.aggregate(lambda v_input: {"v": v_input.sum(0) * 2}, df.group_by("k"), device="cpu")


# ---------------------------------------------------------------------------
# logreg scoring with the reference's weights
# ---------------------------------------------------------------------------

def test_logreg_scoring_with_params_from_jax():
    jparams = jlogreg.init_params(seed=3)
    np_params = {k: np.asarray(v) for k, v in jparams.items()}
    tparams = tlogreg.params_from_jax(np_params)
    feats, _ = tlogreg.make_synthetic_mnist(2000, seed=5)
    jf, _ = jlogreg.make_synthetic_mnist(2000, seed=5)
    np.testing.assert_array_equal(feats, jf)
    j = tfs.map_blocks(jlogreg.scoring_program(jparams), tfs.frame_from_arrays({"features": feats}))
    t = tft.map_blocks(tlogreg.scoring_program(tparams),
                       tft.frame_from_arrays({"features": feats}), device="cpu")
    assert str(t.schema) == str(j.schema)
    np.testing.assert_allclose(t.column_values("scores"), j.column_values("scores"),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(t.column_values("label"), j.column_values("label"))


def test_params_from_jax_rejects_wrong_layouts():
    w = np.zeros((784, 10), np.float32)
    with pytest.raises(ValueError, match="features, classes"):
        tlogreg.params_from_jax({"w": w, "b": np.zeros(9, np.float32)})
    with pytest.raises(ValueError, match="dtypes"):
        tlogreg.params_from_jax({"w": w, "b": np.zeros(10, np.float64)})
    with pytest.raises(ValueError, match="keys"):
        tlogreg.params_from_jax({"w": w})

