"""The single-process relational frame ops and the pandas verbs: the same
frames, made from numpy with a seed, through the JAX package's
``TensorFrame`` methods and the port's (``device="cpu"`` where the op
runs a program). Results are exact: rows, their order, dtypes and the
schema; errors are the same type with the same message. ``describe``'s
moments agree within 1e-12 relative (both compute in float64, the port
in another order); counts, min and max exactly.
"""

import math

import numpy as np
import pytest

import tensorframes_tpu as tfs
import tensorframes_tpu_torch as tft

CPU = {"device": "cpu"}
DESCRIBE_RTOL = 1e-12


def _kw(pkg):
    return CPU if pkg is tft else {}


def _assert_same(j, t):
    """The port's frame ``t`` equals the JAX package's ``j``: schema, and
    every row's cells with their dtypes, in order."""
    assert str(t.schema) == str(j.schema)
    rj, rt = j.collect(), t.collect()
    assert len(rj) == len(rt)
    for a, b in zip(rj, rt):
        assert list(a) == list(b)
        for k in a:
            va, vb = np.asarray(a[k]), np.asarray(b[k])
            assert va.dtype == vb.dtype, (k, va.dtype, vb.dtype)
            np.testing.assert_array_equal(va, vb, err_msg=k)
            if va.dtype.kind == "f":  # -0.0 and 0.0 in their places
                np.testing.assert_array_equal(np.signbit(va), np.signbit(vb), err_msg=k)


def _both(fn):
    """``fn(pkg)`` for the JAX package, then the port."""
    return fn(tfs), fn(tft)


def _raises_alike(fn, exc=Exception):
    """``fn(pkg)`` raises, for both packages, the same type with the same
    message; returns the message."""
    msgs = []
    for pkg in (tfs, tft):
        with pytest.raises(exc) as ei:
            out = fn(pkg)
            if isinstance(out, (tfs.TensorFrame, tft.TensorFrame)):
                out.blocks()
        msgs.append((type(ei.value).__name__, str(ei.value)))
    assert msgs[0] == msgs[1]
    return msgs[1][1]


def _data(n=240, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "k": rng.integers(0, 12, n),
        "x": rng.standard_normal(n).astype(np.float32),
        "i": rng.integers(-50, 50, n).astype(np.int32),
        "s": [f"s{v}" for v in rng.integers(0, 5, n)],
        "v": rng.standard_normal((n, 3)),
    }


def _frame(pkg, data=None, num_blocks=3):
    return pkg.frame_from_arrays(dict(data if data is not None else _data()),
                                 num_blocks=num_blocks)


# ---------------------------------------------------------------------------
# take / first / select / limit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [0, 1, 79, 80, 81, 500])
def test_take(n):
    j, t = _both(lambda pkg: _frame(pkg).take(n))
    assert len(j) == len(t) == min(n, 240)
    for a, b in zip(j, t):
        assert list(a) == list(b)
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))
            assert type(a[k]) is type(b[k])


def test_first_and_first_of_empty():
    j, t = _both(lambda pkg: _frame(pkg).first())
    assert list(j) == list(t)
    for k in j:
        np.testing.assert_array_equal(np.asarray(j[k]), np.asarray(t[k]))
        assert type(j[k]) is type(t[k])
    msg = _raises_alike(lambda pkg: _frame(pkg).limit(0).first(), ValueError)
    assert msg == "Frame is empty"


@pytest.mark.parametrize("names", [["x"], ["s", "k"], ["v", "i", "x"]])
def test_select(names):
    _assert_same(*_both(lambda pkg: _frame(pkg).select(names)))
    # a lazy parent, too
    _assert_same(*_both(lambda pkg: _frame(pkg).sort_values("x").select(names)))


def test_select_unknown_column():
    _raises_alike(lambda pkg: _frame(pkg).select(["nope"]), KeyError)


@pytest.mark.parametrize("n", [0, 1, 80, 81, 239, 240, 1000])
def test_limit(n):
    _assert_same(*_both(lambda pkg: _frame(pkg).limit(n)))


def test_limit_negative():
    msg = _raises_alike(lambda pkg: _frame(pkg).limit(-1), ValueError)
    assert "limit must be >= 0" in msg


# ---------------------------------------------------------------------------
# filter
# ---------------------------------------------------------------------------

def _pred(pkg):
    lib = __import__("jax.numpy" if pkg is tfs else "torch", fromlist=["x"])
    return lambda x, i: {"m": lib.logical_and(x > 0.0, i < 20)}


@pytest.mark.parametrize("num_blocks", [1, 3, 7])
def test_filter_function_predicate(num_blocks):
    _assert_same(*_both(lambda pkg: _frame(pkg, num_blocks=num_blocks)
                        .filter(_pred(pkg), **_kw(pkg))))


def test_filter_dsl_predicate_and_chained_ops():
    def run(pkg):
        df = _frame(pkg)
        with pkg.with_graph():
            x = pkg.block(df, "x")
            pred = pkg.apply_fn(lambda v: v > 0.5, x, name="keep")
            f = df.filter(pred, **_kw(pkg))
        return f.sort_values(["k", "x"]).limit(30)

    _assert_same(*_both(run))


def test_filter_keeps_nothing_and_everything():
    _assert_same(*_both(lambda pkg: _frame(pkg).filter(lambda x: {"m": x > 100.0},
                                                       **_kw(pkg))))
    _assert_same(*_both(lambda pkg: _frame(pkg).filter(lambda x: {"m": x < 100.0},
                                                       **_kw(pkg))))


def test_filter_errors():
    msg = _raises_alike(
        lambda pkg: _frame(pkg).filter(lambda x: {"m": x > 0, "n": x < 0}, **_kw(pkg)),
        ValueError)
    assert "exactly one output" in msg
    msg = _raises_alike(
        lambda pkg: _frame(pkg).filter(lambda x: {"m": x * 2}, **_kw(pkg)), ValueError)
    assert "must be bool[rows]" in msg


def test_filter_runs_its_predicate_through_map_blocks(monkeypatch):
    from tensorframes_tpu_torch.ops import verbs

    calls = []
    real = verbs.map_blocks
    monkeypatch.setattr(verbs, "map_blocks",
                        lambda *a, **k: calls.append(k.get("device")) or real(*a, **k))
    _frame(tft).filter(lambda x: {"m": x > 0}, device="cpu").blocks()
    assert calls == ["cpu"]


# ---------------------------------------------------------------------------
# sort_values
# ---------------------------------------------------------------------------

def _sort_data():
    x = np.array([1.5, np.nan, -0.0, 0.0, 2.0, np.nan, -1.0, 0.0, 1.5, -0.0, 3.0, 2.0],
                 np.float64)
    k = np.array([2, 1, 1, 2, 0, 0, 1, 1, 2, 0, 2, 2], np.int64)
    s = ["b", "a", "c", "b", "a", "c", "a", "b", "c", "a", "b", "a"]
    return {"k": k, "x": x, "s": s, "id": np.arange(12, dtype=np.int32)}


@pytest.mark.parametrize("by,ascending", [
    ("x", True), ("x", False), ("k", True), ("k", False), ("s", True), ("s", False),
    (["k", "x"], True), (["k", "x"], [True, False]), (["x", "k"], [False, True]),
    (["s", "x"], [False, False]), (["k", "s", "x"], [True, False, True]),
])
def test_sort_values(by, ascending):
    _assert_same(*_both(lambda pkg: _frame(pkg, _sort_data(), num_blocks=3)
                        .sort_values(by, ascending=ascending)))


@pytest.mark.parametrize("by", ["k", "x", ["k", "i"]])
def test_sort_values_random_frame(by):
    _assert_same(*_both(lambda pkg: _frame(pkg).sort_values(by)))


def test_sort_values_errors():
    msg = _raises_alike(lambda pkg: _frame(pkg).sort_values(["k", "x"], ascending=[True]),
                        ValueError)
    assert msg == "ascending has 1 entries for 2 sort keys"
    msg = _raises_alike(lambda pkg: _frame(pkg).sort_values("v"), ValueError)
    assert "key column 'v' has non-scalar cells" in msg
    _raises_alike(lambda pkg: _frame(pkg).sort_values("nope"), KeyError)


# ---------------------------------------------------------------------------
# join
# ---------------------------------------------------------------------------

def _join_sides(key_kind):
    rng = np.random.default_rng(7)
    lk = rng.integers(0, 15, 60)
    rk = np.concatenate([rng.integers(5, 25, 30), [6, 6, 7]])  # duplicate right keys
    if key_kind == "str":
        lk = [f"key{v}" for v in lk]
        rk = [f"key{v}" for v in rk]
    left = {"k": lk, "a": rng.standard_normal(60), "c": rng.integers(0, 9, 60).astype(np.int32),
            "t": [f"l{v}" for v in range(60)]}
    right = {"k": rk, "b": rng.standard_normal((len(rk), 2)).astype(np.float32),
             "c": rng.integers(0, 9, len(rk)).astype(np.int64)}
    return left, right


@pytest.mark.parametrize("key_kind", ["int", "str"])
@pytest.mark.parametrize("how", ["inner", "left", "right", "outer"])
def test_join(how, key_kind):
    left, right = _join_sides(key_kind)

    def run(pkg):
        fill = None if how == "inner" else {"a": -1.0, "b": 0.0, "c": -7, "t": "none"}
        return _frame(pkg, left, 2).join(_frame(pkg, right, 2), on="k", how=how,
                                         fill_value=fill)

    j, t = _both(run)
    _assert_same(j, t)
    assert "c_x" in t.schema.names and "c_y" in t.schema.names


@pytest.mark.parametrize("how", ["inner", "left", "outer"])
def test_join_multi_key_suffixes_and_scalar_fill(how):
    rng = np.random.default_rng(3)
    left = {"k1": rng.integers(0, 4, 40), "k2": rng.integers(0, 3, 40),
            "v": rng.integers(0, 100, 40)}
    right = {"k1": rng.integers(0, 5, 25), "k2": rng.integers(0, 3, 25),
             "v": rng.integers(0, 100, 25)}

    def run(pkg):
        return _frame(pkg, left, 3).join(_frame(pkg, right, 2), on=["k1", "k2"], how=how,
                                         suffixes=("_l", "_r"),
                                         fill_value=None if how == "inner" else -1)

    _assert_same(*_both(run))


@pytest.mark.parametrize("how", ["inner", "left", "right", "outer"])
def test_join_with_an_empty_side(how):
    left, right = _join_sides("int")
    fill = None if how == "inner" else {"a": -1.0, "b": 0.0, "c": -7, "t": "none"}
    for empty_left in (True, False):
        def run(pkg):
            lf, rf = _frame(pkg, left, 2), _frame(pkg, right, 2)
            if empty_left:
                lf = lf.limit(0)
            else:
                rf = rf.limit(0)
            return lf.join(rf, on="k", how=how, fill_value=fill)

        _assert_same(*_both(run))


@pytest.mark.parametrize("how,fill,exc", [
    ("cross", None, ValueError),
    ("left", None, ValueError),
    ("outer", None, ValueError),
    ("right", None, ValueError),
    ("left", {"a": 1.0}, ValueError),
    ("outer", {"b": 0.0, "c": 1}, ValueError),
    ("right", {"b": 0.0}, ValueError),
    ("left", {"b": 0.0, "c": -1.5}, ValueError),
    ("left", {"b": 0.0, "c": math.nan}, ValueError),
    ("left", 2.5, ValueError),
])
def test_join_fill_value_errors(how, fill, exc):
    left, right = _join_sides("int")
    msg = _raises_alike(lambda pkg: _frame(pkg, left, 2).join(
        _frame(pkg, right, 2), on="k", how=how, fill_value=fill), exc)
    assert msg


def test_join_unknown_key():
    left, right = _join_sides("int")
    _raises_alike(lambda pkg: _frame(pkg, left).join(_frame(pkg, right), on="a"), KeyError)


# ---------------------------------------------------------------------------
# drop_duplicates / distinct
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("subset", [None, "k", ["k"], ["s"], ["k", "s"], ["x"]])
def test_drop_duplicates(subset):
    data = _data(120)
    data["x"] = np.round(data["x"], 0)
    data["x"][::7] = np.nan  # NaNs compare equal: one survivor
    data["x"][3::11] = -0.0
    data.pop("v")
    _assert_same(*_both(lambda pkg: _frame(pkg, data).drop_duplicates(subset)))


def test_distinct():
    rows = {"a": np.array([1, 2, 1, 2, 3, 1]), "b": ["x", "y", "x", "z", "x", "x"]}
    _assert_same(*_both(lambda pkg: _frame(pkg, rows, 2).distinct()))


def test_drop_duplicates_errors_and_empty():
    msg = _raises_alike(lambda pkg: _frame(pkg).drop_duplicates(["v"]), ValueError)
    assert "pass subset= naming scalar columns" in msg
    _raises_alike(lambda pkg: _frame(pkg).drop_duplicates("nope"), KeyError)
    _assert_same(*_both(lambda pkg: _frame(pkg).limit(0).drop_duplicates("k")))


# ---------------------------------------------------------------------------
# renames, repartition, cache
# ---------------------------------------------------------------------------

def test_with_column_renamed_and_alias_column():
    _assert_same(*_both(lambda pkg: _frame(pkg).with_column_renamed("x", "y")))
    _assert_same(*_both(lambda pkg: _frame(pkg).with_column_renamed("nope", "y")))
    _assert_same(*_both(lambda pkg: _frame(pkg).alias_column("v", "w")))
    _raises_alike(lambda pkg: _frame(pkg).alias_column("nope", "w"), KeyError)


@pytest.mark.parametrize("num_blocks", [1, 2, 5, 300])
def test_repartition(num_blocks):
    j, t = _both(lambda pkg: _frame(pkg).repartition(num_blocks))
    _assert_same(j, t)
    assert t.num_blocks == j.num_blocks
    assert [len(b["k"]) for b in t.blocks()] == [len(b["k"]) for b in j.blocks()]


def test_cache_materializes_once():
    calls = []
    f = tft.map_blocks(lambda x: {"z": calls.append(1) or x + 1}, _frame(tft), device="cpu")
    assert not f.is_materialized
    analysis = len(calls)  # the program's shape analysis
    assert f.cache() is f and f.is_materialized
    f.cache()
    f.collect()
    assert len(calls) - analysis == 3  # one program call per block, once


# ---------------------------------------------------------------------------
# GroupedData.count / describe
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("keys", [("k",), ("s",), ("k", "s")])
def test_grouped_count(keys):
    _assert_same(*_both(lambda pkg: _frame(pkg).group_by(*keys).count(**_kw(pkg))))


def test_grouped_count_takes_the_segment_route(monkeypatch):
    from tensorframes_tpu_torch.ops import verbs

    seen = []
    real = verbs._host_fast_aggregate
    monkeypatch.setattr(verbs, "_host_fast_aggregate",
                        lambda *a: seen.append([op for _, op, _ in a[2]]) or real(*a))
    _frame(tft).group_by("k").count(device="cpu")
    assert seen == [["reduce_sum"]]


def _describe_close(j, t):
    assert list(j) == list(t)
    for c in j:
        assert list(j[c]) == list(t[c])
        assert j[c]["count"] == t[c]["count"]
        for stat in ("min", "max"):
            np.testing.assert_equal(t[c][stat], j[c][stat])
        for stat in ("mean", "std"):
            np.testing.assert_allclose(t[c][stat], j[c][stat], rtol=DESCRIBE_RTOL)


@pytest.mark.parametrize("num_blocks", [1, 4])
def test_describe(num_blocks):
    data = _data()
    data["x"] = (data["x"] * 1e3 + 1e6).astype(np.float32)  # |mean| >> std
    data["b"] = data["i"] > 0
    j = tfs.describe(_frame(tfs, data, num_blocks))
    t = tft.describe(_frame(tft, data, num_blocks), device="cpu")
    _describe_close(j, t)
    assert set(t) == {"k", "x", "i", "b"}
    _describe_close(tfs.describe(_frame(tfs, data), ["x"]),
                    tft.describe(_frame(tft, data), ["x"], device="cpu"))


def test_describe_empty_and_errors():
    j = tfs.describe(_frame(tfs).limit(0))
    t = tft.describe(_frame(tft).limit(0), device="cpu")
    assert list(j) == list(t)
    for c in j:
        assert t[c]["count"] == 0 and all(math.isnan(t[c][s]) for s in ("mean", "std"))
    for cols in (["v"], ["s"]):
        msgs = []
        for pkg in (tfs, tft):
            with pytest.raises(ValueError) as ei:
                pkg.describe(_frame(pkg), cols, **_kw(pkg))
            msgs.append(str(ei.value))
        assert msgs[0] == msgs[1]
    assert tft.describe(_frame(tft, {"s": ["a", "b"]}), device="cpu") == {}


# ---------------------------------------------------------------------------
# pandas verbs, frame_from_pandas, to_pandas
# ---------------------------------------------------------------------------

def test_pandas_round_trip():
    pd = pytest.importorskip("pandas")
    pdf = pd.DataFrame({"x": np.arange(5.0), "i": np.arange(5, dtype=np.int32),
                        "s": list("abcde")})
    j, t = tfs.frame_from_pandas(pdf, num_blocks=2), tft.frame_from_pandas(pdf, num_blocks=2)
    _assert_same(j, t)
    pj, pt = j.to_pandas(), t.to_pandas()
    pd.testing.assert_frame_equal(pj, pt)
    pd.testing.assert_frame_equal(
        _frame(tfs).select(["k", "x", "s"]).to_pandas(),
        _frame(tft).select(["k", "x", "s"]).to_pandas())


@pytest.mark.parametrize("verb", ["map_blocks", "map_rows"])
def test_pandas_verbs(verb):
    pd = pytest.importorskip("pandas")
    pdf = pd.DataFrame({"x": [1.0, 2.0, 3.0], "y": [4.0, 5.0, 6.0]})
    outs = []
    for pkg in (tfs, tft):
        with pkg.with_graph():
            ph = pkg.placeholder("float64", [None], name="x")
            z = pkg.add(ph, 1.0, name="z")
            outs.append(getattr(pkg, verb)(z, pdf, **_kw(pkg)))
    assert isinstance(outs[1], pd.DataFrame)
    pd.testing.assert_frame_equal(outs[0], outs[1])
    assert outs[1]["z"].tolist() == [2.0, 3.0, 4.0]
    assert list(pdf.columns) == ["x", "y"]  # the caller's frame is untouched
