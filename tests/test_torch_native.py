"""The port's native row pass (``tensorframes_tpu_torch/native``, the
reference's ``rowpack.cpp`` built by the port's own loader) against the
JAX package's build of the same source, and against the port's
pure-Python paths under ``TFS_TPU_DISABLE_NATIVE=1``.

Tolerances: exact — buffers byte for byte, codes and uniques, row dicts
and the Python types of their cells, error types; a failed or damaged
build raises, naming the compiler's log.
"""

import numpy as np
import pytest

import tensorframes_tpu as tfs
import tensorframes_tpu_torch as tft
from tensorframes_tpu import native as jnative
from tensorframes_tpu_torch import native as tnative
from tensorframes_tpu_torch.ops import keys as tkeys
from tensorframes_tpu_torch.ops.verbs import _stack_group

pytestmark = pytest.mark.skipif(
    not jnative.available(), reason="the reference's native build is unavailable"
)


@pytest.fixture()
def pure(monkeypatch):
    monkeypatch.setenv("TFS_TPU_DISABLE_NATIVE", "1")
    assert not tnative.available()


def _rows(n=257, seed=0):
    rng = np.random.default_rng(seed)
    return [{"d": float(rng.standard_normal()), "f": np.float32(rng.standard_normal()),
             "i": np.int32(rng.integers(-9, 9)), "l": int(rng.integers(-2**40, 2**40))}
            for _ in range(n)]


@pytest.mark.parametrize("col,dtype", [("d", np.float64), ("f", np.float32),
                                       ("i", np.int32), ("l", np.int64)])
def test_gather_column_matches_reference(col, dtype):
    rows = _rows()
    t = tnative.gather_column(rows, col, dtype)
    j = jnative.gather_column(rows, col, dtype)
    assert t.dtype == j.dtype == np.dtype(dtype)
    assert t.tobytes() == j.tobytes()
    np.testing.assert_array_equal(t, np.asarray([r[col] for r in rows], dtype))


@pytest.mark.parametrize("bad,dtype,exc", [
    ([{"x": 1.0}, {"y": 2.0}], np.float64, KeyError),
    ([{"x": 2**40}], np.int32, OverflowError),
    ([{"x": "nope"}], np.float64, TypeError),
])
def test_gather_column_errors_match(bad, dtype, exc):
    for mod in (jnative, tnative):
        with pytest.raises(exc):
            mod.gather_column(bad, "x", dtype)


def test_columns_to_rows_matches_reference():
    names = ["a", "b", "c", "d"]
    arrays = [np.arange(9, dtype=np.float64) / 3, np.arange(9, dtype=np.int64) - 4,
              np.arange(9, dtype=np.float32), np.arange(9, dtype=np.int32)]
    t = tnative.columns_to_rows(names, arrays)
    j = jnative.columns_to_rows(names, arrays)
    assert t == j
    assert [type(v) for v in t[0].values()] == [type(v) for v in j[0].values()]
    assert tnative.columns_to_rows(names, [np.zeros(3, np.int8)] * 4) is None
    assert tnative.columns_to_rows([], []) is None


def test_parse_csv_matches_reference():
    body = b"1,2.5,x\n-3,,y\r\n40,1e3,\n7,-0.0,z"
    t = tnative.parse_csv(body, ",", [3, 0, 4])
    j = jnative._load().parse_csv(body, ord(","), [3, 0, 4])
    assert t[-1] == j[-1] == 4
    assert bytes(t[0]) == bytes(j[0]) and bytes(t[1]) == bytes(j[1])
    assert t[2] == j[2]
    with pytest.raises(TypeError):
        tnative.parse_csv(b"1,2\n", ",", ["not-an-int", 1])


def test_dict_encode_matches_reference():
    rng = np.random.default_rng(3)
    cells = list(np.array(["b", "a", "c", "a", 3, 2.5], object)[rng.integers(0, 6, 4000)])
    tc, tu = tnative.dict_encode(cells)
    jc, ju = jnative.dict_encode(cells)
    assert tu == ju
    np.testing.assert_array_equal(tc, jc)
    with pytest.raises(TypeError):
        tnative.dict_encode([["unhashable"], "x"])


@pytest.mark.parametrize("use_native", [True, False], ids=["native", "pure"])
def test_unique_inverse_matches_reference(use_native, monkeypatch):
    """The key encode of the aggregate and the relational ops gives the
    reference's uniques and codes through the native hash pass and
    through the pure path: string labels, mixed types, NaN keys (one
    group)."""
    from tensorframes_tpu.ops import keys as jkeys

    if not use_native:
        monkeypatch.setenv("TFS_TPU_DISABLE_NATIVE", "1")
    rng = np.random.default_rng(4)
    labels = np.array(["pear", "apple", "fig"], object)[rng.integers(0, 3, 3000)]
    mixed = np.empty(6, object)
    mixed[:] = ["b", 2, "a", 2, float("nan"), float("nan")]
    for a in (labels, mixed, np.asarray(["pear", "apple", "fig", "apple"])):
        tu, ti = tkeys._unique_inverse(a)
        ju, ji = jkeys._unique_inverse(a)
        assert [repr(x) for x in tu] == [repr(x) for x in ju]
        np.testing.assert_array_equal(ti, ji)


def test_stack_cells_matches_reference_and_np_stack():
    rng = np.random.default_rng(0)
    for dtype, shape in [(np.float32, (8,)), (np.float64, (3, 4)), (np.int64, ()),
                         (np.int8, (5, 2, 2))]:
        cells = [np.ascontiguousarray(rng.standard_normal(shape).astype(dtype))
                 for _ in range(7)]
        t = tnative.stack_cells(cells)
        assert t.tobytes() == jnative.stack_cells(cells).tobytes()
        np.testing.assert_array_equal(t, np.stack(cells))
    for bad in ([np.zeros((2, 6), np.float32), np.zeros((3, 4), np.float32)],
                [np.zeros(4, np.float32), np.zeros(4, np.int32)]):
        with pytest.raises(ValueError):
            tnative.stack_cells(bad)
    # the verbs' stack: np.stack where the pass does not take the cells
    base = np.arange(24, dtype=np.float32).reshape(4, 6)
    cells = [np.ascontiguousarray(base[0, ::2]), base[1, ::2],
             np.ascontiguousarray(base[2, ::2])]
    np.testing.assert_array_equal(_stack_group(cells, [0, 1, 2]), np.stack(cells))
    mixed = [np.zeros(3, np.float32), np.ones(3, np.float64)]
    got = _stack_group(mixed, [0, 1])
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, np.stack(mixed))


def _frame_rows():
    rng = np.random.default_rng(9)
    return [{"x": float(i) / 7, "n": int(rng.integers(-5, 5)), "i": np.int32(i),
             "s": f"r{i % 5}", "v": [float(i), 1.0], "m": (i if i % 9 else float(i))}
            for i in range(103)]


@pytest.mark.parametrize("use_native", [True, False], ids=["native", "pure"])
def test_frame_from_rows_and_collect_match_reference(use_native, monkeypatch):
    """``frame_from_rows`` (scalar columns gathered natively; strings,
    vectors and a mixed int/float column on the per-cell path) and
    ``collect`` (all-scalar blocks scattered natively) give the
    reference's schema, storage and rows, with the native pass and
    without."""
    if not use_native:
        monkeypatch.setenv("TFS_TPU_DISABLE_NATIVE", "1")
    rows = _frame_rows()
    tf = tft.frame_from_rows(rows, num_blocks=4)
    jf = tfs.frame_from_rows(rows, num_blocks=4)
    assert [(c.name, c.dtype.name, tuple(c.block_shape.dims)) for c in tf.schema] == \
        [(c.name, c.dtype.name, tuple(c.block_shape.dims)) for c in jf.schema]
    for tb, jb in zip(tf.blocks(), jf.blocks()):
        for c in jb:
            assert type(tb[c]) is type(jb[c]), c
    scalars = tf.select(["x", "n", "i"]).collect()
    assert scalars == jf.select(["x", "n", "i"]).collect()
    assert [type(v) for v in scalars[0].values()] == [float, int, int]
    for a, b in zip(tf.collect(), jf.collect()):
        assert a.keys() == b.keys()
        for c in a:
            np.testing.assert_array_equal(a[c], b[c])


def test_disabled_is_the_pure_path(pure):
    assert tnative.gather_column([{"a": 1}], "a", np.int64) is None
    assert tnative.columns_to_rows(["a"], [np.zeros(2)]) is None
    assert tnative.dict_encode(["a"]) is None
    assert tnative.stack_cells([np.zeros(2)]) is None
    assert tnative.parse_csv(b"1\n", ",", [3]) is None


def test_failed_build_raises_naming_the_log(tmp_path, monkeypatch):
    """A source g++ refuses raises ``RuntimeError`` naming the log, which
    holds the compiler's message; nothing falls back."""
    src = tmp_path / "rowpack.cpp"
    src.write_text(tnative.SOURCE.read_text() + "\nthis is not C++;\n")
    monkeypatch.setattr(tnative, "SOURCE", src)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tnative, "_mod", None)
    with pytest.raises(RuntimeError) as info:
        tnative.available()
    log = tmp_path / "build" / "rowpack.log"
    assert str(log) in str(info.value)
    assert "error" in log.read_text()
    with pytest.raises(RuntimeError):
        tft.frame_from_rows([{"a": 1.0}])


def test_damaged_build_raises_then_rebuilds(tmp_path, monkeypatch):
    """A damaged library under the build's name raises on import (and is
    removed); the next call builds it again and loads."""
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tnative, "_mod", None)
    so = tnative._so_path()
    so.parent.mkdir(parents=True)
    so.write_bytes(b"\x7fELF not really a library")
    with pytest.raises(RuntimeError, match="failed to import") as info:
        tnative.available()
    assert str(tmp_path / "build" / "rowpack.log") in str(info.value)
    assert not so.exists()
    assert tnative.available()
    assert so.exists()
    np.testing.assert_array_equal(
        tnative.gather_column([{"a": 3}, {"a": 4}], "a", np.int64), [3, 4])
