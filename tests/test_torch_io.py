"""The data path's readers and writers against the JAX package's: the same
files through ``tensorframes_tpu.io`` and ``tensorframes_tpu_torch.io`` on
the CPU, a few parts of a few thousand rows each, made from a seed.

Tolerances: exact everywhere — schemas (names, dtype names, block shapes),
values (NaN where the reference has NaN), host cells, error types and
whole error texts, part signatures, written bytes; ``save_frame``
directories load bit for bit in the other package.
"""

import os
import threading

import numpy as np
import pytest

import tensorframes_tpu as tfs
import tensorframes_tpu_torch as tft
from tensorframes_tpu import io as jio
from tensorframes_tpu_torch import io as tio

PKGS = (("jax", jio), ("torch", tio))


def _schema(frame):
    return [(c.name, c.dtype.name, tuple(c.block_shape.dims)) for c in frame.schema]


def _assert_same_frame(jf, tf):
    assert _schema(tf) == _schema(jf)
    assert tf.num_rows == jf.num_rows
    for info in jf.schema:
        jv, tv = jf.column_values(info.name), tf.column_values(info.name)
        if jv.dtype == object:
            assert tv.tolist() == jv.tolist(), info.name
            continue
        assert tv.dtype == jv.dtype, (info.name, tv.dtype, jv.dtype)
        assert tv.shape == jv.shape
        # bit for bit (NaN payloads included)
        assert tv.tobytes() == jv.tobytes(), info.name


def _both(fn):
    """``fn(io_module)`` in each package: (result or exception) pairs."""
    out = []
    for _, mod in PKGS:
        try:
            out.append(fn(mod))
        except Exception as e:  # noqa: BLE001 - compared whole by callers
            out.append(e)
    return out


def _assert_same_error(j, t):
    assert isinstance(j, Exception) and isinstance(t, Exception), (j, t)
    assert (type(t).__name__, str(t)) == (type(j).__name__, str(j))


def _write(path, text):
    with open(path, "w", newline="") as f:
        f.write(text)
    return str(path)


def _numeric_csv(path, n, seed, delimiter=",", with_gaps=False):
    rng = np.random.default_rng(seed)
    k = rng.integers(-500, 500, n)
    v = rng.standard_normal(n).round(3)
    s = [f"s{int(x) % 17}" for x in rng.integers(0, 1000, n)]
    lines = [delimiter.join(("k", "v", "s"))]
    for i in range(n):
        vv = "" if with_gaps and i % 7 == 3 else repr(float(v[i]))
        lines.append(delimiter.join((str(k[i]), vv, s[i])))
    return _write(path, "\n".join(lines) + "\n")


CSV_CASES = {
    "unquoted": lambda p: _numeric_csv(p / "a.csv", 3000, 1),
    "gaps": lambda p: _numeric_csv(p / "a.csv", 3000, 2, with_gaps=True),
    "tab": lambda p: _numeric_csv(p / "a.tsv", 2000, 3, delimiter="\t"),
    "quoted": lambda p: _write(p / "a.csv", 'name,"v, w",n\n"a,b",1.5,3\n"c ""d""",2.5,4\n'
                               "plain,,5\n"),
    "crlf": lambda p: _write(p / "a.csv", "a,b\r\n1,2.5\r\n3,4\r\n"),
    "header_only": lambda p: _write(p / "a.csv", "a,b,c\n"),
    "strings": lambda p: _write(p / "a.csv", "x,y\n1,abc\n2,\n3,1e3\n"),
}


@pytest.mark.parametrize("native", [True, False], ids=["native", "pure"])
@pytest.mark.parametrize("case", sorted(CSV_CASES))
def test_read_csv_matches_reference(case, native, tmp_path, monkeypatch):
    """One file per case read by both packages, the port with its native
    parse and with ``TFS_TPU_DISABLE_NATIVE=1``: the same schema and
    values, bit for bit."""
    path = CSV_CASES[case](tmp_path)
    delimiter = "\t" if path.endswith(".tsv") else ","
    jf = jio.read_csv(path, delimiter=delimiter)
    if not native:
        monkeypatch.setenv("TFS_TPU_DISABLE_NATIVE", "1")
    tf = tio.read_csv(path, delimiter=delimiter)
    _assert_same_frame(jf, tf)


def test_read_csv_type_pinning_and_errors(tmp_path):
    """``dtypes=`` overrides inference per column (header-only parts
    too); an unsupported override and an unparseable pinned value raise
    the reference's error whole."""
    path = _numeric_csv(tmp_path / "a.csv", 500, 4)
    pins = {"k": "float64", "s": "string", "v": "string"}
    _assert_same_frame(jio.read_csv(path, dtypes=pins), tio.read_csv(path, dtypes=pins))
    head = _write(tmp_path / "h.csv", "a,b\n")
    pins = {"a": "int64", "b": "string"}
    _assert_same_frame(jio.read_csv(head, dtypes=pins), tio.read_csv(head, dtypes=pins))
    j, t = _both(lambda mod: mod.read_csv(path, dtypes={"k": "int32"}))
    _assert_same_error(j, t)
    bad = _write(tmp_path / "b.csv", "a\n1\nx2\n")
    for native in ("0", "1"):
        os.environ["TFS_TPU_DISABLE_NATIVE"] = native
        try:
            j, t = _both(lambda mod: mod.read_csv(bad, dtypes={"a": "int64"}))
        finally:
            del os.environ["TFS_TPU_DISABLE_NATIVE"]
        assert type(t) is type(j), (j, t)


def _parts(d, sizes, seed=0, key_kind="int"):
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(seed)
    paths = []
    for i, n in enumerate(sizes):
        k = rng.integers(0, 9, n)
        v = rng.integers(-1000, 1000, n)
        rows = [f"{('g' + str(a)) if key_kind == 'string' else a},{b}" for a, b in zip(k, v)]
        paths.append(_write(os.path.join(d, f"part-{i:04d}.csv"),
                            "k,v\n" + "".join(r + "\n" for r in rows)))
    return paths


@pytest.mark.parametrize("key_kind", ["int", "string"])
def test_scan_csv_part_manifest_and_part_frame(key_kind, tmp_path):
    """``scan_csv`` yields the same chunks in the same order (a
    header-only part contributes nothing, types pin from the first part
    with rows); ``part_manifest`` gives the same (path, signature) rows;
    ``part_frame`` the same frame; a directory ``read_csv`` ingests
    through the block store to the same frame."""
    d = str(tmp_path / "parts")
    paths = _parts(d, [0, 1500, 700, 2100], seed=5, key_kind=key_kind)
    _write(os.path.join(d, "_ignored.csv"), "junk\n")
    _write(os.path.join(d, "notes.md"), "not a part\n")
    jc = list(jio.scan_csv(d, rows_per_chunk=512))
    tc = list(tio.scan_csv(d, rows_per_chunk=512))
    assert len(tc) == len(jc) == 3 + 2 + 5
    for a, b in zip(jc, tc):
        assert list(a) == list(b)
        for c in a:
            if isinstance(a[c], list):
                assert b[c] == a[c]
            else:
                assert b[c].dtype == a[c].dtype
                np.testing.assert_array_equal(b[c], a[c])
    assert tio.part_manifest(d) == jio.part_manifest(d)
    assert [p for p, _ in tio.part_manifest(d)] == paths
    for p in paths:
        _assert_same_frame(jio.part_frame(p), tio.part_frame(p))
    _assert_same_frame(jio.read_csv(d), tio.read_csv(d))
    _assert_same_frame(jio.read_csv(paths[1:3]), tio.read_csv(paths[1:3]))
    _assert_same_frame(jio.read_csv(d, num_blocks=2), tio.read_csv(d, num_blocks=2))


def test_scan_errors_match(tmp_path):
    """Missing parts, an empty list, a directory without parts, an
    unknown manifest kind and a part whose schema drifts raise the
    reference's errors whole."""
    d = str(tmp_path / "parts")
    os.makedirs(d)
    for fn in (
        lambda mod: list(mod.scan_csv([str(tmp_path / "missing.csv")])),
        lambda mod: list(mod.scan_csv([])),
        lambda mod: list(mod.scan_csv(d)),
        lambda mod: mod.part_manifest(d, kind="orc"),
        lambda mod: mod.part_frame(str(tmp_path / "x.orc"), kind="orc"),
    ):
        j, t = _both(fn)
        _assert_same_error(j, t)
    _write(os.path.join(d, "part-0.csv"), "a,b\n1,2\n")
    _write(os.path.join(d, "part-1.csv"), "a,c\n1,2\n")
    j, t = _both(lambda mod: mod.read_csv(d))
    _assert_same_error(j, t)
    _write(os.path.join(d, "part-1.csv"), "a,b\n1,x\n")
    j, t = _both(lambda mod: mod.read_csv(d))
    assert type(t) is type(j), (j, t)


def test_header_only_directory_is_typed_empty_frame(tmp_path):
    d = str(tmp_path / "parts")
    _parts(d, [0, 0])
    _assert_same_frame(jio.read_csv(d), tio.read_csv(d))


def _rich_frame(pkg, n=2000, seed=7, num_blocks=3):
    rng = np.random.default_rng(seed)
    return pkg.frame_from_arrays({
        "i8": rng.integers(-128, 128, n).astype(np.int8),
        "i32": rng.integers(-2**31, 2**31 - 1, n).astype(np.int32),
        "i64": rng.integers(-2**62, 2**62, n),
        "f16": rng.standard_normal(n).astype(np.float16),
        "f32": rng.standard_normal(n).astype(np.float32),
        "f64": np.where(np.arange(n) % 11 == 0, np.nan, rng.standard_normal(n)),
        "b": rng.integers(0, 2, n).astype(bool),
        "vec": rng.standard_normal((n, 3)).astype(np.float32),
        "s": [f"row{i}" for i in range(n)],
    }, num_blocks=num_blocks)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_save_frame_loads_in_the_other_package(writer, tmp_path):
    """A directory ``save_frame`` writes in one package loads in the
    other bit for bit (dense columns of every frame dtype, a vector
    column, a string column, a ragged column), and resaving over it keeps
    one directory; ``TensorFrame.save`` is the same writer."""
    pkgs = {"jax": (tfs, jio), "torch": (tft, tio)}
    wpkg, wio = pkgs[writer]
    rpkg, rio = pkgs["torch" if writer == "jax" else "jax"]
    src = _rich_frame(wpkg)
    path = str(tmp_path / "frame") + "/"
    wio.save_frame(src, path)
    wio.save_frame(src, path)  # over an existing directory
    assert sorted(os.listdir(tmp_path)) == ["frame"]
    assert sorted(os.listdir(path)) == ["columns.npz", "frame.json", "host_columns.pkl"]
    back = rio.load_frame(path, num_blocks=2)
    _assert_same_frame(_rich_frame(rpkg), back)
    assert back.num_blocks == 2
    ragged = wpkg.frame_from_arrays({"r": [np.arange(i % 4 + 1, dtype=np.float32)
                                           for i in range(10)]})
    wpath = str(tmp_path / "ragged")
    ragged.save(wpath) if writer == "torch" else wio.save_frame(ragged, wpath)
    rb = rio.load_frame(wpath)
    assert _schema(rb) == _schema(ragged)
    for a, b in zip(ragged.collect(), rb.collect()):
        np.testing.assert_array_equal(a["r"], b["r"])


def test_save_frame_heals_a_crashed_swap_and_refuses_future_format(tmp_path):
    """A save that crashed between its two renames left only
    ``<path>.old``: load reads it and the next save heals it, as the
    reference does; a newer format version raises the reference's text."""
    path = str(tmp_path / "f")
    tio.save_frame(tft.frame_from_arrays({"x": np.arange(5)}), path)
    os.rename(path, path + ".old")
    assert tio.load_frame(path).column_values("x").tolist() == list(range(5))
    tio.save_frame(tft.frame_from_arrays({"x": np.arange(3)}), path)
    assert sorted(os.listdir(tmp_path)) == ["f"]
    import json

    with open(os.path.join(path, "frame.json")) as f:
        manifest = json.load(f)
    manifest["format_version"] = 99
    with open(os.path.join(path, "frame.json"), "w") as f:
        json.dump(manifest, f)
    j, t = _both(lambda mod: mod.load_frame(path))
    _assert_same_error(j, t)


def test_write_csv_round_trip(tmp_path):
    """``write_csv`` writes the reference's bytes, reads back to the
    same frame, and refuses vector columns with the reference's text."""
    data = {"k": np.arange(-5, 45), "v": np.linspace(-1, 1, 50),
            "s": [f"a,{i}" if i % 3 == 0 else f"x{i}" for i in range(50)]}
    jp, tp = str(tmp_path / "j.csv"), str(tmp_path / "t.csv")
    jio.write_csv(tfs.frame_from_arrays(dict(data)), jp)
    tio.write_csv(tft.frame_from_arrays(dict(data)), tp)
    assert open(tp, "rb").read() == open(jp, "rb").read()
    _assert_same_frame(jio.read_csv(jp), tio.read_csv(tp))
    assert tio.read_csv(tp).column_values("s").tolist() == data["s"]
    j, t = _both(lambda mod: mod.write_csv(
        (tfs if mod is jio else tft).frame_from_arrays({"m": np.zeros((4, 2))}),
        str(tmp_path / "m.csv")))
    _assert_same_error(j, t)


def test_arrow_both_ways():
    """``frame_to_arrow`` builds the reference's table; ``frame_from_arrow``
    of one table gives the same frame (list columns, strings, bool,
    floats with nulls); a null integer column raises the reference's
    text."""
    pa = pytest.importorskip("pyarrow")
    jt = jio.frame_to_arrow(_rich_frame(tfs, n=300))
    tt = tio.frame_to_arrow(_rich_frame(tft, n=300))
    assert tt.schema == jt.schema

    def cells(table, c):  # NaN compares equal to NaN here
        return [("nan" if isinstance(x, float) and x != x else x)
                for x in table.column(c).to_pylist()]

    for c in jt.column_names:
        assert cells(tt, c) == cells(jt, c), c
    table = pa.table({
        "i": pa.array(np.arange(6, dtype=np.int32)),
        "f": pa.array([1.0, None, 3.0, 4.0, None, 6.0]),
        "b": pa.array([True, False, True, True, False, False]),
        "s": pa.array(list("abcdef")),
        "l": pa.array([[1.0, 2.0]] * 6),
        "r": pa.array([[1], [1, 2], [3], [], [5, 6, 7], [8]]),
    })
    jf, tf = jio.frame_from_arrow(table), tio.frame_from_arrow(table)
    assert _schema(tf) == _schema(jf)
    for c in ("i", "f", "b", "s", "l"):
        np.testing.assert_array_equal(tf.column_values(c), jf.column_values(c))
    for a, b in zip(jf.collect(), tf.collect()):
        np.testing.assert_array_equal(a["r"], b["r"])
    j, t = _both(lambda mod: mod.frame_from_arrow(pa.table({"n": pa.array([1, None])})))
    _assert_same_error(j, t)


def test_parquet_both_ways(tmp_path):
    """A parquet file either package writes reads back in both to the
    same frame; a directory of parts scans into the same chunks and reads
    through the block store."""
    pytest.importorskip("pyarrow")
    jp, tp = str(tmp_path / "j.parquet"), str(tmp_path / "t.parquet")
    jio.write_parquet(_rich_frame(tfs, n=400), jp)
    tio.write_parquet(_rich_frame(tft, n=400), tp)
    for path in (jp, tp):
        _assert_same_frame(jio.read_parquet(path), tio.read_parquet(path))
    d = tmp_path / "pq"
    d.mkdir()
    for i in range(3):
        tio.write_parquet(tft.frame_from_arrays(
            {"k": np.arange(i * 100, i * 100 + 250), "v": np.arange(250) * 0.5}),
            str(d / f"part-{i}.parquet"))
    jc = list(jio.scan_parquet(str(d), rows_per_chunk=100))
    tc = list(tio.scan_parquet(str(d), rows_per_chunk=100))
    assert [len(c["k"]) for c in tc] == [len(c["k"]) for c in jc] == [100, 100, 50] * 3
    for a, b in zip(jc, tc):
        np.testing.assert_array_equal(b["k"], a["k"])
        np.testing.assert_array_equal(b["v"], a["v"])
    _assert_same_frame(jio.read_parquet(str(d)), tio.read_parquet(str(d)))
    p0 = str(d / "part-0.parquet")
    _assert_same_frame(jio.part_frame(p0, kind="parquet"), tio.part_frame(p0, kind="parquet"))
    assert tio.part_manifest(str(d), kind="parquet") == jio.part_manifest(str(d), kind="parquet")


def test_pipeline_iter_order_and_errors():
    """``pipeline_iter`` keeps the source's order through its stage,
    raises a source's exception after the items staged before it, and
    stops its worker when the consumer leaves early."""
    got = list(tio.pipeline_iter(range(50), stage=lambda x: x * x, size=3))
    assert got == [x * x for x in range(50)]
    assert list(tio.pipeline_iter(iter(()))) == []

    def failing():
        yield from range(5)
        raise KeyError("boom at 5")

    seen = []
    with pytest.raises(KeyError, match="boom at 5"):
        for x in tio.pipeline_iter(failing(), size=2):
            seen.append(x)
    assert seen == list(range(5))

    def stage_fail(x):
        if x == 3:
            raise ValueError("stage failed")
        return x

    seen = []
    with pytest.raises(ValueError, match="stage failed"):
        for x in tio.pipeline_iter(range(10), stage=stage_fail):
            seen.append(x)
    assert seen == [0, 1, 2]

    pulled = []

    def endless():
        i = 0
        while True:
            pulled.append(i)
            yield i
            i += 1

    before = threading.active_count()
    it = tio.pipeline_iter(endless(), size=2, thread_name="test-early-stop")
    assert [next(it) for _ in range(4)] == [0, 1, 2, 3]
    it.close()
    assert not any(t.name == "test-early-stop" for t in threading.enumerate())
    assert threading.active_count() <= before
    assert len(pulled) <= 4 + 2 + 2


def test_pyarrow_error_text_matches(monkeypatch):
    """Without pyarrow, the Parquet and Arrow entry points raise the
    reference's ``ImportError`` text."""
    import sys

    monkeypatch.setitem(sys.modules, "pyarrow", None)
    j, t = _both(lambda mod: list(mod.scan_parquet(".")))
    _assert_same_error(j, t)
    assert "pyarrow is required" in str(t)
