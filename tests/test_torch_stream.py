"""The streaming partitioner (``stream_chain``, ``SpilledFrame``,
``TensorFrame.spill_to``) and the result store, against the in-memory
chain and against the JAX package, on the CPU at small sizes made from a
seed.

Tolerances: exact. The chains compute integers (a map casting to int32,
a filter, keyed int32 sums), so a streamed fold equals the in-memory
chain bit for bit, keys and dtypes included; result-store entries are
byte-identical tables across the packages.
"""

import os
import pickle
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensorframes_tpu as tfs
import tensorframes_tpu_torch as tft
from tensorframes_tpu.blockstore import BlockStore as JBlockStore
from tensorframes_tpu.blockstore import ResultStore as JResultStore
from tensorframes_tpu.blockstore import stream_chain as jstream
from tensorframes_tpu_torch.blockstore import BlockStore, ResultStore, SpilledFrame, stream_chain
from tensorframes_tpu_torch.observability.metrics import REGISTRY

CPU = "cpu"


def _dataset(n=8_000, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 13, n), rng.integers(0, 100_000, n)


def _chunks(k, v, size=1000):
    for lo in range(0, len(k), size):
        yield {"k": k[lo:lo + size], "v": v[lo:lo + size]}


def _t_agg(f):
    with tft.with_graph():
        w = tft.block(f, "w", tf_name="w_input")
        return tft.aggregate(tft.reduce_sum(w, axis=0, name="w"), f.group_by("k"),
                             device=CPU)


def _t_mapfilter(f):
    g = tft.map_blocks(lambda v: {"w": (v * 3).to(torch.int32)}, f, device=CPU)
    return g.filter(lambda w: w > 150_000, device=CPU)


def _t_chain(f):
    return _t_agg(_t_mapfilter(f))


def _j_agg(f):
    with tfs.with_graph():
        w = tfs.block(f, "w", tf_name="w_input")
        return tfs.aggregate(tfs.reduce_sum(w, axis=0, name="w"), f.group_by("k"))


def _j_mapfilter(f):
    g = tfs.map_blocks(lambda v: {"w": (v * 3).astype(jnp.int32)}, f)
    return g.filter(lambda w: w > 150_000)


def _j_chain(f):
    return _j_agg(_j_mapfilter(f))


def _cols(frame, names=("k", "w")):
    return {c: frame.column_values(c) for c in names}


def _assert_cols_equal(a, b):
    assert list(a) == list(b)
    for c in a:
        assert a[c].dtype == b[c].dtype, (c, a[c].dtype, b[c].dtype)
        np.testing.assert_array_equal(a[c], b[c], err_msg=c)


@pytest.mark.parametrize("budget", [0, 1 << 14, 1 << 30])
def test_stream_fold_equals_in_memory_and_reference(budget, tmp_path):
    """A map → filter → keyed int32 sum streamed chunk by chunk and folded
    equals the same chain over the whole frame, and the JAX package's
    ``stream_chain``, bit for bit, at every resident budget."""
    k, v = _dataset()
    st = BlockStore(root=str(tmp_path / "t"), budget_bytes=budget)
    got = _cols(stream_chain(_chunks(k, v), chain_fn=_t_chain, fold_fn=_t_agg, store=st))
    assert st.resident_bytes <= max(budget, 0) or budget == 0
    mem = _cols(_t_chain(tft.frame_from_arrays({"k": k, "v": v}, num_blocks=20)))
    _assert_cols_equal(got, mem)
    assert got["w"].dtype == np.int32
    if budget == 1 << 14:  # the reference's leg once
        with JBlockStore(root=str(tmp_path / "j"), budget_bytes=budget) as jst:
            ref = _cols(jstream(_chunks(k, v), chain_fn=_j_chain, fold_fn=_j_agg, store=jst))
        _assert_cols_equal(got, ref)
    st.close()


def test_stream_without_fold_spills_and_reads_back(tmp_path):
    """Without ``fold_fn`` the result blocks spill as they land; the
    ``SpilledFrame`` reads back (memmap and CRC-checked) to the in-memory
    map/filter and to the reference's, in chunk order."""
    k, v = _dataset(seed=1)
    st = BlockStore(root=str(tmp_path / "t"), budget_bytes=1 << 14)
    sf = stream_chain(_chunks(k, v, 1500), chain_fn=_t_mapfilter, store=st)
    assert isinstance(sf, SpilledFrame)
    assert st.spilled_bytes > 0
    mem = _t_mapfilter(tft.frame_from_arrays({"k": k, "v": v}, num_blocks=5))
    names = ("k", "v", "w")
    _assert_cols_equal(_cols(sf.to_frame(mmap=True), names), _cols(mem, names))
    _assert_cols_equal(_cols(sf.to_frame(mmap=False), names), _cols(mem, names))
    assert sf.num_rows == mem.num_rows
    assert [len(b["k"]) for b in sf.iter_blocks()] == [
        len(b["k"]) for b in (_t_mapfilter(tft.frame_from_arrays(c, num_blocks=1)).blocks()[0]
                              for c in _chunks(k, v, 1500)) if len(b["k"])]
    with JBlockStore(root=str(tmp_path / "j"), budget_bytes=1 << 14) as jst:
        jsf = jstream(_chunks(k, v, 1500), chain_fn=_j_mapfilter, store=jst)
        _assert_cols_equal(_cols(sf.to_frame(), names), _cols(jsf.to_frame(), names))
        jsf.drop()
    sf.drop()
    assert st.spilled_bytes == 0
    st.close()


def test_stream_over_scan_csv_and_frame_sources(tmp_path):
    """The chip drill's shape at a small size: CSV parts scanned in
    chunks, streamed, folded, against the whole table read at once; a
    ``TensorFrame`` and a ``SpilledFrame`` as sources stream the same."""
    d = tmp_path / "parts"
    d.mkdir()
    rng = np.random.default_rng(2)
    ks, vs = [], []
    for i in range(4):
        k, v = rng.integers(0, 50, 1800), rng.integers(0, 100_000, 1800)
        ks.append(k)
        vs.append(v)
        (d / f"part-{i:04d}.csv").write_text(
            "k,v\n" + "".join(f"{a},{b}\n" for a, b in zip(k, v)))
    full = tft.frame_from_arrays({"k": np.concatenate(ks), "v": np.concatenate(vs)})
    mem = _cols(_t_chain(full))
    got = _cols(stream_chain(tft.scan_csv(str(d), rows_per_chunk=512), chain_fn=_t_chain,
                             fold_fn=_t_agg))
    _assert_cols_equal(got, mem)
    ref = _cols(jstream(tfs.io.scan_csv(str(d), rows_per_chunk=512), chain_fn=_j_chain,
                        fold_fn=_j_agg))
    _assert_cols_equal(got, ref)
    _assert_cols_equal(_cols(stream_chain(full.repartition(6), chain_fn=_t_chain,
                                          fold_fn=_t_agg)), mem)
    with BlockStore(root=str(tmp_path / "s"), budget_bytes=0) as st:
        sf = full.repartition(3).spill_to(st)
        _assert_cols_equal(_cols(stream_chain(sf, chain_fn=_t_chain, fold_fn=_t_agg)), mem)


def test_stream_errors_match_reference(tmp_path):
    """An empty source and a failing chunk raise as in the reference; an
    owned store is closed either way."""
    errs = []
    for fn in (stream_chain, jstream):
        with pytest.raises(ValueError) as info:
            fn(iter(()))
        errs.append(str(info.value))
    assert errs[0] == errs[1]

    def bad_chunks():
        yield {"k": np.arange(3), "v": np.arange(3)}
        raise OSError("disk went away")

    with pytest.raises(OSError, match="disk went away"):
        stream_chain(bad_chunks(), chain_fn=_t_chain, fold_fn=_t_agg)


def test_spill_to_and_back_matches_reference(tmp_path):
    """``TensorFrame.spill_to`` puts every block into the store and the
    handle rebuilds the frame (dense, string and vector columns) as the
    reference's does."""
    data = {"a": np.arange(1000, dtype=np.float64), "s": [f"n{i}" for i in range(1000)],
            "m": np.arange(3000, dtype=np.int32).reshape(1000, 3)}
    with BlockStore(root=str(tmp_path / "t"), budget_bytes=0) as st, \
            JBlockStore(root=str(tmp_path / "j"), budget_bytes=0) as jst:
        sf = tft.frame_from_arrays(dict(data), num_blocks=4).spill_to(st)
        jsf = tfs.frame_from_arrays(dict(data), num_blocks=4).spill_to(jst)
        assert sf.num_blocks == jsf.num_blocks == 4
        assert st.spilled_bytes == jst.spilled_bytes > 0
        back, jback = sf.to_frame(), jsf.to_frame()
        for c in ("a", "m"):
            assert back.column_values(c).tobytes() == jback.column_values(c).tobytes()
        assert list(back.column_values("s")) == data["s"]
        lazy = tft.map_blocks(lambda a: {"b": a * 2}, tft.frame_from_arrays(
            {"a": data["a"]}, num_blocks=2), device=CPU)
        np.testing.assert_array_equal(lazy.spill_to(st).to_frame().column_values("b"),
                                      data["a"] * 2)


def test_block_store_default_budget_is_the_config_knob(tmp_path):
    """A ``BlockStore()`` built without a budget takes
    ``config.block_budget_bytes`` (``TFTPU_BLOCK_BUDGET_MB``, 512 MB by
    default, the reference's); an explicit 0 stays disk-only."""
    from tensorframes_tpu.config import get_config as jcfg

    assert tft.get_config().block_budget_bytes == jcfg().block_budget_bytes == 512 << 20
    with BlockStore(root=str(tmp_path / "a")) as st:
        assert st.budget_bytes == 512 << 20
    prev = tft.get_config().block_budget_bytes
    tft.configure(block_budget_bytes=1 << 10)
    try:
        with BlockStore(root=str(tmp_path / "b")) as st:
            assert st.budget_bytes == 1 << 10
        with BlockStore(root=str(tmp_path / "c"), budget_bytes=0) as st:
            assert st.budget_bytes == 0
    finally:
        tft.configure(block_budget_bytes=prev)


# ---------------------------------------------------------------------------
# ResultStore
# ---------------------------------------------------------------------------

def _table():
    return {"k": np.arange(5, dtype=np.int64), "s": ["a", "b", "c", "d", "e"],
            "w": np.arange(5, dtype=np.int32) * 7}


def _counter(name):
    return int(next(m.value for m in REGISTRY.collect() if m.name == name))


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_result_store_entries_read_across_packages(writer, tmp_path):
    """An entry either package publishes loads in the other, the same
    bytes on disk; ``keys`` lists it; ``drop`` removes it."""
    root = str(tmp_path / "results")
    w, r = (ResultStore(root), JResultStore(root))[:: 1 if writer == "port" else -1]
    n = w.put("fp-r0123", _table())
    assert n == os.path.getsize(os.path.join(root, "fp-r0123.tbl"))
    table, corrupt = r.load("fp-r0123")
    assert not corrupt
    assert list(table) == ["k", "s", "w"]
    for c, v in _table().items():
        assert type(table[c]) is type(v)
        np.testing.assert_array_equal(table[c], v)
    assert r.keys() == w.keys() == ["fp-r0123"]
    assert r.load("missing") == (None, False)
    r.drop("fp-r0123")
    assert w.keys() == []


@pytest.mark.parametrize("damage", ["flip", "truncate", "magic", "not_a_table"])
def test_result_store_quarantines_damage(damage, tmp_path):
    """A flipped bit, a torn write, a foreign magic or a payload that is
    no table loads as ``(None, True)`` in both packages: the file moves to
    ``.corrupt`` and ``tftpu_resultstore_corrupt_total`` counts it."""
    for pkg_store in (ResultStore, JResultStore):
        st = pkg_store(str(tmp_path / pkg_store.__module__.split(".")[0]))
        st.put("key", _table())
        path = os.path.join(st.root, "key.tbl")
        blob = bytearray(open(path, "rb").read())
        if damage == "flip":
            blob[-3] ^= 0x10
        elif damage == "truncate":
            blob = blob[:-10]
        elif damage == "magic":
            blob[:5] = b"XXXX\x01"
        else:
            payload = pickle.dumps([1, 2, 3], protocol=4)
            blob = (bytearray(b"TFRS\x01") + bytearray(
                __import__("struct").pack("<IQ", zlib.crc32(payload), len(payload)))
                + bytearray(payload))
        open(path, "wb").write(bytes(blob))
        before = _counter("tftpu_resultstore_corrupt_total")
        assert st.load("key") == (None, True)
        if pkg_store is ResultStore:
            assert _counter("tftpu_resultstore_corrupt_total") == before + 1
        assert not os.path.exists(path)
        assert os.path.exists(path + ".corrupt")
        assert st.load("key") == (None, False)


def test_result_store_key_errors_match(tmp_path):
    errs = []
    for pkg_store in (ResultStore, JResultStore):
        with pytest.raises(ValueError) as info:
            pkg_store(str(tmp_path / "r")).put("bad/key", {})
        errs.append(str(info.value))
    assert errs[0] == errs[1]
