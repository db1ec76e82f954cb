"""Registered queries (``Server.register_query``, ``serving/query.py``) on
the port (``device="cpu"``) against the JAX package's endpoint and a numpy
oracle, over small growing directories of CSV parts made from a seed.

The JAX package's endpoints run with no ``compilation_cache_dir``: its own
``test_registered_query.py`` fails where its AOT store is armed, so each
test here runs its reference leg in the same test, with the cache off,
and compares against it. The port's persistent result store (restart
warm-up, a corrupt partial, invalidation) is held against numpy and the
port's own counters.

Tolerances: exact — every table bit for bit (keys, values, dtypes, in
canonical order), decline rows and error texts whole, counters exact.
"""

import json
import os
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensorframes_tpu as tfs
import tensorframes_tpu_torch as tft
from tensorframes_tpu.config import get_config as jget_config
from tensorframes_tpu.serving import QueryEndpoint as JQueryEndpoint
from tensorframes_tpu.serving import QuerySource as JQuerySource
from tensorframes_tpu.serving import query_cache_events as jevents
from tensorframes_tpu_torch.serving import (
    QUERY_DECLINE_REASONS,
    QueryEndpoint,
    QuerySource,
    RejectedError,
    Server,
    query_cache_events,
    serve_http,
)
from tensorframes_tpu_torch.validation import ValidationError

CPU = "cpu"


@pytest.fixture(autouse=True)
def _reference_cache_off():
    """The reference's leg runs with its compile cache (and so its
    result store) off; the port's cache dir starts empty."""
    jprev, tprev = jget_config().compilation_cache_dir, tft.get_config().compilation_cache_dir
    tfs.configure(compilation_cache_dir="")
    tft.configure(compilation_cache_dir="")
    yield
    tfs.configure(compilation_cache_dir=jprev)
    tft.configure(compilation_cache_dir=tprev)


@pytest.fixture()
def cache_dir(tmp_path):
    d = str(tmp_path / "cache")
    tft.configure(compilation_cache_dir=d)
    return d


def _write_chunk(data_dir, i, rows):
    path = os.path.join(data_dir, f"part-{i:04d}.csv")
    with open(path, "w") as fh:
        fh.write("k,v\n")
        for k, v in rows:
            fh.write(f"{k},{v}\n")
    return path


def _rows(n, seed, key_kind="int", dtype="int64"):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        g = int(rng.integers(0, 4))
        k = f"grp{g}" if key_kind == "string" else g
        v = int(rng.integers(-50, 50))
        out.append((k, v if dtype == "int64" else float(v) + 0.5))
    return out


_T_RED = {"sum": tft.reduce_sum, "min": tft.reduce_min, "max": tft.reduce_max,
          "mean": tft.reduce_mean}
_J_RED = {"sum": tfs.reduce_sum, "min": tfs.reduce_min, "max": tfs.reduce_max,
          "mean": tfs.reduce_mean}


def _t_build(op):
    def build(f):
        f1 = tft.map_blocks(lambda v: {"y": v * 2}, f, device=CPU)
        with tft.with_graph():
            y = tft.block(f1, "y", tf_name="y_input")
            return tft.aggregate([_T_RED[op](y, axis=0, name="y")], f1.group_by("k"),
                                 device=CPU)

    return build


def _j_build(op):
    def build(f):
        f1 = tfs.map_blocks(lambda v: {"y": v * 2}, f)
        with tfs.with_graph():
            y = tfs.block(f1, "y", tf_name="y_input")
            return tfs.aggregate([_J_RED[op](y, axis=0, name="y")], f1.group_by("k"))

    return build


def _oracle(data_dir, op, dtypes):
    """numpy over every part at once: the one-shot full-table query."""
    frames = [tft.io.part_frame(p, dtypes=dtypes) for p, _ in tft.io.part_manifest(data_dir)]
    k = np.concatenate([f.column_values("k") for f in frames if f.num_rows])
    y = np.concatenate([f.column_values("v") for f in frames if f.num_rows]) * 2
    keys = sorted(set(k.tolist()))
    fold = {"sum": np.sum, "min": np.min, "max": np.max,
            # a mean keeps the column's dtype: an integer mean truncates
            "mean": lambda a: np.trunc(a.sum() / len(a))}[op]
    vals = [fold(y[k == g]) for g in keys]
    return {"k": np.asarray(keys, dtype=k.dtype), "y": np.asarray(vals).astype(y.dtype)}


def _assert_tables_equal(got, want):
    assert list(got) == list(want)
    for c in want:
        g, w = np.asarray(got[c]), np.asarray(want[c])
        assert g.dtype == w.dtype, (c, g.dtype, w.dtype)
        assert g.tolist() == w.tolist(), c


@pytest.mark.parametrize("op,dtype,key_kind", [
    ("sum", "int64", "int"), ("sum", "int64", "string"), ("min", "float64", "string"),
    ("max", "int64", "int"), ("sum", "float64", "int"), ("mean", "int64", "string"),
])
def test_refresh_equals_full_recompute_and_reference(op, dtype, key_kind, tmp_path):
    """Appends (a header-only part among them) and an in-place rewrite:
    after each, the port's answer equals its own ``_execute_full``, the
    numpy oracle and the JAX package's endpoint over the same directory,
    bit for bit; eligibility and the counters equal the reference's."""
    data = str(tmp_path / "data")
    os.makedirs(data)
    for i, n in enumerate([7, 0, 23, 1]):
        _write_chunk(data, i, _rows(n, 100 + i, key_kind, dtype))
    q = QueryEndpoint(f"t-{op}-{dtype}-{key_kind}", QuerySource(path=data), _t_build(op))
    jq = JQueryEndpoint(f"j-{op}-{dtype}-{key_kind}", JQuerySource(path=data), _j_build(op))
    assert q._csv_dtypes == jq._csv_dtypes

    def check():
        got, ref = q.execute(), jq.execute()
        _assert_tables_equal(ref, _oracle(data, op, q._csv_dtypes))  # reference leg
        _assert_tables_equal(got, ref)
        from tensorframes_tpu_torch.plan.lower import canonical_table_order

        full = canonical_table_order(q._execute_full(tft.io.part_manifest(data)), ("k",))
        _assert_tables_equal(got, full)

    check()
    for i, n in enumerate([5, 0, 31], start=4):
        _write_chunk(data, i, _rows(n, 200 + i, key_kind, dtype))
        check()
    _write_chunk(data, 0, _rows(11, 999, key_kind, dtype))
    check()
    mine, ref = q.cache_stats(), jq.cache_stats()
    for key in ("hits", "misses", "invalidations", "chunks_folded", "chunks_executed",
                "recomputes", "cacheable", "incremental"):
        assert mine[key] == ref[key], key
    assert mine["incremental"] == (op in ("min", "max") or (op, dtype) == ("sum", "int64"))


def test_incremental_refresh_reexecutes_only_new_chunks(tmp_path):
    data = str(tmp_path / "data")
    os.makedirs(data)
    for i in range(6):
        _write_chunk(data, i, _rows(20, i, "string"))
    q = QueryEndpoint("inc", QuerySource(path=data), _t_build("sum"))
    q.execute()
    base = q.cache_stats()
    assert base["chunks_executed"] == 6
    _write_chunk(data, 6, _rows(20, 60, "string"))
    _assert_tables_equal(q.execute(), _oracle(data, "sum", q._csv_dtypes))
    cs = q.cache_stats()
    assert cs["chunks_executed"] == 7
    assert cs["chunks_folded"] - base["chunks_folded"] == 6
    assert cs["invalidations"] == 1 and cs["recomputes"]["cold"] == 2
    q.execute()
    cs2 = q.cache_stats()
    assert cs2["hits"] == cs["hits"] + 1
    assert (cs2["chunks_executed"], cs2["chunks_folded"]) == (
        cs["chunks_executed"], cs["chunks_folded"])


def test_decline_reasons_and_events_match_reference(tmp_path):
    """Each way a plan declines a cache level records the reference's
    evidence row, word for word; every declined endpoint still answers
    the reference's table (counted full recompute)."""
    data = str(tmp_path / "data")
    os.makedirs(data)
    _write_chunk(data, 0, _rows(25, 0, "string", "float64"))
    other = {"k": ["grp0", "grp1", "grp2", "grp3"], "w": np.arange(4.0)}

    def t_ck(f):
        f1 = tft.map_blocks(lambda v: {"k2": v > 0}, f, device=CPU)
        with tft.with_graph():
            v = tft.block(f1, "v", tf_name="v_input")
            return tft.aggregate([tft.reduce_min(v, axis=0, name="v")], f1.group_by("k2"),
                                 device=CPU)

    def j_ck(f):
        f1 = tfs.map_blocks(lambda v: {"k2": v > 0}, f)
        with tfs.with_graph():
            v = tfs.block(f1, "v", tf_name="v_input")
            return tfs.aggregate([tfs.reduce_min(v, axis=0, name="v")], f1.group_by("k2"))

    def t_join(f):
        g = f.join(tft.frame_from_arrays(dict(other)), on="k")
        with tft.with_graph():
            v = tft.block(g, "v", tf_name="v_input")
            return tft.aggregate([tft.reduce_min(v, axis=0, name="v")], g.group_by("k"),
                                 device=CPU)

    def j_join(f):
        g = f.join(tfs.frame_from_arrays(dict(other)), on="k")
        with tfs.with_graph():
            v = tfs.block(g, "v", tf_name="v_input")
            return tfs.aggregate([tfs.reduce_min(v, axis=0, name="v")], g.group_by("k"))

    cases = {
        "float": (_t_build("sum"), _j_build("sum")),
        "mean": (_t_build("mean"), _j_build("mean")),
        "ck": (t_ck, j_ck),
        "join": (t_join, j_join),
        "map": (lambda f: tft.map_blocks(lambda v: {"y": v * 3.0}, f, device=CPU),
                lambda f: tfs.map_blocks(lambda v: {"y": v * 3.0}, f)),
        "eager": (lambda f: _t_build("min")(f).cache(), lambda f: _j_build("min")(f).cache()),
    }
    names = {f"decl-{c}" for c in cases}
    for case, (tb, jb) in cases.items():
        q = QueryEndpoint(f"decl-{case}", QuerySource(path=data), tb)
        jq = JQueryEndpoint(f"decl-{case}", JQuerySource(path=data), jb)
        _assert_tables_equal(q.execute(), jq.execute())
        assert q.cache_stats()["recomputes"] == jq.cache_stats()["recomputes"]
        assert q.cache_stats()["recomputes"]["ineligible"] == 1

    def rows(events):
        return sorted((e["endpoint"], e["mode"], e["reason"], e["detail"])
                      for e in events if e["endpoint"] in names)

    mine = rows(query_cache_events())
    assert mine == rows(jevents())
    assert {r[2] for r in mine} == {"float_accumulation", "reduce_mean", "computed_key",
                                    "join", "no_terminal_aggregate", "eager"}
    assert set(QUERY_DECLINE_REASONS) >= {r[2] for r in mine}


def test_host_callback_declines_both_cache_levels(tmp_path):
    """A map that reads back to the host (``.item()``) is a host callback
    in the port's plan layer: both cache levels decline with the
    reference's reason, and every request recomputes exactly."""
    data = str(tmp_path / "data")
    os.makedirs(data)
    _write_chunk(data, 0, _rows(12, 1))

    from tensorframes_tpu_torch import dtypes as tdt
    from tensorframes_tpu_torch.program import Program, TensorSpec
    from tensorframes_tpu_torch.shape import Shape, Unknown

    def reads_back(feeds):
        v = feeds["v"]
        return {"y": v * 0 + int(v.max().item())}

    prog = Program(reads_back, [TensorSpec("v", tdt.int64, Shape((Unknown,)))],
                   [TensorSpec("y", tdt.int64, Shape((Unknown,)))])

    def build(f):
        f1 = tft.map_blocks(prog, f, device=CPU)
        with tft.with_graph():
            y = tft.block(f1, "y", tf_name="y_input")
            return tft.aggregate([tft.reduce_sum(y, axis=0, name="y")], f1.group_by("k"),
                                 device=CPU)

    q = QueryEndpoint("cb", QuerySource(path=data), build)
    evs = [e for e in query_cache_events() if e["endpoint"] == "cb"]
    assert [(e["mode"], e["reason"]) for e in evs] == [
        ("cache", "host_callback"), ("incremental", "host_callback")]
    assert not q.cache_stats()["cacheable"]
    q.execute()
    assert q.cache_stats()["recomputes"]["ineligible"] == 1


def test_fusion_off_is_the_oracle_mode(tmp_path):
    """With ``plan_fusion`` off the chain never records: no evidence
    rows, the memo still serves repeats, and the table equals the fused
    endpoint's and the reference's."""
    data = str(tmp_path / "data")
    os.makedirs(data)
    for i in range(3):
        _write_chunk(data, i, _rows(9, i, "string"))
    fused = QueryEndpoint("fz-on", QuerySource(path=data), _t_build("sum")).execute()
    tft.configure(plan_fusion=False)
    try:
        q = QueryEndpoint("fz-off", QuerySource(path=data), _t_build("sum"))
        off = q.execute()
        q.execute()
        assert q.cache_stats()["hits"] == 1
    finally:
        tft.configure(plan_fusion=True)
    assert not [e for e in query_cache_events() if e["endpoint"] == "fz-off"]
    _assert_tables_equal(off, fused)
    _assert_tables_equal(off, JQueryEndpoint("fz-ref", JQuerySource(path=data),
                                             _j_build("sum")).execute())


def test_server_lifecycle_and_errors_match_reference(tmp_path):
    """Admission before start, duplicate and bad names, feeds, bad
    deadlines and a stopped server raise the reference's errors; warm-up
    primes the cache; ``stats()`` carries the query's rows."""
    data = str(tmp_path / "data")
    os.makedirs(data)
    for i in range(3):
        _write_chunk(data, i, _rows(15, i, "string"))
    srv = Server(device=CPU)
    jsrv = tfs.serving.Server()
    q = srv.register_query("daily", QuerySource(path=data), _t_build("sum"))
    jq = jsrv.register_query("daily", JQuerySource(path=data), _j_build("sum"))

    def same_error(fn):
        errs = []
        for s, qq in ((srv, q), (jsrv, jq)):
            with pytest.raises(Exception) as info:
                fn(s, qq)
            errs.append(info.value)
        assert (type(errs[0]).__name__, str(errs[0])) == (type(errs[1]).__name__, str(errs[1]))
        return errs[0]

    assert same_error(lambda s, qq: qq.submit(None)).reason == "closed"
    same_error(lambda s, qq: s.register_query("daily", type(qq.source)(path=data), qq.build))
    same_error(lambda s, qq: s.register_query("a/b", type(qq.source)(path=data), qq.build))
    same_error(lambda s, qq: s.register_query("x", object(), qq.build))
    for kw in ({}, {"path": "/x", "frame": object()}, {"path": "/x", "kind": "orc"}):
        errs = []
        for src in (QuerySource, JQuerySource):
            with pytest.raises(ValueError) as info:
                src(**kw)
            errs.append(str(info.value))
        assert errs[0] == errs[1]
    srv.start()
    jsrv.start()
    try:
        assert srv.warmup_reports["daily"]["rows"] == jsrv.warmup_reports["daily"]["rows"] == 4
        t1, t2 = srv.call("daily", None), srv.call("daily", {})
        _assert_tables_equal(t1, t2)
        _assert_tables_equal(t1, jsrv.call("daily", None))
        assert isinstance(same_error(lambda s, qq: s.call("daily", {"x": np.zeros(3)})),
                          ValidationError)
        same_error(lambda s, qq: s.call("daily", None, deadline_s=-1))
        st = srv.stats()
        assert st["queries"]["daily"]["hits"] == 2
        assert st["admitted_requests"] == 2
        assert "daily" in st["latency"] and st["endpoints"] == ["daily"]
    finally:
        srv.stop()
        jsrv.stop()
    with pytest.raises(RejectedError):
        q.submit(None)


def test_live_registration_rolls_back_a_failed_warm(tmp_path):
    data = str(tmp_path / "data")
    os.makedirs(data)
    _write_chunk(data, 0, _rows(8, 0, "string", "float64"))
    srv = Server(device=CPU)
    srv.start()
    try:
        calls = []

        def build(f):
            calls.append(1)
            if len(calls) > 1:
                raise RuntimeError("broken on warm")
            return _t_build("mean")(f)

        with pytest.raises(RuntimeError, match="broken on warm"):
            srv.register_query("ghost", QuerySource(path=data), build)
        assert "ghost" not in srv.endpoints()
        assert not any(e["endpoint"] == "ghost" for e in query_cache_events())
        srv.register_query("ok", QuerySource(path=data), _t_build("min"))
        _assert_tables_equal(srv.call("ok", None), _oracle(data, "min", None))
    finally:
        srv.stop()


def test_restart_warms_from_the_result_store(tmp_path, cache_dir):
    """A fresh server over the same ``compilation_cache_dir`` warms from
    the persistent store with zero chunk executions and answers the same
    bits; an append then executes exactly the new chunk."""
    data = str(tmp_path / "data")
    os.makedirs(data)
    for i in range(4):
        _write_chunk(data, i, _rows(12, i, "string"))
    srv = Server(device=CPU)
    srv.register_query("q", QuerySource(path=data), _t_build("sum"))
    srv.start()
    first = srv.call("q", None)
    srv.stop()
    assert sorted(f.split("-")[1][0] for f in os.listdir(os.path.join(cache_dir, "results"))) \
        == ["p"] * 4 + ["r"]
    srv2 = Server(device=CPU)
    q2 = srv2.register_query("q", QuerySource(path=data), _t_build("sum"))
    srv2.start()
    try:
        cs = q2.cache_stats()
        assert (cs["chunks_executed"], cs["hits"], cs["misses"]) == (0, 1, 0)
        _assert_tables_equal(srv2.call("q", None), first)
        _assert_tables_equal(first, _oracle(data, "sum", q2._csv_dtypes))
        _write_chunk(data, 4, _rows(12, 4, "string"))
        _assert_tables_equal(srv2.call("q", None), _oracle(data, "sum", q2._csv_dtypes))
        cs = q2.cache_stats()
        assert (cs["chunks_executed"], cs["chunks_folded"]) == (1, 4)
    finally:
        srv2.stop()


def test_corrupt_partial_counted_recompute_exact(tmp_path, cache_dir):
    """Every cached partial damaged: a fresh endpoint over a grown
    directory re-executes each damaged chunk (counted
    ``corrupt_partial``), answers the numpy oracle exactly, and a third
    endpoint folds the rewritten partials without executing."""
    data = str(tmp_path / "data")
    os.makedirs(data)
    for i in range(4):
        _write_chunk(data, i, _rows(10, i, "string"))
    src = QuerySource(path=data)
    QueryEndpoint("qc", src, _t_build("sum")).execute()
    results = os.path.join(cache_dir, "results")
    partials = [f for f in os.listdir(results) if "-p" in f]
    assert len(partials) == 4
    for fn in partials:
        with open(os.path.join(results, fn), "r+b") as fh:
            fh.seek(-1, os.SEEK_END)
            b = fh.read(1)
            fh.seek(-1, os.SEEK_END)
            fh.write(bytes([b[0] ^ 0xFF]))
    _write_chunk(data, 4, _rows(10, 40, "string"))
    q2 = QueryEndpoint("qc", src, _t_build("sum"))
    _assert_tables_equal(q2.execute(), _oracle(data, "sum", q2._csv_dtypes))
    cs = q2.cache_stats()
    assert cs["recomputes"]["corrupt_partial"] == 4 and cs["chunks_executed"] == 5
    assert len([f for f in os.listdir(results) if f.endswith(".corrupt")]) == 4
    q3 = QueryEndpoint("qc", src, _t_build("sum"))
    q3.execute()
    assert q3.cache_stats()["chunks_executed"] == 0


def test_invalidation_by_rewrite_and_removal(tmp_path, cache_dir):
    """A rewritten part and a removed part invalidate (counted), re-run
    only what changed, and answer the numpy oracle exactly."""
    data = str(tmp_path / "data")
    os.makedirs(data)
    for i in range(4):
        _write_chunk(data, i, _rows(10, i))
    q = QueryEndpoint("inv", QuerySource(path=data), _t_build("max"))
    q.execute()
    _write_chunk(data, 2, _rows(14, 77))
    _assert_tables_equal(q.execute(), _oracle(data, "max", q._csv_dtypes))
    assert q.cache_stats()["recomputes"]["invalidated"] == 1
    assert q.cache_stats()["chunks_executed"] == 5
    os.remove(os.path.join(data, "part-0001.csv"))
    _assert_tables_equal(q.execute(), _oracle(data, "max", q._csv_dtypes))
    cs = q.cache_stats()
    assert cs["invalidations"] == 2 and cs["chunks_executed"] == 5


def test_frame_source(tmp_path):
    fr = {"k": np.arange(12, dtype=np.int64) % 3, "v": np.arange(12, dtype=np.int64)}
    q = QueryEndpoint("mem", QuerySource(frame=tft.frame_from_arrays(dict(fr))),
                      _t_build("sum"))
    jq = JQueryEndpoint("mem", JQuerySource(frame=tfs.frame_from_arrays(dict(fr))),
                        _j_build("sum"))
    _assert_tables_equal(q.execute(), jq.execute())
    q.execute()
    assert q.cache_stats()["hits"] == 1
    empty = str(tmp_path / "empty")
    os.makedirs(empty)
    errs = []
    for E, S, b in ((QueryEndpoint, QuerySource, _t_build), (JQueryEndpoint, JQuerySource,
                                                              _j_build)):
        with pytest.raises(ValueError) as info:
            E("e", S(path=empty), b("sum"))
        errs.append(str(info.value))
    assert errs[0] == errs[1]


def test_http_serves_a_query_with_string_keys(tmp_path):
    data = str(tmp_path / "data")
    os.makedirs(data)
    for i in range(2):
        _write_chunk(data, i, _rows(9, i, "string"))
    srv = Server(device=CPU)
    srv.register_query("web", QuerySource(path=data), _t_build("sum"))
    srv.start()
    httpd = serve_http(srv, port=0)
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{httpd.server_address[1]}/v1/web",
            data=json.dumps({}).encode(), headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as resp:
            body = json.loads(resp.read())
        want = _oracle(data, "sum", None)
        assert body["outputs"] == {"k": want["k"].tolist(), "y": want["y"].tolist()}
        assert body["rows"] == len(want["k"])
    finally:
        httpd.shutdown()
        srv.stop()


def test_card_route_casts_to_the_kernel_dtypes():
    """The chains ``chip_smoke.py`` serves on the card cast in their map
    (int32 sum/min/max), so the keyed reduction takes the segment
    kernel's dtypes; on the CPU the same build equals numpy exactly."""
    rng = np.random.default_rng(0)
    k, v = rng.integers(0, 64, 5000), rng.integers(-1000, 1000, 5000)
    f = tft.frame_from_arrays({"k": k, "v": v})
    g = tft.map_blocks(lambda v: {"ysum": (v * 3 + 1).to(torch.int32),
                                  "ymin": (v * 3 + 1).to(torch.int32),
                                  "ymax": (v * 3 + 1).to(torch.int32)}, f, device=CPU)
    with tft.with_graph():
        ins = {c: tft.block(g, c, tf_name=f"{c}_input") for c in ("ysum", "ymin", "ymax")}
        out = tft.aggregate([tft.reduce_sum(ins["ysum"], axis=0, name="ysum"),
                             tft.reduce_min(ins["ymin"], axis=0, name="ymin"),
                             tft.reduce_max(ins["ymax"], axis=0, name="ymax")],
                            g.group_by("k"), device=CPU)
    y = (v * 3 + 1).astype(np.int32)
    keys = out.column_values("k")
    assert out.column_values("ysum").dtype == np.int32
    for j, g_ in enumerate(keys):
        m = k == g_
        assert out.column_values("ysum")[j] == y[m].sum(dtype=np.int32)
        assert out.column_values("ymin")[j] == y[m].min()
        assert out.column_values("ymax")[j] == y[m].max()
    assert jnp is not None  # the JAX package is loaded beside the port here


def test_digests_metrics_and_latency_match_reference(tmp_path):
    """The result cache's key halves and instruments equal the
    reference's: ``part_signature``/``content_digest`` of the same files
    and ``frame_content_digest`` of the same frame (string and vector
    columns too) are the same strings; ``RECOMPUTE_REASONS``, the decline
    taxonomy, the latency ladder, the verb list and ``series_key`` are
    the reference's; a verb call and its dispatches feed the port's
    ``tftpu_verb_latency_seconds`` and ``tftpu_dispatch_latency_seconds``."""
    from tensorframes_tpu.compilecache import fingerprint as jfp
    from tensorframes_tpu.observability import latency as jlat
    from tensorframes_tpu.serving import metrics as jm
    from tensorframes_tpu.serving import query as jquery
    from tensorframes_tpu_torch.compilecache import fingerprint as tfp
    from tensorframes_tpu_torch.observability import latency as tlat
    from tensorframes_tpu_torch.serving import metrics as tm

    data = str(tmp_path / "data")
    os.makedirs(data)
    paths = [_write_chunk(data, i, _rows(5, i)) for i in range(3)]
    sigs = [tfp.part_signature(p) for p in paths]
    assert sigs == [jfp.part_signature(p) for p in paths]
    assert tfp.content_digest(sigs) == jfp.content_digest(sigs)
    assert tfp.content_digest(sigs[::-1]) != tfp.content_digest(sigs)
    cols = {"k": np.arange(6) % 2, "s": [f"a{i}" for i in range(6)],
            "m": np.arange(12, dtype=np.float32).reshape(6, 2)}
    assert tfp.frame_content_digest(tft.frame_from_arrays(dict(cols), num_blocks=2)) == \
        jfp.frame_content_digest(tfs.frame_from_arrays(dict(cols), num_blocks=2))
    assert tm.RECOMPUTE_REASONS == jm.RECOMPUTE_REASONS
    assert QUERY_DECLINE_REASONS == jquery.QUERY_DECLINE_REASONS
    assert tlat.LATENCY_BUCKETS == jlat.LATENCY_BUCKETS == tm.LATENCY_BUCKETS
    assert tlat.VERBS == jlat.VERBS
    for labels in ({"verb": "map_blocks"}, {"entry": "vmap"}, {}):
        assert tlat.series_key(labels) == jlat.series_key(labels)
    before = tlat.verb_histogram("map_blocks").count
    blocks = tlat.dispatch_histogram("block").count
    tft.map_blocks(lambda x: {"z": x + 1}, tft.frame_from_arrays(
        {"x": np.arange(6.0)}, num_blocks=3), device=CPU).collect()
    assert tlat.verb_histogram("map_blocks").count == before + 1
    assert tlat.dispatch_histogram("block").count == blocks + 3
    rows = {(r["name"], tuple(sorted(r["labels"].items()))) for r in tlat.quantile_summary()}
    assert ("tftpu_verb_latency_seconds", (("verb", "map_blocks"),)) in rows
    assert any(line.startswith("verb:map_blocks count=") for line in tlat.summary_lines())
