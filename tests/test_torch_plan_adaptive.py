"""The port's adaptive query optimizer (``tensorframes_tpu_torch/plan``):
aggregate pushdown below joins, multi-join reordering and stats-sidecar
re-optimization must be BIT-IDENTICAL to the ``plan_fusion=False``
stage-by-stage run across join orders × hows × key kinds × fetches, agree
with the JAX package on the same inputs (results and counted decision
kinds), keep the static path for ineligible shapes (counted, with the
fixable cause recorded), and record ``reoptimized`` decisions on a
recurring pipeline's second execution without moving a bit. The sidecar
contracts (round trip, quarantine, ``plan_reopt=False``) are checked on
the port alone, in a temporary ``TFTPU_COMPILE_CACHE``."""

import glob
import json
import os

import numpy as np
import pytest

import tensorframes_tpu as tfs
from tensorframes_tpu.observability.metrics import REGISTRY as JREG
from tensorframes_tpu.plan import stats as jstats

import tensorframes_tpu_torch as tft
from tensorframes_tpu_torch.observability.metrics import REGISTRY as TREG
from tensorframes_tpu_torch.plan import ir as tir
from tensorframes_tpu_torch.plan import lower as tlower
from tensorframes_tpu_torch.plan import stats as tstats

SHARED_KINDS = (
    "fuse", "split_single_stage", "epilogue_per_block", "epilogue_concat",
    "pushdown_aggregate", "pushdown_ineligible",
    "pushdown_skipped_selective", "reorder_joins", "join_order_static",
    "reoptimized",
)


@pytest.fixture(autouse=True)
def _plan_defaults():
    cfg = tft.get_config()
    before = (cfg.device, cfg.plan_fusion, cfg.plan_reopt, cfg.compilation_cache_dir)
    jcfg = tfs.configure()
    jbefore = (jcfg.plan_fusion, jcfg.plan_reopt)
    tft.configure(device="cpu", plan_fusion=True, plan_reopt=True, compilation_cache_dir="")
    tfs.configure(plan_fusion=True, plan_reopt=True)
    for st in (tstats, jstats):
        st.clear_memory()
        st.reset_strategy_walls(unlink_sidecar=False)
    yield
    for st in (tstats, jstats):  # leave no walls for the next test file
        st.clear_memory()
        st.reset_strategy_walls(unlink_sidecar=False)
    tft.configure(device=before[0], plan_fusion=before[1], plan_reopt=before[2],
                  compilation_cache_dir=before[3])
    tfs.configure(plan_fusion=jbefore[0], plan_reopt=jbefore[1])


def _unfused(build):
    tft.configure(plan_fusion=False)
    try:
        return build()
    finally:
        tft.configure(plan_fusion=True)


def _count(kind, reg=TREG):
    for d in reg.snapshot():
        if (d["name"] == "tftpu_plan_cost_decisions_total"
                and d["labels"].get("decision") == kind):
            return float(d.get("value", 0.0))
    return 0.0


def _sidecar_count(event):
    for d in TREG.snapshot():
        if (d["name"] == "tftpu_plan_reopt_sidecar_total"
                and d["labels"].get("event") == event):
            return float(d.get("value", 0.0))
    return 0.0


def _shared_delta(reg, fn):
    before = {k: _count(k, reg) for k in SHARED_KINDS}
    out = fn()
    delta = {k: _count(k, reg) - before[k] for k in SHARED_KINDS}
    return out, {k: v for k, v in delta.items() if v}


def _rows_equal(a, b):
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        assert ra.keys() == rb.keys()
        for k in ra:
            va, vb = np.asarray(ra[k]), np.asarray(rb[k])
            assert va.dtype == vb.dtype, (k, va.dtype, vb.dtype)
            np.testing.assert_array_equal(va, vb)


def _fact(P, n=240, key_kind="int", num_blocks=3, seed=3):
    rng = np.random.default_rng(seed)
    k1 = rng.integers(0, 8, n)
    k2 = rng.integers(0, 6, n)
    cols = {"x": (np.arange(n) % 7).astype(np.int64), "dead": np.ones(n, np.float32)}
    if key_kind == "str":
        rows = [{"k1": f"g{int(a)}", "k2": int(b), "x": int(c), "dead": 1.0}
                for a, b, c in zip(k1, k2, cols["x"])]
        return P.frame_from_rows(rows, num_blocks=num_blocks)
    cols["k1"] = k1.astype(np.int32)
    cols["k2"] = k2.astype(np.int32)
    return P.frame_from_arrays(cols, num_blocks=num_blocks)


def _dim(P, key, values, extra_name, extra_dtype=np.int64, key_kind="int"):
    if key_kind == "str":
        rows = [{key: f"g{int(v)}", extra_name: int(v) * 10} for v in values]
        return P.frame_from_rows(rows, num_blocks=1)
    return P.frame_from_arrays({
        key: np.asarray(values, dtype=np.int32),
        extra_name: (np.asarray(values) * 10).astype(extra_dtype),
    }, num_blocks=1)


def _agg_over_join(P, fact, dims, group_keys, op="reduce_sum", hows=None, fills=None):
    """map → join(s) → aggregate of the mapped probe column."""
    j = P.map_blocks(lambda x: {"z": x * x}, fact)
    for i, dim in enumerate(dims):
        how = (hows or ["inner"] * len(dims))[i]
        fill = (fills or [None] * len(dims))[i]
        j = j.join(dim, on=list(dim.schema.names)[0], how=how, fill_value=fill)
    with P.with_graph():
        z_in = P.block(j, "z", tf_name="z_input")
        return P.aggregate(getattr(P, op)(z_in, axis=0, name="z"), j.group_by(*group_keys))


# ---------------------------------------------------------------------------
# equivalence sweep: fused == unfused == the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("key_kind", ["int", "str"])
@pytest.mark.parametrize("how,fill", [("inner", None), ("left", -1), ("right", -1), ("outer", -1)])
@pytest.mark.parametrize("op", ["reduce_sum", "reduce_min", "reduce_max", "reduce_mean"])
def test_agg_over_join_equivalence(key_kind, how, fill, op):
    def build(P):
        fact = _fact(P, key_kind=key_kind)
        dim = _dim(P, "k1", range(0, 8, 2), "w1", key_kind=key_kind)
        return _agg_over_join(P, fact, [dim], ["k1"], op=op, hows=[how], fills=[fill])

    fused, dt_ = _shared_delta(TREG, lambda: build(tft).collect())
    _rows_equal(fused, _unfused(lambda: build(tft).collect()))
    ref, dj = _shared_delta(JREG, lambda: build(tfs).collect())
    _rows_equal(fused, ref)
    assert dt_ == dj
    assert tft.explain_plan(build(tft)) == tfs.explain_plan(build(tfs))


@pytest.mark.parametrize("dim_order", [(0, 1), (1, 0)])
@pytest.mark.parametrize("op", ["reduce_sum", "reduce_min"])
def test_two_join_agg_equivalence_across_orders(dim_order, op):
    def build(P):
        dims = [_dim(P, "k1", range(0, 8, 2), "w1"), _dim(P, "k2", range(6), "w2")]
        return _agg_over_join(P, _fact(P), [dims[i] for i in dim_order], ["k1", "k2"], op=op)

    fused, dt_ = _shared_delta(TREG, lambda: build(tft).collect())
    _rows_equal(fused, _unfused(lambda: build(tft).collect()))
    ref, dj = _shared_delta(JREG, lambda: build(tfs).collect())
    _rows_equal(fused, ref)
    assert dt_ == dj and dt_.get("pushdown_aggregate") == 1.0


@pytest.mark.parametrize("value_dtype", [np.float32, np.float64], ids=lambda d: d.__name__)
def test_float_fetch_keeps_static_path_and_matches(value_dtype):
    def build(P):
        n = 120
        fact = P.frame_from_arrays({"k1": (np.arange(n) % 5).astype(np.int32),
                                    "x": (np.arange(n) % 9).astype(value_dtype)}, num_blocks=2)
        return _agg_over_join(P, fact, [_dim(P, "k1", range(5), "w1")], ["k1"]).collect()

    before = _count("pushdown_aggregate")
    got = build(tft)
    assert _count("pushdown_aggregate") == before
    _rows_equal(got, _unfused(lambda: build(tft)))
    _rows_equal(got, build(tfs))


def test_nonalgebraic_fetch_stays_generic_and_matches():
    def build(P):
        fact = _fact(P, n=60)
        j = P.map_blocks(lambda x: {"z": x * x}, fact).join(_dim(P, "k1", range(8), "w1"), on="k1")
        with P.with_graph():
            z_in = P.block(j, "z", tf_name="z_input")
            fetch = P.reduce_sum(z_in * z_in, axis=0, name="z")  # no segment lowering
            return P.aggregate(fetch, j.group_by("k1")).collect()

    got = build(tft)
    _rows_equal(got, _unfused(lambda: build(tft)))
    _rows_equal(got, build(tfs))


# ---------------------------------------------------------------------------
# the adaptive paths engage (and are counted like the reference's)
# ---------------------------------------------------------------------------

def test_pushdown_engages_and_is_counted():
    def build(P):
        return _agg_over_join(P, _fact(P), [_dim(P, "k1", range(0, 8, 2), "w1")], ["k1"])

    agg = build(tft)
    got, dt_ = _shared_delta(TREG, agg.collect)
    assert dt_ == {"split_single_stage": 1.0, "pushdown_aggregate": 1.0}
    assert {r["k1"] for r in got} == {0, 2, 4, 6}
    _, dj = _shared_delta(JREG, build(tfs).collect)
    assert dt_ == dj
    assert tlower.pushdown_misses(agg) == []


def test_build_side_pushdown_with_unique_probe_keys():
    def build(P):
        probe = P.frame_from_arrays({"k1": np.arange(0, 8, 2, dtype=np.int32),
                                     "junk": np.ones(4, np.float32)}, num_blocks=1)
        rng = np.random.default_rng(5)
        big = P.frame_from_arrays({"k1": rng.integers(0, 8, 100).astype(np.int32),
                                   "w1": np.arange(100, dtype=np.int64)}, num_blocks=1)
        j = probe.join(big, on="k1")
        with P.with_graph():
            w_in = P.block(j, "w1", tf_name="w1_input")
            return P.aggregate(P.reduce_max(w_in, axis=0, name="w1"), j.group_by("k1")).collect()

    got, dt_ = _shared_delta(TREG, lambda: build(tft))
    assert dt_.get("pushdown_aggregate") == 1.0
    _rows_equal(got, _unfused(lambda: build(tft)))
    ref, dj = _shared_delta(JREG, lambda: build(tfs))
    _rows_equal(got, ref)
    assert dt_ == dj


def test_duplicate_build_keys_fall_back_counted_and_match():
    def build(P):
        dup = P.frame_from_arrays({"k1": np.asarray([0, 0, 2, 4], np.int32),
                                   "w1": np.asarray([1, 2, 3, 4], np.int64)}, num_blocks=1)
        return _agg_over_join(P, _fact(P), [dup], ["k1"])

    agg = build(tft)
    got, dt_ = _shared_delta(TREG, agg.collect)
    assert dt_.get("pushdown_aggregate", 0) == 0 and dt_["pushdown_ineligible"] == 1.0
    assert any("duplicate" in m["detail"] for m in tir.pushdown_miss_log(agg))
    _rows_equal(got, _unfused(lambda: build(tft).collect()))
    ref, dj = _shared_delta(JREG, build(tfs).collect)
    _rows_equal(got, ref)
    assert dt_ == dj


def test_static_misses_name_the_blocking_column():
    n = 60
    fact = tft.frame_from_arrays({"k1": (np.arange(n) % 4).astype(np.int32),
                                  "x": (np.arange(n) % 7).astype(np.float32)}, num_blocks=2)
    agg = _agg_over_join(tft, fact, [_dim(tft, "k1", range(4), "w1")], ["k1"])
    (miss,) = tlower.pushdown_misses(agg)
    assert miss["cause"] == "float_reassoc" and miss["subject"] == "z"
    agg2 = _agg_over_join(tft, _fact(tft, n=60), [_dim(tft, "k2", range(6), "w2")], ["k1"])
    assert tlower.pushdown_misses(agg2)[0]["subject"] == "k2"
    assert not any(f.is_materialized for f in (agg, agg2))


def _join_chain(P, selective_second=True):
    rng = np.random.default_rng(7)
    n = 600
    fact = P.frame_from_arrays({"k1": rng.integers(0, 32, n).astype(np.int32),
                                "k2": rng.integers(0, 8, n).astype(np.int32),
                                "x": (np.arange(n) % 5).astype(np.int64)}, num_blocks=2)
    big_dim = _dim(P, "k1", range(32), "w1")
    small_dim = _dim(P, "k2", range(0, 8, 2), "w2")
    f1 = P.map_blocks(lambda x: {"z": x + 1}, fact)
    out = f1.join(big_dim, on="k1").join(small_dim, on="k2")
    return out.select(["k1", "k2", "z", "w1", "w2"])


def test_join_chain_reorders_by_build_size_and_matches():
    got, dt_ = _shared_delta(TREG, lambda: _join_chain(tft).collect())
    assert dt_.get("reorder_joins") == 1.0
    _rows_equal(got, _unfused(lambda: _join_chain(tft).collect()))
    ref, dj = _shared_delta(JREG, lambda: _join_chain(tfs).collect())
    _rows_equal(got, ref)
    assert dt_ == dj
    assert tft.explain_plan(_join_chain(tft)) == tfs.explain_plan(_join_chain(tfs))


def test_left_join_chain_keeps_order_and_matches():
    def build(P):
        fact = _fact(P, n=100)
        f1 = P.map_blocks(lambda x: {"z": x + 1}, fact)
        out = f1.join(_dim(P, "k1", range(0, 8, 2), "w1"), on="k1", how="left",
                      fill_value=-1).join(_dim(P, "k2", range(6), "w2"), on="k2")
        return out.select(["k1", "k2", "z", "w1", "w2"]).collect()

    got, dt_ = _shared_delta(TREG, lambda: build(tft))
    assert dt_.get("join_order_static", 0) >= 1
    _rows_equal(got, _unfused(lambda: build(tft)))
    ref, dj = _shared_delta(JREG, lambda: build(tfs))
    _rows_equal(got, ref)
    assert dt_ == dj


# ---------------------------------------------------------------------------
# the feedback loop: the second execution re-optimizes, bit-identically
# ---------------------------------------------------------------------------

def test_second_execution_records_reoptimized_like_the_reference():
    def build(P):
        dims = [_dim(P, "k1", range(0, 8, 2), "w1"), _dim(P, "k2", range(6), "w2")]
        return _agg_over_join(P, _fact(P, seed=11), dims, ["k1", "k2"]).collect()

    first, d1 = _shared_delta(TREG, lambda: build(tft))
    second, d2 = _shared_delta(TREG, lambda: build(tft))
    assert d2.get("reoptimized", 0) > d1.get("reoptimized", 0)
    _rows_equal(first, second)
    _rows_equal(second, _unfused(lambda: build(tft)))
    _, j1 = _shared_delta(JREG, lambda: build(tfs))
    _, j2 = _shared_delta(JREG, lambda: build(tfs))
    assert (d1, d2) == (j1, j2)


def test_observed_selectivity_reoptimizes_join_order():
    def build(P):
        rng = np.random.default_rng(13)
        n = 400
        fact = P.frame_from_arrays({"k1": rng.integers(0, 4, n).astype(np.int32),
                                    "k2": rng.integers(0, 16, n).astype(np.int32),
                                    "x": (np.arange(n) % 5).astype(np.int64)}, num_blocks=2)
        f1 = P.map_blocks(lambda x: {"z": x + 1}, fact)
        out = f1.join(_dim(P, "k1", range(4), "w1"), on="k1").join(
            _dim(P, "k2", range(0, 16, 4), "w2"), on="k2")
        return out.select(["k1", "k2", "z", "w1", "w2"]).collect()

    first, d1 = _shared_delta(TREG, lambda: build(tft))
    second, d2 = _shared_delta(TREG, lambda: build(tft))
    assert d2.get("reoptimized", 0) > 0
    _rows_equal(first, second)
    _rows_equal(second, _unfused(lambda: build(tft)))
    _, j1 = _shared_delta(JREG, lambda: build(tfs))
    _, j2 = _shared_delta(JREG, lambda: build(tfs))
    assert (d1, d2) == (j1, j2)


def test_pushdown_reoptimized_away_when_joins_are_selective():
    def build(P):
        n = 400
        fact = P.frame_from_arrays({"k1": np.arange(n, dtype=np.int32),
                                    "x": (np.arange(n) % 5).astype(np.int64)}, num_blocks=2)
        return _agg_over_join(P, fact, [_dim(P, "k1", [0, 1], "w1")], ["k1"]).collect()

    first, d1 = _shared_delta(TREG, lambda: build(tft))
    second, d2 = _shared_delta(TREG, lambda: build(tft))
    assert d1.get("pushdown_aggregate") == 1.0
    assert d2.get("pushdown_skipped_selective") == 1.0
    _rows_equal(first, second)
    _rows_equal(second, _unfused(lambda: build(tft)))
    _, j1 = _shared_delta(JREG, lambda: build(tfs))
    _, j2 = _shared_delta(JREG, lambda: build(tfs))
    assert (d1, d2) == (j1, j2)


# ---------------------------------------------------------------------------
# fingerprints: the same pipeline keys the same record in both packages
# ---------------------------------------------------------------------------

def _fp(P, frame):
    from importlib import import_module

    ir = import_module(P.__name__ + ".plan.ir")
    stats = import_module(P.__name__ + ".plan.stats")
    return stats.chain_fingerprint(*ir.resolve_chain(frame._plan))


def test_chain_fingerprint_equal_across_packages():
    def pipelines(P):
        fr = P.frame_from_arrays({"x": np.arange(16, dtype=np.float32),
                                  "k": (np.arange(16) % 4).astype(np.int32)}, num_blocks=2)
        f2 = P.map_blocks(lambda x: {"y": x + 1.0}, fr).map_rows(lambda y: {"z": y * 2.0})
        dims = [_dim(P, "k1", range(0, 8, 2), "w1"), _dim(P, "k2", range(6), "w2")]
        return [f2, f2.select(["z"]), f2.filter(lambda z: {"keep": z > 3.0}),
                _agg_over_join(P, _fact(P), dims, ["k1", "k2"]), _join_chain(P)]

    got = [_fp(tft, f) for f in pipelines(tft)]
    want = [_fp(tfs, f) for f in pipelines(tfs)]
    assert got == want
    assert len(set(got)) == len(got)


# ---------------------------------------------------------------------------
# stats-sidecar contracts (the port alone: the JAX package's own sidecar
# tests need its 8-device mesh in-process)
# ---------------------------------------------------------------------------

def test_sidecar_roundtrip_corruption_and_stale_quarantine(tmp_path, monkeypatch):
    monkeypatch.setattr(tft.get_config(), "compilation_cache_dir", str(tmp_path))

    def build():
        return _agg_over_join(tft, _fact(tft, seed=17), [_dim(tft, "k1", range(0, 8, 2), "w1")],
                              ["k1"]).collect()

    first = build()
    files = [f for f in glob.glob(str(tmp_path / "planstats" / "*.json"))
             if not f.endswith("strategy_walls.json")]
    assert len(files) == 1, "one sidecar record per plan fingerprint"
    rec = json.load(open(files[0]))
    assert rec["v"] == tstats.FORMAT_VERSION and rec["execs"] >= 1 and "push" in rec
    # a fresh process reads the record back: the second run re-optimizes
    tstats.clear_memory()
    l0 = _sidecar_count("load")
    r0 = _count("reoptimized")
    _rows_equal(first, build())
    assert _sidecar_count("load") >= l0 + 1 and _count("reoptimized") > r0

    # corrupt record: quarantined (counted + unlinked), static decisions,
    # results unchanged — never a failure
    tstats.clear_memory()
    with open(files[0], "w") as f:
        f.write("{definitely not json")
    q0 = _sidecar_count("quarantine")
    _rows_equal(first, build())
    assert _sidecar_count("quarantine") == q0 + 1
    assert os.path.exists(files[0])  # re-recorded fresh

    # stale record (format bump): the same contract
    tstats.clear_memory()
    rec2 = json.load(open(files[0]))
    rec2["v"] = tstats.FORMAT_VERSION + 999
    json.dump(rec2, open(files[0], "w"))
    q1 = _sidecar_count("quarantine")
    _rows_equal(first, build())
    assert _sidecar_count("quarantine") == q1 + 1


def test_strategy_walls_stale_entries_pruned(tmp_path, monkeypatch):
    monkeypatch.setattr(tft.get_config(), "compilation_cache_dir", str(tmp_path))
    tstats.clear_memory()
    side = tmp_path / "planstats"
    side.mkdir()
    obs = tstats.STRATEGY_STALE_OBS + 10
    (side / "strategy_walls.json").write_text(json.dumps({
        "v": tstats.SW_FORMAT_VERSION, "kind": "strategy_walls",
        "tables": {"fuse": {"obs": obs, "strategies": {
            "fuse": {"ewma_s": 1.0, "n": 5, "last_obs": 1},
            "split_single_stage": {"ewma_s": 0.5, "n": 5, "last_obs": obs - 1},
        }}},
        "workloads": {},
    }))
    q0 = _sidecar_count("quarantine")
    assert set(tstats.strategy_walls("fuse")) == {"split_single_stage"}
    assert _sidecar_count("quarantine") == q0 + 1
    # a corrupt table quarantines and is unlinked
    tstats.clear_memory()
    (side / "strategy_walls.json").write_text("{nope")
    assert tstats.strategy_walls("fuse") == {}
    assert _sidecar_count("quarantine") == q0 + 2
    assert not (side / "strategy_walls.json").exists()


def test_reopt_off_disables_recording_and_rewrites(tmp_path, monkeypatch):
    monkeypatch.setattr(tft.get_config(), "compilation_cache_dir", str(tmp_path))
    tft.configure(plan_reopt=False)

    def build():
        return _agg_over_join(tft, _fact(tft, seed=19), [_dim(tft, "k1", range(0, 8, 2), "w1")],
                              ["k1"]).collect()

    counts = {k: _count(k) for k in ("pushdown_aggregate", "reorder_joins", "reoptimized")}
    first, second = build(), build()
    _join_chain(tft).collect()
    assert {k: _count(k) for k in counts} == counts
    assert not glob.glob(str(tmp_path / "planstats" / "*.json"))
    assert tstats.lookup("0" * 32) is None
    _rows_equal(first, second)
    _rows_equal(second, _unfused(build))


def test_decision_and_sidecar_counters_preregistered():
    kinds = {d["labels"]["decision"] for d in TREG.snapshot()
             if d["name"] == "tftpu_plan_cost_decisions_total"}
    assert {"pushdown_aggregate", "pushdown_ineligible", "pushdown_skipped_selective",
            "reorder_joins", "join_order_static", "reoptimized"} <= kinds
    events = {d["labels"]["event"] for d in TREG.snapshot()
              if d["name"] == "tftpu_plan_reopt_sidecar_total"}
    assert events == {"load", "store", "quarantine"}


def test_fold_partial_tables_is_exact_and_canonical():
    from tensorframes_tpu.plan import lower as jlower

    parts = [
        {"k": np.array([3, 1], np.int64), "s": np.array([5, 7], np.int32),
         "m": np.array([2.5, -1.0], np.float32)},
        {"k": np.array([1, 2], np.int64), "s": np.array([2**31 - 1, 4], np.int32),
         "m": np.array([-3.0, 9.0], np.float32)},
    ]
    ops = [("s", "reduce_sum"), ("m", "reduce_min")]
    got = tlower.fold_partial_tables(parts, ["k"], ops, None)
    want = jlower.fold_partial_tables(parts, ["k"], ops, None)
    for name in ("k", "s", "m"):
        np.testing.assert_array_equal(got[name], want[name])
        assert got[name].dtype == want[name].dtype
    assert got["k"].tolist() == [1, 2, 3]
    with pytest.raises(ValueError, match="foldable"):
        tlower.fold_partial_tables(parts, ["k"], [("s", "reduce_mean")], None)
