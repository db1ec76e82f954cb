"""The port's plan layer (``tensorframes_tpu_torch/plan``): lazy verb-chain
fusion must be BIT-IDENTICAL to the ``plan_fusion=False`` stage-by-stage
run across chains × dtypes × layouts, agree with the JAX package's plan
layer on the same numpy inputs (results, the non-kernel decision kinds it
counts, ``explain_plan`` text), split at the barriers the reference names
without changing semantics, and leave the mapped chain unmaterialized
under a fused aggregate, reduce or join. Everything runs on the CPU
(``device="cpu"``), where the kernel wrappers compute their plain
versions."""

import itertools

import numpy as np
import pytest
import torch

import tensorframes_tpu as tfs
from tensorframes_tpu.observability.metrics import REGISTRY as JREG
from tensorframes_tpu.plan import stats as jstats

import tensorframes_tpu_torch as tft
from tensorframes_tpu_torch import dtypes as tdt
from tensorframes_tpu_torch.observability.metrics import REGISTRY as TREG
from tensorframes_tpu_torch.ops.executor import _GATHER_BYTES
from tensorframes_tpu_torch.plan import ir as tir
from tensorframes_tpu_torch.plan import stats as tstats
from tensorframes_tpu_torch.program import Program, TensorSpec, analyze_program
from tensorframes_tpu_torch.shape import Shape, Unknown

#: the decision kinds both packages share (the kernel lowerings are named
#: per package: rules.LOWERING_KINDS)
SHARED_KINDS = (
    "fuse", "split_single_stage", "epilogue_per_block", "epilogue_concat",
    "pushdown_aggregate", "pushdown_ineligible",
    "pushdown_skipped_selective", "reorder_joins", "join_order_static",
    "reoptimized",
)


@pytest.fixture(autouse=True)
def _plan_defaults():
    """Every test starts on the CPU with fusion and re-optimization on,
    no stats in memory and no strategy walls in either package."""
    cfg = tft.get_config()
    before = (cfg.device, cfg.plan_fusion, cfg.plan_reopt)
    jcfg = tfs.configure()
    jbefore = (jcfg.plan_fusion, jcfg.plan_reopt)
    tft.configure(device="cpu", plan_fusion=True, plan_reopt=True)
    tfs.configure(plan_fusion=True, plan_reopt=True)
    for st in (tstats, jstats):
        st.clear_memory()
        st.reset_strategy_walls(unlink_sidecar=False)
    yield
    for st in (tstats, jstats):  # leave no walls for the next test file
        st.clear_memory()
        st.reset_strategy_walls(unlink_sidecar=False)
    tft.configure(device=before[0], plan_fusion=before[1], plan_reopt=before[2])
    tfs.configure(plan_fusion=jbefore[0], plan_reopt=jbefore[1])


def _unfused(build):
    tft.configure(plan_fusion=False)
    try:
        return build()
    finally:
        tft.configure(plan_fusion=True)


def _value(reg, name, **labels):
    for d in reg.snapshot():
        if d["name"] == name and d["labels"] == labels:
            return float(d.get("value", 0.0))
    return 0.0


def _decisions(reg):
    return {
        d["labels"]["decision"]: float(d["value"])
        for d in reg.snapshot()
        if d["name"] == "tftpu_plan_cost_decisions_total"
    }


def _shared_delta(reg, fn):
    """Run ``fn`` and return (its result, the shared decision kinds it
    counted)."""
    before = _decisions(reg)
    out = fn()
    after = _decisions(reg)
    delta = {
        k: after.get(k, 0.0) - before.get(k, 0.0) for k in SHARED_KINDS
    }
    return out, {k: v for k, v in delta.items() if v}


def _rows_equal(a, b):
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        assert ra.keys() == rb.keys()
        for k in ra:
            va, vb = np.asarray(ra[k]), np.asarray(rb[k])
            assert va.dtype == vb.dtype, (k, va.dtype, vb.dtype)
            np.testing.assert_array_equal(va, vb)


def _sum0(P):
    """A reduce_blocks fetch summing ``z_input`` in its own dtype."""
    if P is tft:
        return lambda z_input: {"z": z_input.sum(dim=0, dtype=z_input.dtype)}
    return lambda z_input: {"z": z_input.sum(axis=0, dtype=z_input.dtype)}


# ---------------------------------------------------------------------------
# chains × dtypes × layouts: fused == unfused == the JAX package
# ---------------------------------------------------------------------------

DTYPES = [np.float32, np.float64, np.int32, np.int64]


def _chain(P, dtype, layout, n=24):
    if layout == "ragged":
        rng = np.random.default_rng(7)
        rows = [{"x": np.arange(k, dtype=dtype)} for k in rng.integers(1, 5, n)]
        fr = P.frame_from_rows(rows, num_blocks=3)
        g1 = P.map_rows(lambda x: {"s": x.sum()}, fr)
        g2 = g1.map_rows(lambda s: {"t": s * dtype(2)})
        return g2.select(["t", "s"]).collect()
    fr = P.frame_from_arrays({"x": np.arange(n, dtype=dtype)}, num_blocks=3)
    two, one = dtype(2), dtype(1)
    f1 = P.map_blocks(lambda x: {"y": x * two + one}, fr)
    f2 = f1.map_rows(lambda y: {"z": y * y})
    return f2.select(["z", "x"]).collect()


@pytest.mark.parametrize(
    "dtype,layout", list(itertools.product(DTYPES, ["dense", "ragged"])),
    ids=lambda v: str(getattr(v, "__name__", v)),
)
def test_fused_unfused_bit_identical(dtype, layout):
    fused = _chain(tft, dtype, layout)
    _rows_equal(fused, _unfused(lambda: _chain(tft, dtype, layout)))
    ref = _chain(tfs, dtype, layout)  # the JAX leg ran
    assert len(ref) == 24
    _rows_equal(fused, ref)


def _longer(P):
    fr = P.frame_from_arrays(
        {"a": np.arange(30, dtype=np.float64),
         "b": np.arange(30, dtype=np.float64) * 0.5},
        num_blocks=4,
    )
    f1 = P.map_blocks(lambda a, b: {"c": a + b}, fr)
    f2 = f1.map_rows(lambda c: {"d": c * c})
    f3 = P.map_blocks(lambda d, a: {"e": d - a}, f2)
    return f3.select(["e", "c"])


def test_longer_mixed_chain_bit_identical_and_like_the_reference():
    out, dt_ = _shared_delta(TREG, lambda: _longer(tft).collect())
    ref, dj = _shared_delta(JREG, lambda: _longer(tfs).collect())
    assert dt_ == dj == {"fuse": 1.0}
    _rows_equal(out, _unfused(lambda: _longer(tft).collect()))
    _rows_equal(out, ref)
    assert tft.explain_plan(_longer(tft)) == tfs.explain_plan(_longer(tfs))


def _filter_chain(P):
    fr = P.frame_from_arrays({"x": np.arange(40, dtype=np.float32)}, num_blocks=3)
    f1 = P.map_blocks(lambda x: {"y": x * 2.0}, fr)
    f2 = f1.filter(lambda y: {"keep": y > 20.0})
    return f2.map_rows(lambda y: {"q": y + 0.5})


def test_filter_chain_bit_identical():
    fused, dt_ = _shared_delta(TREG, lambda: _filter_chain(tft).collect())
    assert len(fused) == 29
    _rows_equal(fused, _unfused(lambda: _filter_chain(tft).collect()))
    ref, dj = _shared_delta(JREG, lambda: _filter_chain(tfs).collect())
    _rows_equal(fused, ref)
    assert dt_ == dj
    assert tft.explain_plan(_filter_chain(tft)) == tfs.explain_plan(_filter_chain(tfs))


def test_filter_contract_errors_survive_fusion():
    df = tft.frame_from_arrays({"x": np.arange(4, dtype=np.float32)})
    with pytest.raises(ValueError, match="bool"):
        df.filter(lambda x: {"keep": x * 2.0}).collect()
    with pytest.raises(ValueError, match="exactly one"):
        df.filter(lambda x: {"a": x > 1.0, "b": x > 2.0})


def test_host_string_columns_ride_through_fused_chains():
    def build(P):
        fr = P.frame_from_rows(
            [{"x": float(i), "tag": f"r{i}"} for i in range(12)], num_blocks=2,
        )
        f1 = P.map_blocks(lambda x: {"y": x + 1.0}, fr)
        f2 = f1.map_rows(lambda y: {"z": y * 3.0})
        return f2.filter(lambda z: {"keep": z > 9.0}).collect()

    fused = build(tft)
    _rows_equal(fused, _unfused(lambda: build(tft)))
    _rows_equal(fused, build(tfs))


def test_fused_chain_runs_one_program_per_block():
    fr = tft.frame_from_arrays({"x": np.arange(32, dtype=np.float32)}, num_blocks=4)
    p1 = tft.compile_program(lambda x: {"y": x + 1.0}, fr)
    f1 = tft.map_blocks(p1, fr)
    p2 = tft.compile_program(lambda y: {"z": y * 2.0}, f1)
    f2 = tft.map_blocks(p2, f1)
    p3 = tft.compile_program(lambda z: {"w": z - 3.0}, f2)

    def build():
        return tft.map_blocks(p3, tft.map_blocks(p2, tft.map_blocks(p1, fr)))

    out = build()
    fused = tir.resolve_chain(out._plan)
    assert [n.kind for n in fused[1]] == ["map", "map", "map"]
    out.blocks()
    # steady state: the same stage Programs reuse the cached fused one
    from tensorframes_tpu_torch.plan import lower as tlower

    key_count = len(tlower._FUSED_CACHE)
    build().blocks()
    assert len(tlower._FUSED_CACHE) == key_count
    np.testing.assert_array_equal(
        build().column_values("w"), (np.arange(32, dtype=np.float32) + 1.0) * 2.0 - 3.0
    )


def test_fused_stage_metrics_and_trace():
    from tensorframes_tpu_torch.observability import events

    fr = tft.frame_from_arrays({"x": np.arange(16, dtype=np.float32)}, num_blocks=2)
    fused0 = _value(TREG, "tftpu_plan_fused_stages_total")
    avoided0 = _value(TREG, "tftpu_plan_intermediate_bytes_avoided_total")
    events.clear()
    events.enable()
    try:
        f2 = tft.map_blocks(lambda y: {"z": y * 2.0},
                            tft.map_blocks(lambda x: {"y": x + 1.0}, fr))
        f2.select(["z"]).blocks()
    finally:
        events.disable()
    assert _value(TREG, "tftpu_plan_fused_stages_total") == fused0 + 2
    # y (16 f32 rows) was consumed on the device, never materialized
    assert _value(TREG, "tftpu_plan_intermediate_bytes_avoided_total") == avoided0 + 64
    names = {e["name"] for e in events.TRACER.to_chrome_trace()["traceEvents"]}
    assert {"plan.lower", "plan.execute", "executor.run_block"} <= names


# ---------------------------------------------------------------------------
# select pushdown
# ---------------------------------------------------------------------------

def test_select_pushdown_skips_pruned_stage_and_gather():
    wide, n = 256, 64

    def build():
        fr = tft.frame_from_arrays(
            {"x": np.arange(n, dtype=np.float32),
             "w": np.zeros((n, wide), dtype=np.float32)},
            num_blocks=2,
        )
        f1 = tft.map_blocks(lambda x: {"y": x + 1.0}, fr)
        f2 = tft.map_blocks(lambda w: {"big": w * 2.0}, f1)
        return f2.select(["y"]).collect()

    g0 = _GATHER_BYTES.value
    fused = build()
    fused_bytes = _GATHER_BYTES.value - g0
    g1 = _GATHER_BYTES.value
    unfused = _unfused(build)
    unfused_bytes = _GATHER_BYTES.value - g1
    _rows_equal(fused, unfused)
    assert unfused_bytes >= n * wide * 4
    assert fused_bytes <= unfused_bytes - n * wide * 4


def test_all_pruned_segment_projects_without_dispatch():
    def build(P):
        fr = P.frame_from_arrays(
            {"x": np.arange(10, dtype=np.float32), "k": np.arange(10) % 3},
            num_blocks=2,
        )
        f1 = P.map_blocks(lambda x: {"y": x + 1.0}, fr)
        return f1.select(["k"])

    before = _value(TREG, "tftpu_plan_fused_stages_total")
    out, dt_ = _shared_delta(TREG, lambda: build(tft).collect())
    ref, dj = _shared_delta(JREG, lambda: build(tfs).collect())
    assert _value(TREG, "tftpu_plan_fused_stages_total") == before
    assert dt_ == dj == {}
    _rows_equal(out, ref)
    _rows_equal(out, _unfused(lambda: build(tft).collect()))


def test_select_over_pending_frame_prunes_intermediate():
    fr = tft.frame_from_arrays({"x": np.arange(10, dtype=np.float64)}, num_blocks=2)
    f2 = tft.map_blocks(lambda x: {"y": x + 1.0}, fr).map_rows(lambda y: {"z": y * 2.0})
    out = f2.select(["z"])
    assert all(set(b) == {"z"} for b in out.blocks())
    np.testing.assert_array_equal(
        out.column_values("z"), (np.arange(10, dtype=np.float64) + 1) * 2
    )


def test_forced_intermediate_reroots_chain():
    fr = tft.frame_from_arrays({"x": np.arange(12, dtype=np.float32)}, num_blocks=3)
    f1 = tft.map_blocks(lambda x: {"y": x + 1.0}, fr)
    f2 = tft.map_blocks(lambda y: {"z": y * 2.0}, f1)
    f3 = tft.map_blocks(lambda z: {"w": z - 1.0}, f2)
    f2.blocks()  # forced after f3 chained on it
    assert f1._plan is not None and not f1.is_materialized
    src, nodes = tir.resolve_chain(f3._plan)
    assert src is f2 and [repr(n) for n in nodes] == ["map_blocks(w)"]
    assert tft.explain_plan(f3).startswith("source (materialized")
    fused0 = _value(TREG, "tftpu_plan_fused_stages_total")
    got = f3.column_values("w")
    # one stage left: the single-verb path, nothing fused, f1 never forced
    assert _value(TREG, "tftpu_plan_fused_stages_total") == fused0
    assert not f1.is_materialized
    np.testing.assert_array_equal(got, (np.arange(12, dtype=np.float32) + 1) * 2 - 1)


def test_plan_dropped_after_force():
    fr = tft.frame_from_arrays({"x": np.arange(6, dtype=np.float32)}, num_blocks=2)
    f2 = tft.map_blocks(lambda y: {"z": y * 2.0},
                        tft.map_blocks(lambda x: {"y": x + 1.0}, fr))
    assert f2._plan is not None
    f2.blocks()
    assert f2._plan is None


def test_fusion_knob_honored_at_force_time():
    fr = tft.frame_from_arrays({"x": np.arange(12, dtype=np.float32)}, num_blocks=2)
    chain = tft.map_blocks(lambda y: {"z": y * 2.0},
                           tft.map_blocks(lambda x: {"y": x + 1.0}, fr))
    assert chain._plan is not None
    fused0 = _value(TREG, "tftpu_plan_fused_stages_total")
    rows = _unfused(chain.collect)
    assert [r["z"] for r in rows] == [(x + 1.0) * 2.0 for x in range(12)]
    assert _value(TREG, "tftpu_plan_fused_stages_total") == fused0


def test_branched_chain_materializes_shared_prefix_once():
    fr = tft.frame_from_arrays({"x": np.arange(10, dtype=np.float32)}, num_blocks=2)
    f1 = tft.map_blocks(lambda x: {"y": x + 1.0}, fr)
    f2 = tft.map_blocks(lambda y: {"z": y * 2.0}, f1)  # extends f1
    f3 = tft.map_blocks(lambda y: {"w": y - 1.0}, f1)  # branches off
    np.testing.assert_array_equal(f2.column_values("z"),
                                  (np.arange(10, dtype=np.float32) + 1) * 2)
    assert not f1.is_materialized
    np.testing.assert_array_equal(f3.column_values("w"), np.arange(10, dtype=np.float32))
    assert f1.is_materialized


# ---------------------------------------------------------------------------
# barriers split the plan, never change semantics
# ---------------------------------------------------------------------------

def _callback_program(calls):
    """A stage that reads a value back to the host with ``.item()`` (a
    host callback): declared outputs, so the verb does not analyze it."""
    def fn(feeds):
        y = feeds["y"]
        calls.append(float(y.sum().item()))
        return {"c": y + 1.0}

    return Program(
        fn, [TensorSpec("y", tdt.float32, Shape((Unknown,)))],
        [TensorSpec("c", tdt.float32, Shape((Unknown,)))],
    )


def test_item_program_is_a_callback():
    assert tir.program_has_callback(_callback_program([]))
    pure = analyze_program(
        Program(lambda f: {"c": f["y"] + 1.0},
                [TensorSpec("y", tdt.float32, Shape((Unknown,)))]), device="cpu")
    assert not tir.program_has_callback(pure)
    pure._tftpu_has_callback = True  # an explicit declaration wins
    assert tir.program_has_callback(pure)


@pytest.mark.parametrize("pruned", [False, True], ids=["kept", "pruned"])
def test_host_callback_stage_replays_per_stage(pruned):
    def build(calls):
        fr = tft.frame_from_arrays({"x": np.arange(8, dtype=np.float32)}, num_blocks=2)
        f1 = tft.map_blocks(lambda x: {"y": x * 2.0}, fr)
        f2 = tft.map_blocks(_callback_program(calls), f1)
        if pruned:
            # select drops the callback's output: pushdown must NOT elide
            # the stage, its side effect fires as with fusion off
            return f2.select(["y"]).collect()
        return tft.map_blocks(lambda c: {"d": c - 1.0}, f2).collect()

    key = dict(reason="host_callback")
    b0 = _value(TREG, "tftpu_plan_fallback_total", **key)
    fused_calls, unfused_calls = [], []
    fused = build(fused_calls)
    assert _value(TREG, "tftpu_plan_fallback_total", **key) == b0 + 1
    _rows_equal(fused, _unfused(lambda: build(unfused_calls)))
    assert fused_calls == unfused_calls and len(fused_calls) == 2
    col = "y" if pruned else "d"
    assert [r[col] for r in fused] == [float(x) * 2.0 for x in range(8)]


def test_callback_chain_barrier_is_named():
    fr = tft.frame_from_arrays({"x": np.arange(8, dtype=np.float32)}, num_blocks=2)
    f1 = tft.map_blocks(lambda x: {"y": x * 2.0}, fr)
    f2 = tft.map_blocks(_callback_program([]), f1)
    n_maps, barriers = tir.chain_barriers(f2)
    assert n_maps == 2
    assert any("host callback in map_blocks" in b["reason"] for b in barriers)


def test_trim_map_is_a_barrier_and_chain_still_correct():
    def build(P):
        fr = P.frame_from_arrays({"x": np.arange(12, dtype=np.float32)}, num_blocks=2)
        f1 = P.map_blocks(lambda x: {"y": x + 1.0}, fr)
        trimmed = P.map_blocks(lambda y: {"t": y[:3]}, f1, trim=True)
        return P.map_blocks(lambda t: {"u": t * 2.0}, trimmed)

    out = build(tft)
    _, barriers = tir.chain_barriers(out)
    assert [b["reason"] for b in barriers] == [
        "trim map_blocks (row-count-changing output)"]
    fused = out.collect()
    assert len(fused) == 6
    _rows_equal(fused, _unfused(lambda: build(tft).collect()))
    _rows_equal(fused, build(tfs).collect())


def test_repartition_is_a_barrier():
    fr = tft.frame_from_arrays({"x": np.arange(12, dtype=np.float32)}, num_blocks=2)
    f1 = tft.map_blocks(lambda x: {"y": x + 1.0}, fr)
    rp = f1.repartition(3)
    assert rp._fusion_barrier == "repartition materialization"
    f2 = tft.map_blocks(lambda y: {"z": y * 2.0}, rp)
    _, barriers = tir.chain_barriers(f2)
    assert [b["reason"] for b in barriers] == ["repartition materialization"]
    np.testing.assert_array_equal(f2.column_values("z"),
                                  (np.arange(12, dtype=np.float32) + 1) * 2)


def test_device_change_between_stages_is_a_barrier():
    fr = tft.frame_from_arrays({"x": np.arange(8, dtype=np.float32)}, num_blocks=2)
    f1 = tft.map_blocks(lambda x: {"y": x + 1.0}, fr, device="cpu")
    # a chain recorded for the card (its stages would run there)
    f1._plan.device = torch.device("cuda", 0)
    f2 = tft.map_blocks(lambda y: {"z": y * 2.0}, f1, device="cpu")
    src, nodes = tir.resolve_chain(f2._plan)
    assert src is f1 and [n.kind for n in nodes] == ["map"]
    assert not f1._plan._extended  # the cpu stage did not extend the chain
    _, barriers = tir.chain_barriers(f2)
    assert [b["reason"] for b in barriers] == ["device change: cuda:0 -> cpu"]
    # same device: the chain extends and fuses
    g1 = tft.map_blocks(lambda x: {"y": x + 1.0}, fr, device="cpu")
    g2 = tft.map_blocks(lambda y: {"z": y * 2.0}, g1, device="cpu")
    assert tir.resolve_chain(g2._plan)[0] is fr
    assert g2._plan.device == torch.device("cpu")


def test_ragged_source_falls_back_and_matches():
    def build(P):
        rows = [{"v": np.arange(k, dtype=np.float64)} for k in (2, 5, 2, 3, 5)]
        fr = P.frame_from_rows(rows, num_blocks=1)
        g1 = P.map_rows(lambda v: {"s": v.sum()}, fr)
        return g1.map_rows(lambda s: {"t": s + 1.0}).collect()

    key = dict(reason="ragged")
    b0 = _value(TREG, "tftpu_plan_fallback_total", **key)
    fused = build(tft)
    assert _value(TREG, "tftpu_plan_fallback_total", **key) == b0 + 1
    _rows_equal(fused, _unfused(lambda: build(tft)))
    _rows_equal(fused, build(tfs))


# ---------------------------------------------------------------------------
# aggregate epilogues
# ---------------------------------------------------------------------------

def _agg_chain(P, dtype, op, keys_kind="int", n=48, num_blocks=3):
    """map -> map_rows -> aggregate over a multi-block frame; small
    integers, so every dtype's result is exact."""
    rng = np.random.default_rng(5)
    cols = {"x": (np.arange(n) % 7).astype(dtype)}
    if keys_kind == "int":
        cols["k"] = rng.integers(0, 5, n).astype(np.int64)
        fr = P.frame_from_arrays(cols, num_blocks=num_blocks)
    else:
        rows = [{"k": f"g{rng.integers(0, 5)}", "x": dtype(int(v))} for v in cols["x"]]
        fr = P.frame_from_rows(rows, num_blocks=num_blocks)
    f1 = P.map_blocks(lambda x: {"y": x + x}, fr)
    f2 = f1.map_rows(lambda y: {"z": y * y})
    with P.with_graph():
        z_in = P.block(f2, "z", tf_name="z_input")
        fetch = getattr(P, op)(z_in, axis=0, name="z")
        agg = P.aggregate(fetch, f2.group_by("k"))
    return agg, f2


AGG_DTYPES = [np.int32, np.int64, np.float32, np.float64]
AGG_OPS = ["reduce_sum", "reduce_min", "reduce_max", "reduce_mean"]


@pytest.mark.parametrize("dtype", AGG_DTYPES, ids=lambda d: d.__name__)
@pytest.mark.parametrize("op", AGG_OPS)
def test_aggregate_epilogue_bit_identical(dtype, op):
    agg, chain_frame = _agg_chain(tft, dtype, op)
    assert not agg.is_materialized and agg._plan.kind == "aggregate"
    fused, dt_ = _shared_delta(TREG, agg.collect)
    assert not chain_frame.is_materialized, (
        "a fused aggregate must not materialize the mapped chain")
    unfused = _unfused(lambda: _agg_chain(tft, dtype, op)[0].collect())
    _rows_equal(fused, unfused)
    jagg, _ = _agg_chain(tfs, dtype, op)
    ref, dj = _shared_delta(JREG, jagg.collect)
    _rows_equal(fused, ref)
    exact = op in ("reduce_min", "reduce_max") or np.dtype(dtype).kind == "i"
    assert dt_ == dj == {"epilogue_per_block" if exact else "epilogue_concat": 1.0}
    assert tft.explain_plan(agg) == tfs.explain_plan(jagg)


@pytest.mark.parametrize("op", ["reduce_sum", "reduce_mean"])
def test_aggregate_epilogue_string_keys_bit_identical(op):
    fused = _agg_chain(tft, np.float32, op, keys_kind="str")[0].collect()
    _rows_equal(fused, _unfused(
        lambda: _agg_chain(tft, np.float32, op, keys_kind="str")[0].collect()))
    _rows_equal(fused, _agg_chain(tfs, np.float32, op, keys_kind="str")[0].collect())


def test_aggregate_random_floats_within_the_sum_tolerance():
    rng = np.random.default_rng(11)
    n = 3000
    x = rng.standard_normal(n).astype(np.float32)
    k = rng.integers(0, 40, n)

    def build(P):
        fr = P.frame_from_arrays({"x": x, "k": k}, num_blocks=4)
        f1 = P.map_blocks(lambda x: {"y": x * 1.5 + 0.25}, fr)
        with P.with_graph():
            y_in = P.block(f1, "y", tf_name="y_input")
            return P.aggregate([P.reduce_sum(y_in, axis=0, name="y")],
                               f1.group_by("k")).collect()

    fused = build(tft)
    _rows_equal(fused, _unfused(lambda: build(tft)))
    ref = build(tfs)
    y = x * np.float32(1.5) + np.float32(0.25)
    counts = np.bincount(k, minlength=40)
    vmax = float(np.abs(y).max())
    for rp, rr in zip(fused, ref):
        assert rp["k"] == rr["k"]
        atol = 1e-5 * vmax * np.sqrt(counts[rp["k"]])
        assert abs(rp["y"] - rr["y"]) <= 1e-5 * abs(rr["y"]) + atol


def test_aggregate_epilogue_metrics_and_laziness():
    b0 = _value(TREG, "tftpu_plan_fused_epilogues_total", verb="aggregate")
    s0 = _value(TREG, "tftpu_plan_fused_stages_total")
    a0 = _value(TREG, "tftpu_plan_intermediate_bytes_avoided_total")
    agg, chain_frame = _agg_chain(tft, np.float32, "reduce_sum")
    agg.blocks()
    assert _value(TREG, "tftpu_plan_fused_epilogues_total", verb="aggregate") == b0 + 1
    assert _value(TREG, "tftpu_plan_fused_stages_total") == s0 + 2
    # y and z (48 f32 rows each) never reached the host
    assert _value(TREG, "tftpu_plan_intermediate_bytes_avoided_total") == a0 + 2 * 48 * 4
    assert not chain_frame.is_materialized


def test_aggregate_computed_key_falls_back_and_matches():
    def build(P):
        fr = P.frame_from_arrays({"x": (np.arange(24) % 6).astype(np.int64)}, num_blocks=2)
        f1 = P.map_blocks(lambda x: {"kk": x % 3, "y": x * 2}, fr)
        with P.with_graph():
            y_in = P.block(f1, "y", tf_name="y_input")
            return P.aggregate(P.reduce_sum(y_in, axis=0, name="y"), f1.group_by("kk"))

    key = dict(reason="computed_key")
    b0 = _value(TREG, "tftpu_plan_fallback_total", **key)
    agg = build(tft)
    fused = agg.collect()
    assert _value(TREG, "tftpu_plan_fallback_total", **key) == b0 + 1
    assert tir.unfused_epilogues(agg)[0]["verb"] == "aggregate"
    _rows_equal(fused, _unfused(lambda: build(tft).collect()))
    _rows_equal(fused, build(tfs).collect())


def test_aggregate_nonalgebraic_fetch_is_marked_unfused():
    fr = tft.frame_from_arrays({"k": np.array([0, 1, 0, 1]), "x": np.arange(4, dtype=np.float32)})
    f1 = tft.map_blocks(lambda x: {"y": x * 2.0}, fr)
    agg = tft.aggregate(
        lambda y_input: {"y": y_input.max(dim=0).values - y_input.min(dim=0).values},
        f1.group_by("k"),
    )
    assert agg.is_materialized
    (entry,) = tir.unfused_epilogues(agg)
    assert "non-algebraic" in entry["reason"]
    np.testing.assert_array_equal(agg.column_values("y"), [4.0, 4.0])


def test_aggregate_ragged_source_falls_back_and_matches():
    def build(P):
        rows = [{"k": i % 3, "v": np.arange(1 + i % 4, dtype=np.float32)} for i in range(18)]
        fr = P.frame_from_rows(rows, num_blocks=2)
        f1 = P.map_rows(lambda v: {"s": v.sum()}, fr)
        with P.with_graph():
            s_in = P.block(f1, "s", tf_name="s_input")
            return P.aggregate(P.reduce_sum(s_in, axis=0, name="s"),
                               f1.group_by("k")).collect()

    key = dict(reason="ragged")
    b0 = _value(TREG, "tftpu_plan_fallback_total", **key)
    fused = build(tft)
    assert _value(TREG, "tftpu_plan_fallback_total", **key) >= b0 + 1
    _rows_equal(fused, _unfused(lambda: build(tft)))
    _rows_equal(fused, build(tfs))


def test_aggregate_empty_after_filter_keeps_schema():
    def build(P):
        fr = P.frame_from_arrays(
            {"k": np.arange(8, dtype=np.int64), "x": np.arange(8, dtype=np.float32)},
            num_blocks=2)
        f1 = P.map_blocks(lambda x: {"y": x * 2.0}, fr)
        f2 = f1.filter(lambda y: {"keep": y > 1e9})
        with P.with_graph():
            y_in = P.block(f2, "y", tf_name="y_input")
            return P.aggregate(P.reduce_sum(y_in, axis=0, name="y"), f2.group_by("k"))

    agg = build(tft)
    assert agg.num_rows == 0 and agg.schema.names == ["k", "y"]
    _rows_equal(agg.collect(), _unfused(lambda: build(tft).collect()))


def test_segment_bucket_is_the_references_alone():
    """The reference pads a varying group count to a power of two so its
    compiled epilogue is reused (``bucket_segments``); the port's kernels
    take K as an argument, so it runs every count at its true K and
    counts no such decision. Both give the same rows."""
    def run(P):
        out = []
        for ng in (3, 5, 6, 7):  # four distinct group counts for one op set
            fr = P.frame_from_arrays(
                {"k": (np.arange(40) % ng).astype(np.int64),
                 "x": (np.arange(40) % 4).astype(np.int64)}, num_blocks=2)
            f1 = P.map_blocks(lambda x: {"zq": x + 1}, fr)
            with P.with_graph():
                z_in = P.block(f1, "zq", tf_name="zq_input")
                out.append(P.aggregate(P.reduce_sum(z_in, axis=0, name="zq"),
                                       f1.group_by("k")).collect())
        return out

    tb, jb = (_decisions(r).get("bucket_segments", 0.0) for r in (TREG, JREG))
    got = run(tft)
    ref = run(tfs)
    assert _decisions(JREG).get("bucket_segments", 0.0) > jb  # the JAX leg bucketed
    assert _decisions(TREG).get("bucket_segments", 0.0) == tb
    for a, b in zip(got, ref):
        _rows_equal(a, b)


# ---------------------------------------------------------------------------
# reduce epilogues
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", AGG_DTYPES, ids=lambda d: d.__name__)
def test_reduce_blocks_fused_bit_identical(dtype):
    def build(P):
        fr = P.frame_from_arrays({"x": (np.arange(30) % 5).astype(dtype)}, num_blocks=3)
        f2 = P.map_blocks(lambda x: {"y": x + x}, fr).map_rows(lambda y: {"z": y * y})
        return P.reduce_blocks(_sum0(P), f2), f2

    e0 = _value(TREG, "tftpu_plan_fused_epilogues_total", verb="reduce_blocks")
    fused, chain_frame = build(tft)
    assert not chain_frame.is_materialized
    assert _value(TREG, "tftpu_plan_fused_epilogues_total", verb="reduce_blocks") == e0 + 1
    unfused, _ = _unfused(lambda: build(tft))
    np.testing.assert_array_equal(np.asarray(fused), np.asarray(unfused))
    assert np.asarray(fused).dtype == np.asarray(unfused).dtype
    np.testing.assert_array_equal(np.asarray(fused), np.asarray(build(tfs)[0]))


@pytest.mark.parametrize("dtype", [np.float32, np.int64], ids=lambda d: d.__name__)
def test_reduce_rows_fused_bit_identical(dtype):
    def build(P):
        fr = P.frame_from_arrays({"x": (np.arange(17) % 5).astype(dtype)}, num_blocks=4)
        f1 = P.map_blocks(lambda x: {"y": x * dtype(2)}, fr)
        return P.reduce_rows(lambda y_1, y_2: {"y": y_1 + y_2}, f1), f1

    e0 = _value(TREG, "tftpu_plan_fused_epilogues_total", verb="reduce_rows")
    fused, chain_frame = build(tft)
    assert not chain_frame.is_materialized
    assert _value(TREG, "tftpu_plan_fused_epilogues_total", verb="reduce_rows") == e0 + 1
    unfused, _ = _unfused(lambda: build(tft))
    np.testing.assert_array_equal(np.asarray(fused), np.asarray(unfused))
    np.testing.assert_array_equal(np.asarray(fused), np.asarray(build(tfs)[0]))


def test_reduce_callback_chain_runs_eagerly():
    calls = []
    fr = tft.frame_from_arrays({"x": np.arange(6, dtype=np.float32)}, num_blocks=2)
    f1 = tft.map_blocks(lambda x: {"y": x * 2.0}, fr)
    f2 = tft.map_blocks(_callback_program(calls), f1)
    out = tft.reduce_blocks(lambda c_input: {"c": c_input.sum(dim=0)}, f2)
    assert float(out) == float(((np.arange(6) * 2.0) + 1.0).sum())
    assert len(calls) == 2


# ---------------------------------------------------------------------------
# joins in the plan
# ---------------------------------------------------------------------------

def _join_frames(P, keys_kind="int"):
    if keys_kind == "int":
        left = P.frame_from_arrays(
            {"k": np.array([0, 1, 2, 1, 3], np.int64), "x": np.arange(5, dtype=np.float32)},
            num_blocks=2)
        right = P.frame_from_arrays(
            {"k": np.array([1, 2, 4], np.int64), "w": np.array([10.0, 20.0, 40.0], np.float32)})
    else:
        left = P.frame_from_rows([{"k": f"g{i % 3}", "x": float(i)} for i in range(6)],
                                 num_blocks=2)
        right = P.frame_from_rows([{"k": "g0", "w": 10.0}, {"k": "g2", "w": 20.0}])
    return left, right


@pytest.mark.parametrize("how,fill", [
    ("inner", None), ("left", 0.0), ("right", 0.0), ("outer", -1.0),
])
@pytest.mark.parametrize("keys_kind", ["int", "str"])
def test_join_plan_matches_unfused(how, fill, keys_kind):
    def build(P):
        left, right = _join_frames(P, keys_kind)
        f1 = P.map_blocks(lambda x: {"y": x * 2.0}, left)
        kw = {} if fill is None else {"fill_value": fill}
        return f1.join(right, on="k", how=how, **kw).collect()

    fused = build(tft)
    _rows_equal(fused, _unfused(lambda: build(tft)))
    _rows_equal(fused, build(tfs))


def test_join_result_is_lazy_and_plan_carrying():
    left, right = _join_frames(tft)
    f1 = tft.map_blocks(lambda x: {"y": x * 2.0}, left)
    j = f1.join(right, on="k")
    assert not j.is_materialized and j._plan is not None
    assert "join(on=['k'], how='inner')" in tft.explain_plan(j)
    e0 = _value(TREG, "tftpu_plan_fused_epilogues_total", verb="join")
    j.blocks()
    assert _value(TREG, "tftpu_plan_fused_epilogues_total", verb="join") == e0 + 1
    assert not f1.is_materialized  # the probe maps fused into the join


def test_join_pushdown_prunes_both_sides():
    wide, n, nr = 256, 64, 2048

    def build(select_cols):
        left = tft.frame_from_arrays(
            {"k": (np.arange(n) % 8).astype(np.int64), "x": np.arange(n, dtype=np.float32),
             "lsrc": np.ones((n, wide), np.float32)}, num_blocks=2)
        right_src = tft.frame_from_arrays(
            {"k": (np.arange(nr) % 8).astype(np.int64), "w": np.arange(nr, dtype=np.float32),
             "rsrc": np.ones((nr, wide), np.float32)})
        right = tft.map_blocks(lambda rsrc: {"rbig": rsrc * 2.0}, right_src)
        f1 = tft.map_blocks(lambda x: {"y": x * 2.0}, left)
        f2 = tft.map_blocks(lambda lsrc: {"lbig": lsrc * 2.0}, f1)
        return f2.join(right, on="k").select(select_cols).collect()

    g0 = _GATHER_BYTES.value
    build(["k", "y", "w"])
    pruned_bytes = _GATHER_BYTES.value - g0
    g0 = _GATHER_BYTES.value
    build(["k", "y", "w", "lbig", "rbig"])
    full_bytes = _GATHER_BYTES.value - g0
    assert pruned_bytes < full_bytes / 4, (pruned_bytes, full_bytes)


def _map_join_agg(P, n=96, ng=8):
    rng = np.random.default_rng(2)
    left = P.frame_from_arrays(
        {"k": rng.integers(0, ng, n).astype(np.int32),
         "x": (np.arange(n) % 16).astype(np.float32), "dead": np.ones(n, np.float32)},
        num_blocks=3)
    right = P.frame_from_arrays({"k": np.arange(ng, dtype=np.int32),
                                 "w": np.arange(ng, dtype=np.float32)})
    f2 = P.map_blocks(lambda y: {"z": y * y}, P.map_blocks(lambda x: {"y": x * 2.0 + 1.0}, left))
    j = f2.join(right, on="k")
    with P.with_graph():
        fz = P.reduce_sum(P.block(j, "z", tf_name="z_input"), axis=0, name="z")
        fw = P.reduce_sum(P.block(j, "w", tf_name="w_input"), axis=0, name="w")
        return P.aggregate([fz, fw], j.group_by("k")), f2


def test_map_join_aggregate_pipeline_bit_identical():
    agg, chain = _map_join_agg(tft)
    fused, dt_ = _shared_delta(TREG, agg.collect)
    assert not chain.is_materialized
    _rows_equal(fused, _unfused(lambda: _map_join_agg(tft)[0].collect()))
    jagg, _ = _map_join_agg(tfs)
    ref, dj = _shared_delta(JREG, jagg.collect)
    _rows_equal(fused, ref)
    assert dt_ == dj == {"fuse": 1.0, "pushdown_ineligible": 1.0}
    assert tft.explain_plan(agg) == tfs.explain_plan(jagg)


def test_join_lossy_fill_raises_even_when_pruned():
    left = tft.frame_from_arrays({"k": np.array([0, 1, 9], np.int64),
                                  "x": np.arange(3, dtype=np.float32)})
    right = tft.frame_from_arrays({"k": np.array([0, 1], np.int64),
                                   "w": np.array([1.0, 2.0], np.float32),
                                   "tag": np.array([7, 8], np.int64)})
    f1 = tft.map_blocks(lambda x: {"y": x * 2.0}, left)
    for fused in (True, False):
        tft.configure(plan_fusion=fused)
        with pytest.raises(ValueError, match="representable"):
            f1.join(right, on="k", how="left",
                    fill_value={"w": 0.0, "tag": -1.5}).select(["k", "y", "w"]).collect()
    tft.configure(plan_fusion=True)


# ---------------------------------------------------------------------------
# laziness, estimates, metrics registration, explain, costs
# ---------------------------------------------------------------------------

def test_estimated_rows_never_forces():
    fr = tft.frame_from_arrays({"x": np.arange(20, dtype=np.float32)}, num_blocks=2)
    f1 = tft.map_blocks(lambda x: {"y": x + 1.0}, fr)
    f2 = f1.map_rows(lambda y: {"z": y * 2.0}).select(["z"])
    assert f2.estimated_rows == 20 and f2.estimated_bytes == 20 * 4
    filt = f1.filter(lambda y: {"keep": y > 3.0})
    assert filt.estimated_rows is None
    lazy_src = fr.with_column_renamed("x", "x2")
    assert tft.map_blocks(lambda x2: {"q": x2}, lazy_src).estimated_rows is None
    assert not any(f.is_materialized for f in (f1, f2, filt, lazy_src))


def test_plan_metric_families_registered_at_import():
    import subprocess
    import sys

    code = (
        "import tensorframes_tpu_torch\n"
        "from tensorframes_tpu_torch.observability.metrics import REGISTRY\n"
        "print(sorted({d['name'] for d in REGISTRY.snapshot()\n"
        "              if d['name'].startswith(('tftpu_plan', 'tftpu_trace'))}))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=str(__import__("pathlib").Path(__file__).parents[1]))
    assert out.returncode == 0, out.stderr
    names = eval(out.stdout.strip())
    assert names == [
        "tftpu_plan_cost_decisions_total",
        "tftpu_plan_fallback_total",
        "tftpu_plan_fused_epilogues_total",
        "tftpu_plan_fused_stages_total",
        "tftpu_plan_intermediate_bytes_avoided_total",
        "tftpu_plan_lowering_seconds",
        "tftpu_plan_reopt_sidecar_total",
        "tftpu_plan_stage_wall_seconds",
        "tftpu_plan_strategy_wall_seconds",
        "tftpu_trace_events_dropped_total",
    ]
    # the shared decision kinds keep the reference's labels; the kernel
    # lowerings are the port's
    kinds = set(_decisions(TREG))
    assert set(SHARED_KINDS) <= kinds
    assert {"cuda_segment_reduce", "torch_segment_reduce", "cuda_ragged_gather",
            "cuda_decode_attn", "torch_decode_attn"} <= kinds
    assert not any(k.startswith(("pallas", "jit_", "xla_", "host_")) for k in kinds)


def test_explain_plan_text_matches_the_reference():
    def pipelines(P):
        fr = P.frame_from_arrays({"x": np.arange(8, dtype=np.float32),
                                  "k": np.arange(8) % 2}, num_blocks=2)
        f1 = P.map_blocks(lambda x: {"y": x + 1.0}, fr)
        f2 = f1.map_rows(lambda y: {"z": y * 2.0})
        out = [fr, f2.select(["z", "k"]),
               f2.filter(lambda z: {"keep": z > 3.0})]
        with P.with_graph():
            z_in = P.block(f2, "z", tf_name="z_input")
            out.append(P.aggregate(P.reduce_max(z_in, axis=0, name="z"), f2.group_by("k")))
        return out

    for ft, fj in zip(pipelines(tft), pipelines(tfs)):
        assert tft.explain_plan(ft) == tfs.explain_plan(fj)
        assert ft.explain(analyze=False) == fj.explain(analyze=False)


def test_cost_analysis_counts_matmul_flops():
    m, k, n = 8, 784, 10
    w = torch.randn(k, n)
    prog = analyze_program(
        Program(lambda f: {"y": torch.softmax(f["x"] @ w, dim=-1)},
                [TensorSpec("x", tdt.float32, Shape((Unknown, k)))]), device="cpu")
    cost = prog.cost_analysis(probe=m)
    assert cost["flops"] == 2 * m * k * n
    assert cost["bytes accessed"] == (m * k + m * n) * 4
    assert prog.cost_analysis(probe=m) == cost  # memoized
    assert prog.flops_per_row(probe=m) == 2 * k * n
    assert prog.bytes_per_row(probe=m) == (k + n) * 4


def test_stage_costs_ride_the_trace_event():
    """decide_fuse's cost details (flops of a [m, k] @ [k, n] stage) land
    on the ``plan.cost`` event while tracing; untraced, the stages are
    not run an extra time to cost them."""
    from tensorframes_tpu_torch.observability import events

    w = torch.randn(16, 4)
    fr = tft.frame_from_arrays({"x": np.ones((8, 16), np.float32)}, num_blocks=1)

    def build():
        f1 = tft.map_blocks(lambda x: {"y": x @ w}, fr)
        return tft.map_blocks(lambda y: {"z": y + 1.0}, f1).select(["z"])

    out = build()
    stages = [n.program for n in tir.resolve_chain(out._plan)[1] if n.kind == "map"]
    out.blocks()
    assert not any("_cost_cache" in p.__dict__ for p in stages)
    events.clear()
    events.enable()
    try:
        build().blocks()
    finally:
        events.disable()
    (cost,) = [e for e in events.to_chrome_trace()["traceEvents"] if e["name"] == "plan.cost"]
    assert cost["args"]["decision"] == "fuse"
    assert float(cost["args"]["flops"]) == 2 * 8 * 16 * 4
    events.clear()


def test_fused_program_cache_keys_the_device():
    """The same stage Programs chained for another device get their own
    fused program: a cached one never moves a chain to its device."""
    from tensorframes_tpu_torch.plan import lower as tlower

    fr = tft.frame_from_arrays({"x": np.arange(8, dtype=np.float32)}, num_blocks=2)
    p1 = tft.compile_program(lambda x: {"y": x + 1.0}, fr)
    p2 = tft.compile_program(lambda y: {"z": y * 2.0}, tft.map_blocks(p1, fr))

    def chain(device):
        out = tft.map_blocks(p2, tft.map_blocks(p1, fr, device=device), device=device)
        return out, tir.resolve_chain(out._plan)[1]

    out, nodes = chain("cpu")
    out.blocks()
    plan = tlower.plan_segment(nodes, ["z"], fr.schema.names)
    cpu_prog = tlower._fused_program(plan, fr.schema)
    assert cpu_prog.device == torch.device("cpu")
    for n in nodes:  # the same chain, recorded for the card
        n.device = torch.device("cuda", 0)
    card_prog = tlower._fused_program(plan, fr.schema)
    assert card_prog is not cpu_prog and card_prog.device == torch.device("cuda", 0)
