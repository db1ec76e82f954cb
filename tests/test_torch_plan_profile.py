"""The port's plan profiler: EXPLAIN ANALYZE and latency-driven plan
decisions.

* **EXPLAIN ANALYZE** — ``explain(analyze=True)`` on a forced frame
  renders the plan tree followed by the recorded per-stage profile (wall,
  strategy), whose stage walls reconcile with the force's wall;
* **latency-driven flips** — an inverted observed-wall table flips
  ``decide_fuse`` to the per-stage replay on the next execution, counted
  as ``reoptimized``, with the same bits; the pure
  ``pick_by_observed_wall`` core honors min-samples and the margin;
  ``decide_epilogue`` flips only when exact; the kernel decisions
  (``decide_segment_reduce``, ``decide_ragged_gather``,
  ``decide_decode_attention``) read eligibility alone, with the port's
  lowering names, and recorded walls never move a feed off a kernel;
* **offline report** — ``render_report`` over a sidecar directory, and
  the profiler's series are registered at import.

All on the port alone (the JAX package's versions of these checks need
its sidecar path in-process); its rendering helpers are compared with
the reference's where they are pure functions of a record."""

import glob
import os
import time

import numpy as np
import pytest
import torch

from tensorframes_tpu.observability import profile as jprofile

import tensorframes_tpu_torch as tft
from tensorframes_tpu_torch import dtypes as tdt
from tensorframes_tpu_torch.observability import profile
from tensorframes_tpu_torch.observability.metrics import REGISTRY
from tensorframes_tpu_torch.plan import rules
from tensorframes_tpu_torch.plan import stats as plan_stats


@pytest.fixture(autouse=True)
def _plan_defaults(tmp_path, monkeypatch):
    """Fusion and re-optimization on, on the CPU, with the stats sidecar
    in a temporary ``TFTPU_COMPILE_CACHE``."""
    cfg = tft.get_config()
    before = (cfg.device, cfg.plan_fusion, cfg.plan_reopt)
    tft.configure(device="cpu", plan_fusion=True, plan_reopt=True)
    monkeypatch.setattr(cfg, "compilation_cache_dir", str(tmp_path))
    plan_stats.clear_memory()
    plan_stats.reset_strategy_walls(unlink_sidecar=False)
    yield
    plan_stats.reset_strategy_walls()
    plan_stats.clear_memory()
    tft.configure(device=before[0], plan_fusion=before[1], plan_reopt=before[2])


def _count(kind):
    for d in REGISTRY.snapshot():
        if (d["name"] == "tftpu_plan_cost_decisions_total"
                and d["labels"].get("decision") == kind):
            return float(d.get("value", 0.0))
    return 0.0


def _rows_equal(a, b):
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        assert ra.keys() == rb.keys()
        for k in ra:
            np.testing.assert_array_equal(np.asarray(ra[k]), np.asarray(rb[k]))


def _fused_chain(n=256, blocks=4):
    """A 2-stage composable map chain — decide_fuse's 'fuse' territory."""
    df = tft.frame_from_arrays({"x": np.arange(float(n), dtype=np.float32)}, num_blocks=blocks)
    f = tft.map_blocks(lambda x: {"u": x * 2.0}, df)
    return tft.map_blocks(lambda u: {"y": u + 1.0}, f)


# ---------------------------------------------------------------------------
# EXPLAIN ANALYZE
# ---------------------------------------------------------------------------

def test_explain_analyze_renders_profile_and_walls_reconcile():
    g = _fused_chain()
    t0 = time.perf_counter()
    g.collect()
    measured = time.perf_counter() - t0
    fp = getattr(g, "_plan_fp", None)
    assert fp, "the force stashes the plan fingerprint on the frame"
    text = g.explain(analyze=True)
    assert f"profile: fp={fp}" in text and "execs=1" in text and "wall=" in text
    rec = plan_stats.lookup(fp)
    prof = rec["profile"]
    assert [e["stage"] for e in prof] == ["fused"]
    assert prof[0]["strategy"] == "fuse" and prof[0]["rows"] == 256
    assert prof[0]["bytes"] == 0  # u stays a column of the result
    for entry in prof:
        assert f"{entry['stage']}  wall=" in text
    stage_sum = sum(float(e["wall_s"]) for e in prof)
    assert 0.0 < stage_sum <= float(rec["wall_s"]) * 1.05 + 0.01
    assert float(rec["wall_s"]) <= measured * 1.5 + 0.05
    # the offline renderer formats a stage exactly as the reference's
    assert profile._fmt_stage(prof[0]) == jprofile._fmt_stage(prof[0])


def test_explain_analyze_aggregate_and_join_profiles():
    fr = tft.frame_from_arrays({"k": (np.arange(64) % 4).astype(np.int64),
                                "x": np.arange(64, dtype=np.int64)}, num_blocks=2)
    f2 = tft.map_blocks(lambda y: {"z": y + 1},
                        tft.map_blocks(lambda x: {"y": x * 2}, fr))
    with tft.with_graph():
        z_in = tft.block(f2, "z", tf_name="z_input")
        agg = tft.aggregate(tft.reduce_sum(z_in, axis=0, name="z"), f2.group_by("k"))
    agg.blocks()
    prof = plan_stats.lookup(agg._plan_fp)["profile"]
    assert [(e["stage"], e["strategy"]) for e in prof] == [("aggregate", "epilogue_per_block")]
    text = agg.explain(analyze=True)
    assert "aggregate  wall=" in text and "strategy=epilogue_per_block" in text

    dim = tft.frame_from_arrays({"k": np.arange(0, 4, 2, dtype=np.int64),
                                 "w": np.arange(2, dtype=np.int64)})
    j = tft.map_blocks(lambda x: {"y": x * 2}, fr).join(dim, on="k")
    j.blocks()
    prof = plan_stats.lookup(j._plan_fp)["profile"]
    assert [e["stage"] for e in prof] == ["per_stage", "join"]


def test_explain_analyze_before_any_execution_points_at_force():
    g = _fused_chain()
    text = g.explain(analyze=True)
    assert "no recorded execution" in text
    assert "  -> map_blocks(u)" in text and "  -> map_blocks(y)" in text


def test_explain_analyze_reopt_off_says_so():
    tft.configure(plan_reopt=False)
    g = _fused_chain()
    assert "adaptive stats are off" in g.explain(analyze=True)
    g.collect()
    assert "no plan chain and no recorded execution" in g.explain(analyze=True)


def test_explain_analyze_names_barriers_and_unfused_epilogues():
    fr = tft.frame_from_arrays({"x": np.arange(12, dtype=np.float32)}, num_blocks=2)
    f1 = tft.map_blocks(lambda x: {"y": x + 1.0}, fr)

    def chain():
        return tft.map_blocks(lambda y: {"z": y * 2.0}, f1.repartition(2))

    chain().collect()  # records the fingerprint's profile
    text = tft.explain_plan(chain(), analyze=True)  # same pipeline, not forced
    assert "profile: fp=" in text and "execs=1" in text
    assert "TFG107 fusion-barrier: repartition materialization" in text
    fk = tft.frame_from_arrays({"k": np.array([0, 1, 0, 1]), "x": np.arange(4, dtype=np.float32)})
    agg = tft.aggregate(
        lambda y_input: {"y": y_input.amax(dim=0) - y_input.amin(dim=0)},
        tft.map_blocks(lambda x: {"y": x * 2.0}, fk).group_by("k"))
    assert not [ln for ln in profile.profile_lines(agg) if "TFG109" in ln]  # no plan: none
    from tensorframes_tpu_torch.plan import ir

    ir.mark_unfused(agg, "aggregate", "non-algebraic fetches")
    agg._plan_fp = "0" * 32
    plan_stats.record_execution("0" * 32, wall_s=0.001)
    assert "  TFG109 unfused-aggregate: aggregate — non-algebraic fetches" in \
        profile.profile_lines(agg)


# ---------------------------------------------------------------------------
# latency-driven decisions
# ---------------------------------------------------------------------------

def test_inverted_walls_flip_fuse_to_per_stage_bit_identically():
    baseline = _fused_chain().collect()
    walls = plan_stats.strategy_walls("fuse")
    assert walls.get("fuse", {}).get("n", 0) >= 1, (
        "the fused dispatch feeds its wall back into the table")
    for _ in range(max(2, plan_stats.STRATEGY_WALL_MIN_SAMPLES) * 2):
        plan_stats.observe_strategy_wall("fuse", "fuse", 10.0)
        plan_stats.observe_strategy_wall("fuse", "split_single_stage", 1e-4)
    s0, r0 = _count("split_single_stage"), _count("reoptimized")
    flipped = _fused_chain().collect()
    assert _count("split_single_stage") > s0
    assert _count("reoptimized") > r0
    _rows_equal(baseline, flipped)


def test_pick_by_observed_wall_min_samples_and_margin():
    pick = rules.pick_by_observed_wall
    assert pick("fuse", ("split_single_stage",), None) is None
    assert pick("fuse", ("split_single_stage",), {}) is None
    thin = {"fuse": {"ewma_s": 1.0, "n": 1}, "split_single_stage": {"ewma_s": 0.01, "n": 9}}
    assert pick("fuse", ("split_single_stage",), thin) is None
    thin_alt = {"fuse": {"ewma_s": 1.0, "n": 9}, "split_single_stage": {"ewma_s": 0.01, "n": 1}}
    assert pick("fuse", ("split_single_stage",), thin_alt) is None
    close = {"fuse": {"ewma_s": 1.0, "n": 4},
             "split_single_stage": {"ewma_s": rules.LATENCY_FLIP_MARGIN + 0.01, "n": 4}}
    assert pick("fuse", ("split_single_stage",), close) is None
    clear = {"fuse": {"ewma_s": 1.0, "n": 4}, "split_single_stage": {"ewma_s": 0.5, "n": 4}}
    kind, evidence = pick("fuse", ("split_single_stage",), clear)
    assert kind == "split_single_stage" and evidence["latency_flip"] is True
    assert evidence["observed_wall_s"] == {"fuse": 1.0, "split_single_stage": 0.5}
    assert evidence["wall_samples"] == {"fuse": 4, "split_single_stage": 4}


def test_decide_epilogue_flips_only_when_exact():
    walls = {"epilogue_per_block": {"ewma_s": 1.0, "n": 4},
             "epilogue_concat": {"ewma_s": 0.1, "n": 4}}
    d = rules.decide_epilogue([("reduce_sum", np.int32)], num_groups=4, value_bytes=1024,
                              observed_walls=walls)
    assert d.kind == "epilogue_concat" and d.details["latency_flip"] is True
    d = rules.decide_epilogue([("reduce_sum", np.int32)], num_groups=4, value_bytes=1024)
    assert d.kind == "epilogue_per_block"
    d = rules.decide_epilogue([("reduce_sum", np.float32)], num_groups=4, value_bytes=1024,
                              observed_walls=walls)
    assert d.kind == "epilogue_concat" and "latency_flip" not in d.details


def test_decide_decode_attention_names_the_ports_lowerings():
    cuda, cpu = torch.device("cuda", 0), torch.device("cpu")
    assert rules.decide_decode_attention(8, 64, 16, 32, device=cuda).kind == "cuda_decode_attn"
    assert rules.decide_decode_attention(8, 64, 16, 32, device=cpu).kind == "torch_decode_attn"
    assert rules.LOWERING_KINDS["pallas_decode_attn"] == "cuda_decode_attn"


def test_decide_segment_reduce_and_ragged_gather_on_cuda():
    cuda, cpu = torch.device("cuda", 0), torch.device("cpu")
    ops = (("v", "reduce_sum"),)
    f32 = {"v": torch.zeros(10, dtype=torch.float32)}
    i64 = {"v": torch.zeros(10, dtype=torch.int64)}
    i32 = {"v": torch.zeros(10, dtype=torch.int32)}
    assert rules.decide_segment_reduce(ops, f32, 4, device=cuda).kind == "cuda_segment_reduce"
    assert rules.decide_segment_reduce(ops, i32, 4, device=cuda).kind == "cuda_segment_reduce"
    assert rules.decide_segment_reduce(ops, f32, 4, device=cpu).kind == "torch_segment_reduce"
    # int64 fails the fused kernel's eligibility; too many groups too
    assert rules.decide_segment_reduce(ops, i64, 4, device=cuda).kind == "torch_segment_reduce"
    assert rules.decide_segment_reduce(ops, f32, 5000, device=cuda).kind == "torch_segment_reduce"
    assert rules.decide_ragged_gather(100, 4, np.float32, device=cuda).kind == "cuda_ragged_gather"
    bf16 = tdt.bfloat16.np_dtype  # ml_dtypes' kind "V": still a float cell
    assert rules.decide_ragged_gather(100, 4, bf16, device=cuda).kind == "cuda_ragged_gather"
    assert rules.decide_ragged_gather(100, 4, np.dtype(object), device=cuda) is None
    assert rules.decide_ragged_gather(100, 4, np.float32, device=cpu) is None
    assert rules.decide_ragged_gather(0, 0, np.float32, device=cuda) is None


def test_planted_walls_leave_eligible_cuda_feeds_on_the_kernels():
    """Recorded walls that favour the torch routes move no eligible
    CUDA feed off its kernel: the kernel decisions read eligibility
    alone."""
    walls = {
        "segment_reduce": {"cuda_segment_reduce": 1.0, "torch_segment_reduce": 1e-4},
        "ragged_gather": {"cuda_ragged_gather": 1.0, "host_stack": 1e-4},
        "decode_attention": {"cuda_decode_attn": 1.0, "torch_decode_attn": 1e-4},
    }
    for d, t in walls.items():
        for k, w in t.items():
            for _ in range(8):
                plan_stats.observe_strategy_wall(d, k, w)
    assert plan_stats.strategy_walls("segment_reduce")["torch_segment_reduce"]["n"] >= 8
    cuda = torch.device("cuda", 0)
    ops = (("v", "reduce_max"), ("w", "reduce_sum"))
    i32 = {"v": torch.zeros(10, dtype=torch.int32), "w": torch.zeros(10, dtype=torch.int32)}
    assert rules.decide_segment_reduce(ops, i32, 4, device=cuda).kind == "cuda_segment_reduce"
    assert rules.decide_ragged_gather(100, 4, np.int32, device=cuda).kind == "cuda_ragged_gather"
    assert rules.decide_decode_attention(8, 64, 16, 32, device=cuda).kind == "cuda_decode_attn"


def test_eager_aggregate_counts_its_route_and_records_no_walls():
    """An eager aggregate on the CPU counts its torch route and records
    no strategy walls (the kernel decisions keep none)."""
    fr = tft.frame_from_arrays({"k": np.arange(8) % 2, "v": np.arange(8, dtype=np.float32)})
    t0 = _count("torch_segment_reduce")
    with tft.with_graph():
        tft.aggregate(tft.reduce_sum(tft.block(fr, "v", tf_name="v_input"), name="v"),
                      fr.group_by("k"))
    assert _count("torch_segment_reduce") == t0 + 1
    assert plan_stats.strategy_walls("segment_reduce") == {}


# ---------------------------------------------------------------------------
# offline report + registered series
# ---------------------------------------------------------------------------

def test_report_profile_renders_sidecar_offline(tmp_path):
    _fused_chain().collect()
    side = str(tmp_path / "planstats")
    assert glob.glob(os.path.join(side, "*.json"))
    text = profile.render_report(side)
    assert "plan-profile sidecar" in text and "1 fingerprint(s)" in text
    assert "slowest recorded plan stage" in text and "wall=" in text and "fp=" in text
    assert "fuse (obs=1):" in text
    records, skipped = profile.load_profiles(side)
    assert skipped == 0 and profile.top_stages(records, 5) == jprofile.top_stages(records, 5)
    assert profile.load_strategy_walls(side) == jprofile.load_strategy_walls(side)
    # the reference's reader renders the port's sidecar the same way
    assert profile.render_report(side) == jprofile.render_report(side)
    junk = os.path.join(side, "deadbeef" * 4 + ".json")
    with open(junk, "w") as f:
        f.write("{nope")
    assert "1 unreadable file(s) skipped" in profile.render_report(side)
    assert os.path.exists(junk)  # a read-only visitor never deletes


def test_profiler_series_are_preregistered():
    snap = REGISTRY.snapshot()
    stages = {d["labels"].get("stage") for d in snap
              if d["name"] == "tftpu_plan_stage_wall_seconds"}
    assert stages == {"fused", "per_stage", "join", "join_chain", "aggregate", "pushdown",
                      "reduce"}
    pairs = {(d["labels"].get("decision"), d["labels"].get("strategy"))
             for d in snap if d["name"] == "tftpu_plan_strategy_wall_seconds"}
    assert {("fuse", "fuse"), ("fuse", "split_single_stage"),
            ("epilogue", "epilogue_concat"), ("epilogue", "epilogue_per_block")} == pairs
