"""The static analyzer of the port against the JAX package's.

The same programs, written once per package over numpy inputs, through
``lint_program`` and ``analyze_frame`` of both (the port with
``device="cpu"``): the same multiset of (code, severity) for TFG101–
TFG106 and TFG108, input-name subjects exactly, graph-site subjects by
op (a jaxpr equation against an aten node, mapped by :data:`PORT_OPS`).
Then the verbs' ``strict=``, ``lint_plan`` over the same chains, the
serving evidence rules, the CLI over a ``save_program`` artifact and
the package's selfcheck. All comparisons are exact (codes, severities,
subjects, texts where stated).
"""

import json
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensorframes_tpu as tfs
import tensorframes_tpu_torch as tft
from tensorframes_tpu import analysis as janalysis
from tensorframes_tpu import dtypes as jdt
from tensorframes_tpu.frame import TensorFrame as JFrame
from tensorframes_tpu.program import Program as JProgram
from tensorframes_tpu.program import TensorSpec as JSpec
from tensorframes_tpu.shape import Shape as JShape
from tensorframes_tpu_torch import analysis as tanalysis
from tensorframes_tpu_torch import dtypes as tdt
from tensorframes_tpu_torch.analysis import rules as trules
from tensorframes_tpu_torch.frame import TensorFrame as TFrame
from tensorframes_tpu_torch.kernels import LAUNCHES
from tensorframes_tpu_torch.ops import executor as texec
from tensorframes_tpu_torch.program import Program as TProgram
from tensorframes_tpu_torch.program import TensorSpec as TSpec
from tensorframes_tpu_torch.shape import Shape as TShape

ROOT = Path(__file__).resolve().parents[1]
CPU = {"device": "cpu"}
COMPARED = ("TFG101", "TFG102", "TFG103", "TFG104", "TFG105", "TFG106", "TFG108", "TFG111")
#: the port's aten op at a graph site -> the reference's jaxpr primitive
PORT_OPS = {"reciprocal": "div", "_to_copy": "convert_element_type", "log2": "log"}


@pytest.fixture
def restore_config():
    jcfg, tcfg = tfs.configure(), tft.configure()
    keys = ("max_bucket_doublings", "block_budget_bytes")
    saved = ({k: getattr(jcfg, k) for k in keys}, {k: getattr(tcfg, k) for k in keys})
    yield
    tfs.configure(**saved[0])
    tft.configure(**saved[1])


def _summary(report, port: bool):
    out = []
    for d in report:
        if d.code not in COMPARED:
            continue
        subj = d.subject
        if subj.startswith(("eqn#", "node#")):
            op = subj.split(":", 1)[1]
            subj = "site:" + (PORT_OPS.get(op, op) if port else op)
        out.append((d.code, d.severity, subj))
    return sorted(out)


def _frame(P, cols=("x",), n=16, blocks=2):
    return P.frame_from_arrays(
        {c: np.arange(n, dtype=np.float32) + 1.0 + i for i, c in enumerate(cols)},
        num_blocks=blocks,
    )


def _f64_const():
    return np.arange(3.0)


_SEEDED = np.random.default_rng(42).standard_normal(3).astype(np.float32)

#: name -> (columns, the reference's function, the port's function)
CATALOGUE = {
    "add3": (("x",), lambda x: {"z": x + 3.0}, lambda x: {"z": x + 3.0}),
    "log": (("x",), lambda x: {"l": jnp.log(x)}, lambda x: {"l": torch.log(x)}),
    "log_of_positive": (("x",), lambda x: {"l": jnp.log(jnp.exp(x) + 1.0)},
                        lambda x: {"l": torch.log(torch.exp(x) + 1.0)}),
    "div_by_column": (("x", "y"), lambda x, y: {"q": x / y}, lambda x, y: {"q": x / y}),
    "div_by_literal": (("x",), lambda x: {"q": x / 2.0}, lambda x: {"q": x / 2.0}),
    "div_by_negative": (("x",), lambda x: {"q": x / -2.0}, lambda x: {"q": x / -2.0}),
    "reciprocal": (("x",), lambda x: {"q": 1.0 / x}, lambda x: {"q": 1.0 / x}),
    "rsqrt": (("x",), lambda x: {"r": jax.lax.rsqrt(x)}, lambda x: {"r": torch.rsqrt(x)}),
    "sqrt_of_square": (("x",), lambda x: {"s": jnp.sqrt(jnp.square(x))},
                       lambda x: {"s": torch.sqrt(torch.square(x))}),
    "log_of_mixed_concat": (("x",), lambda x: {"l": jnp.log(jnp.concatenate([jnp.exp(x), x]))},
                            lambda x: {"l": torch.log(torch.cat([torch.exp(x), x]))}),
    "log_of_positive_concat": (
        ("x",), lambda x: {"l": jnp.log(jnp.concatenate([jnp.exp(x), jnp.exp(x)]))},
        lambda x: {"l": torch.log(torch.cat([torch.exp(x), torch.exp(x)]))}),
    "softmax_by_hand": (("x",), lambda x: {"s": jnp.exp(x) / jnp.sum(jnp.exp(x))},
                        lambda x: {"s": torch.exp(x) / torch.sum(torch.exp(x))}),
    "softmax": (("x",), lambda x: {"s": jax.nn.softmax(x)},
                lambda x: {"s": torch.softmax(x, -1)}),
    "log_of_relu": (("x",), lambda x: {"l": jnp.log(jax.nn.relu(x))},
                    lambda x: {"l": torch.log(torch.relu(x))}),
    "log_of_clamped": (("x",), lambda x: {"l": jnp.log(jnp.maximum(x, 1e-3))},
                       lambda x: {"l": torch.log(torch.clamp(x, min=1e-3))}),
    "unused_input": (("x", "y"), lambda x, y: {"z": x + 1.0}, lambda x, y: {"z": x + 1.0}),
    "donation_alias": (("x",), lambda x: {"x": x * 1.0}, lambda x: {"x": x * 1.0}),
    "f64_cast": (("x",), lambda x: {"d": x.astype(jnp.float64)}, lambda x: {"d": x.double()}),
    "f64_const": (("x",),
                  lambda x: {"d": x[:, None].astype(jnp.float64) * _f64_const()[None, :]},
                  lambda x: {"d": x[:, None].double() * torch.from_numpy(_f64_const()[None, :])}),
    "unstable_capture": (("x",), lambda x: {"y": x + np.random.rand()},
                         lambda x: {"y": x + np.random.rand()}),
    "seeded_capture": (("x",), lambda x: {"y": x[:, None] + _SEEDED[None, :]},
                       lambda x: {"y": x[:, None] + torch.from_numpy(_SEEDED)[None, :]}),
}


@pytest.mark.parametrize("name", sorted(CATALOGUE))
def test_lint_program_matches_reference(name, restore_config):
    cols, jfn, tfn = CATALOGUE[name]
    jp = tfs.compile_program(jfn, _frame(tfs, cols))
    tp = tft.compile_program(tfn, _frame(tft, cols), **CPU)
    jr, tr = jp.lint(), tp.lint()
    assert _summary(tr, True) == _summary(jr, False), (jr.pretty(), tr.pretty())


@pytest.mark.parametrize("block", [True, False])
@pytest.mark.parametrize("name", ["add3", "log", "div_by_column", "rsqrt", "unused_input",
                                  "f64_cast", "log_of_relu", "unstable_capture"])
def test_analyze_frame_matches_reference(name, block):
    cols, jfn, tfn = CATALOGUE[name]
    jr = janalysis.analyze_frame(_frame(tfs, cols), jfn, block=block)
    tr = tanalysis.analyze_frame(_frame(tft, cols), tfn, block=block, **CPU)
    assert _summary(tr, True) == _summary(jr, False), (jr.pretty(), tr.pretty())
    assert tr.subject == jr.subject


def test_codes_are_the_references():
    assert tanalysis.CODES == janalysis.CODES
    from tensorframes_tpu.analysis import diagnostics as jd
    from tensorframes_tpu_torch.analysis import diagnostics as td

    assert td.SEVERITIES == jd.SEVERITIES
    assert set(trules.RULES) == set(janalysis.rules.RULES)


def test_messages_whole_where_no_graph_is_named():
    """Diagnostics bound to inputs, not graph sites, read word for word
    as the reference's (TFG103, TFG106 at a planted budget). TFG104
    keeps the reference's code, severity and subject; its text names the
    JAX package's donation, as the port has no donation switch."""
    def both(name, code):
        cols, jfn, tfn = CATALOGUE[name]
        [jd] = tfs.compile_program(jfn, _frame(tfs, cols)).lint().by_code(code)
        [td] = tft.compile_program(tfn, _frame(tft, cols), **CPU).lint().by_code(code)
        return jd, td

    jd, td = both("unused_input", "TFG103")
    assert td.explain() == jd.explain()
    jd, td = both("donation_alias", "TFG104")
    assert (td.severity, td.subject) == (jd.severity, jd.subject) == ("error", "x")
    assert "donate_inputs" not in td.explain() and "donate_inputs" in jd.explain()
    jp = tfs.compile_program(CATALOGUE["add3"][1], _frame(tfs))
    tp = tft.compile_program(CATALOGUE["add3"][2], _frame(tft), **CPU)
    [jd] = jp.lint(hbm_budget_bytes=10).by_code("TFG106")
    [td] = tp.lint(hbm_budget_bytes=10).by_code("TFG106")
    assert td.message == jd.message
    assert not tp.lint(hbm_budget_bytes=1 << 30).by_code("TFG106")


def test_memoized_cost_analysis_raises_the_tfg106_estimate():
    tp = tft.compile_program(lambda x: {"z": x + 3.0}, _frame(tft), **CPU)
    tp.cost_analysis(probe=8)
    [d] = tp.lint(hbm_budget_bytes=10).by_code("TFG106")
    assert "cost model" in d.message


def test_inner_unknown_dim_and_disabled_bucketing_match(restore_config):
    jp = JProgram(lambda f: {"y": f["x"] * 2.0}, [JSpec("x", jdt.float32, JShape([-1, -1]))])
    tp = TProgram(lambda f: {"y": f["x"] * 2.0}, [TSpec("x", tdt.float32, TShape([-1, -1]))])
    jr, tr = janalysis.lint_program(jp), tanalysis.lint_program(tp)
    assert _summary(tr, True) == _summary(jr, False) == [("TFG101", "warn", "x")]
    tfs.configure(max_bucket_doublings=0)
    tft.configure(max_bucket_doublings=0)
    jp = JProgram(lambda f: {"y": f["x"] * 2.0}, [JSpec("x", jdt.float32, JShape([-1]))])
    tp = TProgram(lambda f: {"y": f["x"] * 2.0}, [TSpec("x", tdt.float32, TShape([-1]))])
    jr, tr = janalysis.lint_program(jp), tanalysis.lint_program(tp)
    assert _summary(tr, True) == _summary(jr, False) == [("TFG101", "warn", "x")]


def test_block_shape_storm_matches_and_lazy_frames_stay_lazy():
    reports = []
    for P, F, kw in ((tfs, JFrame, {}), (tft, TFrame, CPU)):
        base = _frame(P, n=4, blocks=1)
        blocks = [{"x": np.arange(n, dtype=np.float32) + 1.0} for n in (1, 2, 4, 8)]
        stormy = F(blocks, base.schema)
        rep = P.analyze_frame(stormy, lambda x: {"z": x * 2.0}, block=True, **kw)
        reports.append(rep)
        lazy = P.map_blocks(lambda x: {"z": x + 1.0}, base, **kw)
        P.analyze_frame(lazy, lambda z: {"w": z * 2.0}, **kw)
        assert not lazy.is_materialized
    jr, tr = reports
    assert _summary(tr, True) == _summary(jr, False) == [("TFG101", "warn", "frame")]
    assert "4 distinct block row counts" in tr.by_code("TFG101")[0].message


def test_dsl_fetches_lint_like_the_reference():
    out = []
    for P, kw in ((tfs, {}), (tft, CPU)):
        fr = _frame(P, n=8, blocks=1)
        with P.with_graph():
            x = P.block(fr, "x")
            fetch = P.log(x, name="lx")
        out.append(P.analyze_frame(fr, [fetch], **kw))
    assert _summary(out[1], True) == _summary(out[0], False)
    assert [d.code for d in out[1]] == ["TFG105"]


def test_lint_dispatches_nothing():
    tp = tft.compile_program(lambda x: {"l": torch.log(x)}, _frame(tft), **CPU)
    before = (texec._JIT_HITS.value, texec._JIT_MISSES.value, LAUNCHES.snapshot())
    tp.lint(hbm_budget_bytes=1 << 30)
    tanalysis.analyze_frame(_frame(tft), lambda x: {"z": x * 2.0}, **CPU)
    assert (texec._JIT_HITS.value, texec._JIT_MISSES.value, LAUNCHES.snapshot()) == before
    assert tp.compiled().cache_sizes() == {"block": 0, "vmap": 0}


def test_report_surfaces_and_counter():
    from tensorframes_tpu_torch.observability.metrics import REGISTRY

    def value(code):
        for m in REGISTRY.collect():
            if m.name == "tftpu_analysis_diagnostics_total" and dict(m.labels).get("code") == code:
                return m.value
        raise AssertionError("counter family missing")

    expo = REGISTRY.to_prometheus()
    assert all(f'code="{c}"' in expo for c in tanalysis.CODES)
    before = value("TFG103")
    report = tft.compile_program(CATALOGUE["unused_input"][2], _frame(tft, ("x", "y")),
                                 **CPU).lint()
    assert value("TFG103") == before + 1
    rows = [json.loads(ln) for ln in report.to_jsonl().splitlines()]
    assert [r["code"] for r in rows] == ["TFG103"]
    with pytest.raises(ValueError, match="unknown diagnostic code"):
        tanalysis.Diagnostic("TFG999", "warn", "nope")
    with pytest.raises(ValueError, match="unknown severity"):
        tanalysis.Diagnostic("TFG101", "fatal", "nope")


# ---------------------------------------------------------------------------
# strict= on the six verbs
# ---------------------------------------------------------------------------

def _planted_error(ctx):
    from tensorframes_tpu_torch.analysis.diagnostics import Diagnostic

    return [Diagnostic("TFG104", "error", "planted error-severity finding", subject="x")]


def _planted_error_ref(ctx):
    return [janalysis.Diagnostic("TFG104", "error", "planted error-severity finding",
                                 subject="x")]


NATURAL_TFG104 = ("map_blocks", "reduce_rows", "reduce_blocks", "aggregate")


def _strict_call(P, verb, kw):
    """One strict verb call per package. The programs of
    :data:`NATURAL_TFG104` keep a feed under its own name (TFG104, an
    error); ``map_rows`` and the pandas map cannot (validation refuses
    the collision before the lint), so they raise only under a planted
    error rule."""
    fr = _frame(P)
    if verb == "map_blocks":
        return P.map_blocks(lambda x: {"x": x * 1.0}, fr, trim=True, strict=True, **kw)
    if verb in ("map_rows", "pandas"):
        if verb == "pandas":
            pd = pytest.importorskip("pandas")
            return P.map_blocks(lambda x: {"z": x + 1.0},
                                pd.DataFrame({"x": np.arange(4.0, dtype=np.float32)}),
                                strict=True, **kw)
        return P.map_rows(lambda x: {"z": x + 1.0}, fr, strict=True, **kw)
    if verb == "reduce_rows":
        f2 = P.frame_from_arrays({"x": np.arange(4, dtype=np.float32),
                                  "x_1": np.arange(4, dtype=np.float32)})
        return P.reduce_rows(lambda x_1, x_2, x_1_1, x_1_2: {"x": x_1 + x_2, "x_1": x_1_1 + x_1_2},
                             f2, strict=True, **kw)
    cols = {"k": np.arange(8) % 2, "x": np.arange(8, dtype=np.float32),
            "x_input": np.arange(8, dtype=np.float32),
            "x_input_input": np.arange(8, dtype=np.float32)}
    f3 = P.frame_from_arrays(cols, num_blocks=2)

    def fetches(x_input, x_input_input):
        return {"x": x_input.sum(0), "x_input": x_input_input.sum(0)}

    if verb == "reduce_blocks":
        return P.reduce_blocks(fetches, f3, strict=True, **kw)
    return P.aggregate(fetches, f3.group_by("k"), strict=True, **kw)


@pytest.mark.parametrize("verb", ["map_blocks", "map_rows", "reduce_rows", "reduce_blocks",
                                  "aggregate", "pandas"])
def test_strict_raises_the_references_error_before_dispatch(verb, monkeypatch, restore_config):
    """The whole error text, with TFG104's rule planted in both packages
    (the port's own TFG104 text names the JAX package's donation)."""
    monkeypatch.setitem(trules.RULES, "TFG104", _planted_error)
    monkeypatch.setitem(janalysis.rules.RULES, "TFG104", _planted_error_ref)
    with pytest.raises(tfs.StaticAnalysisError) as je:
        _strict_call(tfs, verb, {})
    before = (texec._JIT_HITS.value, texec._JIT_MISSES.value, LAUNCHES.snapshot())
    with pytest.raises(tft.StaticAnalysisError) as te:
        _strict_call(tft, verb, CPU)
    assert (texec._JIT_HITS.value, texec._JIT_MISSES.value, LAUNCHES.snapshot()) == before
    assert str(te.value) == str(je.value)
    assert [d.code for d in te.value.diagnostics] == [d.code for d in je.value.diagnostics]
    assert isinstance(te.value, tft.ValidationError)


@pytest.mark.parametrize("verb", NATURAL_TFG104)
def test_strict_donation_alias_raises_as_the_reference_before_dispatch(verb, restore_config):
    with pytest.raises(tfs.StaticAnalysisError) as je:
        _strict_call(tfs, verb, {})
    before = (texec._JIT_HITS.value, texec._JIT_MISSES.value, LAUNCHES.snapshot())
    with pytest.raises(tft.StaticAnalysisError) as te:
        _strict_call(tft, verb, CPU)
    assert (texec._JIT_HITS.value, texec._JIT_MISSES.value, LAUNCHES.snapshot()) == before

    def found(err):
        return [(d.code, d.severity, d.subject) for d in err.diagnostics]

    assert found(te.value) == found(je.value)
    assert found(te.value)[0][:2] == ("TFG104", "error")


@pytest.mark.parametrize("verb", ["map_blocks", "map_rows", "reduce_rows", "reduce_blocks",
                                  "aggregate"])
def test_strict_clean_program_equals_non_strict(verb):
    fr = tft.frame_from_arrays({"k": np.arange(12) % 3, "x": np.arange(12, dtype=np.float32)},
                               num_blocks=2)

    def run(strict):
        if verb == "map_blocks":
            return tft.map_blocks(lambda x: {"z": x + 3.0}, fr, strict=strict, **CPU).collect()
        if verb == "map_rows":
            return tft.map_rows(lambda x: {"z": x * 2.0}, fr, strict=strict, **CPU).collect()
        if verb == "reduce_rows":
            return tft.reduce_rows(lambda x_1, x_2: {"x": x_1 + x_2}, fr, strict=strict, **CPU)
        with tft.with_graph():
            fetch = tft.reduce_sum(tft.block(fr, "x", tf_name="x_input"), axis=0, name="x")
            if verb == "reduce_blocks":
                return tft.reduce_blocks(fetch, fr, strict=strict, **CPU)
            return tft.aggregate(fetch, fr.group_by("k"), strict=strict, **CPU).collect()

    a, b = run(True), run(False)
    assert repr(a) == repr(b)


def test_strict_warn_only_program_runs():
    fr = _frame(tft, n=8, blocks=1)
    out = tft.map_rows(lambda x: {"l": torch.log(x)}, fr, strict=True, **CPU)
    assert out.column_values("l").shape == (8,)
    with pytest.raises(tft.StaticAnalysisError):
        fr.map_blocks_trimmed(tft.compile_program(lambda x: {"x": x * 1.0}, fr, **CPU),
                              strict=True, **CPU)


# ---------------------------------------------------------------------------
# lint_plan: the same chains in both packages
# ---------------------------------------------------------------------------

def _plan_summary(report):
    return sorted((d.code, d.severity, d.subject) for d in report)


def _chain_repartition(P, kw):
    fr = P.frame_from_arrays({"x": np.arange(12, dtype=np.float32)}, num_blocks=2)
    f1 = P.map_blocks(lambda x: {"y": x + 1.0}, fr, **kw)
    return P.map_blocks(lambda y: {"z": y * 2.0}, f1.repartition(3), **kw)


def _chain_trim(P, kw):
    fr = P.frame_from_arrays({"x": np.arange(12, dtype=np.float32)}, num_blocks=2)
    f1 = P.map_blocks(lambda x: {"y": x + 1.0}, fr, **kw)
    trimmed = P.map_blocks(lambda y: {"t": y[:3]}, f1, trim=True, **kw)
    return P.map_blocks(lambda t: {"u": t * 2.0}, trimmed, **kw)


def _chain_clean(P, kw):
    fr = P.frame_from_arrays({"x": np.arange(8, dtype=np.float32)})
    return P.map_blocks(lambda y: {"z": y * 2.0},
                        P.map_blocks(lambda x: {"y": x + 1.0}, fr, **kw), **kw)


def _chain_nonalgebraic(P, kw):
    fr = P.frame_from_arrays({"k": np.array([0, 1, 0, 1]), "x": np.arange(4, dtype=np.float32)})
    f1 = P.map_blocks(lambda x: {"y": x * 2.0}, fr, **kw)
    if P is tfs:
        fn = lambda y_input: {"y": y_input.max(axis=0) - y_input.min(axis=0)}  # noqa: E731
    else:
        fn = lambda y_input: {"y": y_input.max(dim=0).values - y_input.min(dim=0).values}  # noqa: E731
    return P.aggregate(fn, f1.group_by("k"), **kw)


def _chain_computed_key(P, kw):
    fr = P.frame_from_arrays({"x": (np.arange(24) % 6).astype(np.int64)}, num_blocks=2)
    f1 = P.map_blocks(lambda x: {"kk": x % 3, "y": x * 2}, fr, **kw)
    with P.with_graph():
        y_in = P.block(f1, "y", tf_name="y_input")
        agg = P.aggregate(P.reduce_sum(y_in, axis=0, name="y"), f1.group_by("kk"), **kw)
    agg.collect()
    return agg


def _agg_over_join(P, kw, key_grouped="k1", dim_key="k1"):
    n = 60
    fact = P.frame_from_arrays({"k1": (np.arange(n) % 4).astype(np.int32),
                                "k2": (np.arange(n) % 6).astype(np.int32),
                                "x": (np.arange(n) % 7).astype(np.float32)}, num_blocks=2)
    dim = P.frame_from_arrays({dim_key: np.arange(6, dtype=np.int32),
                               "w": np.arange(6, dtype=np.int64) * 10}, num_blocks=1)
    j = P.map_blocks(lambda x: {"z": x * x}, fact, **kw).join(dim, on=dim_key)
    with P.with_graph():
        z_in = P.block(j, "z", tf_name="z_input")
        return P.aggregate(P.reduce_sum(z_in, axis=0, name="z"), j.group_by(key_grouped), **kw)


CHAINS = {
    "repartition_barrier": _chain_repartition,
    "trim_barrier": _chain_trim,
    "clean": _chain_clean,
    "nonalgebraic_aggregate": _chain_nonalgebraic,
    "computed_key": _chain_computed_key,
    "float_fetch_over_join": lambda P, kw: _agg_over_join(P, kw),
    "key_not_grouped": lambda P, kw: _agg_over_join(P, kw, key_grouped="k1", dim_key="k2"),
}


@pytest.mark.parametrize("name", sorted(CHAINS))
def test_lint_plan_matches_reference(name):
    jr = tfs.lint_plan(CHAINS[name](tfs, {}))
    tr = tft.lint_plan(CHAINS[name](tft, CPU))
    assert _plan_summary(tr) == _plan_summary(jr), (jr.pretty(), tr.pretty())
    # TFG107 says "its own program" where the reference says "its own XLA
    # program"; the other plan rules read word for word
    assert [d.message for d in tr] == [
        d.message.replace("its own XLA program", "its own program") for d in jr]
    assert tr.subject == jr.subject


def test_lint_plan_reads_a_planted_to_host_mark(restore_config):
    reports = []
    for P in (tfs, tft):
        P.configure(block_budget_bytes=64)
        fr = P.frame_from_arrays({"x": np.arange(100, dtype=np.float32)}, num_blocks=2)
        fr.blocks()
        fr._fusion_barrier = "to_host materialization"
        reports.append(P.lint_plan(fr))
    jr, tr = reports
    assert [d.code for d in tr] == ["TFG111"]
    assert [d.explain() for d in tr] == [d.explain() for d in jr]
    from tensorframes_tpu_torch.plan import lower as tlower

    fr = tft.frame_from_arrays({"x": np.arange(100, dtype=np.float32)})
    assert tlower.oversized_materializations(fr) == []


def test_serving_evidence_rules_match_reference():
    from tensorframes_tpu.serving import decode as jdecode
    from tensorframes_tpu.serving import query as jquery
    from tensorframes_tpu_torch.serving import decode as tdecode
    from tensorframes_tpu_torch.serving import query as tquery

    stub = types.SimpleNamespace(name="gen_probe", config=types.SimpleNamespace(page_size=16))
    reports = []
    for dec, q, P in ((jdecode, jquery, tfs), (tdecode, tquery, tft)):
        dec.DecodeEngine._note_prefix_ineligible(stub, "store_unarmed", 40)
        dec.DecodeEngine._note_prefix_ineligible(stub, "page_misalignment", 7)
        q._record_event("q_probe", "incremental", "float_accumulation", "sum of float32 'x'")
        try:
            reports.append(P.lint_plan(P.frame_from_arrays({"x": np.arange(4.0)})))
        finally:
            q._withdraw_events("q_probe")
            for reason in ("store_unarmed", "page_misalignment"):
                dec._PREFIX_INELIGIBLE_SEEN.discard(("gen_probe", reason))
            kept = [e for e in dec._PREFIX_INELIGIBLE if e.get("endpoint") != "gen_probe"]
            dec._PREFIX_INELIGIBLE.clear()
            dec._PREFIX_INELIGIBLE.extend(kept)
    jr, tr = reports
    assert sorted(d.code for d in tr) == ["TFG113", "TFG113", "TFG114"]
    assert [d.explain() for d in tr] == [d.explain() for d in jr]


# ---------------------------------------------------------------------------
# the CLI over a save_program artifact, and selfcheck
# ---------------------------------------------------------------------------

def test_cli_lints_a_saved_program(tmp_path, capsys, restore_config):
    from tensorframes_tpu_torch.analysis.cli import main

    fr = _frame(tft, n=8, blocks=1)
    clean = tmp_path / "add3.pt2"
    tft.save_program(tft.compile_program(lambda x: {"z": x + 3.0}, fr, **CPU), str(clean), **CPU)
    alias = tmp_path / "alias.pt2"
    tft.save_program(tft.compile_program(lambda x: {"x": x * 1.0}, fr, **CPU), str(alias), **CPU)
    assert main([str(clean), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "clean" in out and str(clean) in out
    assert main(["--json", str(clean), "--device", "cpu"]) == 0
    payload = json.loads(capsys.readouterr().out.strip())
    assert payload["counts"] == {"error": 0, "warn": 0, "info": 0}
    assert main([str(alias), "--device", "cpu"]) == 0  # non-strict: report only
    capsys.readouterr()
    assert main(["--strict", str(alias), "--device", "cpu"]) == 1
    assert "TFG104" in capsys.readouterr().out
    bogus = tmp_path / "bogus.pt2"
    bogus.write_bytes(b"not a bundle")
    assert main([str(bogus), "--device", "cpu"]) == 2
    assert main(["--demo", "--strict", "--device", "cpu"]) == 0


def test_selfcheck_is_clean_and_catches_each_rule(tmp_path):
    run = [sys.executable, "-m", "tensorframes_tpu_torch.analysis", "selfcheck"]
    proc = subprocess.run(run, cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    bad = tmp_path / "bad.py"
    bad.write_text(
        "import torch\n"
        "from tensorframes_tpu_torch.observability.metrics import counter\n"
        "_cache = {}\n"
        "def f(x):\n"
        "    _cache[x] = torch.compile(lambda v: v)\n"
        "    return counter('late_metric')\n"
    )
    proc = subprocess.run(run + [str(bad)], cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 1
    for code in ("TFL001", "TFL002", "TFL003"):
        assert code in proc.stdout
    ok = tmp_path / "ok.py"
    ok.write_text("import torch\nf = torch.jit.script  # lint: allow-jax-jit\n"
                  "g = torch.utils.cpp_extension.load('x', [])  # lint: allow-jax-jit\n")
    proc = subprocess.run(run + [str(ok)], cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout
