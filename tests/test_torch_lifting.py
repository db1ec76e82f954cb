"""Verified UDF lifting in the port against the JAX package's.

Both packages in one process on the CPU (the port with ``device="cpu"``),
the same module-level numpy UDFs through each:

* ``inspect_udf`` and ``detect_mutable_closures`` give the same candidate
  or the same ``(reason, node, lineno)`` decline;
* the decision table: each UDF of :data:`TABLE` at each dtype lifts or
  declines as :data:`PORT_DECLINES` says, the JAX package decides the same
  in the same run but for :data:`REF_DIFFERENCES` (each recorded in
  ROADMAP.md with its measured cause), and every row the port lifts equals
  the port's host stage and numpy bit for bit (NaN canonical) on the
  boundary corpus and on 100,000 seeded values;
* ``map_blocks``, ``aggregate`` and ``reduce_blocks`` with ``numpy_udf``
  against the JAX package; ``map_rows`` and the ``TypeError`` texts whole;
* the plan: ``chain_barriers`` (none for a lifted chain, one for a
  declined one), the ``host_callback`` fallback, TFG112 through
  ``lint_plan`` (messages whole), ``lift_report`` and ``--lift-report``
  (walls masked), the capture-time TFG112 warning;
* ``tftpu_lift_total`` at import, ``TFTPU_LIFT=0`` in a subprocess, the
  fingerprint's lift slot and the host stage's missing fingerprint.
"""

import contextlib
import io
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import tensorframes_tpu as tfs
import tensorframes_tpu_torch as tft
from tensorframes_tpu.analysis import lifting as jlifting
from tensorframes_tpu.analysis.diagnostics import DIAGNOSTIC_LOG as JLOG
from tensorframes_tpu.plan import ir as jir
from tensorframes_tpu.plan import lift as jlift
from tensorframes_tpu_torch.analysis import lifting as tlifting
from tensorframes_tpu_torch.analysis.diagnostics import DIAGNOSTIC_LOG as TLOG
from tensorframes_tpu_torch.plan import ir as tir
from tensorframes_tpu_torch.plan import lift as tlift

ROOT = Path(__file__).resolve().parents[1]
CPU = {"device": "cpu"}


@pytest.fixture(autouse=True)
def _lift_state():
    """Every test starts lifting-enabled in both packages with empty
    decision logs and leaves the configs as it found them."""
    was = (tfs.configure().udf_lifting, tft.configure().udf_lifting)
    tfs.configure(udf_lifting=True)
    tft.configure(udf_lifting=True)
    jlift.clear_lift_log()
    tlift.clear_lift_log()
    yield
    tfs.configure(udf_lifting=was[0])
    tft.configure(udf_lifting=was[1])


@contextlib.contextmanager
def _lifting_off():
    tfs.configure(udf_lifting=False)
    tft.configure(udf_lifting=False)
    try:
        yield
    finally:
        tfs.configure(udf_lifting=True)
        tft.configure(udf_lifting=True)


# ---------------------------------------------------------------------------
# the UDFs (module level: lifting reads their source)
# ---------------------------------------------------------------------------

def _arith(x):
    return {"y": (x * 2 + 1) - 3}


def _where_compare(x):
    return {"y": np.where(x > 3, x - 3, 3 - x)}


def _clip(x):
    return {"y": np.clip(x, 1, 25)}


def _demean(x):
    return {"y": x - x.mean()}


def _span(x):
    return {"lo": x - x.min(), "hi": x.max() - x}


def _chain(x):
    z = np.abs(x) + 1
    return {"y": np.maximum(z, x) * np.minimum(z, 7)}


def masks(x):
    return {"m": np.logical_and(x > 2, x < 9),
            "n": np.logical_or(x == 0, x == 5)}


def root(x):
    return {"y": np.sqrt(x)}


def third(x):
    return {"y": x / 3}


def expo(x):
    return {"y": np.exp(x)}


def logn(x):
    return {"y": np.log(x)}


def tanh(x):
    return {"y": np.tanh(x)}


def sign(x):
    return {"y": np.sign(x)}


def mod3(x):
    return {"y": np.mod(x, 3.0)}


def floordiv3(x):
    return {"y": np.floor_divide(x, 3)}


def selfdiv(x):
    return {"y": x // x}


def total(x):
    return {"y": x - np.sum(x)}


def hyp(x, y):
    return {"h": np.sqrt(x * x + y * y), "d": np.where(x > y, x, y)}


def blend(u, v):
    return {"z": np.where(u > v, u - v, v - u)}


def loopy(x):
    acc = x
    for _ in range(3):
        acc = acc + x
    return {"a": acc}


def branchy(x):
    if x.sum() > 0:
        return {"y": x}
    return {"y": -x}


def rng_udf(x):
    return {"r": x + np.random.rand(*x.shape)}


def rng_method(x):
    return {"r": np.random.rand(*x.shape).astype(x.dtype)}


def aug(x):
    y = x * 2
    y += 1
    return {"y": y}


def sorter(x):
    return {"y": np.sort(x)}


def fft(x):
    return {"y": np.fft.fft(x).real}


def ternary(x):
    return {"y": x if x.max() > 0 else -x}


def logic_words(x):
    return {"y": (x > 0) and (x < 3)}


def negated(x):
    return {"y": not x}


def keyword(x):
    return {"y": np.clip(x, a_min=0, a_max=1)}


def defaulted(x, k=2):
    return {"y": x * k}


def two_returns(x):
    return {"y": x}
    return {"y": -x}  # noqa


def _state_closure():
    state = [1.0]

    def closed(x):
        return {"c": x * state[0]}

    return closed


def _dict_closure():
    state = {"k": 2.0}

    def closed(x):
        return {"c": x * state["k"]}

    return closed


def _scalar_closure():
    k = 2.5

    def scaled(x):
        return {"y": x * k}

    return scaled


closed_list = _state_closure()
closed_dict = _dict_closure()
scaled = _scalar_closure()


def fsum(x_input):
    return {"x": x_input.sum()}


def imax(x_input):
    return {"x": np.max(x_input)}


def fmax(x_input):
    return {"x": np.max(x_input)}


# ---------------------------------------------------------------------------
# inspect_udf / detect_mutable_closures: the same candidate or decline
# ---------------------------------------------------------------------------

INSPECTED = [_arith, _where_compare, _clip, _demean, _span, _chain, masks, root,
             hyp, total, loopy, branchy, rng_udf, rng_method, aug, sorter, fft,
             ternary, logic_words, negated, keyword, defaulted, two_returns,
             closed_list, closed_dict, scaled]


def _inspect(mod, fn):
    try:
        c = mod.inspect_udf(fn)
    except mod.LiftDeclined as d:
        return ("declined", d.reason, d.node, d.lineno, d.detail, str(d))
    return ("candidate", c.name, c.params, c.consts, sorted(c.np_aliases),
            c.has_reduction, c.mutable_closures,
            [__import__("ast").dump(s) for s in c.body])


@pytest.mark.parametrize("fn", INSPECTED, ids=lambda f: f.__name__)
def test_inspect_udf_matches_reference(fn):
    assert _inspect(tlifting, fn) == _inspect(jlifting, fn)
    assert tlifting.detect_mutable_closures(fn) == jlifting.detect_mutable_closures(fn)


def test_allowlists_are_the_references():
    assert tlifting.ELEMENTWISE_OPS == jlifting.ELEMENTWISE_OPS
    assert tlifting.REDUCTION_OPS == jlifting.REDUCTION_OPS
    assert tlifting.ARRAY_METHODS == jlifting.ARRAY_METHODS
    # every allowlisted name has an explicit torch counterpart (``where``
    # and the int ``mean`` are built from others)
    assert (tlifting.ELEMENTWISE_OPS | tlifting.REDUCTION_OPS) - {"where", "mean"} <= set(
        tlift._TORCH_OPS)


# ---------------------------------------------------------------------------
# the decision table
# ---------------------------------------------------------------------------

FLOATS = ("float16", "float32", "float64")
INTS = ("int8", "int32", "int64", "uint8")
ALL = FLOATS + INTS + ("bool",)

#: UDF -> the dtypes it is captured at
TABLE = {
    _arith: ALL, _where_compare: ALL, _clip: FLOATS + INTS, _demean: ALL,
    _span: FLOATS + INTS, _chain: FLOATS + INTS, masks: ALL, root: ALL,
    third: FLOATS + INTS, expo: FLOATS + ("int32",), logn: FLOATS + ("int32",),
    tanh: FLOATS + ("int32",), sign: FLOATS + INTS, mod3: FLOATS + INTS,
    floordiv3: FLOATS + INTS, selfdiv: ("int32", "int64"),
    total: FLOATS + ("int8", "int32", "int64", "bool"),
}

_VM, _FR = "verify-mismatch", "float-reduction"

#: The port's declines on the CPU (every other row of TABLE lifts).
PORT_DECLINES = {
    **{("_demean", d): _FR for d in FLOATS + ("int64",)},
    **{("_span", d): _FR for d in FLOATS},
    **{("total", d): _FR for d in FLOATS},
    # torch's CPU sqrt is not correctly rounded (f32: the random block;
    # f64: sqrt(0.5) and sqrt(2.0) one ulp low)
    **{("root", d): _VM for d in ("float32", "float64", "int32", "int64")},
    # f16 exp: the CPU's f16 exp differs from numpy's on a few of the
    # 61,442 f16 values the verification runs (every zero and normal)
    ("expo", "float16"): _VM, ("expo", "float32"): _VM, ("logn", "float32"): _VM,
    **{("tanh", d): _VM for d in ("float32", "float64", "int32")},
    **{("sign", d): _VM for d in FLOATS},
    **{("mod3", d): _VM for d in FLOATS + ("int8", "int32", "int64")},
    # an integer division by zero raises in torch on the CPU
    **{("selfdiv", d): "probe-failure" for d in ("int32", "int64")},
}

#: Rows where the JAX package decides otherwise (None: it lifts), each
#: recorded in ROADMAP.md with its cause.
REF_DIFFERENCES = {
    **{("root", d): None for d in ("float32", "float64", "int32", "int64")},
    **{("third", d): _VM for d in FLOATS + INTS},
    ("expo", "float16"): None, ("expo", "float64"): _VM, ("expo", "int32"): _VM,
    ("logn", "float16"): _VM, ("logn", "float64"): _VM, ("logn", "int32"): _VM,
    **{("mod3", d): None for d in ("int8", "int32", "int64")},
    **{("floordiv3", d): _VM for d in FLOATS},
    **{("selfdiv", d): _VM for d in ("int32", "int64")},
}

ROWS = [(fn, d) for fn, dts in TABLE.items() for d in dts]


def _corpus_values(dtn: str) -> np.ndarray:
    """The boundary pool, tiled at two phases (26 rows and more)."""
    pool = tlift._boundary_pool(np.dtype(dtn))
    reps = -(-26 // len(pool))
    return np.concatenate([np.tile(pool, reps), np.roll(np.tile(pool, reps), 11)])


def _seeded_values(dtn: str, n: int = 100_000) -> np.ndarray:
    """n seeded values: floats half standard normals (scaled by 10) and
    half log-uniform over the normal range, integers half over the whole
    range and half small, bools fair."""
    d = np.dtype(dtn)
    rng = np.random.default_rng(1234)
    if d == np.bool_:
        return rng.integers(0, 2, n).astype(bool)
    if np.issubdtype(d, np.integer):
        info = np.iinfo(d)
        small = np.clip(np.rint(rng.standard_normal(n // 2) * 100), info.min, info.max)
        return np.concatenate([rng.integers(info.min, info.max, n - n // 2, dtype=d,
                                            endpoint=True), small.astype(d)])
    info = np.finfo(d)
    mag = np.exp2(rng.uniform(np.log2(float(info.tiny)), np.log2(float(info.max)), n // 2))
    with np.errstate(all="ignore"):
        vals = np.concatenate([np.copysign(mag, rng.standard_normal(n // 2)),
                               rng.standard_normal(n - n // 2) * 10]).astype(d)
    return np.where(np.isfinite(vals) & (np.abs(vals) >= info.tiny), vals, d.type(1.5))


def _decide(P, lift_mod, fn, frame, **kw):
    P.compile_program(P.numpy_udf(fn), frame, **kw)
    rec = lift_mod.lift_log()[-1]
    return None if rec["lifted"] else rec["reason"]


def _numpy_blocks(fn, frame):
    """fn on each block with numpy, NaN canonical, concatenated."""
    outs = [tlift._host_outputs(fn, [b["x"]], fn.__name__) for b in frame.blocks()]
    return {k: np.concatenate([np.atleast_1d(o[k]) for o in outs]) for k in outs[0]}


def _same_bits(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("fn,dtn", ROWS, ids=[f"{f.__name__}-{d}" for f, d in ROWS])
def test_decision_table(fn, dtn):
    want = PORT_DECLINES.get((fn.__name__, dtn))
    ref_want = REF_DIFFERENCES.get((fn.__name__, dtn), want)
    x = _corpus_values(dtn)
    assert _decide(tft, tlift, fn, tft.frame_from_arrays({"x": x}, num_blocks=2),
                   **CPU) == want
    assert _decide(tfs, jlift, fn, tfs.frame_from_arrays({"x": x}, num_blocks=2)) == ref_want
    if want is not None:
        return
    udf = tft.numpy_udf(fn)
    for values in (x, _seeded_values(dtn)):
        fr = tft.frame_from_arrays({"x": values}, num_blocks=3)
        lifted = tft.map_blocks(udf, fr, **CPU)
        names = [o for o in lifted.schema.names if o != "x"]
        got = {o: lifted.column_values(o) for o in names}
        with _lifting_off():
            host = tft.map_blocks(udf, fr, **CPU)
            host = {o: host.column_values(o) for o in names}
        want_np = _numpy_blocks(fn, fr)
        for o in names:
            assert _same_bits(got[o], host[o]), (o, len(values))
            assert _same_bits(got[o], want_np[o]), (o, len(values))
    assert udf._programs and all(k[-1] == "cpu" for k in udf._programs)


def test_table_rows_all_recorded_in_roadmap():
    """Every difference the table asserts is a row of ROADMAP.md's
    recorded differences."""
    text = " ".join((ROOT / "ROADMAP.md").read_text().split())
    for name, dtn in REF_DIFFERENCES:
        assert f"`{name}` {dtn}" in text, (name, dtn)


def test_multi_input_lifts_and_matches_host_stage():
    fr_np = {"x": np.asarray([3.0, 0.0, -3.0, 1e20, np.nan, 5.0, -0.0, np.inf], np.float64),
             "y": np.asarray([4.0, -0.0, 4.0, 1e20, 1.0, 12.0, 0.0, np.inf], np.float64)}
    udf = tft.numpy_udf(hyp)
    fr = tft.frame_from_arrays(fr_np, num_blocks=2)
    got = tft.map_blocks(udf, fr, **CPU)
    rec = tlift.lift_log()[-1]
    # the CPU's f64 sqrt is not correctly rounded: the random block shows it
    assert (rec["lifted"], rec["reason"]) == (False, _VM)
    assert "random block" in rec["detail"]
    want = tlift._host_outputs(hyp, [fr_np["x"], fr_np["y"]], "hyp")
    assert _same_bits(got.column_values("d"), want["d"])
    assert _same_bits(got.column_values("h"), want["h"])
    # the reference lifts it on XLA:CPU
    tfs.map_blocks(tfs.numpy_udf(hyp), tfs.frame_from_arrays(fr_np, num_blocks=2)).blocks()
    assert jlift.lift_log()[-1]["lifted"]


def test_random_block_is_what_declines_cpu_sqrt_f32():
    """Without the random block the f32 sqrt would lift on the CPU (the
    boundary corpus agrees) and then differ from the host stage on real
    data."""
    cand = tlifting.inspect_udf(root)
    specs = {"x": tft.program.TensorSpec("x", tft.dtypes.float32, tft.Shape((tft.Unknown,)))}
    _, synth = tlift._build_lifted_program(cand, ["x"], specs)
    with pytest.raises(tlifting.LiftDeclined) as e:
        tlift.verify_candidate(cand, specs, synth, "cpu")
    assert e.value.reason == _VM and "random block" in e.value.detail
    vals = _seeded_values("float32")
    got = synth({"x": torch.from_numpy(vals)})["y"].numpy()
    with np.errstate(all="ignore"):
        want = tlift.canonical_nan_numpy(np.sqrt(vals))
    assert not _same_bits(got, want)


def test_nan_is_canonical_on_both_paths():
    payload = np.array([0x7FC00001, 0xFFC00000], np.uint32).view(np.float32)
    vals = np.concatenate([payload, np.float32([1.0, -np.inf, np.inf])])
    fr = tft.frame_from_arrays({"x": vals}, num_blocks=1)
    udf = tft.numpy_udf(_arith)
    lifted = tft.map_blocks(udf, fr, **CPU).column_values("y")
    with _lifting_off():
        host = tft.map_blocks(udf, fr, **CPU).column_values("y")
    assert _same_bits(lifted, host)
    assert lifted.view(np.uint32)[:2].tolist() == [0x7FC00000, 0x7FC00000]


# ---------------------------------------------------------------------------
# the verbs with numpy_udf, against the JAX package
# ---------------------------------------------------------------------------

def _both_frames(cols, num_blocks=2):
    return (tfs.frame_from_arrays(cols, num_blocks=num_blocks),
            tft.frame_from_arrays(cols, num_blocks=num_blocks))


def _nan_equal(a, b) -> bool:
    """Equal bits except that NaN matches NaN (the port writes NaN
    canonical, the reference keeps numpy's payloads)."""
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype.kind == "f":
        na, nb = np.isnan(a), np.isnan(b)
        return bool((na == nb).all()) and a[~na].tobytes() == b[~nb].tobytes()
    return a.tobytes() == b.tobytes()


@pytest.mark.parametrize("fn,dtn", [(_arith, "float32"), (_where_compare, "int32"),
                                    (_chain, "float64"), (masks, "int8"),
                                    (third, "float32"), (rng_udf, "float32"),
                                    (closed_list, "float32"), (_span, "int64")],
                         ids=lambda v: getattr(v, "__name__", v))
def test_map_blocks_matches_reference(fn, dtn):
    vals = (np.arange(24) - 9).astype(dtn)
    if np.dtype(dtn).kind == "f":
        vals[[1, 5, 7]] = [np.nan, np.inf, -0.0]
    jf, tf_ = _both_frames({"x": vals}, num_blocks=3)
    j = tfs.map_blocks(tfs.numpy_udf(fn), jf)
    t = tft.map_blocks(tft.numpy_udf(fn), tf_, **CPU)
    assert t.schema.names == j.schema.names
    for name in j.schema.names:
        if fn is rng_udf and name == "r":
            continue
        assert _nan_equal(t.column_values(name), j.column_values(name)), name


def test_feed_dict_placeholder():
    def sq(x):
        return {"y": x * x + 1}

    jf, tf_ = _both_frames({"a": np.arange(6, dtype=np.float32)})
    j = tfs.map_blocks(tfs.numpy_udf(sq), jf, feed_dict={"x": "a"})
    t = tft.map_blocks(tft.numpy_udf(sq), tf_, feed_dict={"x": "a"}, **CPU)
    assert _same_bits(t.column_values("y"), j.column_values("y"))
    assert tlift.lift_log()[-1]["lifted"] and jlift.lift_log()[-1]["lifted"]


@pytest.mark.parametrize("dtn", ["int32", "int64"])
def test_aggregate_and_reduce_blocks_match_reference(dtn):
    cols = {"k": np.arange(12) % 3, "x": (np.arange(12) * 7 % 5).astype(dtn)}
    jf, tf_ = _both_frames(cols)
    j = tfs.aggregate(tfs.numpy_udf(imax), jf.group_by("k"))
    t = tft.aggregate(tft.numpy_udf(imax), tf_.group_by("k"), **CPU)
    for c in ("k", "x"):
        assert _same_bits(t.column_values(c), j.column_values(c))
    assert tlift.lift_log()[-1]["lifted"] and jlift.lift_log()[-1]["lifted"]
    jr = tfs.reduce_blocks(tfs.numpy_udf(imax), jf)
    tr = tft.reduce_blocks(tft.numpy_udf(imax), tf_, **CPU)
    assert tr == jr == 4


def test_host_stage_reduce_blocks_and_aggregate_under_vmap():
    cols = {"k": np.arange(12) % 3, "x": np.arange(12).astype(np.float32)}
    jf, tf_ = _both_frames(cols)
    assert tft.reduce_blocks(tft.numpy_udf(fmax), tf_, **CPU) == \
        tfs.reduce_blocks(tfs.numpy_udf(fmax), jf) == 11.0
    assert tlift.lift_log()[-1]["reason"] == _FR
    # a host stage cannot run under vmap (the generic aggregate maps over
    # groups): both packages raise
    with pytest.raises(NotImplementedError):
        tfs.aggregate(tfs.numpy_udf(fmax), jf.group_by("k"))
    with pytest.raises(NotImplementedError, match="cannot run under torch.func.vmap"):
        tft.aggregate(tft.numpy_udf(fmax), tf_.group_by("k"), **CPU)


def test_float_keyed_sums_after_a_lifted_stage():
    rng = np.random.default_rng(5)
    cols = {"k": rng.integers(0, 7, 400), "x": rng.standard_normal(400).astype(np.float32),
            "y": rng.standard_normal(400).astype(np.float32)}
    sums = []
    for P, kw in ((tfs, {}), (tft, CPU)):
        fr = P.frame_from_arrays(cols, num_blocks=3)
        f1 = P.map_blocks(lambda x, y: {"u": x * 2.0, "v": y + 1.0}, fr, **kw)
        f2 = P.map_blocks(P.numpy_udf(blend), f1, **kw)
        with P.with_graph():
            z = P.block(f2, "z", tf_name="z_input")
            out = P.aggregate([P.reduce_sum(z, axis=0, name="z")], f2.group_by("k"), **kw)
        sums.append((out.column_values("k"), out.column_values("z")))
    (jk, jz), (tk, tz) = sums
    assert np.array_equal(jk, tk)
    np.testing.assert_allclose(tz, jz, rtol=1e-5, atol=1e-5 * np.sqrt(400) * 6)


def test_map_rows_and_type_errors_read_as_reference():
    jf, tf_ = _both_frames({"x": np.arange(6, dtype=np.float32)})
    texts = []
    for P, f, kw in ((tfs, jf, {}), (tft, tf_, CPU)):
        with pytest.raises(P.ValidationError) as e:
            P.map_rows(P.numpy_udf(_arith), f, **kw)
        texts.append(str(e.value))
        for bad in (3, P.compile_program(lambda x: {"y": x}, f, **kw), P.placeholder("float32", [None])):
            with pytest.raises(TypeError) as e:
                P.numpy_udf(bad)
            texts.append(str(e.value))
    n = len(texts) // 2
    assert texts[n:] == texts[:n]


def test_decline_is_not_an_error():
    fr = tft.frame_from_arrays({"x": np.arange(8, dtype=np.float32)}, num_blocks=2)
    got = tft.map_blocks(tft.numpy_udf(closed_dict), fr, **CPU).column_values("c")
    assert tlift.lift_log()[-1]["reason"] == "mutable-closure:state"
    np.testing.assert_array_equal(got, np.arange(8, dtype=np.float32) * 2.0)


def test_host_stage_reads_inputs_read_only():
    def inplace(x):
        x += 1
        return {"y": x}

    fr = tft.frame_from_arrays({"x": np.arange(4, dtype=np.float32)}, num_blocks=1)
    with pytest.raises(ValueError, match="read-only"):
        tft.map_blocks(tft.numpy_udf(inplace), fr, **CPU).column_values("y")
    assert fr.column_values("x").tolist() == [0.0, 1.0, 2.0, 3.0]


def test_mutable_closure_capture_warns_like_reference():
    msgs = []
    for P, log in ((tfs, JLOG), (tft, TLOG)):
        n0 = len(log)
        P.numpy_udf(closed_list)
        warns = [d for d in list(log)[n0:] if d.code == "TFG112"]
        assert [d.severity for d in warns] == ["warn"]
        msgs.append(warns[0].explain())
        n0 = len(log)
        P.numpy_udf(_arith)
        assert not [d for d in list(log)[n0:] if d.code == "TFG112"]
    assert msgs[0] == msgs[1]


def test_lifting_disabled_records_reason():
    fr = tft.frame_from_arrays({"x": np.arange(8, dtype=np.float32)}, num_blocks=2)
    with _lifting_off():
        prog = tft.compile_program(tft.numpy_udf(_arith), fr, **CPU)
    rec = tlift.lift_log()[-1]
    assert (rec["lifted"], rec["reason"]) == (False, "lifting-disabled")
    assert rec["detail"] == "config.udf_lifting is off (TFTPU_LIFT=0)"
    assert prog._tftpu_has_callback and tir.program_has_callback(prog)


# ---------------------------------------------------------------------------
# the plan: barriers, fallbacks, TFG112, the report
# ---------------------------------------------------------------------------

def _chain_frames(P, kw, udf_fn):
    fr = P.frame_from_arrays({"x": np.arange(16, dtype=np.float32),
                              "y": np.arange(16, dtype=np.float32) - 7.5,
                              "k": np.arange(16) % 3}, num_blocks=2)
    f1 = P.map_blocks(lambda x, y: {"u": x * 2.0, "v": y + 1.0}, fr, **kw)
    return P.map_blocks(P.numpy_udf(udf_fn), f1, **kw)


def _rng_chain(P, kw):
    fr = P.frame_from_arrays({"x": np.arange(16, dtype=np.float32)}, num_blocks=2)
    f1 = P.map_blocks(lambda x: {"w": x * 2.0}, fr, **kw)
    return P.map_blocks(P.numpy_udf(rng_w), f1, **kw)


def rng_w(w):
    return {"r": w + np.random.rand(*w.shape)}


def test_chain_barriers_lifted_and_declined():
    for P, ir_mod, kw in ((tfs, jir, {}), (tft, tir, CPU)):
        assert ir_mod.chain_barriers(_chain_frames(P, kw, blend)) == (2, [])
        n_maps, barriers = ir_mod.chain_barriers(_rng_chain(P, kw))
        assert n_maps == 2 and len(barriers) == 1
    assert tir.chain_barriers(_rng_chain(tft, CPU)) == jir.chain_barriers(_rng_chain(tfs, {}))


def _fallbacks(reason="host_callback") -> float:
    return sum(float(d["value"]) for d in tft.observability.REGISTRY.snapshot()
               if d["name"] == "tftpu_plan_fallback_total" and d["labels"].get("reason") == reason)


@pytest.mark.parametrize("lifting", [True, False])
def test_host_callback_fallback_counted_only_when_declined(lifting):
    tft.configure(udf_lifting=lifting)
    f2 = _chain_frames(tft, CPU, blend)
    with tft.with_graph():
        z = tft.block(f2, "z", tf_name="z_input")
        agg = tft.aggregate([tft.reduce_sum(z, axis=0, name="z")], f2.group_by("k"), **CPU)
    before = _fallbacks()
    got = agg.column_values("z")
    assert (_fallbacks() - before > 0) is (not lifting)
    assert np.isfinite(got).all()


def test_lint_plan_tfg112_messages_whole():
    pairs = []
    for P, kw in ((tfs, {}), (tft, CPU)):
        lifted = [d.explain() for d in P.lint_plan(_chain_frames(P, kw, blend)).by_code("TFG112")]
        declined = [d.explain() for d in P.lint_plan(_rng_chain(P, kw)).by_code("TFG112")]
        P.configure(udf_lifting=False)
        disabled = [d.explain() for d in P.lint_plan(_chain_frames(P, kw, blend)).by_code("TFG112")]
        P.configure(udf_lifting=True)
        pairs.append((lifted, declined, disabled))
    assert pairs[0] == pairs[1]
    lifted, declined, disabled = pairs[1]
    assert [d.split()[1] for d in lifted + declined + disabled] == ["info", "warn", "warn"]
    assert "unsupported-call:np.random.rand" in declined[0]


_WALL = re.compile(r"\(verify \d+\.\d+s\)")


def _report_sequence(P, kw):
    fr = P.frame_from_arrays({"x": np.arange(8, dtype=np.float32)}, num_blocks=2)
    for fn in (_arith, loopy, rng_udf, closed_list):
        P.compile_program(P.numpy_udf(fn), fr, **kw)


def test_lift_report_matches_reference_walls_masked():
    assert tlift.lift_report() == jlift.lift_report() == \
        "lift-report: no UDF capture decisions recorded"
    _report_sequence(tfs, {})
    _report_sequence(tft, CPU)
    t, j = tlift.lift_report(), jlift.lift_report()
    assert _WALL.sub("(verify X)", t) == _WALL.sub("(verify X)", j)
    assert "LIFTED   _arith -> y" in t and "DECLINED loopy: unsupported-syntax:For at For line 3" in t


def test_cli_lift_report_matches_reference(capsys):
    from tensorframes_tpu.analysis.cli import main as jmain
    from tensorframes_tpu_torch.analysis.cli import main as tmain

    _report_sequence(tfs, {})
    _report_sequence(tft, CPU)
    assert jmain(["--lift-report"]) == 0
    j = capsys.readouterr().out
    assert tmain(["--lift-report"]) == 0
    t = capsys.readouterr().out
    assert _WALL.sub("(verify X)", t) == _WALL.sub("(verify X)", j)
    assert "LIFTED" in t and "DECLINED" in t


def test_tfg114_host_callback_fix_is_the_references():
    from tensorframes_tpu.analysis import rules as jrules
    from tensorframes_tpu_torch.analysis import rules as trules

    assert trules._TFG114_FIXES == jrules._TFG114_FIXES


# ---------------------------------------------------------------------------
# programs: callback markers, fake traces, fingerprints
# ---------------------------------------------------------------------------

def test_program_markers_survive_feed_dict_and_fake_traces():
    from tensorframes_tpu_torch.ops.verbs import _apply_feed_dict

    fr = tft.frame_from_arrays({"x": np.arange(8, dtype=np.float32)}, num_blocks=2)
    lifted = _apply_feed_dict(tft.compile_program(tft.numpy_udf(_arith), fr, **CPU),
                              {"x": "a"})
    with _lifting_off():
        host = _apply_feed_dict(tft.compile_program(tft.numpy_udf(_arith), fr, **CPU),
                                {"x": "a"})
    assert lifted.input_names == host.input_names == ["a"]
    assert not tir.program_has_callback(lifted) and lifted._tftpu_lifted
    assert tir.program_has_callback(host)
    assert lifted._tftpu_lift_info["lifted"] and host._tftpu_lift_info["reason"] == "lifting-disabled"
    # the host stage runs under fake tensors and make_fx without numpy
    # touching them: empty outputs of the probed shapes
    graph = tft.program.capture_graph(host, probe=5)
    assert graph.outputs == [("y", (5,), torch.float32)]
    assert host.lint().by_code("TFG103") == []


def test_lift_counter_registered_at_import():
    code = ("import tensorframes_tpu_torch as t\n"
            "print(sorted((d['labels']['outcome'], d['value']) for d in "
            "t.observability.REGISTRY.snapshot() if d['name'] == 'tftpu_lift_total'))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=str(ROOT)), timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[('declined', 0.0), ('lifted', 0.0)]"


def test_tftpu_lift_0_in_a_subprocess(tmp_path):
    (tmp_path / "udfmod.py").write_text(
        "import numpy as np\n\n\ndef _arith(x):\n    return {'y': (x * 2 + 1) - 3}\n")
    code = ("import numpy as np, tensorframes_tpu_torch as t\n"
            "from tensorframes_tpu_torch.plan import lift\n"
            "import udfmod\n"
            "fr = t.frame_from_arrays({'x': np.arange(6, dtype=np.float32)})\n"
            "v = t.map_blocks(t.numpy_udf(udfmod._arith), fr, device='cpu').column_values('y')\n"
            "r = lift.lift_log()[-1]\n"
            "print(t.get_config().udf_lifting, r['reason'], v.tolist())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=f"{ROOT}{os.pathsep}{tmp_path}",
                                  TFTPU_LIFT="0"), timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == (
        "False lifting-disabled [-2.0, 0.0, 2.0, 4.0, 6.0, 8.0]")


def test_fingerprint_lift_slot():
    from tensorframes_tpu_torch.compilecache import fingerprint as tfp
    from tensorframes_tpu_torch.compilecache import store as tstore

    on = tfp._env_parts("block", "cpu")
    fr = tft.frame_from_arrays({"x": np.arange(8, dtype=np.float32)}, num_blocks=2)
    prog = tft.compile_program(tft.numpy_udf(_arith), fr, **CPU)
    fp_on = tfp.program_fingerprint(prog)
    with _lifting_off():
        off = tfp._env_parts("block", "cpu")
        fp_off = tfp.program_fingerprint(prog)
        host = tft.compile_program(tft.numpy_udf(_arith), fr, **CPU)
        assert tfp.program_fingerprint(host) is None
        assert tfp.dispatch_fingerprint(host, "block", [("x", [4], "float32")], "cpu") is None
    assert on["lift"] == {"enabled": True, "version": tlift.LIFT_FORMAT_VERSION}
    assert off["lift"]["enabled"] is False and on != off
    assert fp_on is not None and fp_off is not None and fp_on != fp_off
    assert tfp.FORMAT_VERSION == 2
    # a dispatch of the host stage with an armed store is counted, not keyed
    count = tstore._FALLBACKS["unfingerprintable"]
    n0 = count.value
    was = tft.configure().compilation_cache_dir
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        tft.configure(compilation_cache_dir=d)
        try:
            with _lifting_off():
                tft.map_blocks(tft.numpy_udf(_arith), fr, **CPU).column_values("y")
        finally:
            tft.configure(compilation_cache_dir=was)
    assert count.value > n0
