"""Parity of the port's GraphDef importer (``tensorframes_tpu_torch.graphdef``)
with the JAX package's, on the same bytes.

The same frozen bytes go through the JAX importer (``compute_dtype=None``,
f32-faithful) and the port's (``device="cpu"``, where ``"auto"`` is
f32-faithful too), and TF's ``Session`` runs them as well. The graphs:
keras InceptionV3 at 75x75, MobileNetV2 96x96, ResNet50 64x64 and
EfficientNetB0 64x64 (random weights, frozen by TensorFlow in
module-scoped fixtures, as ``tests/test_graphdef_frozen.py`` builds them),
three sweep graphs of raw TF ops (math, shapes, image ops: every stride-2
SAME conv and pool at an odd and an even size), an un-frozen
``tf.function`` (nested ``PartitionedCall``) and a variable-bearing
SavedModel (``StatefulPartitionedCall`` over ``VarHandleOp`` reads).
:func:`test_every_reference_op_is_accepted_and_reached` holds the port's
op set to the reference's, and each name to one of these graphs.

Tolerances, once for the file: ``ATOL_JAX`` 1e-5 absolute between the
two importers (both f32 on the CPU; they differ in the order of f32 sums
in XLA's and PyTorch's CPU kernels), ``ATOL_TF`` 1e-4 against TF (the
JAX package's own bound, ``tests/test_graphdef_frozen.py``). Under
``compute_dtype="bfloat16"`` the port's convolution rounds its output to
bf16 where XLA keeps f32 (``graphdef.py``'s docstring), so the two
packages are held to ``BF16_RTOL`` of max |output|, each first to that
bound of TF's f32 run. Each test first holds the reference's leg against
TF (or its own expectation), so a failing reference shows as such.

Error cases need no TF: their bytes come from ``chip_smoke.py``'s wire
writer (``ld``/``vf``/``node_bytes``, as ``tests/test_graphdef.py``
writes them), and both packages must raise the same error type and
message.
"""

import ast
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import tensorframes_tpu as tfs
from tensorframes_tpu import graphdef as jgd

import tensorframes_tpu_torch as tft
from tensorframes_tpu_torch import graphdef as tgd

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import ld as _ld, node_bytes as _node_bytes, varint as _varint, vf as _vf  # noqa: E402

ATOL_JAX = 1e-5
ATOL_TF = 1e-4
BF16_RTOL = 2e-2  # of max |output|

ROOT = Path(__file__).resolve().parents[1]
KERAS_MODELS = {
    "InceptionV3": (75, 75, 3),
    "MobileNetV2": (96, 96, 3),
    "ResNet50": (64, 64, 3),
    "EfficientNetB0": (64, 64, 3),
}


@pytest.fixture(scope="module")
def tf():
    return pytest.importorskip("tensorflow")


def _freeze(tf, fn, spec):
    from tensorflow.python.framework.convert_to_constants import (
        convert_variables_to_constants_v2,
    )

    cf = tf.function(fn).get_concrete_function(spec)
    return convert_variables_to_constants_v2(cf).graph.as_graph_def().SerializeToString()


@pytest.fixture(scope="module")
def keras_graphs(tf):
    """name → frozen bytes of each keras model (random weights, seed 3)."""
    out = {}
    for name, shape in KERAS_MODELS.items():
        tf.keras.utils.set_random_seed(3)
        model = getattr(tf.keras.applications, name)(weights=None, input_shape=shape)
        out[name] = _freeze(tf, lambda x, m=model: m(x, training=False),
                            tf.TensorSpec([None, *shape], tf.float32))
    return out


def _tf_run(tf, data, fetches, feeds):
    """TF's ``Session`` on the bytes as written: grappler's rewrites off
    (they cost seconds a graph and only fuse or fold what the kernels
    compute anyway)."""
    gd = tf.compat.v1.GraphDef()
    gd.ParseFromString(data)
    config = tf.compat.v1.ConfigProto()
    config.graph_options.rewrite_options.disable_meta_optimizer = True
    with tf.Graph().as_default() as g:
        tf.import_graph_def(gd, name="")
        with tf.compat.v1.Session(graph=g, config=config) as sess:
            got = sess.run([f + ":0" for f in fetches],
                           {f"{k}:0": v for k, v in feeds.items()})
    return dict(zip(fetches, got))


def _port_fn(prog, feeds):
    with torch.inference_mode():
        out = prog.fn({k: torch.from_numpy(v) for k, v in feeds.items()})
    return {k: v.numpy() for k, v in out.items()}


def _jax_fn(prog, feeds):
    """The reference's program compiled whole, as its verbs run it."""
    import jax

    return {k: np.asarray(v) for k, v in jax.jit(prog.fn)(feeds).items()}


def _close(got, want, atol, what):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, atol=atol, rtol=0, err_msg=what)


# ---------------------------------------------------------------------------
# frozen keras models, through the port's map_blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(KERAS_MODELS))
def test_keras_graph_matches_reference_and_tf(tf, keras_graphs, name):
    data = keras_graphs[name]
    jprog = jgd.program_from_graphdef(jgd.parse_graphdef(data), relax_lead_dim=True,
                                      compute_dtype=None)
    [inp] = jprog.inputs
    fetch = jprog.fetch_order[0]
    x = np.random.default_rng(4).standard_normal((3, *KERAS_MODELS[name])).astype(np.float32)
    want = _tf_run(tf, data, [fetch], {inp.name: x})[fetch]
    ref = _jax_fn(jprog, {inp.name: x})[fetch]
    _close(ref, want, ATOL_TF, f"{name}: the reference against TF")

    tprog = tgd.program_from_graphdef(tgd.parse_graphdef(data), relax_lead_dim=True,
                                      device="cpu")
    tprog = tft.program.analyze_program(tprog, device="cpu")
    assert [i.name for i in tprog.inputs] == [inp.name]
    frame = tft.frame_from_arrays({inp.name: x}, num_blocks=2)
    got = tft.map_blocks(tprog, frame, device="cpu").column_values(fetch)
    _close(got, ref, ATOL_JAX, f"{name}: the port against the reference")
    _close(got, want, ATOL_TF, f"{name}: the port against TF")
    top2 = np.sort(want, axis=1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 2 * ATOL_TF
    np.testing.assert_array_equal(got.argmax(1)[clear], want.argmax(1)[clear])


def test_load_graphdef_from_a_file(tf, keras_graphs, tmp_path):
    """``load_graphdef`` reads the file, analyses the program on the
    device asked for (Unknown lead dim kept) and scores like the bytes'
    own import."""
    path = tmp_path / "mobilenet.pb"
    path.write_bytes(keras_graphs["MobileNetV2"])
    jprog = tfs.load_graphdef(str(path), relax_lead_dim=True, compute_dtype=None)
    tprog = tft.load_graphdef(str(path), relax_lead_dim=True, device="cpu")
    assert [o.pretty() for o in tprog.outputs] == [o.pretty() for o in jprog.outputs]
    [inp] = tprog.inputs
    x = np.random.default_rng(5).standard_normal((2, 96, 96, 3)).astype(np.float32)
    fetch = tprog.fetch_order[0]
    ref = _jax_fn(jprog, {inp.name: x})[fetch]
    _close(_port_fn(tprog, {inp.name: x})[fetch], ref, ATOL_JAX, "load_graphdef")


def _small_cnn(tf, seed):
    """A keras CNN with a stride-2 SAME conv, a pool and two dense layers,
    frozen: the quantize and bf16 legs' graph."""
    tf.keras.utils.set_random_seed(seed)
    model = tf.keras.Sequential([
        tf.keras.layers.Input((16, 16, 3)),
        tf.keras.layers.Conv2D(8, 3, strides=2, padding="same", activation="relu"),
        tf.keras.layers.DepthwiseConv2D(3, padding="same", activation="relu"),
        tf.keras.layers.MaxPooling2D(2),
        tf.keras.layers.Flatten(),
        tf.keras.layers.Dense(16, activation="relu"),
        tf.keras.layers.Dense(5),
    ])
    return _freeze(tf, lambda x: model(x, training=False),
                   tf.TensorSpec([None, 16, 16, 3], tf.float32))


def test_quantize_weights_matches_reference(tf):
    """``quantize_weights=True`` on both importers: the same per-channel
    int8 filters (conv, depthwise with its (2, 3) channel spec, dense),
    the scale on each output; within ATOL_JAX of each other, and visibly
    off the f32 import."""
    data = _small_cnn(tf, 21)
    x = np.random.default_rng(22).standard_normal((4, 16, 16, 3)).astype(np.float32)
    jq = jgd.program_from_graphdef(jgd.parse_graphdef(data), relax_lead_dim=True,
                                   quantize_weights=True, compute_dtype=None)
    jf = jgd.program_from_graphdef(jgd.parse_graphdef(data), relax_lead_dim=True,
                                   compute_dtype=None)
    [inp] = jq.inputs
    fetch = jq.fetch_order[0]
    ref_q, ref_f = _jax_fn(jq, {inp.name: x})[fetch], _jax_fn(jf, {inp.name: x})[fetch]
    np.testing.assert_allclose(ref_q, ref_f, atol=0.05, rtol=0.1)
    assert not np.allclose(ref_q, ref_f, atol=ATOL_JAX, rtol=0)
    tq = tgd.program_from_graphdef(tgd.parse_graphdef(data), relax_lead_dim=True,
                                   quantize_weights=True, device="cpu")
    _close(_port_fn(tq, {inp.name: x})[fetch], ref_q, ATOL_JAX, "int8 import")


def test_bfloat16_import_matches_reference(tf, keras_graphs):
    """``compute_dtype="bfloat16"``: the matmul-class ops contract bf16
    operands into f32 on both sides; the port's convs round their output
    to bf16 first. Both within BF16_RTOL of TF's f32 run and of each
    other; f32 outputs."""
    data = keras_graphs["ResNet50"]
    x = np.random.default_rng(23).standard_normal((2, 64, 64, 3)).astype(np.float32)
    jprog = jgd.program_from_graphdef(jgd.parse_graphdef(data), relax_lead_dim=True,
                                      compute_dtype="bfloat16")
    [inp] = jprog.inputs
    fetch = jprog.fetch_order[0]
    # the logits before softmax: the sensitive quantity
    logits = [n.inputs[0] for n in jgd.parse_graphdef(data) if n.name == fetch][0]
    want = _tf_run(tf, data, [logits], {inp.name: x})[logits]
    bound = BF16_RTOL * np.abs(want).max()
    jfetch = jgd.program_from_graphdef(jgd.parse_graphdef(data), fetches=[logits],
                                       relax_lead_dim=True, compute_dtype="bfloat16")
    ref = _jax_fn(jfetch, {inp.name: x})[logits]
    _close(ref, want, bound, "the reference's bf16 import against TF")
    tprog = tgd.program_from_graphdef(tgd.parse_graphdef(data), fetches=[logits],
                                      relax_lead_dim=True, compute_dtype="bfloat16",
                                      device="cpu")
    got = _port_fn(tprog, {inp.name: x})[logits]
    assert got.dtype == np.float32
    _close(got, want, bound, "the port's bf16 import against TF")
    _close(got, ref, bound, "the port's bf16 import against the reference's")


def test_f64_graph_stays_f64_under_bf16_policy(tf):
    """A DT_DOUBLE conv/matmul graph stays exactly f64 with no policy and
    under ``compute_dtype="bfloat16"`` (its cast is f32-operand-only)."""
    rng = np.random.default_rng(7)
    w = rng.standard_normal((3, 3, 2, 4))
    with tf.Graph().as_default() as g:
        x = tf.compat.v1.placeholder(tf.float64, [None, 8, 8, 2], name="x")
        y = tf.nn.conv2d(x, tf.constant(w, dtype=tf.float64), strides=1, padding="SAME")
        tf.linalg.matmul(tf.reshape(y, [-1, 8 * 8 * 4]),
                         tf.constant(rng.standard_normal((8 * 8 * 4, 3)), tf.float64),
                         name="out")
    data = g.as_graph_def().SerializeToString()
    xv = rng.standard_normal((2, 8, 8, 2))
    want = _tf_run(tf, data, ["out"], {"x": xv})["out"]
    for policy in (None, "bfloat16"):
        ref = _jax_fn(jgd.program_from_graphdef(jgd.parse_graphdef(data), fetches=["out"],
                                                compute_dtype=policy), {"x": xv})["out"]
        np.testing.assert_allclose(ref, want, atol=1e-10)
        got = _port_fn(tgd.program_from_graphdef(tgd.parse_graphdef(data), fetches=["out"],
                                                 compute_dtype=policy, device="cpu"),
                       {"x": xv})["out"]
        assert got.dtype == np.float64
        np.testing.assert_allclose(got, want, atol=1e-10)


# ---------------------------------------------------------------------------
# sweep graphs: every op of the reference's set
# ---------------------------------------------------------------------------

def _math_graph(tf):
    rng = np.random.default_rng(11)
    feeds = {
        "x": rng.uniform(-0.9, 0.9, (4, 6)).astype(np.float32),
        "p": rng.uniform(1.1, 3.0, (4, 6)).astype(np.float32),
        "i": rng.integers(1, 6, (4, 6)).astype(np.int32),
    }
    with tf.Graph().as_default() as g:
        x = tf.compat.v1.placeholder(tf.float32, [None, 6], name="x")
        p = tf.compat.v1.placeholder(tf.float32, [None, 6], name="p")
        i = tf.compat.v1.placeholder(tf.int32, [None, 6], name="i")
        r = tf.nn.relu(x)  # zeros for the 0-input short-circuits
        f = lambda t: tf.cast(t, tf.float32)  # noqa: E731
        raw = tf.raw_ops
        outs = {
            "add": raw.Add(x=x, y=p), "div": raw.Div(x=x, y=p),
            "floordiv": raw.FloorDiv(x=x * 4.0, y=p), "floormod": raw.FloorMod(x=x * 4.0, y=p),
            "pow": raw.Pow(x=p, y=x), "sqdiff": raw.SquaredDifference(x=x, y=p),
            "cmp": f(raw.Greater(x=x, y=0.1)) + 2 * f(raw.GreaterEqual(x=x, y=0.1))
            + 4 * f(raw.Less(x=x, y=0.2)) + 8 * f(raw.LessEqual(x=x, y=0.2))
            + 16 * f(raw.Equal(x=i, y=3)) + 32 * f(raw.NotEqual(x=i, y=3)),
            "logic": f(raw.LogicalAnd(x=x > 0, y=p > 2)) + 2 * f(raw.LogicalOr(x=x > 0, y=p > 2))
            + 4 * f(raw.LogicalNot(x=x > 0)),
            "atan2": raw.Atan2(y=x, x=p), "xdivy": raw.Xdivy(x=r, y=p),
            "xlogy": raw.Xlogy(x=r, y=p), "divnonan": raw.DivNoNan(x=p, y=r),
            "mod": raw.Mod(x=x * 7.0, y=p), "truncdiv": f(raw.TruncateDiv(x=i * 7 - 20, y=i)),
            "minimum": raw.Minimum(x=x, y=p - 2.0),
            "plumb": raw.Snapshot(input=raw.PreventGradient(input=tf.debugging.check_numerics(
                tf.stop_gradient(x), "x"))),
            "logsoftmax": tf.nn.log_softmax(x), "l2loss": raw.L2Loss(t=x),
            "neg_sq_abs": raw.Neg(x=raw.Square(x=x)) + raw.Abs(x=x),
            "exp_log_tanh": raw.Exp(x=x) + raw.Log(x=p) + raw.Tanh(x=x),
            "erf": raw.Erf(x=x) + raw.Erfc(x=x),
            "rounding": raw.Floor(x=x * 5) + 10 * raw.Ceil(x=x * 5) + 100 * raw.Round(x=x * 5),
            "elu_selu": raw.Elu(features=x) + raw.Selu(features=x),
            "softplus_sign": raw.Softplus(features=x) + raw.Softsign(features=x),
            "trig": raw.Sin(x=x) + raw.Cos(x=x) + raw.Tan(x=x) + raw.Atan(x=x)
            + raw.Asin(x=x) + raw.Acos(x=x),
            "hyper": raw.Sinh(x=x) + raw.Cosh(x=x) + raw.Asinh(x=x) + raw.Acosh(x=p)
            + raw.Atanh(x=x),
            "log1p_expm1": raw.Log1p(x=p) + raw.Expm1(x=x),
            "recip_sign": raw.Reciprocal(x=p) + raw.Sign(x=x),
            "finite": f(raw.IsNan(x=x)) + 2 * f(raw.IsInf(x=x)) + 4 * f(raw.IsFinite(x=x)),
            "sum": tf.reduce_sum(x, 1), "min": tf.reduce_min(x, 0, keepdims=True),
            "max": tf.reduce_max(x, [0, 1]), "prod": tf.reduce_prod(p, 1),
            "all_any": f(tf.reduce_all(x > -0.5, 1)) + 2 * f(tf.reduce_any(x > 0.8, 1)),
        }
        for k, v in outs.items():
            tf.identity(v, name=f"out_{k}")
    return g.as_graph_def().SerializeToString(), feeds, [f"out_{k}" for k in sorted(outs)]


def _shape_graph(tf):
    rng = np.random.default_rng(12)
    feeds = {
        "x": rng.standard_normal((4, 6)).astype(np.float32),
        "idx": rng.integers(0, 5, (4,)).astype(np.int32),
    }
    with tf.Graph().as_default() as g:
        x = tf.compat.v1.placeholder(tf.float32, [None, 6], name="x")
        idx = tf.compat.v1.placeholder(tf.int32, [None], name="idx")
        raw = tf.raw_ops
        f = lambda t: tf.cast(t, tf.float32)  # noqa: E731
        table = tf.constant(rng.standard_normal((5, 3)).astype(np.float32))
        w = tf.constant(rng.standard_normal((6, 3)).astype(np.float32))
        x3 = tf.reshape(x, [-1, 2, 3])
        a, b, c = tf.split(x, 3, axis=1)
        s1, s2 = tf.split(x, [2, 4], axis=1)
        cols = tf.unstack(x, num=6, axis=1)
        tv, ti = tf.math.top_k(x, k=3)
        n1, n2 = tf.identity_n([x, x * 2.0])
        outs = {
            "concat": raw.Concat(concat_dim=1, values=[x, x]),
            "padv2": tf.pad(x, [[0, 0], [1, 2]], constant_values=3.0),
            "tile_expand": tf.tile(tf.expand_dims(x, 1), [1, 2, 1]),
            "fill": tf.fill(tf.shape(x), 2.5) + x,
            "range": x + f(tf.range(0, tf.shape(x)[1])),
            "argmax": f(tf.argmax(x, 1)) + 10 * f(tf.argmin(x, 1)),
            "gather": tf.gather(table, idx),
            "einsum": tf.einsum("bi,ij->bj", x, w),
            "transpose": tf.transpose(x),
            "select": tf.compat.v1.where(x > 0, x, -x) + tf.where(x > 0.5, x, 0.0 * x),
            "bmm": tf.linalg.matmul(x3, x3, transpose_b=True)
            + raw.BatchMatMul(x=x3, y=x3, adj_y=True),
            "leaky": tf.nn.leaky_relu(x, alpha=0.1),
            "slice": tf.slice(x, [0, 2], [-1, 3]),
            "zeros_ones": tf.zeros_like(x) + 2 * tf.ones_like(x),
            "bcast": tf.broadcast_to(tf.reduce_sum(x, axis=1, keepdims=True), [4, 6]),
            "onehot": tf.one_hot(idx, 5, on_value=2.0, off_value=-1.0),
            "cumsum": tf.cumsum(x, axis=1) + tf.math.cumprod(tf.abs(x) + 0.5, axis=0),
            "rank_size": f(raw.Rank(input=x)) + f(tf.size(x)) + 0 * x,
            "addn": tf.add_n([x, x, 2 * x]),
            "reverse": tf.reverse(x, [1]),
            "gather_nd": tf.gather_nd(x, [[0, 1], [1, 2], [3, 5]]),
            "mirror": tf.pad(x, [[0, 0], [2, 2]], mode="REFLECT")
            + tf.pad(x, [[0, 0], [2, 2]], mode="SYMMETRIC"),
            "band": tf.linalg.band_part(x3, 1, 0),
            "split": a * 2.0 + b - c + tf.concat([s1, s2[:, :2]], 1)[:, :2],
            "unpack": cols[1] + cols[4],
            "topk": tv + f(ti),
            "identity_n": n1 + n2,
            "strided": x[:, ::-1] + x[:, ::2][:, :1],
        }
        for k, v in outs.items():
            tf.identity(v, name=f"out_{k}")
    return g.as_graph_def().SerializeToString(), feeds, [f"out_{k}" for k in sorted(outs)]


def _image_graph(tf):
    """Stride-2 SAME convs (3x3, 2x2, dilated 3x3), depthwise conv and
    pools at an odd (7) and an even (8) size, where TF's split differs;
    FusedBatchNorm v1-v3, depth/space shuffles and the legacy resizes."""
    rng = np.random.default_rng(13)
    feeds = {
        "img8": rng.standard_normal((2, 8, 8, 4)).astype(np.float32),
        "img7": rng.standard_normal((2, 7, 7, 4)).astype(np.float32),
    }
    with tf.Graph().as_default() as g:
        raw = tf.raw_ops
        outs = {}
        for size in (8, 7):
            x = tf.compat.v1.placeholder(tf.float32, [None, size, size, 4], name=f"img{size}")
            k3 = tf.constant(rng.standard_normal((3, 3, 4, 6)).astype(np.float32) / 6)
            k2 = tf.constant(rng.standard_normal((2, 2, 4, 6)).astype(np.float32) / 4)
            dk = tf.constant(rng.standard_normal((3, 3, 4, 2)).astype(np.float32) / 3)
            outs[f"conv3_s2_{size}"] = tf.nn.conv2d(x, k3, 2, "SAME")
            outs[f"conv2_s2_{size}"] = tf.nn.conv2d(x, k2, 2, "SAME")
            outs[f"conv3_d2_{size}"] = tf.nn.conv2d(x, k3, 1, "SAME", dilations=2)
            outs[f"dw_s2_{size}"] = tf.nn.depthwise_conv2d(x, dk, [1, 2, 2, 1], "SAME")
            outs[f"max_s2_{size}"] = tf.nn.max_pool2d(x, 3, 2, "SAME")
            outs[f"avg_s2_{size}"] = tf.nn.avg_pool2d(x, 3, 2, "SAME")
            outs[f"avg_valid_{size}"] = tf.nn.avg_pool2d(x, 2, 2, "VALID")
        x = g.get_tensor_by_name("img8:0")
        scale, offset = np.float32([1.5, 0.5, 1.0, 2.0]), np.float32([0.1, -0.2, 0.0, 0.3])
        mean, var = np.float32([0.2, 0.0, -0.1, 0.4]), np.float32([1.0, 2.0, 0.5, 1.5])
        bn = dict(x=x, scale=scale, offset=offset, mean=mean, variance=var, is_training=False)
        outs["batchnorm"] = (raw.FusedBatchNorm(**bn).y + raw.FusedBatchNormV2(**bn).y
                             + raw.FusedBatchNormV3(**bn, epsilon=1e-3).y)
        outs["d2s"] = raw.DepthToSpace(input=x, block_size=2)
        outs["s2d"] = raw.SpaceToDepth(input=x, block_size=2)
        outs["bilinear"] = raw.ResizeBilinear(images=x, size=[11, 5], half_pixel_centers=True)
        outs["nearest"] = raw.ResizeNearestNeighbor(images=x, size=[5, 13], align_corners=True)
        for k, v in outs.items():
            tf.identity(v, name=f"out_{k}")
    return g.as_graph_def().SerializeToString(), feeds, [f"out_{k}" for k in sorted(outs)]


_SWEEPS = {"math": _math_graph, "shape": _shape_graph, "image": _image_graph}


@pytest.fixture(scope="module")
def sweep_graphs(tf):
    return {name: build(tf) for name, build in _SWEEPS.items()}


@pytest.mark.parametrize("name", list(_SWEEPS))
def test_sweep_graph_matches_reference_and_tf(tf, sweep_graphs, name):
    data, feeds, fetches = sweep_graphs[name]
    want = _tf_run(tf, data, fetches, feeds)
    ref = _jax_fn(jgd.program_from_graphdef(jgd.parse_graphdef(data), fetches=fetches,
                                            compute_dtype=None), feeds)
    for f in fetches:
        _close(ref[f], np.asarray(want[f]), ATOL_TF, f"reference {f}")
    got = _port_fn(tgd.program_from_graphdef(tgd.parse_graphdef(data), fetches=fetches,
                                             device="cpu"), feeds)
    for f in fetches:
        _close(got[f], ref[f], ATOL_JAX, f"port {f}")


def _function_graph(tf):
    """An un-frozen ``tf.function`` export: nested PartitionedCall bodies,
    a multi-output function."""

    @tf.function
    def leaf(x):
        return tf.tanh(x)

    @tf.function
    def mid(x):
        a, b = tf.split(leaf(x), 2, axis=1)
        return a + b, a * b

    @tf.function
    def top(x):
        s, p = mid(x * 0.5)
        return s - p

    cf = top.get_concrete_function(tf.TensorSpec([None, 8], tf.float32))
    x = np.random.default_rng(14).standard_normal((5, 8)).astype(np.float32)
    return cf.graph.as_graph_def().SerializeToString(), x, top(x).numpy()


def test_partitioned_call_matches_reference(tf):
    data, x, want = _function_graph(tf)
    assert tgd.parse_graphdef(data).library
    jprog = jgd.program_from_graphdef(jgd.parse_graphdef(data), relax_lead_dim=True,
                                      compute_dtype=None)
    [inp] = jprog.inputs
    fetch = jprog.fetch_order[0]
    ref = _jax_fn(jprog, {inp.name: x})[fetch]
    _close(ref, want, ATOL_TF, "reference")
    tprog = tgd.program_from_graphdef(tgd.parse_graphdef(data), relax_lead_dim=True,
                                      device="cpu")
    _close(_port_fn(tprog, {inp.name: x})[fetch], ref, ATOL_JAX, "port")
    # quantize_weights on a library-bearing graph is rejected in both
    for gd in (jgd, tgd):
        with pytest.raises(ValueError, match="function library"):
            gd.program_from_graphdef(gd.parse_graphdef(data), quantize_weights=True,
                                     **({"device": "cpu"} if gd is tgd else {}))


def _saved_module(tf, path):
    """A variable-bearing ``tf.Module`` saved as a SavedModel: its serving
    signature calls the body through StatefulPartitionedCall over
    VarHandleOp reads, restored from the checkpoint bundle."""
    rng = np.random.default_rng(15)

    class Affine(tf.Module):
        def __init__(self):
            super().__init__()
            self.w = tf.Variable(rng.standard_normal((4, 3)).astype(np.float32), name="w")
            self.b = tf.Variable(rng.standard_normal(3).astype(np.float32), name="b")

        @tf.function(input_signature=[tf.TensorSpec([None, 4], tf.float32)])
        def __call__(self, x):
            return {"y": tf.nn.relu6(tf.matmul(x, self.w) + self.b)}

    m = Affine()
    tf.saved_model.save(m, str(path), signatures=m.__call__)
    x = rng.standard_normal((5, 4)).astype(np.float32)
    return x, m(x)["y"].numpy()


def test_variable_saved_model_matches_reference(tf, tmp_path):
    x, want = _saved_module(tf, tmp_path / "sm")
    jprog = tfs.load_saved_model(str(tmp_path / "sm"), relax_lead_dim=True, compute_dtype=None)
    ref = _jax_fn(jprog, {"x": x})["y"]
    _close(ref, want, ATOL_TF, "reference")
    tprog = tft.load_saved_model(str(tmp_path / "sm"), relax_lead_dim=True, device="cpu")
    assert tprog.explain() == jprog.explain()
    _close(_port_fn(tprog, {"x": x})["y"], ref, ATOL_JAX, "port")


def _reference_ops():
    """Every op name ``tensorframes_tpu/graphdef.py`` dispatches on, read
    from its source text: the keys of ``_BINARY``/``_UNARY``/``_REDUCERS``
    and the ``structural`` tuple of ``program_from_graphdef``."""
    tree = ast.parse((ROOT / "tensorframes_tpu" / "graphdef.py").read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and isinstance(
                node.targets[0], ast.Name):
            target = node.targets[0].id
            if target in ("_BINARY", "_UNARY", "_REDUCERS") and isinstance(node.value, ast.Dict):
                names |= {k.value for k in node.value.keys}
            elif target == "structural" and isinstance(node.value, ast.Tuple):
                names |= {e.value for e in node.value.elts}
    return names


def _ops_of(nodes):
    ops = {n.op for n in nodes}
    for fd in getattr(nodes, "library", {}).values():
        ops |= {n.op for n in fd.nodes}
    return ops


def test_every_reference_op_is_accepted_and_reached(tf, keras_graphs, sweep_graphs, tmp_path):
    """The port accepts exactly the reference's ops, and each is run by one
    of this file's parity graphs."""
    ref = _reference_ops()
    assert len(ref) > 130
    assert tgd.SUPPORTED_OPS == ref, sorted(tgd.SUPPORTED_OPS ^ ref)
    reached = set()
    for data in keras_graphs.values():
        reached |= _ops_of(tgd.parse_graphdef(data))
    for data, _, _ in sweep_graphs.values():
        reached |= _ops_of(tgd.parse_graphdef(data))
    reached |= _ops_of(tgd.parse_graphdef(_function_graph(tf)[0]))
    _saved_module(tf, tmp_path / "sm")
    nodes, _ = tgd.parse_saved_model((tmp_path / "sm" / "saved_model.pb").read_bytes())
    reached |= _ops_of(nodes)
    assert not ref - reached, sorted(ref - reached)


# ---------------------------------------------------------------------------
# errors: the same type and message in both packages (wire bytes, no TF)
# ---------------------------------------------------------------------------

_FLOAT = ("dtype", _vf(6, 1))
_SHAPE2 = ("shape", _ld(7, _ld(2, _vf(1, 2))))


def _graph(*nodes) -> bytes:
    return b"".join(_ld(1, n) for n in nodes)


def _error(fn):
    with pytest.raises(Exception) as info:
        fn()
    return type(info.value), str(info.value)


def _both(build, run=None):
    """``(reference error, port error)`` of ``build(pkg)`` (then
    ``run(program)``, where the error comes when the program runs)."""
    out = []
    for gd in (jgd, tgd):
        def go(gd=gd):
            prog = build(gd)
            if run is not None:
                run(gd, prog)
        out.append(_error(go))
    return out


def _import(data, **kw):
    def build(gd):
        extra = {"device": "cpu"} if gd is tgd else {}
        return gd.program_from_graphdef(gd.parse_graphdef(data), **kw, **extra)
    return build


def _call(feeds):
    def run(gd, prog):
        prog.fn({k: (torch.from_numpy(v) if gd is tgd else v) for k, v in feeds.items()})
    return run


_X = {"x": np.asarray([1.5, -2.0], np.float32)}


def test_unknown_op_raises_like_reference():
    data = _graph(_node_bytes("x", "Placeholder", attrs=[_FLOAT, _SHAPE2]),
                  _node_bytes("c", "Cholesky", ["x"]))
    ref, got = _both(_import(data, fetches=["c"]))
    assert ref[0] is ValueError and "Cholesky" in ref[1]
    assert got == ref


@pytest.mark.parametrize("data", [b"\x0a\xff\xff\xff", bytes(range(1, 64))])
def test_malformed_bytes_raise_like_reference(data):
    errs = [_error(lambda gd=gd: gd.parse_graphdef(data)) for gd in (jgd, tgd)]
    assert errs[0][0] is ValueError and "GraphDef" in errs[0][1]
    assert errs[1] == errs[0]


def test_string_const_raises_like_reference():
    """A string Const parses; fetching it raises at import, consuming it
    when the program runs, in both packages."""
    string_t = _ld(8, _vf(1, 7) + _ld(8, b"hi"))
    nodes = [_node_bytes("x", "Placeholder", attrs=[_FLOAT, _SHAPE2]),
             _node_bytes("s", "Const", attrs=[("dtype", _vf(6, 7)), ("value", string_t)]),
             _node_bytes("y", "Identity", ["x"]),
             _node_bytes("bad", "Add", ["x", "s"])]
    data = _graph(*nodes)
    for gd in (jgd, tgd):
        t = gd._parse_tensor(_vf(1, 7) + _ld(8, b"hi"))
        assert isinstance(t, gd._StringTensor) and t.values == [b"hi"]
    ref, got = _both(_import(data, fetches=["s"]))
    assert ref[0] is ValueError and "string" in ref[1]
    assert got == ref
    ref, got = _both(_import(data, fetches=["bad"]), _call(_X))
    assert ref[0] is ValueError and "string" in ref[1]
    assert got == ref
    out = _port_fn(tgd.program_from_graphdef(tgd.parse_graphdef(data), fetches=["y"],
                                             device="cpu"), _X)
    np.testing.assert_array_equal(out["y"], _X["x"])


def test_cycle_raises_like_reference():
    data = _graph(_node_bytes("x", "Placeholder", attrs=[_FLOAT, _SHAPE2]),
                  _node_bytes("a", "Identity", ["b"]), _node_bytes("b", "Identity", ["a"]))
    ref, got = _both(_import(data, fetches=["a"]), _call(_X))
    assert ref[0] is ValueError and "cycle" in ref[1]
    assert got == ref


def test_deep_chain_evaluates_like_reference():
    """2,500 sequential ops, deeper than Python's recursion limit."""
    nodes = [_node_bytes("x", "Placeholder", attrs=[_FLOAT, _SHAPE2])]
    prev = "x"
    for i in range(2500):
        nodes.append(_node_bytes(f"n{i}", "Neg" if i % 2 else "Identity", [prev]))
        prev = f"n{i}"
    data = _graph(*nodes)
    ref = _jax_fn(jgd.program_from_graphdef(jgd.parse_graphdef(data), fetches=[prev]), _X)
    np.testing.assert_array_equal(ref[prev], _X["x"])
    got = _port_fn(tgd.program_from_graphdef(tgd.parse_graphdef(data), fetches=[prev],
                                             device="cpu"), _X)
    np.testing.assert_array_equal(got[prev], ref[prev])


def test_multi_output_fetches_like_reference():
    """``:k`` refs select outputs of multi-output ops (Split here); a
    ``:k>0`` fetch of a single-output op, or past the op's outputs,
    raises the same error in both packages."""
    split_dim = _ld(8, _vf(1, 3) + _ld(2, b"") + _ld(4, np.int32(0).tobytes()))
    shape4 = ("shape", _ld(7, _ld(2, _vf(1, 4))))
    data = _graph(
        _node_bytes("x", "Placeholder", attrs=[_FLOAT, shape4]),
        _node_bytes("d", "Const", attrs=[("dtype", _vf(6, 3)), ("value", split_dim)]),
        _node_bytes("sp", "Split", ["d", "x"], attrs=[("num_split", _vf(3, 2))]),
        _node_bytes("y", "Mul", ["sp:0", "sp:1"]),
    )
    feeds = {"x": np.asarray([1.0, 2.0, 3.0, 4.0], np.float32)}
    ref = _jax_fn(jgd.program_from_graphdef(jgd.parse_graphdef(data),
                                            fetches=["y", "sp:1"]), feeds)
    np.testing.assert_array_equal(ref["y"], [3.0, 8.0])
    got = _port_fn(tgd.program_from_graphdef(tgd.parse_graphdef(data), fetches=["y", "sp:1"],
                                             device="cpu"), feeds)
    for k in ("y", "sp:1"):
        np.testing.assert_array_equal(got[k], ref[k])
    for fetch, words in (("y:1", "single-output"), ("sp:2", "has 2 outputs"),
                         ("sp:z", "malformed output suffix")):
        ref_e, got_e = _both(_import(data, fetches=[fetch]))
        assert ref_e[0] is ValueError and words in ref_e[1], ref_e
        assert got_e == ref_e


def test_cast_bad_enum_raises_like_reference():
    data = _graph(_node_bytes("x", "Placeholder", attrs=[_FLOAT, _SHAPE2]),
                  _node_bytes("c", "Cast", ["x"], attrs=[("DstT", _vf(6, 100))]))
    ref, got = _both(_import(data, fetches=["c"]), _call(_X))
    assert ref[0] is ValueError and "DstT" in ref[1]
    assert got == ref


def test_tensor_decoding_like_reference():
    """fp16 ``half_val`` bit patterns and TF's partial-fill convention
    decode to the same arrays in both packages."""
    half = b"".join(_varint(b) for b in (0x3E00, 0x4100))
    protos = [
        _vf(1, 19) + _ld(2, _ld(2, _vf(1, 2))) + _ld(13, half),
        _vf(1, 1) + _ld(2, _ld(2, _vf(1, 5))) + _ld(5, np.float32([1, 2]).tobytes()),
    ]
    for proto in protos:
        ref, got = jgd._parse_tensor(proto), tgd._parse_tensor(proto)
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)


def test_unresolved_variable_error_like_reference():
    """An unbound VarHandleOp raises the dedicated ``ValueError``
    subclass, with the reference's message (naming this package's
    bundle reader)."""
    node = jgd.GraphNode(name="w", op="VarHandleOp", inputs=[], attrs={})
    ref = _error(lambda: jgd.program_from_graphdef([node], fetches=["w"]))
    tnode = tgd.GraphNode(name="w", op="VarHandleOp", inputs=[], attrs={})
    got = _error(lambda: tgd.program_from_graphdef([tnode], fetches=["w"], device="cpu"))
    assert ref[0] is jgd.UnresolvedVariableError and got[0] is tgd.UnresolvedVariableError
    assert issubclass(got[0], ValueError)
    assert got[1] == ref[1].replace("tensorframes_tpu.bundle", "tensorframes_tpu_torch.bundle")


def test_compute_dtype_auto_resolves_by_device(monkeypatch, caplog):
    """``"auto"``: bfloat16 on a CUDA device (one INFO line per process),
    f32-faithful on the CPU; ``None`` opts out anywhere."""
    import logging

    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert tgd._resolve_compute_dtype("auto", cpu) is None
    assert tgd._resolve_compute_dtype(None, cuda) is None
    assert tgd._resolve_compute_dtype("bfloat16", cpu) is torch.bfloat16
    monkeypatch.setattr(tgd, "_auto_bf16_logged", False)
    with caplog.at_level(logging.INFO, logger="tensorframes_tpu_torch.graphdef"):
        assert tgd._resolve_compute_dtype("auto", cuda) is torch.bfloat16
        assert tgd._resolve_compute_dtype("auto", cuda) is torch.bfloat16
    hits = [r for r in caplog.records if "bfloat16" in r.getMessage()]
    assert len(hits) == 1 and "compute_dtype=None" in hits[0].getMessage()
    with pytest.raises(ValueError, match="compute_dtype"):
        tgd._resolve_compute_dtype("int8", cpu)


def test_entry_points_default_to_the_card():
    """With no ``device``, the importer resolves ``config.device`` (the
    card) and raises where no GPU is visible, as every verb does."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device is usable")
    data = _graph(_node_bytes("x", "Placeholder", attrs=[_FLOAT, _SHAPE2]),
                  _node_bytes("y", "Identity", ["x"]))
    with pytest.raises(RuntimeError, match="cuda"):
        tgd.program_from_graphdef(tgd.parse_graphdef(data), fetches=["y"])


def test_weights_move_to_the_device_once():
    """Consts that per-call ops read are on the device at import, in the
    form and dtype each reads (a conv filter as ``[O, I, kh, kw]`` in
    ``channels_last`` memory, in the compute dtype); a call uploads only
    its feeds, and drops each value after its last reader."""
    w = np.random.default_rng(3).standard_normal((3, 3, 2, 4)).astype(np.float32)
    bias = np.float32([0.5, -1.0, 2.0, 0.0])

    def const(name, arr, enum=1):
        t = _vf(1, enum) + _ld(2, b"".join(_ld(2, _vf(1, d)) for d in arr.shape)) + _ld(
            4, arr.tobytes())
        return _node_bytes(name, "Const", attrs=[("dtype", _vf(6, enum)), ("value", _ld(8, t))])

    ints = lambda v: _ld(1, _ld(3, b"".join(_varint(i) for i in v)))  # noqa: E731
    shape = ("shape", _ld(7, b"".join(_ld(2, _vf(1, d & (2**64 - 1))) for d in (-1, 5, 5, 2))))
    data = _graph(
        _node_bytes("x", "Placeholder", attrs=[_FLOAT, shape]), const("w", w), const("b", bias),
        _node_bytes("c", "Conv2D", ["x", "w"], attrs=[("strides", ints([1, 2, 2, 1])),
                                                      ("padding", _ld(2, b"SAME"))]),
        _node_bytes("y", "BiasAdd", ["c", "b"]),
    )
    forms = {}
    real_hoist = tgd._Ctx.hoist

    def hoist(self, v, dtype=None, form=None):
        real_hoist(self, v, dtype, form)
        forms[(dtype, form)] = self._hoisted[(id(v), dtype, form)]

    tgd._Ctx.hoist = hoist
    try:
        prog = tgd.program_from_graphdef(tgd.parse_graphdef(data), fetches=["y"],
                                         compute_dtype="bfloat16", device="cpu")
    finally:
        tgd._Ctx.hoist = real_hoist
    assert set(forms) == {(torch.bfloat16, "conv"), (None, None)}
    filt = forms[(torch.bfloat16, "conv")]
    assert tuple(filt.shape) == (4, 2, 3, 3)
    assert filt.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(filt, torch.from_numpy(w).permute(3, 2, 0, 1).to(torch.bfloat16))
    assert torch.equal(forms[(None, None)], torch.from_numpy(bias))
    calls = []
    real = tgd._np_to_torch
    tgd._np_to_torch = lambda a, device: calls.append(np.shape(a)) or real(a, device)
    try:
        out = _port_fn(prog, {"x": np.ones((2, 5, 5, 2), np.float32)})["y"]
    finally:
        tgd._np_to_torch = real
    assert calls == [] and out.shape == (2, 3, 3, 4)
