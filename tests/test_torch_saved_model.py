"""SavedModels and serialized programs in the PyTorch port, against the
JAX package.

* ``load_saved_model``: a keras SavedModel whose variables the clean-room
  bundle reader restores (no TF at import), the serving meta graph picked
  among several (wire bytes, no TF), an unknown signature, and
  ``quantize_weights=True``, which freezes through TF in both packages.
  Tolerances: ``ATOL_JAX`` 1e-5 between the packages, ``ATOL_TF`` 1e-4
  against the live keras model (``tests/test_graphdef_frozen.py``'s).
* ``bundle``: a truncated index raises ``BundleError`` in both.
* ``save_program``/``load_program``: ``torch.export`` artifacts whose
  Unknown dims stay symbolic; an imported conv/pool/dense graph and VGG
  ``tiny``'s scoring program round-trip at batches 3 and 7 with the same
  bits, an int8 import too (its ``tftpu::int8_matmul`` call resolves
  after loading), and a program that reads its batch size into a Python
  int is refused, naming the dim.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import tensorframes_tpu as tfs
from tensorframes_tpu import bundle as jbundle
from tensorframes_tpu import graphdef as jgd

import tensorframes_tpu_torch as tft
from tensorframes_tpu_torch import bundle as tbundle
from tensorframes_tpu_torch import dtypes as tdt
from tensorframes_tpu_torch import graphdef as tgd
from tensorframes_tpu_torch.models import vgg as tvgg
from tensorframes_tpu_torch.program import TensorSpec, analyze_program, program_from_function
from tensorframes_tpu_torch.shape import Shape, Unknown

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import ld as _ld, node_bytes as _node_bytes, vf as _vf  # noqa: E402

ATOL_JAX = 1e-5
ATOL_TF = 1e-4


@pytest.fixture(scope="module")
def tf():
    return pytest.importorskip("tensorflow")


def _port_fn(prog, feeds):
    with torch.inference_mode():
        out = prog.fn({k: torch.from_numpy(v) for k, v in feeds.items()})
    return {k: v.numpy() for k, v in out.items()}


def _keras_saved_model(tf, path, seed):
    tf.keras.utils.set_random_seed(seed)
    model = tf.keras.Sequential([
        tf.keras.layers.Input((6,)),
        tf.keras.layers.Dense(4, activation="relu"),
        tf.keras.layers.Dense(2),
    ])
    tf.saved_model.save(model, str(path))
    return model


def test_keras_saved_model_matches_reference(tf, tmp_path):
    """Variables restored by each package's clean-room bundle reader; the
    signature's input and output names; the same values."""
    model = _keras_saved_model(tf, tmp_path / "sm", 7)
    x = np.random.default_rng(8).standard_normal((5, 6)).astype(np.float32)
    want = model(x, training=False).numpy()
    jprog = tfs.load_saved_model(str(tmp_path / "sm"), relax_lead_dim=True, compute_dtype=None)
    [inp] = jprog.inputs
    ref = np.asarray(jprog.fn({inp.name: x})[jprog.fetch_order[0]])
    np.testing.assert_allclose(ref, want, atol=ATOL_TF)
    tprog = tft.load_saved_model(str(tmp_path / "sm"), relax_lead_dim=True, device="cpu")
    assert tprog.input_names == jprog.input_names and tprog.fetch_order == jprog.fetch_order
    got = _port_fn(tprog, {inp.name: x})[tprog.fetch_order[0]]
    np.testing.assert_allclose(got, ref, atol=ATOL_JAX, rtol=0)
    for pkg in (tfs, tft):
        with pytest.raises(KeyError, match="serving_default|available"):
            pkg.load_saved_model(str(tmp_path / "sm"), signature="nope",
                                 **({"device": "cpu"} if pkg is tft else {}))


def test_bundle_restores_the_same_variables(tf, tmp_path):
    _keras_saved_model(tf, tmp_path / "sm", 9)
    ref = jbundle.restore_variables(str(tmp_path / "sm" / "variables"))
    got = tbundle.restore_variables(str(tmp_path / "sm" / "variables"))
    assert sorted(got) == sorted(ref) and ref
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])


def test_quantize_weights_saved_model_freezes_through_tf(tf, tmp_path):
    """``quantize_weights=True`` routes through TF freezing in both
    packages (the weight planner needs an inlined graph)."""
    model = _keras_saved_model(tf, tmp_path / "sm", 10)
    x = np.random.default_rng(11).standard_normal((4, 6)).astype(np.float32)
    jprog = tfs.load_saved_model(str(tmp_path / "sm"), relax_lead_dim=True,
                                 quantize_weights=True, compute_dtype=None)
    ref = np.asarray(jprog.fn({jprog.inputs[0].name: x})[jprog.fetch_order[0]])
    np.testing.assert_allclose(ref, model(x, training=False).numpy(), atol=0.05, rtol=0.1)
    tprog = tft.load_saved_model(str(tmp_path / "sm"), relax_lead_dim=True,
                                 quantize_weights=True, device="cpu")
    got = _port_fn(tprog, {tprog.inputs[0].name: x})[tprog.fetch_order[0]]
    np.testing.assert_allclose(got, ref, atol=ATOL_JAX, rtol=0)


# ---------------------------------------------------------------------------
# wire bytes: no TF
# ---------------------------------------------------------------------------

def _tiny_graphdef_bytes():
    """x = Placeholder(float, [2]); y = Identity(x)."""
    dtype_attr = _vf(6, 1)
    shape_attr = _ld(7, _ld(2, _vf(1, 2)))
    x = _node_bytes("x", "Placeholder", attrs=[("dtype", dtype_attr), ("shape", shape_attr)])
    y = _node_bytes("y", "Identity", inputs=["x"], attrs=[("T", dtype_attr)])
    return _ld(1, x) + _ld(1, y)


def _signature_entry(key, inputs, outputs):
    sig = b""
    for arg, ref in inputs.items():
        sig += _ld(1, _ld(1, arg.encode()) + _ld(2, _ld(1, ref.encode())))
    for arg, ref in outputs.items():
        sig += _ld(2, _ld(1, arg.encode()) + _ld(2, _ld(1, ref.encode())))
    return _ld(5, _ld(1, key.encode()) + _ld(2, sig))


def _meta_graph_bytes(tags, graphdef, sig_entries):
    info = b"".join(_ld(4, t.encode()) for t in tags)
    return _ld(1, info) + _ld(2, graphdef) + sig_entries


def test_saved_model_several_meta_graphs_like_reference(tmp_path):
    """The signature is served from whichever meta graph holds it (train
    first, serve second); an absent one lists every meta graph's."""
    gd = _tiny_graphdef_bytes()
    sm = (_ld(2, _meta_graph_bytes(["train"], gd, _signature_entry(
        "train_step", {"inp": "x:0"}, {"out": "y:0"})))
        + _ld(2, _meta_graph_bytes(["serve"], gd, _signature_entry(
            "serving_default", {"inp": "x:0"}, {"out": "y:0"}))))
    for gdm in (jgd, tgd):
        metas = gdm.parse_saved_model_meta_graphs(sm)
        assert [tags for _, _, tags in metas] == [["train"], ["serve"]]
        assert "serving_default" in gdm.parse_saved_model(sm)[1]
    sm_dir = tmp_path / "sm"
    sm_dir.mkdir()
    (sm_dir / "saved_model.pb").write_bytes(sm)
    xv = np.asarray([1.5, -2.0], np.float32)
    for signature in ("serving_default", "train_step"):
        ref = tfs.load_saved_model(str(sm_dir), signature=signature)
        np.testing.assert_array_equal(np.asarray(ref.fn({"x": xv})["out"]), xv)
        got = tft.load_saved_model(str(sm_dir), signature=signature, device="cpu")
        assert got.input_names == ref.input_names
        np.testing.assert_array_equal(_port_fn(got, {"x": xv})["out"], xv)
    msgs = []
    for pkg in (tfs, tft):
        with pytest.raises(KeyError) as info:
            pkg.load_saved_model(str(sm_dir), signature="nope",
                                 **({"device": "cpu"} if pkg is tft else {}))
        msgs.append(str(info.value))
    assert "2 meta graph" in msgs[0] and msgs[1] == msgs[0]
    for gdm in (jgd, tgd):
        with pytest.raises(ValueError, match="SavedModel"):
            gdm.parse_saved_model(b"\x12\xff\xff")


def test_bundle_truncated_index_raises_like_reference():
    data = bytes(16)
    for mod in (jbundle, tbundle):
        for off, size in ((8, 8), (8, 12)):
            with pytest.raises(mod.BundleError) as info:
                mod._parse_table_block(data, off, size)
            assert "past end of file" in str(info.value)


# ---------------------------------------------------------------------------
# save_program / load_program
# ---------------------------------------------------------------------------

def _conv_pool_dense(tf, seed):
    from tensorflow.python.framework.convert_to_constants import (
        convert_variables_to_constants_v2,
    )

    tf.keras.utils.set_random_seed(seed)
    model = tf.keras.Sequential([
        tf.keras.layers.Input((10, 10, 3)),
        tf.keras.layers.Conv2D(6, 3, strides=2, padding="same", activation="relu"),
        tf.keras.layers.GlobalAveragePooling2D(),
        tf.keras.layers.Dense(4),
    ])
    cf = tf.function(lambda x: model(x, training=False)).get_concrete_function(
        tf.TensorSpec([None, 10, 10, 3], tf.float32))
    return convert_variables_to_constants_v2(cf).graph.as_graph_def().SerializeToString()


@pytest.mark.parametrize("quantize", [False, True])
def test_imported_graph_round_trips(tf, tmp_path, quantize):
    """A frozen conv / global pool / dense graph: imported, saved, loaded;
    the loaded program returns the saved one's bits at batches 3 and 7
    (the batch dim stays symbolic), and the saved one matches the
    reference's import of the same bytes."""
    data = _conv_pool_dense(tf, 13)
    path = tmp_path / "m.pb"
    path.write_bytes(data)
    prog = tft.load_graphdef(str(path), relax_lead_dim=True, quantize_weights=quantize,
                             device="cpu")
    ref_prog = tfs.load_graphdef(str(path), relax_lead_dim=True, quantize_weights=quantize,
                                 compute_dtype=None)
    art = str(tmp_path / "m.pt2")
    tft.save_program(prog, art, device="cpu")
    back = tft.load_program(art)
    assert back.input_names == prog.input_names and back.fetch_order == prog.fetch_order
    [inp] = prog.inputs
    fetch = prog.fetch_order[0]
    rng = np.random.default_rng(14)
    for n in (3, 7):
        x = rng.standard_normal((n, 10, 10, 3)).astype(np.float32)
        want = _port_fn(prog, {inp.name: x})[fetch]
        np.testing.assert_array_equal(_port_fn(back, {inp.name: x})[fetch], want)
        ref = np.asarray(ref_prog.fn({inp.name: x})[fetch])
        np.testing.assert_allclose(want, ref, atol=ATOL_JAX, rtol=0)


def test_vgg_scoring_program_round_trips(tmp_path):
    cfg = tvgg.tiny()
    params = tvgg.init_params(cfg, seed=1, device="cpu")
    spec = TensorSpec("images", tdt.float32, Shape((Unknown, 32, 32, 3)))
    prog = analyze_program(program_from_function(
        tvgg.scoring_program(cfg, params, top_k=3), {"images": spec}))
    art = str(tmp_path / "vgg.pt2")
    tft.save_program(prog, art, device="cpu")
    back = tft.load_program(art)
    for n in (3, 7):
        x = tvgg.synthetic_images(cfg, n, seed=n)
        want, got = _port_fn(prog, {"images": x}), _port_fn(back, {"images": x})
        assert sorted(got) == ["scores", "top_idx", "top_val"]
        for k in want:
            assert got[k].shape[0] == n
            np.testing.assert_array_equal(got[k], want[k])


def test_save_program_refuses_a_pinned_batch_dim(tmp_path):
    """Host shape arithmetic that reads the batch size into a Python int
    would fix the artifact at the example's size: refused, naming the
    dim."""
    def fn(x):
        return {"y": x.reshape(int(x.shape[0]) * 2, -1)}

    spec = TensorSpec("x", tdt.float32, Shape((Unknown, 4)))
    prog = analyze_program(program_from_function(fn, {"x": spec}))
    with pytest.raises(ValueError, match="b0"):
        tft.save_program(prog, str(tmp_path / "bad.pt2"), device="cpu")
    assert not (tmp_path / "bad.pt2").exists()
