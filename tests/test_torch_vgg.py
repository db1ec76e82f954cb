"""Parity of the PyTorch port's VGG-16 (``tensorframes_tpu_torch.models.vgg``)
with the JAX package's.

Weights are drawn with numpy at the shapes of the JAX package's
``init_params`` (read with ``jax.eval_shape``: its eager ``jax.random``
draw takes seconds a layer on the CPU), biases at random too (zeros would
hide a dropped or misplaced bias); they cross as numpy arrays through the
port's ``params_from_jax``. Images are the packages' own
``synthetic_images`` (the same numpy draw). Tolerances:

* f32 ``tiny``: logits within ``F32_RTOL`` = 1e-4 of max |logit|; both
  sides compute in f32 and differ in the order of each convolution's and
  matmul's f32 sums (XLA's against PyTorch's CPU kernels).
* bf16 ``tiny``: within ``BF16_RTOL`` = 2e-2 of max |logit|: bf16 rounds at
  other places in the two packages (the port's conv returns bf16 before
  the f32 bias, where XLA keeps the f32 sum).
* int8 weights: the same quantized values on both sides (``torch.round``
  and ``jnp.round`` both round half to even), then ``F32_RTOL``.
"""

import numpy as np
import pytest
import torch

import jax

import tensorframes_tpu as tfs
from tensorframes_tpu.models import vgg as jvgg
from tensorframes_tpu.ops import quantize as jq

import tensorframes_tpu_torch as tft
from tensorframes_tpu_torch.models import vgg as tvgg
from tensorframes_tpu_torch.ops import quantize as tq

F32_RTOL = 1e-4   # of max |logit|
BF16_RTOL = 2e-2  # of max |logit|


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _random_params(cfg, seed):
    """The reference's tree at its shapes and dtypes: He-normal weights
    (its scale), biases N(0, 0.1)."""
    shapes = jax.eval_shape(lambda: jvgg.init_params(cfg, seed=0))
    rng = np.random.default_rng(seed)

    def draw(p):
        w = rng.standard_normal(p["w"].shape).astype(np.float32)
        w *= np.sqrt(2.0 / np.prod(p["w"].shape[:-1]))
        b = (0.1 * rng.standard_normal(p["b"].shape)).astype(np.float32)
        return {"w": jax.numpy.asarray(w, p["w"].dtype), "b": jax.numpy.asarray(b, p["b"].dtype)}

    return {k: draw(p) for k, p in shapes.items()}


def _port_cfg(cfg):
    return tvgg.VGGConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})


def _pair(cfg, seed=0, n=3):
    jparams = _random_params(cfg, seed + 100)
    tparams = tvgg.params_from_jax(_port_cfg(cfg), _np_tree(jparams), device="cpu")
    images = jvgg.synthetic_images(cfg, n, seed=seed + 1)
    np.testing.assert_array_equal(images, tvgg.synthetic_images(cfg, n, seed=seed + 1))
    return jparams, tparams, images


def _jax_logits(cfg, params, images):
    return np.asarray(jax.jit(lambda p, x: jvgg.forward(cfg, p, x))(params, images))


def _port_logits(cfg, params, images):
    with torch.inference_mode():
        return tvgg.forward(_port_cfg(cfg), params, torch.from_numpy(images)).numpy()


def _within(got, ref, rtol):
    bound = rtol * np.abs(ref).max()
    diff = np.abs(got - ref).max()
    assert diff <= bound, f"max |diff| {diff} > {bound}"


def test_tiny_f32_forward_matches_reference():
    cfg = jvgg.tiny()
    jparams, tparams, images = _pair(cfg)
    ref = _jax_logits(cfg, jparams, images)
    assert ref.shape == (3, cfg.num_classes) and np.isfinite(ref).all()
    got = _port_logits(cfg, tparams, images)
    assert got.dtype == np.float32
    _within(got, ref, F32_RTOL)
    # a dropped last-conv bias lies far outside the tolerance
    dropped = {**tparams, "conv5_3": {**tparams["conv5_3"],
                                      "b": torch.zeros_like(tparams["conv5_3"]["b"])}}
    assert np.abs(_port_logits(cfg, dropped, images) - ref).max() > 10 * F32_RTOL * np.abs(
        ref).max()


def test_tiny_bf16_forward_matches_reference():
    cfg = jvgg.tiny(compute_dtype="bfloat16")
    f32 = jvgg.tiny()
    jparams32, tparams32, images = _pair(f32, seed=4)
    exact = _jax_logits(f32, jparams32, images)
    jparams = jax.tree_util.tree_map(lambda a: a.astype(jax.numpy.bfloat16), jparams32)
    ref = _jax_logits(cfg, jparams, images)
    _within(ref, exact, BF16_RTOL)  # the reference's own bf16 leg first
    tparams = tvgg.params_from_jax(_port_cfg(cfg), _np_tree(jparams32), device="cpu")
    got = _port_logits(cfg, tparams, images)
    _within(got, ref, BF16_RTOL)
    _within(got, exact, BF16_RTOL)


def test_scoring_through_both_packages_map_blocks():
    """``scoring_program`` through each package's ``map_blocks`` over the
    same 6-image frame in 2 blocks: scores within F32_RTOL, the same top-k
    where the reference's values are apart, top-k values sorted and
    equal to the scores at their indices."""
    cfg = jvgg.tiny()
    jparams, tparams, _ = _pair(cfg, seed=2)
    images = jvgg.synthetic_images(cfg, 6, seed=7)
    jout = tfs.map_blocks(lambda images: jvgg.scoring_program(cfg, jparams, top_k=3)(images),
                          tfs.frame_from_arrays({"images": images}, num_blocks=2))
    tout = tft.map_blocks(tvgg.scoring_program(_port_cfg(cfg), tparams, top_k=3),
                          tft.frame_from_arrays({"images": images}, num_blocks=2),
                          device="cpu")
    js, ts = jout.column_values("scores"), tout.column_values("scores")
    np.testing.assert_allclose(js.sum(1), 1.0, atol=1e-5)
    _within(ts, js, F32_RTOL)
    ti, tv = tout.column_values("top_idx"), tout.column_values("top_val")
    assert ti.dtype == np.int32 and ti.shape == (6, 3)
    np.testing.assert_array_equal(tv, -np.sort(-ts, axis=1)[:, :3])
    np.testing.assert_array_equal(np.take_along_axis(ts, ti.astype(np.int64), 1), tv)
    jv = jout.column_values("top_val")
    apart = np.diff(jv, axis=1).min(axis=1) < -1e-3
    np.testing.assert_array_equal(ti[apart], jout.column_values("top_idx")[apart])


def test_quantized_weights_match_reference():
    """``quantize_params``: the same int8 values and scales as the JAX
    package's (conv HWIO axis -1 ≙ the port's dim 0; fc per column), and
    logits within F32_RTOL; on a CPU tensor the fc layers take
    ``ops.quantize.matmul``'s structural path."""
    cfg = jvgg.tiny()
    jparams, tparams, images = _pair(cfg, seed=5)
    jqp, tqp = jvgg.quantize_params(jparams), tvgg.quantize_params(tparams)
    for name in ("conv1_1", "conv4_2", "fc6", "fc8"):
        jw, tw = jqp[name]["w"], tqp[name]["w"]
        assert isinstance(tw, tq.QuantizedTensor) and isinstance(jw, jq.QuantizedTensor)
        jqv, jsc = np.asarray(jw.q), np.asarray(jw.scale)
        if name.startswith("conv"):  # HWIO → [cout, cin, kh, kw]
            jqv, jsc = jqv.transpose(3, 2, 0, 1), jsc.transpose(3, 2, 0, 1)
        np.testing.assert_array_equal(tw.q.numpy(), jqv)
        np.testing.assert_array_equal(tw.scale.numpy(), jsc)
    assert tvgg.param_count(tqp) == jvgg.param_count(jqp) == tvgg.param_count(tparams)
    _within(_port_logits(cfg, tqp, images), _jax_logits(cfg, jqp, images), F32_RTOL)


def test_preprocess_matches_reference():
    rng = np.random.default_rng(0)
    images = rng.uniform(0, 255, (2, 40, 48, 3)).astype(np.float32)
    ref = np.asarray(jvgg.preprocess(images, 32))
    got = tvgg.preprocess(torch.from_numpy(images), 32).numpy()
    np.testing.assert_array_equal(got, ref)
    for pkg in (jvgg, tvgg):
        with pytest.raises(ValueError, match="smaller than crop"):
            pkg.preprocess(images if pkg is jvgg else torch.from_numpy(images), 64)


def test_config_naming_and_count_match_reference():
    for jcfg in (jvgg.tiny(), jvgg.vgg_16()):
        tcfg = _port_cfg(jcfg)
        assert [tcfg.ch(c) for c in (64, 128, 256, 512)] == [jcfg.ch(c) for c in (64, 128, 256, 512)]
        assert tcfg.fc == jcfg.fc
    cfg = jvgg.tiny()
    jparams = jax.eval_shape(lambda: jvgg.init_params(cfg, seed=0))
    tparams = tvgg.init_params(_port_cfg(cfg), seed=0, device="cpu")
    assert sorted(tparams) == sorted(jparams)
    assert tvgg.param_count(tparams) == jvgg.param_count(jparams)
    assert tparams["conv1_1"]["w"].is_contiguous(memory_format=torch.channels_last)
    full = tvgg.vgg_16()
    assert full.ch(512) == 512 and full.fc == 4096 and full.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="vgg params need keys"):
        tvgg.params_from_jax(_port_cfg(cfg), {"fc6": jparams["fc6"]}, device="cpu")


def test_batch_invariance():
    cfg = jvgg.tiny()
    _, tparams, images = _pair(cfg, seed=6)
    all_logits = _port_logits(cfg, tparams, images)
    one = _port_logits(cfg, tparams, images[1:2])
    np.testing.assert_allclose(all_logits[1:2], one, rtol=2e-4, atol=2e-4)


def test_int8_fc_layers_take_the_kernel_builds_by_rule():
    """``int8_matmul_build``'s rule on VGG-16's fc layers in bf16: fc6
    (25,088 → 4,096) and fc7 (4,096 → 4,096) the tensor-core build, fc8
    (4,096 → 1,000: n not a multiple of 16) the scalar build."""
    cfg = tvgg.vgg_16()
    want = {"fc6": "mma", "fc7": "mma", "fc8": "scalar"}
    for name, (cin, cout) in tvgg._shapes(cfg).items():
        if name in want:
            x = torch.empty((4, cin), dtype=torch.bfloat16)
            q = torch.empty((cin, cout), dtype=torch.int8)
            assert tq.int8_matmul_build(x, q) == want[name], name
