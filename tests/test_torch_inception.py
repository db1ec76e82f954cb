"""Parity of the PyTorch port's Inception-v3 with the JAX package.

Weights come from the JAX package's ``init_params`` and cross as numpy
arrays through the port's ``params_from_jax``; images are the packages'
own ``synthetic_images`` (the same numpy draw). ``init_params`` folds an
identity batch-norm (scale 1, bias 0), so each conv's scale and bias are
replaced by seeded draws, as a frozen graph's folded batch-norm gives
them; a forward that dropped or misplaced the affine would otherwise
pass. Tolerances:

* f32 ``tiny``: logits within 1e-4·max|logit|. Both sides compute in f32;
  they differ only in the order of each convolution's f32 sums (XLA's
  against PyTorch's CPU kernels) across ~40 layers in sequence.
* bf16 ``tiny``: within 2e-2·max|logit|. bf16 rounds at other places in
  the two packages: the port's conv returns bf16 before the folded-BN
  affine, while XLA keeps the conv's f32 sum for it.
* batch invariance: a row alone against the same row in a batch, rtol and
  atol 2e-4 (the JAX package's own test's bound).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import tensorframes_tpu as tfs
from tensorframes_tpu.models import inception as jinc
from tensorframes_tpu.ops import quantize as jq
from tensorframes_tpu.ops import windows as jwin

import tensorframes_tpu_torch as tft
from tensorframes_tpu_torch.models import inception as tinc
from tensorframes_tpu_torch.ops import quantize as tq
from tensorframes_tpu_torch.ops import windows as twin

F32_RTOL = 1e-4   # of max |logit|
BF16_RTOL = 2e-2  # of max |logit|


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _jax_logits(cfg, params, images):
    return np.asarray(jax.jit(lambda p, x: jinc.forward(cfg, p, x))(params, images))


def _port_cfg(cfg):
    return tinc.InceptionConfig(**dataclasses.asdict(cfg))


def _random_affine(jparams, seed):
    """``jparams`` with every conv's folded-BN scale drawn from U(0.5, 1.5)
    and bias from N(0, 0.1), in the leaves' dtype."""
    rng = np.random.default_rng(seed)
    out = {"fc": jparams["fc"]}
    for block, convs in jparams.items():
        if block == "fc":
            continue
        out[block] = {}
        for name, p in convs.items():
            c = p["scale"].shape[0]
            out[block][name] = {
                "w": p["w"],
                "scale": jnp.asarray(rng.uniform(0.5, 1.5, c).astype(np.float32), p["scale"].dtype),
                "bias": jnp.asarray((0.1 * rng.standard_normal(c)).astype(np.float32),
                                    p["bias"].dtype),
            }
    return out


def _pair(cfg, seed=0, n=3, image_seed=1):
    jparams = _random_affine(jinc.init_params(cfg, seed=seed), seed + 100)
    tparams = tinc.params_from_jax(_port_cfg(cfg), _np_tree(jparams), device="cpu")
    images = jinc.synthetic_images(cfg, n, seed=image_seed)
    np.testing.assert_array_equal(images, tinc.synthetic_images(cfg, n, seed=image_seed))
    return jparams, tparams, images


def _port_logits(cfg, params, images):
    with torch.inference_mode():
        return tinc.forward(cfg, params, torch.from_numpy(images)).numpy()


def _close(got, want, rtol):
    assert got.shape == want.shape and np.isfinite(got).all()
    scale = float(np.abs(want).max())
    err = float(np.abs(got.astype(np.float64) - want).max())
    assert err <= rtol * scale, (err, rtol * scale)


def test_tiny_forward_matches_jax():
    cfg = jinc.tiny()
    jparams, tparams, images = _pair(cfg)
    want = _jax_logits(cfg, jparams, images)
    got = _port_logits(tinc.tiny(), tparams, images)
    assert got.dtype == np.float32
    _close(got, want, F32_RTOL)


def test_tiny_bf16_forward_within_bf16_tolerance():
    cfg = jinc.tiny(compute_dtype="bfloat16")
    jparams, tparams, images = _pair(cfg, seed=4, image_seed=5)
    assert tparams["mixed_a0"]["b1"]["w"].dtype == torch.bfloat16
    want = _jax_logits(cfg, jparams, images)
    got = _port_logits(tinc.tiny(compute_dtype="bfloat16"), tparams, images)
    _close(got, want, BF16_RTOL)


@pytest.mark.parametrize("dtype,rtol", [("float32", F32_RTOL), ("bfloat16", BF16_RTOL)])
def test_dropped_affine_falls_outside_the_tolerance(dtype, rtol):
    """The control for the two tests above: the same weights with every
    conv's folded-BN bias dropped, or its scale, lie far outside the
    tolerance, so those tests see the affine."""
    cfg = jinc.tiny(compute_dtype=dtype)
    jparams, tparams, images = _pair(cfg, seed=4, image_seed=5)
    want = _jax_logits(cfg, jparams, images)
    tcfg = _port_cfg(cfg)
    _close(_port_logits(tcfg, tparams, images), want, rtol)
    for leaf, value in (("bias", torch.zeros_like), ("scale", torch.ones_like)):
        broken = {block: convs if block == "fc" else
                  {name: {**p, leaf: value(p[leaf])} for name, p in convs.items()}
                  for block, convs in tparams.items()}
        got = _port_logits(tcfg, broken, images)
        err = float(np.abs(got.astype(np.float64) - want).max())
        assert err > 5 * rtol * float(np.abs(want).max()), (leaf, err)


def test_scoring_program_through_map_blocks():
    """Both packages' ``map_blocks`` over two blocks: scores within the f32
    tolerance, labels equal wherever the reference's top-2 margin is
    clear of it."""
    cfg = jinc.tiny()
    jparams, tparams, images = _pair(cfg, seed=1, n=6, image_seed=2)
    jdf = tfs.frame_from_arrays({"images": images}, num_blocks=2)
    jprog = jinc.scoring_program(cfg, jparams)
    jout = tfs.map_blocks(lambda images: jprog(images), jdf)
    tdf = tft.frame_from_arrays({"images": images}, num_blocks=2)
    tout = tft.map_blocks(tinc.scoring_program(tinc.tiny(), tparams), tdf, device="cpu")
    assert str(tout.schema) == str(jout.schema)
    js, ts = jout.column_values("scores"), tout.column_values("scores")
    assert ts.dtype == np.float32 and ts.shape == (6, cfg.num_classes)
    np.testing.assert_allclose(ts.sum(1), 1.0, atol=1e-5)
    _close(ts, js, F32_RTOL)
    logits = _jax_logits(cfg, jparams, images)
    top2 = np.sort(logits, axis=1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 2 * F32_RTOL * np.abs(logits).max()
    assert clear.any()
    jl, tl = jout.column_values("label"), tout.column_values("label")
    assert tl.dtype == np.int32
    np.testing.assert_array_equal(tl[clear], jl[clear])


def test_quantized_tree_matches_jax():
    """Per-output-channel int8 of every conv and per class of the
    classifier: the same int8 values and scales as the reference's (its
    HWIO axis -1 is the port's dim 0), so the dequantized weights are the
    same bits, and the logits agree within the f32 tolerance."""
    cfg = jinc.tiny()
    jparams, tparams, images = _pair(cfg, seed=2, image_seed=3)
    jquant = jinc.quantize_params(jparams)
    tquant = tinc.quantize_params(tparams)
    jw, tw = jquant["mixed_c1"]["bd_2"]["w"], tquant["mixed_c1"]["bd_2"]["w"]
    assert isinstance(tw, tq.QuantizedTensor) and isinstance(jw, jq.QuantizedTensor)
    np.testing.assert_array_equal(tw.q.permute(2, 3, 1, 0).numpy(), np.asarray(jw.q))
    np.testing.assert_array_equal(tw.scale.reshape(-1).numpy(), np.asarray(jw.scale).reshape(-1))
    assert isinstance(tquant["fc"]["w"], tq.QuantizedTensor)
    assert not isinstance(tquant["fc"]["b"], tq.QuantizedTensor)
    assert not isinstance(tquant["stem"]["c1"]["scale"], tq.QuantizedTensor)
    assert tinc.param_count(tquant) == tinc.param_count(tparams) == jinc.param_count(jquant)
    want = _jax_logits(cfg, jquant, images)
    _close(_port_logits(tinc.tiny(), tquant, images), want, F32_RTOL)


def test_batch_invariance():
    cfg = tinc.tiny()
    params = tinc.init_params(cfg, seed=2, device="cpu")
    images = tinc.synthetic_images(cfg, 3, seed=3)
    all_logits = _port_logits(cfg, params, images)
    one = _port_logits(cfg, params, images[1:2])
    np.testing.assert_allclose(all_logits[1:2], one, rtol=2e-4, atol=2e-4)


def test_channel_rounding_and_param_count():
    tiny, full = tinc.tiny(), tinc.inception_v3()
    for c in (32, 48, 64, 80, 96, 128, 160, 192, 320, 384, 448):
        assert tiny.ch(c) == jinc.tiny().ch(c) and tiny.ch(c) % 8 == 0 and tiny.ch(c) >= 8
        assert full.ch(c) == jinc.inception_v3().ch(c) == c
    for cfg, jcfg in ((tiny, jinc.tiny()), (full, jinc.inception_v3())):
        jshapes = jax.eval_shape(lambda: jinc.init_params(jcfg, seed=0))
        want = sum(int(np.prod(leaf.shape)) for leaf in jax.tree_util.tree_leaves(jshapes))
        params = tinc.init_params(cfg, seed=0, device="cpu")
        assert tinc.param_count(params) == want
        got = jax.tree_util.tree_map(lambda s: tuple(s.shape), jshapes)
        for block, convs in tinc.conv_shapes(cfg).items():
            for name, shape in convs.items():
                assert got[block][name]["w"] == shape
                w = params[block][name]["w"]
                assert tuple(w.shape) == (shape[3], shape[2], shape[0], shape[1])
                assert w.is_contiguous(memory_format=torch.channels_last)
    assert tinc.param_count(tinc.init_params(full, device="cpu")) > 20_000_000


def test_avgpool_divides_by_same_pool_counts():
    """The 3x3 SAME pool divides each window's f32 sum by the pixels it
    covers: ``same_pool_counts`` (the port's copy equals the reference's),
    to within one f32 rounding of the division."""
    for h, w in ((35, 35), (17, 17), (8, 8), (5, 9)):
        np.testing.assert_array_equal(twin.same_pool_counts(h, w, 3, 3),
                                      jwin.same_pool_counts(h, w, 3, 3))
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 7, 5)).astype(np.float32)  # NHWC
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = tinc._avgpool3(xt).permute(0, 2, 3, 1).numpy()
    padded = np.pad(x.astype(np.float64), ((0, 0), (1, 1), (1, 1), (0, 0)))
    sums = sum(padded[:, i:i + 9, j:j + 7] for i in range(3) for j in range(3))
    want = sums / twin.same_pool_counts(9, 7, 3, 3)
    np.testing.assert_allclose(got, want, rtol=2e-7, atol=1e-7)
    jgot = np.asarray(jinc._avgpool3(jnp.asarray(x)))
    np.testing.assert_allclose(got, jgot, rtol=2e-7, atol=1e-7)


def test_same_padding_rule_and_bad_params():
    cfg = tinc.tiny()
    params = tinc.init_params(cfg, device="cpu")
    x = torch.zeros(1, cfg.ch(32), 9, 9)
    with pytest.raises(ValueError, match="SAME padding needs stride 1"):
        tinc._conv2d(params["stem"]["c2"], x, stride=2)
    jparams = _np_tree(jinc.init_params(jinc.tiny(), seed=0))
    jparams["mixed_b"]["b3"]["w"] = jparams["mixed_b"]["b3"]["w"][:, :, :, :-8]
    with pytest.raises(ValueError, match="mixed_b/b3"):
        tinc.params_from_jax(cfg, jparams, device="cpu")
    del jparams["mixed_b"]
    with pytest.raises(ValueError, match="inception params need keys"):
        tinc.params_from_jax(cfg, jparams, device="cpu")


def test_entry_points_need_a_gpu_or_the_cpu_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tinc.tiny()
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        tinc.init_params(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tinc.params_from_jax(cfg, _np_tree(jinc.init_params(jinc.tiny())))
    params = tinc.init_params(cfg, device="cpu")
    df = tft.frame_from_arrays({"images": tinc.synthetic_images(cfg, 2)})
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        tft.map_blocks(tinc.scoring_program(cfg, params), df)
    out = tft.map_blocks(tinc.scoring_program(cfg, params), df, device="cpu")
    assert out.column_values("label").shape == (2,)
