"""Inception-v3 image classification (batch-inference workload).

BASELINE config 4: "Inception-v3 frozen GraphDef batch inference over
image-bytes DataFrame"; the counterpart of
``tensorframes_tpu/models/inception.py``. The architecture follows the
Inception-v3 paper (Szegedy et al. 2015): stem, 3 x block A (35x35),
grid reduction B, 4 x block C (17x17, factorized 7x1/1x7), grid
reduction D, 2 x block E (8x8), global average pool, dense classifier.
``channel_scale`` shrinks widths for tests; :func:`tiny` runs on 75x75
inputs in seconds on a CPU.

Layout. The public functions take NHWC images ``[n, H, W, 3]``, as the
JAX package does. Inside, activations are logical NCHW tensors in
``torch.channels_last`` memory, which is NHWC in memory: the input's
``permute`` is free, and cuDNN runs its NHWC kernels without transposes.
Conv weights are stored ``[cout, cin, kh, kw]`` in ``channels_last``
memory; :func:`params_from_jax` converts the JAX package's HWIO weights.

Numbers. Each conv runs in the compute dtype (``torch.nn.functional.conv2d``;
cuDNN on a GPU, with f32 accumulation in bf16), then the folded-BN affine
in f32, ReLU and a cast back, as the reference's ``_conv2d``. The bf16
conv returns bf16 before the affine, where XLA keeps f32: bf16 results
round at other places than the JAX package's. Convolutions and pools have
no Pallas kernel in the reference (XLA computed them), so they run through
PyTorch's operators here.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import resolve_device
from ..ops.quantize import QuantizedTensor, asarray, quantize_tree, tree_leaves

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class InceptionConfig:
    num_classes: int = 1000
    image_size: int = 299
    channel_scale: float = 1.0
    compute_dtype: str = "bfloat16"  # activations/weights; accum is f32

    def ch(self, c: int) -> int:
        """Scaled channel count, rounded to a multiple of 8 (at least 8),
        as the reference rounds it."""
        return max(8, int(round(c * self.channel_scale / 8.0)) * 8)

    @property
    def dtype(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]


def inception_v3(**kw) -> InceptionConfig:
    return InceptionConfig(**kw)


def tiny(**kw) -> InceptionConfig:
    kw.setdefault("num_classes", 10)
    kw.setdefault("image_size", 75)
    kw.setdefault("channel_scale", 0.125)
    kw.setdefault("compute_dtype", "float32")
    return InceptionConfig(**kw)


# ---------------------------------------------------------------------------
# Parameter layout and init
# ---------------------------------------------------------------------------

ConvShape = Tuple[int, int, int, int]  # (kh, kw, cin, cout), the reference's HWIO order


def conv_shapes(cfg: InceptionConfig) -> Dict[str, Dict[str, ConvShape]]:
    """Every conv of the network, ``{block: {conv: (kh, kw, cin, cout)}}``,
    in the reference's order (its ``init_params`` draws them in this
    order); the classifier is ``fc`` (``w [features, classes]``, ``b``)."""
    c = cfg.ch
    p: Dict[str, Dict[str, ConvShape]] = {}
    p["stem"] = {
        "c1": (3, 3, 3, c(32)),        # /2
        "c2": (3, 3, c(32), c(32)),
        "c3": (3, 3, c(32), c(64)),    # SAME
        "c4": (1, 1, c(64), c(80)),
        "c5": (3, 3, c(80), c(192)),
    }
    cur = c(192)
    for i, pool_ch in enumerate([32, 64, 64]):
        p[f"mixed_a{i}"] = {
            "b1": (1, 1, cur, c(64)),
            "b5_1": (1, 1, cur, c(48)),
            "b5_2": (5, 5, c(48), c(64)),
            "b3_1": (1, 1, cur, c(64)),
            "b3_2": (3, 3, c(64), c(96)),
            "b3_3": (3, 3, c(96), c(96)),
            "bp": (1, 1, cur, c(pool_ch)),
        }
        cur = c(64) + c(64) + c(96) + c(pool_ch)
    p["mixed_b"] = {
        "b3": (3, 3, cur, c(384)),          # /2 VALID
        "bd_1": (1, 1, cur, c(64)),
        "bd_2": (3, 3, c(64), c(96)),
        "bd_3": (3, 3, c(96), c(96)),       # /2 VALID
    }
    cur = c(384) + c(96) + cur
    for i, c7 in enumerate([128, 160, 160, 192]):
        p[f"mixed_c{i}"] = {
            "b1": (1, 1, cur, c(192)),
            "b7_1": (1, 1, cur, c(c7)),
            "b7_2": (1, 7, c(c7), c(c7)),
            "b7_3": (7, 1, c(c7), c(192)),
            "bd_1": (1, 1, cur, c(c7)),
            "bd_2": (7, 1, c(c7), c(c7)),
            "bd_3": (1, 7, c(c7), c(c7)),
            "bd_4": (7, 1, c(c7), c(c7)),
            "bd_5": (1, 7, c(c7), c(192)),
            "bp": (1, 1, cur, c(192)),
        }
        cur = 4 * c(192)
    p["mixed_d"] = {
        "b3_1": (1, 1, cur, c(192)),
        "b3_2": (3, 3, c(192), c(320)),     # /2 VALID
        "b7_1": (1, 1, cur, c(192)),
        "b7_2": (1, 7, c(192), c(192)),
        "b7_3": (7, 1, c(192), c(192)),
        "b7_4": (3, 3, c(192), c(192)),     # /2 VALID
    }
    cur = c(320) + c(192) + cur
    for i in range(2):
        p[f"mixed_e{i}"] = {
            "b1": (1, 1, cur, c(320)),
            "b3_1": (1, 1, cur, c(384)),
            "b3_2a": (1, 3, c(384), c(384)),
            "b3_2b": (3, 1, c(384), c(384)),
            "bd_1": (1, 1, cur, c(448)),
            "bd_2": (3, 3, c(448), c(384)),
            "bd_3a": (1, 3, c(384), c(384)),
            "bd_3b": (3, 1, c(384), c(384)),
            "bp": (1, 1, cur, c(192)),
        }
        cur = c(320) + 2 * c(384) + 2 * c(384) + c(192)
    return p


def _features(cfg: InceptionConfig) -> int:
    return cfg.ch(320) + 4 * cfg.ch(384) + cfg.ch(192)


def _conv_weight(hwio: np.ndarray, dtype, device) -> torch.Tensor:
    """An HWIO weight as the port's ``[cout, cin, kh, kw]`` in
    ``channels_last`` memory (cout, kh, kw, cin in memory)."""
    ohwi = np.array(np.transpose(hwio, (3, 0, 1, 2)), order="C")
    return torch.from_numpy(ohwi).to(device=device, dtype=dtype).permute(0, 3, 1, 2)


def init_params(cfg: InceptionConfig, seed: int = 0, device=None) -> Dict:
    """Random weights from a numpy ``Generator`` seeded with ``seed``, on
    ``device`` (default ``config.device``): He-normal convs, the folded BN
    as the identity affine (scale 1, bias 0), a classifier of std 0.01,
    the reference's tree and shapes. The numbers differ from the
    reference's ``jax.random`` draw; carry its weights across with
    :func:`params_from_jax` to score identically."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    dt = cfg.dtype
    params: Dict = {}
    for block, convs in conv_shapes(cfg).items():
        params[block] = {}
        for name, (kh, kw, cin, cout) in convs.items():
            w = rng.standard_normal((kh, kw, cin, cout), dtype=np.float32)
            w *= np.float32(np.sqrt(2.0 / (kh * kw * cin)))
            params[block][name] = {
                "w": _conv_weight(w, dt, device),
                "scale": torch.ones(cout, dtype=dt, device=device),
                "bias": torch.zeros(cout, dtype=dt, device=device),
            }
    fc = rng.standard_normal((_features(cfg), cfg.num_classes), dtype=np.float32) * np.float32(0.01)
    params["fc"] = {
        "w": torch.from_numpy(fc).to(device=device, dtype=dt),
        "b": torch.zeros(cfg.num_classes, dtype=dt, device=device),
    }
    return params


def params_from_jax(cfg: InceptionConfig, params: Dict, device=None) -> Dict:
    """The reference package's Inception parameters (numpy arrays: HWIO
    conv weights, ``[cout]`` scale and bias, ``fc`` ``w [features,
    classes]`` and ``b``) as the port's, on ``device`` (default
    ``config.device``), in the config's compute dtype. Raises on a
    missing or extra key and on a shape that is not the config's."""
    device = resolve_device(device)
    dt = cfg.dtype
    shapes = conv_shapes(cfg)
    if set(params) != set(shapes) | {"fc"}:
        raise ValueError(f"inception params need keys {sorted(set(shapes) | {'fc'})}, "
                         f"got {sorted(params)}")
    out: Dict = {}
    for block, convs in shapes.items():
        if set(params[block]) != set(convs):
            raise ValueError(f"inception block {block!r} needs convs {sorted(convs)}, "
                             f"got {sorted(params[block])}")
        out[block] = {}
        for name, shape in convs.items():
            p = params[block][name]
            w = np.array(p["w"], np.float32)
            scale, bias = np.array(p["scale"], np.float32), np.array(p["bias"], np.float32)
            if w.shape != shape or scale.shape != (shape[3],) or bias.shape != (shape[3],):
                raise ValueError(f"inception {block}/{name}: w {w.shape}, scale {scale.shape}, "
                                 f"bias {bias.shape}; expected w {shape} and [{shape[3]}]")
            out[block][name] = {
                "w": _conv_weight(w, dt, device),
                "scale": torch.from_numpy(scale).to(device=device, dtype=dt),
                "bias": torch.from_numpy(bias).to(device=device, dtype=dt),
            }
    w, b = np.array(params["fc"]["w"], np.float32), np.array(params["fc"]["b"], np.float32)
    if w.shape != (_features(cfg), cfg.num_classes) or b.shape != (cfg.num_classes,):
        raise ValueError(f"inception fc: w {w.shape}, b {b.shape}; expected "
                         f"{(_features(cfg), cfg.num_classes)} and [{cfg.num_classes}]")
    out["fc"] = {"w": torch.from_numpy(w).to(device=device, dtype=dt),
                 "b": torch.from_numpy(b).to(device=device, dtype=dt)}
    return out


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _conv2d(p, x: torch.Tensor, stride: int = 1, padding: str = "SAME") -> torch.Tensor:
    """conv + folded-BN affine (f32) + relu, cast back to ``x``'s dtype.
    SAME appears only at stride 1 with odd kernels, where it is the
    symmetric padding k // 2; stride-2 convs are VALID."""
    w = asarray(p["w"], x.dtype)
    kh, kw = int(w.shape[2]), int(w.shape[3])
    if padding == "SAME":
        if stride != 1 or kh % 2 == 0 or kw % 2 == 0:
            raise ValueError(f"SAME padding needs stride 1 and odd kernels, got stride "
                             f"{stride} and {kh}x{kw}")
        pad = (kh // 2, kw // 2)
    elif padding == "VALID":
        pad = (0, 0)
    else:
        raise ValueError(f"padding must be SAME or VALID, got {padding!r}")
    y = F.conv2d(x, w, stride=stride, padding=pad)
    scale = p["scale"].float().view(1, -1, 1, 1)
    bias = p["bias"].float().view(1, -1, 1, 1)
    y = torch.addcmul(bias, y, scale)  # f32 by type promotion, one pass
    return torch.relu_(y).to(x.dtype)


def _maxpool(x: torch.Tensor, window: int = 3, stride: int = 2) -> torch.Tensor:
    """VALID max pool."""
    return F.max_pool2d(x, window, stride)


def _avgpool3(x: torch.Tensor) -> torch.Tensor:
    """3x3 SAME average pool, stride 1: each window's sum over the pixels
    it covers, divided by their count (``ops/windows.same_pool_counts``).
    The operator sums bf16 and f32 inputs in f32 and rounds once, as the
    reference's f32 sum and cast do."""
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)


def _block_a(p, x):
    b1 = _conv2d(p["b1"], x)
    b5 = _conv2d(p["b5_2"], _conv2d(p["b5_1"], x))
    bd = _conv2d(p["b3_3"], _conv2d(p["b3_2"], _conv2d(p["b3_1"], x)))
    bp = _conv2d(p["bp"], _avgpool3(x))
    return torch.cat([b1, b5, bd, bp], dim=1)


def _block_b(p, x):
    b3 = _conv2d(p["b3"], x, stride=2, padding="VALID")
    bd = _conv2d(p["bd_3"], _conv2d(p["bd_2"], _conv2d(p["bd_1"], x)), stride=2,
                 padding="VALID")
    return torch.cat([b3, bd, _maxpool(x)], dim=1)


def _block_c(p, x):
    b1 = _conv2d(p["b1"], x)
    b7 = _conv2d(p["b7_3"], _conv2d(p["b7_2"], _conv2d(p["b7_1"], x)))
    bd = x
    for k in ("bd_1", "bd_2", "bd_3", "bd_4", "bd_5"):
        bd = _conv2d(p[k], bd)
    bp = _conv2d(p["bp"], _avgpool3(x))
    return torch.cat([b1, b7, bd, bp], dim=1)


def _block_d(p, x):
    b3 = _conv2d(p["b3_2"], _conv2d(p["b3_1"], x), stride=2, padding="VALID")
    b7 = x
    for k in ("b7_1", "b7_2", "b7_3"):
        b7 = _conv2d(p[k], b7)
    b7 = _conv2d(p["b7_4"], b7, stride=2, padding="VALID")
    return torch.cat([b3, b7, _maxpool(x)], dim=1)


def _block_e(p, x):
    b1 = _conv2d(p["b1"], x)
    b3 = _conv2d(p["b3_1"], x)
    b3 = torch.cat([_conv2d(p["b3_2a"], b3), _conv2d(p["b3_2b"], b3)], dim=1)
    bd = _conv2d(p["bd_2"], _conv2d(p["bd_1"], x))
    bd = torch.cat([_conv2d(p["bd_3a"], bd), _conv2d(p["bd_3b"], bd)], dim=1)
    bp = _conv2d(p["bp"], _avgpool3(x))
    return torch.cat([b1, b3, bd, bp], dim=1)


def forward(cfg: InceptionConfig, params: Dict, images: torch.Tensor) -> torch.Tensor:
    """images ``[n, H, W, 3]`` float (NHWC) → logits ``[n, num_classes]``
    (float32). Branches concatenate along dim 1, the channels."""
    # NHWC memory read as NCHW: a channels_last view, no copy
    x = images.to(cfg.dtype).permute(0, 3, 1, 2)
    s = params["stem"]
    x = _conv2d(s["c1"], x, stride=2, padding="VALID")
    x = _conv2d(s["c2"], x, padding="VALID")
    x = _conv2d(s["c3"], x)
    x = _maxpool(x)
    x = _conv2d(s["c4"], x)
    x = _conv2d(s["c5"], x, padding="VALID")
    x = _maxpool(x)
    for i in range(3):
        x = _block_a(params[f"mixed_a{i}"], x)
    x = _block_b(params["mixed_b"], x)
    for i in range(4):
        x = _block_c(params[f"mixed_c{i}"], x)
    x = _block_d(params["mixed_d"], x)
    for i in range(2):
        x = _block_e(params[f"mixed_e{i}"], x)
    x = x.float().mean(dim=(2, 3))  # global average pool
    fc = params["fc"]
    return x @ asarray(fc["w"], torch.float32) + fc["b"].float()


# ---------------------------------------------------------------------------
# map_blocks program + synthetic data
# ---------------------------------------------------------------------------

def scoring_program(cfg: InceptionConfig, params: Dict):
    """A map_blocks program: image block ``[n, H, W, 3]`` → ``{"scores",
    "label"}``. The weights are the tensors in ``params``, read at every
    call (≙ frozen-graph inference, core.py:42-56)."""

    def program(images):
        logits = forward(cfg, params, images)
        return {
            "scores": torch.softmax(logits, dim=-1).float(),
            "label": torch.argmax(logits, dim=-1).to(torch.int32),
        }

    return program


def synthetic_images(cfg: InceptionConfig, n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    side = cfg.image_size
    return rng.standard_normal((n, side, side, 3), dtype=np.float32)


def param_count(params) -> int:
    total = 0
    for v in tree_leaves(params):
        shape = v.q.shape if isinstance(v, QuantizedTensor) else v.shape
        total += int(np.prod(shape))
    return total


def quantize_params(params: Dict) -> Dict:
    """Weight-only int8: every conv weight per output channel (dim 0 of
    ``[cout, cin, kh, kw]``, the reference's HWIO axis -1) and the
    classifier's weight per class; the folded-BN scale/bias and fc bias
    stay full precision (rank < 2)."""
    convs = quantize_tree(params, predicate=lambda _, leaf: leaf.ndim == 4, channel_axis=0)
    return quantize_tree(convs)
