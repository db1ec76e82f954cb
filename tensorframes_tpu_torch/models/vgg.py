"""VGG-16 image classification (batch-inference workload).

The counterpart of ``tensorframes_tpu/models/vgg.py``: the reference's
image-inference snippet (``tensorframes_snippets/read_image.py``: slim
``vgg.vgg_16`` + central-crop preprocessing + softmax + top-5), scored
through ``map_blocks`` as a plain function program over an image column.
Configuration "D" of Simonyan & Zisserman (2014): 13 3x3 convs in five
pooled stages, then fc6/fc7 (4,096 wide) and fc8 (the classes), the fc
layers as matmuls over the flattened 7x7x512 feature map.

Layout. The public functions take NHWC images ``[n, S, S, 3]``, as the
JAX package does. Inside, activations are logical NCHW tensors in
``torch.channels_last`` memory (NHWC in memory), so cuDNN runs its NHWC
kernels with no transposes; conv weights are ``[cout, cin, 3, 3]`` in
``channels_last`` memory, and the feature map flattens in the
reference's (h, w, c) order. :func:`params_from_jax` converts the JAX
package's HWIO weights.

Numbers. Each conv runs in the compute dtype (cuDNN on a GPU, f32
accumulation in bf16), then bias in f32, ReLU and a cast back, as the
reference's ``_conv_relu``. The fc layers contract the compute-dtype
values in f32 and add the bias in f32, as the reference's
``preferred_element_type=f32`` does. With int8 weights
(:func:`quantize_params`) they go through
:func:`~tensorframes_tpu_torch.ops.quantize.matmul` and launch the
hand-written ``int8_matmul`` kernel on the card, fc6 and fc7 on its
tensor-core build and fc8 (1,000 columns, not a multiple of 16) on its
scalar build; the kernel returns the activations' dtype. The bf16 conv
returns bf16 where XLA keeps f32, so bf16 results round at other places
than the JAX package's. Convolutions and pools have no Pallas
kernel in the reference (XLA computed them), so they run through
PyTorch's operators here.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from ..config import resolve_device
from ..ops.quantize import QuantizedTensor, asarray, matmul, quantize_tree, tree_leaves

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}

# channels-last ImageNet RGB means (vgg_preprocessing's _R_MEAN/_G_MEAN/_B_MEAN)
_RGB_MEAN = (123.68, 116.779, 103.939)

# the 13 conv layers of configuration "D": (#convs in the block,
# out_channels) per pooling stage
_VGG16_PLAN = ((2, 64), (2, 128), (3, 256), (3, 512), (3, 512))


@dataclasses.dataclass(frozen=True)
class VGGConfig:
    num_classes: int = 1000
    image_size: int = 224
    channel_scale: float = 1.0
    fc_width: int = 4096
    compute_dtype: str = "bfloat16"  # activations/weights; accum is f32

    def ch(self, c: int) -> int:
        """Scaled channel count, rounded to a multiple of 8 (at least 8),
        as the reference rounds it."""
        return max(8, int(round(c * self.channel_scale / 8.0)) * 8)

    @property
    def fc(self) -> int:
        return max(8, int(round(self.fc_width * self.channel_scale / 8.0)) * 8)

    @property
    def dtype(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]


def vgg_16(**kw) -> VGGConfig:
    return VGGConfig(**kw)


def tiny(**kw) -> VGGConfig:
    kw.setdefault("num_classes", 10)
    kw.setdefault("image_size", 32)
    kw.setdefault("channel_scale", 0.125)
    kw.setdefault("compute_dtype", "float32")
    return VGGConfig(**kw)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def _shapes(cfg: VGGConfig) -> Dict[str, tuple]:
    """``{name: (cin, cout)}`` for every conv (3x3) and fc layer, in the
    reference's order and with its slim checkpoint names
    (``conv{stage}_{i}``, ``fc6``/``fc7``/``fc8``)."""
    out: Dict[str, tuple] = {}
    cin = 3
    for stage, (reps, width) in enumerate(_VGG16_PLAN, start=1):
        cout = cfg.ch(width)
        for i in range(1, reps + 1):
            out[f"conv{stage}_{i}"] = (cin, cout)
            cin = cout
    # feature map after 5 pools: (size/32)² × ch(512)
    feat = (cfg.image_size // 32) ** 2 * cin
    out["fc6"] = (feat, cfg.fc)
    out["fc7"] = (cfg.fc, cfg.fc)
    out["fc8"] = (cfg.fc, cfg.num_classes)
    return out


def _conv_weight(hwio: torch.Tensor, dtype, device) -> torch.Tensor:
    """An HWIO weight as the port's ``[cout, cin, kh, kw]`` in
    ``channels_last`` memory."""
    oihw = hwio.permute(3, 2, 0, 1).to(device=device, dtype=dtype)
    return oihw.contiguous(memory_format=torch.channels_last)


def init_params(cfg: VGGConfig, seed: int = 0, device=None) -> Dict:
    """He-normal weights and zero biases from a ``torch.Generator``
    seeded with ``seed``, on ``device`` (default ``config.device``), in
    the config's compute dtype; the reference's tree and shapes. The
    numbers differ from the reference's ``jax.random`` draw; carry its
    weights across with :func:`params_from_jax` to score identically."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    dt = cfg.dtype
    params: Dict = {}
    for name, (cin, cout) in _shapes(cfg).items():
        if name.startswith("conv"):
            w = torch.randn((3, 3, cin, cout), generator=gen) * float(np.sqrt(2.0 / (9 * cin)))
            w = _conv_weight(w, dt, device)
        else:
            w = (torch.randn((cin, cout), generator=gen) * float(np.sqrt(2.0 / cin))).to(
                device=device, dtype=dt)
        params[name] = {"w": w, "b": torch.zeros(cout, dtype=dt, device=device)}
    return params


def params_from_jax(cfg: VGGConfig, params: Dict, device=None) -> Dict:
    """The reference package's VGG parameters (numpy arrays: HWIO conv
    weights, ``[cin, cout]`` fc weights, ``[cout]`` biases) as the
    port's, on ``device`` (default ``config.device``), in the config's
    compute dtype. Raises on a missing or extra key and on a shape that
    is not the config's."""
    device = resolve_device(device)
    dt = cfg.dtype
    shapes = _shapes(cfg)
    if set(params) != set(shapes):
        raise ValueError(f"vgg params need keys {sorted(shapes)}, got {sorted(params)}")
    out: Dict = {}
    for name, (cin, cout) in shapes.items():
        w = np.array(params[name]["w"], np.float32)
        b = np.array(params[name]["b"], np.float32)
        want = (3, 3, cin, cout) if name.startswith("conv") else (cin, cout)
        if w.shape != want or b.shape != (cout,):
            raise ValueError(f"vgg {name}: w {w.shape}, b {b.shape}; expected w {want} "
                             f"and [{cout}]")
        wt = torch.from_numpy(w)
        out[name] = {
            "w": (_conv_weight(wt, dt, device) if name.startswith("conv")
                  else wt.to(device=device, dtype=dt)),
            "b": torch.from_numpy(b).to(device=device, dtype=dt),
        }
    return out


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _conv_relu(p, x: torch.Tensor) -> torch.Tensor:
    """3x3 SAME conv (stride 1: symmetric padding 1) + bias in f32 +
    ReLU, cast back to ``x``'s dtype."""
    y = F.conv2d(x, asarray(p["w"], x.dtype), padding=1)
    y = y.float() + p["b"].float().view(1, -1, 1, 1)
    return torch.relu_(y).to(x.dtype)


def _dense(p, x: torch.Tensor) -> torch.Tensor:
    """``x @ w + b`` with the products, sums and bias in f32, as the
    reference's ``preferred_element_type=f32`` computes them. A plain
    ``w`` in bf16/f16 on the card: cuBLAS's half-precision GEMM with an
    f32 output (its default output would round to bf16); elsewhere the
    values contract in f32, where each such product is exact. A
    quantized ``w`` takes the int8 kernel on the card, which returns
    ``x``'s dtype: one rounding of the scaled f32 sum."""
    w = p["w"]
    if isinstance(w, QuantizedTensor):
        y = matmul(x, w)
    elif x.device.type == "cuda" and x.dtype in (torch.bfloat16, torch.float16):
        y = torch.mm(x, w.to(x.dtype), out_dtype=torch.float32)
    else:
        y = x.float() @ w.float()
    return y.float() + p["b"].float()


def forward(cfg: VGGConfig, params: Dict, images: torch.Tensor) -> torch.Tensor:
    """images ``[n, S, S, 3]`` float (NHWC) → logits ``[n, num_classes]``
    (float32)."""
    # NHWC memory read as NCHW: a channels_last view, no copy
    x = images.to(cfg.dtype).permute(0, 3, 1, 2)
    for stage, (reps, _) in enumerate(_VGG16_PLAN, start=1):
        for i in range(1, reps + 1):
            x = _conv_relu(params[f"conv{stage}_{i}"], x)
        x = F.max_pool2d(x, 2, 2)
    # flatten in the reference's NHWC (h, w, c) order
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    for name in ("fc6", "fc7"):
        x = torch.relu_(_dense(params[name], x)).to(cfg.dtype)
    return _dense(params["fc8"], x)


# ---------------------------------------------------------------------------
# Preprocessing (≙ vgg_preprocessing.preprocess_image, inference branch)
# ---------------------------------------------------------------------------

def preprocess(images: torch.Tensor, out_size: int) -> torch.Tensor:
    """Central-crop a ``[n, H, W, 3]`` batch to ``out_size`` and subtract
    the ImageNet channel means, on the batch's device."""
    images = torch.as_tensor(images)
    _, h, w, _ = images.shape
    if h < out_size or w < out_size:
        raise ValueError(
            f"preprocess: input {h}x{w} smaller than crop {out_size}"
        )
    top = (h - out_size) // 2
    left = (w - out_size) // 2
    x = images[:, top:top + out_size, left:left + out_size, :]
    mean = torch.tensor(_RGB_MEAN, dtype=images.dtype, device=images.device)
    return x - mean


# ---------------------------------------------------------------------------
# map_blocks scoring program (≙ read_image.py's output_nodes:
# probabilities + top-k indices + top-k values)
# ---------------------------------------------------------------------------

def scoring_program(cfg: VGGConfig, params: Dict, top_k: int = 5):
    """Image block ``[n, S, S, 3]`` → ``{"scores", "top_idx",
    "top_val"}``. The weights are the tensors in ``params``, read at
    every call."""
    k = min(top_k, cfg.num_classes)

    def program(images):
        logits = forward(cfg, params, images)
        scores = torch.softmax(logits, dim=-1).float()
        top_val, top_idx = torch.topk(scores, k, dim=-1)
        return {
            "scores": scores,
            "top_idx": top_idx.to(torch.int32),
            "top_val": top_val,
        }

    return program


def synthetic_images(cfg: VGGConfig, n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    s = cfg.image_size
    return rng.standard_normal((n, s, s, 3), dtype=np.float32)


def param_count(params) -> int:
    total = 0
    for v in tree_leaves(params):
        shape = v.q.shape if isinstance(v, QuantizedTensor) else v.shape
        total += int(np.prod(shape))
    return total


def quantize_params(params: Dict) -> Dict:
    """Weight-only int8 for every conv/dense weight, per output channel
    (dim 0 of a conv's ``[cout, cin, 3, 3]``, the reference's HWIO axis
    -1; the last dim of an fc's ``[cin, cout]``); biases stay full
    precision (rank < 2)."""
    convs = quantize_tree(params, predicate=lambda _, leaf: leaf.ndim == 4, channel_axis=0)
    return quantize_tree(convs)
