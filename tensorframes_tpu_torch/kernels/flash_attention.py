"""Flash-attention forward — the kernel behind ``attention_impl="flash"``.

Replaces the Pallas TPU kernel that the reference package's
``ops/attention.py::flash_attention`` reaches on a TPU (upstream JAX's
``jax/experimental/pallas/ops/tpu/flash_attention.py``, forward only):
``softmax(q·kᵀ·sm_scale)·v`` over ``[batch, heads, seq, head_dim]``,
optionally causal, without the ``[seq, seq]`` scores in device memory.

:func:`flash_attention_reference` is the kernel's plain PyTorch version:
dense, in the upstream kernel's order of roundings (the scale applied to
the f32 product, not to q; ``p`` rounded to v's dtype before an
f32-accumulated ``P·V``; the result times ``1/l``, cast to q's dtype).

:func:`flash_attention` goes through the custom op ``tftpu::flash_attention``:

* on a CUDA tensor the op launches ``csrc/flash_attention.cu`` (or
  raises: there is no fallback), reading q/k/v at their own strides, so
  the ``[b, s, 3, h, d] → [b, h, s, d]`` views the encoder passes are not
  copied; the output is a ``[b, h, s, d]`` view of a ``[b, s, h, d]``
  buffer, so the encoder's transpose back is free;
* on a CPU tensor it computes the plain version;
* its fake implementation serves the program's shape analysis;
* its vmap rule folds the vmapped dim into the batch dim and calls the
  op once, so ``map_rows`` launches one kernel per layer per block, not
  one per row.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import check, launch_target, library

MAX_HEAD_DIM = 128
MASK_VALUE = -0.7 * float(np.finfo(np.float32).max)  # upstream's DEFAULT_MASK_VALUE


def default_scale(head_dim: int) -> float:
    """``1/√head_dim`` as an f32 value, the scale both versions apply."""
    return float(np.float32(1.0 / math.sqrt(head_dim)))


def flash_attention_reference(q, k, v, causal: bool = False, sm_scale: float = 1.0):
    """Dense attention in the upstream flash kernel's order of roundings:
    ``s = (q·kᵀ in f32) * sm_scale``; causal positions ``col > row`` get
    the mask value; f32 max and exp; ``p`` cast to ``v.dtype`` before
    ``P·V``, which accumulates in f32; times ``1/l`` (1 where ``l`` is 0);
    cast to ``q.dtype``."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    if causal:
        sq, sk = s.shape[-2:]
        col = torch.arange(sk, device=q.device)
        keep = col[None, :] <= torch.arange(sq, device=q.device)[:, None]
        s = s.masked_fill(~keep, MASK_VALUE)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    inv = torch.where(l == 0, torch.ones_like(l), 1.0 / l)
    return (o * inv).to(q.dtype)


def _out_like(q: torch.Tensor) -> torch.Tensor:
    """An uninitialised ``[b, h, s, d]`` output, laid out as ``[b, s, h, d]``."""
    b, h, s, d = q.shape
    return q.new_empty((b, s, h, d)).transpose(1, 2)


@torch.library.custom_op("tftpu::flash_attention", mutates_args=())
def _flash_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
              sm_scale: float) -> torch.Tensor:
    if q.device.type != "cuda":
        return _out_like(q).copy_(flash_attention_reference(q, k, v, causal, sm_scale))
    return _launch(q, k, v, causal, sm_scale)


@_flash_op.register_fake
def _flash_fake(q, k, v, causal, sm_scale):
    return _out_like(q)


@_flash_op.register_vmap
def _flash_vmap(info, in_dims, q, k, v, causal, sm_scale):
    """Fold the vmapped dim into the batch dim: one op call for the whole
    vmapped batch."""
    n = info.batch_size

    def fold(t, dim):
        t = t.movedim(dim, 0) if dim is not None else t.expand(n, *t.shape)
        return t.reshape(n * t.shape[1], *t.shape[2:])

    out = _flash_op(fold(q, in_dims[0]), fold(k, in_dims[1]), fold(v, in_dims[2]),
                    causal, sm_scale)
    return out.reshape(n, -1, *out.shape[1:]), 0


def _strides(t: torch.Tensor):
    return tuple(int(x) for x in t.stride()[:3])


def _launch(q, k, v, causal: bool, sm_scale: float) -> torch.Tensor:
    b, h, sq, d = (int(x) for x in q.shape)
    sk = int(k.shape[2])
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    out = _out_like(q)
    if b == 0 or sq == 0:
        return out
    rc = library().tft_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, sq, sk, d,
        *_strides(q), *_strides(k), *_strides(v), *_strides(out),
        float(sm_scale), int(causal), int(q.dtype == torch.bfloat16), *launch_target(q.device),
    )
    check("flash_attention", rc)
    return out


def flash_attention(q, k, v, causal: bool = False) -> torch.Tensor:
    """``softmax(q·kᵀ/√d)·v`` for ``q [b, h, sq, d]`` and ``k, v
    [b, h, sk, d]`` of one dtype (bf16 or f32 on the card); the result
    ``[b, h, sq, d]`` in ``q.dtype``. Causal masks ``col > row``. A CUDA
    input the kernel cannot take (another dtype, head_dim above 128, no
    keys) raises."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(
            f"flash_attention: q/k/v must be [b, h, s, d]; got {q.ndim}/{k.ndim}/{v.ndim}-D"
        )
    b, h, _, d = q.shape
    if tuple(k.shape) != tuple(v.shape) or (k.shape[0], k.shape[1], k.shape[3]) != (b, h, d):
        raise ValueError(
            f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} "
            "do not match"
        )
    if q.device.type == "cuda":
        if q.dtype not in (torch.bfloat16, torch.float32) or {k.dtype, v.dtype} != {q.dtype}:
            raise ValueError(
                f"flash_attention: the kernel takes bfloat16 or float32 q/k/v of one dtype; "
                f"got {q.dtype}/{k.dtype}/{v.dtype}"
            )
        if d > MAX_HEAD_DIM:
            raise ValueError(
                f"flash_attention: the kernel takes head_dim <= {MAX_HEAD_DIM}; got {d}"
            )
        if k.shape[2] == 0:
            raise ValueError("flash_attention: the kernel needs at least one key")
        if k.device != q.device or v.device != q.device:
            raise ValueError("flash_attention: q, k and v must be on one device")
    return _flash_op(q, k, v, bool(causal), default_scale(int(d)))
