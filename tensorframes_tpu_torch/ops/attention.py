"""Attention for the transformer family, one contract for all:
``[batch, heads, seq, head_dim]``.

* :func:`dense_attention` — plain O(s²) attention, the correctness
  oracle (the encoder's ``attention_impl="dense"`` and the cache-free
  ``generate_naive``);
* :func:`blockwise_attention` — an online softmax over key blocks,
  O(s·block) memory, in the reference's order of roundings;
* :func:`flash_attention` — the hand-written flash-attention kernels
  (``kernels/flash_attention.py``) on a CUDA tensor, their plain versions
  on a CPU tensor; differentiable, its gradient through the two backward
  kernels.

Dense and blockwise attention are differentiable through autograd (the
dense and blockwise training paths).

The reference's ring and Ulysses implementations wait for the
multi-device work (ROADMAP queue 1).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

NEG_INF = -1e30


def dense_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    padding_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain O(s²) attention, the correctness oracle for the kernels.

    ``q/k/v [b, h, s, d]``; ``padding_mask``: bool ``[b, s_k]``, False
    positions masked out. As the reference: q is scaled by 1/√d in its own
    dtype, scores and the context accumulate in f32, the result is cast
    to ``q.dtype``."""
    d = q.shape[-1]
    qs = q / torch.full((), math.sqrt(d), dtype=q.dtype, device=q.device)
    s = torch.einsum("bhqd,bhkd->bhqk", qs.float(), k.float())
    if causal:
        sq, sk = s.shape[-2:]
        mask = torch.arange(sq, device=q.device)[:, None] >= torch.arange(sk, device=q.device)
        s = s.masked_fill(~mask[None, None], NEG_INF)
    if padding_mask is not None:
        s = s.masked_fill(~padding_mask.bool()[:, None, None, :], NEG_INF)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", w, v.float()).to(q.dtype)


def blockwise_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    block_size: int = 512,
) -> torch.Tensor:
    """Online softmax over key blocks of ``block_size`` (the last one
    padded and masked): exact attention in O(sq · block) memory per head.
    As the reference: q scaled by 1/√d in its own dtype, f32 scores and
    running max/denominator/context, the context divided by
    ``max(l, 1e-30)`` and cast to ``q.dtype``."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    block_size = min(block_size, sk)
    num_blocks = -(-sk // block_size)
    pad = num_blocks * block_size - sk
    if pad:
        k = F.pad(k, (0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, pad))
    # the scale rounds to q's dtype first, as a weak-typed scalar does in JAX
    qs = (q * torch.full((), float(1.0 / np.sqrt(d)), dtype=q.dtype, device=q.device)).float()
    q_pos = torch.arange(sq, device=q.device)
    o = torch.zeros((b, h, sq, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    for i in range(num_blocks):
        blk = slice(i * block_size, (i + 1) * block_size)
        s = torch.einsum("bhqd,bhkd->bhqk", qs, k[:, :, blk].float())
        mask = None
        if causal or pad:
            k_pos = torch.arange(i * block_size, (i + 1) * block_size, device=q.device)
            mask = (k_pos < sk)[None, :]
            if causal:
                mask = mask & (q_pos[:, None] >= k_pos[None, :])
            s = s.masked_fill(~mask, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        # rows with nothing attended yet keep m at NEG_INF; exp underflows to 0
        p = torch.exp(s - m_new[..., None])
        if mask is not None:
            p = p.masked_fill(~mask, 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        o = o * corr[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, v[:, :, blk].float())
        m = m_new
    return (o / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    block_size: int = 512,
) -> torch.Tensor:
    """Attention through the flash-attention kernel: on a CUDA tensor the
    hand-written kernel (any sequence length, head_dim <= 128, bf16 or
    f32; an input it cannot take raises, nothing falls back), on a CPU
    tensor its plain version, both in the upstream flash kernel's order of
    roundings (``kernels/flash_attention.py``). Its gradient goes through
    the dK/dV and dQ kernels the same way. ``block_size`` is the
    reference's signature, which passes it to its blockwise fallback; the
    port has no fallback and the kernel picks its own tiles."""
    from ..kernels.flash_attention import flash_attention as kernel

    del block_size
    return kernel(q, k, v, causal=causal)
