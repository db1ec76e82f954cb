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
  kernels;
* :func:`ring_attention` — sequence parallelism over a mesh axis of
  ranks: each rank holds a shard of the sequence and scans the whole of
  it by rotating its k/v shard around the axis's ring
  (:func:`..parallel.collectives.ring_permute`) while it accumulates the
  online softmax; exact attention in O(seq/sp) memory a rank;
* :func:`ulysses_attention` — the all-to-all complement: heads scatter
  and the sequence gathers, blockwise attention runs on the whole
  sequence for heads/sp heads, the reverse exchange restores the shard;
* :func:`paged_decode_attention` — the paged int8-KV decode kernel
  (``kernels/decode_attention.py``) behind the reference's public face.

Dense, blockwise, ring and Ulysses attention are differentiable through
autograd (the ring's and Ulysses' collectives have their transposes as
backward). Where the reference's ring and Ulysses take global arrays
under ``shard_map``, the port's take this rank's shard ``[b/dp, h/tp,
s/sp, d]``: the mesh names the group to rotate or exchange over.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

NEG_INF = -1e30


def _scaled_q(q: torch.Tensor) -> torch.Tensor:
    """q times 1/√d, the scale rounded to q's dtype first (as a
    weak-typed scalar does in JAX), widened to f32."""
    d = q.shape[-1]
    return (q * torch.full((), float(1.0 / np.sqrt(d)), dtype=q.dtype, device=q.device)).float()


def _online_block(qs, k, v, o, m, l, mask: Optional[torch.Tensor]):
    """One online-softmax accumulation step (the flash-attention
    recurrence) in the reference's order of roundings: ``qs`` pre-scaled
    f32 ``[b, h, sq, d]``, f32 scores against ``k``, masked to
    ``NEG_INF`` where ``mask`` (bool ``[sq, sk]``) is False, then the
    running max ``m``, the correction, the denominator ``l`` and the f32
    context ``o``. Returns ``(o, m, l)``."""
    s = torch.einsum("bhqd,bhkd->bhqk", qs, k.float())
    if mask is not None:
        s = s.masked_fill(~mask, NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    # rows with nothing attended yet keep m at NEG_INF; exp underflows to 0
    p = torch.exp(s - m_new[..., None])
    if mask is not None:
        p = p.masked_fill(~mask, 0.0)
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(dim=-1)
    o_new = o * corr[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return o_new, m_new, l_new


def _init_state(q: torch.Tensor):
    b, h, sq, d = q.shape
    return (torch.zeros((b, h, sq, d), dtype=torch.float32, device=q.device),
            torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=q.device),
            torch.zeros((b, h, sq), dtype=torch.float32, device=q.device))


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
    sq, sk = q.shape[2], k.shape[2]
    block_size = min(block_size, sk)
    num_blocks = -(-sk // block_size)
    pad = num_blocks * block_size - sk
    if pad:
        k = F.pad(k, (0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, pad))
    qs = _scaled_q(q)
    q_pos = torch.arange(sq, device=q.device)
    o, m, l = _init_state(q)
    for i in range(num_blocks):
        blk = slice(i * block_size, (i + 1) * block_size)
        mask = None
        if causal or pad:
            k_pos = torch.arange(i * block_size, (i + 1) * block_size, device=q.device)
            mask = (k_pos < sk)[None, :]
            if causal:
                mask = mask & (q_pos[:, None] >= k_pos[None, :])
        o, m, l = _online_block(qs, k[:, :, blk], v[:, :, blk], o, m, l, mask)
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


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh,
    axis: str = "sp",
    causal: bool = False,
    batch_axis: Optional[str] = "dp",
    head_axis: Optional[str] = "tp",
) -> torch.Tensor:
    """Sequence-parallel exact attention over ``mesh[axis]``, as the
    reference's ``lax.scan`` over the axis's ``n`` rotations.

    ``q/k/v`` are this rank's shard ``[b, h, s/n, d]`` of the sequence
    (rank ``i`` of the axis holds rows ``[i·s/n, (i+1)·s/n)``); the
    result is this rank's rows of the context. At rotation ``t`` the k/v
    held came from the axis's rank ``(i - t) mod n``; with ``causal`` its
    keys sit at ``src·s/n + arange`` and a block wholly above the
    diagonal is computed and masked, as the reference does. ``batch_axis``
    and ``head_axis`` are the reference's: they name how the caller split
    batch and heads, which the shard already reflects."""
    del batch_axis, head_axis
    n = mesh.shape[axis]
    me = mesh.axis_index(axis)
    group = mesh.group(axis)
    from ..parallel.collectives import ring_permute

    s_loc = q.shape[2]
    qs = _scaled_q(q)
    q_pos = me * s_loc + torch.arange(s_loc, device=q.device)
    kv = torch.stack([k, v])
    o, m, l = _init_state(q)
    for t in range(n):
        mask = None
        if causal:
            src = (me - t) % n
            k_pos = src * s_loc + torch.arange(s_loc, device=q.device)
            mask = q_pos[:, None] >= k_pos[None, :]
        o, m, l = _online_block(qs, kv[0], kv[1], o, m, l, mask)
        if t < n - 1:  # the reference's last rotation only hands the shards back
            kv = ring_permute(kv, group)
    return (o / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)


def ulysses_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh,
    axis: str = "sp",
    causal: bool = False,
    batch_axis: Optional[str] = "dp",
) -> torch.Tensor:
    """All-to-all sequence parallelism (DeepSpeed-Ulysses style), the
    complement of :func:`ring_attention`.

    ``q/k/v`` are this rank's shard ``[b, h, s/n, d]`` of the sequence.
    One exchange of the stacked q/k/v scatters heads and gathers the
    sequence (each rank then holds the whole sequence for ``h/n`` heads),
    :func:`blockwise_attention` runs on it with no per-step
    communication, and the reverse exchange restores this rank's rows for
    all ``h`` heads. ``h`` must divide by the axis size. ``batch_axis`` is
    the reference's (the shard already reflects the batch split)."""
    del batch_axis
    from ..parallel.collectives import all_to_all

    n = mesh.shape[axis]
    heads = q.shape[1]
    if heads % n != 0:
        raise ValueError(
            f"ulysses_attention: heads {heads} not divisible by mesh axis "
            f"{axis!r} of size {n} (use ring_attention for heads < sp)"
        )
    group = mesh.group(axis)
    # [3, b, h, s/n, d] -> [3, b, h/n, s, d]: heads scatter, sequence gathers
    qkv = all_to_all(torch.stack([q, k, v]), group, split_axis=2, concat_axis=3)
    ctx = blockwise_attention(qkv[0], qkv[1], qkv[2], causal=causal)
    # reverse: sequence scatters, heads gather -> [b, h, s/n, d]
    return all_to_all(ctx, group, split_axis=2, concat_axis=1)


def paged_decode_attention(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    k_scale: torch.Tensor,
    v_scale: torch.Tensor,
    layer: int,
    tables: torch.Tensor,
    pos: torch.Tensor,
    interpret: Optional[bool] = None,
) -> torch.Tensor:
    """Fused paged int8-KV decode attention, the public face of
    ``kernels/decode_attention.paged_decode_attention`` in the reference's
    argument order: each slot's pages gathered through its page table,
    dequantized in registers, and the masked softmax attention computed,
    in one launch of the hand-written kernel on a CUDA tensor (an input
    it cannot take raises); on a CPU tensor its plain version. ``q``
    ``[slots, heads, head_dim]``; the pool tensors are
    ``models/generation.init_paged_kv``'s layout. ``interpret`` is the
    reference's Pallas-interpreter switch: the port has no interpreter,
    so only None or False is accepted."""
    from ..kernels.decode_attention import paged_decode_attention as _kernel

    if interpret:
        raise ValueError("paged_decode_attention: the port has no interpret mode; a CPU "
                         "tensor computes the plain version")
    return _kernel(q, k_pages, v_pages, k_scale, v_scale, layer, tables, pos)
