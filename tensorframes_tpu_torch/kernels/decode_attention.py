"""Paged int8-KV decode attention — the kernel half of the decode engine.

Replaces ``tensorframes_tpu/kernels/decode_attention.py::paged_decode_attention``
(the Pallas TPU kernel). Decode is bound by memory traffic, so what the
kernel saves is the materialized gather: the plain chain
(:func:`paged_attention_reference`) copies every slot's pages into a
``[S, heads, pages * page_size, head_dim]`` tensor, dequantizes it and
attends; the kernel (``csrc/decode_attention.cu``) stages each slot's
int8 rows straight out of the pool through its page table into shared
memory, all at once, and keeps scores and weights on chip. It reads
``q`` at its strides, so the decode step's ``qkv[:, 0]`` view needs no
copy.

Null-page handling is the reference's: padding slots carry all-null
tables (every page is page 0) and real slots mask to ``position <= pos``,
so the null page's garbage never reaches an unmasked score.

CUDA tensors launch the kernel (or raise); CPU tensors, and the fake
tensors of shape analysis, compute :func:`paged_attention_reference`.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import check, launch_target, library

NEG = -1e30


def _sqrt_hd(hd: int) -> float:
    """√head_dim rounded to f32, the divisor both versions use."""
    return float(np.float32(math.sqrt(hd)))


def paged_attention_reference(q, k_pages, v_pages, k_scale, v_scale, layer, tables, pos):
    """The gather → dequantize → attend chain, line for line as the
    reference's oracle: ``q [S, nh, hd]``, int8 pages ``[P, L, nh, page,
    hd]``, f32 scales ``[P, L, nh, page, 1]``, int32 ``tables [S, maxp]``
    and ``pos [S]`` → context ``[S, nh, hd]`` in ``q.dtype``. Both
    contractions accumulate in f32; the softmax is ``exp(s - max) / sum``
    as ``jax.nn.softmax`` computes it."""
    S, nh, hd = q.shape
    page = int(k_pages.shape[3])
    maxp = int(tables.shape[1])
    C = maxp * page
    dtype = q.dtype
    li = int(layer)
    tables = tables.long()
    valid = torch.arange(C, device=q.device)[None, :] <= pos.long()[:, None]
    pk = k_pages[tables, li]
    pv = v_pages[tables, li]
    pks = k_scale[tables, li][..., 0]
    pvs = v_scale[tables, li][..., 0]
    pk = pk.permute(0, 2, 1, 3, 4).reshape(S, nh, C, hd)
    pv = pv.permute(0, 2, 1, 3, 4).reshape(S, nh, C, hd)
    pks = pks.permute(0, 2, 1, 3).reshape(S, nh, C)
    pvs = pvs.permute(0, 2, 1, 3).reshape(S, nh, C)
    sqrt_hd = torch.full((), _sqrt_hd(hd), dtype=torch.float32, device=q.device)
    scores = torch.einsum("nhd,nhcd->nhc", q.float(), pk.to(dtype).float()) / sqrt_hd
    scores = scores * pks
    scores = scores.masked_fill(~valid[:, None, :], NEG)
    e = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    w = e / e.sum(dim=-1, keepdim=True)
    w = (w * pvs).to(dtype)
    return torch.einsum("nhc,nhcd->nhd", w.float(), pv.to(dtype).float()).to(dtype)


def paged_decode_attention(q, k_pages, v_pages, k_scale, v_scale, layer, tables, pos):
    """One layer's paged decode attention for every slot: the ``[S, nh,
    hd]`` context in ``q.dtype`` (bf16 or f32). Same arguments as
    :func:`paged_attention_reference`. ``pos`` must be >= 0; page-table
    entries outside the pool clamp, as the reference's gather does."""
    from torch._subclasses.fake_tensor import is_fake

    if q.device.type != "cuda" or is_fake(q):
        return paged_attention_reference(q, k_pages, v_pages, k_scale, v_scale, layer,
                                         tables, pos)
    S, nh, hd = (int(d) for d in q.shape)
    P, L, nh_k, page, hd_k = (int(d) for d in k_pages.shape)
    maxp = int(tables.shape[1])
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"paged_decode_attention: q must be bfloat16 or float32, got {q.dtype}")
    if (nh_k, hd_k) != (nh, hd) or tuple(v_pages.shape) != tuple(k_pages.shape):
        raise ValueError(
            f"paged_decode_attention: q {tuple(q.shape)} vs pages {tuple(k_pages.shape)} / "
            f"{tuple(v_pages.shape)}"
        )
    if tuple(k_scale.shape) != (P, L, nh, page, 1) or tuple(v_scale.shape) != (P, L, nh, page, 1):
        raise ValueError("paged_decode_attention: scales must be [P, L, nh, page, 1]")
    if k_pages.dtype != torch.int8 or v_pages.dtype != torch.int8:
        raise ValueError("paged_decode_attention: pages must be int8")
    if k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32:
        raise ValueError("paged_decode_attention: scales must be float32")
    if tuple(tables.shape) != (S, maxp) or tuple(pos.shape) != (S,):
        raise ValueError(
            f"paged_decode_attention: tables {tuple(tables.shape)} / pos {tuple(pos.shape)} "
            f"for {S} slots"
        )
    if hd > 128:
        raise ValueError(f"paged_decode_attention: head_dim {hd} > 128")
    if not 0 <= int(layer) < L:
        raise ValueError(f"paged_decode_attention: layer {layer} outside [0, {L})")
    dev = q.device
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages), ("k_scale", k_scale),
                    ("v_scale", v_scale)):
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"paged_decode_attention: {name} must be contiguous on {dev}")
    if q.stride(-1) != 1:
        q = q.contiguous()  # the kernel reads q at its slot and head strides
    tables = tables.to(device=dev, dtype=torch.int32).contiguous()
    pos = pos.to(device=dev, dtype=torch.int32).contiguous()
    out = torch.empty((S, nh, hd), dtype=q.dtype, device=dev)
    if S == 0:
        return out
    rc = library().tft_paged_decode_attention(
        q.data_ptr(), q.stride(0), q.stride(1), k_pages.data_ptr(), v_pages.data_ptr(),
        k_scale.data_ptr(),
        v_scale.data_ptr(), tables.data_ptr(), pos.data_ptr(), out.data_ptr(),
        S, nh, hd, page, maxp, int(layer), L, P, _sqrt_hd(hd),
        int(q.dtype == torch.bfloat16), *launch_target(dev),
    )
    check("decode_attention", rc)
    return out
