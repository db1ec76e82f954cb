"""Attention for the transformer family: the dense O(s²) formulation.

The reference package's ``ops/attention.py`` holds four implementations
behind one contract (``[batch, heads, seq, head_dim]``). The port has the
dense one, which the encoder's ``forward`` (``attention_impl="dense"``)
and the cache-free ``generate_naive`` oracle use. The blockwise, flash
(a Pallas TPU kernel upstream), ring and Ulysses implementations wait
for the models and multi-device slices (ROADMAP queues 1 and 2).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

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
