"""Host-side numpy window arithmetic for pooled models and the GraphDef
importer.

:func:`same_pool_counts` is TF's edge-clipped divisor of a SAME-padded
average pool: how many input pixels each output pixel's window covers.
The port's own copy of ``tensorframes_tpu/ops/windows.py`` (numpy only).
For a stride-1 pool with an odd window, PyTorch's
``avg_pool2d(k, 1, k // 2, count_include_pad=False)`` divides by the same
counts (``models/inception.py``'s 3x3 pool uses that).
"""

from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=64)
def same_pool_counts(
    h: int, w: int, kh: int, kw: int, sh: int = 1, sw: int = 1
) -> np.ndarray:
    """Per-pixel window population of a SAME-padded pool (TF's
    edge-clipped average divisor), shaped ``[1, out_h, out_w, 1]``."""
    out_h, out_w = -(-h // sh), -(-w // sw)
    pad_h = max((out_h - 1) * sh + kh - h, 0)
    pad_w = max((out_w - 1) * sw + kw - w, 0)
    top, left = pad_h // 2, pad_w // 2
    padded = np.zeros((h + pad_h, w + pad_w), np.float32)
    padded[top:top + h, left:left + w] = 1.0
    counts = np.zeros((out_h, out_w), np.float32)
    for i in range(out_h):
        for j in range(out_w):
            counts[i, j] = padded[i * sh:i * sh + kh, j * sw:j * sw + kw].sum()
    return counts.reshape(1, out_h, out_w, 1)
