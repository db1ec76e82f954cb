"""Weight-only int8 quantization for inference, and the int8-weight matmul.

Small-batch serving is bound by weight traffic, not by arithmetic:
symmetric per-output-channel int8 storage moves 4× fewer weight bytes
than f32 (2× fewer than bf16). :class:`QuantizedTensor` is the stored
form (``q * scale ≈ w``); :func:`quantize_tree` converts a parameter tree
of plain dicts and lists; :func:`asarray` is the read-side accessor, so
one forward pass serves plain and quantized trees.

:func:`matmul` is ``x @ w``. For an eligible quantized weight (a 2-D
``q`` with per-output-channel scale, ``x`` in bf16 or f32) on a CUDA
tensor it launches the hand-written int8-weight kernel
(:func:`matmul_int8`), which replaces the reference package's Pallas
kernel ``ops/quantize.py::matmul_pallas_int8``, in one of two builds
(:func:`int8_matmul_build`): bf16 ``x`` on the tensor cores, split over
k (``csrc/int8_matmul_mma.cu``, partition :func:`int8_matmul_split`),
f32 ``x`` and unaligned shapes on the scalar kernel
(``csrc/int8_matmul.cu``).
On a CPU tensor it keeps the reference's structural path
(``(x @ q.to(x.dtype)) * scale``), so the CPU results match the JAX
package's CPU results. :func:`matmul_int8_plain` is the kernel's plain
PyTorch version, with the Pallas kernel's semantics: f32 accumulation,
the scale applied to the f32 sum, one cast to ``x.dtype``.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np
import torch

from ..kernels import check, launch_target, library


class QuantizedTensor:
    """Symmetric per-channel int8 weight: ``q * scale ≈ w``.

    ``scale`` (f32) keeps singleton dims, so it broadcasts against ``q``
    and dequantization is one multiply."""

    __slots__ = ("q", "scale")

    def __init__(self, q: torch.Tensor, scale: torch.Tensor):
        self.q = q
        self.scale = scale

    @property
    def shape(self):
        return tuple(self.q.shape)

    @property
    def nbytes(self) -> int:
        return int(np.prod(self.q.shape)) + 4 * int(np.prod(self.scale.shape))

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        return (self.q.float() * self.scale).to(dtype)

    def to(self, device) -> "QuantizedTensor":
        return QuantizedTensor(self.q.to(device), self.scale.to(device))

    def __repr__(self) -> str:  # pragma: no cover - convenience
        return f"QuantizedTensor(shape={self.shape}, device={self.q.device})"


def quantize(w, channel_axis=-1) -> QuantizedTensor:
    """Symmetric per-channel int8: scales are per-slice max/127 along every
    axis EXCEPT ``channel_axis`` (the output-feature axis). ``channel_axis``
    may be a tuple for channels that span several axes. Rounds half to
    even (``torch.round``, as ``jnp.round``) and clips to ±127; an all-zero
    slice gets scale 1."""
    w = torch.as_tensor(w)
    if not w.is_floating_point():
        raise TypeError(f"quantize expects a floating array, got {w.dtype}")
    axes = (channel_axis,) if isinstance(channel_axis, int) else tuple(channel_axis)
    keep = {a % w.ndim for a in axes}
    reduce_axes = tuple(i for i in range(w.ndim) if i not in keep)
    w32 = w.float()
    absmax = w32.abs()
    if reduce_axes:
        absmax = absmax.amax(dim=reduce_axes, keepdim=True)
    scale = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return QuantizedTensor(q, scale)


def asarray(w, dtype=torch.float32) -> torch.Tensor:
    """Read-side accessor: dequantize if quantized, else cast."""
    if isinstance(w, QuantizedTensor):
        return w.dequantize(dtype)
    return torch.as_tensor(w).to(dtype)


def _per_output_channel(w: QuantizedTensor) -> bool:
    return w.q.ndim == 2 and tuple(w.scale.shape[:-1]) == (1,)


def _kernel_eligible(x: torch.Tensor, w) -> bool:
    return (
        isinstance(w, QuantizedTensor)
        and _per_output_channel(w)
        and x.dtype in (torch.bfloat16, torch.float32)
    )


def matmul(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ w`` for a plain or quantized weight.

    A quantized, per-output-channel 2-D weight with ``x`` in bf16/f32 on
    a CUDA tensor launches the int8-weight kernel (:func:`matmul_int8`);
    there is no fallback. On the CPU it takes the reference's structural
    path, where the scale commutes out of the contraction:
    ``(x @ q.to(x.dtype)).float() * scale`` cast back to ``x.dtype``.
    Scale layouts that span contracted axes dequantize first."""
    if not isinstance(w, QuantizedTensor):
        return x @ torch.as_tensor(w).to(x.dtype)
    if not _per_output_channel(w):
        return x @ w.dequantize(x.dtype)
    if x.device.type == "cuda" and _kernel_eligible(x, w):
        return matmul_int8(x, w)
    out = x @ w.q.to(x.dtype)
    return (out.float() * w.scale.reshape(-1)).to(x.dtype)


def matmul_plain(x: torch.Tensor, w) -> torch.Tensor:
    """:func:`matmul` with the int8 kernel's plain version wherever
    :func:`matmul` would launch the kernel on a CUDA tensor, on any
    device (the decode step's plain path)."""
    if _kernel_eligible(x, w):
        return matmul_int8_plain(x, w)
    return matmul(x, w)


def matmul_int8_plain(x: torch.Tensor, w: QuantizedTensor) -> torch.Tensor:
    """Plain PyTorch version of the int8-weight kernel: widen ``q``,
    accumulate ``x @ q`` in f32, multiply the f32 sum by the per-channel
    scale, cast once to ``x.dtype``."""
    out = x.float() @ w.q.float()
    return (out * w.scale.reshape(-1)).to(x.dtype)


SPLIT_TILE_N = 32     # output channels per block of the mma build
SPLIT_QUANTUM = 32    # k rows a chunk is a multiple of: two 16-deep mma steps
MAX_SPLITS = 8        # one cluster of blocks per output tile: the portable cluster size
CARD_SMS = 132        # the H100's streaming multiprocessors


def int8_matmul_split(k: int, n: int) -> tuple:
    """``(chunk, splits)``: the mma build's partition of k. Split ``s``
    sums rows ``s·chunk .. min(k, (s + 1)·chunk) - 1`` of the weight, and
    the splits' partials are added in the order 0, 1, ..., splits - 1.
    A function of ``(k, n)`` alone, so a row's sums never depend on how
    many rows ride with it. It asks for enough splits that the ``n / 32``
    output tiles of one 16-token block row put a block on each of the
    card's 132 SMs (at most 8, one cluster), then rounds the chunk up to
    a multiple of 32 and drops any split left empty."""
    if k < 1 or n < 1:
        raise ValueError(f"int8_matmul_split: k {k}, n {n}")
    tiles = -(-n // SPLIT_TILE_N)
    want = min(MAX_SPLITS, -(-CARD_SMS // tiles))
    chunk = -(-(-(-k // want)) // SPLIT_QUANTUM) * SPLIT_QUANTUM
    return chunk, -(-k // chunk)


def _aligned_16(t: torch.Tensor) -> bool:
    """The kernel reads ``t`` itself when it is contiguous (a view keeps
    its data pointer), else a fresh, aligned copy."""
    return not t.is_contiguous() or t.data_ptr() % 16 == 0


def int8_matmul_build(x: torch.Tensor, w) -> str:
    """The build a CUDA call of :func:`matmul_int8` launches: ``"mma"`` or
    ``"scalar"``.

    ``"mma"`` (``csrc/int8_matmul_mma.cu``, the tensor cores, split over
    k) takes bfloat16 ``x`` whose rows, and the weight's, the copy engine
    reads through a tensor map: row strides of a multiple of 16 bytes
    (``k % 8 == 0`` for x, ``n % 16 == 0`` for the weight) and both on
    16-byte boundaries. Everything else
    goes to ``"scalar"`` (``csrc/int8_matmul.cu``): float32 ``x``, which
    the tensor cores would take only as TF32, and the bfloat16 shapes
    above that fail the rule. Both compute the same function with f32
    sums, the scale on the sum and one rounding; this chooses between two
    kernels and is not a fallback. Every weight product of the decode
    server and of the quantized encoder takes ``"mma"``. ``w`` is a
    :class:`QuantizedTensor` or its int8 ``q``."""
    q = w.q if isinstance(w, QuantizedTensor) else w
    k, n = int(q.shape[0]), int(q.shape[1])
    if (x.dtype == torch.bfloat16 and k % 8 == 0 and n % 16 == 0
            and _aligned_16(x) and _aligned_16(q)):
        return "mma"
    return "scalar"


@torch.library.custom_op("tftpu::int8_matmul", mutates_args=())
def _int8_op(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    if x.device.type != "cuda":
        return matmul_int8_plain(x, QuantizedTensor(q, scale))
    return _launch_int8(x, q, scale)


@_int8_op.register_fake
def _int8_fake(x, q, scale):
    return x.new_empty((*x.shape[:-1], q.shape[1]))


@_int8_op.register_vmap
def _int8_vmap(info, in_dims, x, q, scale):
    """Fold the vmapped dim into the kernel's rows: one launch for the
    whole vmapped batch (``map_rows`` over a quantized model)."""
    if in_dims[1] is not None or in_dims[2] is not None:
        raise NotImplementedError("matmul_int8 under vmap: the weight must not be vmapped")
    return _int8_op(x.movedim(in_dims[0], 0), q, scale), 0


def _launch_int8(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    k, n = int(q.shape[0]), int(q.shape[1])
    lead = tuple(x.shape[:-1])
    m = int(np.prod(lead)) if lead else 1
    x2 = x.reshape(m, k).contiguous()
    q = q.contiguous()
    scale = scale.contiguous()
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0:
        return out.reshape(*lead, n)
    if int8_matmul_build(x2, q) == "mma":
        chunk, _ = int8_matmul_split(k, n)
        rc = library().tft_int8_matmul_mma(
            x2.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(),
            m, k, n, chunk, *launch_target(x.device),
        )
        check("int8_matmul", rc, "int8_matmul_mma")
    else:
        rc = library().tft_int8_matmul(
            x2.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(),
            m, k, n, int(x.dtype == torch.bfloat16), *launch_target(x.device),
        )
        check("int8_matmul", rc)
    return out.reshape(*lead, n)


def matmul_int8(x: torch.Tensor, w: QuantizedTensor) -> torch.Tensor:
    """``x [..., k] @ int8 w.q [k, n]`` with per-output-channel scale, in
    ``x.dtype``, through the custom op ``tftpu::int8_matmul``. On a CUDA
    tensor: the hand-written kernel, in the build
    :func:`int8_matmul_build` chooses (a 2-D view of ``x``'s leading
    dims; each output row is summed over k in an order fixed by ``(k,
    n)``, so a row's bits do not depend on how many rows ride with it).
    On a CPU tensor:
    :func:`matmul_int8_plain`. Shape analysis takes the op's fake
    implementation; under ``torch.func.vmap`` its vmap rule folds the
    vmapped dim into the rows and calls the op once."""
    if not _per_output_channel(w):
        raise ValueError(
            f"matmul_int8 needs a 2-D q with per-output-channel scale [1, n]; "
            f"got q {tuple(w.q.shape)}, scale {tuple(w.scale.shape)}"
        )
    k, n = int(w.q.shape[0]), int(w.q.shape[1])
    if x.shape[-1] != k:
        raise ValueError(f"matmul_int8: x [..., {x.shape[-1]}] @ q [{k}, {n}]")
    if x.device.type == "cuda":
        if x.dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(f"matmul_int8: x must be bfloat16 or float32, got {x.dtype}")
        if w.q.dtype != torch.int8 or w.scale.dtype != torch.float32:
            raise ValueError("matmul_int8: q must be int8 and scale float32")
        if w.q.device != x.device or w.scale.device != x.device:
            raise ValueError("matmul_int8: x, q and scale must be on one device")
    return _int8_op(x, w.q, w.scale.reshape(n))


def _tree_map(fn, tree, path=()):
    """Map ``fn(path, leaf)`` over nested dicts/lists/tuples; a
    :class:`QuantizedTensor` is a leaf."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v, path + (i,)) for i, v in enumerate(tree))
    return fn(path, tree)


def tree_leaves(tree):
    """The leaves of a parameter tree, :class:`QuantizedTensor` whole."""
    out = []
    _tree_map(lambda _, leaf: out.append(leaf), tree)
    return out


def tree_to(tree, device):
    """The tree with every tensor (and quantized weight) on ``device``."""
    def move(_, leaf):
        if isinstance(leaf, (QuantizedTensor, torch.Tensor)):
            return leaf.to(device)
        return leaf

    return _tree_map(move, tree)


def quantize_tree(
    params: Any,
    min_rank: int = 2,
    predicate: Optional[Callable[[tuple, torch.Tensor], bool]] = None,
    channel_axis: int = -1,
) -> Any:
    """Quantize every floating tensor leaf of rank >= ``min_rank``
    (weights; biases and norms stay full precision). ``predicate(path,
    leaf)`` — ``path`` the tuple of dict keys and list indices — can veto
    a leaf. Idempotent on already-quantized leaves."""

    def maybe_q(path, leaf):
        if isinstance(leaf, QuantizedTensor) or not torch.is_tensor(leaf):
            return leaf
        if not leaf.is_floating_point() or leaf.ndim < min_rank:
            return leaf
        if predicate is not None and not predicate(path, leaf):
            return leaf
        return quantize(leaf, channel_axis)

    return _tree_map(maybe_q, params)


def tree_nbytes(params: Any) -> int:
    """Total parameter bytes, counting a quantized leaf as int8 + scales."""
    total = 0
    for leaf in tree_leaves(params):
        if isinstance(leaf, QuantizedTensor):
            total += leaf.nbytes
        elif torch.is_tensor(leaf):
            total += leaf.numel() * leaf.element_size()
        else:
            arr = np.asarray(leaf)
            total += arr.size * arr.dtype.itemsize
    return total
