"""Flash attention — the kernels behind ``attention_impl="flash"``, forward
and gradient.

Replaces the Pallas TPU kernels that the reference package's
``ops/attention.py::flash_attention`` reaches on a TPU (upstream JAX's
``jax/experimental/pallas/ops/tpu/flash_attention.py``): the forward
``softmax(q·kᵀ·sm_scale)·v`` over ``[batch, heads, seq, head_dim]``,
optionally causal, without the ``[seq, seq]`` scores in device memory,
and the two backward kernels that ``jax.grad`` reaches through its
``custom_vjp``, ``_flash_attention_bwd_dkv`` and ``_flash_attention_bwd_dq``.

The plain PyTorch versions, dense, in the upstream kernels' order of
roundings:

* :func:`flash_attention_fwd_reference` → ``(o, l, m)``: the scale applied
  to the f32 product, not to q; ``p`` rounded to v's dtype before an
  f32-accumulated ``P·V``; the result times ``1/l``, cast to q's dtype;
  ``l`` and ``m`` are each row's denominator and max, upstream's residuals
  (:func:`flash_attention_reference` returns ``o`` alone);
* :func:`flash_attention_bwd_reference` → ``(dq, dk, dv)``: ``di = Σ o·dO``
  in f32; ``p = exp(s − m)·(1/l)``; ``dV = pᵀ`` rounded to dO's dtype ``·
  dO``; ``dS = (dO·vᵀ − di)·p·sm_scale``; ``dK = dS`` rounded to dO's dtype
  ``ᵀ·q``, ``dQ = dS`` rounded to k's dtype ``·k``; f32 sums, cast once.
  Its two halves, :func:`flash_attention_bwd_dkv_reference` and
  :func:`flash_attention_bwd_dq_reference`, are the two kernels' plain
  versions; :func:`flash_attention_bwd_bound` gives the scale of their
  tolerance on the card, and :func:`flash_attention_bwd_order_bound` the
  term that the tensor-core build's order of dP's f32 sums adds to it.

:func:`flash_attention` goes through the custom op ``tftpu::flash_attention``:

* on a CUDA tensor the op launches one of two forward kernels, as
  :func:`forward_build` chooses — ``csrc/flash_attention_mma.cu`` (bf16
  on the tensor cores) or ``csrc/flash_attention.cu`` (scalar f32 FMAs:
  f32 inputs and the bf16 rows the other cannot copy) — or raises: there
  is no fallback. Both read q/k/v at their own strides, so the
  ``[b, s, 3, h, d] → [b, h, s, d]`` views the encoder passes are not
  copied; the output is a ``[b, h, s, d]`` view of a ``[b, s, h, d]``
  buffer, so the encoder's transpose back is free. When a gradient will
  be taken (grad mode on and an input that requires it) the kernel also
  writes ``l`` and ``m``; otherwise it writes neither;
* on a CPU tensor it computes the plain version;
* its fake implementation serves the program's shape analysis;
* its vmap rule folds the vmapped dim into the batch dim and calls the
  op once, so ``map_rows`` launches one kernel per layer per block, not
  one per row;
* its gradient (``register_autograd``) computes ``di`` with one torch
  reduction and calls ``tftpu::flash_attention_bwd_dkv`` and
  ``tftpu::flash_attention_bwd_dq``, which on a CUDA tensor launch one of
  two builds of each, as :func:`backward_build` chooses —
  ``csrc/flash_attention_bwd_mma.cu`` (bf16 on the tensor cores) or
  ``csrc/flash_attention_bwd.cu`` (scalar f32 FMAs) — and compute the
  plain backward on a CPU tensor. Gradients of the gradient raise, as
  upstream's do; gradients under vmap are not supported.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from . import check, launch_target, library

MAX_HEAD_DIM = 128
MASK_VALUE = -0.7 * float(np.finfo(np.float32).max)  # upstream's DEFAULT_MASK_VALUE


def default_scale(head_dim: int) -> float:
    """``1/√head_dim`` as an f32 value, the scale both versions apply."""
    return float(np.float32(1.0 / math.sqrt(head_dim)))


def _causal_keep(sq: int, sk: int, device) -> torch.Tensor:
    """``[sq, sk]`` bool, True where ``col <= row``."""
    return torch.arange(sk, device=device)[None, :] <= torch.arange(sq, device=device)[:, None]


def flash_attention_fwd_reference(q, k, v, causal: bool = False, sm_scale: float = 1.0):
    """Dense attention in the upstream flash kernel's order of roundings,
    with its residuals: ``s = (q·kᵀ in f32) * sm_scale``; causal positions
    ``col > row`` get the mask value; f32 max ``m`` and ``p = exp(s − m)``,
    ``l = Σ p``; ``p`` cast to ``v.dtype`` before ``P·V``, which accumulates
    in f32; times ``1/l`` (1 where ``l`` is 0); cast to ``q.dtype``.
    Returns ``(o, l, m)``, ``l`` and ``m`` f32 ``[b, h, sq]``."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    if causal:
        s = s.masked_fill(~_causal_keep(*s.shape[-2:], q.device), MASK_VALUE)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    inv = torch.where(l == 0, torch.ones_like(l), 1.0 / l)
    return (o * inv).to(q.dtype), l[..., 0], m[..., 0]


def flash_attention_reference(q, k, v, causal: bool = False, sm_scale: float = 1.0):
    """The output of :func:`flash_attention_fwd_reference` alone."""
    return flash_attention_fwd_reference(q, k, v, causal, sm_scale)[0]


def _p(q, k, l, m, causal: bool, sm_scale: float):
    """The backward's f32 ``p`` ``[b, h, sq, sk]`` from the residuals."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    p = torch.exp(s - m[..., None]) * (1.0 / l)[..., None]
    if causal:
        p = p.masked_fill(~_causal_keep(*s.shape[-2:], q.device), 0.0)
    return p


def _p_ds(q, k, v, l, m, do, di, causal: bool, sm_scale: float):
    """The backward's f32 ``p`` and ``dS`` ``[b, h, sq, sk]`` from the
    residuals, in upstream's order of roundings."""
    p = _p(q, k, l, m, causal, sm_scale)
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), v.float())
    return p, (dp - di[..., None]) * p * sm_scale


def flash_attention_bwd_dkv_reference(q, k, v, l, m, do, di, causal: bool = False,
                                      sm_scale: float = 1.0):
    """Plain version of the dK/dV kernel: ``(dk, dv)`` from the residuals
    ``l``, ``m`` and ``di = Σ o·dO`` (f32 ``[b, h, sq]`` each)."""
    p, ds = _p_ds(q, k, v, l, m, do, di, causal, sm_scale)
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(do.dtype).float(), do.float())
    dk = torch.einsum("bhqk,bhqd->bhkd", ds.to(do.dtype).float(), q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_dq_reference(q, k, v, l, m, do, di, causal: bool = False,
                                     sm_scale: float = 1.0):
    """Plain version of the dQ kernel."""
    _, ds = _p_ds(q, k, v, l, m, do, di, causal, sm_scale)
    return torch.einsum("bhqk,bhkd->bhqd", ds.to(k.dtype).float(), k.float()).to(q.dtype)


def flash_attention_di(o, do) -> torch.Tensor:
    """``Σ_d o·dO`` in f32, ``[b, h, sq]`` contiguous (upstream computes it
    outside its kernels, as here)."""
    return (o.float() * do.float()).sum(dim=-1).contiguous()


def flash_attention_bwd_reference(q, k, v, o, l, m, do, causal: bool = False,
                                  sm_scale: float = 1.0):
    """Plain version of both backward kernels: ``(dq, dk, dv)`` of
    :func:`flash_attention_fwd_reference`'s ``o`` for the output gradient
    ``do``, from its residuals ``l`` and ``m``."""
    di = flash_attention_di(o, do)
    dk, dv = flash_attention_bwd_dkv_reference(q, k, v, l, m, do, di, causal, sm_scale)
    return flash_attention_bwd_dq_reference(q, k, v, l, m, do, di, causal, sm_scale), dk, dv


def flash_attention_bwd_bound(q, k, v, o, l, m, do, causal: bool = False,
                              sm_scale: float = 1.0):
    """``(A_dq, A_dk, A_dv)`` = ``(|dS|·|k|, |dS|ᵀ·|q|, pᵀ·|dO|)`` in f32:
    the backward's sums taken over absolute values. Where the kernels and
    their plain versions round ``p`` or ``dS`` to neighbouring values of
    the working dtype, each gradient moves by at most one step of its A
    (2^-7 relative in bf16), and the final rounding by one step of the
    gradient itself: the card's checks allow twice that."""
    p, ds = _p_ds(q, k, v, l, m, do, flash_attention_di(o, do), causal, sm_scale)
    ds = ds.abs()
    return (torch.einsum("bhqk,bhkd->bhqd", ds, k.float().abs()),
            torch.einsum("bhqk,bhqd->bhkd", ds, q.float().abs()),
            torch.einsum("bhqk,bhqd->bhkd", p, do.float().abs()))


F32_UNIT = 2.0 ** -24  # unit roundoff of f32 rounding to nearest
DP_ORDER_C = 4        # E's factor on gamma_d: see flash_attention_bwd_order_bound


def flash_attention_bwd_order_bound(q, k, v, l, m, do, causal: bool = False,
                                    sm_scale: float = 1.0):
    """``(E_dq, E_dk, E_dv)`` = ``(e·|k|, eᵀ·|q|, 0)`` in f32, with ``e_ij
    = c·γ_d·(|dO|·|v|ᵀ)_ij·p_ij·sm_scale``, ``γ_d = d·u / (1 − d·u)``, ``u
    = 2^-24``, ``d`` the head_dim and ``c`` = :data:`DP_ORDER_C` = 4: the
    term that the f32 summation order of ``dP = dO·vᵀ`` adds to the gap
    between a backward kernel and its plain version, beyond
    :func:`flash_attention_bwd_bound`'s ``A``.

    Derivation. Each of dP's ``d`` products is of two bf16 values (8
    significant bits each), so it is exact in f32 (24 bits). A sum of
    ``d`` terms taken in any order of f32 additions that round to nearest
    lies within ``γ_d·Σ|terms|`` of the exact sum, here ``γ_d·(|dO|·|v|ᵀ)``.
    The kernel and the plain version each commit that error in their own
    order, so their dP differ by up to twice it. ``di`` is one tensor that
    both read, so it adds nothing, and ``dS = (dP − di)·p·sm_scale`` carries
    the gap times ``p·sm_scale``: that is ``e`` with ``c = 2``. Where ``dP −
    di`` cancels, the plain version's dS and A are 0 (the causal first
    row, whose o is v's first row, is one such place) while the kernel's
    dS is not, so ``A`` cannot hold this term. ``c = 4`` takes the kernel's
    side at twice the plain one's: PTX does not promise round-to-nearest
    inside an ``mma``'s accumulation, and an accumulator that aligns its
    addends to the largest one and truncates loses less than ``2u`` of
    the largest addend on each of the others, which for blocks of ``k``
    products summed at once with the accumulator keeps it within
    ``2·(1 + 1/k)·γ_d``, at most ``2.5·γ_d`` for ``k ≥ 4``. With the plain
    side's ``γ_d`` (an f32 GEMM that rounds to nearest) that is at most
    ``3.5·γ_d``; what is left of 4 covers dS's rounding to bf16 and the
    gradient's own rounding where ``ref`` and ``A`` are 0.
    ``E_dq`` and ``E_dk`` are ``e`` summed through the dS products
    (``dQ = dS·k``, ``dK = dSᵀ·q``); dV does not read dP (``E_dv = 0``).

    The f32 order of ``s = q·kᵀ`` moves p too, but by a factor: p =
    exp(s·sm_scale − m)/l moves by ``exp(±δ)``, ``δ = c·γ_d·(|q|·|k|ᵀ)
    ·sm_scale``, and dS with it, so both stay within a step of their
    rounded values. ``A`` already allows each side's p and dS to land on
    a neighbouring bf16 value, which holds while ``δ`` stays below half of
    bf16's smallest relative step, 2^-9. At the gates' shapes (standard
    normal q and k, head_dim up to 128) ``δ`` stays several times below
    that; this raises ``ValueError`` where it does not, since ``A`` then no
    longer covers it, and for inputs other than bfloat16, whose products
    the derivation needs exact."""
    if {t.dtype for t in (q, k, v, do)} != {torch.bfloat16}:
        raise ValueError("flash_attention_bwd_order_bound: derived for bfloat16 q/k/v/dO, "
                         "whose products are exact in f32")
    d = q.shape[-1]
    gamma = d * F32_UNIT / (1.0 - d * F32_UNIT)
    qa, ka = q.float().abs(), k.float().abs()
    qk = torch.einsum("bhqd,bhkd->bhqk", qa, ka)
    if causal:
        qk = qk.masked_fill(~_causal_keep(*qk.shape[-2:], q.device), 0.0)
    move = DP_ORDER_C * gamma * float(qk.max()) * sm_scale if qk.numel() else 0.0
    if move > 2.0 ** -9:
        raise ValueError(
            f"flash_attention_bwd_order_bound: s's summation order moves p by up to "
            f"{move:.3g} (relative), beyond the 2^-9 that A covers"
        )
    del qk
    e = torch.einsum("bhqd,bhkd->bhqk", do.float().abs(), v.float().abs())
    e = e * _p(q, k, l, m, causal, sm_scale) * (DP_ORDER_C * gamma * sm_scale)
    return (torch.einsum("bhqk,bhkd->bhqd", e, ka),
            torch.einsum("bhqk,bhqd->bhkd", e, qa),
            torch.zeros(v.shape, dtype=torch.float32, device=v.device))


def _out_like(q: torch.Tensor) -> torch.Tensor:
    """An uninitialised ``[b, h, s, d]`` tensor, laid out as ``[b, s, h, d]``."""
    b, h, s, d = q.shape
    return q.new_empty((b, s, h, d)).transpose(1, 2)


def _stats_like(q: torch.Tensor, stats: bool) -> torch.Tensor:
    """An uninitialised f32 ``[b, h, sq]`` buffer for ``l`` or ``m``, or
    ``[b, h, 0]`` when no statistics are kept."""
    b, h, sq, _ = q.shape
    return q.new_empty((b, h, sq if stats else 0), dtype=torch.float32)


@torch.library.custom_op("tftpu::flash_attention", mutates_args=())
def _flash_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
              sm_scale: float, stats: bool) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    if q.device.type != "cuda":
        if not stats:
            o = flash_attention_reference(q, k, v, causal, sm_scale)
            return _out_like(q).copy_(o), _stats_like(q, False), _stats_like(q, False)
        o, l, m = flash_attention_fwd_reference(q, k, v, causal, sm_scale)
        return _out_like(q).copy_(o), l.contiguous(), m.contiguous()
    return _launch(q, k, v, causal, sm_scale, stats)


@_flash_op.register_fake
def _flash_fake(q, k, v, causal, sm_scale, stats):
    return _out_like(q), _stats_like(q, stats), _stats_like(q, stats)


def _fold(n: int, t: torch.Tensor, dim):
    t = t.movedim(dim, 0) if dim is not None else t.expand(n, *t.shape)
    return t.reshape(n * t.shape[1], *t.shape[2:])


@_flash_op.register_vmap
def _flash_vmap(info, in_dims, q, k, v, causal, sm_scale, stats):
    """Fold the vmapped dim into the batch dim: one op call for the whole
    vmapped batch; each of ``o``, ``l``, ``m`` unfolds again."""
    n = info.batch_size
    outs = _flash_op(_fold(n, q, in_dims[0]), _fold(n, k, in_dims[1]), _fold(n, v, in_dims[2]),
                     causal, sm_scale, stats)
    return tuple(t.reshape(n, t.shape[0] // n, *t.shape[1:]) for t in outs), (0, 0, 0)


def _flash_setup(ctx, inputs, output):
    q, k, v, causal, sm_scale, _ = inputs
    o, l, m = output
    ctx.save_for_backward(q, k, v, o, l, m)
    ctx.causal, ctx.sm_scale = causal, sm_scale
    ctx.mark_non_differentiable(l, m)
    ctx.set_materialize_grads(False)  # l and m get no gradient: do not fill zeros for them


def _flash_grad(ctx, do, _dl, _dm):
    if torch.is_grad_enabled():
        raise NotImplementedError(
            "flash_attention: gradients of the gradient are not supported (as upstream's)"
        )
    q, k, v, o, l, m = ctx.saved_tensors
    if l.shape[-1] != q.shape[2]:
        raise RuntimeError(
            "flash_attention: the forward kept no softmax statistics (stats=False); "
            "call flash_attention() with grad mode on to differentiate it"
        )
    dq, dk, dv = flash_attention_backward(q, k, v, o, l, m, do, ctx.causal, ctx.sm_scale)
    return dq, dk, dv, None, None, None


_flash_op.register_autograd(_flash_grad, setup_context=_flash_setup)


@torch.library.custom_op("tftpu::flash_attention_bwd_dkv", mutates_args=())
def flash_attention_bwd_dkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            l: torch.Tensor, m: torch.Tensor, do: torch.Tensor,
                            di: torch.Tensor, causal: bool,
                            sm_scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """dK and dV (``[b, h, sk, d]``, laid out as ``[b, sk, h, d]``) from the
    residuals: the kernel on a CUDA tensor, its plain version on a CPU one."""
    if q.device.type != "cuda":
        dk, dv = flash_attention_bwd_dkv_reference(q, k, v, l, m, do, di, causal, sm_scale)
        return _out_like(k).copy_(dk), _out_like(v).copy_(dv)
    return _launch_dkv(q, k, v, l, m, do, di, causal, sm_scale)


@flash_attention_bwd_dkv.register_fake
def _bwd_dkv_fake(q, k, v, l, m, do, di, causal, sm_scale):
    return _out_like(k), _out_like(v)


@torch.library.custom_op("tftpu::flash_attention_bwd_dq", mutates_args=())
def flash_attention_bwd_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           l: torch.Tensor, m: torch.Tensor, do: torch.Tensor,
                           di: torch.Tensor, causal: bool, sm_scale: float) -> torch.Tensor:
    """dQ (laid out as ``[b, sq, h, d]``), as :func:`flash_attention_bwd_dkv`."""
    if q.device.type != "cuda":
        dq = flash_attention_bwd_dq_reference(q, k, v, l, m, do, di, causal, sm_scale)
        return _out_like(q).copy_(dq)
    return _launch_dq(q, k, v, l, m, do, di, causal, sm_scale)


@flash_attention_bwd_dq.register_fake
def _bwd_dq_fake(q, k, v, l, m, do, di, causal, sm_scale):
    return _out_like(q)


def flash_attention_backward(q, k, v, o, l, m, do, causal: bool, sm_scale: float):
    """``(dq, dk, dv)`` through the two backward ops: ``di`` by one torch
    reduction, then dK/dV and dQ (the kernels on a CUDA tensor, the plain
    backward on a CPU tensor)."""
    if do.dtype != q.dtype:
        raise ValueError(f"flash_attention backward: dO is {do.dtype}, q is {q.dtype}")
    di = flash_attention_di(o, do)
    dk, dv = flash_attention_bwd_dkv(q, k, v, l, m, do, di, causal, sm_scale)
    return flash_attention_bwd_dq(q, k, v, l, m, do, di, causal, sm_scale), dk, dv


def _strides(t: torch.Tensor):
    return tuple(int(x) for x in t.stride()[:3])


def _unit_last(*ts):
    return tuple(t if t.stride(-1) == 1 else t.contiguous() for t in ts)


def _rows_aligned(t: torch.Tensor) -> bool:
    """Every ``[b, h, s]`` row of ``t`` starts on a 16-byte boundary: the
    data pointer does, and so does every stride of a dim longer than 1."""
    size = t.element_size()
    return t.data_ptr() % 16 == 0 and all(
        (st * size) % 16 == 0 for st, n in zip(t.stride()[:3], t.shape[:3]) if n > 1)


def forward_build(q, k, v) -> str:
    """The forward kernel a CUDA call launches: ``"mma"`` or ``"scalar"``.

    ``"mma"`` (``csrc/flash_attention_mma.cu``, the tensor cores) takes
    bfloat16 q/k/v (with a unit last stride) whose rows it copies into
    shared memory 16 bytes at a time: head_dim a multiple of 8, and every
    row of q, k and v starting on a 16-byte boundary. Everything else goes
    to ``"scalar"`` (``csrc/flash_attention.cu``): float32 inputs, which
    the tensor cores would take only as TF32 (10 mantissa bits, where the
    f32 gate allows 1e-5), and the bfloat16 inputs above that fail the
    rule. Both kernels compute the same function in the same order of
    roundings; this chooses between two kernels and is not a fallback.
    The encoder's and the training path's q/k/v — views of one ``[b, s,
    3, h, 64]`` bf16 tensor — take ``"mma"``."""
    if (q.dtype == torch.bfloat16 and q.shape[-1] % 8 == 0
            and all(_rows_aligned(t) for t in (q, k, v))):
        return "mma"
    return "scalar"


def backward_build(q, k, v, do) -> str:
    """The backward kernels a CUDA call launches: ``"mma"`` or ``"scalar"``.

    ``"mma"`` (``csrc/flash_attention_bwd_mma.cu``, the tensor cores) takes
    bfloat16 q/k/v/dO (with a unit last stride) whose rows it copies into
    shared memory 16 bytes at a time: head_dim a multiple of 8, and every
    row of q, k, v and dO starting on a 16-byte boundary. Everything else
    goes to ``"scalar"`` (``csrc/flash_attention_bwd.cu``): float32 inputs
    and the bfloat16 inputs that fail the rule. This is the forward's rule
    (:func:`forward_build`) with dO added; both builds compute the same
    function in the same order of roundings, and this chooses between two
    kernels: it is not a fallback. The training path's q/k/v (views of one
    ``[b, s, 3, h, 64]`` bf16 tensor) and dO take ``"mma"``."""
    if (q.dtype == torch.bfloat16 and q.shape[-1] % 8 == 0
            and all(_rows_aligned(t) for t in (q, k, v, do))):
        return "mma"
    return "scalar"


def _launch(q, k, v, causal: bool, sm_scale: float, stats: bool):
    b, h, sq, d = (int(x) for x in q.shape)
    sk = int(k.shape[2])
    q, k, v = _unit_last(q, k, v)
    out, l, m = _out_like(q), _stats_like(q, stats), _stats_like(q, stats)
    if b == 0 or sq == 0:
        return out, l, m
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            l.data_ptr() if stats else None, m.data_ptr() if stats else None, b, h, sq, sk, d,
            *_strides(q), *_strides(k), *_strides(v), *_strides(out),
            float(sm_scale), int(causal))
    if forward_build(q, k, v) == "mma":
        rc = library().tft_flash_attention_mma(*args, *launch_target(q.device))
        check("flash_attention", rc, "flash_attention_mma")
    else:
        rc = library().tft_flash_attention(*args, int(q.dtype == torch.bfloat16),
                                           *launch_target(q.device))
        check("flash_attention", rc)
    return out, l, m


def _bwd_inputs(q, k, v, l, m, do, di):
    """q/k/v/dO with a unit last stride, the statistics f32 and contiguous;
    raises on what the kernels do not take."""
    if {k.dtype, v.dtype, do.dtype} != {q.dtype} or q.dtype not in (torch.bfloat16,
                                                                   torch.float32):
        raise ValueError(
            f"flash_attention backward: the kernels take bfloat16 or float32 q/k/v/dO of one "
            f"dtype; got {q.dtype}/{k.dtype}/{v.dtype}/{do.dtype}"
        )
    b, h, sq, _ = q.shape
    for name, t in (("l", l), ("m", m), ("di", di)):
        if t.dtype != torch.float32 or tuple(t.shape) != (b, h, sq):
            raise ValueError(
                f"flash_attention backward: {name} must be float32 {(b, h, sq)}; got "
                f"{t.dtype} {tuple(t.shape)}"
            )
    if tuple(do.shape) != tuple(q.shape):
        raise ValueError(f"flash_attention backward: dO {tuple(do.shape)} is not q's shape")
    return (*_unit_last(q, k, v, do), l.contiguous(), m.contiguous(), di.contiguous())


def _launch_dkv(q, k, v, l, m, do, di, causal: bool, sm_scale: float):
    q, k, v, do, l, m, di = _bwd_inputs(q, k, v, l, m, do, di)
    b, h, sq, d = (int(x) for x in q.shape)
    sk = int(k.shape[2])
    dk, dv = _out_like(k), _out_like(v)
    if b == 0:
        return dk, dv
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), l.data_ptr(), m.data_ptr(),
            di.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h, sq, sk, d,
            *_strides(q), *_strides(k), *_strides(v), *_strides(do), *_strides(dk),
            *_strides(dv), float(sm_scale), int(causal))
    if backward_build(q, k, v, do) == "mma":
        rc = library().tft_flash_attention_bwd_dkv_mma(*args, *launch_target(q.device))
        check("flash_attention_bwd_dkv", rc, "flash_attention_bwd_dkv_mma")
    else:
        rc = library().tft_flash_attention_bwd_dkv(*args, int(q.dtype == torch.bfloat16),
                                                   *launch_target(q.device))
        check("flash_attention_bwd_dkv", rc)
    return dk, dv


def _launch_dq(q, k, v, l, m, do, di, causal: bool, sm_scale: float):
    q, k, v, do, l, m, di = _bwd_inputs(q, k, v, l, m, do, di)
    b, h, sq, d = (int(x) for x in q.shape)
    sk = int(k.shape[2])
    dq = _out_like(q)
    if b == 0 or sq == 0:
        return dq
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), l.data_ptr(), m.data_ptr(),
            di.data_ptr(), dq.data_ptr(), b, h, sq, sk, d,
            *_strides(q), *_strides(k), *_strides(v), *_strides(do), *_strides(dq),
            float(sm_scale), int(causal))
    if backward_build(q, k, v, do) == "mma":
        rc = library().tft_flash_attention_bwd_dq_mma(*args, *launch_target(q.device))
        check("flash_attention_bwd_dq", rc, "flash_attention_bwd_dq_mma")
    else:
        rc = library().tft_flash_attention_bwd_dq(*args, int(q.dtype == torch.bfloat16),
                                                  *launch_target(q.device))
        check("flash_attention_bwd_dq", rc)
    return dq


def flash_attention_fwd(q, k, v, causal: bool, sm_scale: float):
    """``(o, l, m)``: the forward with its residuals (``l``, ``m`` f32
    ``[b, h, sq]``), as the gradient saves them."""
    return _flash_op(q, k, v, causal, sm_scale, True)


def flash_attention(q, k, v, causal: bool = False) -> torch.Tensor:
    """``softmax(q·kᵀ/√d)·v`` for ``q [b, h, sq, d]`` and ``k, v
    [b, h, sk, d]`` of one dtype (bf16 or f32 on the card); the result
    ``[b, h, sq, d]`` in ``q.dtype``, differentiable in q, k and v. Causal
    masks ``col > row``. A CUDA input the kernels cannot take (another
    dtype, head_dim above 128, no keys) raises."""
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
    stats = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    return _flash_op(q, k, v, bool(causal), default_scale(int(d)), stats)[0]
