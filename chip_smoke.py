#!/usr/bin/env python3
"""Chip smoke for tensorframes_tpu_torch: build the CUDA kernels, hold each
against its plain PyTorch version on the card, then drive the five verbs,
the decode server, BERT-base embedding extraction, gpt_small training,
Inception-v3 scoring (native, and from a frozen GraphDef this script
writes) and VGG-16 scoring through the package's entry points at full
size on one GPU.

    python3 chip_smoke.py

Needs one CUDA GPU and ``nvcc`` (the kernels build on first use into
``build/torch_kernels/``, one ``nvcc`` per source, all at once). Exits nonzero, printing no result, when no GPU
is visible or when the package is not beside this script. After the
build it prints the ptxas registers and spills of each flash forward and
backward build, of both int8_matmul builds, of decode_attention and of the
segment kernels' two launches (seg_fold, seg_merge).
Phases:

1. kernels against their plain versions at the main path's shapes:
   ``segment_reduce`` (10M rows, 4096 groups: f32 sum and mean, f32 [n, 8]
   max, int32 sum), ``segment_sum`` (f32 [10M, 8]) and ``ragged_gather``
   (200,000 f32 rows of lengths 16/32/64/128 in 4 groups; and 200,000 rows
   of lengths 1-256 in 256 groups, in f32 and in bf16: every group
   bit-exact, one launch a call, timed over its launches and as a whole
   call with its table upload; and 60,000 f32 rows of 1-4 KB); both
   segment kernels
   again on three more feeds: one key holding half of the 10M rows, the
   logreg scores [262,144, 10] over 10 labels, and 16 f32 [100,000, 64]
   columns (max and sum) over 256 groups, each exact where it must be,
   within tolerance of float64 sums elsewhere, its float sums bit-exact
   against the kernel-order emulation and relaunched bit for bit, timed
   beside its plain version, library calls and byte bound; device times per
   call (ten calls queued behind a spin kernel and timed by CUDA events,
   so the card runs them back to back whatever the host's launch rate)
   for the kernel, the plain version and one PyTorch library call per
   (column, op) (``index_add_``/``scatter_reduce``, or ``index_select`` on
   an unfolded view for the gather); then the decode
   server's kernels in bf16 at gpt_small's shapes: ``int8_matmul`` at
   every (k, n) of a layer for m in {1, 16, 128}, a ragged m and an f32
   case, each through the build ``int8_matmul_build`` must choose
   (counted: bf16 on the tensor cores, f32 on the scalar kernel), twice
   bit for bit, a row's bits the same at every m, three broken plain
   versions (the last 16 k rows, the scale, the last k-split dropped)
   outside the tolerance (timed: one layer's four products at m = 16, m
   = 1 and 128 logged; library: ``torch.matmul`` on a pre-widened bf16
   weight), and ``decode_attention`` at 1 and 16 slots over a 193-page
   pool and at 4 slots of 64-page tables (past its staging buffer), twice
   bit for bit, each slot alone equal to the batch's, two broken plain
   versions outside the tolerance (timed at 16; library:
   ``scaled_dot_product_attention`` over pages already gathered and
   dequantized, the gather not timed); ``flash_attention``
   at [1024, 12, 128, 64] bf16 (q/k/v the encoder's strided views of one
   qkv tensor), [4, 8, 4096, 128] bf16 causal, [3, 4, 200, 64] f32
   causal and [2, 8, 333, 80] bf16 causal, within a tolerance that three
   deliberately broken plain versions must exceed, each through the build
   it must reach (bf16 on the tensor cores, f32 on the scalar kernel) and
   twice with the same bits (timed at the first shape; the bench shape,
   the training path's with and without l and m, and an f32 one logged;
   library: ``scaled_dot_product_attention``); the flash backward's dK/dV
   and dQ kernels at [1024, 12, 128, 64] bf16 (strided views), [8, 12,
   1024, 64] bf16 causal (the training path's), [2, 8, 1000, 128] bf16
   causal, [2, 6, 333, 80] bf16 causal against 200 keys, [2, 3, 77, 36]
   bf16 causal and [3, 4, 1000, 128] f32 causal, from the forward
   kernel's own o, l and m (whose o must equal the forward without l and
   m bit for bit and lie within the forward's tolerance of the plain
   forward, which the three broken forward versions exceed at these
   shapes too), each through the build it must reach (counted: the
   tensor cores for bf16 with head_dims that are multiples of 8, the
   scalar kernels for head_dim 36 and f32), within a tolerance (plus the
   term of dP's summation order on the tensor cores) that three
   deliberately broken plain backward versions must exceed four times
   over, two launches bit for bit (timed at the training shape; library:
   ``scaled_dot_product_attention``'s backward); ``quantize.matmul`` under
   ``torch.func.vmap`` must launch once and match the plain call's bits;
2. the main path with every launch count reset first: add-3
   ``map_blocks`` over 20M float64 rows, ``reduce_blocks`` sum/min over
   ``double[?,2]`` (10M rows), ``map_rows`` on fixed and ragged cells,
   full-width logreg scoring (262,144 × 784) and an aggregate of its
   scores by predicted label, the 10M-row aggregate above, and an
   aggregate mixing float32 and int64 sums (the per-op route). Each output
   is checked; every kernel of the path must have launched. Rows/s per
   verb follow. Then the ragged ``map_rows`` verb again on the main and
   wide-lengths feeds, serial (``map_pipeline_depth`` 0) and pipelined
   (the defaults): host wall, gather launches (one a call) and busy share
   of one call, the two modes' outputs equal. Then the generic (UDAF)
   ``aggregate``: 1,000,000 rows over 512 groups, a ``torch.logsumexp``
   of an f32 [n, 8] column and an int32 sum as plain-function fetches
   (buffer 10): int sums exact against ``np.add.at``, log-sum-exps within
   ``LSE_RTOL`` of a float64 host computation, wall, dispatches, rows/s.
   Then the relational frame ops over 10,000,000 rows (counts reset before
   each op): ``filter(x > 0.5)``, the filtered rows' keyed sum and max
   (``segment_reduce``) and sum beside an int64 sum (``segment_sum``);
   on a 1,000,000-row slice ``sort_values`` and an inner and a left
   ``join`` against 100,000 rows; ``drop_duplicates`` and
   ``group_by().count()``: every result against numpy, each op's host
   wall. Then the decode server's path, counts reset again: a
   ``Server`` with a gpt_small decode endpoint (int8 weights from seed 0,
   16 slots, 16-position pages, prompts <= 128, 64 new tokens) answers 32
   requests; the first 8 re-run solo must match exactly; an engine with a
   4-horizon pool must preempt and still return the same tokens; the
   kernels must have launched 12 (attention) and 48 (matmul, every one on
   its tensor-core build) times per step; one 16-slot step's logits,
   kernel path against plain path on the same pool, within a tolerance
   that three deliberately broken plain
   paths must exceed. Tokens/s, TTFT (each request's own, from its
   future) and step time follow. Then BERT-base embedding extraction with
   flash attention (f32 weights from seed 0, 1,024 rows of 128 tokens):
   ``map_rows`` and ``map_blocks`` must launch the flash kernel 12 times
   per call, all on its tensor-core build, agree with each other and with dense attention through the
   same verb, while an attention that drops the last key tile must not;
   a 64-row ``map_rows`` over int8 weights must launch 48 int8 and 12
   flash kernels, all on their tensor-core builds. Rows/s per verb
   follow. Then gpt_small training with
   flash attention (f32 weights from seed 0, AdamW at lr 1e-3):
   ``training.train_on_frame`` takes 10 steps of 8 x 1024 tokens off a
   16-row frame, counts reset first; every step must launch the flash
   forward, dK/dV and dQ kernels 12 times each, all on their tensor-core
   builds, receive the batch
   ``iterate_batches`` gives, and the loss must be finite, start near
   ln(32,000) and fall; a ``remat=True`` step launches the forward 24
   times and each backward kernel 12, on the tensor cores; one step's
   loss and gradients with flash agree with dense attention, and steps
   whose backward is one of the broken versions do not. Steps/s, tokens/s and peak memory follow.
   Then Inception-v3 at full width (299x299, bf16, weights from seed 0,
   each conv's folded-BN scale and bias drawn at random):
   1,024 synthetic images in two host blocks of 512 through
   ``map_blocks`` (a warm-up call, then a timed one: rows/s, peak
   memory); block 0 equal to a direct ``forward``; on 64 images the bf16
   logits within ``INCEPTION_RTOL`` of an f32 forward of the same weights
   (TF32 off in cuDNN and cuBLAS), labels equal where the margin is
   clear, three broken forwards outside; a 64-image int8 leg
   (``quantize_params``) within the same tolerance of the f32 forward of
   its dequantized weights. Then the block pipeline on the same images in
   8 blocks of 128, serial (``map_pipeline_depth`` and
   ``map_prefetch_depth`` 0) and pipelined (2 and 2): rows/s, peak device
   memory, peak pinned host bytes, a profiled call's ``Memcpy HtoD`` and
   the part of it under kernels, busy share; the two outputs equal bit
   for bit. Then the same network (f32 weights) as a
   frozen NHWC GraphDef written here with no TensorFlow
   (``inception_graphdef``: Conv2D → Mul → AddV2 → Relu per conv, the
   pools, ConcatV2, Mean, MatMul + BiasAdd), read back by
   ``load_graphdef`` (bf16 on the card) and scored over the same 1,024
   images in two blocks of 512 (warm-up, then a timed call: rows/s, peak
   memory); on 64 images its logits within ``INCEPTION_RTOL`` of the f32
   forward of the weights it computes with, an f32 import within
   ``IMPORT_F32_RTOL`` of the f32 forward, labels equal where the margin
   is clear, a SAME AvgPool divided by the full window and a graph
   without the stem's first folded-BN ``Mul`` outside; a 64-image
   ``quantize_weights=True`` import launching ``int8_matmul`` once a call
   (scalar build) within ``INCEPTION_RTOL`` of the f32 forward of its
   dequantized weights. Then a graph of stride-2 SAME ops (Conv2D 3x3
   and 2x2, depthwise, MaxPool, AvgPool at sizes 17 and 16) in f32 on
   the card against the same import on the CPU within ``PAD_RTOL``, the
   split on the wrong side outside. Then VGG-16 (224x224 bf16, biases
   drawn at random): 512 images in two blocks of 256 through
   ``map_blocks(scoring_program)`` (warm-up, timed call); block 0 equal
   to a direct call, top-k equal to the sorted scores, bf16 logits within
   ``VGG_RTOL`` of an f32 forward with a dropped last-conv bias outside,
   a 64-image int8 leg launching ``int8_matmul`` 3 times a call (2 on the
   tensor-core build); ``save_program``/``load_program`` of the scoring
   program, the loaded one equal bit for bit at 4 and 16 images.
3. where the time goes: ``torch.profiler`` device time by kernel for
   each segment kernel alone, for two verbs (aggregate, map_blocks) and
   for a 16-slot decode step and for one BERT-base ``map_rows`` call
   (flash against the dense products and copies), and for one gpt_small
   training step (forward, backward and optimizer by CUDA events; GEMMs,
   the three flash kernels, norms, the embedding's backward), and for one
   Inception-v3 ``map_blocks`` call, native and imported (convolutions,
   pools, elementwise, host-to-device copies and the part of them under
   kernels, the top operations), with the device's busy share of each
   call's host wall time (the union of its busy intervals);
4. one JSON line listing every kernel, the card's name and power limit,
   and as the last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import re
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_BF16_FLOPS = 989e12    # dense bf16 tensor-core peak, H100 SXM data sheet
H100_F32_FLOPS = 67e12      # float32 outside the tensor cores, H100 SXM data sheet
SPIN_CYCLES = 100_000_000   # ~50 ms at the H100's ~2 GHz: longer than queuing 10 calls
SLICE1_KERNELS = ("segment_reduce", "segment_sum", "ragged_gather")
SERVING_KERNELS = ("decode_attention", "int8_matmul")
ENCODER_KERNELS = ("flash_attention",)
TRAINING_KERNELS = ("flash_attention", "flash_attention_bwd_dkv", "flash_attention_bwd_dq")
# every launch of a training step's flash kernel counted, and on its tensor-core build
TRAINING_BUILDS = (*TRAINING_KERNELS, "flash_attention_mma", "flash_attention_bwd_dkv_mma",
                   "flash_attention_bwd_dq_mma")


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, what: str, reps: int = 10) -> float:
    """Device time per call of ``fn``, after one warm-up call: ``reps``
    calls queued behind a spin kernel, between two CUDA events. The host
    queues them all while the card spins, so the card runs them back to
    back and the host's launch rate is not in the time. A call that waits
    on the card (a host sync) lets the card drain the queue first; then
    the time includes the host's share, and a line says so. (So do calls of
    hundreds of launches, which fill the card's queue of pending launches
    and stall the host until the spin ends: time those through
    :func:`graphed`.)"""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    queued = not start.query()  # the card still spun when the last call was queued
    end.synchronize()
    if not queued:
        log(f"# timing {what}: the card caught up with the host (the call syncs), so "
            "its time includes the host's share")
    return start.elapsed_time(end) / reps


def graphed(fn):
    """``fn``'s launches captured once into a CUDA graph, after a warm-up
    call; the graph's replay runs them all as one launch, so a call of
    hundreds of launches (one per length group) queues behind
    :func:`time_ms`'s spin. Returns the replay."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph.replay


def launch_counts(tft) -> dict:
    """Launches per kernel since the last reset, and per build
    (``flash_attention_mma``: the forward's launches on the tensor cores)."""
    return {**tft.kernels.LAUNCHES.snapshot(), **tft.kernels.LAUNCHES.builds()}


def bound_ms(nbytes: int) -> float:
    return nbytes / H100_BYTES_PER_S * 1e3


def roofline(nbytes: int, flops: int) -> dict:
    """The least time for the work: the larger of bytes over the memory
    rate and bf16 operations over the tensor-core peak."""
    b, f = bound_ms(nbytes), flops / H100_BF16_FLOPS * 1e3
    return {"bound_ms": max(b, f), "bound_by": "bytes" if b >= f else "operations"}


def float_close(got, ref, counts, vmax: float, mean: bool = False) -> float:
    """Max |got - ref|; fails past rtol 1e-5 / atol 1e-5·max|v|·√n for a
    group's sum of n rows (the kernel sums in another order than the plain
    version), and that atol over n, 1e-5·max|v|/√n, for its mean.
    ``counts`` holds the rows of each group, in the results' row order."""
    import torch

    got, ref = got.double(), ref.double()
    n = torch.as_tensor(counts).to(ref.device).double().clamp(min=1)
    n = n.reshape(-1, *([1] * (ref.ndim - 1)))
    diff = (got - ref).abs()
    tol = 1e-5 * ref.abs() + 1e-5 * vmax * (n.rsqrt() if mean else n.sqrt())
    if not bool((diff <= tol).all()):
        worst = int((diff - tol).argmax())
        fail(f"float result off by {float(diff.flatten()[worst])} where the tolerance "
             f"is {float(tol.flatten()[worst])}")
    return float(diff.max()) if diff.numel() else 0.0


def exact(got, ref, what: str) -> None:
    import torch

    if got.dtype != ref.dtype or not torch.equal(got, ref):
        fail(f"{what}: kernel and plain version differ")


# ---------------------------------------------------------------------------
# phase 1: kernels against their plain versions
# ---------------------------------------------------------------------------

SEGMENT_OPS = (("v_sum", "reduce_sum"), ("v_mean", "reduce_mean"),
               ("w", "reduce_max"), ("c", "reduce_sum"))


def segment_inputs(n: int, groups: int, dev):
    import torch

    g = torch.Generator(device=dev).manual_seed(SEED)
    ids = torch.randint(0, groups, (n,), generator=g, device=dev, dtype=torch.int32)
    v = torch.randn(n, generator=g, device=dev)
    w = torch.randn((n, 8), generator=g, device=dev)
    c = torch.randint(-1000, 1000, (n,), generator=g, device=dev, dtype=torch.int32)
    return ids, v, w, c


def check_segment_reduce(dev, n: int, groups: int) -> dict:
    import torch
    from tensorframes_tpu_torch.kernels import segment_reduce as ksr

    ids, v, w, c = segment_inputs(n, groups, dev)
    ops = SEGMENT_OPS
    cols = {"v_sum": v, "v_mean": v, "w": w, "c": c}
    got = ksr.segment_reduce(ops, groups, cols, ids)
    ref = ksr.segment_reduce_plain(ops, groups, cols, ids)
    _, kernel_counts = ksr.segment_reduce_tables(ops, groups, cols, ids)
    counts = torch.bincount(ids.long(), minlength=groups).to(torch.int32)
    torch.cuda.synchronize()
    exact(got["w"], ref["w"], "segment_reduce max")
    exact(got["c"], ref["c"], "segment_reduce int32 sum")
    exact(kernel_counts, counts, "segment_reduce count table")
    vmax = float(v.abs().max())
    err = max(float_close(got["v_sum"], ref["v_sum"], counts, vmax),
              float_close(got["v_mean"], ref["v_mean"], counts, vmax, mean=True))
    again = ksr.segment_reduce(ops, groups, cols, ids)
    for k in got:
        if not torch.equal(got[k], again[k]):
            fail(f"segment_reduce is not deterministic ({k})")

    def library():
        idx = ids.long()
        torch.zeros(groups, device=dev).index_add_(0, idx, v)
        torch.zeros(groups, device=dev).index_add_(0, idx, v)
        torch.full((groups, 8), float("-inf"), device=dev).scatter_reduce_(
            0, idx[:, None].expand(n, 8), w, reduce="amax")
        torch.zeros(groups, dtype=torch.int32, device=dev).index_add_(0, idx, c)

    nbytes = 4 * n + v.nbytes + w.nbytes + c.nbytes + groups * 11 * 4
    return {
        "max_abs_err": err,
        "ms": time_ms(lambda: ksr.segment_reduce(ops, groups, cols, ids), "segment_reduce"),
        "plain_ms": time_ms(lambda: ksr.segment_reduce_plain(ops, groups, cols, ids),
                            "segment_reduce plain"),
        "library_ms": time_ms(library, "segment_reduce library"),
        "bound_ms": bound_ms(nbytes),
        "bound_by": "bytes",
    }


def check_segment_sum(dev, n: int, groups: int) -> dict:
    import torch
    from tensorframes_tpu_torch.ops import segment as seg

    ids, _, w, _ = segment_inputs(n, groups, dev)
    got = seg.segment_sum_kernel(w, ids, groups)
    ref = seg.segment_sum_plain(w, ids, groups)
    torch.cuda.synchronize()
    err = float_close(got, ref, torch.bincount(ids.long(), minlength=groups),
                      float(w.abs().max()))
    if not torch.equal(got, seg.segment_sum_kernel(w, ids, groups)):
        fail("segment_sum is not deterministic")
    idx = ids.long()
    nbytes = 4 * n + w.nbytes + groups * 8 * 4
    return {
        "max_abs_err": err,
        "ms": time_ms(lambda: seg.segment_sum_kernel(w, ids, groups), "segment_sum"),
        "plain_ms": time_ms(lambda: seg.segment_sum_plain(w, ids, groups), "segment_sum plain"),
        "library_ms": time_ms(
            lambda: torch.zeros((groups, 8), device=dev).index_add_(0, idx, w),
            "segment_sum library"),
        "bound_ms": bound_ms(nbytes),
        "bound_by": "bytes",
    }


def f64_sums(v, ids, groups: int):
    """Float sums by group in float64, the reference for a leg whose groups
    hold millions of rows (an f32 sum over one accumulator, as the plain
    version's, drifts past the tolerance by itself there)."""
    import torch

    v = v.double().reshape(v.shape[0], -1)
    return torch.zeros((groups, v.shape[1]), dtype=torch.float64, device=v.device).index_add_(
        0, ids.long(), v)


def segment_leg(dev, what: str, ids, cols, ops, groups: int) -> dict:
    """One more feed through both segment kernels: ``segment_reduce`` over
    ``ops`` (min/max and integer sums exact against the plain version,
    float sums and means within ``float_close`` of the float64 sums, the
    raw float sums bit-exact against ``segment_sum_in_kernel_order``),
    ``segment_sum`` over the widest f32 column, each relaunched bit for bit;
    device times of both kernels, their plain versions and library calls,
    and their byte bounds."""
    import torch
    from tensorframes_tpu_torch.kernels import segment_reduce as ksr
    from tensorframes_tpu_torch.ops import segment as seg

    n = int(ids.shape[0])
    counts = torch.bincount(ids.long(), minlength=groups)
    got = ksr.segment_reduce(ops, groups, cols, ids)
    again = ksr.segment_reduce(ops, groups, cols, ids)
    ref = ksr.segment_reduce_plain(ops, groups, cols, ids)
    raw, _ = ksr.segment_reduce_tables(ops, groups, cols, ids)
    lanes = sum(1 if cols[x].ndim == 1 else int(cols[x].shape[1]) for x, _ in ops) + int(
        any(op == "reduce_mean" for _, op in ops))
    chunks = ksr.num_chunks(n, groups, lanes)
    torch.cuda.synchronize()
    err = 0.0
    for x, op in ops:
        if not torch.equal(got[x], again[x]):
            fail(f"segment_reduce {what}: not deterministic ({x})")
        if op in ("reduce_min", "reduce_max") or not cols[x].is_floating_point():
            exact(got[x], ref[x], f"segment_reduce {what} {x}")
            continue
        if not torch.equal(raw[x].reshape(groups, -1).cpu(),
                           ksr.segment_sum_in_kernel_order(cols[x], ids, groups, chunks)):
            fail(f"segment_reduce {what}: {x} is not summed in the kernel's order")
        want = f64_sums(cols[x], ids, groups).reshape(got[x].shape)
        if op == "reduce_mean":
            want = want / counts.reshape(-1, *([1] * (want.ndim - 1)))
        err = max(err, float_close(got[x], want, counts, float(cols[x].abs().max()),
                                   mean=op == "reduce_mean"))
    w2 = widest_f32(cols, ops)
    s_got = seg.segment_sum_kernel(w2, ids, groups)
    if not torch.equal(s_got, seg.segment_sum_kernel(w2, ids, groups)):
        fail(f"segment_sum {what}: not deterministic")
    if not torch.equal(s_got.cpu(), ksr.segment_sum_in_kernel_order(
            w2, ids, groups, ksr.num_chunks(n, groups, int(w2.shape[1])))):
        fail(f"segment_sum {what}: not summed in the kernel's order")
    err_sum = float_close(s_got, f64_sums(w2, ids, groups), counts, float(w2.abs().max()))
    idx = ids.long()

    def library():
        for x, op in ops:
            v = cols[x]
            if op in ("reduce_sum", "reduce_mean"):
                acc = torch.zeros((groups,) + tuple(v.shape[1:]), device=dev, dtype=v.dtype)
                acc.index_add_(0, idx, v)
            else:
                v2 = v if v.ndim == 2 else v[:, None]
                torch.full((groups, v2.shape[1]), float("-inf"), device=dev).scatter_reduce_(
                    0, idx[:, None].expand_as(v2), v2,
                    reduce="amax" if op == "reduce_max" else "amin")

    distinct = {cols[x].data_ptr(): cols[x].nbytes for x, _ in ops}
    in_bytes = 4 * n + sum(distinct.values())
    out_lanes = sum(1 if cols[x].ndim == 1 else int(cols[x].shape[1]) for x, _ in ops)
    return {
        "segment_reduce": {
            "max_abs_err": err,
            "ms": time_ms(lambda: ksr.segment_reduce(ops, groups, cols, ids), f"segment_reduce {what}"),
            "plain_ms": time_ms(lambda: ksr.segment_reduce_plain(ops, groups, cols, ids),
                                f"segment_reduce {what} plain"),
            "library_ms": time_ms(library, f"segment_reduce {what} library"),
            "bound_ms": bound_ms(in_bytes + groups * out_lanes * 4), "bound_by": "bytes",
        },
        "segment_sum": {
            "max_abs_err": err_sum,
            "ms": time_ms(lambda: seg.segment_sum_kernel(w2, ids, groups), f"segment_sum {what}"),
            "plain_ms": time_ms(lambda: seg.segment_sum_plain(w2, ids, groups),
                                f"segment_sum {what} plain"),
            "library_ms": time_ms(
                lambda: torch.zeros((groups, w2.shape[1]), device=dev).index_add_(0, idx, w2),
                f"segment_sum {what} library"),
            "bound_ms": bound_ms(4 * n + w2.nbytes + groups * int(w2.shape[1]) * 4),
            "bound_by": "bytes",
        },
    }


def segment_feeds(dev) -> dict:
    """The segment kernels' feeds, ``{name: (ids, cols, ops, groups)}``: the
    main path's four columns over 4,096 groups with uniform keys
    (``main``) and with one key holding half of the 10M rows (``skew``),
    the logreg scores [262,144, 10] by label (``ten_groups``), and 16 f32
    [100,000, 64] columns, max and sum in turn, over 256 groups (``wide``:
    each column runs in two 32-lane slices)."""
    import torch

    g = torch.Generator(device=dev).manual_seed(SEED)
    ids, v, w, c = segment_inputs(10_000_000, 4096, dev)
    cols = {"v_sum": v, "v_mean": v, "w": w, "c": c}
    hot = torch.where(torch.rand(ids.shape, generator=g, device=dev) < 0.5,
                      torch.full_like(ids, 1234), ids)
    feeds = {"main": (ids, cols, SEGMENT_OPS, 4096), "skew": (hot, cols, SEGMENT_OPS, 4096)}
    n = 262_144
    labels = torch.randint(0, 10, (n,), generator=g, device=dev, dtype=torch.int32)
    scores = torch.randn((n, 10), generator=g, device=dev)
    feeds["ten_groups"] = (labels, {"scores": scores}, (("scores", "reduce_sum"),), 10)
    n = 100_000
    ids = torch.randint(0, 256, (n,), generator=g, device=dev, dtype=torch.int32)
    wide = {f"x{i}": torch.randn((n, 64), generator=g, device=dev) for i in range(16)}
    wide_ops = tuple((f"x{i}", "reduce_max" if i % 2 else "reduce_sum") for i in range(16))
    feeds["wide"] = (ids, wide, wide_ops, 256)
    return feeds


def widest_f32(cols, ops):
    """The f32 column of ``ops`` with the most elements, as [n, d]: the
    column a leg's ``segment_sum`` sums."""
    import torch

    w = max((cols[x] for x, _ in ops if cols[x].dtype == torch.float32), key=lambda t: t.numel())
    return w if w.ndim == 2 else w[:, None]


def segment_legs(dev) -> dict:
    """Phase 1's segment legs beyond the main path's feed: ``segment_leg``
    over the skew, 10-group and wide feeds of ``segment_feeds``."""
    feeds = segment_feeds(dev)
    del feeds["main"]
    return {name: segment_leg(dev, name, *feed) for name, feed in feeds.items()}


RAGGED_ROWS = 200_000


def ragged_cells(n_rows: int, wide: bool = False):
    """Seeded row lengths, their starts in one flat buffer and the buffer's
    float32 values: lengths drawn from {16, 32, 64, 128} (the main feed),
    or uniformly from 1-256 (``wide``: ragged token or embedding rows of
    every length, as tokenized text reaches ``map_rows``)."""
    import numpy as np

    rng = np.random.default_rng(SEED)
    if wide:
        lens = rng.integers(1, 257, size=n_rows)
    else:
        lens = rng.choice(np.array([16, 32, 64, 128]), size=n_rows)
    flat = rng.standard_normal(int(lens.sum()), dtype=np.float32)
    starts = np.zeros(n_rows, np.int64)
    np.cumsum(lens[:-1], out=starts[1:])
    return lens, starts, flat


def ragged_groups(lens, starts) -> list:
    """The groups the ragged ``map_rows`` verb gathers: one per length,
    its starts bucket-padded with rows at offset 0."""
    import numpy as np
    from tensorframes_tpu_torch.ops.executor import bucket_rows

    groups = []
    for L in np.unique(lens):
        idx = np.flatnonzero(lens == L)
        st = np.zeros(bucket_rows(len(idx)), np.int32)
        st[:len(idx)] = starts[idx]
        groups.append((st, int(L)))
    return groups


LONG_ROWS = 60_000


def ragged_feeds(dev) -> dict:
    """``{name: (flat buffer on dev, groups)}``: the main path's feed (4
    length groups, f32); the wide-lengths feed (256 groups, a ~103 MB f32
    buffer, larger than the 50 MB L2) in f32 and in bf16, whose odd starts
    put rows at 2-byte offsets; and 60,000 f32 rows of 1, 2 or 4 KB
    (lengths 256, 512, 1,024, every row 16-byte aligned: the long rows on
    which bulk copies were weighed against the vector path, PERF.md)."""
    import numpy as np
    import torch

    lens, starts, flat = ragged_cells(RAGGED_ROWS)
    feeds = {"main": (torch.from_numpy(flat).to(dev), ragged_groups(lens, starts))}
    lens, starts, flat = ragged_cells(RAGGED_ROWS, wide=True)
    wide = torch.from_numpy(flat).to(dev)
    groups = ragged_groups(lens, starts)
    feeds["wide_f32"] = (wide, groups)
    feeds["wide_bf16"] = (wide.to(torch.bfloat16), groups)
    rng = np.random.default_rng(SEED)
    lens = rng.choice(np.array([256, 512, 1024]), size=LONG_ROWS)
    starts = np.zeros(LONG_ROWS, np.int64)
    np.cumsum(lens[:-1], out=starts[1:])
    flat = torch.from_numpy(rng.standard_normal(int(lens.sum()), dtype=np.float32)).to(dev)
    feeds["long_f32"] = (flat, ragged_groups(lens, starts))
    return feeds


def host_ms(fn, reps: int = 10) -> float:
    """Host wall time per call of ``fn`` through to the card's end of it
    (a synchronize after each call), after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def source_bytes(groups, n_flat: int, es: int) -> int:
    """The distinct bytes of an ``n_flat``-element buffer that ``groups``
    read: the union of every row's span, each byte once (padding rows
    re-read the first row's span, which then counts once)."""
    import numpy as np

    lo = np.concatenate([st for st, _ in groups]).astype(np.int64)
    hi = np.concatenate([st.astype(np.int64) + L for st, L in groups])
    depth = np.cumsum(np.bincount(lo, minlength=n_flat + 1) - np.bincount(hi, minlength=n_flat + 1))
    return int(np.count_nonzero(depth[:n_flat])) * es


def ragged_leg(dev, what: str, flat, groups) -> dict:
    """One feed's gather: every group bit-exact against the plain version,
    the launches a call takes (one per LAUNCH_BUDGET_BYTES of padded
    output), the kernel's device time over the call's launches (tables
    uploaded beforehand), the whole call's host wall (its table and starts
    uploaded each time), the plain version's and the library's device
    time over the groups (one call per group, replayed from a CUDA graph),
    and the byte bound (each output byte written once, each distinct
    source byte read once by :func:`source_bytes`, the starts read
    once)."""
    import torch
    from tensorframes_tpu_torch import kernels
    from tensorframes_tpu_torch.kernels import ragged_gather as krg

    es = flat.element_size()
    want_launches = len(krg.launch_groups([(len(st), L) for st, L in groups], es))
    before = kernels.LAUNCHES.snapshot()["ragged_gather"]
    outs = krg.ragged_gather_groups(flat, groups)
    torch.cuda.synchronize()
    per_call = kernels.LAUNCHES.snapshot()["ragged_gather"] - before
    if per_call != want_launches:
        fail(f"ragged_gather {what}: {per_call} launches a call, expected {want_launches}")
    dev_groups = [(torch.from_numpy(st).to(dev), L) for st, L in groups]
    err = 0.0
    for (st, L), got in zip(dev_groups, outs):
        plain = krg.gather_plain(flat, st, L)
        exact(got, plain, f"ragged_gather {what} length {L}")
        err = max(err, float((got.double() - plain.double()).abs().max()))
    del outs
    launches = krg.plan_launches(flat, groups)
    out_bytes = sum(len(st) * L * es for st, L in groups)
    in_bytes = source_bytes(groups, int(flat.shape[0]), es)
    nbytes = out_bytes + in_bytes + sum(4 * len(st) for st, _ in groups)
    return {
        "max_abs_err": err,
        "ms": time_ms(lambda: [krg.gather_launch(flat, launch) for launch in launches],
                      f"ragged_gather {what}"),
        "call_host_ms": host_ms(lambda: krg.ragged_gather_groups(flat, groups)),
        "plain_ms": time_ms(graphed(
            lambda: [krg.gather_plain(flat, st, L) for st, L in dev_groups]),
            f"ragged_gather {what} plain"),
        "library_ms": time_ms(graphed(
            lambda: [flat.unfold(0, L, 1).index_select(0, st.long()) for st, L in dev_groups]),
            f"ragged_gather {what} library"),
        "bound_ms": bound_ms(nbytes),
        "bound_by": "bytes",
        "launches_per_call": per_call,
        "groups": len(groups),
        "out_bytes": out_bytes,
        "in_bytes": in_bytes,
    }


def check_ragged_gather(dev) -> dict:
    """The main feed's leg (the kernel line's numbers), with the
    wide-lengths legs under ``legs``."""
    legs = {name: ragged_leg(dev, name, *feed) for name, feed in ragged_feeds(dev).items()}
    return {**legs.pop("main"), "legs": legs}


GEMM_SHAPES = ((768, 2304), (768, 768), (768, 3072), (3072, 768))  # a gpt_small layer


def bf16_ratio(got, ref, f32: bool = False) -> float:
    """max |got - ref| / tol, tol = 2^-7·|ref| + 1e-3·max|ref| in bf16 (the
    kernel sums in f32 in another order than the plain version, so an
    output may round to the neighbouring bf16 value) or rtol 1e-5 / atol
    1e-5·max|ref| in f32; <= 1 passes."""
    got, ref = got.double(), ref.double()
    scale = float(ref.abs().max())
    tol = (1e-5 if f32 else 2.0 ** -7) * ref.abs() + (1e-5 if f32 else 1e-3) * scale
    return float(((got - ref).abs() / tol).max())


def bf16_close(got, ref, what: str, f32: bool = False) -> float:
    """Max |got - ref|; fails past :func:`bf16_ratio`'s tolerance."""
    ratio = bf16_ratio(got, ref, f32)
    if not ratio <= 1:
        fail(f"{what}: off by {float((got.double() - ref.double()).abs().max())}, "
             f"{ratio} of the tolerance")
    return float((got.double() - ref.double()).abs().max())


def broken_int8_versions() -> dict:
    """Deliberately wrong plain int8 products ``(x, w) -> out``, for showing
    that the kernel gate sees a wrong kernel: the step gate's product that
    drops the last 16 k rows, one that drops the scale, and one that drops
    the last k-split of the tensor-core build's partition."""
    from tensorframes_tpu_torch.ops import quantize as tq

    def no_scale(x, w):
        return (x.float() @ w.q.float()).to(x.dtype)

    def last_split_dropped(x, w):
        chunk, splits = tq.int8_matmul_split(*w.q.shape)
        cut = (splits - 1) * chunk
        return tq.matmul_int8_plain(x[..., :cut], tq.QuantizedTensor(w.q[:cut], w.scale))

    return {"last 16 k rows dropped": broken_plain_paths()["matmul dropping its last k tile"][1],
            "scale dropped": no_scale, "last k-split dropped": last_split_dropped}


def int8_case(x, w, want: str, what: str) -> tuple:
    """One product through ``matmul_int8``, twice: the build ``want``
    (counted), the same bits both times, within :func:`bf16_ratio`'s
    tolerance of ``matmul_int8_plain`` (the f32 one for f32 x). Returns
    the output, max |err|, the share of the tolerance and each broken
    plain version's share."""
    import torch
    from tensorframes_tpu_torch import kernels
    from tensorframes_tpu_torch.ops import quantize as tq

    build = tq.int8_matmul_build(x, w)
    kernels.LAUNCHES.reset()
    got, again = tq.matmul_int8(x, w), tq.matmul_int8(x, w)
    counts = (kernels.LAUNCHES.snapshot()["int8_matmul"],
              kernels.LAUNCHES.builds()["int8_matmul_mma"])
    ref = tq.matmul_int8_plain(x, w)
    torch.cuda.synchronize()
    if build != want or counts != (2, 2 * (want == "mma")):
        fail(f"{what}: build {build}, launches (all, tensor cores) {counts}; want {want}")
    if not torch.equal(got, again):
        fail(f"{what}: two launches differ")
    f32 = x.dtype == torch.float32
    broken = {bw: bf16_ratio(fn(x, w), ref, f32) for bw, fn in broken_int8_versions().items()}
    return got, bf16_close(got, ref, what, f32=f32), bf16_ratio(got, ref, f32), broken


def check_int8_matmul(dev) -> dict:
    """Every (k, n) of a gpt_small layer at m = 1, 16 (slot counts), 128
    (the top prompt bucket) and a ragged 37 in bf16, plus an f32 case, each
    through the build ``int8_matmul_build`` must choose (counted: the tensor
    cores for bf16, the scalar kernel for f32), twice with the same bits;
    the bf16 rows are the first m of one 128-row x, and each row must come
    out with the same bits at every m. Three broken plain versions must
    land outside the tolerance at every case. The timed unit is one
    layer's four products at m = 16 (a 16-slot decode step's layer); the
    same at m = 1 and m = 128 is logged."""
    import numpy as np
    import torch
    from tensorframes_tpu_torch.ops import quantize as tq

    rng = np.random.default_rng(SEED)
    weights = {kn: tq.quantize(torch.from_numpy(
        (rng.standard_normal(kn) * kn[0] ** -0.5).astype(np.float32)).to(dev))
        for kn in GEMM_SHAPES}

    def xs(m, dtype=torch.bfloat16):
        return {kn: torch.from_numpy(rng.standard_normal((m, kn[0])).astype(np.float32)).to(
            dev, dtype) for kn in GEMM_SHAPES}

    err, worst = 0.0, 0.0
    broken = {what: float("inf") for what in broken_int8_versions()}
    x128 = xs(128)
    cases = [(m, torch.bfloat16) for m in (1, 16, 128, 37)] + [(16, torch.float32)]
    outs = {}
    for m, dtype in cases:
        xm = {kn: x[:m] for kn, x in x128.items()} if dtype == torch.bfloat16 else xs(m, dtype)
        for kn, x in xm.items():
            want = "mma" if dtype == torch.bfloat16 else "scalar"
            got, e, ratio, shares = int8_case(x, weights[kn], want,
                                              f"int8_matmul m={m} (k, n)={kn} {dtype}")
            err, worst = max(err, e), max(worst, ratio)
            broken = {bw: min(r, shares[bw]) for bw, r in broken.items()}
            if dtype == torch.bfloat16:
                outs[kn, m] = got
    for kn in GEMM_SHAPES:  # a row's bits at every m
        full = outs[kn, 128]
        if not all(torch.equal(outs[kn, m], full[:m]) for m in (1, 16, 37)):
            fail(f"int8_matmul (k, n)={kn}: a row's bits change with m")
    log(f"# int8_matmul: every bf16 case on the tensor cores and the f32 one on the scalar "
        f"kernel, two launches bit for bit, rows bit-equal at m = 1, 16, 37 and 128; the kernel "
        f"used at most {worst:.4g} of the tolerance; broken versions at least "
        + ", ".join(f"{w} {r:.4g}" for w, r in broken.items()))
    for what, r in broken.items():
        if r <= 1:
            fail(f"the int8_matmul gate cannot see a broken version ({what}: {r} <= 1)")
    wide = {kn: w.dequantize(torch.bfloat16) for kn, w in weights.items()}
    x16 = {kn: x[:16] for kn, x in x128.items()}

    def layer(fn, x):
        return lambda: [fn(x[kn], weights[kn]) for kn in GEMM_SHAPES]

    for m in (1, 128):
        xm = {kn: x[:m] for kn, x in x128.items()}
        log(f"# int8_matmul one layer's four products at m = {m}: kernel "
            f"{time_ms(layer(tq.matmul_int8, xm), f'int8_matmul m={m}'):.6f} ms, library "
            f"{time_ms(lambda: [xm[kn] @ wide[kn] for kn in GEMM_SHAPES], f'matmul m={m}'):.6f} "
            "ms")
    nbytes = sum(k * n + 4 * n + 2 * 16 * k + 2 * 16 * n for k, n in GEMM_SHAPES)
    legs = check_int8_model_products(dev)
    return {
        "max_abs_err": max(err, *(leg["max_abs_err"] for leg in legs.values())),
        "legs": legs,
        "ms": time_ms(layer(tq.matmul_int8, x16), "int8_matmul"),
        "plain_ms": time_ms(layer(tq.matmul_int8_plain, x16), "int8_matmul plain"),
        "library_ms": time_ms(lambda: [x16[kn] @ wide[kn] for kn in GEMM_SHAPES],
                              "int8_matmul library"),
        **roofline(nbytes, sum(2 * 16 * k * n for k, n in GEMM_SHAPES)),
    }


def check_int8_model_products(dev) -> dict:
    """The products that the VGG-16 and imported Inception-v3 int8 legs
    give the kernel, at their shapes and dtypes: each through the build
    that the leg takes (counted), twice with the same bits, against
    ``matmul_int8_plain`` within :func:`bf16_ratio`'s tolerance (the f32
    one for f32 x), with the three broken plain versions outside it at
    every product. Per product: the kernel, plain and library times and
    the bound (f32 operations at the CUDA cores' f32 peak)."""
    import numpy as np
    import torch
    from tensorframes_tpu_torch.ops import quantize as tq

    model_gemms = (  # (product, m, k, n, x dtype, build)
        ("vgg-16 fc6", VGG_CHECK, 25_088, 4_096, "bfloat16", "mma"),
        ("vgg-16 fc7", VGG_CHECK, 4_096, 4_096, "bfloat16", "mma"),
        ("vgg-16 fc8", VGG_CHECK, 4_096, 1_000, "bfloat16", "scalar"),
        # under bf16 the importer contracts the narrowed values in f32
        ("imported inception-v3 classifier", INC_CHECK, 2_048, 1_000, "float32", "scalar"),
    )
    rng = np.random.default_rng(SEED + 1)
    legs, broken = {}, {what: float("inf") for what in broken_int8_versions()}
    for what, m, k, n, dtype_name, want in model_gemms:
        dtype = getattr(torch, dtype_name)
        w = tq.quantize(torch.from_numpy(rng.standard_normal((k, n), dtype=np.float32)).to(
            dev) * k ** -0.5)
        x = torch.from_numpy(rng.standard_normal((m, k), dtype=np.float32)).to(dev, dtype)
        label = f"int8_matmul {what} [{m}, {k}] @ [{k}, {n}] {dtype_name}"
        _, err, ratio, shares = int8_case(x, w, want, label)
        broken = {bw: min(r, shares[bw]) for bw, r in broken.items()}
        f32 = dtype == torch.float32
        wide = w.dequantize(dtype)
        es = x.element_size()
        flops = 2 * m * k * n
        b = bound_ms(k * n + 4 * n + es * m * k + es * m * n)
        f = flops / (H100_F32_FLOPS if f32 else H100_BF16_FLOPS) * 1e3
        legs[what] = {
            "m": m, "k": k, "n": n, "dtype": dtype_name, "build": want,
            "max_abs_err": err, "share_of_tolerance": ratio,
            "ms": time_ms(lambda: tq.matmul_int8(x, w), label),
            "plain_ms": time_ms(lambda: tq.matmul_int8_plain(x, w), f"{label} plain"),
            "library_ms": time_ms(lambda: x @ wide, f"{label} library"),
            "bound_ms": max(b, f), "bound_by": "bytes" if b >= f else "operations",
        }
        del w, x, wide
    log("# int8_matmul model products: "
        + "; ".join(f"{w} {leg['build']} {leg['share_of_tolerance']:.4g} of the tolerance"
                    for w, leg in legs.items())
        + "; broken versions at least " + ", ".join(f"{w} {r:.4g}" for w, r in broken.items()))
    for what, r in broken.items():
        if r <= 1:
            fail(f"the int8_matmul gate cannot see a broken version at the model products "
                 f"({what}: {r} <= 1)")
    return legs


def paged_inputs(dev, S: int, pages: int = 193, layers: int = 12, nh: int = 12,
                 page: int = 16, hd: int = 64, maxp: int = 12):
    """A random int8 pool of the decode server's geometry, with S slots
    whose positions spread over the 192-position horizon on distinct
    pages; with S > 1 the last slot is padding (null table, position 0)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(SEED + S)
    kv = [torch.from_numpy(rng.integers(-127, 128, (pages, layers, nh, page, hd)).astype(
        np.int8)).to(dev) for _ in range(2)]
    sc = [torch.from_numpy(rng.uniform(0.001, 0.03, (pages, layers, nh, page, 1)).astype(
        np.float32)).to(dev) for _ in range(2)]
    q = torch.from_numpy(rng.standard_normal((S, nh, hd)).astype(np.float32)).to(
        dev, torch.bfloat16)
    pos = np.linspace(maxp * page - 1, 0, S).astype(np.int32)
    tables = np.zeros((S, maxp), np.int32)
    free = rng.permutation(np.arange(1, pages))
    for s in range(S):
        n = pos[s] // page + 1
        tables[s, :n], free = free[:n], free[n:]
    if S > 1:
        pos[-1], tables[-1] = 0, 0
    return (q, *kv, *sc, torch.from_numpy(tables).to(dev), torch.from_numpy(pos).to(dev))


DECODE_CASES = (  # (slots, page-table width): the serving geometry, and a context
    (1, 12), (16, 12), (4, 64))  # of up to 1,024 positions, past the 256-position staging


def check_decode_attention(dev) -> dict:
    """Kernel against plain at 1 and 16 slots of the serving pool and at 4
    slots of 64-page tables (layer 5 of 12), twice with the same bits, each
    slot alone equal to the same slot in the batch, and two broken plain
    versions (the step gate's: no V scale, the newest position missed)
    outside the tolerance at each; timed at 16 slots. The library call is
    SDPA over K/V already gathered and dequantized (that gather is not
    timed)."""
    import torch
    import torch.nn.functional as F
    from tensorframes_tpu_torch import kernels
    from tensorframes_tpu_torch.kernels import decode_attention as kda

    err, worst = 0.0, 0.0
    broken = {what: fn for what, (name, fn) in broken_plain_paths().items()
              if name == "paged_attention_reference"}
    for S, maxp in DECODE_CASES:
        inputs = paged_inputs(dev, S, maxp=maxp)
        args = (*inputs[:5], 5, *inputs[5:])
        kernels.LAUNCHES.reset()
        got, again = kda.paged_decode_attention(*args), kda.paged_decode_attention(*args)
        launched = kernels.LAUNCHES.snapshot()["decode_attention"]
        ref = kda.paged_attention_reference(*args)
        torch.cuda.synchronize()
        what = f"decode_attention S={S} maxp={maxp}"
        if launched != 2 or not torch.equal(got, again):
            fail(f"{what}: {launched} launches for two calls, or two launches differ")
        err = max(err, bf16_close(got, ref, what))
        worst = max(worst, bf16_ratio(got, ref))
        q, kp, vp, ks, vs, layer, tables, pos = args
        for s in range(S):
            alone = kda.paged_decode_attention(q[s:s + 1], kp, vp, ks, vs, layer,
                                               tables[s:s + 1], pos[s:s + 1])
            if not torch.equal(alone[0], got[s]):
                fail(f"{what}: slot {s} alone differs from the same slot in the batch")
        ratios = {w: bf16_ratio(fn(*args), ref) for w, fn in broken.items()}
        log(f"# {what}: two launches bit for bit, every slot alone = in the batch, "
            f"{bf16_ratio(got, ref):.4g} of the tolerance; broken versions at "
            + ", ".join(f"{w} {r:.4g}" for w, r in ratios.items()))
        for w, r in ratios.items():
            if r <= 1:
                fail(f"the decode_attention gate cannot see a broken version at {what} "
                     f"({w}: {r} <= 1)")
    inputs = paged_inputs(dev, 16)
    args = (*inputs[:5], 5, *inputs[5:])
    q, kp, vp, ks, vs, _, tables, pos = args
    S, nh, hd = q.shape
    C = kp.shape[3] * tables.shape[1]
    t = tables.long()
    kd = (kp[t, 5].float() * ks[t, 5]).permute(0, 2, 1, 3, 4).reshape(S, nh, C, hd)
    vd = (vp[t, 5].float() * vs[t, 5]).permute(0, 2, 1, 3, 4).reshape(S, nh, C, hd)
    kd, vd, qd = kd.to(torch.bfloat16), vd.to(torch.bfloat16), q[:, :, None, :]
    mask = (torch.arange(C, device=dev)[None, :] <= pos.long()[:, None])[:, None, None, :]
    valid = int((pos.long() + 1).sum())  # the positions this run's slots attend
    nbytes = 2 * q.numel() * 2 + valid * nh * (2 * hd + 8) + tables.numel() * 4 + S * 4
    log(f"# decode_attention: the kernel used at most {worst:.4g} of the tolerance")
    return {
        "max_abs_err": err,
        "ms": time_ms(lambda: kda.paged_decode_attention(*args), "decode_attention"),
        "plain_ms": time_ms(lambda: kda.paged_attention_reference(*args),
                            "decode_attention plain"),
        "library_ms": time_ms(
            lambda: F.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask),
            "decode_attention library"),
        **roofline(nbytes, valid * nh * 4 * hd),
    }


FLASH_SHAPES = (  # (shape, dtype name, causal, q/k/v as views of one qkv tensor)
    ((1024, 12, 128, 64), "bfloat16", False, True),  # BERT-base map_rows, as the encoder's
    ((4, 8, 4096, 128), "bfloat16", True, False),    # the reference's attention bench
    ((3, 4, 200, 64), "float32", True, False),       # tile edges: 200 = 3 x 64 + 8
    ((2, 8, 333, 80), "bfloat16", True, False),      # head_dim 80 padded to 128; 333 = 5 x 64 + 13
)
FLASH_RTOL = {"bfloat16": 2.0 ** -7, "float32": 1e-5}
# the forward's other timed shapes: the training path's (as the model passes
# q/k/v), and an f32 one, which the scalar build serves
FLASH_TRAIN_SHAPE = ((8, 12, 1024, 64), "bfloat16", True, True)
FLASH_F32_SHAPE = ((3, 4, 1000, 128), "float32", True, False)


def flash_inputs(dev, shape, dtype_name: str, strided: bool):
    import numpy as np
    import torch

    rng = np.random.default_rng(SEED + shape[2])
    b, h, s, d = shape
    dtype = getattr(torch, dtype_name)
    if strided:  # [b, s, 3, h, d] -> three [b, h, s, d] views, as the encoder's _attention
        qkv = rng.standard_normal((b, s, 3, h, d), dtype=np.float32)
        qkv = torch.from_numpy(qkv).to(dev, dtype)
        return tuple(qkv[:, :, i].permute(0, 2, 1, 3) for i in range(3))
    return tuple(torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev, dtype)
                 for _ in range(3))


def flash_ratio(got, ref, bound, dtype_name: str) -> float:
    """max |got - ref| / (rtol * (|ref| + A)), A = the same attention over
    |v|. The kernel differs from its plain version in the order of f32
    sums and in taking p against the running max before rounding it to
    v's dtype: each side's p rounds by at most half a step, so the two
    outputs differ by at most a step of A (plus a step of |ref| where the
    f32 sums round to neighbouring outputs). rtol 2^-7 is twice that in
    bf16; in f32 1e-5 covers the summation order. <= 1 passes."""
    got, ref = got.double(), ref.double()
    tol = FLASH_RTOL[dtype_name] * (ref.abs() + bound.double())
    return float(((got - ref).abs() / tol).max())


def broken_flash_versions(ref, causal: bool) -> dict:
    """Deliberately wrong plain versions, for showing that the flash gate
    sees a wrong kernel: the scale dropped, the causal mask shifted by one
    (each row also sees the next key), the last 64-key tile dropped."""
    import torch.nn.functional as F

    def last_tile_dropped(q, k, v, c, scale):
        cut = (k.shape[2] - 1) // 64 * 64
        return ref(q, k[:, :, :cut], v[:, :, :cut], c, scale)

    out = {"scale dropped": lambda q, k, v, c, scale: ref(q, k, v, c, 1.0),
           "last key tile dropped": last_tile_dropped}
    if causal:  # row i of q, placed at row i + 1, sees keys 0..i+1
        out["causal mask shifted by one"] = (
            lambda q, k, v, c, scale: ref(F.pad(q, (0, 0, 1, 0)), k, v, c, scale)[:, :, 1:])
    return out


def check_flash_attention(dev) -> dict:
    """The kernel against its plain version at the ``FLASH_SHAPES``, with
    the broken versions outside the same tolerance, each through the build
    it must reach (counted: the tensor cores for every bf16 entry, whose
    head_dims are multiples of 8 and rows aligned, the scalar kernel for
    f32), and two launches bit for bit. Timed at the main path's shape
    (q/k/v the encoder's strided views); the bench shape, the training
    path's shape (without and with l and m) and an f32 shape logged. The
    library call is ``scaled_dot_product_attention`` on the same inputs."""
    import torch
    import torch.nn.functional as F
    from tensorframes_tpu_torch import kernels
    from tensorframes_tpu_torch.kernels import flash_attention as kfa

    err, worst = 0.0, 0.0
    for shape, dtype_name, causal, strided in FLASH_SHAPES:
        q, k, v = flash_inputs(dev, shape, dtype_name, strided)
        if strided and (q.is_contiguous() or q.stride(-1) != 1):
            fail(f"flash_attention {shape}: the q/k/v views are not the encoder's strided ones")
        scale = kfa.default_scale(shape[-1])
        build = kfa.forward_build(q, k, v)
        kernels.LAUNCHES.reset()
        got = kfa.flash_attention(q, k, v, causal=causal)
        again = kfa.flash_attention(q, k, v, causal=causal)
        counts = (kernels.LAUNCHES.snapshot()["flash_attention"],
                  kernels.LAUNCHES.builds()["flash_attention_mma"])
        ref = kfa.flash_attention_reference(q, k, v, causal, scale)
        bound = kfa.flash_attention_reference(q, k, v.abs(), causal, scale)
        torch.cuda.synchronize()
        want = "mma" if dtype_name == "bfloat16" else "scalar"
        if build != want or counts != (2, 2 * (build == "mma")):
            fail(f"flash_attention {shape} {dtype_name}: build {build}, launches (all, tensor "
                 f"cores) {counts}; want {want}")
        if not torch.equal(got, again):
            fail(f"flash_attention {shape}: two launches differ")
        if got.shape != ref.shape or got.dtype != ref.dtype or not bool(torch.isfinite(got).all()):
            fail(f"flash_attention {shape}: output {tuple(got.shape)} {got.dtype} or not finite")
        ratio = flash_ratio(got, ref, bound, dtype_name)
        broken = {what: flash_ratio(fn(q, k, v, causal, scale), ref, bound, dtype_name)
                  for what, fn in broken_flash_versions(kfa.flash_attention_reference,
                                                        causal).items()}
        log(f"# flash_attention {shape} {dtype_name} causal={causal} q strides {q.stride()} "
            f"(read in place, no copy), build {build}, two launches bit for bit: max |err| "
            f"{float((got.double() - ref.double()).abs().max()):.6g}, {ratio:.4g} of the "
            "tolerance; "
            "broken versions at " + ", ".join(f"{w} {r:.4g}" for w, r in broken.items()))
        if ratio > 1:
            fail(f"flash_attention {shape}: kernel off its plain version by {ratio} of the "
                 "tolerance")
        for what, r in broken.items():
            if r <= 1:
                fail(f"the flash gate cannot see a broken version at {shape} ({what}: {r} <= 1)")
        err, worst = max(err, float((got.double() - ref.double()).abs().max())), max(worst, ratio)
        del got, again, ref, bound

    def timing(shape, dtype_name, causal, strided, stats=False):
        q, k, v = flash_inputs(dev, shape, dtype_name, strided)
        scale = kfa.default_scale(shape[-1])
        b, h, s, d = shape
        pairs = s * (s + 1) // 2 if causal else s * s  # the (row, key) pairs this data needs
        run = ((lambda: kfa.flash_attention_fwd(q, k, v, causal, scale)) if stats else
               (lambda: kfa.flash_attention(q, k, v, causal=causal)))
        return {
            "build": kfa.forward_build(q, k, v),
            "ms": time_ms(run, f"flash {shape} stats={stats}"),
            "plain_ms": time_ms(lambda: kfa.flash_attention_reference(q, k, v, causal, scale),
                                f"flash plain {shape}"),
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal),
                                  f"flash library {shape}"),
            **roofline(4 * q.numel() * q.element_size() + (2 * b * h * s * 4 if stats else 0),
                       4 * b * h * pairs * d),
        }

    with torch.no_grad():
        for what, args in (("the attention bench's", (*FLASH_SHAPES[1],)),
                           ("the training path's", FLASH_TRAIN_SHAPE),
                           ("the training path's, with l and m,", (*FLASH_TRAIN_SHAPE, True)),
                           ("an f32", FLASH_F32_SHAPE)):
            log(f"# flash_attention at {what} {args[0]} {args[1]} causal={args[2]}: "
                f"{json.dumps(timing(*args))}")
        main = timing(*FLASH_SHAPES[0])
    log(f"# flash_attention: the kernel used at most {worst:.4g} of the tolerance")
    return {"max_abs_err": err, **{k: v for k, v in main.items() if k != "build"}}


def check_int8_vmap(dev) -> None:
    """``torch.func.vmap`` of ``quantize.matmul`` over [64, 128, 768] bf16
    rows with a quantized 768 x 2304 weight, as ``map_rows`` runs it: one
    launch, the same bits as the un-vmapped call."""
    import numpy as np
    import torch
    from tensorframes_tpu_torch import kernels
    from tensorframes_tpu_torch.ops import quantize as tq

    rng = np.random.default_rng(SEED)
    w = tq.quantize(torch.from_numpy(
        (rng.standard_normal((768, 2304)) / np.sqrt(768)).astype(np.float32)).to(dev))
    x = torch.from_numpy(rng.standard_normal((64, 128, 768), dtype=np.float32)).to(
        dev, torch.bfloat16)
    kernels.LAUNCHES.reset()
    with torch.inference_mode():
        got = torch.func.vmap(lambda r: tq.matmul(r, w))(x)
    launched = kernels.LAUNCHES.snapshot()["int8_matmul"]
    if launched != 1 or not torch.equal(got, tq.matmul(x, w)):
        fail(f"int8_matmul under vmap: {launched} launches, or bits differ from the plain call")
    log("# int8_matmul under vmap over [64, 128, 768]: one launch, bit-equal to the "
        "un-vmapped call")


FLASH_BWD_SHAPES = (  # (shape [b, h, sq, d], dtype name, causal, q/k/v/dO as views of
    #                    [b, s, ., h, d], sk (None: sq), the build backward_build must choose)
    ((1024, 12, 128, 64), "bfloat16", False, True, None, "mma"),  # BERT-base, as the encoder's
    ((8, 12, 1024, 64), "bfloat16", True, True, None, "mma"),     # the training path: gpt_small
    ((2, 8, 1000, 128), "bfloat16", True, False, None, "mma"),    # head_dim 128; 1000 = 15x64 + 40
    ((2, 6, 333, 80), "bfloat16", True, False, 200, "mma"),       # sq != sk; 80 padded to 128
    ((2, 3, 77, 36), "bfloat16", True, False, None, "scalar"),    # head_dim 36: 72-byte rows
    ((3, 4, 1000, 128), "float32", True, False, None, "scalar"),  # f32: tile edges
)
# Twice the worst case of the backward's rounding differences (PERF.md): the
# kernels and the plain versions round p and dS from f32 values that differ
# in the order of their sums, so each side may land on a neighbouring bf16
# value, up to 2^-8 of the value each, and each gradient moves by at most
# 2^-7 of A, its sum over absolute values (kfa.flash_attention_bwd_bound),
# plus 2^-7 of |ref| where the f32 sums round apart: rtol 2^-6 of
# (|ref| + A) doubles that; in f32 1e-5 covers the summation order. The
# tensor-core build is held to that plus E, the term dP's f32 summation
# order adds where dP - di cancels (kfa.flash_attention_bwd_order_bound).
FLASH_BWD_RTOL = {"bfloat16": 2.0 ** -6, "float32": 1e-5}
BROKEN_BWD_MIN = 4.0  # each broken backward version's share of the tolerance must exceed it


def bwd_inputs(dev, shape, dtype_name: str, strided: bool, sk=None):
    """q/k/v as ``flash_inputs`` gives them (k and v of ``sk`` rows when
    that is given) and a seeded dO, the latter a ``[b, s, h, d] -> [b, h,
    s, d]`` view when ``strided``, as autograd hands it to the flash op's
    gradient in the model."""
    import numpy as np
    import torch

    b, h, s, d = shape
    dtype = getattr(torch, dtype_name)
    q, k, v = flash_inputs(dev, shape, dtype_name, strided)
    if sk is not None and sk != s:
        rng = np.random.default_rng(SEED + 3 * sk)
        k, v = (torch.from_numpy(rng.standard_normal((b, h, sk, d), dtype=np.float32)).to(
            dev, dtype) for _ in range(2))
    rng = np.random.default_rng(SEED + 7 * s)
    do = torch.from_numpy(rng.standard_normal((b, s, h, d), dtype=np.float32)).to(dev, dtype)
    return q, k, v, do.permute(0, 2, 1, 3) if strided else do.permute(0, 2, 1, 3).contiguous()


def bwd_ratio(got, ref, bound, dtype_name: str, order=None) -> float:
    """max |got - ref| / (rtol * (|ref| + A) + E), an equal entry counting 0
    (also where its tolerance is 0); E (``order``) is 0 when not given;
    <= 1 passes."""
    import torch

    got, ref = got.double(), ref.double()
    diff = (got - ref).abs()
    tol = FLASH_BWD_RTOL[dtype_name] * (ref.abs() + bound.double())
    if order is not None:
        tol = tol + order.double()
    return float(torch.where(diff == 0, 0.0, diff / tol).max())


def broken_bwd_versions(causal: bool) -> dict:
    """Deliberately wrong plain backward versions ``(q, k, v, l, m, do, di,
    causal, scale) -> (dq, dk, dv)``, for showing that the backward gate
    sees a wrong kernel: ``di`` left out, ``sm_scale`` left out of dS
    (dQ and dK come out 1/sm_scale too large), and the causal mask dropped
    in the backward only (p of future keys no longer 0)."""
    import torch
    from tensorframes_tpu_torch.kernels import flash_attention as kfa

    def plain(q, k, v, l, m, do, di, c, scale):
        dk, dv = kfa.flash_attention_bwd_dkv_reference(q, k, v, l, m, do, di, c, scale)
        return kfa.flash_attention_bwd_dq_reference(q, k, v, l, m, do, di, c, scale), dk, dv

    def unscaled(*a):
        dq, dk, dv = plain(*a)
        scale = a[-1]
        return (dq.float() / scale).to(dq.dtype), (dk.float() / scale).to(dk.dtype), dv

    out = {"di left out": lambda q, k, v, l, m, do, di, c, scale: plain(
               q, k, v, l, m, do, torch.zeros_like(di), c, scale),
           "sm_scale left out of dS": unscaled}
    if causal:
        out["causal mask dropped in the backward"] = (
            lambda q, k, v, l, m, do, di, c, scale: plain(q, k, v, l, m, do, di, False, scale))
    return out


def check_flash_backward(dev) -> dict:
    """Both backward kernels against their plain versions at the
    ``FLASH_BWD_SHAPES``, from the forward kernel's own o, l and m, each
    through the build ``backward_build`` must choose (counted): the
    tensor-core build held to ``rtol·(|ref| + A) + E``, the scalar build to
    ``rtol·(|ref| + A)`` alone; each share is reported with and without E.
    The broken versions must land above ``BROKEN_BWD_MIN`` of the same
    tolerance; two launches bit for bit. The forward that keeps l and m
    (the build the training path launches) is held against the plain
    forward at each shape too: its o within the forward's tolerance
    (``flash_ratio``), which the broken forward versions must exceed, and
    equal to the o bits of the forward without l and m; its l and m within
    rtol 1e-5 (f32 sums in another order). Timed at the training path's
    shape; the library call is ``scaled_dot_product_attention``'s backward
    for dq, dk and dv together."""
    import torch
    import torch.nn.functional as F
    from tensorframes_tpu_torch import kernels
    from tensorframes_tpu_torch.kernels import flash_attention as kfa

    out = {"flash_attention_bwd_dkv": {"max_abs_err": 0.0},
           "flash_attention_bwd_dq": {"max_abs_err": 0.0}}
    worst = 0.0
    for shape, dtype_name, causal, strided, sk, want in FLASH_BWD_SHAPES:
        q, k, v, do = bwd_inputs(dev, shape, dtype_name, strided, sk)
        scale = kfa.default_scale(shape[-1])
        build = kfa.backward_build(q, k, v, do)
        with torch.no_grad():
            o, l, m = kfa.flash_attention_fwd(q, k, v, causal, scale)
            o_plain = kfa.flash_attention(q, k, v, causal=causal)
        o_ref, l_ref, m_ref = kfa.flash_attention_fwd_reference(q, k, v, causal, scale)
        o_bound = kfa.flash_attention_reference(q, k, v.abs(), causal, scale)
        di = kfa.flash_attention_di(o, do)
        kernels.LAUNCHES.reset()
        dk, dv = kfa.flash_attention_bwd_dkv(q, k, v, l, m, do, di, causal, scale)
        dq = kfa.flash_attention_bwd_dq(q, k, v, l, m, do, di, causal, scale)
        dk2, dv2 = kfa.flash_attention_bwd_dkv(q, k, v, l, m, do, di, causal, scale)
        dq2 = kfa.flash_attention_bwd_dq(q, k, v, l, m, do, di, causal, scale)
        counts = (kernels.LAUNCHES.snapshot()["flash_attention_bwd_dkv"],
                  kernels.LAUNCHES.snapshot()["flash_attention_bwd_dq"],
                  kernels.LAUNCHES.builds()["flash_attention_bwd_dkv_mma"],
                  kernels.LAUNCHES.builds()["flash_attention_bwd_dq_mma"])
        ref = (kfa.flash_attention_bwd_dq_reference(q, k, v, l, m, do, di, causal, scale),
               *kfa.flash_attention_bwd_dkv_reference(q, k, v, l, m, do, di, causal, scale))
        bound = kfa.flash_attention_bwd_bound(q, k, v, o, l, m, do, causal, scale)
        # E is derived for bf16 products (exact in f32); the f32 build has none
        order = (kfa.flash_attention_bwd_order_bound(q, k, v, l, m, do, causal, scale)
                 if dtype_name == "bfloat16" else (None, None, None))
        gate = order if build == "mma" else (None, None, None)
        torch.cuda.synchronize()
        n_mma = 2 * (build == "mma")
        if build != want or counts != (2, 2, n_mma, n_mma):
            fail(f"flash backward {shape} {dtype_name}: build {build}, launches (dK/dV, dQ, "
                 f"dK/dV on the tensor cores, dQ on the tensor cores) {counts}; want {want}")
        if not torch.equal(o, o_plain):
            fail(f"flash forward {shape}: o with l/m differs from o without them")
        l_err = float(((l - l_ref).abs() / l_ref.abs()).max())
        m_err = float(((m - m_ref).abs() / m_ref.abs().clamp(min=1.0)).max())
        o_ratio = flash_ratio(o, o_ref, o_bound, dtype_name)
        o_broken = {what: flash_ratio(fn(q, k, v, causal, scale), o_ref, o_bound, dtype_name)
                    for what, fn in broken_flash_versions(kfa.flash_attention_reference,
                                                          causal).items()}
        got = (dq, dk, dv)
        for name, g, r in zip(("dq", "dk", "dv"), got, ref):
            if g.shape != r.shape or g.dtype != r.dtype or not bool(torch.isfinite(g).all()):
                fail(f"flash backward {shape}: {name} {tuple(g.shape)} {g.dtype} or not finite")
        ratios = [bwd_ratio(g, r, a, dtype_name, e) for g, r, a, e in zip(got, ref, bound, gate)]
        with_e = [bwd_ratio(g, r, a, dtype_name, e) if e is not None else float("nan")
                  for g, r, a, e in zip(got, ref, bound, order)]
        without_e = [bwd_ratio(g, r, a, dtype_name) for g, r, a in zip(got, ref, bound)]
        broken = {}
        for what, fn in broken_bwd_versions(causal).items():
            bad = fn(q, k, v, l, m, do, di, causal, scale)
            broken[what] = max(bwd_ratio(g, r, a, dtype_name, e)
                               for g, r, a, e in zip(bad, ref, bound, gate))
            del bad
        errs = [float((g.double() - r.double()).abs().max()) for g, r in zip(got, ref)]
        held = "A + E" if build == "mma" else "A"
        log(f"# flash backward {shape} {dtype_name} causal={causal} strided={strided} sk="
            f"{sk or shape[2]}: build {build} (launches {counts}), held to {held}, two "
            f"launches bit for bit: max |err| dq {errs[0]:.6g}, dk {errs[1]:.6g}, dv "
            f"{errs[2]:.6g}; share of the tolerance with E dq {with_e[0]:.4g}, dk "
            f"{with_e[1]:.4g}, dv {with_e[2]:.4g}; without E dq {without_e[0]:.4g}, dk "
            f"{without_e[1]:.4g}, dv {without_e[2]:.4g}; broken versions at "
            + ", ".join(f"{w} {r:.4g}" for w, r in broken.items()))
        log(f"# flash forward with l, m {shape}: o max |err| "
            f"{float((o.double() - o_ref.double()).abs().max()):.6g}, {o_ratio:.4g} of the "
            f"tolerance; l rel err {l_err:.3g}, m {m_err:.3g}; broken forward versions at "
            + ", ".join(f"{w} {r:.4g}" for w, r in o_broken.items()))
        if not (torch.equal(dq, dq2) and torch.equal(dk, dk2) and torch.equal(dv, dv2)):
            fail(f"flash backward {shape}: two launches differ")
        if o_ratio > 1:
            fail(f"flash forward with l, m {shape}: o off its plain version by {o_ratio} of "
                 "the tolerance")
        for what, r in o_broken.items():
            if r <= 1:
                fail(f"the flash gate cannot see a broken version at {shape} ({what}: {r} <= 1)")
        if l_err > 1e-5 or m_err > 1e-5:
            fail(f"flash forward {shape}: l or m off the plain forward's (rel {l_err}, {m_err})")
        if max(ratios) > 1:
            fail(f"flash backward {shape}: kernels off their plain versions by {ratios} of the "
                 f"tolerance ({held})")
        for what, r in broken.items():
            if r <= BROKEN_BWD_MIN:
                fail(f"the flash backward gate cannot see a broken version at {shape} "
                     f"({what}: {r} <= {BROKEN_BWD_MIN})")
        out["flash_attention_bwd_dq"]["max_abs_err"] = max(
            out["flash_attention_bwd_dq"]["max_abs_err"], errs[0])
        out["flash_attention_bwd_dkv"]["max_abs_err"] = max(
            out["flash_attention_bwd_dkv"]["max_abs_err"], errs[1], errs[2])
        worst = max(worst, *ratios)
        del o, l, m, o_ref, o_bound, dq, dk, dv, dq2, dk2, dv2, ref, bound, order, gate, got

    shape, dtype_name, causal, strided, _, _ = FLASH_BWD_SHAPES[1]
    q, k, v, do = bwd_inputs(dev, shape, dtype_name, strided)
    scale = kfa.default_scale(shape[-1])
    with torch.no_grad():
        o, l, m = kfa.flash_attention_fwd(q, k, v, causal, scale)
    di = kfa.flash_attention_di(o, do)
    args = (q, k, v, l, m, do, di, causal, scale)
    qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
    sdpa = F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal)
    library = time_ms(lambda: torch.autograd.grad(sdpa, (qs, ks, vs), do, retain_graph=True),
                      "flash backward library")
    b, h, s, d = shape
    pairs = s * (s + 1) // 2 if causal else s * s
    io = q.numel() * q.element_size()  # one of q, k, v, dO, dq, dk, dv
    stats = 3 * b * h * s * 4          # l, m, di
    out["flash_attention_bwd_dkv"].update({
        "ms": time_ms(lambda: kfa.flash_attention_bwd_dkv(*args), "flash_attention_bwd_dkv"),
        "plain_ms": time_ms(lambda: kfa.flash_attention_bwd_dkv_reference(*args),
                            "flash_attention_bwd_dkv plain"),
        "library_ms": library,
        **roofline(6 * io + stats, 8 * b * h * pairs * d),
    })
    out["flash_attention_bwd_dq"].update({
        "ms": time_ms(lambda: kfa.flash_attention_bwd_dq(*args), "flash_attention_bwd_dq"),
        "plain_ms": time_ms(lambda: kfa.flash_attention_bwd_dq_reference(*args),
                            "flash_attention_bwd_dq plain"),
        "library_ms": library,
        **roofline(5 * io + stats, 6 * b * h * pairs * d),
    })
    log(f"# flash backward: the kernels used at most {worst:.4g} of the tolerance; SDPA's "
        f"backward (dq, dk, dv together) {library:.6f} ms at {shape} {dtype_name} causal")
    return out


# ---------------------------------------------------------------------------
# phase 2: the main path through the entry points
# ---------------------------------------------------------------------------

def main_path(tft, dev) -> dict:
    import numpy as np
    import torch
    from tensorframes_tpu_torch.models import logreg

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(SEED)
    tft.profiling.reset_metrics()
    tft.kernels.LAUNCHES.reset()

    # add-3 map_blocks over 20M float64 rows (BASELINE config 1)
    x = np.arange(20_000_000, dtype=np.float64)
    df = tft.frame_from_arrays({"x": x})
    with tft.with_graph():
        z = tft.map_blocks(tft.add(tft.block(df, "x"), 3, name="z"), df, device=dev)
    zc = z.column_values("z")
    if zc.dtype != np.float64 or not np.array_equal(zc, x + 3):
        fail("map_blocks add-3")
    del df, z, zc, x

    # reduce_blocks reduce_sum / reduce_min over double[?,2] (config 2)
    y = rng.standard_normal((10_000_000, 2))
    fr = tft.frame_from_arrays({"y": y})
    with tft.with_graph():
        s = tft.reduce_blocks(tft.reduce_sum(
            tft.placeholder(np.float64, (None, 2), name="y_input"), name="y"), fr, device=dev)
    with tft.with_graph():
        m = tft.reduce_blocks(tft.reduce_min(
            tft.placeholder(np.float64, (None, 2), name="y_input"), name="y"), fr, device=dev)
    if not np.allclose(s, y.sum(0), rtol=1e-9, atol=1e-6) or not np.array_equal(m, y.min(0)):
        fail("reduce_blocks sum/min")

    # map_rows on fixed cells
    with tft.with_graph():
        w = tft.map_rows(tft.mul(tft.row(fr, "y"), 2.0, name="w"), fr, device=dev)
    if not np.array_equal(w.column_values("w"), y * 2.0):
        fail("map_rows fixed cells")
    del fr, w, y

    # map_rows on ragged cells (the ragged-gather kernel stages each group)
    lens, starts, flat = ragged_cells(RAGGED_ROWS)
    cells = [flat[s:s + n] for s, n in zip(starts, lens)]
    rf = tft.frame_from_arrays({"r": cells})
    with tft.with_graph():
        rmax = tft.map_rows(tft.reduce_max(
            tft.placeholder(np.float32, (None,), name="r"), name="m"), rf, device=dev)
    if not np.array_equal(rmax.column_values("m"), np.array([c.max() for c in cells])):
        fail("map_rows ragged cells")
    del rf, rmax, cells

    # full-width logreg scoring with reference-layout weights, then an
    # aggregate of the scores by predicted label (config 3)
    feats, _ = logreg.make_synthetic_mnist(262_144, 784, seed=SEED)
    params_np = {"w": (rng.standard_normal((784, 10)) * 0.01).astype(np.float32),
                 "b": np.zeros(10, np.float32)}
    params = logreg.params_from_jax(params_np, device=dev)
    ff = tft.frame_from_arrays({"features": feats})
    scored = tft.map_blocks(logreg.scoring_program(params), ff, device=dev)
    labels = scored.column_values("label")
    logits = feats[:4096].astype(np.float64) @ params_np["w"].astype(np.float64)
    top2 = np.sort(logits, axis=1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > 1e-4
    if not np.array_equal(labels[:4096][clear], logits.argmax(1)[clear]):
        fail("logreg labels")
    sf = tft.frame_from_arrays({"label": labels, "scores": scored.column_values("scores")})
    with tft.with_graph():
        agg = tft.aggregate(tft.reduce_sum(tft.block(sf, "scores", tf_name="scores_input"),
                                           name="scores"), sf.group_by("label"), device=dev)
    got = agg.column_values("scores")
    want = np.zeros((10, 10))
    np.add.at(want, labels, sf.column_values("scores").astype(np.float64))
    present = np.unique(labels)
    float_close(torch.from_numpy(got), torch.from_numpy(want[present]),
                np.bincount(labels, minlength=10)[present], 1.0)
    del ff, scored, sf, feats

    # the 10M-row aggregate (segment_reduce), and an aggregate of f32 +
    # int64 sums: int64 fails the fused kernel's eligibility, so that one
    # takes the per-op route (segment_sum for the f32 column). Both are
    # checked below against the same aggregates run on the CPU (the
    # kernels' plain versions), outside the timed window.
    n, groups = 10_000_000, 4096
    k = rng.integers(0, groups, n)
    v = rng.standard_normal(n, dtype=np.float32)
    big = tft.frame_from_arrays({
        "k": k, "v": v, "u": v.copy(),
        "w": rng.standard_normal((n, 8), dtype=np.float32),
        "c": rng.integers(-1000, 1000, n).astype(np.int32),
    })
    mixed = tft.frame_from_arrays({"k": k, "v": v, "i": rng.integers(-1000, 1000, n)})

    def big_agg(device):
        with tft.with_graph():
            b = lambda col: tft.block(big, col, tf_name=f"{col}_input")  # noqa: E731
            return tft.aggregate([
                tft.reduce_sum(b("v"), name="v"), tft.reduce_mean(b("u"), name="u"),
                tft.reduce_max(b("w"), name="w"), tft.reduce_sum(b("c"), name="c"),
            ], big.group_by("k"), device=device)

    def mixed_agg(device):
        with tft.with_graph():
            return tft.aggregate([
                tft.reduce_sum(tft.block(mixed, "v", tf_name="v_input"), name="v"),
                tft.reduce_sum(tft.block(mixed, "i", tf_name="i_input"), name="i"),
            ], mixed.group_by("k"), device=device)

    big_got, mixed_got = big_agg(dev), mixed_agg(dev)
    torch.cuda.synchronize()
    launches = tft.kernels.LAUNCHES.snapshot()
    rates = {
        name: {"calls": st.calls, "rows": st.rows, "seconds": st.seconds,
               "rows_per_s": st.rows_per_sec}
        for name, st in tft.profiling.metrics().items()
    }

    ref = big_agg("cpu")
    if not all(np.array_equal(big_got.column_values(c), ref.column_values(c))
               for c in ("k", "w", "c")):
        fail("10M-row aggregate: keys, max or int sum")
    counts, vmax = np.bincount(k, minlength=groups)[ref.column_values("k")], float(np.abs(v).max())
    for col in ("v", "u"):
        float_close(torch.from_numpy(big_got.column_values(col)),
                    torch.from_numpy(ref.column_values(col)), counts, vmax, mean=col == "u")
    ref = mixed_agg("cpu")
    if not np.array_equal(mixed_got.column_values("i"), ref.column_values("i")):
        fail("mixed aggregate: int64 sum")
    counts = np.bincount(k, minlength=groups)[ref.column_values("k")]
    float_close(torch.from_numpy(mixed_got.column_values("v")),
                torch.from_numpy(ref.column_values("v")), counts, vmax)
    return {"launches": launches, "verbs": rates}


@contextlib.contextmanager
def knobs(tft, **values):
    """``tft.configure(**values)`` for the block, the old values after."""
    cfg = tft.get_config()
    was = {k: getattr(cfg, k) for k in values}
    tft.configure(**values)
    try:
        yield
    finally:
        tft.configure(**was)


RAGGED_REPS = 5
PIPELINE_MODES = (("serial", {"map_pipeline_depth": 0, "map_prefetch_depth": 0}),
                  ("pipelined", {"map_pipeline_depth": 2, "map_prefetch_depth": 2}))


def ragged_verb_legs(tft, dev) -> dict:
    """The ragged ``map_rows`` verb (``reduce_max`` of each row) on the main
    and wide-lengths f32 feeds, serial (``map_pipeline_depth`` 0: each
    group read back before the next dispatch) and pipelined (the
    defaults): a warm-up call checked against the host's row maxima, then
    RAGGED_REPS calls of each mode in turn (the median host wall, to the
    result on the host; one gather launch each), and the device's busy
    share of a profiled call. The two modes' outputs must be equal."""
    import numpy as np

    out = {}
    for name, wide in (("main", False), ("wide_f32", True)):
        lens, starts, flat = ragged_cells(RAGGED_ROWS, wide=wide)
        cells = [flat[s:s + n] for s, n in zip(starts, lens)]
        rf = tft.frame_from_arrays({"r": cells})

        def call():
            with tft.with_graph():
                return tft.map_rows(tft.reduce_max(
                    tft.placeholder(np.float32, (None,), name="r"), name="m"),
                    rf, device=dev).column_values("m")

        got, walls = {}, {mode: [] for mode, _ in PIPELINE_MODES}
        for mode, values in PIPELINE_MODES:
            with knobs(tft, **values):
                got[mode] = call()
                if not np.array_equal(got[mode], np.array([c.max() for c in cells])):
                    fail(f"map_rows ragged cells ({name} feed, {mode})")
        for _ in range(RAGGED_REPS):  # the modes in turn: host walls drift
            for mode, values in PIPELINE_MODES:
                with knobs(tft, **values):
                    tft.kernels.LAUNCHES.reset()
                    t0 = time.perf_counter()
                    call()
                    walls[mode].append(time.perf_counter() - t0)
                    if tft.kernels.LAUNCHES.snapshot()["ragged_gather"] != 1:
                        fail(f"the ragged map_rows call ({name}, {mode}) launched "
                             "ragged_gather other than once (want 1: every group in one launch)")
        for mode, values in PIPELINE_MODES:
            with knobs(tft, **values):
                tft.kernels.LAUNCHES.reset()
                prof = timeline_profile(call)
                launches = tft.kernels.LAUNCHES.snapshot()["ragged_gather"] // 2
            wall = float(np.median(walls[mode]))
            r = out[f"{name}_{mode}"] = {
                "wall_ms": wall * 1e3, "walls_ms": [w * 1e3 for w in walls[mode]],
                "launches_per_call": launches,
                "groups": len(np.unique(lens)), "profiled_wall_ms": prof["wall_ms"],
                "busy_ms": prof["busy_ms"], "busy_share": prof["busy_share"],
                "top": sorted(prof["device"].items(), key=lambda kv: -kv[1])[:5]}
            log(f"# verb map_rows ragged {name} {mode} ({RAGGED_ROWS} rows, {r['groups']} "
                f"length groups): {wall * 1e3:.3f} ms host wall (median of {RAGGED_REPS}: "
                + ", ".join(f"{w * 1e3:.1f}" for w in walls[mode])
                + f"), {launches} ragged_gather launch(es) a call; profiled "
                f"{prof['wall_ms']:.3f} ms, device busy {prof['busy_ms']:.3f} ms "
                f"({100 * prof['busy_share']:.1f}%)")
            for k, ms in r["top"]:
                log(f"#   {ms:9.3f} ms  {k[:80]}")
        if got["serial"].tobytes() != got["pipelined"].tobytes():
            fail(f"map_rows ragged cells ({name} feed): pipelined differs from serial")
    return out


GENERIC_ROWS, GENERIC_GROUPS, GENERIC_BUFFER = 1_000_000, 512, 10
LSE_RTOL = 1e-5  # of max |logsumexp|: f32 against a float64 host computation per group


def generic_aggregate_leg(tft, dev, n: int = GENERIC_ROWS, groups: int = GENERIC_GROUPS) -> dict:
    """The generic (UDAF) ``aggregate`` at the reference docstring's scale:
    ``n`` rows over ``groups`` uniform groups, an f32 ``[n, 8]`` and an
    int32 column, plain-function fetches (``torch.logsumexp`` over rows,
    an int32 sum) with ``aggregate_buffer_size`` 10. A warm-up call, then
    a timed one (wall, vmapped dispatches, rows/s). The int sums exact
    against ``np.add.at``; the log-sum-exps within LSE_RTOL·max of a
    float64 host computation of each group."""
    import numpy as np
    import torch
    from tensorframes_tpu_torch.ops import executor

    rng = np.random.default_rng(SEED)
    k = rng.integers(0, groups, n)
    v = rng.standard_normal((n, 8), dtype=np.float32)
    i = rng.integers(-1000, 1000, n).astype(np.int32)
    frame = tft.frame_from_arrays({"k": k, "v": v, "i": i})

    def fetches(v_input, i_input):
        return {"v": torch.logsumexp(v_input, 0), "i": i_input.sum(0, dtype=torch.int32)}

    def dispatches():
        return executor._JIT_HITS.value + executor._JIT_MISSES.value

    with knobs(tft, aggregate_buffer_size=GENERIC_BUFFER):
        tft.aggregate(fetches, frame.group_by("k"), device=dev)  # warm-up
        d0 = dispatches()
        t0 = time.perf_counter()
        res = tft.aggregate(fetches, frame.group_by("k"), device=dev)
        keys, got_v, got_i = (res.column_values(c) for c in ("k", "v", "i"))
        wall = time.perf_counter() - t0
        calls = int(dispatches() - d0)
    want_i = np.zeros(groups, np.int64)
    np.add.at(want_i, k, i)
    if got_i.dtype != np.int32 or not np.array_equal(got_i.astype(np.int64), want_i[keys]):
        fail("generic aggregate: int32 sums differ from np.add.at")
    order = np.argsort(k, kind="stable")
    starts = np.searchsorted(k[order], np.arange(groups))
    want_v = np.logaddexp.reduceat(v[order].astype(np.float64), starts, axis=0)[keys]
    err = float(np.abs(got_v.astype(np.float64) - want_v).max())
    tol = LSE_RTOL * float(np.abs(want_v).max())
    if got_v.shape != (groups, 8) or not np.isfinite(got_v).all() or err > tol:
        fail(f"generic aggregate: logsumexp off by {err} where the tolerance is {tol}")
    log(f"# generic aggregate ({n} rows, {groups} groups, f32 [n, 8] logsumexp + int32 sum, "
        f"buffer {GENERIC_BUFFER}): {wall * 1e3:.3f} ms host wall, {calls} vmapped "
        f"dispatches, {n / wall:.0f} rows/s; logsumexp off by {err:.3g} "
        f"({err / tol:.4f} of the tolerance), int sums exact")
    return {"wall_ms": wall * 1e3, "dispatches": calls, "rows_per_s": n / wall,
            "lse_ratio": err / tol}


REL_ROWS, REL_KEYS, REL_SLICE, REL_RIGHT = 10_000_000, 100_000, 1_000_000, 100_000
REL_GROUP_DIV = 25  # g = k // 25: 4,000 groups, within the segment kernels' 4,096


def relational_leg(tft, dev, n: int = REL_ROWS, keys: int = REL_KEYS,
                   n_slice: int = REL_SLICE, n_right: int = REL_RIGHT) -> dict:
    """The relational frame ops over ``n`` rows (f32 ``x`` in [0, 1) and
    its copy ``xm``, int64 ``k`` over ``keys`` values, ``g = k // 25``,
    int32 ``id``), every expected result built with numpy:
    ``filter(x > 0.5)`` exact; the filtered rows' keyed f32 sum of ``x``
    and max of ``xm`` by ``g`` (the fused ``segment_reduce``; 100,000
    keys exceed the kernels' 4,096 segments) and the f32 sum beside an
    int64 sum of ``k`` (the per-op route, ``segment_sum`` for the f32
    column), sums within ``float_close``'s tolerance, max and int sums
    exact, each through its kernel by the launch counts; on an ``n_slice``-row slice ``sort_values(["k", "x"],
    ascending=[True, False])`` and an inner and a left ``join`` against
    an ``n_right``-row frame of unique keys (``fill_value``), exact;
    ``drop_duplicates(["k"])`` and ``group_by("k").count()``, exact. Each
    op's host wall is logged."""
    import numpy as np
    import torch

    rng = np.random.default_rng(SEED)
    x = rng.random(n, dtype=np.float32)
    k = rng.integers(0, keys, n)
    ids = np.arange(n, dtype=np.int32)
    frame = tft.frame_from_arrays({"x": x, "xm": x, "k": k, "g": k // REL_GROUP_DIV,
                                   "id": ids})
    walls, launches = {}, {}

    def timed(name, fn):
        tft.kernels.LAUNCHES.reset()
        t0 = time.perf_counter()
        out = fn()
        walls[name] = (time.perf_counter() - t0) * 1e3
        launches[name] = tft.kernels.LAUNCHES.snapshot()
        return out

    def cols(f, names):
        return tuple(f.column_values(c) for c in names)

    keep = x > 0.5
    filtered = timed("filter", lambda: frame.filter(
        lambda x: {"keep": x > 0.5}, device=dev).cache())
    fx, fk, fg, fid = cols(filtered, ("x", "k", "g", "id"))
    if not (np.array_equal(fid, ids[keep]) and np.array_equal(fx, x[keep])
            and np.array_equal(fk, k[keep])):
        fail("relational: filter(x > 0.5) differs from the numpy mask")

    groups = int(fg.max()) + 1
    counts = np.bincount(fg, minlength=groups)
    want_sum = np.bincount(fg, weights=fx.astype(np.float64), minlength=groups)
    order = np.argsort(fg, kind="stable")
    want_max = np.maximum.reduceat(fx[order], np.searchsorted(fg[order], np.arange(groups)))

    def agg(fetch):
        with tft.with_graph():
            b = lambda col: tft.block(filtered, col, tf_name=f"{col}_input")  # noqa: E731
            return tft.aggregate(fetch(b), filtered.group_by("g"), device=dev)

    fused = timed("aggregate sum+max", lambda: agg(lambda b: [
        tft.reduce_sum(b("x"), name="x"), tft.reduce_max(b("xm"), name="xm")]))
    per_op = timed("aggregate sum + int64 sum", lambda: agg(lambda b: [
        tft.reduce_sum(b("x"), name="x"), tft.reduce_sum(b("k"), name="k")]))
    g_out = fused.column_values("g")
    vmax = float(np.abs(fx).max())
    for res in (fused, per_op):
        float_close(torch.from_numpy(res.column_values("x")),
                    torch.from_numpy(want_sum[g_out]), counts[g_out], vmax)
    want_k = np.bincount(fg, weights=fk, minlength=groups).astype(np.int64)  # < 2^53: exact
    if not (np.array_equal(fused.column_values("xm"), want_max[g_out])
            and np.array_equal(per_op.column_values("k"), want_k[g_out])):
        fail("relational: a filtered keyed max or int64 sum differs from numpy")
    if launches["aggregate sum+max"]["segment_reduce"] < 1:
        fail("relational: the filtered sum+max aggregate did not launch segment_reduce")
    if launches["aggregate sum + int64 sum"]["segment_sum"] < 1:
        fail("relational: the filtered f32 sum beside an int64 sum did not launch segment_sum")

    part = frame.limit(n_slice).cache()
    px, pk, pid = x[:n_slice], k[:n_slice], ids[:n_slice]
    srt = timed("sort_values", lambda: part.sort_values(["k", "x"], ascending=[True, False])
                .column_values("id"))
    if not np.array_equal(srt, pid[np.lexsort((-px, pk))]):
        fail("relational: sort_values(['k', 'x'], ascending=[True, False]) differs from numpy")
    right_k = rng.permutation(2 * keys)[:n_right]
    right_w = rng.standard_normal(n_right, dtype=np.float32)
    right = tft.frame_from_arrays({"k": right_k, "w": right_w})
    pos = np.full(2 * keys, -1, np.int64)
    pos[right_k] = np.arange(n_right)
    m = pos[pk]
    inner = timed("join inner", lambda: part.join(right, on="k").cache())
    left = timed("join left", lambda: part.join(right, on="k", how="left",
                                                fill_value={"w": -1.0}).cache())
    hit = m >= 0
    if not (np.array_equal(inner.column_values("id"), pid[hit])
            and np.array_equal(inner.column_values("w"), right_w[m[hit]])
            and np.array_equal(left.column_values("id"), pid)
            and np.array_equal(left.column_values("w"),
                               np.where(hit, right_w[np.maximum(m, 0)], np.float32(-1.0)))):
        fail("relational: an inner or left join differs from numpy")

    dd = timed("drop_duplicates", lambda: frame.drop_duplicates(["k"]).column_values("id"))
    if not np.array_equal(dd, ids[np.sort(np.unique(k, return_index=True)[1])]):
        fail("relational: drop_duplicates(['k']) differs from numpy")
    cnt = timed("count", lambda: frame.group_by("k").count(device=dev))
    if not np.array_equal(cnt.column_values("count"), np.bincount(k)[cnt.column_values("k")]):
        fail("relational: group_by('k').count() differs from np.bincount")
    log(f"# relational ({n} rows, {keys} keys; slice {n_slice}, right {n_right}): "
        + ", ".join(f"{name} {ms:.3f} ms" for name, ms in walls.items())
        + f"; kept {int(keep.sum())} rows; launches sum+max {launches['aggregate sum+max']}, "
        f"sum + int64 sum {launches['aggregate sum + int64 sum']}")
    merged = {}
    for counts_ in launches.values():
        for kname, c in counts_.items():
            merged[kname] = merged.get(kname, 0) + c
    return {"walls_ms": walls, "launches": merged}


def serving_path(tft, dev) -> dict:
    """The decode server at gpt_small's full width: 32 requests through
    ``Server.submit`` with every launch count reset first, then the gates
    (solo = batched, preempted = unpreempted, launches per step)."""
    import dataclasses

    import numpy as np
    from tensorframes_tpu_torch.models import generation as gen
    from tensorframes_tpu_torch.models import transformer as tr
    from tensorframes_tpu_torch.serving import DecodeConfig, Server
    from tensorframes_tpu_torch.serving import metrics as sm

    t0 = time.perf_counter()
    cfg = gen.gpt_small()
    params = tr.quantize_params(tr.init_params(cfg, seed=SEED, device=dev))
    dcfg = DecodeConfig(max_slots=16, page_size=16, max_prompt_len=128, max_new_tokens=64)
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in rng.integers(8, 129, 32)]
    srv = Server(device=dev)
    srv.register_decode("gpt_small", cfg, params, dcfg)
    srv.start()  # warms the slot × prompt bucket grid
    log(f"# serving setup (weights, pool, warm-up): {time.perf_counter() - t0:.1f} s")
    try:
        steps0 = {p: sm.DECODE_STEPS[p].value for p in sm.DECODE_PHASES}
        tft.kernels.LAUNCHES.reset()
        t1 = time.perf_counter()
        futs = [(time.perf_counter(), srv.submit("gpt_small", {"prompt": p})) for p in prompts]
        outs, lat = [], []
        for t_sub, f in futs:
            outs.append(f.result(600)["tokens"])
            lat.append(time.perf_counter() - t_sub)
        wall = time.perf_counter() - t1
        launches = launch_counts(tft)
        steps = {p: int(sm.DECODE_STEPS[p].value - steps0[p]) for p in sm.DECODE_PHASES}
        # each request's own submit-to-first-token time; the burst's 32
        # first tokens are also the only observations of the histogram
        # (warm-up prefills do not observe it)
        ttfts = [f.ttft_s for _, f in futs]
        if sm.DECODE_TTFT.count != 32 or None in ttfts:
            fail(f"{sm.DECODE_TTFT.count} TTFT observations for 32 requests")
        ttft = {"p50": float(np.percentile(ttfts, 50)), "p99": float(np.percentile(ttfts, 99))}
        for o in outs:  # every request answered, in range
            if (o.shape != (1, 64) or o.dtype != np.int32 or o.min() < 0
                    or o.max() >= cfg.vocab_size):
                fail(f"a decode result of shape {o.shape} / {o.dtype} or out of range")
        # the kernels ran as often as the steps say
        if launches["decode_attention"] != 12 * steps["decode"]:
            fail(f"decode_attention launched {launches['decode_attention']} times in "
                 f"{steps['decode']} decode steps (want 12 per step)")
        if launches["int8_matmul"] != 48 * (steps["decode"] + steps["prefill"]):
            fail(f"int8_matmul launched {launches['int8_matmul']} times in {steps} "
                 "(want 48 per decode step and per prefill)")
        if launches["int8_matmul_mma"] != launches["int8_matmul"]:
            fail(f"{launches['int8_matmul_mma']} of the {launches['int8_matmul']} int8_matmul "
                 "launches went to the tensor-core build (want all)")
        # solo equals batched, exactly
        for i in range(8):
            solo = srv.call("gpt_small", {"prompt": prompts[i]}, timeout=600)["tokens"]
            if not np.array_equal(solo, outs[i]):
                fail(f"request {i}: solo tokens differ from batched")
        # an engine with 4 horizons of pages preempts and still matches
        maxp = -(-(dcfg.max_prompt_len + dcfg.max_new_tokens) // dcfg.page_size)
        srv.register_decode("gpt_small_tight", cfg, params,
                            dataclasses.replace(dcfg, num_pages=1 + 4 * maxp))
        pre0 = sm.DECODE_PREEMPTIONS.value
        t2 = time.perf_counter()
        tight = [f.result(900)["tokens"] for f in
                 [srv.submit("gpt_small_tight", {"prompt": p}) for p in prompts]]
        preempted = int(sm.DECODE_PREEMPTIONS.value - pre0)
        if preempted < 1:
            fail("the 4-horizon pool never preempted")
        for i, (a, b) in enumerate(zip(tight, outs)):
            if not np.array_equal(a, b):
                fail(f"request {i}: tokens after preemption differ from the first run")
        log(f"# serving gates: 32 answered; 8 solo = batched; 4-horizon pool preempted "
            f"{preempted} times in {time.perf_counter() - t2:.2f} s and matched all 32; "
            f"launches {launches} over {steps}")
    finally:
        srv.stop(drain=False, timeout=60)
    return {
        "launches": launches, "steps": steps, "wall_s": wall,
        "tokens_per_s": 32 * 64 / wall, "ttft_s": ttft,
        "latency_s": {"p50": float(np.percentile(lat, 50)), "p99": float(np.percentile(lat, 99))},
        "cfg": cfg, "params": params, "prompts": prompts,
    }


EMB_RTOL = 2e-2  # of max |embedding|: ~3x the flash-vs-dense gap of a sound run (PERF.md)
ENC_ROWS, ENC_SEQ = 1024, 128  # BASELINE config 5, as the reference's bench


def embed_rows(tft, cfg, params, frame, dev, verb: str):
    """One verb call of BERT-base embedding extraction on ``frame``:
    ``map_rows`` over ``compile_program(embed_row_program, block=False)``
    or ``map_blocks`` over ``compile_program(embed_program)``, compiled
    (shape analysis) outside the timed call, as the reference's bench does.
    Returns the [n, hidden] f32 embeddings and the verb call's host
    seconds."""
    from tensorframes_tpu_torch.models import transformer as tr

    rows = verb == "map_rows"
    fn = (tr.embed_row_program if rows else tr.embed_program)(cfg, params)
    prog = tft.compile_program(fn, frame, block=not rows, device=dev)
    t0 = time.perf_counter()
    emb = getattr(tft, verb)(prog, frame, device=dev).column_values("embedding")
    return emb, time.perf_counter() - t0


def encoder_path(tft, dev) -> dict:
    """BERT-base (12 layers, 768 wide, 12 heads, bf16 activations, f32
    weights from seed 0) over 1,024 rows of 128 tokens through both verbs
    with ``attention_impl="flash"``, counts reset just before and read
    just after each call: 12 flash launches per call. Then the gates: the
    two verbs agree, both agree with dense attention through the same
    verb and a broken attention does not, and a 64-row ``map_rows`` over
    int8 weights launches 48 int8 and 12 flash kernels."""
    import dataclasses

    import numpy as np
    from tensorframes_tpu_torch.kernels import flash_attention as kfa
    from tensorframes_tpu_torch.models import transformer as tr
    from tensorframes_tpu_torch.ops import attention as att

    cfg = tr.bert_base(attention_impl="flash")
    params = tr.init_params(cfg, seed=SEED, device=dev)
    tokens, _ = tr.synthetic_batch(cfg, ENC_ROWS, ENC_SEQ, seed=SEED)
    frame = tft.frame_from_arrays({"tokens": tokens}, num_blocks=1)
    embed_rows(tft, cfg, params, frame, dev, "map_blocks")  # warm-up (cuBLAS handles, pools)
    emb, secs, launches = {}, {}, {}
    for verb in ("map_rows", "map_blocks"):
        tft.kernels.LAUNCHES.reset()
        emb[verb], secs[verb] = embed_rows(tft, cfg, params, frame, dev, verb)
        launches[verb] = launch_counts(tft)
        if launches[verb]["flash_attention"] != cfg.num_layers:
            fail(f"{verb}: flash_attention launched {launches[verb]['flash_attention']} times "
                 f"in one call (want {cfg.num_layers}, one per layer)")
        if launches[verb]["flash_attention_mma"] != cfg.num_layers:
            fail(f"{verb}: {launches[verb]['flash_attention_mma']} of the {cfg.num_layers} flash "
                 "launches went to the tensor-core build (want all)")
        e = emb[verb]
        if e.shape != (ENC_ROWS, cfg.hidden) or e.dtype != np.float32 or not np.isfinite(e).all():
            fail(f"{verb}: embeddings of shape {e.shape} / {e.dtype} or not finite")
    rows_vs_blocks = float(np.abs(emb["map_rows"] - emb["map_blocks"]).max())

    dense_cfg = dataclasses.replace(cfg, attention_impl="dense")
    gaps = {}
    for verb in ("map_rows", "map_blocks"):
        dense, _ = embed_rows(tft, dense_cfg, params, frame, dev, verb)
        gaps[verb] = (float(np.abs(emb[verb] - dense).max()), float(np.abs(dense).max()))
    tol = EMB_RTOL * gaps["map_rows"][1]
    saved = att.flash_attention
    att.flash_attention = lambda q, k, v, causal=False, block_size=512: (
        kfa.flash_attention_reference(q, k[:, :, :64], v[:, :, :64], causal,
                                      kfa.default_scale(q.shape[-1])))
    try:  # attention that drops the last 64-key tile, through map_rows
        broken, _ = embed_rows(tft, cfg, params, frame, dev, "map_rows")
    finally:
        att.flash_attention = saved
    broken_gap = float(np.abs(broken - emb["map_rows"]).max())
    log(f"# encoder gates: map_rows vs map_blocks max |diff| {rows_vs_blocks:.6g}; flash vs "
        f"dense max |diff| map_rows {gaps['map_rows'][0]:.6g}, map_blocks "
        f"{gaps['map_blocks'][0]:.6g} (max |dense| {gaps['map_rows'][1]:.6g}, tolerance "
        f"{tol:.6g}); attention dropping the last key tile off by {broken_gap:.6g}")
    if rows_vs_blocks > tol:
        fail(f"map_rows and map_blocks embeddings differ by {rows_vs_blocks} (tolerance {tol})")
    for verb, (gap, _) in gaps.items():
        if gap > tol:
            fail(f"{verb}: flash embeddings off the dense ones by {gap} (tolerance {tol})")
    if broken_gap <= tol:
        fail(f"the embedding gate cannot see a broken attention ({broken_gap} <= {tol})")

    qparams = tr.quantize_params(params)
    small = tft.frame_from_arrays({"tokens": tokens[:64]}, num_blocks=1)
    embed_rows(tft, cfg, qparams, small, dev, "map_rows")  # warm-up
    tft.kernels.LAUNCHES.reset()
    qemb, qsecs = embed_rows(tft, cfg, qparams, small, dev, "map_rows")
    qlaunches = launch_counts(tft)
    if (qlaunches["int8_matmul"], qlaunches["int8_matmul_mma"], qlaunches["flash_attention"],
            qlaunches["flash_attention_mma"]) != (4 * cfg.num_layers, 4 * cfg.num_layers,
                                                  cfg.num_layers, cfg.num_layers):
        fail(f"int8 map_rows launched {qlaunches} in one call (want 48 int8_matmul and 12 "
             "flash_attention, all on the tensor cores)")
    qblocks, _ = embed_rows(tft, cfg, qparams, small, dev, "map_blocks")
    qgap = float(np.abs(qemb - qblocks).max())
    if not np.isfinite(qemb).all() or qgap > tol:
        fail(f"int8 map_rows embeddings not finite or off map_blocks' by {qgap} (tolerance {tol})")
    log(f"# encoder int8 leg: 64 rows through map_rows in {qsecs:.4f} s, launches {qlaunches}; "
        f"map_rows vs map_blocks max |diff| {qgap:.6g}; max |diff| to the f32-weight embeddings "
        f"{float(np.abs(qemb - emb['map_rows'][:64]).max()):.6g} (reported, not gated)")
    total = {k: launches["map_rows"][k] + launches["map_blocks"][k] for k in launches["map_rows"]}
    return {"launches": total, "seconds": secs,
            "rows_per_s": {v: ENC_ROWS / t for v, t in secs.items()},
            "cfg": cfg, "params": params, "frame": frame}


TRAIN_ROWS, TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS, TRAIN_LR = 16, 1024, 8, 10, 1e-3
# bf16 against the f32 forward of the same weights (TF32 off), of max |logit|:
# ~3x the gap of a sound run (1.26e-3 on an H100, PERF.md).
INCEPTION_RTOL = 4e-3
INC_ROWS, INC_BLOCK, INC_CHECK = 1024, 512, 64


def inception_logits(inc, cfg, params, images, dev):
    import torch

    with torch.inference_mode():
        return inc.forward(cfg, params, torch.from_numpy(images).to(dev)).float().cpu().numpy()


def inception_ratio(got, ref) -> float:
    """max |got - ref| over INCEPTION_RTOL·max |ref|."""
    import numpy as np

    return float(np.abs(got - ref).max() / (INCEPTION_RTOL * np.abs(ref).max()))


def conv_leaves(params: dict, leaf: str, fn) -> dict:
    """Inception ``params`` with ``fn`` applied to one leaf (``"scale"``
    or ``"bias"``) of every conv; the classifier as it is."""
    return {block: convs if block == "fc" else
            {name: {**p, leaf: fn(p[leaf])} for name, p in convs.items()}
            for block, convs in params.items()}


def random_affine(params: dict, seed: int) -> dict:
    """``params`` with every conv's folded-BN scale drawn from U(0.5, 1.5)
    and bias from N(0, 0.1), as a frozen graph's folded batch-norm gives
    them (``init_params`` folds an identity one, which would hide a
    dropped or misplaced affine)."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(seed)
    with_scale = conv_leaves(params, "scale", lambda t: (0.5 + torch.rand(
        t.shape, generator=g)).to(t.device, t.dtype))
    return conv_leaves(with_scale, "bias", lambda t: (0.1 * torch.randn(
        t.shape, generator=g)).to(t.device, t.dtype))


def inception_path(tft, dev) -> dict:
    """Inception-v3 scoring at full width (299x299, bf16, random weights
    from seed 0 through the port's ``init_params``, each conv's folded-BN
    scale and bias then drawn by ``random_affine``) over 1,024 synthetic
    images in two host blocks of 512 through ``map_blocks`` of a program
    compiled (shape analysis) beforehand, counts reset just before: a
    warm-up call, then a timed one (rows/s, peak memory). Then the gates: the verb's block 0 equals a direct ``forward`` call's
    scores and labels; on 64 images the bf16 logits lie within
    INCEPTION_RTOL of an f32 forward of the same weights with TF32 off in
    cuDNN and cuBLAS, labels equal wherever the reference's top-2 margin
    exceeds twice that (each logit may move by the tolerance), and three
    broken forwards (the convs' biases dropped, the last pool branch
    dropped, the average pool skipped) do not; a 64-image call over ``quantize_params``
    weights lies within the same tolerance of an f32 forward of its
    dequantized weights (as the bf16 forward rounds them)."""
    import numpy as np
    import torch
    from tensorframes_tpu_torch.models import inception as inc
    from tensorframes_tpu_torch.ops import quantize as q

    cfg = inc.inception_v3()
    params = random_affine(inc.init_params(cfg, seed=SEED, device=dev), SEED)
    images = inc.synthetic_images(cfg, INC_ROWS, seed=SEED)
    frame = tft.frame_from_arrays({"images": images}, num_blocks=INC_ROWS // INC_BLOCK)
    fn = inc.scoring_program(cfg, params)
    # shape analysis once, outside the timed calls, as the reference's bench does
    prog = tft.compile_program(fn, frame, device=dev)

    def score(frame):
        out = tft.map_blocks(prog, frame, device=dev)
        return out.column_values("scores"), out.column_values("label")

    t0 = time.perf_counter()
    score(frame)  # warm-up: cuDNN's algorithm choice, the allocator's pools
    warm_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    tft.kernels.LAUNCHES.reset()
    t1 = time.perf_counter()
    scores, labels = score(frame)
    wall = time.perf_counter() - t1
    peak = torch.cuda.max_memory_allocated()
    launches = launch_counts(tft)
    if scores.shape != (INC_ROWS, cfg.num_classes) or scores.dtype != np.float32:
        fail(f"inception scores of shape {scores.shape} / {scores.dtype}")
    if not np.isfinite(scores).all() or np.abs(scores.sum(1) - 1).max() > 1e-3:
        fail("inception scores not finite or not summing to 1")
    if labels.dtype != np.int32 or labels.min() < 0 or labels.max() >= cfg.num_classes:
        fail("inception labels out of range")
    with torch.inference_mode():
        direct = fn(torch.from_numpy(images[:INC_BLOCK]).to(dev))
    if not (np.array_equal(direct["scores"].cpu().numpy(), scores[:INC_BLOCK])
            and np.array_equal(direct["label"].cpu().numpy(), labels[:INC_BLOCK])):
        fail("inception: map_blocks block 0 differs from a direct forward")

    sub = images[:INC_CHECK]
    cfg32 = inc.inception_v3(compute_dtype="float32")
    # the weights the bf16 forward computes with, in f32: convs as asarray(w,
    # bf16) gives them, the classifier as asarray(w, f32) does
    to32 = lambda tree: q._tree_map(  # noqa: E731
        lambda path, leaf: q.asarray(leaf, torch.float32 if path[0] == "fc" else cfg.dtype)
        .float(), tree)
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        ref = inception_logits(inc, cfg32, to32(params), sub, dev)
        qparams = inc.quantize_params(params)
        qref = inception_logits(inc, cfg32, to32(qparams), sub, dev)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    got = inception_logits(inc, cfg, params, sub, dev)
    ratio = inception_ratio(got, ref)
    if not np.isfinite(got).all() or ratio > 1:
        fail(f"inception bf16 logits off the f32 forward by {ratio:.3f} of the tolerance")
    top2 = np.sort(ref, axis=1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 2 * INCEPTION_RTOL * np.abs(ref).max()
    if not np.array_equal(labels[:INC_CHECK][clear], ref.argmax(1)[clear]):
        fail("inception labels differ from the f32 forward's where its margin is clear")

    broken = {"folded-BN bias dropped": inception_ratio(inception_logits(
        inc, cfg, conv_leaves(params, "bias", torch.zeros_like), sub, dev), ref)}
    dropped = {**params, "mixed_e1": {**params["mixed_e1"], "bp": {
        **params["mixed_e1"]["bp"], "scale": torch.zeros_like(params["mixed_e1"]["bp"]["scale"])}}}
    broken["last pool branch dropped"] = inception_ratio(
        inception_logits(inc, cfg, dropped, sub, dev), ref)
    real_pool = inc._avgpool3
    inc._avgpool3 = lambda x: x
    try:
        broken["3x3 average pool skipped"] = inception_ratio(
            inception_logits(inc, cfg, params, sub, dev), ref)
    finally:
        inc._avgpool3 = real_pool
    for what, r in broken.items():
        if r <= 1:
            fail(f"inception: a broken forward ({what}) lies within the tolerance ({r:.3f})")

    qframe = tft.frame_from_arrays({"images": sub}, num_blocks=1)
    qprog = tft.compile_program(inc.scoring_program(cfg, qparams), qframe, device=dev)
    tft.map_blocks(qprog, qframe, device=dev).column_values("label")  # warm-up
    t2 = time.perf_counter()
    qlabels = tft.map_blocks(qprog, qframe, device=dev).column_values("label")
    qwall = time.perf_counter() - t2
    qratio = inception_ratio(inception_logits(inc, cfg, qparams, sub, dev), qref)
    if qratio > 1:
        fail(f"inception int8 logits off the f32 forward of their weights by {qratio:.3f}")
    qtop2 = np.sort(qref, axis=1)[:, -2:]
    qclear = qtop2[:, 1] - qtop2[:, 0] > 2 * INCEPTION_RTOL * np.abs(qref).max()
    if not np.array_equal(qlabels[qclear], qref.argmax(1)[qclear]):
        fail("inception int8 labels differ from the f32 forward's where its margin is clear")
    log(f"# inception gates: block 0 = direct forward; bf16 vs f32 {ratio:.4f} of the "
        f"tolerance ({int(clear.sum())} of {INC_CHECK} labels clear and equal); broken "
        + ", ".join(f"{k} {v:.3f}" for k, v in broken.items())
        + f"; int8 vs f32 of its weights {qratio:.4f} ({int(qclear.sum())} clear and equal)")
    return {
        "rows_per_s": INC_ROWS / wall, "wall_s": wall, "warm_s": warm_s,
        "peak_bytes": peak, "held_bytes": held, "launches": launches,
        "ratio": ratio, "broken": broken, "int8_ratio": qratio,
        "int8_rows_per_s": INC_CHECK / qwall, "weight_bytes": q.tree_nbytes(params),
        "frame": frame, "prog": prog, "images": images,
    }


PIPE_BLOCK = 128


def pinned_stats() -> dict:
    """PyTorch's pinned host allocator: the bytes of the pinned blocks it
    holds (cached ones too) and the blocks it has created, or {} where
    this torch lacks the statistics. (Its ``active_bytes`` only grow on
    the card's torch, so they are not read.)"""
    import torch

    stats = getattr(torch.cuda, "host_memory_stats", lambda: {})()
    return {k: stats[k] for k in ("allocated_bytes.current", "num_host_alloc") if k in stats}


@contextlib.contextmanager
def pinned_tracker():
    """Counts the bytes of the pinned tensors ``Tensor.pin_memory`` makes
    (the prefetcher's staging copies) while Python holds them; yields a
    dict whose ``peak`` is the most held at once. The allocator keeps a
    freed block until its copy has ended, so this is a lower bound of the
    pinned memory in use."""
    import weakref

    import torch

    live = {"now": 0, "peak": 0}
    lock = threading.Lock()  # the prefetch worker pins, any thread frees
    real = torch.Tensor.pin_memory

    def release(n):
        with lock:
            live["now"] -= n

    def tracked(self, *a, **k):
        t = real(self, *a, **k)
        n = t.numel() * t.element_size()
        with lock:
            live["now"] += n
            live["peak"] = max(live["peak"], live["now"])
        weakref.finalize(t, release, n)
        return t

    torch.Tensor.pin_memory = tracked
    try:
        yield live
    finally:
        torch.Tensor.pin_memory = real


def copy_rates(dev, nbytes: int) -> dict:
    """GB/s of one host-to-device copy of ``nbytes`` from pageable and from
    pinned host memory, by CUDA events around 5 copies after a warm-up."""
    import torch

    host = torch.empty(nbytes, dtype=torch.uint8)
    pinned = host.pin_memory()
    out = {}
    for name, src in (("pageable", host), ("pinned", pinned)):
        src.to(dev, non_blocking=True)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(5):
            src.to(dev, non_blocking=True)
        end.record()
        end.synchronize()
        out[name] = nbytes * 5 / (start.elapsed_time(end) / 1e3) / 1e9
    return out


def pipeline_leg(tft, dev, incep) -> dict:
    """The block pipeline on Inception-v3: the Inception leg's 1,024 images
    (299x299, scored in bf16) in 8 host blocks of 128 through
    ``map_blocks`` of the same compiled program, serial
    (``map_pipeline_depth`` 0, ``map_prefetch_depth`` 0) and pipelined
    (2, 2): each a warm-up call, a timed one (rows/s, peak device memory,
    the peak bytes of pinned staging copies alive at once, and the pinned
    allocator's pool around the call) and a profiled one (``Memcpy HtoD`` ms, the
    part of it under kernels, the device's busy share). The two modes'
    scores and labels must be equal bit for bit."""
    import torch

    frame = tft.frame_from_arrays({"images": incep["images"]},
                                  num_blocks=INC_ROWS // PIPE_BLOCK)

    def call():
        out = tft.map_blocks(incep["prog"], frame, device=dev)
        return out.column_values("scores"), out.column_values("label")

    out, results = {}, {}
    for mode, values in PIPELINE_MODES:
        with knobs(tft, **values):
            call()  # warm-up
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            pinned_before = pinned_stats()
            with pinned_tracker() as staged:
                t0 = time.perf_counter()
                results[mode] = call()
                wall = time.perf_counter() - t0
            peak, pinned = torch.cuda.max_memory_allocated(), pinned_stats()
            prof = timeline_profile(call)
        out[mode] = {"rows_per_s": INC_ROWS / wall, "wall_s": wall, "peak_bytes": peak,
                     "held_bytes": held, "pinned_staged_peak_bytes": staged["peak"],
                     "pinned_before": pinned_before, "pinned_after": pinned,
                     **{k: prof[k] for k in ("wall_ms", "busy_ms", "busy_share", "kernel_busy_ms",
                                             "kernel_busy_share", "htod_ms", "htod_events",
                                             "htod_overlap_ms")}}
        log(f"# pipeline inception-v3 {mode} ({INC_ROWS} images in {INC_ROWS // PIPE_BLOCK} "
            f"blocks of {PIPE_BLOCK}, depth {values['map_pipeline_depth']}, prefetch "
            f"{values['map_prefetch_depth']}): {INC_ROWS / wall:.1f} rows/s; peak device "
            f"memory {peak} bytes ({peak - held} above what was held); profiled "
            f"{prof['wall_ms']:.3f} ms, device busy {prof['busy_ms']:.3f} ms "
            f"({100 * prof['busy_share']:.1f}%), kernels alone {prof['kernel_busy_ms']:.3f} ms "
            f"({100 * prof['kernel_busy_share']:.1f}%), Memcpy HtoD {prof['htod_ms']:.3f} ms "
            f"in {prof['htod_events']} copies, {prof['htod_overlap_ms']:.3f} ms of it under "
            "kernels")
        log(f"# pipeline pinned host memory {mode}: peak {staged['peak']} bytes of staged "
            f"blocks alive at once; the allocator's pool before the timed call "
            f"{json.dumps(pinned_before)}, after it {json.dumps(pinned)}")
    block_bytes = INC_ROWS // (INC_ROWS // PIPE_BLOCK) * 299 * 299 * 3 * 4
    rates = copy_rates(dev, block_bytes)
    out["copy_gb_per_s"] = rates
    log(f"# pipeline host-to-device copy of one {block_bytes}-byte block: pageable "
        f"{rates['pageable']:.2f} GB/s, pinned {rates['pinned']:.2f} GB/s")
    for a, b in zip(results["serial"], results["pipelined"]):
        if a.dtype != b.dtype or a.tobytes() != b.tobytes():
            fail("pipeline: the pipelined Inception-v3 outputs differ from the serial ones")
    return out


# ---------------------------------------------------------------------------
# frozen GraphDefs, written here: the card's machine has no TensorFlow
# ---------------------------------------------------------------------------

def varint(x: int) -> bytes:
    x &= (1 << 64) - 1  # negative ints as two's-complement int64, as TF writes them
    out = bytearray()
    while True:
        b = x & 0x7F
        x >>= 7
        out.append(b | (0x80 if x else 0))
        if not x:
            return bytes(out)


def ld(field: int, payload: bytes) -> bytes:
    """A length-delimited field: a message, string or packed list."""
    return varint((field << 3) | 2) + varint(len(payload)) + payload


def vf(field: int, value: int) -> bytes:
    """A varint field."""
    return varint(field << 3) + varint(value)


def node_bytes(name: str, op: str, inputs=(), attrs=()) -> bytes:
    """One ``NodeDef``: its name, op, inputs and ``(key, AttrValue
    bytes)`` pairs."""
    b = ld(1, name.encode()) + ld(2, op.encode())
    for i in inputs:
        b += ld(3, i.encode())
    for k, v in attrs:
        b += ld(5, ld(1, k.encode()) + ld(2, v))
    return b


_TF_ENUM = {"float32": 1, "int32": 3, "int64": 9}


def _attr_ints(vals) -> bytes:
    """AttrValue.list.i, packed (strides, ksize)."""
    return ld(1, ld(3, b"".join(varint(v) for v in vals)))


def _attr_str(s: bytes) -> bytes:
    return ld(2, s)


def _shape_bytes(dims) -> bytes:
    return b"".join(ld(2, vf(1, d)) for d in dims)


class GraphWriter:
    """A frozen GraphDef's bytes, node by node, with the wire encoding of
    ``graph.proto``/``node_def.proto``/``attr_value.proto``/
    ``tensor.proto``: the subset the importer reads. Consts carry
    ``tensor_content``."""

    def __init__(self):
        self.parts = []
        self.count = 0

    def node(self, op: str, inputs=(), name=None, **attrs) -> str:
        name = name or f"{op.lower()}_{self.count}"
        self.count += 1
        self.parts.append(ld(1, node_bytes(name, op, inputs, attrs.items())))
        return name

    def const(self, arr, name=None) -> str:
        import numpy as np

        arr = np.ascontiguousarray(arr)
        enum = _TF_ENUM[arr.dtype.name]
        tensor = vf(1, enum) + ld(2, _shape_bytes(arr.shape)) + ld(4, arr.tobytes())
        return self.node("Const", name=name, dtype=vf(6, enum), value=ld(8, tensor))

    def placeholder(self, name: str, dims) -> str:
        return self.node("Placeholder", name=name, dtype=vf(6, 1),
                         shape=ld(7, _shape_bytes(dims)))

    def bytes(self) -> bytes:
        return b"".join(self.parts)


def inception_graphdef(cfg, params, skip_scale=None) -> bytes:
    """The port's Inception-v3 (``models/inception.py``: its config and
    weights, any device) as a frozen NHWC GraphDef, each conv decomposed
    as keras's freezer leaves it: ``Conv2D`` (HWIO ``Const``) → ``Mul``
    (folded-BN scale) → ``AddV2`` (bias) → ``Relu``; the pools as
    ``MaxPool``/``AvgPool`` (the 3x3 average pool SAME, stride 1), the
    branches as ``ConcatV2``, the global pool as ``Mean``, the classifier
    as ``MatMul`` + ``BiasAdd`` (``logits``), then ``Softmax``
    (``scores``) and ``ArgMax`` (``label``, int32). The input is
    ``images`` ``[-1, S, S, 3]`` float32. ``skip_scale`` names one conv
    (``"stem/c1"``) whose ``Mul`` is left out: a broken graph."""
    import numpy as np

    g = GraphWriter()
    one = _attr_ints([1, 1, 1, 1])

    def f32(t):
        return t.detach().float().cpu().numpy()

    def conv(p, x, tag, stride=1, padding=b"SAME"):
        w = f32(p["w"].permute(2, 3, 1, 0))  # [cout, cin, kh, kw] → HWIO
        y = g.node("Conv2D", [x, g.const(w)], strides=_attr_ints([1, stride, stride, 1]),
                   padding=_attr_str(padding), data_format=_attr_str(b"NHWC"), dilations=one)
        if tag != skip_scale:
            y = g.node("Mul", [y, g.const(f32(p["scale"]))])
        return g.node("Relu", [g.node("AddV2", [y, g.const(f32(p["bias"]))])])

    def pool(op, x, k, s, padding):
        return g.node(op, [x], ksize=_attr_ints([1, k, k, 1]), strides=_attr_ints([1, s, s, 1]),
                      padding=_attr_str(padding), data_format=_attr_str(b"NHWC"))

    def cat(xs):
        return g.node("ConcatV2", [*xs, g.const(np.asarray(3, np.int32))])

    def chain(p, x, block, names, last_stride=1, last_padding=b"SAME"):
        for i, nm in enumerate(names):
            last = i == len(names) - 1
            x = conv(p[nm], x, f"{block}/{nm}", last_stride if last else 1,
                     last_padding if last else b"SAME")
        return x

    x = g.placeholder("images", [-1, cfg.image_size, cfg.image_size, 3])
    s = params["stem"]
    x = conv(s["c1"], x, "stem/c1", 2, b"VALID")
    x = conv(s["c2"], x, "stem/c2", 1, b"VALID")
    x = conv(s["c3"], x, "stem/c3")
    x = pool("MaxPool", x, 3, 2, b"VALID")
    x = conv(s["c4"], x, "stem/c4")
    x = conv(s["c5"], x, "stem/c5", 1, b"VALID")
    x = pool("MaxPool", x, 3, 2, b"VALID")
    for i in range(3):
        b, p = f"mixed_a{i}", params[f"mixed_a{i}"]
        x = cat([chain(p, x, b, ["b1"]), chain(p, x, b, ["b5_1", "b5_2"]),
                 chain(p, x, b, ["b3_1", "b3_2", "b3_3"]),
                 chain(p, pool("AvgPool", x, 3, 1, b"SAME"), b, ["bp"])])
    p = params["mixed_b"]
    x = cat([chain(p, x, "mixed_b", ["b3"], 2, b"VALID"),
             chain(p, x, "mixed_b", ["bd_1", "bd_2", "bd_3"], 2, b"VALID"),
             pool("MaxPool", x, 3, 2, b"VALID")])
    for i in range(4):
        b, p = f"mixed_c{i}", params[f"mixed_c{i}"]
        x = cat([chain(p, x, b, ["b1"]), chain(p, x, b, ["b7_1", "b7_2", "b7_3"]),
                 chain(p, x, b, ["bd_1", "bd_2", "bd_3", "bd_4", "bd_5"]),
                 chain(p, pool("AvgPool", x, 3, 1, b"SAME"), b, ["bp"])])
    p = params["mixed_d"]
    x = cat([chain(p, x, "mixed_d", ["b3_1", "b3_2"], 2, b"VALID"),
             chain(p, x, "mixed_d", ["b7_1", "b7_2", "b7_3", "b7_4"], 2, b"VALID"),
             pool("MaxPool", x, 3, 2, b"VALID")])
    for i in range(2):
        b, p = f"mixed_e{i}", params[f"mixed_e{i}"]
        b3 = chain(p, x, b, ["b3_1"])
        bd = chain(p, x, b, ["bd_1", "bd_2"])
        x = cat([chain(p, x, b, ["b1"]),
                 cat([chain(p, b3, b, ["b3_2a"]), chain(p, b3, b, ["b3_2b"])]),
                 cat([chain(p, bd, b, ["bd_3a"]), chain(p, bd, b, ["bd_3b"])]),
                 chain(p, pool("AvgPool", x, 3, 1, b"SAME"), b, ["bp"])])
    x = g.node("Mean", [x, g.const(np.asarray([1, 2], np.int32))], keep_dims=vf(5, 0))
    x = g.node("MatMul", [x, g.const(f32(params["fc"]["w"]))])
    logits = g.node("BiasAdd", [x, g.const(f32(params["fc"]["b"]))], name="logits",
                    data_format=_attr_str(b"NHWC"))
    g.node("Softmax", [logits], name="scores")
    g.node("ArgMax", [logits, g.const(np.asarray(1, np.int32))], name="label",
           output_type=vf(6, 3))
    return g.bytes()


PAD_SIZES = (17, 16)  # odd and even: TF's SAME split differs between them
PAD_CHANNELS = 8
PAD_RTOL = 1e-5  # of max |CPU output|: f32 on the card (TF32 off) against the CPU


def padding_graphdef(seed: int = SEED):
    """Stride-2 SAME ops at an odd and an even size, each on its own
    ``x{size}`` placeholder ``[-1, size, size, 8]``: ``Conv2D`` 3x3 and
    2x2, ``DepthwiseConv2dNative`` 3x3 (multiplier 2), ``MaxPool`` and
    ``AvgPool`` 3x3. Returns ``(bytes, fetches)``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    g = GraphWriter()
    s2, same = _attr_ints([1, 2, 2, 1]), _attr_str(b"SAME")
    c = PAD_CHANNELS
    fetches = []
    for size in PAD_SIZES:
        x = g.placeholder(f"x{size}", [-1, size, size, c])
        for name, shape in (("conv3", (3, 3, c, 16)), ("conv2", (2, 2, c, 16))):
            w = g.const((rng.standard_normal(shape) / np.sqrt(np.prod(shape[:3]))).astype(np.float32))
            fetches.append(g.node("Conv2D", [x, w], name=f"{name}_{size}", strides=s2,
                                  padding=same))
        w = g.const((rng.standard_normal((3, 3, c, 2)) / 3).astype(np.float32))
        fetches.append(g.node("DepthwiseConv2dNative", [x, w], name=f"dw3_{size}", strides=s2,
                              padding=same))
        for op in ("MaxPool", "AvgPool"):
            fetches.append(g.node(op, [x], name=f"{op.lower()}3_{size}",
                                  ksize=_attr_ints([1, 3, 3, 1]), strides=s2, padding=same))
    return g.bytes(), fetches


def padding_feeds(n: int = 4, seed: int = SEED) -> dict:
    import numpy as np

    rng = np.random.default_rng(seed + 1)
    return {f"x{s}": rng.standard_normal((n, s, s, PAD_CHANNELS), dtype=np.float32)
            for s in PAD_SIZES}


def padding_ratio(tft, data: bytes, fetches, feeds: dict, dev, want: dict) -> float:
    """max over fetches of max |card - CPU| over PAD_RTOL·max |CPU|, the
    card's import f32 with TF32 off."""
    import numpy as np
    import torch

    prog = tft.program_from_graphdef(tft.parse_graphdef(data), fetches=fetches,
                                     compute_dtype=None, device=dev)
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.inference_mode():
            got = prog.fn({k: torch.from_numpy(v).to(dev) for k, v in feeds.items()})
            got = {k: v.cpu().numpy() for k, v in got.items()}
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    return max(float(np.abs(got[f] - want[f]).max() / (PAD_RTOL * np.abs(want[f]).max()))
               for f in fetches)


def padding_path(tft, dev) -> dict:
    """The padding graph on the card (f32, TF32 off) against the same
    import on the CPU, within PAD_RTOL; the same with TF's SAME split put
    on the wrong side (the odd row or column before) must fall outside."""
    import torch
    from tensorframes_tpu_torch import graphdef as gd

    data, fetches = padding_graphdef()
    feeds = padding_feeds()
    cpu = tft.program_from_graphdef(tft.parse_graphdef(data), fetches=fetches,
                                    compute_dtype=None, device="cpu")
    with torch.inference_mode():
        want = {k: v.numpy() for k, v in cpu.fn(
            {k: torch.from_numpy(v) for k, v in feeds.items()}).items()}
    ratio = padding_ratio(tft, data, fetches, feeds, dev, want)
    if ratio > 1:
        fail(f"padding graph: the card off the CPU by {ratio:.3f} of the tolerance")
    real = gd._same_pads
    gd._same_pads = lambda *a: real(*a)[::-1]
    try:
        broken = padding_ratio(tft, data, fetches, feeds, dev, want)
    finally:
        gd._same_pads = real
    if broken <= 1:
        fail(f"padding graph: a split on the wrong side lies within the tolerance ({broken:.3f})")
    log(f"# padding graph (stride-2 SAME Conv2D 3x3/2x2, depthwise, MaxPool, AvgPool at "
        f"{PAD_SIZES}): card vs CPU {ratio:.4f} of the tolerance; split on the wrong side "
        f"{broken:.1f}")
    return {"ratio": ratio, "broken": broken}


# f32 import (TF32 off) against the native f32 forward of the same weights, of
# max |logit|: both compute in f32 and differ in the order of each conv's sums
# (cuDNN's algorithms) and in the folded-BN affine (Mul then AddV2 against one
# addcmul)
IMPORT_F32_RTOL = 1e-4


def graph_logits(tft, prog, images, dev, column: str = "logits"):
    frame = tft.frame_from_arrays({"images": images}, num_blocks=1)
    return tft.map_blocks(prog, frame, device=dev).column_values(column)


def dequantized_inception(params: dict, dev) -> dict:
    """``params`` (f32) with every conv filter and the classifier's weight
    replaced by what the importer's ``quantize_weights=True`` computes
    with: HWIO filters and the ``[features, classes]`` weight quantized
    per output channel on the CPU, dequantized to f32."""
    import torch
    from tensorframes_tpu_torch.ops.quantize import quantize

    def dq(w_io):  # output channel last
        return quantize(w_io.detach().float().cpu().contiguous(), channel_axis=-1).dequantize()

    out = {}
    for block, convs in params.items():
        if block == "fc":
            out[block] = {"w": dq(convs["w"]).to(dev), "b": convs["b"]}
            continue
        out[block] = {}
        for name, p in convs.items():
            hwio = dq(p["w"].permute(2, 3, 1, 0))
            w = hwio.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last).to(dev)
            out[block][name] = {**p, "w": w}
    return out


def imported_inception_path(tft, dev, incep) -> dict:
    """BASELINE config 4 as its users run it: the native leg's
    Inception-v3 (seed 0, full width, the same random folded-BN scale and
    bias, in f32) written as a frozen GraphDef by :func:`inception_graphdef`,
    read back by ``load_graphdef`` (``relax_lead_dim=True``,
    ``compute_dtype="auto"``: bf16 on the card) and scored over the native
    leg's 1,024 images in its two blocks of 512 through ``map_blocks``: a
    warm-up call, then a timed one (rows/s, peak memory). Gates on 64
    images: the bf16 logits within INCEPTION_RTOL of the native f32
    forward (TF32 off) of the weights they compute with (filters and the
    classifier's weight rounded to bf16), the f32 import
    (``compute_dtype=None``) within IMPORT_F32_RTOL of the f32 forward of
    the unrounded weights, labels equal
    where its margin is clear; a SAME AvgPool divided by the full window
    and a graph without the stem's first folded-BN ``Mul`` both outside
    INCEPTION_RTOL; a ``quantize_weights=True`` import within
    INCEPTION_RTOL of the f32 forward of its dequantized weights,
    launching ``int8_matmul`` once a call (the classifier, 1,000 columns:
    the scalar build)."""
    import tempfile

    import numpy as np
    import torch
    from tensorframes_tpu_torch import graphdef as gd
    from tensorframes_tpu_torch.models import inception as inc

    cfg32 = inc.inception_v3(compute_dtype="float32")
    params32 = random_affine(inc.init_params(cfg32, seed=SEED, device=dev), SEED)
    t0 = time.perf_counter()
    data = inception_graphdef(cfg32, params32)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_graphs_"))
    path = tmp / "inception_v3_frozen.pb"
    path.write_bytes(data)
    write_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    prog = tft.load_graphdef(str(path), fetches=["logits", "scores", "label"],
                             relax_lead_dim=True, device=dev)
    torch.cuda.synchronize()
    import_s = time.perf_counter() - t1
    frame = incep["frame"]

    def score():
        out = tft.map_blocks(prog, frame, device=dev)
        return out.column_values("logits"), out.column_values("label")

    t2 = time.perf_counter()
    score()  # warm-up
    warm_s = time.perf_counter() - t2
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    tft.kernels.LAUNCHES.reset()
    t3 = time.perf_counter()
    logits, labels = score()
    wall = time.perf_counter() - t3
    peak = torch.cuda.max_memory_allocated()
    launches = launch_counts(tft)
    if logits.shape != (INC_ROWS, cfg32.num_classes) or not np.isfinite(logits).all():
        fail(f"imported inception logits of shape {logits.shape}, or not finite")
    if labels.dtype != np.int32 or not np.array_equal(labels, logits.argmax(1)):
        fail("imported inception labels are not the argmax of its logits")

    sub = incep["images"][:INC_CHECK]
    # the weights the bf16 import computes with: conv filters and the
    # classifier's weight rounded to bf16 (the matmul-class ops' cast), the
    # folded-BN scale and bias exact f32
    rounded = {block: {k: v.to(torch.bfloat16).float() if k == "w" else v
                       for k, v in convs.items()} if block == "fc" else
               {name: {**p, "w": p["w"].to(torch.bfloat16).float()} for name, p in convs.items()}
               for block, convs in params32.items()}
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        ref = inception_logits(inc, cfg32, rounded, sub, dev)
        ref32 = inception_logits(inc, cfg32, params32, sub, dev)
        qref = inception_logits(inc, cfg32, dequantized_inception(params32, dev), sub, dev)
        prog32 = tft.load_graphdef(str(path), fetches=["logits"], relax_lead_dim=True,
                                   compute_dtype=None, device=dev)
        got32 = graph_logits(tft, prog32, sub, dev)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    del prog32
    ratio = inception_ratio(logits[:INC_CHECK], ref)
    if ratio > 1:
        fail(f"imported inception bf16 logits off the f32 forward by {ratio:.3f} of the tolerance")
    ratio32 = float(np.abs(got32 - ref32).max() / (IMPORT_F32_RTOL * np.abs(ref32).max()))
    if ratio32 > 1:
        fail(f"imported inception f32 logits off the f32 forward by {ratio32:.3f} of the tolerance")
    top2 = np.sort(ref, axis=1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 2 * INCEPTION_RTOL * np.abs(ref).max()
    if not np.array_equal(labels[:INC_CHECK][clear], ref.argmax(1)[clear]):
        fail("imported inception labels differ from the f32 forward's where its margin is clear")

    broken = {}
    real_counts = gd._Ctx.pool_counts
    gd._Ctx.pool_counts = lambda self, h, w, kh, kw, sh, sw: torch.full(
        (1, 1, -(-h // sh), -(-w // sw)), float(kh * kw), device=self.device)
    try:
        bad = tft.load_graphdef(str(path), fetches=["logits"], relax_lead_dim=True, device=dev)
        broken["SAME AvgPool over the full window"] = inception_ratio(
            graph_logits(tft, bad, sub, dev), ref)
    finally:
        gd._Ctx.pool_counts = real_counts
    bad = tft.program_from_graphdef(
        tft.parse_graphdef(inception_graphdef(cfg32, params32, skip_scale="stem/c1")),
        fetches=["logits"], relax_lead_dim=True, device=dev)
    broken["stem folded-BN Mul skipped"] = inception_ratio(graph_logits(tft, bad, sub, dev), ref)
    del bad
    for what, r in broken.items():
        if r <= 1:
            fail(f"imported inception: a broken import ({what}) lies within the tolerance "
                 f"({r:.3f})")

    qprog = tft.load_graphdef(str(path), fetches=["logits"], relax_lead_dim=True,
                              quantize_weights=True, device=dev)
    graph_logits(tft, qprog, sub, dev)  # warm-up
    tft.kernels.LAUNCHES.reset()
    t4 = time.perf_counter()
    qlogits = graph_logits(tft, qprog, sub, dev)
    qwall = time.perf_counter() - t4
    qlaunches = launch_counts(tft)
    if qlaunches["int8_matmul"] != 1 or qlaunches.get("int8_matmul_mma", 0) != 0:
        fail(f"imported inception int8: int8_matmul launched {qlaunches['int8_matmul']} times, "
             f"{qlaunches.get('int8_matmul_mma', 0)} on the mma build (want 1, 0: the scalar "
             "build for 1,000 classes)")
    qratio = inception_ratio(qlogits, qref)
    if qratio > 1:
        fail(f"imported inception int8 logits off the f32 forward of their weights by "
             f"{qratio:.3f}")
    path.unlink()
    log(f"# imported inception gates: bf16 vs f32 forward {ratio:.4f} of INCEPTION_RTOL "
        f"({int(clear.sum())} of {INC_CHECK} labels clear and equal); f32 import vs f32 "
        f"forward {ratio32:.4f} of IMPORT_F32_RTOL; broken "
        + ", ".join(f"{k} {v:.3f}" for k, v in broken.items())
        + f"; int8 import vs f32 of its weights {qratio:.4f}, int8_matmul {qlaunches['int8_matmul']}"
        f" launch a call (scalar build)")
    return {
        "rows_per_s": INC_ROWS / wall, "wall_s": wall, "warm_s": warm_s,
        "peak_bytes": peak, "held_bytes": held, "launches": launches,
        "graph_bytes": len(data), "graph_nodes": len(tft.parse_graphdef(data)),
        "write_s": write_s, "import_s": import_s,
        "ratio": ratio, "ratio_f32": ratio32, "broken": broken, "int8_ratio": qratio,
        "int8_rows_per_s": INC_CHECK / qwall, "int8": {"launches": qlaunches},
        "prog": prog, "frame": frame,
    }


VGG_ROWS, VGG_BLOCK, VGG_CHECK = 512, 256, 64
VGG_BIAS_STD = 0.2  # init_params' biases are zero; drawn ones make a dropped bias show
VGG_TOP_K = 5
# bf16 against the f32 forward of the same weights (TF32 off), of max |logit|
VGG_RTOL = 2e-2


def vgg_logits(vgg, cfg, params, images, dev):
    import torch

    with torch.inference_mode():
        return vgg.forward(cfg, params, torch.from_numpy(images).to(dev)).float().cpu().numpy()


def vgg_path(tft, dev) -> dict:
    """VGG-16 at full width (224x224, bf16, ``init_params`` seed 0, every
    bias then drawn from N(0, VGG_BIAS_STD)): 512 synthetic images in two
    host blocks of 256 through ``map_blocks(scoring_program)``, a warm-up
    call, then a timed one (rows/s, peak memory). Gates: block 0 equal
    bit for bit to a direct ``forward`` + softmax + top-k; the top-k
    values equal to the sorted scores and to the scores at the top-k
    indices; on 64 images the bf16 logits within VGG_RTOL of the f32
    forward of the same weights (TF32 off), while a forward without the
    last conv's bias lies outside; a 64-image ``quantize_params`` leg
    within VGG_RTOL of the f32 forward of its dequantized weights,
    launching ``int8_matmul`` 3 times a call (fc6 and fc7 on the mma
    build, fc8 on the scalar one). Then ``save_program`` /
    ``load_program`` round-trip the scoring program: at 4 and 16 images
    the loaded program returns the saved one's bits."""
    import tempfile

    import numpy as np
    import torch
    from tensorframes_tpu_torch.models import vgg
    from tensorframes_tpu_torch.ops import quantize as q

    cfg = vgg.vgg_16()
    params = vgg.init_params(cfg, seed=SEED, device=dev)
    g = torch.Generator().manual_seed(SEED)
    params = {k: {**p, "b": (VGG_BIAS_STD * torch.randn(p["b"].shape, generator=g)).to(
        dev, p["b"].dtype)} for k, p in params.items()}
    images = vgg.synthetic_images(cfg, VGG_ROWS, seed=SEED)
    frame = tft.frame_from_arrays({"images": images}, num_blocks=VGG_ROWS // VGG_BLOCK)
    fn = vgg.scoring_program(cfg, params, top_k=VGG_TOP_K)
    prog = tft.compile_program(fn, frame, device=dev)
    cols = ("scores", "top_idx", "top_val")

    def score(frame):
        out = tft.map_blocks(prog, frame, device=dev)
        return {c: out.column_values(c) for c in cols}

    t0 = time.perf_counter()
    score(frame)
    warm_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    tft.kernels.LAUNCHES.reset()
    t1 = time.perf_counter()
    out = score(frame)
    wall = time.perf_counter() - t1
    peak = torch.cuda.max_memory_allocated()
    launches = launch_counts(tft)
    scores = out["scores"]
    if scores.shape != (VGG_ROWS, cfg.num_classes) or not np.isfinite(scores).all() or np.abs(
            scores.sum(1) - 1).max() > 1e-3:
        fail("vgg scores not finite, of the wrong shape or not summing to 1")
    with torch.inference_mode():
        direct = fn(torch.from_numpy(images[:VGG_BLOCK]).to(dev))
    for c in cols:
        if not np.array_equal(direct[c].cpu().numpy(), out[c][:VGG_BLOCK]):
            fail(f"vgg: map_blocks block 0 {c} differs from a direct forward")
    desc = -np.sort(-scores, axis=1)[:, :VGG_TOP_K]
    if not (np.array_equal(out["top_val"], desc) and np.array_equal(
            np.take_along_axis(scores, out["top_idx"].astype(np.int64), 1), out["top_val"])):
        fail("vgg: top-k differs from the sorted scores")

    sub = images[:VGG_CHECK]
    cfg32 = vgg.vgg_16(compute_dtype="float32")
    to32 = lambda tree: q._tree_map(  # noqa: E731
        lambda path, leaf: q.asarray(leaf, torch.float32 if path[0].startswith("fc")
                                     else cfg.dtype).float(), tree)
    qparams = vgg.quantize_params(params)
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        ref = vgg_logits(vgg, cfg32, to32(params), sub, dev)
        qref = vgg_logits(vgg, cfg32, to32(qparams), sub, dev)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32

    def vratio(got, want):
        return float(np.abs(got - want).max() / (VGG_RTOL * np.abs(want).max()))

    got = vgg_logits(vgg, cfg, params, sub, dev)
    ratio = vratio(got, ref)
    if not np.isfinite(got).all() or ratio > 1:
        fail(f"vgg bf16 logits off the f32 forward by {ratio:.3f} of the tolerance")
    nobias = {**params, "conv5_3": {**params["conv5_3"],
                                    "b": torch.zeros_like(params["conv5_3"]["b"])}}
    broken = vratio(vgg_logits(vgg, cfg, nobias, sub, dev), ref)
    if broken <= 1:
        fail(f"vgg: a forward without the last conv's bias lies within the tolerance "
             f"({broken:.3f})")

    qframe = tft.frame_from_arrays({"images": sub}, num_blocks=1)
    qprog = tft.compile_program(vgg.scoring_program(cfg, qparams, top_k=VGG_TOP_K), qframe,
                                device=dev)
    tft.map_blocks(qprog, qframe, device=dev).column_values("top_idx")  # warm-up
    tft.kernels.LAUNCHES.reset()
    t2 = time.perf_counter()
    tft.map_blocks(qprog, qframe, device=dev).column_values("top_idx")
    qwall = time.perf_counter() - t2
    qlaunches = launch_counts(tft)
    if qlaunches["int8_matmul"] != 3 or qlaunches.get("int8_matmul_mma", 0) != 2:
        fail(f"vgg int8: int8_matmul launched {qlaunches['int8_matmul']} times, "
             f"{qlaunches.get('int8_matmul_mma', 0)} on the mma build (want 3, 2)")
    qratio = vratio(vgg_logits(vgg, cfg, qparams, sub, dev), qref)
    if qratio > 1:
        fail(f"vgg int8 logits off the f32 forward of their weights by {qratio:.3f}")

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_programs_"))
    saved_path = tmp / "vgg16_scoring.pt2"
    t3 = time.perf_counter()
    tft.save_program(prog, str(saved_path), device=dev)
    save_s = time.perf_counter() - t3
    saved_bytes = saved_path.stat().st_size
    t4 = time.perf_counter()
    loaded = tft.load_program(str(saved_path))
    load_s = time.perf_counter() - t4
    for n in (4, 16):
        x = torch.from_numpy(images[:n]).to(dev)
        with torch.inference_mode():
            a, b = prog.fn({"images": x}), loaded.fn({"images": x})
        for c in cols:
            if a[c].shape != (n, *a[c].shape[1:]) or not torch.equal(a[c], b[c]):
                fail(f"save_program/load_program: {c} at {n} images differs from the saved "
                     "program's")
    saved_path.unlink()
    log(f"# vgg gates: block 0 = direct forward; top-k = sorted scores; bf16 vs f32 "
        f"{ratio:.4f} of VGG_RTOL, conv5_3 bias dropped {broken:.3f}; int8 vs f32 of its "
        f"weights {qratio:.4f}, int8_matmul {qlaunches['int8_matmul']} launches a call "
        f"({qlaunches.get('int8_matmul_mma', 0)} mma); save_program {save_s:.2f} s "
        f"({saved_bytes} bytes), load_program {load_s:.2f} s, loaded = saved bit for bit at "
        "4 and 16 images")
    return {
        "rows_per_s": VGG_ROWS / wall, "wall_s": wall, "warm_s": warm_s,
        "peak_bytes": peak, "held_bytes": held, "launches": launches, "ratio": ratio,
        "broken": broken, "int8_ratio": qratio, "int8_rows_per_s": VGG_CHECK / qwall,
        "int8": {"launches": qlaunches}, "weight_bytes": q.tree_nbytes(params),
        "save_s": save_s, "load_s": load_s, "saved_bytes": saved_bytes,
    }



# The first loss: random tied embeddings of scale 0.02 against unit-variance
# final hidden states give logits of std sqrt(768) * 0.02 ~ 0.55, so the
# expected cross entropy is ln(32,000) + 0.55^2 / 2 ~ 10.53; a window of
# +-1 around ln(32,000) leaves room for what the layers add and catches a
# forward that is off by a scale.
FIRST_LOSS_WINDOW = 1.0
GRAD_RTOL = 5e-2  # of each leaf's max |grad|, flash against dense: ~3x the sound gap (PERF.md)
LOSS_ATOL = 2e-4  # flash against dense, one step's loss: ~3x the sound gap (PERF.md)


def train_state(tr, cfg, dev):
    """Fresh f32 parameters from seed 0, their AdamW (optax's defaults at
    lr 1e-3), and ``step_fn(state, batch)`` for ``train_on_frame``."""
    params = tr.init_params(cfg, seed=SEED, device=dev)
    opt = tr.adamw(params, TRAIN_LR)
    step = tr.make_train_step(cfg, opt)

    def step_fn(state, batch):
        p, opt_state, loss = step(*state, batch["tokens"], batch["targets"])
        return (p, opt_state), loss

    return params, opt, step, step_fn


def leaf_grads(tr, cfg, params, tokens, targets):
    """One step's loss and the gradient of every parameter leaf."""
    import torch

    leaves = tr.tree_leaves(params)
    loss = tr.loss_fn(cfg, params, tokens, targets)
    return loss.detach(), torch.autograd.grad(loss, leaves)


def training_path(tft, dev) -> dict:
    """gpt_small (vocab 32,000, 12 x 768, 12 heads, max_seq_len 1024, bf16
    activations, f32 parameters from seed 0) with flash attention, trained
    for 10 steps straight off a frame of 16 rows x 1024 tokens
    (``synthetic_batch`` seed 0) by ``training.train_on_frame``: batches of
    8 rows, shuffled per epoch (two batches an epoch), prefetched two
    ahead. Counts reset just before; each step must launch the flash
    forward, dK/dV and dQ kernels 12 times each, on their tensor-core
    builds. Then the gates: finite
    losses, the first near ln(32,000), the last below the first; the
    batches each step received equal ``iterate_batches``'s bit for bit; one
    more step with ``remat=True`` launches the forward 24 times (and each
    backward kernel 12), all on the tensor cores; one
    step's loss and per-leaf gradients with flash agree with dense
    attention, and a step whose backward leaves out ``di`` does not."""
    import dataclasses
    import math

    import numpy as np
    import torch
    from tensorframes_tpu_torch.kernels import flash_attention as kfa
    from tensorframes_tpu_torch.models import generation as gen
    from tensorframes_tpu_torch.models import transformer as tr

    cfg = gen.gpt_small(attention_impl="flash")
    tokens, targets = tr.synthetic_batch(cfg, TRAIN_ROWS, TRAIN_SEQ, seed=SEED)
    frame = tft.frame_from_arrays({"tokens": tokens, "targets": targets})
    params, opt, step, step_fn = train_state(tr, cfg, dev)
    received, losses, per_step, first_done = [], [], [], []

    # the timed loop stays train_on_frame's own: the wrapper keeps a
    # reference to each batch (no copy, no device work), on_step keeps the
    # loss tensor and a host-side launch count, and only the first step
    # waits for the card, to stamp the start of steps 2-10
    def recording(state, batch):
        received.append(batch)
        return step_fn(state, batch)

    def on_step(i, loss):
        losses.append(loss)
        per_step.append(launch_counts(tft))
        if i == 1:
            torch.cuda.synchronize()
            first_done.append(time.perf_counter())

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev)  # the earlier paths' tensors and the weights
    tft.kernels.LAUNCHES.reset()
    t0 = time.perf_counter()
    (params, _), ran = tft.training.train_on_frame(
        recording, (params, opt.state), frame, ["tokens", "targets"], batch_size=TRAIN_BATCH,
        num_steps=TRAIN_STEPS, shuffle=True, seed=SEED, prefetch=2, on_step=on_step, device=dev)
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    wall = t_end - t0
    launches = launch_counts(tft)
    peak = torch.cuda.max_memory_allocated(dev)
    losses = [float(x) for x in losses]
    steady = (t_end - first_done[0]) / (len(losses) - 1)
    log(f"# training gpt_small flash, 10 steps of {TRAIN_BATCH} x {TRAIN_SEQ} tokens: losses "
        + ", ".join(f"{x:.6f}" for x in losses) + f"; launches {launches}; peak memory "
        f"{peak / 2**30:.3f} GiB, {(peak - held) / 2**30:.3f} GiB above the "
        f"{held / 2**30:.3f} GiB held before the first step")

    if ran != TRAIN_STEPS:
        fail(f"train_on_frame ran {ran} steps (want {TRAIN_STEPS})")
    prev = {k: 0 for k in launches}
    for i, snap in enumerate(per_step):
        got = {k: snap[k] - prev[k] for k in TRAINING_BUILDS}
        if set(got.values()) != {cfg.num_layers}:
            fail(f"training step {i + 1} launched {got} (want {cfg.num_layers} of each, every "
                 "flash kernel on the tensor cores)")
        prev = snap
    per_epoch = TRAIN_ROWS // TRAIN_BATCH
    for i, batch in enumerate(received):  # epoch e is shuffled with seed + e
        ref = list(tft.io.iterate_batches(frame, ["tokens", "targets"], TRAIN_BATCH, shuffle=True,
                                          seed=SEED + i // per_epoch,
                                          drop_remainder=True))[i % per_epoch]
        for col in ("tokens", "targets"):
            if not np.array_equal(batch[col].cpu().numpy(), ref[col]):
                fail(f"training step {i + 1} received a {col} batch other than iterate_batches'")
    if not all(math.isfinite(x) for x in losses):
        fail(f"training losses not finite: {losses}")
    lnv = math.log(cfg.vocab_size)
    if abs(losses[0] - lnv) > FIRST_LOSS_WINDOW:
        fail(f"first loss {losses[0]} outside ln({cfg.vocab_size}) +- {FIRST_LOSS_WINDOW}")
    if not losses[-1] < losses[0]:
        fail(f"the loss did not fall: {losses}")
    log("# training gates: 12 launches of each flash kernel in every step, all on the tensor "
        "cores; every step's batch "
        "as iterate_batches gives it, bit for bit; the losses finite, the first in the window, "
        "the last below it")

    # one more step with every layer recomputed in the backward pass
    remat_step = tr.make_train_step(dataclasses.replace(cfg, remat=True), opt)
    torch.cuda.synchronize()
    tft.kernels.LAUNCHES.reset()
    _, _, remat_loss = remat_step(params, opt.state, received[0]["tokens"],
                                  received[0]["targets"])
    torch.cuda.synchronize()
    remat = launch_counts(tft)
    want = {k: (2 if k in ("flash_attention", "flash_attention_mma") else 1) * cfg.num_layers
            for k in TRAINING_BUILDS}  # the forward runs again in the backward
    if {k: remat[k] for k in TRAINING_BUILDS} != want:
        fail(f"a remat step launched {remat} (want {want}: 24 forward, 12 dK/dV, 12 dQ, all "
             "on the tensor cores)")
    if not math.isfinite(float(remat_loss)):
        fail("the remat step's loss is not finite")

    # flash against dense attention: one step's loss and gradients on the
    # same fresh weights and batch
    fresh = tr.init_params(cfg, seed=SEED, device=dev)
    for leaf in tr.tree_leaves(fresh):
        leaf.requires_grad_(True)
    tb = torch.from_numpy(tokens[:TRAIN_BATCH]).to(dev)
    gb = torch.from_numpy(targets[:TRAIN_BATCH]).to(dev)
    dense_cfg = dataclasses.replace(cfg, attention_impl="dense")
    loss_d, grads_d = leaf_grads(tr, dense_cfg, fresh, tb, gb)
    loss_f, grads_f = leaf_grads(tr, cfg, fresh, tb, gb)

    def worst(grads):
        return max(float((g - r).abs().max()) / max(float(r.abs().max()), 1e-30)
                   for g, r in zip(grads, grads_d))

    gap = worst(grads_f)
    broken = {}
    saved = kfa.flash_attention_backward
    for what, fn in broken_bwd_versions(True).items():
        kfa.flash_attention_backward = (
            lambda q, k, v, o, l, m, do, c, scale, fn=fn: fn(
                q, k, v, l, m, do, kfa.flash_attention_di(o, do), c, scale))
        try:
            broken[what] = worst(leaf_grads(tr, cfg, fresh, tb, gb)[1])
        finally:
            kfa.flash_attention_backward = saved
    loss_gap = abs(float(loss_f) - float(loss_d))
    log(f"# training gates: flash vs dense one step: loss {float(loss_f):.6f} vs "
        f"{float(loss_d):.6f} (|diff| {loss_gap:.6g}, tolerance {LOSS_ATOL}); worst leaf "
        f"max|grad diff| / max|grad| {gap:.6g} (tolerance {GRAD_RTOL}); broken backward "
        "versions at " + ", ".join(f"{w} {r:.4g}" for w, r in broken.items())
        + f"; remat step launches {remat}, loss {float(remat_loss):.6f}")
    if loss_gap > LOSS_ATOL:
        fail(f"flash loss off the dense loss by {loss_gap} (tolerance {LOSS_ATOL})")
    if gap > GRAD_RTOL:
        fail(f"flash gradients off the dense ones by {gap} of a leaf's max (tolerance "
             f"{GRAD_RTOL})")
    for what, r in broken.items():
        if r <= GRAD_RTOL:
            fail(f"the gradient gate cannot see a broken backward ({what}: {r} <= {GRAD_RTOL})")
    del fresh, grads_d, grads_f
    return {"launches": launches, "losses": losses, "wall_s": wall, "steady_step_s": steady,
            "peak_bytes": peak, "held_bytes": held, "cfg": cfg, "params": params, "opt": opt,
            "step": step,
            "batch": received[0]}


def step_inputs(cfg, params, prompts, dev):
    """A 16-slot decode step's state: each prompt prefilled (kernel path)
    into its own pages of a fresh pool; returns (pool, step args)."""
    import numpy as np
    from tensorframes_tpu_torch.models import generation as gen

    page, maxp = 16, 12
    pool = gen.init_paged_kv(cfg, 1 + 16 * maxp, page, device=dev)
    prefill = gen.paged_prefill_fn(cfg, page, maxp)
    tokens, pos = np.zeros(16, np.int32), np.zeros(16, np.int32)
    tables = np.arange(1, 1 + 16 * maxp, dtype=np.int32).reshape(16, maxp)
    for i, p in enumerate(prompts[:16]):
        bucket = next(b for b in (8, 16, 32, 64, 128) if b >= len(p))
        padded = np.zeros(bucket, np.int32)
        padded[:len(p)] = p
        _, first = prefill(params, pool, padded, len(p), tables[i])
        tokens[i], pos[i] = int(first), len(p)
    return pool, (tokens, pos, tables)


STEP_LOGITS_RTOL = 2e-2  # of max |logit|: ~3x the gap of sound runs (PERF.md)


def broken_plain_paths():
    """Deliberately wrong plain paths, for showing that the step-logits
    gate sees a wrong kernel: attention without the V scale, attention
    that misses each slot's newest position, and a weight product whose k
    loop drops its last 16-row tile."""
    import torch
    from tensorframes_tpu_torch.kernels.decode_attention import paged_attention_reference as ref
    from tensorframes_tpu_torch.ops import quantize as tq

    def no_v_scale(q, kp, vp, ks, vs, layer, tables, pos):
        return ref(q, kp, vp, ks, torch.ones_like(vs), layer, tables, pos)

    def misses_newest(q, kp, vp, ks, vs, layer, tables, pos):
        return ref(q, kp, vp, ks, vs, layer, tables, (pos - 1).clamp(min=0))

    def short_k(x, w):
        if not isinstance(w, tq.QuantizedTensor):
            return tq.matmul_plain(x, w)
        cut = tq.QuantizedTensor(w.q[:-16], w.scale)
        return tq.matmul_int8_plain(x[..., :-16], cut)

    return {"attention without v_scale": ("paged_attention_reference", no_v_scale),
            "attention missing the newest position": ("paged_attention_reference",
                                                      misses_newest),
            "matmul dropping its last k tile": ("matmul_plain", short_k)}


def check_step_logits(path, dev) -> dict:
    """One 16-slot decode step's logits, kernel path against plain path
    on copies of the same pool, within ``STEP_LOGITS_RTOL``·max|ref|: the
    two paths sum in f32 in other orders inside the two kernels, so a bf16
    activation may round to its neighbour and the difference grows through
    12 layers. Each broken plain path must land outside that tolerance."""
    import torch
    from tensorframes_tpu_torch.models import generation as gen

    cfg, params = path["cfg"], path["params"]
    pool, args = step_inputs(cfg, params, path["prompts"], dev)
    snap = {k: v.clone() for k, v in pool.items()}

    def plain_step(**patch):
        saved = {name: getattr(gen, name) for name in patch}
        for name, fn in patch.items():
            setattr(gen, name, fn)
        try:
            twin = {k: v.clone() for k, v in snap.items()}
            return gen.paged_decode_step_fn(cfg, 16, 12, plain=True)(
                params, twin, *args, return_logits=True)[1:]
        finally:
            for name, fn in saved.items():
                setattr(gen, name, fn)

    _, nk, lk = gen.paged_decode_step_fn(cfg, 16, 12, logits_rows=16)(
        params, pool, *args, return_logits=True)
    npl, lp = plain_step()
    torch.cuda.synchronize()
    if not bool(torch.isfinite(lk).all()) or lk.shape != (16, cfg.vocab_size):
        fail(f"decode-step logits not finite or of shape {tuple(lk.shape)}")
    diff = float((lk - lp).abs().max())
    tol = STEP_LOGITS_RTOL * float(lp.abs().max())
    broken = {what: float((plain_step(**{name: fn})[1] - lp).abs().max())
              for what, (name, fn) in broken_plain_paths().items()}
    agree = int((nk == npl).sum())
    log(f"# decode-step logits, kernel vs plain path: max |diff| {diff:.6g} "
        f"(tolerance {tol:.6g}, max |logit| {float(lp.abs().max()):.6g}); "
        f"greedy tokens agree on {agree}/16 slots (reported, not gated); broken plain "
        f"paths off the plain path by " + ", ".join(f"{k} {v:.6g}" for k, v in broken.items()))
    if diff > tol:
        fail(f"decode-step logits: kernel path off the plain path by {diff} (tolerance {tol})")
    for what, gap in broken.items():
        if gap <= tol:
            fail(f"the step-logits gate cannot see a broken path ({what}: {gap} <= {tol})")
    return {"pool": pool, "args": args}


# ---------------------------------------------------------------------------
# phase 3: where the time goes
# ---------------------------------------------------------------------------

def device_profile(fn, reps: int = 3):
    """Host wall time per call of ``fn`` and device time per call by
    kernel or copy name (``torch.profiler``), in ms, over ``reps`` calls
    after one warm-up."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device = {  # kernels and copies; a user annotation's span (the optimizer's step) would
        # count its kernels twice
        ev.key: ev.device_time_total / reps / 1e3
        for ev in prof.key_averages()
        if ev.device_type == torch.autograd.DeviceType.CUDA and ev.device_time_total > 0
        and not getattr(ev, "is_user_annotation", False)
    }
    return wall / reps * 1e3, device


def merged(intervals) -> list:
    """The union of ``[start, end)`` intervals, as sorted disjoint ones."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def timeline_profile(fn) -> dict:
    """One call of ``fn`` under ``torch.profiler``, after two warm-up calls:
    host wall (ms), device time by kernel or copy name, the device's busy
    time as the union of its intervals (copies on a side stream overlap
    kernels, so the sum would count time twice) and its share of the
    wall, the same for kernels alone, the ``Memcpy HtoD`` time (and its
    count of copies) and the part of it that ran while a kernel ran."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # the warm-up step is traced and dropped: a trace's first device
    # activities went missing without it (7 of 8 copies in one trace);
    # the active step's events are read when its trace is ready
    events = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=torch.profiler.schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: events.extend(p.events())) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        prof.step()
    if not events:
        fail("timeline_profile: the profiler returned no events")
    device, spans, kernels, htod = {}, [], [], []
    for ev in events:
        if ev.device_type != torch.autograd.DeviceType.CUDA or getattr(
                ev, "is_user_annotation", False):
            continue
        span = (ev.time_range.start / 1e3, ev.time_range.end / 1e3)  # ms
        if span[1] <= span[0]:
            continue
        device[ev.name] = device.get(ev.name, 0.0) + span[1] - span[0]
        spans.append(span)
        low = ev.name.lower()
        if "memcpy htod" in low:
            htod.append(span)
        elif "memcpy" not in low and "memset" not in low:
            kernels.append(span)
    busy = sum(b - a for a, b in merged(spans))
    running = merged(kernels)
    overlap = sum(max(0.0, min(b, kb) - max(a, ka)) for a, b in htod for ka, kb in running)
    kernel_busy = sum(b - a for a, b in running)
    return {"wall_ms": wall, "device": device, "busy_ms": busy, "busy_share": busy / wall,
            "kernel_busy_ms": kernel_busy, "kernel_busy_share": kernel_busy / wall,
            "htod_ms": sum(b - a for a, b in htod), "htod_events": len(htod),
            "htod_overlap_ms": overlap}


def where_the_time_goes(tft, dev) -> None:
    """Profile each segment kernel alone (its passes) and two verbs of
    the main path (the device's busy share of the verb's wall time)."""
    import numpy as np
    from tensorframes_tpu_torch.kernels import segment_reduce as ksr
    from tensorframes_tpu_torch.ops import segment as seg

    n, groups = 10_000_000, 4096
    ids, v, w, c = segment_inputs(n, groups, dev)
    ops = SEGMENT_OPS
    cols = {"v_sum": v, "v_mean": v, "w": w, "c": c}
    rng = np.random.default_rng(SEED)
    big = tft.frame_from_arrays({
        "k": rng.integers(0, groups, n), "v": rng.standard_normal(n, dtype=np.float32),
        "w": rng.standard_normal((n, 8), dtype=np.float32),
    })
    xf = tft.frame_from_arrays({"x": np.arange(20_000_000, dtype=np.float64)})

    def aggregate():
        with tft.with_graph():
            tft.aggregate([tft.reduce_sum(tft.block(big, "v", tf_name="v_input"), name="v"),
                           tft.reduce_max(tft.block(big, "w", tf_name="w_input"), name="w")],
                          big.group_by("k"), device=dev)

    targets = (
        ("kernel segment_reduce", lambda: ksr.segment_reduce(ops, groups, cols, ids)),
        ("kernel segment_sum", lambda: seg.segment_sum_kernel(w, ids, groups)),
        ("verb aggregate (10M rows, 4096 groups)", aggregate),
        ("verb map_blocks add-3 (20M float64 rows)",
         lambda: tft.map_blocks(lambda x: {"z": x + 3}, xf, device=dev).blocks()),
    )
    for what, fn in targets:
        wall, device = device_profile(fn)
        busy = sum(device.values())
        log(f"# profile {what}: {wall:.3f} ms per call on the host clock, device busy "
            f"{busy:.3f} ms ({100 * busy / wall:.1f}%)")
        for name, ms in sorted(device.items(), key=lambda kv: -kv[1])[:6]:
            log(f"#   {ms:9.3f} ms  {name[:80]}")


def decode_step_profile(path, state) -> float:
    """A 16-slot decode step of the serving path (the step plus its one
    host sync, as the engine runs it): host wall per step with and without
    the profiler, the device's busy share, and the biggest device items.
    Returns the unprofiled host ms."""
    from tensorframes_tpu_torch.models import generation as gen

    step = gen.paged_decode_step_fn(path["cfg"], 16, 12, logits_rows=16)

    def one():
        return step(path["params"], state["pool"], *state["args"])[1].cpu()

    wall, device = device_profile(one, reps=5)
    busy = sum(device.values())
    t0 = time.perf_counter()
    for _ in range(20):
        one()
    plain_wall = (time.perf_counter() - t0) / 20 * 1e3
    log(f"# profile decode step, gpt_small, 16 slots: {wall:.3f} ms per step on the host "
        f"clock under the profiler ({plain_wall:.3f} ms without it), device busy "
        f"{busy:.3f} ms ({100 * busy / wall:.1f}% of the profiled step, "
        f"{100 * busy / plain_wall:.1f}% of the unprofiled one)")
    for name, ms in sorted(device.items(), key=lambda kv: -kv[1])[:8]:
        log(f"#   {ms:9.3f} ms  {name[:80]}")
    return plain_wall


def encoder_profile(tft, enc, dev) -> None:
    """One BERT-base ``map_rows`` call (1,024 rows, flash): host wall per
    call, the device's busy share, the biggest device items, and the
    device time of flash against the dense products and any copies."""
    def call():
        return embed_rows(tft, enc["cfg"], enc["params"], enc["frame"], dev, "map_rows")[1]

    wall, device = device_profile(call, reps=2)
    plain_wall = sum(call() for _ in range(3)) / 3 * 1e3
    busy = sum(device.values())
    log(f"# profile map_rows BERT-base, 1,024 x 128 tokens, flash: {wall:.3f} ms per call on the "
        f"host clock under the profiler ({plain_wall:.3f} ms without it), device busy "
        f"{busy:.3f} ms ({100 * busy / wall:.1f}% of the profiled call, "
        f"{100 * busy / plain_wall:.1f}% of the unprofiled one)")
    groups = {"flash_attention": 0.0, "matmul (gemm)": 0.0, "copies": 0.0, "other": 0.0}
    for name, ms in device.items():
        low = name.lower()
        if "flash_attention_fwd" in low:
            groups["flash_attention"] += ms
        elif any(w in low for w in ("gemm", "nvjet", "xmma", "cutlass")):
            groups["matmul (gemm)"] += ms
        elif "copy" in low or "memcpy" in low:
            groups["copies"] += ms
        else:
            groups["other"] += ms
    log("# profile map_rows by group: " + ", ".join(f"{k} {v:.3f} ms" for k, v in groups.items()))
    for name, ms in sorted(device.items(), key=lambda kv: -kv[1])[:10]:
        log(f"#   {ms:9.3f} ms  {name[:80]}")


def training_profile(train) -> dict:
    """One gpt_small training step (8 x 1024 tokens, flash) of the trained
    state: device time of forward, backward and optimizer by CUDA events
    around each part, the host wall of the unprofiled step, and
    ``torch.profiler`` device time by kernel group (GEMMs, the three flash
    kernels, elementwise and norms, the embedding's backward, the
    optimizer) with the device's busy share of the unprofiled step."""
    import torch
    from tensorframes_tpu_torch.models import transformer as tr

    cfg, params, opt = train["cfg"], train["params"], train["opt"]
    tokens, targets = train["batch"]["tokens"], train["batch"]["targets"]

    def one():
        train["step"](params, opt.state, tokens, targets)

    parts = {"forward": [], "backward": [], "optimizer": []}
    for _ in range(3):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        opt.zero_grad(set_to_none=True)
        ev[0].record()
        loss = tr.loss_fn(cfg, params, tokens, targets)
        ev[1].record()
        loss.backward()
        ev[2].record()
        opt.step()
        ev[3].record()
        torch.cuda.synchronize()
        for i, name in enumerate(parts):
            parts[name].append(ev[i].elapsed_time(ev[i + 1]))
    split = {k: sum(v) / len(v) for k, v in parts.items()}
    t0 = time.perf_counter()
    for _ in range(3):
        one()
    torch.cuda.synchronize()
    plain_wall = (time.perf_counter() - t0) / 3 * 1e3
    wall, device = device_profile(one, reps=2)
    busy = sum(device.values())
    groups = {"flash forward": 0.0, "flash dK/dV": 0.0, "flash dQ": 0.0, "GEMMs": 0.0,
              "embedding backward": 0.0, "optimizer": 0.0, "norms": 0.0, "softmax/loss": 0.0,
              "copies": 0.0, "elementwise and other": 0.0}
    for name, ms in device.items():
        low = name.lower()
        if "flash_attention_fwd" in low:
            groups["flash forward"] += ms
        elif "flash_attention_bwd_dkv" in low:
            groups["flash dK/dV"] += ms
        elif "flash_attention_bwd_dq" in low:
            groups["flash dQ"] += ms
        elif any(w in low for w in ("gemm", "nvjet", "xmma", "cutlass", "sm90_")):
            groups["GEMMs"] += ms
        elif "index" in low and ("put" in low or "backward" in low or "sort" in low
                                 or "radix" in low):
            groups["embedding backward"] += ms
        elif "multi_tensor" in low or "adam" in low:
            groups["optimizer"] += ms
        elif "layer_norm" in low or "layernorm" in low:
            groups["norms"] += ms
        elif "softmax" in low or "gather" in low or "nll" in low:
            groups["softmax/loss"] += ms
        elif "copy" in low or "memcpy" in low or "memset" in low:
            groups["copies"] += ms
        else:
            groups["elementwise and other"] += ms
    log(f"# profile training step gpt_small flash, 8 x 1024 tokens: {plain_wall:.3f} ms per step "
        f"on the host clock ({wall:.3f} ms under the profiler); by CUDA events forward "
        f"{split['forward']:.3f} ms, backward {split['backward']:.3f} ms, optimizer "
        f"{split['optimizer']:.3f} ms; device busy {busy:.3f} ms ({100 * busy / plain_wall:.1f}% "
        f"of the unprofiled step)")
    log("# profile training step by group: "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in groups.items()))
    for name, ms in sorted(device.items(), key=lambda kv: -kv[1])[:12]:
        log(f"#   {ms:9.3f} ms  {name[:80]}")
    return {"step_ms": plain_wall, "split_ms": split, "busy_ms": busy, "groups_ms": groups}


def inception_profile(tft, incep, dev, what: str = "inception-v3") -> dict:
    """One Inception-v3 ``map_blocks`` call (1,024 images, two blocks of
    512, the pipeline's default depths) of ``incep["prog"]`` (the native
    program, or the imported GraphDef's): host wall, the device's busy
    share (the union of its intervals), device time by group
    (convolutions, pools, elementwise, host-to-device copies), the part of
    the copies that ran under kernels, and the top device operations.
    Returns the groups."""
    def call():
        tft.map_blocks(incep["prog"], incep["frame"], device=dev).column_values("label")

    prof = timeline_profile(call)
    wall, busy = prof["wall_ms"], prof["busy_ms"]
    groups = {"convolutions": 0.0, "memcpy HtoD": 0.0, "pools": 0.0, "other copies": 0.0,
              "elementwise and other": 0.0}
    for name, ms in prof["device"].items():
        low = name.lower()
        if "memcpy htod" in low:
            groups["memcpy HtoD"] += ms
        elif any(w in low for w in ("conv", "xmma", "cudnn", "implicit", "sm90_", "nvjet",
                                    "cutlass", "gemm")):
            groups["convolutions"] += ms
        elif "pool" in low:
            groups["pools"] += ms
        elif "copy" in low or "memcpy" in low or "memset" in low:
            groups["other copies"] += ms
        else:
            groups["elementwise and other"] += ms
    log(f"# profile map_blocks {what}, {INC_ROWS} images: {wall:.3f} ms per call on the "
        f"host clock under the profiler, device busy {busy:.3f} ms ({100 * busy / wall:.1f}%); "
        f"Memcpy HtoD {groups['memcpy HtoD']:.3f} ms ({100 * groups['memcpy HtoD'] / wall:.1f}% "
        f"of the call), {prof['htod_overlap_ms']:.3f} ms of it under kernels")
    log(f"# profile {what} by group: " + ", ".join(f"{k} {v:.3f} ms" for k, v in groups.items()))
    for name, ms in sorted(prof["device"].items(), key=lambda kv: -kv[1])[:12]:
        log(f"#   {ms:9.3f} ms  {name[:80]}")
    return {"wall_ms": wall, "busy_ms": busy, **groups}


def kernel_name(mangled: str) -> str:
    """``flash_attention_fwd_mma_kernel<64, true>`` from a mangled kernel
    name of the build log (anything else as it is): the length-prefixed
    name that ends in ``_kernel`` and takes template arguments."""
    import re

    for i in range(len(mangled)):
        size = re.match(r"\d+", mangled[i:])
        if not size:
            continue
        start = i + len(size.group())
        name = mangled[start:start + int(size.group())]
        rest = mangled[start + len(name):]
        m = re.match(r"I(.*?)EEv", rest) or re.match(r"I(.*?)Ev", rest)  # values / types
        if name.endswith("_kernel") and m:
            break
    else:
        return mangled
    args = m.group(1).replace("13__nv_bfloat16", "bf16,").replace("Lb0E", "false,")
    args = re.sub(r"Li(\d+)E", r"\1,", args.replace("Lb1E", "true,"))
    if args.startswith("f"):
        args = "float," + args[1:]
    return f"{name}<{args.rstrip(',').replace(',', ', ')}>"


def ptxas_report(text: str, needle: str = "flash_attention_fwd") -> dict:
    """``{kernel<args>: "Used N registers, ...; S bytes spill stores, L
    bytes spill loads"}`` for each kernel of the build log whose mangled
    name holds ``needle``."""
    out, entry, spill = {}, None, ""
    for line in text.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            entry, spill = (kernel_name(name) if needle in name else None), ""
        elif entry is not None and "spill" in line:
            spill = line.strip()
        elif entry is not None and "Used" in line:
            out[entry] = f"{line.split(':', 1)[1].strip()}; {spill}"
            entry = None
    return out


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    if not (ROOT / "tensorframes_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: tensorframes_tpu_torch is not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import tensorframes_tpu_torch as tft

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    tft.kernels.library()
    log(f"# build: {time.perf_counter() - t0:.1f} s")
    build_log = tft.kernels.BUILD_LOG.read_text() if tft.kernels.BUILD_LOG.exists() else ""
    for line in build_log.splitlines():
        if "registers" in line or "spill" in line or "rc " in line:
            log(f"# nvcc | {line.strip()}")
    for name, used in ptxas_report(build_log).items():
        log(f"# ptxas flash forward build {name}: {used}")
    for name, used in ptxas_report(build_log, "flash_attention_bwd").items():
        log(f"# ptxas flash backward build {name}: {used}")
    for name, used in ptxas_report(build_log, "int8_matmul").items():
        log(f"# ptxas int8_matmul build {name}: {used}")
    for name, used in ptxas_report(build_log, "paged_decode_attention").items():
        log(f"# ptxas decode_attention {name}: {used}")
    for name, used in ptxas_report(build_log, "seg_").items():
        short = re.search(r"\d+(seg_[a-z]+)E", name)
        log(f"# ptxas segment_reduce {short.group(1) if short else name}: {used}")

    legs = segment_legs(dev)
    results = {
        "segment_reduce": {**check_segment_reduce(dev, 10_000_000, 4096),
                           "legs": {k: leg["segment_reduce"] for k, leg in legs.items()}},
        "segment_sum": {**check_segment_sum(dev, 10_000_000, 4096),
                        "legs": {k: leg["segment_sum"] for k, leg in legs.items()}},
        "ragged_gather": check_ragged_gather(dev),
        "decode_attention": check_decode_attention(dev),
        "int8_matmul": check_int8_matmul(dev),
        "flash_attention": check_flash_attention(dev),
        **check_flash_backward(dev),
    }
    check_int8_vmap(dev)
    for name, r in results.items():
        log(f"# kernel {name}: {json.dumps(r)}")

    t1 = time.perf_counter()
    path = main_path(tft, dev)
    log(f"# main path: {time.perf_counter() - t1:.1f} s")
    for name, r in sorted(path["verbs"].items()):
        log(f"# verb {name}: {r['rows_per_s']:.0f} rows/s ({r['rows']} rows, "
            f"{r['calls']} calls, {r['seconds']:.4f} s)")
    missing = [k for k in SLICE1_KERNELS if path["launches"][k] <= 0]
    if missing:
        fail(f"kernels never launched on the verbs' path: {missing}")
    if path["launches"]["ragged_gather"] != 1:
        fail(f"the ragged map_rows call launched ragged_gather "
             f"{path['launches']['ragged_gather']} times (want 1: every group in one launch)")
    t_new = time.perf_counter()
    ragged_verbs = ragged_verb_legs(tft, dev)
    generic = generic_aggregate_leg(tft, dev)
    relational = relational_leg(tft, dev)
    new_legs_s = time.perf_counter() - t_new
    log(f"# ragged, generic aggregate and relational legs: {new_legs_s:.1f} s")

    t2 = time.perf_counter()
    serving = serving_path(tft, dev)
    log(f"# serving path: {time.perf_counter() - t2:.1f} s")
    missing = [k for k in SERVING_KERNELS if serving["launches"][k] <= 0]
    if missing:
        fail(f"kernels never launched on the decode server's path: {missing}")
    state = check_step_logits(serving, dev)

    t3 = time.perf_counter()
    encoder = encoder_path(tft, dev)
    log(f"# encoder path: {time.perf_counter() - t3:.1f} s")
    missing = [k for k in ENCODER_KERNELS if encoder["launches"][k] <= 0]
    if missing:
        fail(f"kernels never launched on the encoder's path: {missing}")
    for verb in ("map_rows", "map_blocks"):
        log(f"# encoder BERT-base {verb}: {encoder['rows_per_s'][verb]:.1f} rows/s (1,024 rows "
            f"x 128 tokens in {encoder['seconds'][verb]:.4f} s, flash attention)")

    t4 = time.perf_counter()
    train = training_path(tft, dev)
    log(f"# training path: {time.perf_counter() - t4:.1f} s")
    missing = [k for k in TRAINING_KERNELS if train["launches"][k] <= 0]
    if missing:
        fail(f"kernels never launched on the training path: {missing}")
    log(f"# training gpt_small flash: {TRAIN_STEPS / train['wall_s']:.3f} steps/s, "
        f"{TRAIN_STEPS * TRAIN_BATCH * TRAIN_SEQ / train['wall_s']:.1f} tokens/s over the 10 "
        f"steps on the host clock ({train['wall_s']:.3f} s, the first step's start-up "
        f"included); steps 2-10 {1 / train['steady_step_s']:.3f} steps/s, "
        f"{TRAIN_BATCH * TRAIN_SEQ / train['steady_step_s']:.1f} tokens/s; peak memory "
        f"{train['peak_bytes']} bytes ({train['peak_bytes'] - train['held_bytes']} above what "
        "was held before the first step)")

    t5 = time.perf_counter()
    incep = inception_path(tft, dev)
    log(f"# inception path: {time.perf_counter() - t5:.1f} s")
    log(f"# inception-v3 299x299 bf16 map_blocks: {incep['rows_per_s']:.1f} rows/s ({INC_ROWS} "
        f"images in {INC_ROWS // INC_BLOCK} blocks of {INC_BLOCK} in {incep['wall_s']:.4f} s; "
        f"warm-up call {incep['warm_s']:.3f} s); peak memory {incep['peak_bytes']} bytes "
        f"({incep['peak_bytes'] - incep['held_bytes']} above what was held, weights "
        f"{incep['weight_bytes']} bytes); int8 weights, {INC_CHECK} images: "
        f"{incep['int8_rows_per_s']:.1f} rows/s; launches {incep['launches']}")

    t_pipe = time.perf_counter()
    pipeline = pipeline_leg(tft, dev, incep)
    new_legs_s += time.perf_counter() - t_pipe
    log(f"# pipeline leg: {time.perf_counter() - t_pipe:.1f} s; the legs new to this "
        f"slice: {new_legs_s:.1f} s")

    t6 = time.perf_counter()
    imported = imported_inception_path(tft, dev, incep)
    log(f"# imported inception path: {time.perf_counter() - t6:.1f} s")
    log(f"# imported inception-v3 GraphDef 299x299 bf16 map_blocks: {imported['rows_per_s']:.1f} "
        f"rows/s ({INC_ROWS} images in {INC_ROWS // INC_BLOCK} blocks of {INC_BLOCK} in "
        f"{imported['wall_s']:.4f} s; warm-up call {imported['warm_s']:.3f} s) against the "
        f"native {incep['rows_per_s']:.1f}; peak memory {imported['peak_bytes']} bytes "
        f"({imported['peak_bytes'] - imported['held_bytes']} above what was held) against the "
        f"native {incep['peak_bytes']} ({incep['peak_bytes'] - incep['held_bytes']}); GraphDef "
        f"{imported['graph_bytes']} bytes, {imported['graph_nodes']} nodes, written in "
        f"{imported['write_s']:.2f} s, imported in "
        f"{imported['import_s']:.2f} s; int8 weights, {INC_CHECK} images: "
        f"{imported['int8_rows_per_s']:.1f} rows/s")
    t7 = time.perf_counter()
    padding = padding_path(tft, dev)
    vggr = vgg_path(tft, dev)
    log(f"# padding and vgg paths: {time.perf_counter() - t7:.1f} s")
    log(f"# vgg-16 224x224 bf16 map_blocks: {vggr['rows_per_s']:.1f} rows/s ({VGG_ROWS} images "
        f"in {VGG_ROWS // VGG_BLOCK} blocks of {VGG_BLOCK} in {vggr['wall_s']:.4f} s; warm-up "
        f"call {vggr['warm_s']:.3f} s); peak memory {vggr['peak_bytes']} bytes "
        f"({vggr['peak_bytes'] - vggr['held_bytes']} above what was held, weights "
        f"{vggr['weight_bytes']} bytes); int8 weights, {VGG_CHECK} images: "
        f"{vggr['int8_rows_per_s']:.1f} rows/s")

    where_the_time_goes(tft, dev)
    step_ms = decode_step_profile(serving, state)
    encoder_profile(tft, encoder, dev)
    training_profile(train)
    native_prof = inception_profile(tft, incep, dev)
    import_prof = inception_profile(tft, imported, dev, "imported inception-v3 GraphDef")
    log(f"# inception Memcpy HtoD per call: imported {import_prof['memcpy HtoD']:.3f} ms, native "
        f"{native_prof['memcpy HtoD']:.3f} ms (the images only: "
        f"{INC_ROWS * 299 * 299 * 3 * 4} bytes)")
    log(f"# serving gpt_small: {serving['tokens_per_s']:.1f} generated tokens/s (32 requests "
        f"x 64 tokens in {serving['wall_s']:.3f} s); TTFT p50 {serving['ttft_s']['p50']:.4f} s, "
        f"p99 {serving['ttft_s']['p99']:.4f} s (each request's own); request latency "
        f"p50 {serving['latency_s']['p50']:.4f} s, p99 {serving['latency_s']['p99']:.4f} s; "
        f"decode step {step_ms:.3f} ms at 16 slots; steps {serving['steps']}")

    kernels = []
    paths = ((path, SLICE1_KERNELS), (relational, ("segment_reduce", "segment_sum")),
             (serving, SERVING_KERNELS), (encoder, ENCODER_KERNELS),
             (train, TRAINING_KERNELS), (imported["int8"], ("int8_matmul",)),
             (vggr["int8"], ("int8_matmul",)))
    for name, info in tft.kernels.KERNELS.items():
        # a kernel on several paths (the flash forward) counts its launches on each
        launches = sum(p["launches"][name] for p, names in paths if name in names)
        builds = {b: sum(p["launches"].get(b, 0) for p, names in paths if name in names)
                  for b, kernel in tft.kernels.BUILDS.items() if kernel == name}
        kernels.append({
            "name": name, "route": "cuda", "source": info.source,
            "replaces": info.replaces, "launches": launches,
            **{f"{b}_launches": n for b, n in builds.items()}, **results[name],
        })
    log(f"# ragged verb legs: {json.dumps({k: {m: v[m] for m in ('wall_ms', 'launches_per_call', 'busy_share')} for k, v in ragged_verbs.items()})}")
    log(f"# pipeline legs: {json.dumps(pipeline)}")
    log(f"# generic aggregate: {json.dumps(generic)}; relational walls: "
        f"{json.dumps(relational['walls_ms'])}")
    log(f"# total: {time.perf_counter() - t0:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(gpu_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
