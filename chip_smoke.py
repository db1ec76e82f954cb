#!/usr/bin/env python3
"""Chip smoke for tensorframes_tpu_torch: build the CUDA kernels, hold each
against its plain PyTorch version on the card, then drive the five verbs,
the decode server (with its prefix cache and KV swap), BERT-base embedding
extraction (also as a flush endpoint over HTTP), the data path (a growing
CSV directory as a registered query, an out-of-core ``stream_chain``,
frame and CSV round trips), gpt_small training,
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
   pool, at 4 slots of 64-page tables (past its staging buffer) and at
   the prefills' geometry (128 rows of one sequence's table, pos = start
   + i from starts 0 and 112, padding rows after them), twice
   bit for bit, each slot alone equal to the batch's, two broken plain
   versions outside the tolerance (timed at 16 slots and at the cold
   prefill's 128 rows; library:
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
   wall. Then the plan layer (``plan_leg``): bench.py's chain3 (three
   f32 maps, ``select``), chain3_join (two maps, a join with 512 rows,
   f32 sums by key) and multijoin (int32 star schema, two joins, an
   aggregate pushed below them) over 10,000,000 rows in 8 blocks, fused
   (the default), with ``plan_fusion=False`` and, for multijoin,
   ``plan_reopt=False``: every mode's outputs equal the fused ones bit
   for bit and numpy's; per mode the median wall of 3 calls, decisions,
   launches per call (an aggregate must launch ``segment_reduce`` in
   every mode),
   bytes avoided, a profiled call's copies and busy share. The main
   path's logreg aggregate by label also runs off the lazy scoring
   chain, fused and unfused, bit-equal to the materialized frame's.
   Then the data path (``data_plane_leg``, counts reset before each
   drill): 56 CSV parts of 80,000 rows registered as a query
   (``Server.register_query``, int32 sum/min/max by key through
   ``segment_reduce``, the result store armed): the cold execute, 20
   repeats (all hits, no new dispatch key), one appended part refreshed
   by one chunk's execution and equal to the full recompute and numpy
   bit for bit, a fresh server warmed from the store, one HTTP answer; a
   CSV directory five times a 32 MB block budget streamed by
   ``stream_chain`` (map, filter, keyed sum, folded; the map/filter alone
   spilled) equal to the in-memory chain, with the peak RSS growth
   sampled and held under 3.5 budgets; a 1M-row ``save_frame``/
   ``load_frame`` and a 1M-row native ``read_csv`` against numpy.
   Then verified UDF lifting (``lift_leg``): numpy UDFs captured by
   ``numpy_udf`` on the card (arithmetic, compare/where, clip, abs/
   maximum chains, sqrt, x / 3, exp, tanh, sign, mod, an int32 mean and
   span, a bool mask, a two-input hypot, in f32, f64 and int32), each
   decision and its wall printed, every lifted capture equal to its
   host stage (``udf_lifting=False``) bit for bit over 1,000,000 values,
   a float mean, a loop and ``np.random`` declining with the JAX
   package's reasons; a map → lifted ``numpy_udf`` → keyed sum/max chain
   over 10,000,000 rows fused with no barrier and through
   ``segment_reduce``, against the same chain with the UDF as a host
   stage (one barrier, a counted ``host_callback`` fallback), the two
   equal bit for bit and to numpy (sums within the float64 tolerance),
   each mode's median wall, launches, copies and busy share; TFG112
   ``info``/``warn`` from ``lint_plan``, the CLI's ``--lift-report``,
   and the lift slot of the stage's fingerprint.
   Then the decode server's path, counts reset again: a
   ``Server`` with a gpt_small decode endpoint (int8 weights from seed 0,
   16 slots, 16-position pages, prompts <= 128, 64 new tokens) answers 32
   requests; the first 8 re-run solo must match exactly; an engine with a
   4-horizon pool must preempt and still return the same tokens; the
   kernels must have launched 12 (attention) and 48 (matmul, every one on
   its tensor-core build) times per decode step and per prefill; one 16-slot step's logits,
   kernel path against plain path on the same pool, within a tolerance
   that three deliberately broken plain
   paths must exceed. Tokens/s, TTFT (each request's own, from its
   future) and step time follow. Then the decode server's KV tiers on
   the same model (``kv_tiers_leg``, counts reset before each engine's
   traffic): with ``prefix_cache=True`` a 112-token prefix published, 12
   cold one-token requests, 12 suffix hits (the prefix plus 16 fresh
   tokens) and a 120-token repeat that copy-on-extends a shared page,
   the hits' 64 tokens equal to an unarmed engine's exactly, TTFT p50 of
   cold and hit reported; with ``kv_swap=True`` on a 1 + 2 x 12-page pool
   the 32 prompts resume from swapped pages with the first run's tokens,
   a corrupted segment falls back once (counted) with the same tokens,
   and a hard-stopped engine's parked segments spill into a fresh
   engine whose redriven requests resume from them; ``decode_attention``
   12 and ``int8_matmul`` 48 (tensor cores) per decode step and per
   prefill, whatever its route. Then BERT-base embedding extraction with
   flash attention (f32 weights from seed 0, 1,024 rows of 128 tokens):
   ``map_rows`` and ``map_blocks`` must launch the flash kernel 12 times
   per call, all on its tensor-core build, agree with each other and with dense attention through the
   same verb, while an attention that drops the last key tile must not;
   a 64-row ``map_rows`` over int8 weights must launch 48 int8 and 12
   flash kernels, all on their tensor-core builds. Rows/s per verb
   follow. Then the same BERT-base as a flush endpoint
   (``flush_serving_leg``: ``Server.register`` over int32 [128] token
   cells, 64-row flushes, a 2 ms timer, warmed by ``start()``): 256
   requests of 1, 2 and 4 rows sent open-loop at 400 requests/s, half
   through ``submit`` and half through ``serve_http`` from a child
   process over 64 keep-alive connections, each row within
   2e-2·max|embedding| of one ``map_rows`` call (bit-identical rows
   counted), no new dispatch key, 12 flash launches a flush, a repeated
   idempotent POST run once, ``POST /admin/drain`` through ``draining``
   to ``stopped``; rows/s and latency p50/p99 of each half, the server
   process's CPU share and its flushes' wall against their CPU time.
   Then the same endpoint as a fleet (``fleet_serving_leg``): a
   ``ServingFleet`` of 2 replica processes on the card (this script with
   ``--fleet-replica``, each ``serve_replica`` over the endpoint, its
   output in a log file) behind the router's ingress; two bursts of 256
   requests at 400 requests/s from a child process, replica 1 SIGKILLed
   a third into the first and replica 0 rolled by ``POST /admin/drain`` a
   third into the second: every request one 200, every row within
   2e-2·max|embedding| of one ``map_rows`` call, one crash restart and
   none for the drain, the restarted replica with no kernel build and
   its warm-up's 4 dispatch keys, 12 flash launches a flush on the
   tensor cores in every replica that exited cleanly, the replicas' and
   the router's trace shards merged into one timeline, the leg within
   120 s; each burst's rows/s and latency p50/p99, ``recovery_s`` and the
   router's redrives. Then the static analyzer and the compile cache
   (``infra_leg``): two processes of this script (``--infra-warm cold``
   and ``--infra-warm restart``) on one fresh store
   (``TFTPU_COMPILE_CACHE``) warm BERT-base's ``map_rows`` program at
   every bucket of ``serving_row_buckets(64)`` (12 flash launches a
   bucket on the tensor cores, one store entry a key, the first real
   dispatch at a warmed bucket adds no key) and replay the store's
   manifest (``disk`` for every bucket, no kernel build, embeddings equal
   to the cold process's bit for bit); the ``compilecache`` CLI reports
   and quarantines a planted corrupt entry and prunes a planted stale
   kernel library (in a build directory of the leg's own, beside a link
   to the current library); a strict ``aggregate`` raises ``StaticAnalysisError``
   (TFG104) before any launch and a clean one equals the non-strict bit
   for bit through ``segment_reduce``; ``analyze_frame`` on BERT-base's
   row program, TFG106 against the card's memory and a planted 1 MiB,
   launches nothing and adds no key (its wall printed); ``lint_plan``
   finds TFG107, TFG109 and TFG110 on chains built to show them; the leg
   within 120 s. Then the data-parallel frame (``sharded_leg``): a world
   of one under NCCL takes the main path's 10M-row aggregate feed through
   ``to_device``, a map, the keyed aggregate (one ``segment_reduce``
   launch, equal to the unsharded port's within ``float_close``) and
   ``reduce_blocks`` (the device's idle share of one aggregate printed);
   two ranks of this script (``--sharded-rank``) share the card over gloo
   (NCCL refuses two ranks on one device), 5M rows each: the dense,
   string-key and generic aggregates, ``repartition_by_key``, an exchange
   join, a range-exchange sort, ``drop_duplicates``, a ragged
   ``map_rows``, the sharded save/load and ``to_host``, their union equal
   to the single-process port, ``segment_reduce`` once a rank an
   aggregate and ``ragged_gather`` once a rank; each rank's walls and
   exchange and shuffle bytes printed; the leg within 120 s. Then gpt_small training with
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
   Then the resumable_training leg on the same model and frame, counts
   reset first (``resumable_training_leg``): under deterministic
   algorithms (``CUBLAS_WORKSPACE_CONFIG`` set at the start of
   ``main``) a checkpointed run resumed from step 3 equals the
   uninterrupted one bit for bit, a child process SIGKILLed at the loop
   edge resumes to the bits of an uninterrupted child, a NaN step is
   skipped (the bits of a run without it) and raised (a finite
   emergency checkpoint), ``accum_steps=2`` agrees with 1 and the version
   without the division does not; save/restore MB/s, peak memory and
   the warm step times of the plain loop, the guard and the telemetry.
   Then model parallelism (``model_parallel_leg``) on the same model and
   batch: a world of one under NCCL (mesh ``{"dp": 1}``, flash) takes two
   sharded steps bit for bit equal to ``make_train_step``'s, launching
   each flash kernel 12 times a step on the tensor cores; four ranks of
   this script (``--mp-rank``) share the card over gloo and take two
   AdamW steps each with ring attention in mixed precision, Ulysses and
   flash on ``{"tp": 2, "sp": 2}`` and flash on ``{"dp": 2, "tp": 2}``,
   the first step's loss and every gathered gradient leaf within
   MP_LOSS_ATOL / MP_GRAD_RTOL of the single-process step of the same
   impl family (dense, dense in mixed precision, flash); ``moe_ffn_ep``
   on ``{"ep": 4}`` (768 / 3,072, 8 experts, 8,192 tokens a rank, none
   dropped) within MP_MOE_RTOL of ``moe_ffn`` on the whole batch; a
   ``{"pp": 4}`` pipeline of three layers a stage over 8 microbatches
   against the 12 layers in order (output, loss and one step's
   gradients); step ms, launches, bytes through each collective kind and
   each rank's peak memory printed; the leg within 150 s.
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
import dataclasses
import json
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

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
    ``segment_sum`` over the widest f32 column (where the feed has one),
    each relaunched bit for bit; device times of both kernels, their plain
    versions and library calls, and their byte bounds."""
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
    out = {"segment_reduce": {
        "max_abs_err": err,
        "ms": time_ms(lambda: ksr.segment_reduce(ops, groups, cols, ids), f"segment_reduce {what}"),
        "plain_ms": time_ms(lambda: ksr.segment_reduce_plain(ops, groups, cols, ids),
                            f"segment_reduce {what} plain"),
        "library_ms": time_ms(library, f"segment_reduce {what} library"),
        "bound_ms": bound_ms(in_bytes + groups * out_lanes * 4), "bound_by": "bytes",
    }}
    if not any(cols[x].dtype == torch.float32 for x, _ in ops):
        return out
    w2 = widest_f32(cols, ops)
    s_got = seg.segment_sum_kernel(w2, ids, groups)
    if not torch.equal(s_got, seg.segment_sum_kernel(w2, ids, groups)):
        fail(f"segment_sum {what}: not deterministic")
    if not torch.equal(s_got.cpu(), ksr.segment_sum_in_kernel_order(
            w2, ids, groups, ksr.num_chunks(n, groups, int(w2.shape[1])))):
        fail(f"segment_sum {what}: not summed in the kernel's order")
    err_sum = float_close(s_got, f64_sums(w2, ids, groups), counts, float(w2.abs().max()))
    return {**out,
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
        }}


def segment_feeds(dev) -> dict:
    """The segment kernels' feeds, ``{name: (ids, cols, ops, groups)}``: the
    main path's four columns over 4,096 groups with uniform keys
    (``main``) and with one key holding half of the 10M rows (``skew``),
    the logreg scores [262,144, 10] by label (``ten_groups``), 16 f32
    [100,000, 64] columns, max and sum in turn, over 256 groups (``wide``:
    each column runs in two 32-lane slices), one int32 sum of 65,519 rows
    over 1,000 groups (``stream_chunk``: the out-of-core drill's per-chunk
    aggregate) and one of 136 stacked 1,000-key partial tables
    (``stream_fold``: its fold)."""
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
    # one streamed chunk's aggregate on the data plane: the int32 w > 150,000
    # that survive the filter of 131,072 rows (about half) over 1,000 keys
    n = STREAM_CHUNK // 2 - 17
    ids = torch.randint(0, STREAM_KEYS, (n,), generator=g, device=dev, dtype=torch.int32)
    w = torch.randint(150_001, 300_000, (n,), generator=g, device=dev, dtype=torch.int32)
    feeds["stream_chunk"] = (ids, {"w": w}, (("w", "reduce_sum"),), STREAM_KEYS)
    # the drill's fold: every chunk's partial table (each key once) stacked
    n = 136 * STREAM_KEYS
    ids = torch.arange(STREAM_KEYS, device=dev, dtype=torch.int32).repeat(136)
    w = torch.randint(12_000_000, 18_000_000, (n,), generator=g, device=dev, dtype=torch.int32)
    feeds["stream_fold"] = (ids, {"w": w}, (("w", "reduce_sum"),), STREAM_KEYS)
    return feeds


def widest_f32(cols, ops):
    """The f32 column of ``ops`` with the most elements, as [n, d]: the
    column a leg's ``segment_sum`` sums."""
    import torch

    w = max((cols[x] for x, _ in ops if cols[x].dtype == torch.float32), key=lambda t: t.numel())
    return w if w.ndim == 2 else w[:, None]


def segment_legs(dev) -> dict:
    """Phase 1's segment legs beyond the main path's feed: ``segment_leg``
    over the skew, 10-group, wide, streamed-chunk and fold feeds of
    ``segment_feeds``."""
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
                 page: int = 16, hd: int = 64, maxp: int = 12, start=None):
    """A random int8 pool of the decode server's geometry. Decode geometry
    (``start=None``): S slots whose positions spread over the 192-position
    horizon on distinct pages; with S > 1 the last slot is padding (null
    table, position 0). Prefill geometry (``start`` given): the rows of
    one sequence's prefill, each carrying its table, ``pos = start + i``
    up to the table's horizon and at most S - 1 rows; the rows past them
    are padding (null table, position 0), as ``paged_suffix_prefill_fn``
    lays them out."""
    import numpy as np
    import torch

    rng = np.random.default_rng(SEED + S + (0 if start is None else 1 + start))
    kv = [torch.from_numpy(rng.integers(-127, 128, (pages, layers, nh, page, hd)).astype(
        np.int8)).to(dev) for _ in range(2)]
    sc = [torch.from_numpy(rng.uniform(0.001, 0.03, (pages, layers, nh, page, 1)).astype(
        np.float32)).to(dev) for _ in range(2)]
    q = torch.from_numpy(rng.standard_normal((S, nh, hd)).astype(np.float32)).to(
        dev, torch.bfloat16)
    tables = np.zeros((S, maxp), np.int32)
    free = rng.permutation(np.arange(1, pages))
    if start is None:
        pos = np.linspace(maxp * page - 1, 0, S).astype(np.int32)
        for s in range(S):
            n = pos[s] // page + 1
            tables[s, :n], free = free[:n], free[n:]
        if S > 1:
            pos[-1], tables[-1] = 0, 0
    else:
        rows = min(S - 1, maxp * page - start)
        pos = np.zeros(S, np.int32)
        pos[:rows] = start + np.arange(rows)
        n = (start + rows - 1) // page + 1
        tables[:rows, :n] = free[:n]
    return (q, *kv, *sc, torch.from_numpy(tables).to(dev), torch.from_numpy(pos).to(dev))


# (slots, page-table width, prefill start): the serving geometry, a context
# of up to 1,024 positions (past the 256-position staging), and the
# prefills' geometry, a row a slot at the suffix bucket's top of 128 rows:
# a cold prefill of 127 rows and a suffix after a 112-token prefix
DECODE_CASES = ((1, 12, None), (16, 12, None), (4, 64, None), (128, 12, 0), (128, 12, 112))


def check_decode_attention(dev) -> dict:
    """Kernel against plain at 1 and 16 slots of the serving pool, at 4
    slots of 64-page tables and at the prefills' 128 rows of one table
    (starts 0 and 112; layer 5 of 12), twice with the same bits, each slot
    alone equal to the same slot in the batch, and two broken plain
    versions (the step gate's: no V scale, the newest position missed)
    outside the tolerance at each; timed at 16 slots, and at the cold
    prefill's 128 rows (``prefill_ms``, ``prefill_plain_ms``). The library
    call is SDPA over K/V already gathered and dequantized (that gather is
    not timed)."""
    import torch
    import torch.nn.functional as F
    from tensorframes_tpu_torch import kernels
    from tensorframes_tpu_torch.kernels import decode_attention as kda

    err, worst = 0.0, 0.0
    broken = {what: fn for what, (name, fn) in broken_plain_paths().items()
              if name == "paged_attention_reference"}
    for S, maxp, start in DECODE_CASES:
        inputs = paged_inputs(dev, S, maxp=maxp, start=start)
        args = (*inputs[:5], 5, *inputs[5:])
        kernels.LAUNCHES.reset()
        got, again = kda.paged_decode_attention(*args), kda.paged_decode_attention(*args)
        launched = kernels.LAUNCHES.snapshot()["decode_attention"]
        ref = kda.paged_attention_reference(*args)
        torch.cuda.synchronize()
        what = f"decode_attention S={S} maxp={maxp}" + (
            "" if start is None else f" prefill start={start}")
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
    pre = paged_inputs(dev, 128, start=0)
    pre = (*pre[:5], 5, *pre[5:])
    prefill_ms = time_ms(lambda: kda.paged_decode_attention(*pre), "decode_attention prefill")
    prefill_plain_ms = time_ms(lambda: kda.paged_attention_reference(*pre),
                               "decode_attention prefill plain")
    log(f"# decode_attention prefill rows (S=128, start=0): kernel {prefill_ms:.6f} ms, "
        f"plain {prefill_plain_ms:.6f} ms")
    return {
        "prefill_ms": prefill_ms,
        "prefill_plain_ms": prefill_plain_ms,
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
    # the same aggregate straight off the lazy scoring chain: the plan
    # route (the label is a key the chain computes, so the chain runs and
    # the keyed reduction follows), fused and with plan_fusion off, equal
    # bit for bit to each other and to the aggregate above
    def label_agg():
        chain = tft.map_blocks(logreg.scoring_program(params), ff, device=dev)
        with tft.with_graph():
            out = tft.aggregate(tft.reduce_sum(tft.block(chain, "scores", tf_name="scores_input"),
                                               name="scores"), chain.group_by("label"), device=dev)
        return out.column_values("label"), out.column_values("scores")

    fused_cfg3 = label_agg()
    with knobs(tft, plan_fusion=False):
        unfused_cfg3 = label_agg()
    for a, b in zip(fused_cfg3 + fused_cfg3, unfused_cfg3 + (agg.column_values("label"), got)):
        if a.dtype != b.dtype or a.tobytes() != b.tobytes():
            fail("logreg aggregate by label: the plan route, plan_fusion=False and the "
                 "materialized frame's aggregate differ")
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
FILTER_REPS = 3
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
    exact, each through its kernel by the launch counts; the filter
    again, FILTER_REPS times each way, alternating ``plan_fusion=False``
    and fused, every result equal to the first, so the plan's host cost
    on a one-stage filter reads off one run (medians); on an ``n_slice``-row slice ``sort_values(["k", "x"],
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
    # the plan's mask route against the eager one, warm and alternated in
    # one run: the host time the plan machinery adds to a one-stage filter
    warm = {"filter unfused": [], "filter fused again": []}
    for _ in range(FILTER_REPS):
        for label, fusion in (("filter unfused", False), ("filter fused again", True)):
            with knobs(tft, plan_fusion=fusion):
                t0 = time.perf_counter()
                other = frame.filter(lambda x: {"keep": x > 0.5}, device=dev).cache()
                warm[label].append((time.perf_counter() - t0) * 1e3)
            if not np.array_equal(other.column_values("id"), fid):
                fail(f"relational: {label} differs from the first filter")
            del other
    for label, ws in warm.items():
        walls[label] = float(np.median(ws))
    log("# relational filter, warm, alternated (ms): " + "; ".join(
        f"{label} median {walls[label]:.3f} of {', '.join(f'{w:.3f}' for w in ws)}"
        for label, ws in warm.items()))

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


# the plan leg's pipelines (bench.py's chain3, chain3_join and multijoin)
# at the relational leg's scale: 10M rows in 8 blocks, seed 0. multijoin
# groups by (k1, k2) over 512 x PLAN_G2 keys: 4,096 groups, the segment
# kernel's MAX_SEGMENTS, where bench.py's 64 k2 keys (32,768 groups) would
# leave the pushed-down partial aggregate to the torch route
PLAN_ROWS, PLAN_BLOCKS, PLAN_G1, PLAN_G2, PLAN_REPS = 10_000_000, 8, 512, 8, 3
PLAN_TRACE = ROOT / "build" / "plan_leg_trace.json"


QUERY_PARTS = 56            # the registered-query drill's CSV parts ...
QUERY_PART_ROWS = 80_000    # ... of 80,000 rows: k in 0-63, v in -1,000-999
QUERY_KEYS = 64
QUERY_REPEATS = 20
STREAM_BUDGET = 32 << 20    # the out-of-core drill's BlockStore budget
STREAM_FACTOR = 5           # CSV bytes on disk over the budget
STREAM_CHUNK = 131_072      # rows a chunk
STREAM_RSS_CAP = 3.5        # peak RSS growth over the walk, in budgets
STREAM_KEYS = 1000          # k in 0-999, v in 0-99,999
STREAM_PART_ROWS = (900_000, 1_150_000)  # each part's rows, drawn: ~10 MB, a ragged last chunk
ROUNDTRIP_ROWS = 1_000_000


def csv_body(*cols) -> bytes:
    """Rows of integer columns as unquoted CSV bytes without a header, each
    cell as ``str`` writes it (a minus sign, no leading zeros): one byte
    matrix of sign, digit and separator columns, masked and flattened,
    rather than one Python string a row."""
    import numpy as np

    n = len(cols[0])
    mats, masks = [], []
    for j, x in enumerate(cols):
        x = np.asarray(x, np.int64)
        a = np.abs(x)
        width = len(str(int(a.max()))) if n else 1
        if width < 10:
            a = a.astype(np.int32)
        p10 = 10 ** np.arange(width - 1, -1, -1, dtype=a.dtype)
        ndig = 1 + (a[:, None] >= p10[None, :-1]).sum(axis=1)
        sep = b"\n" if j == len(cols) - 1 else b","
        mats += [np.full((n, 1), ord("-"), np.uint8),
                 ((a[:, None] // p10) % 10 + ord("0")).astype(np.uint8),
                 np.full((n, 1), sep[0], np.uint8)]
        masks += [(x < 0)[:, None], np.arange(width)[None, :] >= (width - ndig)[:, None],
                  np.ones((n, 1), bool)]
    return np.hstack(mats)[np.hstack(masks)].tobytes()


class RssPeak:
    """The process's peak resident set over a window, sampled from
    ``/proc/self/status`` every 5 ms by a thread (the kernel's own high-water
    mark counts the legs before this one)."""

    def __init__(self):
        self.base = self.peak = self.read()
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._run, daemon=True, name="rss-peak")
        self._t.start()

    @staticmethod
    def read() -> int:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) << 10
        return 0

    def _run(self):
        while not self._stop.wait(0.005):
            self.peak = max(self.peak, self.read())

    def stop(self) -> int:
        self._stop.set()
        self._t.join()
        self.peak = max(self.peak, self.read())
        return self.peak - self.base


def query_oracle(parts) -> dict:
    """The registered query's answer by numpy over every part: int32
    ``v * 3 + 1`` summed, min'd and max'd by ``k``."""
    import numpy as np

    k = np.concatenate([p[0] for p in parts])
    y = (np.concatenate([p[1] for p in parts]) * 3 + 1).astype(np.int32)
    keys = np.unique(k)
    idx = np.searchsorted(keys, k)
    ysum = np.bincount(idx, weights=y, minlength=len(keys)).astype(np.int64).astype(np.int32)
    ymin = np.full(len(keys), np.iinfo(np.int32).max, np.int32)
    ymax = np.full(len(keys), np.iinfo(np.int32).min, np.int32)
    np.minimum.at(ymin, idx, y)
    np.maximum.at(ymax, idx, y)
    return {"k": keys, "ysum": ysum, "ymin": ymin, "ymax": ymax}


def same_table(got: dict, want: dict, what: str) -> None:
    """Bit for bit, dtypes included, row order too (a query's rows come in
    canonical key order); the column order is not compared (a folded
    refresh lists the fetches in their order, a plan's table in its
    schema's, in both packages)."""
    import numpy as np

    if sorted(got) != sorted(want):
        fail(f"{what}: columns {list(got)} != {list(want)}")
    for c in want:
        g, w = np.asarray(got[c]), np.asarray(want[c])
        if g.dtype != w.dtype or g.shape != w.shape or g.tobytes() != w.tobytes():
            fail(f"{what}: column {c!r} differs ({g.dtype}{g.shape} vs {w.dtype}{w.shape})")


def registered_query_drill(tft, work: str) -> dict:
    """A growing directory of CSV parts served as a registered query on the
    card (≙ the reference's ``bench.py:1314-1440``): 56 parts of 80,000
    rows, a map to int32 ``ysum = ymin = ymax = v * 3 + 1`` and a keyed
    sum/min/max by ``k`` through ``segment_reduce``, the result store armed
    under a temporary ``compilation_cache_dir``. Gates: 20 repeats all hits
    with no new dispatch key; one appended part refreshes by executing one
    chunk; the refresh equals ``_execute_full`` and a numpy int32 oracle
    bit for bit; a fresh ``Server`` over the same cache dir warms from the
    store executing no chunk; one answer over ``serve_http``;
    ``segment_reduce`` launched during the cold execute and the refresh.
    Then the dispatch-key store's cost on a cold execute: fresh servers,
    each over an empty cache dir so that every part executes, with the
    store armed and off (``active_store`` patched to None) in the order
    off, armed, armed, off; every cold execute's wall spent in
    ``CompiledProgram._consult_store`` is timed beside it."""
    import http.client
    import os

    import numpy as np
    import torch

    data = os.path.join(work, "query")
    os.makedirs(data)
    rng = np.random.default_rng(SEED)
    parts = []

    def write_part(i):
        k = rng.integers(0, QUERY_KEYS, QUERY_PART_ROWS)
        v = rng.integers(-1000, 1000, QUERY_PART_ROWS)
        with open(os.path.join(data, f"part-{i:04d}.csv"), "wb") as f:
            f.write(b"k,v\n" + csv_body(k, v))
        parts.append((k, v))

    for i in range(QUERY_PARTS):
        write_part(i)

    def build(f):
        g = tft.map_blocks(lambda v: {"ysum": (v * 3 + 1).to(torch.int32),
                                      "ymin": (v * 3 + 1).to(torch.int32),
                                      "ymax": (v * 3 + 1).to(torch.int32)}, f)
        with tft.with_graph():
            ins = {c: tft.block(g, c, tf_name=f"{c}_input") for c in ("ysum", "ymin", "ymax")}
            return tft.aggregate([tft.reduce_sum(ins["ysum"], axis=0, name="ysum"),
                                  tft.reduce_min(ins["ymin"], axis=0, name="ymin"),
                                  tft.reduce_max(ins["ymax"], axis=0, name="ymax")],
                                 g.group_by("k"))

    from unittest import mock

    from tensorframes_tpu_torch.compilecache import store as cc_store
    from tensorframes_tpu_torch.ops.executor import CompiledProgram

    consult, consult_s = CompiledProgram._consult_store, []

    def timed_consult(self, key, device):
        t0 = time.perf_counter()
        try:
            return consult(self, key, device)
        finally:
            consult_s.append(time.perf_counter() - t0)

    out = {}
    with knobs(tft, compilation_cache_dir=os.path.join(work, "cache")), \
            mock.patch.object(CompiledProgram, "_consult_store", timed_consult):
        srv = tft.Server()
        q = srv.register_query("dashboard", tft.QuerySource(path=data), build)
        if not (q.cache_stats()["cacheable"] and q.cache_stats()["incremental"]):
            fail(f"data plane: the query declined a cache level: {q.cache_stats()}")
        tft.kernels.LAUNCHES.reset()
        t0 = time.perf_counter()
        srv.start()  # the cold execute: every part read and executed once
        out["first_execute_s"] = time.perf_counter() - t0
        out["first_execute_store"] = {"s": sum(consult_s), "consults": len(consult_s)}
        cold = tft.kernels.LAUNCHES.snapshot()
        out["cold_launches"] = cold
        if cold["segment_reduce"] <= 0:
            fail(f"data plane: the cold execute never launched segment_reduce: {cold}")
        if q.cache_stats()["chunks_executed"] != QUERY_PARTS:
            fail(f"data plane: the cold execute ran {q.cache_stats()['chunks_executed']} chunks")
        misses0 = srv.stats()["process"]["xla_compiles"]
        hits0 = q.cache_stats()["hits"]
        from tensorframes_tpu_torch.compilecache.fingerprint import content_digest

        walls = []
        split = {"list_s": [], "manifest_s": [], "digest_s": []}
        first = None
        for _ in range(QUERY_REPEATS):
            # a hit's own steps timed beside it: the directory listing, the
            # manifest (listing and a stat and sha256 a part), the digest
            t0 = time.perf_counter()
            tft.io._part_files(data, tft.io.PART_EXTS["csv"])
            t1 = time.perf_counter()
            manifest = q._manifest()
            t2 = time.perf_counter()
            content_digest(sig for _, sig in manifest)
            t3 = time.perf_counter()
            table = srv.call("dashboard", None)
            walls.append(time.perf_counter() - t3)
            for key, dt in zip(split, (t1 - t0, t2 - t1, t3 - t2)):
                split[key].append(dt)
            first = first or table
        out["hit_split_p50_s"] = {k: float(np.median(v)) for k, v in split.items()}
        if q.cache_stats()["hits"] - hits0 != QUERY_REPEATS:
            fail(f"data plane: {QUERY_REPEATS} repeats made "
                 f"{q.cache_stats()['hits'] - hits0} hits")
        if srv.stats()["process"]["xla_compiles"] != misses0:
            fail("data plane: the repeats added executor dispatch-key misses")
        out["repeat_p50_s"] = float(np.median(walls))
        same_table(first, query_oracle(parts), "data plane: the cold answer against numpy")

        write_part(QUERY_PARTS)
        executed0 = q.cache_stats()["chunks_executed"]
        tft.kernels.LAUNCHES.reset()
        t0 = time.perf_counter()
        refreshed = srv.call("dashboard", None)
        out["refresh_s"] = time.perf_counter() - t0
        refresh = tft.kernels.LAUNCHES.snapshot()
        out["refresh_launches"] = refresh
        if refresh["segment_reduce"] <= 0:
            fail(f"data plane: the refresh never launched segment_reduce: {refresh}")
        if q.cache_stats()["chunks_executed"] - executed0 != 1:
            fail(f"data plane: the refresh executed "
                 f"{q.cache_stats()['chunks_executed'] - executed0} chunks (want 1)")
        from tensorframes_tpu_torch.plan.lower import canonical_table_order

        t0 = time.perf_counter()
        full = canonical_table_order(q._execute_full(tft.io.part_manifest(data)), ("k",))
        out["full_recompute_s"] = time.perf_counter() - t0
        same_table(refreshed, full, "data plane: the refresh against _execute_full")
        same_table(refreshed, query_oracle(parts), "data plane: the refresh against numpy")
        srv.stop()

        srv2 = tft.Server()
        q2 = srv2.register_query("dashboard", tft.QuerySource(path=data), build)
        srv2.start()
        httpd = tft.serve_http(srv2, port=0)
        try:
            if q2.cache_stats()["chunks_executed"] != 0 or q2.cache_stats()["hits"] != 1:
                fail(f"data plane: a fresh server did not warm from the store: "
                     f"{q2.cache_stats()}")
            same_table(srv2.call("dashboard", None), refreshed,
                       "data plane: the fresh server's answer")
            c = http.client.HTTPConnection("127.0.0.1", httpd.server_address[1], timeout=60)
            c.request("POST", "/v1/dashboard", body=b"{}",
                      headers={"Content-Type": "application/json"})
            r = c.getresponse()
            body = json.loads(r.read())
            c.close()
            if r.status != 200 or body["outputs"] != {k: v.tolist() for k, v in refreshed.items()}:
                fail(f"data plane: the HTTP answer differs (status {r.status})")
        finally:
            httpd.shutdown()
            httpd.server_close()
            srv2.stop()

        ab = {"off": [], "armed": []}
        for i, mode in enumerate(("off", "armed", "armed", "off")):
            off = mock.patch.object(cc_store, "active_store", lambda: None) if mode == "off" \
                else contextlib.nullcontext()
            with knobs(tft, compilation_cache_dir=os.path.join(work, f"cache_ab{i}")), off:
                srv3 = tft.Server()
                q3 = srv3.register_query("dashboard", tft.QuerySource(path=data), build)
                del consult_s[:]
                t0 = time.perf_counter()
                srv3.start()
                ab[mode].append({"s": time.perf_counter() - t0, "store_s": sum(consult_s),
                                 "consults": len(consult_s)})
                srv3.stop()
                if q3.cache_stats()["chunks_executed"] != QUERY_PARTS + 1:
                    fail(f"data plane: the store A/B's cold execute ran "
                         f"{q3.cache_stats()['chunks_executed']} chunks")
        out["store_ab"] = ab
    out["refresh_over_full"] = out["refresh_s"] / out["full_recompute_s"]
    out["rows"] = (QUERY_PARTS + 1) * QUERY_PART_ROWS
    return out


def out_of_core_drill(tft, work: str) -> dict:
    """A CSV directory five times a 32 MB ``BlockStore`` budget streamed
    through ``stream_chain`` on the card (≙ the reference's
    ``bench.py:3436-3595``): ``w = int32(v * 3)``, ``w > 150,000``, a keyed
    sum by ``k`` per chunk of 131,072 rows, folded; then the map/filter
    alone, whose output spills. Every part holds its own seeded rows, and
    no part is a whole number of chunks, so no two chunks are alike. Gates:
    the fold equals the in-memory chain and numpy's (``bincount`` of the
    kept ``w`` by ``k``, cast to int32 as the kernel's int32 sum wraps) bit
    for bit; the spilled result read back equals the in-memory map/filter
    and numpy's filter; something spilled; the peak RSS growth over the
    walk (after a warm-up walk over one part) stays within 3.5 budgets;
    ``segment_reduce`` launched."""
    import os

    import numpy as np
    import torch

    parts_dir = os.path.join(work, "stream")
    os.makedirs(parts_dir)
    rng = np.random.default_rng(11)
    ks, vs = [], []
    written = 0
    while written < STREAM_FACTOR * STREAM_BUDGET:
        n = int(rng.integers(*STREAM_PART_ROWS))
        k, v = rng.integers(0, STREAM_KEYS, n), rng.integers(0, 100_000, n)
        body = csv_body(k, v)
        with open(os.path.join(parts_dir, f"part-{len(ks):04d}.csv"), "wb") as f:
            f.write(b"k,v\n" + body)
        written += len(body)
        ks.append(k)
        vs.append(v)
    del body
    n_rows = sum(len(k) for k in ks)

    def agg(f):
        with tft.with_graph():
            w = tft.block(f, "w", tf_name="w_input")
            return tft.aggregate(tft.reduce_sum(w, axis=0, name="w"), f.group_by("k"))

    def mapfilter(f):
        g = tft.map_blocks(lambda v: {"w": (v * 3).to(torch.int32)}, f)
        return g.filter(lambda w: w > 150_000)

    def chain(f):
        return agg(mapfilter(f))

    first_part = os.path.join(parts_dir, "part-0000.csv")
    with tft.BlockStore(root=os.path.join(work, "warm"), budget_bytes=STREAM_BUDGET) as warm:
        tft.stream_chain(tft.scan_csv([first_part], rows_per_chunk=STREAM_CHUNK),
                         chain_fn=chain, fold_fn=agg, store=warm)
        tft.stream_chain(tft.scan_csv([first_part], rows_per_chunk=STREAM_CHUNK),
                         chain_fn=mapfilter, store=warm).drop()
    store = tft.BlockStore(root=os.path.join(work, "store"), budget_bytes=STREAM_BUDGET)
    rss = RssPeak()
    tft.kernels.LAUNCHES.reset()
    t0 = time.perf_counter()
    res = tft.stream_chain(tft.scan_csv(parts_dir, rows_per_chunk=STREAM_CHUNK),
                           chain_fn=chain, fold_fn=agg, store=store)
    stream_s = time.perf_counter() - t0
    launches = tft.kernels.LAUNCHES.snapshot()
    sf = tft.stream_chain(tft.scan_csv(parts_dir, rows_per_chunk=STREAM_CHUNK),
                          chain_fn=mapfilter, store=store)
    peak = rss.stop()
    out = {"rows": n_rows, "csv_bytes": written, "parts": len(ks),
           "chunks": sum(-(-len(k) // STREAM_CHUNK) for k in ks),
           "budget_bytes": STREAM_BUDGET,
           "rss_growth_bytes": peak, "rss_cap_bytes": int(STREAM_RSS_CAP * STREAM_BUDGET),
           "resident_bytes": store.resident_bytes, "spilled_bytes": store.spilled_bytes,
           "stream_s": stream_s, "stream_rows_per_s": n_rows / stream_s,
           "launches": launches}
    if launches["segment_reduce"] <= 0:
        fail(f"data plane: the streamed chain never launched segment_reduce: {launches}")
    if store.spilled_bytes <= 0:
        fail("data plane: the streamed map/filter spilled nothing")
    if peak > out["rss_cap_bytes"]:
        fail(f"data plane: peak RSS grew {peak} bytes over the walk, above "
             f"{STREAM_RSS_CAP} x the {STREAM_BUDGET}-byte budget")
    stream_k, stream_w = res.column_values("k"), res.column_values("w")
    del res

    k_all, v_all = np.concatenate(ks), np.concatenate(vs)
    del ks, vs
    w_all = (v_all * 3).astype(np.int32)
    keep = w_all > 150_000
    kept = {"k": k_all[keep], "v": v_all[keep], "w": w_all[keep]}
    present = np.flatnonzero(np.bincount(kept["k"], minlength=STREAM_KEYS))
    sums = np.bincount(kept["k"], weights=kept["w"], minlength=STREAM_KEYS)  # exact: < 2**53
    order = np.argsort(stream_k, kind="stable")
    same_table({"k": stream_k[order], "w": stream_w[order]},
               {"k": present, "w": sums[present].astype(np.int64).astype(np.int32)},
               "data plane: the streamed fold against numpy")

    full = tft.frame_from_arrays({"k": k_all, "v": v_all})
    del k_all, v_all, w_all, keep
    t0 = time.perf_counter()
    oracle = chain(full)
    oracle.blocks()
    out["in_memory_s"] = time.perf_counter() - t0
    out["in_memory_rows_per_s"] = n_rows / out["in_memory_s"]
    same_table({"k": stream_k, "w": stream_w},
               {"k": oracle.column_values("k"), "w": oracle.column_values("w")},
               "data plane: the streamed fold against the in-memory chain")
    mem_mf = mapfilter(full)
    back = sf.to_frame(mmap=True)
    back_cols = {c: back.column_values(c) for c in ("k", "v", "w")}
    same_table(back_cols, {c: mem_mf.column_values(c) for c in ("k", "v", "w")},
               "data plane: the spilled map/filter read back against the in-memory one")
    same_table(back_cols, kept,
               "data plane: the spilled map/filter read back against numpy's filter")
    out["groups"] = int(len(stream_k))
    out["kept_rows"] = int(len(kept["k"]))
    del back, back_cols, mem_mf, oracle, full, kept
    sf.drop()
    store.close()
    return out


def round_trip_drill(tft, dev, work: str) -> dict:
    """``save_frame``/``load_frame`` of a 1M-row frame whose dense columns
    (int8, int32, int64, float16, float32, float64 and an f32 [n, 4] vector)
    come off the card through ``map_blocks``, beside a string column, bit
    for bit; and ``read_csv`` of a 1M-row unquoted file through the native
    parse against numpy's parse of the same bytes."""
    import os

    import numpy as np
    import torch

    rng = np.random.default_rng(SEED + 16)
    n = ROUNDTRIP_ROWS
    src = {
        "i8": rng.integers(-128, 128, n).astype(np.int8),
        "i32": rng.integers(-2**31, 2**31 - 1, n).astype(np.int32),
        "i64": rng.integers(-2**62, 2**62, n),
        "f16": rng.standard_normal(n).astype(np.float16),
        "f32": rng.standard_normal(n).astype(np.float32),
        "f64": rng.standard_normal(n),
        "vec": rng.standard_normal((n, 4)).astype(np.float32),
    }
    host = tft.frame_from_arrays(dict(src))
    names = list(src)
    on_card = tft.map_blocks(
        lambda i8, i32, i64, f16, f32, f64, vec: {
            "o_i8": i8.clone(), "o_i32": i32.clone(), "o_i64": i64.clone(),
            "o_f16": f16.clone(), "o_f32": f32.clone(), "o_f64": f64.clone(),
            "o_vec": vec.clone()}, host, device=dev)
    strings = [f"s{i % 1000}" for i in range(n)]
    frame = tft.frame_from_arrays(
        {**{c: on_card.column_values(f"o_{c}") for c in names}, "s": strings})
    path = os.path.join(work, "saved")
    t0 = time.perf_counter()
    tft.save_frame(frame, path)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = tft.load_frame(path)
    load_s = time.perf_counter() - t0
    for c in names:
        got = back.column_values(c)
        if got.dtype != src[c].dtype or got.tobytes() != src[c].tobytes():
            fail(f"data plane: save_frame/load_frame changed column {c!r}")
    if back.column_values("s").tolist() != strings:
        fail("data plane: save_frame/load_frame changed the string column")

    k = rng.integers(-10**12, 10**12, n)
    v = np.round(rng.standard_normal(n) * 1e3, 4)
    csv = os.path.join(work, "rows.csv")
    with open(csv, "w") as f:
        f.write("k,v\n")
        f.write("\n".join(np.char.add(np.char.add(k.astype(str), ","),
                                      v.astype(str)).tolist()) + "\n")
    t0 = time.perf_counter()
    parsed = tft.read_csv(csv)
    read_s = time.perf_counter() - t0
    ref_k = np.loadtxt(csv, delimiter=",", skiprows=1, usecols=0, dtype=np.int64)
    ref_v = np.loadtxt(csv, delimiter=",", skiprows=1, usecols=1, dtype=np.float64)
    if not (parsed.column_values("k").tobytes() == ref_k.tobytes()
            and parsed.column_values("v").tobytes() == ref_v.tobytes()):
        fail("data plane: read_csv's native parse differs from numpy's")
    return {"rows": n, "save_s": save_s, "load_s": load_s,
            "saved_bytes": sum(os.path.getsize(os.path.join(path, x)) for x in os.listdir(path)),
            "read_csv_s": read_s, "read_csv_rows_per_s": n / read_s,
            "native_build_s": tft.native.build_seconds,
            "native_library": tft.native._so_path().name}


NATIVE_SITE_ROWS = 200_000


def native_sites(tft, work: str) -> dict:
    """Each call site of the native row pass timed on the host with the pass
    on and with ``TFS_TPU_DISABLE_NATIVE=1`` (the pure-Python path), the two
    taking turns twice, the best of each kept; both paths' outputs are
    compared exactly. Sites: ``read_csv`` of the round-trip drill's 1M-row
    file, ``part_frame`` of one registered-query part (80,000 rows),
    ``collect`` and ``frame_from_rows`` of 200,000 rows of int64, float64
    and int32 scalars, the object-key encode of 1M strings over 1,000 keys,
    and the ragged stack of 200,000 f32[16] cells."""
    import os

    import numpy as np
    from tensorframes_tpu_torch.ops.keys import _unique_inverse
    from tensorframes_tpu_torch.ops.verbs import _stack_group

    rng = np.random.default_rng(SEED + 17)
    n = NATIVE_SITE_ROWS
    frame = tft.frame_from_arrays({"a": rng.integers(-10**12, 10**12, n),
                                   "b": rng.standard_normal(n),
                                   "c": rng.integers(-1000, 1000, n).astype(np.int32)})
    rows = frame.collect()
    keys = np.empty(ROUNDTRIP_ROWS, object)
    keys[:] = [f"key-{i}" for i in rng.integers(0, 1000, ROUNDTRIP_ROWS)]
    cells = list(rng.standard_normal((n, 16)).astype(np.float32))
    idx = np.arange(n)

    def cols(f):
        return {c: (str(f.column_values(c).dtype), f.column_values(c).tobytes())
                for c in f.schema.names}

    sites = {
        "read_csv_1m": lambda: cols(tft.read_csv(os.path.join(work, "rows.csv"))),
        "query_part_parse": lambda: cols(tft.io.part_frame(
            os.path.join(work, "query", "part-0000.csv"))),
        "collect": frame.collect,
        "frame_from_rows": lambda: cols(tft.frame_from_rows(rows)),
        "object_key_encode": lambda: [x.tolist() for x in _unique_inverse(keys)],
        "ragged_stack": lambda: _stack_group(cells, idx).tobytes(),
    }
    prior = os.environ.pop("TFS_TPU_DISABLE_NATIVE", None)
    out = {}
    try:
        for name, fn in sites.items():
            best = {"native": float("inf"), "pure": float("inf")}
            got = {}
            for mode in ("native", "pure", "native", "pure"):
                if mode == "pure":
                    os.environ["TFS_TPU_DISABLE_NATIVE"] = "1"
                t0 = time.perf_counter()
                got[mode] = fn()
                best[mode] = min(best[mode], time.perf_counter() - t0)
                os.environ.pop("TFS_TPU_DISABLE_NATIVE", None)
            if got["native"] != got["pure"]:
                fail(f"data plane: the native and pure paths of {name} differ")
            out[name] = {"native_s": best["native"], "pure_s": best["pure"],
                         "pure_over_native": best["pure"] / best["native"]}
    finally:
        if prior is not None:
            os.environ["TFS_TPU_DISABLE_NATIVE"] = prior
    return out


def data_plane_leg(tft, dev) -> dict:
    """The data path on the card: the registered-query drill, the
    out-of-core stream, the round trips and the native row pass's call
    sites against their pure paths, in a temporary directory.
    ``launches`` sums the query's cold execute and refresh and the
    streamed chain."""
    import shutil

    if not tft.native.available():
        fail("data plane: the native row pass is disabled (TFS_TPU_DISABLE_NATIVE=1)")
    work = tempfile.mkdtemp(prefix="tftorch-data-plane-")
    try:
        t0 = time.perf_counter()
        query = registered_query_drill(tft, work)
        t1 = time.perf_counter()
        stream = out_of_core_drill(tft, work)
        t2 = time.perf_counter()
        trips = round_trip_drill(tft, dev, work)
        t3 = time.perf_counter()
        sites = native_sites(tft, work)
        t4 = time.perf_counter()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    launches = {name: query["cold_launches"][name] + query["refresh_launches"][name]
                + stream["launches"][name] for name in query["cold_launches"]}
    return {"query": query, "stream": stream, "round_trips": trips, "native_sites": sites,
            "launches": launches,
            "walls_s": {"query": t1 - t0, "stream": t2 - t1, "round_trips": t3 - t2,
                        "native_sites": t4 - t3}}


def copy_profile(fn) -> dict:
    """One call of ``fn`` under ``torch.profiler`` after a traced warm-up
    (see :func:`timeline_profile`), read from its exported Chrome trace:
    the count and bytes of ``Memcpy HtoD`` and ``Memcpy DtoH`` copies,
    the device's busy time (the union of its kernel, copy and memset
    intervals) and its share of the call's host wall."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    PLAN_TRACE.parent.mkdir(parents=True, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=torch.profiler.schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: p.export_chrome_trace(str(PLAN_TRACE))) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        prof.step()
    trace = json.loads(PLAN_TRACE.read_text())
    PLAN_TRACE.unlink()
    out = {"htod_count": 0, "htod_bytes": 0, "dtoh_count": 0, "dtoh_bytes": 0}
    spans = []
    for ev in trace.get("traceEvents", []):
        if ev.get("ph") != "X" or ev.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        spans.append((float(ev["ts"]) / 1e3, (float(ev["ts"]) + float(ev["dur"])) / 1e3))
        name = ev.get("name", "")
        for tag, key in (("Memcpy HtoD", "htod"), ("Memcpy DtoH", "dtoh")):
            if name.startswith(tag):
                out[f"{key}_count"] += 1
                out[f"{key}_bytes"] += int((ev.get("args") or {}).get("bytes", 0))
    busy = sum(b - a for a, b in merged(spans))
    return {**out, "wall_ms": wall, "busy_ms": busy, "busy_share": busy / wall}


def plan_pipelines(tft, dev) -> dict:
    """bench.py's three plan pipelines (``_bench_chain3``,
    ``_bench_chain3_join``, ``_bench_multijoin``) at PLAN_ROWS rows in
    PLAN_BLOCKS blocks: each a function from nothing to its outputs (a
    dict of numpy columns), rebuilding its chain from pre-compiled
    stage Programs as a per-batch pipeline would."""
    import numpy as np

    n = PLAN_ROWS
    rng = np.random.default_rng(SEED)
    frame = tft.frame_from_arrays({"x": np.arange(n, dtype=np.float32)}, num_blocks=PLAN_BLOCKS)
    c1 = tft.compile_program(lambda x: {"y": x * 2.0 + 1.0}, frame, device=dev)
    cf1 = tft.map_blocks(c1, frame, device=dev)
    c2 = tft.compile_program(lambda y: {"z": y * 0.5 - 3.0}, cf1, device=dev)
    cf2 = tft.map_blocks(c2, cf1, device=dev)
    c3 = tft.compile_program(lambda z: {"w": z * z + 1.0}, cf2, device=dev)

    def chain3():
        out = tft.map_blocks(c3, tft.map_blocks(c2, tft.map_blocks(c1, frame, device=dev),
                                                device=dev), device=dev).select(["w"])
        return {"w": out.column_values("w")}

    # chain3_join: dead probe columns a, b and an [n, 8] e, a dead build
    # column; small integers, so every f32 group sum is exact
    probe = tft.frame_from_arrays({
        "k": rng.integers(0, PLAN_G1, n).astype(np.int32),
        "x": (np.arange(n) % 16).astype(np.float32),
        "a": np.arange(n, dtype=np.float32), "b": np.ones(n, np.float32),
        "e": np.ones((n, 8), np.float32)}, num_blocks=PLAN_BLOCKS)
    dim = tft.frame_from_arrays({"k": np.arange(PLAN_G1, dtype=np.int32),
                                 "w": np.arange(PLAN_G1, dtype=np.float32),
                                 "tag": np.ones(PLAN_G1, np.float32)}, num_blocks=1)
    j1 = tft.compile_program(lambda x: {"y": x * 2.0 + 1.0}, probe, device=dev)
    jf1 = tft.map_blocks(j1, probe, device=dev)
    j2 = tft.compile_program(lambda y: {"z": y * y}, jf1, device=dev)
    j0 = tft.map_blocks(j2, jf1, device=dev).join(dim, on="k")
    with tft.with_graph():
        jagg = tft.compile_program([
            tft.reduce_sum(tft.block(j0, "z", tf_name="z_input"), axis=0, name="z"),
            tft.reduce_sum(tft.block(j0, "w", tf_name="w_input"), axis=0, name="w"),
        ], j0, reduce_mode="blocks", device=dev)

    def chain3_join():
        f2 = tft.map_blocks(j2, tft.map_blocks(j1, probe, device=dev), device=dev)
        out = tft.aggregate(jagg, f2.join(dim, on="k").group_by("k"), device=dev)
        return {c: out.column_values(c) for c in ("k", "z", "w")}

    # multijoin: int32 star schema, unique dim keys (m = 1), dim2 holding
    # half of k2's keys so the inner join drops groups
    fact = tft.frame_from_arrays({
        "k1": rng.integers(0, PLAN_G1, n).astype(np.int32),
        "k2": rng.integers(0, PLAN_G2, n).astype(np.int32),
        "x": (np.arange(n) % 16).astype(np.int32),
        "a": np.arange(n, dtype=np.float32), "e": np.ones((n, 8), np.float32)},
        num_blocks=PLAN_BLOCKS)
    dim1 = tft.frame_from_arrays({"k1": np.arange(PLAN_G1, dtype=np.int32),
                                  "w1": np.arange(PLAN_G1, dtype=np.int32),
                                  "tag1": np.ones(PLAN_G1, np.float32)}, num_blocks=1)
    dim2 = tft.frame_from_arrays({"k2": np.arange(0, PLAN_G2, 2, dtype=np.int32),
                                  "w2": np.arange(PLAN_G2 // 2, dtype=np.int32),
                                  "tag2": np.ones(PLAN_G2 // 2, np.float32)}, num_blocks=1)
    m1 = tft.compile_program(lambda x: {"y": x * 2 + 1}, fact, device=dev)
    mf1 = tft.map_blocks(m1, fact, device=dev)
    m2 = tft.compile_program(lambda y: {"z": y * y}, mf1, device=dev)
    m0 = tft.map_blocks(m2, mf1, device=dev).join(dim1, on="k1").join(dim2, on="k2")
    with tft.with_graph():
        magg = tft.compile_program(
            [tft.reduce_sum(tft.block(m0, "z", tf_name="z_input"), axis=0, name="z")],
            m0, reduce_mode="blocks", device=dev)

    def multijoin():
        f2 = tft.map_blocks(m2, tft.map_blocks(m1, fact, device=dev), device=dev)
        j = f2.join(dim1, on="k1").join(dim2, on="k2")
        out = tft.aggregate(magg, j.group_by("k1", "k2"), device=dev)
        return {c: out.column_values(c) for c in ("k1", "k2", "z")}

    def expected():
        """Each pipeline's outputs computed with numpy (every sum exact)."""
        x = np.arange(n, dtype=np.float32)
        w = (((x * np.float32(2) + np.float32(1)) * np.float32(0.5) - np.float32(3)) ** 2
             + np.float32(1))
        k = probe.column_values("k")
        zf = (2 * (np.arange(n) % 16) + 1) ** 2
        cnt = np.bincount(k, minlength=PLAN_G1)
        ks = np.flatnonzero(cnt)
        cj = {"k": ks.astype(np.int32),
              "z": np.bincount(k, weights=zf, minlength=PLAN_G1)[ks].astype(np.float32),
              "w": (cnt * np.arange(PLAN_G1))[ks].astype(np.float32)}
        k1, k2 = fact.column_values("k1"), fact.column_values("k2")
        keep = k2 % 2 == 0
        code = k1[keep].astype(np.int64) * PLAN_G2 + k2[keep]
        sums = np.bincount(code, weights=zf[keep], minlength=PLAN_G1 * PLAN_G2)
        present = np.flatnonzero(np.bincount(code, minlength=PLAN_G1 * PLAN_G2))
        mj = {"k1": (present // PLAN_G2).astype(np.int32),
              "k2": (present % PLAN_G2).astype(np.int32),
              "z": sums[present].astype(np.int32)}
        return {"chain3": {"w": w}, "chain3_join": cj, "multijoin": mj}

    return {"chain3": chain3, "chain3_join": chain3_join, "multijoin": multijoin,
            "expected": expected}


def plan_leg(tft, dev) -> dict:
    """The plan layer on the card: bench.py's chain3, chain3_join and
    multijoin (:func:`plan_pipelines`), each in every mode — fused (the
    default), ``plan_fusion=False`` (stage by stage), and for multijoin
    ``plan_reopt=False`` (the static cost model) — with outputs equal to
    the fused ones bit for bit. Per mode: the median host wall of
    PLAN_REPS calls (after a warm-up call), the cost model's decisions
    counted in one call by kind, the kernels' launches per call, the
    ``tftpu_plan_intermediate_bytes_avoided_total`` delta of one call,
    and one profiled call's ``Memcpy HtoD``/``DtoH`` count and bytes and
    the device's busy share. An aggregate that launched no
    ``segment_reduce``, in any mode, fails: its epilogue (or the eager
    route) did not reach the kernel."""
    import numpy as np

    reg = tft.observability.REGISTRY

    def series(name):
        return {tuple(sorted(d["labels"].items())): float(d["value"])
                for d in reg.snapshot() if d["name"] == name}

    def delta(name, fn):
        before = series(name)
        out = fn()
        after = series(name)
        return out, {k: after[k] - before.get(k, 0.0) for k in after
                     if after[k] != before.get(k, 0.0)}

    pipes = plan_pipelines(tft, dev)
    expected = pipes["expected"]()
    modes = {"chain3": ("fused", "unfused"), "chain3_join": ("fused", "unfused"),
             "multijoin": ("fused", "static", "unfused")}
    knob_of = {"fused": {}, "unfused": {"plan_fusion": False}, "static": {"plan_reopt": False}}
    result = {}
    for name, mode_names in modes.items():
        fn = pipes[name]
        outs, per_mode = {}, {}
        for mode in mode_names:
            with knobs(tft, **knob_of[mode]):
                outs[mode] = fn()  # warm-up, and the outputs compared below
                walls, launches = [], []
                for _ in range(PLAN_REPS):
                    tft.kernels.LAUNCHES.reset()
                    t0 = time.perf_counter()
                    fn()
                    walls.append((time.perf_counter() - t0) * 1e3)
                    launches.append(tft.kernels.LAUNCHES.snapshot())
                _, decisions = delta("tftpu_plan_cost_decisions_total", fn)
                _, avoided = delta("tftpu_plan_intermediate_bytes_avoided_total", fn)
                prof = copy_profile(fn)
            per_call = {k: v for k, v in launches[-1].items() if v}
            per_mode[mode] = {
                "wall_ms": float(np.median(walls)), "walls_ms": walls,
                "decisions": {dict(k)["decision"]: v for k, v in decisions.items()},
                "launches_per_call": per_call,
                "bytes_avoided": sum(avoided.values()),
                **{("profiled_wall_ms" if k == "wall_ms" else k): v for k, v in prof.items()}}
            if name != "chain3" and per_call.get("segment_reduce", 0) < 1:
                fail(f"plan_leg {name} ({mode}): the aggregate launched segment_reduce "
                     f"{per_call.get('segment_reduce', 0)} times a call — its epilogue did not "
                     "reach the kernel")
            r = per_mode[mode]
            log(f"# plan {name} {mode}: median {r['wall_ms']:.3f} ms of {PLAN_REPS} calls "
                f"({', '.join(f'{w:.3f}' for w in walls)}); decisions {json.dumps(r['decisions'])}; "
                f"launches per call {json.dumps(per_call)}; bytes avoided "
                f"{r['bytes_avoided']:.0f}; profiled {r['profiled_wall_ms']:.3f} ms: Memcpy HtoD "
                f"{r['htod_count']} copies {r['htod_bytes']} bytes, DtoH {r['dtoh_count']} copies "
                f"{r['dtoh_bytes']} bytes, device busy {r['busy_ms']:.3f} ms "
                f"({100 * r['busy_share']:.1f}%)")
        for mode in mode_names[1:]:
            for col, v in outs["fused"].items():
                u = outs[mode][col]
                if v.dtype != u.dtype or v.shape != u.shape or v.tobytes() != u.tobytes():
                    fail(f"plan_leg {name}: column {col!r} of the {mode} run differs from the "
                         "fused run's bits")
        for col, want in expected[name].items():
            if not np.array_equal(outs["fused"][col], want):
                fail(f"plan_leg {name}: column {col!r} differs from numpy's")
        result[name] = per_mode
    fused_md = result["multijoin"]["fused"]["decisions"]
    if fused_md.get("pushdown_aggregate", 0) < 1:
        fail("plan_leg multijoin: the fused run recorded no pushdown_aggregate decision")
    if fused_md.get("reoptimized", 0) < 1:
        fail("plan_leg multijoin: a repeated fused run recorded no reoptimized decision")
    return result


# ---------------------------------------------------------------------------
# verified UDF lifting (lift_leg)
# ---------------------------------------------------------------------------

LIFT_VALUES = 1_000_000  # values of each capture's lifted-against-host check
LIFT_BLOCKS = 2
LIFT_LEG_LIMIT_S = 90.0


# The UDFs the leg captures. Module-level functions: lifting reads their
# source (inspect.getsource). The first four are the JAX package's
# tests/test_lifting.py's own.
def _arith(x):
    return {"y": (x * 2 + 1) - 3}


def _where_compare(x):
    return {"y": np.where(x > 3, x - 3, 3 - x)}


def _clip(x):
    return {"y": np.clip(x, 1, 25)}


def _chain(x):
    z = np.abs(x) + 1
    return {"y": np.maximum(z, x) * np.minimum(z, 7)}


def udf_sqrt(x):
    return {"y": np.sqrt(x)}


def udf_div3(x):
    return {"y": x / 3}


def udf_exp(x):
    return {"y": np.exp(x)}


def udf_tanh(x):
    return {"y": np.tanh(x)}


def udf_sign(x):
    return {"y": np.sign(x)}


def udf_mod(x):
    return {"y": np.mod(x, 3.0)}


def udf_demean(x):
    return {"y": x - x.mean()}


def udf_span(x):
    return {"lo": x - x.min(), "hi": x.max() - x}


def udf_mask(x):
    return {"m": np.logical_and(x > 2, x < 9)}


def udf_hypot(x, y):
    return {"h": np.sqrt(x * x + y * y), "d": np.where(x > y, x, y)}


def udf_float_mean(x):
    return {"y": x - np.mean(x)}


def udf_loop(x):
    acc = x
    for _ in range(3):
        acc = acc + x
    return {"a": acc}


def udf_random(x):
    return {"r": x + np.random.rand(*x.shape)}


def blend(u, v):
    d = np.where(u > v, u - v, v - u)
    return {"zs": d, "zm": d}


# (UDF, dtypes); then the three that must decline, with the JAX package's
# reasons
LIFT_CAPTURES = (
    (_arith, ("float32", "float64", "int32")),
    (_where_compare, ("float32", "float64", "int32")),
    (_clip, ("float32", "float64", "int32")),
    (_chain, ("float32", "float64", "int32")),
    (udf_sqrt, ("float32", "float64", "int32")),
    (udf_div3, ("float32", "float64", "int32")),
    (udf_exp, ("float32", "float64", "int32")),
    (udf_tanh, ("float32", "float64", "int32")),
    (udf_sign, ("float32", "float64", "int32")),
    (udf_mod, ("float32", "float64", "int32")),
    (udf_demean, ("int32",)),
    (udf_span, ("int32",)),
    (udf_mask, ("float32", "int32")),
    (udf_hypot, ("float32", "float64")),
)
LIFT_MUST_DECLINE = (
    (udf_float_mean, "float32", "float-reduction"),
    (udf_loop, "float32", "unsupported-syntax:For"),
    (udf_random, "float32", "unsupported-call:np.random.rand"),
)


def same_bits(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def lift_leg(tft, dev) -> dict:
    """Verified UDF lifting on the card (``numpy_udf``, ``plan/lift``):
    (a) each UDF of LIFT_CAPTURES captured on the card per dtype — the
    decision, its reason and the capture's wall (verification included),
    and each lifted capture through ``map_blocks`` equal bit for bit to
    its host stage (``udf_lifting=False``) over LIFT_VALUES seeded values;
    the LIFT_MUST_DECLINE three declining with the JAX package's reasons;
    (b) ``map_blocks`` (x, y → u, v) → ``map_blocks(numpy_udf(blend))`` →
    ``aggregate`` of ``blend``'s output's sum and max by ``k`` over
    PLAN_ROWS rows in PLAN_BLOCKS blocks, lifted (no barrier, no
    ``host_callback`` fallback) and with ``udf_lifting=False`` (one
    barrier, the fallback counted), ``segment_reduce`` launched in both,
    both modes' outputs equal bit for bit, the max equal to numpy's and
    the sums within ``float_close`` of float64 sums; per mode the median
    host wall of PLAN_REPS calls after a warm-up, launches per call and a
    profiled call's copies and busy share; (c) ``lint_plan`` on both
    chains gives TFG112 ``info`` and ``warn``, and the analysis CLI's
    ``--lift-report`` prints LIFTED and DECLINED rows; (d) the lifted
    stage's ``program_fingerprint`` moves when ``udf_lifting`` flips (a
    host stage has none). ``launches``: the kernels' launches during
    (b)."""
    import io

    import torch

    from tensorframes_tpu_torch.analysis.cli import main as analysis_main
    from tensorframes_tpu_torch.compilecache.fingerprint import program_fingerprint
    from tensorframes_tpu_torch.plan import ir as plan_ir
    from tensorframes_tpu_torch.plan import lift as plan_lift

    t_leg = time.perf_counter()
    reg = tft.observability.REGISTRY

    def host_callback_fallbacks() -> float:
        return sum(float(d["value"]) for d in reg.snapshot()
                   if d["name"] == "tftpu_plan_fallback_total"
                   and d["labels"].get("reason") == "host_callback")

    plan_lift.clear_lift_log()
    rng = np.random.default_rng(SEED)
    a_cols = {
        "float32": {"x": rng.standard_normal(LIFT_VALUES).astype(np.float32),
                    "y": rng.standard_normal(LIFT_VALUES).astype(np.float32)},
        "float64": {"x": rng.standard_normal(LIFT_VALUES),
                    "y": rng.standard_normal(LIFT_VALUES)},
        "int32": {"x": rng.integers(-2**31, 2**31, LIFT_VALUES, dtype=np.int32, endpoint=False)},
    }
    frames = {k: tft.frame_from_arrays(v, num_blocks=LIFT_BLOCKS) for k, v in a_cols.items()}

    # (a) the decisions on the card
    decisions = []
    for fn, dtypes in LIFT_CAPTURES:
        for dtn in dtypes:
            fr = frames[dtn]
            if fn.__code__.co_argcount == 1 and len(fr.schema.names) > 1:
                fr = tft.frame_from_arrays({"x": a_cols[dtn]["x"]}, num_blocks=LIFT_BLOCKS)
            udf = tft.numpy_udf(fn)
            t0 = time.perf_counter()
            tft.compile_program(udf, fr, device=dev)
            wall = time.perf_counter() - t0
            rec = plan_lift.lift_log()[-1]
            row = {"udf": fn.__name__, "dtype": dtn, "lifted": rec["lifted"],
                   "reason": rec["reason"], "detail": rec["detail"], "wall_s": wall,
                   "verify_s": rec["wall_s"]}
            if rec["lifted"]:
                outs = rec["outputs"]
                lifted = tft.map_blocks(udf, fr, device=dev)
                got = {o: lifted.column_values(o) for o in outs}
                with knobs(tft, udf_lifting=False):
                    host = tft.map_blocks(udf, fr, device=dev)
                    want = {o: host.column_values(o) for o in outs}
                for o in outs:
                    if not same_bits(got[o], want[o]):
                        fail(f"lift_leg {fn.__name__} {dtn}: lifted output {o!r} differs from "
                             f"the host stage's bits over {LIFT_VALUES} values")
                row["checked_values"] = LIFT_VALUES
            decisions.append(row)
            log(f"# lift capture {fn.__name__} {dtn}: "
                + ("LIFTED" if rec["lifted"] else f"DECLINED {rec['reason']}")
                + f", capture {wall:.4f} s (verify {rec['wall_s']:.4f} s)"
                + (f"; equal to the host stage bit for bit over {LIFT_VALUES} values"
                   if rec["lifted"] else f" — {rec['detail'][:160]}"))
    for fn, dtn, reason in LIFT_MUST_DECLINE:
        fr = tft.frame_from_arrays({"x": a_cols[dtn]["x"]}, num_blocks=LIFT_BLOCKS)
        t0 = time.perf_counter()
        tft.compile_program(tft.numpy_udf(fn), fr, device=dev)
        wall = time.perf_counter() - t0
        rec = plan_lift.lift_log()[-1]
        if rec["lifted"] or rec["reason"] != reason:
            fail(f"lift_leg {fn.__name__}: decided {rec['lifted']}/{rec['reason']!r}, "
                 f"must decline with {reason!r}")
        decisions.append({"udf": fn.__name__, "dtype": dtn, "lifted": False,
                          "reason": rec["reason"], "wall_s": wall, "verify_s": rec["wall_s"]})
        log(f"# lift capture {fn.__name__} {dtn}: DECLINED {rec['reason']} (as it must), "
            f"capture {wall:.4f} s")
    t_a = time.perf_counter() - t_leg

    # (b) the fused chain: lifted, and with udf_lifting=False
    n = PLAN_ROWS
    x = rng.standard_normal(n).astype(np.float32)
    y = rng.standard_normal(n).astype(np.float32)
    k = rng.integers(0, 4096, n).astype(np.int32)
    frame = tft.frame_from_arrays(
        {"x": x, "y": y, "n": rng.integers(-2**31, 2**31, n, dtype=np.int32),
         "k": k}, num_blocks=PLAN_BLOCKS)
    pre = tft.compile_program(lambda x, y: {"u": x * 2.0, "v": y + 1.0}, frame, device=dev)
    udf = tft.numpy_udf(blend)
    f1 = tft.map_blocks(pre, frame, device=dev)
    f2 = tft.map_blocks(udf, f1, device=dev)
    with tft.with_graph():
        agg = tft.compile_program(
            [tft.reduce_sum(tft.block(f2, "zs", tf_name="zs_input"), axis=0, name="zs"),
             tft.reduce_max(tft.block(f2, "zm", tf_name="zm_input"), axis=0, name="zm")],
            f2, reduce_mode="blocks", device=dev)

    def chain():
        g2 = tft.map_blocks(udf, tft.map_blocks(pre, frame, device=dev), device=dev)
        out = tft.aggregate(agg, g2.group_by("k"), device=dev)
        return g2, {c: out.column_values(c) for c in ("k", "zs", "zm")}

    u32 = x * np.float32(2.0)
    v32 = y + np.float32(1.0)
    d = np.where(u32 > v32, u32 - v32, v32 - u32)
    present = np.flatnonzero(np.bincount(k, minlength=4096))
    want_max = np.full(4096, -np.inf, np.float32)
    np.maximum.at(want_max, k, d)
    want_sum = np.bincount(k, weights=d.astype(np.float64), minlength=4096)
    counts = np.bincount(k, minlength=4096)[present]

    tft.kernels.LAUNCHES.reset()
    modes, outs, frames_b = {}, {}, {}
    for mode, lifting in (("lifted", True), ("host", False)):
        with knobs(tft, udf_lifting=lifting):
            g2, outs[mode] = chain()  # warm-up, and the outputs compared below
            frames_b[mode] = g2
            n_maps, barriers = plan_ir.chain_barriers(g2)
            walls, per_call = [], []
            for _ in range(PLAN_REPS):
                before = launch_counts(tft)
                fb = host_callback_fallbacks()
                t0 = time.perf_counter()
                chain()
                walls.append((time.perf_counter() - t0) * 1e3)
                after = launch_counts(tft)
                per_call.append({k2: after[k2] - before.get(k2, 0) for k2 in after
                                 if after[k2] != before.get(k2, 0)})
                fallbacks = host_callback_fallbacks() - fb
            prof = copy_profile(lambda: chain())
        r = {"wall_ms": float(np.median(walls)), "walls_ms": walls,
             "launches_per_call": per_call[-1], "barriers": len(barriers),
             "host_callback_fallbacks_per_call": fallbacks,
             **{("profiled_wall_ms" if k2 == "wall_ms" else k2): v for k2, v in prof.items()}}
        modes[mode] = r
        if r["launches_per_call"].get("segment_reduce", 0) < 1:
            fail(f"lift_leg chain ({mode}): the aggregate launched no segment_reduce")
        log(f"# lift chain {mode}: median {r['wall_ms']:.3f} ms of {PLAN_REPS} calls "
            f"({', '.join(f'{w:.3f}' for w in walls)}); barriers {len(barriers)} of {n_maps} "
            f"maps; host_callback fallbacks a call {fallbacks:.0f}; launches per call "
            f"{json.dumps(r['launches_per_call'])}; profiled {r['profiled_wall_ms']:.3f} ms: "
            f"Memcpy HtoD {r['htod_count']} copies {r['htod_bytes']} bytes, DtoH "
            f"{r['dtoh_count']} copies {r['dtoh_bytes']} bytes, device busy {r['busy_ms']:.3f} "
            f"ms ({100 * r['busy_share']:.1f}%)")
    launches = tft.kernels.LAUNCHES.snapshot()
    if modes["lifted"]["barriers"] != 0 or modes["lifted"]["host_callback_fallbacks_per_call"]:
        fail(f"lift_leg: the lifted chain kept a barrier or a host_callback fallback "
             f"({json.dumps(modes['lifted'])})")
    if modes["host"]["barriers"] != 1 or modes["host"]["host_callback_fallbacks_per_call"] < 1:
        fail("lift_leg: the host-stage chain has no barrier or no host_callback fallback")
    for col in ("k", "zs", "zm"):
        if not same_bits(outs["lifted"][col], outs["host"][col]):
            fail(f"lift_leg: column {col!r} of the lifted chain differs from the host stage's")
    got = outs["lifted"]
    if not np.array_equal(got["k"], present.astype(got["k"].dtype)):
        fail("lift_leg: the aggregate's keys differ from numpy's")
    if not same_bits(got["zm"], want_max[present]):
        fail("lift_leg: the keyed max differs from numpy's")
    sum_err = float_close(torch.from_numpy(got["zs"]), torch.from_numpy(want_sum[present]),
                          counts, float(np.abs(d).max()))
    log(f"# lift chain outputs: lifted = host stage bit for bit; max = numpy's; sums within "
        f"the float64 tolerance (max |err| {sum_err:.6g}); {len(present)} groups")

    # (c) the analyzer
    diags = {}
    for mode, g2 in frames_b.items():
        hits = tft.lint_plan(g2).by_code("TFG112")
        diags[mode] = [(h.severity, h.message) for h in hits]
    if [s for s, _ in diags["lifted"]] != ["info"] or [s for s, _ in diags["host"]] != ["warn"]:
        fail(f"lift_leg: lint_plan's TFG112 {json.dumps(diags)}")
    for mode, hits in diags.items():
        log(f"# lift TFG112 {mode}: {hits[0][0]} — {hits[0][1]}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = analysis_main(["--lift-report"])
    report = buf.getvalue().splitlines()
    lifted_rows = [r for r in report if r.strip().startswith("LIFTED")]
    declined_rows = [r for r in report if r.strip().startswith("DECLINED")]
    if rc != 0 or not lifted_rows or not declined_rows:
        fail(f"lift_leg: --lift-report rc {rc}, {len(lifted_rows)} LIFTED and "
             f"{len(declined_rows)} DECLINED rows")
    log(f"# lift report (the analysis CLI's --lift-report, rc 0): {report[0]}; "
        f"{len(lifted_rows)} LIFTED rows, {len(declined_rows)} DECLINED rows; e.g."
        f"{lifted_rows[0]} |{declined_rows[-1]}")

    # (d) the fingerprint's lift slot
    lifted_prog = tft.compile_program(udf, f1, device=dev)
    fp_on = program_fingerprint(lifted_prog)
    with knobs(tft, udf_lifting=False):
        fp_off = program_fingerprint(lifted_prog)
        host_fp = program_fingerprint(tft.compile_program(udf, f1, device=dev))
    if fp_on is None or fp_off is None or fp_on == fp_off or host_fp is not None:
        fail(f"lift_leg: fingerprints {fp_on} / {fp_off} / host stage {host_fp}")
    log(f"# lift fingerprint: lifted stage {fp_on} with udf_lifting on, {fp_off} off; the "
        "host stage has none (counted unfingerprintable at dispatch)")
    leg_s = time.perf_counter() - t_leg
    log(f"# lift leg: {leg_s:.1f} s ((a) {t_a:.1f} s)")
    if leg_s > LIFT_LEG_LIMIT_S:
        fail(f"lift_leg took {leg_s:.1f} s, past its {LIFT_LEG_LIMIT_S:.0f} s")
    return {"decisions": decisions, "modes": modes, "launches": launches,
            "sum_err": sum_err, "leg_s": leg_s}


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
        if launches["decode_attention"] != 12 * (steps["decode"] + steps["prefill"]):
            fail(f"decode_attention launched {launches['decode_attention']} times in "
                 f"{steps} (want 12 per decode step and per prefill)")
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
        "cfg": cfg, "params": params, "prompts": prompts, "outs": outs,
    }


KV_SHARED, KV_SUFFIX, KV_HITS = 112, 16, 12  # a 7-page shared prefix, 16 fresh tokens


def counted(obj, attr: str) -> list:
    """Wrap ``obj.attr`` (a callable) so each call appends to the returned
    list: the script's own count of an engine route's calls."""
    calls, fn = [], getattr(obj, attr)

    def wrapper(*a, **k):
        calls.append(1)
        return fn(*a, **k)

    setattr(obj, attr, wrapper)
    return calls


def step_launch_gates(launches: dict, steps: dict, what: str) -> None:
    """decode_attention 12 and int8_matmul 48 (all on the tensor-core
    build) per decode step and per prefill, whatever its route (cold,
    suffix or copy-on-extend: every route reads the pool through the
    kernel)."""
    want_attn = 12 * (steps["decode"] + steps["prefill"])
    want_mm = 48 * (steps["decode"] + steps["prefill"])
    if launches["decode_attention"] != want_attn:
        fail(f"{what}: decode_attention launched {launches['decode_attention']} times "
             f"(want {want_attn}: 12 x {steps})")
    if launches["int8_matmul"] != want_mm or launches["int8_matmul_mma"] != want_mm:
        fail(f"{what}: int8_matmul launched {launches['int8_matmul']} times, "
             f"{launches['int8_matmul_mma']} on the tensor cores (want {want_mm}: 48 x "
             f"{steps})")


def kv_tiers_leg(tft, dev, serving) -> dict:
    """The decode server's KV tiers at gpt_small's full width (int8 weights
    from seed 0, 16 slots, 16-position pages, prompts <= 128, 64 new
    tokens). (a) ``prefix_cache=True``: a 112-token prefix published, 12
    cold one-token requests of fresh 128-token prompts, 12 suffix hits
    (the shared 112 plus 16 fresh tokens) and one 120-token repeat that
    copy-on-extends a shared ragged page; the hits' 64 tokens equal an
    unarmed engine's exactly. (b) ``kv_swap=True`` on a pool of 1 + 2 x 12
    pages: ``serving_path``'s 32 prompts resume from swapped pages with its
    tokens; one corrupted segment falls back once, counted, with the same
    tokens; a hard-stopped engine's parked segments spill into a fresh
    engine, whose redriven requests resume from them with the same tokens.
    Launch counts are reset before and read after each engine's traffic."""
    import dataclasses
    import os

    import numpy as np
    from tensorframes_tpu_torch.blockstore import BlockStore
    from tensorframes_tpu_torch.observability import context as ctx
    from tensorframes_tpu_torch.serving import DecodeConfig, Server
    from tensorframes_tpu_torch.serving import metrics as sm

    t0 = time.perf_counter()
    cfg, params = serving["cfg"], serving["params"]
    dcfg = DecodeConfig(max_slots=16, page_size=16, max_prompt_len=128, max_new_tokens=64)
    rng = np.random.default_rng(SEED + 15)
    shared = rng.integers(0, cfg.vocab_size, KV_SHARED).astype(np.int32)
    cold_prompts = [rng.integers(0, cfg.vocab_size, 128).astype(np.int32)
                    for _ in range(KV_HITS)]
    hit_prompts = [np.concatenate([shared, rng.integers(0, cfg.vocab_size, KV_SUFFIX)]
                                  ).astype(np.int32) for _ in range(KV_HITS)]
    # the whole-prompt repeat: the shared prefix plus the first half of a
    # hit's suffix, which that hit published as a page of its own
    repeat = hit_prompts[0][:KV_SHARED + KV_SUFFIX // 2].copy()
    srv = Server(device=dev)
    eng = srv.register_decode("kv_prefix", cfg, params,
                              dataclasses.replace(dcfg, prefix_cache=True))
    srv.register_decode("kv_unarmed", cfg, params, dcfg)
    srv.start()
    setup_s = time.perf_counter() - t0
    launches, steps, out = {}, {}, {}
    try:
        suffix_calls = counted(eng, "_suffix_prefill")
        cow_calls = counted(eng, "_copy_page")
        steps0 = {p: sm.DECODE_STEPS[p].value for p in sm.DECODE_PHASES}
        h0 = sm.PREFIX_HITS.value
        tft.kernels.LAUNCHES.reset()
        t1 = time.perf_counter()
        srv.call("kv_prefix", {"prompt": shared, "max_new_tokens": 1}, timeout=600)
        cold = [srv.submit("kv_prefix", {"prompt": p, "max_new_tokens": 1})
                for p in cold_prompts]
        for f in cold:
            f.result(600)
        hits = [srv.submit("kv_prefix", {"prompt": p}) for p in hit_prompts]
        hit_out = [f.result(600)["tokens"] for f in hits]
        rep = srv.submit("kv_prefix", {"prompt": repeat})
        rep_out = rep.result(600)["tokens"]
        prefix_wall = time.perf_counter() - t1
        launches["prefix"] = launch_counts(tft)
        steps["prefix"] = {p: int(sm.DECODE_STEPS[p].value - steps0[p])
                           for p in sm.DECODE_PHASES}
        n_hits = int(sm.PREFIX_HITS.value - h0)
        if n_hits < KV_HITS + 1 or len(cow_calls) != 1 or len(suffix_calls) != KV_HITS:
            fail(f"prefix leg: {n_hits} hits counted, {len(suffix_calls)} suffix prefills, "
                 f"{len(cow_calls)} copy-on-extend (want >= 13, 12, 1)")
        step_launch_gates(launches["prefix"], steps["prefix"], "prefix leg")
        want = [srv.submit("kv_unarmed", {"prompt": p}) for p in hit_prompts + [repeat]]
        want = [f.result(600)["tokens"] for f in want]
        mismatch = [i for i, (a, b) in enumerate(zip(hit_out + [rep_out], want))
                    if not np.array_equal(a, b)]
        if mismatch:
            fail(f"prefix leg: the hits {mismatch} (12 = the copy-on-extend repeat) differ "
                 "from the unarmed engine's tokens")
        ttft = {k: float(np.percentile([f.ttft_s for f in fs], 50))
                for k, fs in (("cold", cold), ("hit", hits))}
        out["prefix"] = {"hits": n_hits, "suffix_prefills": len(suffix_calls),
                         "copy_on_extend": len(cow_calls), "ttft_p50_s": ttft,
                         "wall_s": prefix_wall, "steps": steps["prefix"],
                         "shared_pages": eng.pool.num_shared}
        eng.pool.check()
    finally:
        srv.stop(drain=False, timeout=60)

    prompts, ref = serving["prompts"], serving["outs"]
    maxp = -(-(dcfg.max_prompt_len + dcfg.max_new_tokens) // dcfg.page_size)
    root = ROOT / "build" / "kv_swap"
    swap_cfg = dataclasses.replace(dcfg, num_pages=1 + 2 * maxp, kv_swap=True)

    def swap_server(name: str):
        s = Server(device=dev)
        e = s.register_decode(name, cfg, params,
                              dataclasses.replace(swap_cfg, swap_dir=str(root / name)))
        return s.start(), e

    def drive(s, name: str, keyed: bool = False):
        futs = []
        for i, p in enumerate(prompts):
            with ctx.request_scope(f"kv-{i}" if keyed else None):
                futs.append(s.submit(name, {"prompt": p}))
        return futs

    def same_tokens(outs, what: str) -> None:
        bad = [i for i, (a, b) in enumerate(zip(outs, ref)) if not np.array_equal(a, b)]
        if bad:
            fail(f"{what}: requests {bad} differ from serving_path's tokens")

    counters = lambda: {k: v.value for k, v in (  # noqa: E731
        ("outs", sm.KVSWAP_OUTS), ("resumes", sm.KVSWAP_RESUMES),
        ("fallbacks", sm.KVSWAP_FALLBACKS), ("bytes", sm.KVSWAP_BYTES))}

    def delta(c0):
        return {k: int(v - c0[k]) for k, v in counters().items()}

    srv, eng = swap_server("kv_swap")
    try:
        steps0 = {p: sm.DECODE_STEPS[p].value for p in sm.DECODE_PHASES}
        c0 = counters()
        tft.kernels.LAUNCHES.reset()
        t2 = time.perf_counter()
        outs = [f.result(900)["tokens"] for f in drive(srv, "kv_swap")]
        swap_wall = time.perf_counter() - t2
        launches["swap"] = launch_counts(tft)
        steps["swap"] = {p: int(sm.DECODE_STEPS[p].value - steps0[p]) for p in sm.DECODE_PHASES}
        swap = delta(c0)
        if swap["resumes"] < 1 or swap["fallbacks"] != 0:
            fail(f"swap leg: {swap} (want resumes > 0, fallbacks 0)")
        same_tokens(outs, "swap leg")
        step_launch_gates(launches["swap"], steps["swap"], "swap leg")
        # one corrupted segment: the first to land gets a byte flipped
        store = eng._swap_store
        orig_put, flipped = store.put_spilled, []

        def corrupting_put(block):
            ref_ = orig_put(block)
            if not flipped:
                path = os.path.join(store._seg_dir(ref_.block_id), "c0.bin")
                with open(path, "r+b") as f:
                    b = f.read(1)
                    f.seek(0)
                    f.write(bytes([b[0] ^ 0xFF]))
                flipped.append(path)
            return ref_

        store.put_spilled = corrupting_put
        c1 = counters()
        outs = [f.result(900)["tokens"] for f in drive(srv, "kv_swap")]
        corrupt = delta(c1)
        if corrupt["fallbacks"] != 1:
            fail(f"corrupted-segment leg: {corrupt} (want exactly one fallback)")
        same_tokens(outs, "corrupted-segment leg")
    finally:
        srv.stop(drain=False, timeout=120)

    # a hard stop with swapped sequences pending parks their segments;
    # spill() hands them to a fresh engine through a BlockStore
    parked = 0
    for attempt in range(6):
        srv, eng = swap_server(f"kv_swapstop{attempt}")
        drive(srv, f"kv_swapstop{attempt}", keyed=True)
        deadline = time.time() + 120
        while time.time() < deadline and not eng._swap:
            time.sleep(0.001)
        srv.stop(drain=False, timeout=120)
        parked = len(eng._swap_parked)
        if parked:
            break
    if not parked:
        fail("restart leg: never caught a swapped sequence pending across 6 hard stops")
    handoff = BlockStore(root=str(root / "handoff"), budget_bytes=0)
    snap = eng.spill(handoff)
    srv2, eng2 = swap_server("kv_swaprestored")
    try:
        adopted = eng2.restore(handoff, snap)
        c2 = counters()
        outs = [f.result(900)["tokens"] for f in drive(srv2, "kv_swaprestored", keyed=True)]
        restart = delta(c2)
        if adopted < 1 or restart["resumes"] < 1:
            fail(f"restart leg: adopted {adopted}, {restart} (want resumes from the "
                 "restored segments)")
        same_tokens(outs, "restart leg")
    finally:
        srv2.stop(drain=True, timeout=120)
        handoff.close()
    total = {k: launches["prefix"][k] + launches["swap"][k] for k in launches["prefix"]}
    out.update({"swap": {**swap, "wall_s": swap_wall, "steps": steps["swap"]},
                "corrupt": corrupt, "restart": {**restart, "parked": parked,
                                                "adopted": adopted},
                "launches": total, "setup_s": setup_s,
                "wall_s": time.perf_counter() - t0})
    log(f"# serving kv tiers: prefix {json.dumps(out['prefix'])}; swap {json.dumps(out['swap'])}; "
        f"corrupted segment {json.dumps(corrupt)}; restart {json.dumps(out['restart'])}; "
        f"launches {json.dumps(total)}; setup {setup_s:.1f} s, leg {out['wall_s']:.1f} s")
    return out


FLUSH_REQUESTS, FLUSH_RATE = 256, 400.0  # open loop: requests at a fixed rate
FLUSH_ROWS = (1, 2, 4)
# the flush leg's HTTP half: ``python -c FLUSH_HTTP_CLIENT base rate conns
# feed.npz out.npz`` encodes every request body, opens ``conns`` keep-alive
# connections (a thread each), prints "ready" and reads t_start (wall clock)
# from its stdin. Each thread takes the next request i of the feed's ``idx``
# in order, posts it at t_start + i / rate (later when every connection is
# busy: the wait counts in its latency) and keeps the raw answer, parsed
# only after the last one. Connects stay out of the schedule: on the card's
# machine a burst of them waited out TCP's 1, 3 and 7 s retries. Saved:
# each answer's embeddings, its time after t_start (taken when its body is
# read) and how late its send was.
FLUSH_HTTP_CLIENT = r"""
import http.client, json, queue, sys, threading, time
from urllib.parse import urlsplit
import numpy as np

base, rate, conns, feed, out = sys.argv[1], float(sys.argv[2]), int(sys.argv[3]), *sys.argv[4:6]
where = urlsplit(base)
with np.load(feed) as f:
    tokens, offs, idx = f["tokens"], f["offs"], f["idx"]
bodies = [json.dumps({"inputs": {"tokens": tokens[offs[i]:offs[i + 1]].tolist()}}).encode()
          for i in idx]
raws, done, late, errors = [None] * len(idx), [0.0] * len(idx), [0.0] * len(idx), []
work = queue.Queue()
for j, i in enumerate(idx):
    work.put((j, int(i)))
go, connected, t_start = threading.Event(), threading.Semaphore(0), [0.0]


def connection():
    c = http.client.HTTPConnection(where.hostname, where.port, timeout=120)
    try:
        c.connect()
    finally:
        connected.release()
    go.wait()
    while True:
        try:
            j, i = work.get_nowait()
        except queue.Empty:
            c.close()
            return
        t_send = t_start[0] + i / rate
        pause = t_send - time.time()
        if pause > 0:
            time.sleep(pause)
        late[j] = time.time() - t_send
        try:
            c.request("POST", "/v1/bert", body=bodies[j],
                      headers={"Content-Type": "application/json"})
            r = c.getresponse()
            body = r.read()
            if r.status != 200:
                raise RuntimeError(f"status {r.status}: {body[:200]!r}")
            raws[j] = body
            done[j] = time.time() - t_start[0]
        except Exception as e:
            errors.append(f"request {i}: {type(e).__name__}: {e}")
            c.close()
            c = http.client.HTTPConnection(where.hostname, where.port, timeout=120)


threads = [threading.Thread(target=connection) for _ in range(conns)]
for th in threads:
    th.start()
for _ in threads:
    connected.acquire()
print("ready", flush=True)
t_start[0] = float(sys.stdin.readline())
go.set()
for th in threads:
    th.join(300)
if errors or any(r is None for r in raws):
    print("\n".join(errors[:5]) or "unanswered requests", file=sys.stderr)
    sys.exit(1)
embs = [np.asarray(json.loads(r)["outputs"]["embedding"], np.float32) for r in raws]
start = np.concatenate([[0], np.cumsum([len(e) for e in embs])])
np.savez(out, emb=np.concatenate(embs), start=start, done=np.asarray(done),
         late=np.asarray(late))
"""
FLUSH_HTTP_CONNECTIONS = 64  # keep-alive connections of the HTTP half


def listen_overflows():
    """The kernel's count of connections dropped at a full listen queue
    (``TcpExt ListenOverflows`` in ``/proc/net/netstat``; None where it
    cannot be read). A dropped SYN is retried by the client after 1 s,
    then 3 s, 7 s: the latency steps of an overflowing accept queue."""
    try:
        lines = Path("/proc/net/netstat").read_text().splitlines()
    except OSError:
        return None
    for head, vals in zip(lines[::2], lines[1::2]):
        if head.startswith("TcpExt:"):
            return dict(zip(head.split()[1:], map(int, vals.split()[1:]))).get(
                "ListenOverflows")
    return None


def bert_flush_server(tft, dev, cfg, params):
    """BERT-base's flush endpoint ``bert`` over int32 [128] token cells,
    as the flush and fleet legs serve it: ``ServingConfig(max_batch_rows=64,
    max_latency_s=0.002)`` on ``dev``, not started."""
    from tensorframes_tpu_torch.models import transformer as tr
    from tensorframes_tpu_torch.serving import Server, ServingConfig

    schema = tft.Schema([tft.ColumnInfo("tokens", tft.dtypes.int32,
                                        tft.Shape((tft.Unknown, ENC_SEQ)))])
    srv = Server(ServingConfig(max_batch_rows=64, max_latency_s=0.002), device=dev)
    srv.register("bert", tr.embed_row_program(cfg, params), schema)
    return srv


def flush_serving_leg(tft, dev, encoder) -> dict:
    """BERT-base (flash attention, the encoder path's weights) as a flush
    endpoint: ``Server.register("bert", embed_row_program, schema)`` over
    int32 [128] token cells, ``ServingConfig(max_batch_rows=64,
    max_latency_s=0.002)``, warmed by ``start()``; 256 requests of 1, 2 and
    4 rows in turn, sent open-loop at 400 requests/s, half through
    ``submit`` and half through ``serve_http`` on 127.0.0.1 from a child
    process over ``FLUSH_HTTP_CONNECTIONS`` keep-alive connections
    (``FLUSH_HTTP_CLIENT``), so the server's process runs no client code; each half's rows/s and latency are reported apart,
    with the server process's CPU seconds over the wall and each flush's
    wall against the worker thread's CPU time in it. Gates: every
    row within EMB_RTOL·max|embedding| of the same rows through one
    ``map_rows`` call, no new dispatch key after warm-up, 12 flash launches
    per flush (the encoder path's per dispatch), a repeated POST with one
    idempotency key run once, ``POST /admin/drain`` leading ``/healthz``
    through ``draining`` to ``stopped``."""
    import urllib.request

    import numpy as np
    from tensorframes_tpu_torch.models import transformer as tr
    from tensorframes_tpu_torch.ops.executor import _JIT_MISSES
    from tensorframes_tpu_torch.serving import serve_http
    from tensorframes_tpu_torch.serving import metrics as sm

    t0 = time.perf_counter()
    cfg, params = encoder["cfg"], encoder["params"]
    sizes = [FLUSH_ROWS[i % len(FLUSH_ROWS)] for i in range(FLUSH_REQUESTS)]
    offs = np.concatenate([[0], np.cumsum(sizes)])
    tokens, _ = tr.synthetic_batch(cfg, int(offs[-1]), ENC_SEQ, seed=SEED + 15)
    frame = tft.frame_from_arrays({"tokens": tokens}, num_blocks=1)
    ref, _ = embed_rows(tft, cfg, params, frame, dev, "map_rows")
    srv = bert_flush_server(tft, dev, cfg, params)
    srv.start()  # warms the 8/16/32/64-row ladder
    ep = srv._endpoints["bert"]
    alone_ms, alone_cpu_ms = {}, {}
    for n in (1, 64):  # one flush's dispatch alone: host wall to the result, and CPU
        walls, cpus = [], []
        for _ in range(3):
            t, c = time.perf_counter(), time.thread_time()
            ep.dispatch({"tokens": tokens[:n]}, n)
            walls.append(1e3 * (time.perf_counter() - t))
            cpus.append(1e3 * (time.thread_time() - c))
        alone_ms[n], alone_cpu_ms[n] = float(np.median(walls)), float(np.median(cpus))
    httpd = serve_http(srv, max_body_bytes=64 << 20)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    setup_s = time.perf_counter() - t0

    def post(path, body, timeout=120):
        req = urllib.request.Request(base + path, data=json.dumps(body).encode(),
                                     method="POST")
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.load(r)

    def get_state():
        with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
            return json.load(r)["state"]

    results, lat, done = [None] * FLUSH_REQUESTS, [0.0] * FLUSH_REQUESTS, [0.0] * FLUSH_REQUESTS
    http_idx = list(range(1, FLUSH_REQUESTS, 2))
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_flush_"))
    np.savez(tmp / "feed.npz", tokens=tokens, offs=offs, idx=np.asarray(http_idx))
    # the worker's flushes: host wall and the worker thread's own CPU time,
    # so a flush that waits for the interpreter lock shows as wall > CPU
    batcher = srv._batchers["bert"]
    dispatch, flush_times = batcher._dispatch, []

    def timed_dispatch(feeds, rows):
        w, c = time.perf_counter(), time.thread_time()
        try:
            return dispatch(feeds, rows)
        finally:
            flush_times.append((time.perf_counter() - w, time.thread_time() - c))

    batcher._dispatch = timed_dispatch
    client = None
    try:
        flush0 = sum(c.value for c in sm.FLUSHES.values())
        miss0 = _JIT_MISSES.value
        hist0 = {h: (h.count, h.sum) for h in (sm.DISPATCH_SECONDS, sm.QUEUE_WAIT,
                                               sm.BATCH_ROWS)}
        tft.kernels.LAUNCHES.reset()
        # the HTTP half's clients run in a child process (numpy and urllib
        # only), so the server's process holds only its handler threads and
        # the batcher's worker; both halves keep one schedule on the wall
        # clock, set once the child has loaded (its start-up takes seconds)
        t_spawn = time.time()
        client = subprocess.Popen(
            [sys.executable, "-c", FLUSH_HTTP_CLIENT, base, repr(FLUSH_RATE),
             str(FLUSH_HTTP_CONNECTIONS), str(tmp / "feed.npz"), str(tmp / "out.npz")],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if client.stdout.readline().strip() != "ready":
            fail(f"flush leg: the HTTP client did not start: {client.communicate(timeout=60)[0]}")
        t_start = time.time() + 0.2
        client_start_s = t_start - 0.2 - t_spawn
        client.stdin.write(f"{t_start!r}\n")
        client.stdin.flush()
        pending = {}

        def reap():  # each answer's time to within the 0.5 ms poll
            now = time.time() - t_start
            for i in [i for i, f in pending.items() if f.done()]:
                results[i] = pending.pop(i).result(0)["embedding"]
                done[i] = now

        while time.time() < t_start:
            time.sleep(0.001)
        cpu0, over0 = time.process_time(), listen_overflows()
        for i in range(0, FLUSH_REQUESTS, 2):
            while time.time() < t_start + i / FLUSH_RATE:
                reap()
                time.sleep(0.0005)
            pending[i] = srv.submit("bert", {"tokens": tokens[offs[i]:offs[i + 1]]})
        deadline = time.time() + 300
        while pending and time.time() < deadline:
            reap()
            time.sleep(0.0005)
        said, _ = client.communicate(timeout=300)
        cpu_s = time.process_time() - cpu0
        over1 = listen_overflows()
        fw = np.asarray(flush_times)  # the traffic's flushes alone
        if client.returncode != 0:
            fail(f"flush leg: the HTTP client exited {client.returncode}: {said[-2000:]}")
        with np.load(tmp / "out.npz") as got_http:
            emb, cut = got_http["emb"], got_http["start"]
            send_late_s = float(got_http["late"].max())
            for j, i in enumerate(http_idx):
                results[i] = emb[int(cut[j]):int(cut[j + 1])]
                done[i] = float(got_http["done"][j])
                lat[i] = done[i] - i / FLUSH_RATE
        for i in range(FLUSH_REQUESTS):
            lat[i] = done[i] - i / FLUSH_RATE
        wall = max(done)
        launches = launch_counts(tft)
        flushes = int(sum(c.value for c in sm.FLUSHES.values()) - flush0)
        misses = int(_JIT_MISSES.value - miss0)
        means = {name: (h.sum - hist0[h][1]) / max(1, h.count - hist0[h][0])
                 for name, h in (("dispatch_s", sm.DISPATCH_SECONDS),
                                 ("queue_wait_s", sm.QUEUE_WAIT),
                                 ("rows_per_flush", sm.BATCH_ROWS))}
        if any(r is None for r in results):
            fail(f"flush leg: {sum(r is None for r in results)} unanswered requests")
        got = np.concatenate(results)
        tol = EMB_RTOL * float(np.abs(ref).max())
        gap = float(np.abs(got - ref).max())
        identical = int(sum(np.array_equal(got[j], ref[j]) for j in range(len(ref))))
        if gap > tol:
            fail(f"flush leg: served embeddings off map_rows' by {gap} (tolerance {tol})")
        if misses:
            fail(f"flush leg: {misses} new dispatch keys after warm-up (want 0)")
        if (launches["flash_attention"] != cfg.num_layers * flushes
                or launches["flash_attention_mma"] != launches["flash_attention"]):
            fail(f"flush leg: flash launched {launches['flash_attention']} times "
                 f"({launches['flash_attention_mma']} on the tensor cores) in {flushes} "
                 f"flushes (want {cfg.num_layers} per flush, all on the tensor cores)")
        # a POST repeated with one idempotency key runs once
        rows0, dd0 = sm.ROWS.value, sm.IDEMPOTENT_DEDUP.value
        body = {"inputs": {"tokens": tokens[:2].tolist()}, "idempotency_key": "bert-once"}
        first, again = post("/v1/bert", body), post("/v1/bert", body)
        if (first[0], again[0]) != (200, 200) or first[1]["outputs"] != again[1]["outputs"] \
                or sm.ROWS.value - rows0 != 2 or sm.IDEMPOTENT_DEDUP.value - dd0 != 1:
            fail("flush leg: a POST repeated with one idempotency key did not run once")
        # drain over HTTP: a request in flight keeps the server draining
        pending = srv.submit("bert", {"tokens": tokens[:4]})
        code, drained = post("/admin/drain", {})
        states = [drained["state"]]
        deadline = time.time() + 60
        while states[-1] != "stopped" and time.time() < deadline:
            time.sleep(0.01)
            states.append(get_state())
        pending.result(60)
        if code != 202 or states[0] != "draining" or states[-1] != "stopped":
            fail(f"flush leg: /admin/drain answered {code}, states {states[:3]} .. "
                 f"{states[-1]} (want 202, draining, then stopped)")
    finally:
        if client is not None and client.poll() is None:
            client.kill()
            client.wait()
        shutil.rmtree(tmp, ignore_errors=True)
        httpd.shutdown()
        httpd.server_close()
        srv.stop(drain=False, timeout=60)
    rows = int(offs[-1])

    def half(idx):
        n = int(sum(sizes[i] for i in idx))
        w = max(done[i] for i in idx)
        return {"rows": n, "wall_s": w, "rows_per_s": n / w,
                "latency_s": {"p50": float(np.percentile([lat[i] for i in idx], 50)),
                              "p99": float(np.percentile([lat[i] for i in idx], 99))}}

    out = {"requests": FLUSH_REQUESTS, "rows": rows, "wall_s": wall, "rows_per_s": rows / wall,
           "latency_s": {"p50": float(np.percentile(lat, 50)),
                         "p99": float(np.percentile(lat, 99))},
           "halves": {"in_process": half(range(0, FLUSH_REQUESTS, 2)), "http": half(http_idx)},
           # the server process: its CPU seconds over the traffic's wall (1.0 =
           # one core busy throughout), and the worker's flushes' wall and CPU
           "process_cpu_share": cpu_s / wall,
           "listen_overflows": None if over0 is None or over1 is None else over1 - over0,
           "http_client_start_s": client_start_s, "http_send_late_max_s": send_late_s,
           "http_latency_s_sorted": sorted(lat[i] for i in http_idx),
           "flush_wall_ms": {"median": 1e3 * float(np.median(fw[:, 0])),
                             "sum": 1e3 * float(fw[:, 0].sum())},
           "flush_cpu_ms": {"median": 1e3 * float(np.median(fw[:, 1])),
                            "sum": 1e3 * float(fw[:, 1].sum())},
           "flushes": flushes, "means": means, "dispatch_alone_ms": alone_ms,
           "dispatch_alone_cpu_ms": alone_cpu_ms,
           "dispatch_key_misses": misses, "max_abs_gap": gap,
           "tolerance": tol, "bit_identical_rows": identical, "launches": launches,
           "setup_s": setup_s, "leg_s": time.perf_counter() - t0}
    log(f"# flush serving: {json.dumps({k: v for k, v in out.items() if k not in ('launches', 'http_latency_s_sorted')})}; "
        f"launches {json.dumps(launches)}")
    return out


FLEET_REPLICAS = 2   # replica processes on the one card (a CUDA context each)
FLEET_REQUESTS = 256  # a burst, at FLUSH_RATE; two bursts
FLEET_LEG_LIMIT_S = 120.0
FLEET_HEARTBEAT_TIMEOUT_S = 10.0  # longer than a replica's warm-up stall
# the replica processes: this script in its replica mode (a test may point
# it at a CPU stand-in)
FLEET_REPLICA_CMD = [sys.executable, str(ROOT / "chip_smoke.py"), "--fleet-replica"]


def fleet_replica(tft, dev, cfg, params) -> int:
    """One fleet replica's body: BERT-base's flush endpoint
    (:func:`bert_flush_server`) under ``serve_replica`` with the tracer
    on. The launch counts are set to 0 once ``start()`` has warmed the
    ladder; on a clean exit the replica writes them, its builds' counts,
    its flushes since then, ``kernel_builds`` and its dispatch keys to
    ``launches_p<rank>_a<attempt>.json`` in the rendezvous dir, and its
    trace shard to ``traces/`` there, under the track index ``1 + rank +
    FLEET_REPLICAS * attempt`` (the router's process is track 0), so every
    incarnation gets a track of its own. Returns the exit code."""
    import os

    from tensorframes_tpu_torch.observability import context, events
    from tensorframes_tpu_torch.ops.executor import _JIT_MISSES
    from tensorframes_tpu_torch.serving import metrics as sm
    from tensorframes_tpu_torch.serving import serve_replica

    fleet_dir = Path(os.environ["TFTPU_FLEET_DIR"])
    rank = context.process_index()
    attempt = int(os.environ.get("TFTPU_FLEET_ATTEMPT", "0"))
    events.enable()
    srv = bert_flush_server(tft, dev, cfg, params)
    warm = {}
    start = srv.start

    def start_then_count():
        start()
        tft.kernels.LAUNCHES.reset()
        warm["flushes"] = sum(c.value for c in sm.FLUSHES.values())
        warm["keys"] = int(_JIT_MISSES.value)

    srv.start = start_then_count
    rc = serve_replica(srv)
    if rc == 0:
        report = {"rank": rank, "attempt": attempt, "launches": launch_counts(tft),
                  "flushes": int(sum(c.value for c in sm.FLUSHES.values()) - warm["flushes"]),
                  "kernel_builds": int(tft.kernels.KERNEL_BUILDS.value),
                  "warmup_keys": warm["keys"], "dispatch_keys": int(_JIT_MISSES.value)}
        (fleet_dir / f"launches_p{rank}_a{attempt}.json").write_text(json.dumps(report))
        context.bind(process_index=1 + rank + FLEET_REPLICAS * attempt)
        events.save_shard(str(fleet_dir / "traces"))
    return rc


def fleet_replica_main() -> int:
    """``python3 chip_smoke.py --fleet-replica``: one replica of
    ``fleet_serving_leg``'s fleet, on the card, its stdout and stderr sent
    to ``replica_p<rank>_a<attempt>.log`` in the rendezvous dir. It builds
    the encoder's weights as ``encoder_path`` does (seed 0, drawn on the
    CPU, then moved), so every replica holds the bits the script's own
    reference uses. A library that fails to load or a kernel that fails to
    launch ends the process nonzero: the fleet counts a crash."""
    import os

    import torch

    why = refusal(torch)
    if why:
        print(f"chip_smoke: {why}", file=sys.stderr)
        return 2
    fleet_dir = os.environ.get("TFTPU_FLEET_DIR")
    if not fleet_dir:
        print("chip_smoke: --fleet-replica runs under a ServingFleet (no TFTPU_FLEET_DIR)",
              file=sys.stderr)
        return 2
    name = (f"replica_p{os.environ.get('TFTPU_PROCESS_INDEX', '0')}"
            f"_a{os.environ.get('TFTPU_FLEET_ATTEMPT', '0')}.log")
    log_fd = os.open(str(Path(fleet_dir) / name), os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
    sys.stdout.flush()
    sys.stderr.flush()
    os.dup2(log_fd, 1)
    os.dup2(log_fd, 2)
    os.close(log_fd)
    sys.path.insert(0, str(ROOT))
    import tensorframes_tpu_torch as tft
    from tensorframes_tpu_torch.models import transformer as tr

    dev = torch.device("cuda", 0)
    tft.kernels.library()
    cfg = tr.bert_base(attention_impl="flash")
    return fleet_replica(tft, dev, cfg, tr.init_params(cfg, seed=SEED, device=dev))


def fleet_log_tails(fleet_dir: Path, n: int = 1500) -> str:
    return "\n".join(f"== {p.name}\n{p.read_text(errors='replace')[-n:]}"
                     for p in sorted(fleet_dir.glob("replica_*.log")))


def fleet_serving_leg(tft, dev, encoder) -> dict:
    """BERT-base served by a fleet: ``ServingFleet`` of ``FLEET_REPLICAS``
    replica processes on the card (``FLEET_REPLICA_CMD``, each
    ``serve_replica`` over :func:`bert_flush_server`) behind the router's
    ingress. Two bursts of ``FLEET_REQUESTS`` requests of 1, 2 and 4 rows
    x 128 tokens, open loop at 400 requests/s from a child process over
    keep-alive connections (``FLUSH_HTTP_CLIENT``). A third of the way
    into the first, replica 1 is SIGKILLed; once it is back, replica 0 is
    rolled by ``POST /admin/drain`` a third of the way into the second.
    Gates: every request answered once with 200; every row within
    EMB_RTOL·max|embedding| of one in-process ``map_rows`` call; one crash
    restart, none for the drain; the restarted replica ran no kernel build
    and dispatched at its warm-up's keys alone; every replica that exited
    cleanly launched flash 12 times a flush, all on the tensor-core build
    (the survivor and the restarted replica served flushes); the
    replicas' trace shards and the router's merge into one timeline, a
    track a process, with request ids joining ingress and replica spans;
    the leg within ``FLEET_LEG_LIMIT_S``. Reports each burst's ingress
    rows/s and latency p50/p99, ``recovery_s``, the router's redrives and
    the leg's wall."""
    import signal

    import numpy as np
    import torch
    from tensorframes_tpu_torch.compilecache import serving_row_buckets
    from tensorframes_tpu_torch.models import transformer as tr
    from tensorframes_tpu_torch.observability import events, merge
    from tensorframes_tpu_torch.serving import ServingFleet
    from tensorframes_tpu_torch.serving import metrics as sm
    from tensorframes_tpu_torch.serving.replica import card_addr, read_cards
    from tensorframes_tpu_torch.serving.router import http_json

    t0 = time.perf_counter()
    cfg, params = encoder["cfg"], encoder["params"]
    sizes = [FLUSH_ROWS[i % len(FLUSH_ROWS)] for i in range(FLEET_REQUESTS)]
    offs = np.concatenate([[0], np.cumsum(sizes)])
    per_burst = int(offs[-1])
    tokens, _ = tr.synthetic_batch(cfg, 2 * per_burst, ENC_SEQ, seed=SEED + 17)
    ref, _ = embed_rows(tft, cfg, params, tft.frame_from_arrays({"tokens": tokens},
                                                                num_blocks=1), dev, "map_rows")
    tol = EMB_RTOL * float(np.abs(ref).max())
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_fleet_"))
    for b in range(2):
        np.savez(work / f"feed{b}.npz", tokens=tokens[b * per_burst:(b + 1) * per_burst],
                 offs=offs, idx=np.arange(FLEET_REQUESTS))
    fleet_dir = work / "fleet"
    torch.cuda.empty_cache()  # the earlier legs' cached blocks: the replicas share the card
    events.clear()
    events.enable()
    redrives0 = sm.ROUTER_REDRIVES.value
    fleet = ServingFleet(FLEET_REPLICA_CMD, FLEET_REPLICAS, rendezvous_dir=str(fleet_dir),
                         heartbeat_timeout_s=FLEET_HEARTBEAT_TIMEOUT_S, max_restarts=2,
                         ready_timeout_s=90.0, grace_s=30.0)
    bursts, client = [], None

    def burst(b, action):
        """One burst through the ingress; ``action`` runs a third of the
        way into its schedule."""
        nonlocal client
        out = work / f"out{b}.npz"
        client = subprocess.Popen(
            [sys.executable, "-c", FLUSH_HTTP_CLIENT, fleet.url, repr(FLUSH_RATE),
             str(FLUSH_HTTP_CONNECTIONS), str(work / f"feed{b}.npz"), str(out)],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if client.stdout.readline().strip() != "ready":
            fail(f"fleet leg: the HTTP client did not start: {client.communicate(timeout=60)[0]}")
        t_start = time.time() + 0.2
        client.stdin.write(f"{t_start!r}\n")
        client.stdin.flush()
        while time.time() < t_start + FLEET_REQUESTS / 3 / FLUSH_RATE:
            time.sleep(0.001)
        action()
        said, _ = client.communicate(timeout=300)
        if client.returncode != 0:
            fail(f"fleet leg: burst {b}: requests failed or went unanswered "
                 f"(client exit {client.returncode}): {said[-2000:]}")
        with np.load(out) as got:
            emb, done = got["emb"], got["done"]
        if emb.shape != (per_burst, cfg.hidden) or not np.isfinite(emb).all():
            fail(f"fleet leg: burst {b}: embeddings of shape {emb.shape} or not finite")
        lat = done - np.arange(FLEET_REQUESTS) / FLUSH_RATE
        gap = float(np.abs(emb - ref[b * per_burst:(b + 1) * per_burst]).max())
        bursts.append({"rows": per_burst, "wall_s": float(done.max()),
                       "rows_per_s": per_burst / float(done.max()),
                       "latency_s": {"p50": float(np.percentile(lat, 50)),
                                     "p99": float(np.percentile(lat, 99))},
                       "max_abs_gap": gap})
        if gap > tol:
            fail(f"fleet leg: burst {b}: embeddings off map_rows' by {gap} (tolerance {tol})")

    def wait_for(cond, what, timeout=90.0):
        deadline = time.monotonic() + timeout
        while not cond():
            if time.monotonic() > deadline:
                fail(f"fleet leg: {what} within {timeout:g} s; status "
                     f"{json.dumps(fleet.status(), default=str)}\n{fleet_log_tails(fleet_dir)}")
            time.sleep(0.05)

    try:
        t_fleet = time.perf_counter()
        try:
            fleet.start()
        except (TimeoutError, RuntimeError) as e:
            fail(f"fleet leg: the fleet did not start: {e}\n{fleet_log_tails(fleet_dir)}")
        start_s = time.perf_counter() - t_fleet
        killed = []
        burst(0, lambda: killed.append(fleet.kill_replica(1, signal.SIGKILL)))
        if killed[0] is None:
            fail("fleet leg: replica 1 was not running when the kill came")
        wait_for(lambda: 1 in fleet.restart_reports, "replica 1 did not come back")
        wait_for(lambda: fleet.router.live_count() == FLEET_REPLICAS, "the fleet did not recover")
        restarts_after_kill = fleet.restarts
        card = read_cards(str(fleet_dir), fleet.run_id)[0]
        drained = []
        burst(1, lambda: drained.append(http_json(card_addr(card), "POST", "/admin/drain",
                                                  {}, 10.0)[0]))
        wait_for(lambda: fleet.restart_reports.get(0, {}).get("attempt") == 1,
                 "replica 0 was not respawned after its drain")
        restarts_after_drain = fleet.restarts
        router = fleet.router.counters()
        reports = dict(fleet.restart_reports)
    finally:
        if client is not None and client.poll() is None:
            client.kill()
            client.wait()
        fleet.stop(drain=True)
    redrives = sm.ROUTER_REDRIVES.value - redrives0
    events.save_shard(str(fleet_dir / "traces"))
    events.disable()
    trace_events = 0
    try:
        if drained != [202]:
            fail(f"fleet leg: POST /admin/drain answered {drained} (want 202)")
        if (restarts_after_kill, restarts_after_drain) != (1, 1):
            fail(f"fleet leg: restarts {restarts_after_kill} after the kill and "
                 f"{restarts_after_drain} after the drain (want 1 and 1)")
        if router["requests"] != 2 * FLEET_REQUESTS or any(router["rejected"].values()):
            fail(f"fleet leg: the router counted {router} (want {2 * FLEET_REQUESTS} "
                 "requests, none refused)")
        back = reports[1]
        if back.get("kernel_builds") != 0 or back.get("xla_compiles") != len(
                serving_row_buckets(64)):
            fail(f"fleet leg: the restarted replica reported {back} (want kernel_builds 0 "
                 "and its warm-up's 4 dispatch keys)")
        files = {p.stem: json.loads(p.read_text())
                 for p in sorted(fleet_dir.glob("launches_p*_a*.json"))}
        want = {f"launches_p{r}_a{a}" for r, a in ((0, 0), (1, 1), (0, 1))}
        if set(files) != want:
            fail(f"fleet leg: launch files {sorted(files)} (want {sorted(want)}: every "
                 f"replica that exited cleanly)\n{fleet_log_tails(fleet_dir)}")
        for name, r in files.items():
            n = r["launches"]
            if (n["flash_attention"] != cfg.num_layers * r["flushes"]
                    or n["flash_attention_mma"] != n["flash_attention"]
                    or r["kernel_builds"] != 0 or r["dispatch_keys"] != r["warmup_keys"]):
                fail(f"fleet leg: {name}: {r} (want {cfg.num_layers} flash launches a flush, "
                     "all on the tensor cores, no kernel build, no new dispatch key)")
        if not (files["launches_p0_a0"]["flushes"] > 0 and files["launches_p1_a1"]["flushes"] > 0):
            fail(f"fleet leg: the survivor or the restarted replica served no flush: {files}")
        shards = merge.find_shards(str(fleet_dir / "traces"))
        merged = merge.merge_traces(shards)
        trace_events = len(merged["traceEvents"])
        tracks = {p["process_index"] for p in merged["otherData"]["processes"]}
        want_tracks = {0} | {1 + r["rank"] + FLEET_REPLICAS * r["attempt"]
                             for r in files.values()}
        ingress = {e["args"]["request_id"] for e in merged["traceEvents"]
                   if e.get("name") == "router.request" and e["pid"] == 0}
        served = {e["args"].get("request_id"): e["pid"] for e in merged["traceEvents"]
                  if e.get("name") == "serving.request"}
        joined = sum(1 for rid in ingress if served.get(rid, 0) != 0)
        if (tracks != want_tracks or len(shards) != len(want_tracks)
                or len(ingress) != 2 * FLEET_REQUESTS or joined < FLEET_REQUESTS):
            fail(f"fleet leg: the merged timeline holds tracks {sorted(tracks)} from "
                 f"{len(shards)} shards (want {sorted(want_tracks)}), {len(ingress)} ingress "
                 f"spans, {joined} joined to a replica's request span (want at least "
                 f"{FLEET_REQUESTS})")
        launches = {k: sum(r["launches"][k] for r in files.values())
                    for k in ("flash_attention", "flash_attention_mma")}
    finally:
        events.clear()
        shutil.rmtree(work, ignore_errors=True)
    leg_s = time.perf_counter() - t0
    if leg_s > FLEET_LEG_LIMIT_S:
        fail(f"fleet leg: took {leg_s:.1f} s (limit {FLEET_LEG_LIMIT_S:g} s)")
    out = {"replicas": FLEET_REPLICAS, "requests": 2 * FLEET_REQUESTS, "bursts": bursts,
           "recovery_s": reports[1]["recovery_s"], "drain_recovery_s": reports[0]["recovery_s"],
           "restart_report": reports[1], "redrives": int(redrives),
           "router": router, "replica_reports": files, "launches": launches,
           "merged_trace": {"tracks": sorted(tracks), "events": trace_events,
                            "joined_request_ids": joined},
           "start_s": start_s, "leg_s": leg_s}
    log(f"# fleet serving: {json.dumps({k: v for k, v in out.items() if k != 'replica_reports'})}")
    return out


EMB_RTOL = 2e-2  # of max |embedding|: ~3x the flash-vs-dense gap of a sound run (PERF.md)
ENC_ROWS, ENC_SEQ = 1024, 128  # BASELINE config 5, as the reference's bench


INFRA_ROWS = 64  # BERT-base rows a warmed process serves: serving_row_buckets(64) = 8..64
INFRA_AGG_ROWS, INFRA_AGG_GROUPS = 1_000_000, 512
INFRA_LEG_LIMIT_S = 120.0
INFRA_STALE_LIB = "libtftorch_kernels-0000000000000000.so"


def infra_warm(tft, dev, cfg, params, mode: str, cache: Path) -> dict:
    """One process of ``infra_leg``'s warm-up pair, on the card, the
    persistent store at ``cache`` (``TFTPU_COMPILE_CACHE``): ``cold`` warms
    BERT-base's ``map_rows`` program at every bucket of
    ``serving_row_buckets(INFRA_ROWS)``, ``restart`` replays the store's
    manifest (``warmup(manifest=True)``); then one real ``map_rows`` call of
    ``INFRA_ROWS`` rows, its embeddings saved to ``emb_<mode>.npy`` in
    ``cache``. Counts reset before the warm-up; the report names its
    statuses, launches, dispatch keys and builds."""
    import numpy as np
    import torch
    from tensorframes_tpu_torch.compilecache import serving_row_buckets
    from tensorframes_tpu_torch.models import transformer as tr
    from tensorframes_tpu_torch.ops.executor import _JIT_MISSES

    tokens, _ = tr.synthetic_batch(cfg, INFRA_ROWS, ENC_SEQ, seed=SEED)
    frame = tft.frame_from_arrays({"tokens": tokens}, num_blocks=1)
    prog = tft.compile_program(tr.embed_row_program(cfg, params), frame, block=False,
                               device=dev)
    tft.kernels.LAUNCHES.reset()
    keys0 = int(_JIT_MISSES.value)
    t0 = time.perf_counter()
    if mode == "cold":
        report = tft.warmup(frame, prog, rows=serving_row_buckets(INFRA_ROWS), block=False,
                            device=dev)
    else:
        report = tft.warmup(None, prog, block=False, manifest=True, device=dev)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    warm_launches = launch_counts(tft)
    keys1 = int(_JIT_MISSES.value)
    t1 = time.perf_counter()
    emb = tft.map_rows(prog, frame, device=dev).column_values("embedding")
    dispatch_s = time.perf_counter() - t1
    np.save(cache / f"emb_{mode}.npy", emb)
    return {"mode": mode, "counts": report.counts(), "compiled": report.compiled,
            "disk_hits": report.disk_hits, "rows": [e["rows"] for e in report.entries],
            "warm_s": warm_s, "warm_launches": warm_launches,
            "launches": launch_counts(tft), "warm_keys": keys1 - keys0,
            "dispatch_new_keys": int(_JIT_MISSES.value) - keys1, "dispatch_s": dispatch_s,
            "kernel_builds": int(tft.kernels.KERNEL_BUILDS.value),
            "entries": tft.compilecache.active_store().stats()["entries"],
            "finite": bool(np.isfinite(emb).all()), "shape": list(emb.shape)}


def infra_warm_main() -> int:
    """``python3 chip_smoke.py --infra-warm MODE``: one process of
    ``infra_leg``'s pair (``TFTPU_COMPILE_CACHE`` names the store). BERT-base's
    weights are drawn from the seed as in ``encoder_path``, so both processes
    hold the same bits. Prints the report as its last line."""
    import os

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    why = refusal(torch)
    if why:
        print(f"chip_smoke: {why}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import tensorframes_tpu_torch as tft
    from tensorframes_tpu_torch.models import transformer as tr

    dev = torch.device("cuda", 0)
    tft.kernels.library()
    cfg = tr.bert_base(attention_impl="flash")
    params = tr.init_params(cfg, seed=SEED, device=dev)
    cache = Path(tft.get_config().compilation_cache_dir)
    print(json.dumps(infra_warm(tft, dev, cfg, params, sys.argv[2], cache)))
    return 0


def infra_child(args, env=None, timeout: float = 240):
    """Run a child process from the repo root; (rc, stdout, stderr, s)."""
    import os

    t0 = time.perf_counter()
    out = subprocess.run(args, cwd=ROOT, env=dict(os.environ, **(env or {})),
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                         timeout=timeout)
    return out.returncode, out.stdout, out.stderr, time.perf_counter() - t0


def infra_cli(cache: Path, *args) -> tuple:
    """``compilecache``'s CLI in this process (the same ``main`` that
    ``python -m tensorframes_tpu_torch.compilecache`` runs): (rc, its JSON
    output, s)."""
    import contextlib
    import io

    from tensorframes_tpu_torch.compilecache.cli import main as cc_main

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cc_main(["--store", str(cache), *args])
    return rc, json.loads(buf.getvalue().strip().splitlines()[-1]), time.perf_counter() - t0


def infra_leg(tft, dev, encoder) -> dict:
    """The static analyzer and the compile cache on the card, counts reset
    first: (a) a process with a fresh store warms BERT-base's ``map_rows``
    program at every bucket of ``serving_row_buckets(64)`` (12 flash
    launches a bucket, all on the tensor cores; one store entry a key; the
    first real dispatch at a warmed bucket adds no key); (b) a second
    process on the same store replays its manifest (``disk`` for every
    bucket, no kernel build) and gives the same embeddings bit for bit;
    (c) the ``compilecache`` CLI's stats, verify and prune (the first
    verify as ``python -m tensorframes_tpu_torch.compilecache`` in a child
    process while (d)-(f) run, the rest through the same ``main`` here): a
    planted corrupt entry reported and quarantined, a planted stale kernel
    library pruned (the libraries' half points ``kernels.BUILD_DIR`` at a
    directory under the leg's own, so nothing the checkout built is
    touched); (d) a strict ``aggregate`` whose program
    keeps a feed under its own name raises ``StaticAnalysisError`` before
    any launch, and a clean strict one equals the non-strict bit for bit
    through ``segment_reduce``; (e) ``analyze_frame`` on BERT-base's
    ``map_rows`` program, TFG106 against the card's memory and against a
    planted 1 MiB budget, no launch and no dispatch key; (f) ``lint_plan``
    finds TFG107, TFG109 and TFG110 on chains built to show them."""
    import numpy as np
    import torch
    from tensorframes_tpu_torch.compilecache import serving_row_buckets
    from tensorframes_tpu_torch.models import transformer as tr
    from tensorframes_tpu_torch.ops.executor import _JIT_MISSES

    t_leg = time.perf_counter()
    cfg, params = encoder["cfg"], encoder["params"]
    buckets = serving_row_buckets(INFRA_ROWS)
    work = Path(tempfile.mkdtemp(prefix="infra_leg.", dir=str(ROOT / "build")))
    out = {"buckets": buckets}
    verify_child = real_build_dir = None
    try:
        # (a) cold, (b) restart: two processes on one store
        procs = {}
        for mode in ("cold", "restart"):
            rc, stdout, stderr, s = infra_child(
                [sys.executable, str(ROOT / "chip_smoke.py"), "--infra-warm", mode],
                env={"TFTPU_COMPILE_CACHE": str(work)})
            if rc != 0:
                fail(f"infra {mode} process: rc {rc}\n{stdout[-3000:]}\n{stderr[-3000:]}")
            procs[mode] = dict(json.loads(stdout.strip().splitlines()[-1]), process_s=s)
            log(f"# infra {mode}: {json.dumps(procs[mode])}")
        cold, restart = procs["cold"], procs["restart"]
        nb, nl = len(buckets), cfg.num_layers
        if cold["compiled"] != nb or cold["counts"] != {"compiled": nb}:
            fail(f"infra cold warm-up: {cold['counts']} (want compiled = {nb} buckets)")
        if (cold["warm_launches"]["flash_attention"], cold["warm_launches"]["flash_attention_mma"]) \
                != (nl * nb, nl * nb):
            fail(f"infra cold warm-up launched {cold['warm_launches']} (want {nl} flash launches a "
                 f"bucket, {nl * nb} in all, all on the tensor cores)")
        if cold["entries"] != nb or cold["warm_keys"] != 0:
            fail(f"infra cold: {cold['entries']} store entries, {cold['warm_keys']} counted keys "
                 f"(want {nb} entries, one a key, and no counted dispatch key)")
        for p in (cold, restart):
            if p["dispatch_new_keys"] != 0 or not p["finite"] or \
                    p["shape"] != [INFRA_ROWS, cfg.hidden]:
                fail(f"infra {p['mode']}: the first map_rows added {p['dispatch_new_keys']} keys "
                     f"(want 0), embeddings {p['shape']} finite={p['finite']}")
        if restart["disk_hits"] != nb or restart["counts"] != {"disk": nb} \
                or restart["kernel_builds"] != 0:
            fail(f"infra restart: {restart['counts']}, kernel_builds {restart['kernel_builds']} "
                 f"(want disk = {nb}, no build)")
        if restart["warm_launches"]["flash_attention_mma"] != nl * nb:
            fail(f"infra restart warm-up launched {restart['warm_launches']}")
        a, b = np.load(work / "emb_cold.npy"), np.load(work / "emb_restart.npy")
        if a.tobytes() != b.tobytes():
            fail(f"infra restart: embeddings differ from the cold process's "
                 f"(max |diff| {float(np.abs(a - b).max())})")
        out.update(cold=cold, restart=restart)

        # (c) the CLI on that store: a corrupt entry, a stale library. The
        # first verify runs as `python -m` in a child process, beside (d)-(f)
        rc, stats, s_stats = infra_cli(work, "stats", "--json")
        if rc != 0 or stats["entries"] != nb or stats["libraries"]["current"] is None:
            fail(f"compilecache stats: rc {rc}, {stats}")
        entry = sorted((work / "aot").glob("*.xc"))[0]
        bad = work / "aot" / ("f" * 40 + ".xc")
        blob = bytearray(entry.read_bytes())
        blob[-1] ^= 0xFF
        bad.write_bytes(bytes(blob))
        t_child = time.perf_counter()
        verify_child = subprocess.Popen(
            [sys.executable, "-m", "tensorframes_tpu_torch.compilecache", "--store", str(work),
             "verify", "--json"], cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)

        # (d) strict aggregate
        rng = np.random.default_rng(SEED)
        n = INFRA_AGG_ROWS
        agg_frame = tft.frame_from_arrays({
            "k": rng.integers(0, INFRA_AGG_GROUPS, n).astype(np.int32),
            "v": rng.standard_normal(n, dtype=np.float32),
            "c": rng.integers(-1000, 1000, n).astype(np.int32),
            "x": np.zeros(n, np.float32), "x_input": rng.standard_normal(n, dtype=np.float32),
            "x_input_input": rng.standard_normal(n, dtype=np.float32),
        }, num_blocks=2)
        tft.kernels.LAUNCHES.reset()
        keys0 = int(_JIT_MISSES.value)
        raise_s = []
        for _ in range(2):  # the first lint of the process, then a warm one
            t0 = time.perf_counter()
            try:
                tft.aggregate(lambda x_input, x_input_input: {"x": x_input.sum(0),
                                                              "x_input": x_input_input.sum(0)},
                              agg_frame.group_by("k"), strict=True, device=dev)
            except tft.StaticAnalysisError as e:
                codes = [d.code for d in e.diagnostics]
            else:
                fail("strict aggregate over a program keeping a feed under its name did not "
                     "raise")
            raise_s.append(time.perf_counter() - t0)
        if codes != ["TFG104"] or launch_counts(tft)["segment_reduce"] != 0 or \
                int(_JIT_MISSES.value) != keys0:
            fail(f"strict aggregate raised {codes} after {launch_counts(tft)} launches, "
                 f"{int(_JIT_MISSES.value) - keys0} keys (want TFG104 before any)")

        def clean(strict):
            with tft.with_graph():
                blk = lambda col: tft.block(agg_frame, col, tf_name=f"{col}_input")  # noqa: E731
                return tft.aggregate([tft.reduce_sum(blk("v"), name="v"),
                                      tft.reduce_max(blk("c"), name="c")],
                                     agg_frame.group_by("k"), strict=strict, device=dev)

        tft.kernels.LAUNCHES.reset()
        strict_out = clean(True)
        strict_launches = launch_counts(tft)
        plain_out = clean(False)
        if strict_launches["segment_reduce"] < 1:
            fail(f"clean strict aggregate launched {strict_launches} (want segment_reduce)")
        for col in ("k", "v", "c"):
            if strict_out.column_values(col).tobytes() != plain_out.column_values(col).tobytes():
                fail(f"clean strict aggregate column {col} differs from the non-strict one")
        out["strict"] = {"raise_s": raise_s, "codes": codes,
                         "launches": strict_launches}

        # (e) analyze_frame on BERT-base's map_rows program
        program_fn = tr.embed_row_program(cfg, params)
        tft.kernels.LAUNCHES.reset()
        keys0 = int(_JIT_MISSES.value)
        t0 = time.perf_counter()
        report = tft.analyze_frame(encoder["frame"], program_fn, block=False, device=dev)
        lint_s = time.perf_counter() - t0
        budget = int(torch.cuda.mem_get_info(dev)[1])
        t0 = time.perf_counter()
        planted = tft.analyze_frame(encoder["frame"], program_fn, block=False, device=dev,
                                    hbm_budget_bytes=1 << 20)
        planted_s = time.perf_counter() - t0
        tfg106 = planted.by_code("TFG106")
        if report.by_code("TFG106") or not tfg106:
            fail(f"TFG106: {report.pretty()} at the card's {budget} bytes; "
                 f"{planted.pretty()} at 1 MiB")
        if sum(launch_counts(tft).values()) != 0 or int(_JIT_MISSES.value) != keys0:
            fail(f"analyze_frame launched {launch_counts(tft)}, added "
                 f"{int(_JIT_MISSES.value) - keys0} dispatch keys (want none)")
        out["lint"] = {"seconds": lint_s, "planted_seconds": planted_s, "budget_bytes": budget,
                       "codes": [(d.code, d.severity, d.subject) for d in report],
                       "tfg106": tfg106[0].message if tfg106 else None}
        log(f"# infra analyze_frame BERT-base map_rows: {lint_s:.3f} s "
            f"(planted budget {planted_s:.3f} s); card budget {budget} bytes; "
            f"{report.pretty()}; planted: {out['lint']['tfg106']}")

        # (f) lint_plan on chains built to show TFG107, TFG109 and TFG110
        fr = tft.frame_from_arrays({"x": np.arange(4096, dtype=np.float32),
                                    "k": (np.arange(4096) % 8).astype(np.int32),
                                    "k2": (np.arange(4096) % 6).astype(np.int32)},
                                   num_blocks=2)
        f1 = tft.map_blocks(lambda x: {"y": x + 1.0}, fr, device=dev)
        barrier = tft.map_blocks(lambda y: {"z": y * 2.0}, f1.repartition(3), device=dev)
        f2 = tft.map_blocks(lambda x: {"y": x * 2.0}, fr, device=dev)
        nonalg = tft.aggregate(
            lambda y_input: {"y": y_input.max(dim=0).values - y_input.min(dim=0).values},
            f2.group_by("k"), device=dev)
        dim = tft.frame_from_arrays({"k2": np.arange(6, dtype=np.int32),
                                     "w": np.arange(6, dtype=np.int64) * 10}, num_blocks=1)
        j = tft.map_blocks(lambda x: {"z": x * x}, fr, device=dev).join(dim, on="k2")
        with tft.with_graph():
            pushed = tft.aggregate(
                tft.reduce_sum(tft.block(j, "z", tf_name="z_input"), axis=0, name="z"),
                j.group_by("k2"), device=dev)
        plan_codes = {name: sorted({d.code for d in tft.lint_plan(f)})
                      for name, f in (("barrier", barrier), ("nonalgebraic", nonalg),
                                      ("float_over_join", pushed))}
        if plan_codes != {"barrier": ["TFG107"], "nonalgebraic": ["TFG109"],
                          "float_over_join": ["TFG110"]}:
            fail(f"lint_plan: {plan_codes}")
        out["plan_codes"] = plan_codes

        child_out, child_err = verify_child.communicate(timeout=240)
        s_v1 = time.perf_counter() - t_child
        rc1 = verify_child.returncode
        try:
            v1 = json.loads(child_out.strip().splitlines()[-1])
        except (ValueError, IndexError):
            fail(f"python -m ...compilecache verify: rc {rc1}, no JSON\n{child_err[-3000:]}")
        # the libraries' half on a build directory of the leg's own: the
        # current library linked there beside a planted stale one
        lib_dir = work / "torch_kernels"
        lib_dir.mkdir()
        (lib_dir / tft.kernels.library_path().name).symlink_to(tft.kernels.library_path())
        stale = lib_dir / INFRA_STALE_LIB
        stale.write_bytes(b"built from other sources")
        real_build_dir, tft.kernels.BUILD_DIR = tft.kernels.BUILD_DIR, lib_dir
        rc2, v2, s_v2 = infra_cli(work, "verify", "--json", "--delete-bad")
        rc3, v3, s_v3 = infra_cli(work, "verify", "--json")
        rc4, pruned, s_prune = infra_cli(work, "prune")
        if (rc1, rc2, rc3, rc4) != (1, 1, 0, 0):
            fail(f"compilecache exit codes verify/--delete-bad/verify/prune = "
                 f"{(rc1, rc2, rc3, rc4)} (want 1, 1, 0, 0)")
        if [x["entry"] for x in v1["bad"]] != [bad.name] or v2["deleted"] != 1 or bad.exists():
            fail(f"compilecache verify did not report and quarantine the planted entry: {v1}, {v2}")
        if INFRA_STALE_LIB not in [x["file"] for x in v2["libraries"]["stale"]]:
            fail(f"compilecache verify missed the stale library: {v2['libraries']}")
        if pruned["libraries_removed"] != [INFRA_STALE_LIB] or stale.exists() or \
                not tft.kernels.library_path().exists() or pruned["entries"] != nb:
            fail(f"compilecache prune: {pruned}")
        out["cli_s"] = {"stats": s_stats, "python_m_verify": s_v1, "verify_delete_bad": s_v2,
                        "verify_clean": s_v3, "prune": s_prune}
        log(f"# infra cli: stats {stats['entries']} entries, {stats['bytes']} bytes; verify "
            f"{v1['bad']}; prune {pruned}; walls {json.dumps(out['cli_s'])}")
    finally:
        if real_build_dir is not None:
            tft.kernels.BUILD_DIR = real_build_dir
        if verify_child is not None and verify_child.poll() is None:
            verify_child.kill()
            verify_child.wait()
        shutil.rmtree(work, ignore_errors=True)
    out["launches"] = {k: out["cold"]["launches"][k] + out["restart"]["launches"][k]
                       + out["strict"]["launches"][k] for k in out["cold"]["launches"]}
    out["leg_s"] = time.perf_counter() - t_leg
    if out["leg_s"] > INFRA_LEG_LIMIT_S:
        fail(f"infra leg: took {out['leg_s']:.1f} s (limit {INFRA_LEG_LIMIT_S:g} s)")
    log(f"# infra leg: {json.dumps({k: v for k, v in out.items() if k not in ('cold', 'restart')})}")
    return out


SHARDED_ROWS, SHARDED_GROUPS = 10_000_000, 4096  # the main path's aggregate feed
SHARDED_RANKS = 2            # gloo ranks sharing cuda:0 (NCCL refuses two ranks on one card)
SHARDED_REL_ROWS = 1_000_000  # each rank's slice for the relational ops and the string keys
SHARDED_STR_KEYS = 64
SHARDED_RIGHT = 4096         # the join's right side: one row a key
SHARDED_RAGGED = 100_000     # each rank's ragged rows (RAGGED_ROWS in all)
SHARDED_LEG_LIMIT_S = 120.0
SHARDED_RANK_CMD = [sys.executable, str(ROOT / "chip_smoke.py"), "--sharded-rank"]


def free_port() -> int:
    import socket

    sock = socket.socket()
    sock.bind(("localhost", 0))
    port = sock.getsockname()[1]
    sock.close()
    return port


def sharded_columns(dev, lo: int, hi: int) -> dict:
    """Rows ``[lo, hi)`` of the main path's 10M-row aggregate feed
    (``segment_inputs``, drawn on the card from the seed): int32 ids over
    4,096 groups, f32 ``v`` (summed) and its copy ``u`` (averaged), f32
    ``[n, 8]`` ``w`` (its map ``w2`` maxed), int32 ``c`` (summed) and its
    copy ``c_min`` (minimized)."""
    ids, v, w, c = segment_inputs(SHARDED_ROWS, SHARDED_GROUPS, dev)
    return {"ids": ids[lo:hi], "v": v[lo:hi], "u": v[lo:hi].clone(), "w": w[lo:hi],
            "c": c[lo:hi], "c_min": c[lo:hi].clone()}


def sharded_fetches(tft, frame) -> list:
    """sum, mean, max (of the mapped ``w2``), sum and min: one aggregate."""
    with tft.with_graph():
        b = lambda col: tft.block(frame, col, tf_name=f"{col}_input")  # noqa: E731
        return [tft.reduce_sum(b("v"), name="v"), tft.reduce_mean(b("u"), name="u"),
                tft.reduce_max(b("w2"), name="w2"), tft.reduce_sum(b("c"), name="c"),
                tft.reduce_min(b("c_min"), name="c_min")]


def sharded_reduce(tft, frame):
    with tft.with_graph():
        return frame.reduce_blocks([
            tft.reduce_sum(tft.block(frame, "v", tf_name="v_input"), name="v"),
            tft.reduce_min(tft.block(frame, "c", tf_name="c_input"), name="c")])


def sharded_rel_columns(cols: dict) -> dict:
    """A rank's relational slice: its first SHARDED_REL_ROWS rows, with a
    string key of SHARDED_STR_KEYS values (``ids % 64``)."""
    ids = cols["ids"][:SHARDED_REL_ROWS]
    names = [f"grp{j:02d}" for j in range(SHARDED_STR_KEYS)]
    return {"k": ids, "x": cols["v"][:SHARDED_REL_ROWS], "c": cols["c"][:SHARDED_REL_ROWS],
            "s": [names[i] for i in (ids.cpu().numpy() % SHARDED_STR_KEYS)]}


def sharded_right(lo: int, hi: int) -> dict:
    import numpy as np

    rv = np.random.default_rng(SEED).integers(0, 1000, SHARDED_RIGHT).astype(np.int32)
    return {"k": np.arange(SHARDED_RIGHT, dtype=np.int32)[lo:hi], "rv": rv[lo:hi]}


def sharded_lse(x_input, c_input):
    """The generic (UDAF) fetch: log-sum-exp and an int32 sum."""
    import torch

    return {"x": torch.logsumexp(x_input, 0), "c": c_input.sum(0, dtype=torch.int32)}


def sharded_generic(tft, frame):
    return frame.select(["k", "x", "c"]).group_by("k").aggregate(sharded_lse)


def sharded_strings(tft, frame):
    with tft.with_graph():
        return frame.group_by("s").aggregate([
            tft.reduce_sum(tft.block(frame, "c", tf_name="c_input"), name="c"),
            tft.reduce_sum(tft.block(frame, "x", tf_name="x_input"), name="x")])


def check_dense(got, want, ids, v, what: str) -> float:
    """A sharded 10M-row aggregate against the unsharded port's: keys,
    max, int sum and min exact; the float sum and mean within float_close
    of float64 sums."""
    import numpy as np
    import torch

    for col in ("ids", "w2", "c", "c_min"):
        a, b = np.asarray(got[col]), np.asarray(want[col])
        if a.dtype != b.dtype or not np.array_equal(a, b):
            fail(f"{what}: {col} differs from the unsharded port's")
    keys = torch.from_numpy(np.asarray(got["ids"]).astype(np.int64)).to(v.device)
    counts = torch.bincount(ids.long(), minlength=SHARDED_GROUPS)[keys]
    sums = f64_sums(v, ids, SHARDED_GROUPS)[keys][:, 0]
    vmax = float(v.abs().max())
    err = float_close(torch.as_tensor(np.asarray(got["v"])).to(v.device), sums, counts, vmax)
    return max(err, float_close(torch.as_tensor(np.asarray(got["u"])).to(v.device),
                                sums / counts.double(), counts, vmax, mean=True))


def table(frame) -> dict:
    """A host frame's columns (this rank's rows)."""
    import numpy as np

    out = {}
    for n in frame.schema.names:
        v = frame.column_values(n)
        out[n] = list(v) if v.dtype == object else np.asarray(v)
    return out


def sharded_rank(tft, dev, rank: int, world: int, port: int, work: Path) -> dict:
    """One gloo rank of ``sharded_leg``'s pair on the card: its half of the
    10M rows through ``frame_from_process_local``, the dense-span
    aggregate after a map, ``reduce_blocks``, and on its 1M-row relational
    slice the string-key (dictionary plan) and generic aggregates (the
    latter's partials merged through the file shuffle), ``repartition_by_key``,
    an exchange join, an over-budget ``sort_values``, ``drop_duplicates``,
    a ``map_rows`` over process-local ragged cells, the sharded save and
    load, and ``to_host``. Returns its results, walls and launches."""
    import os

    import numpy as np
    from tensorframes_tpu_torch import io as tio
    from tensorframes_tpu_torch.blockstore import shuffle
    from tensorframes_tpu_torch.blockstore.store import HOSTGATHER_BYTES
    from tensorframes_tpu_torch.ops import exchange
    from tensorframes_tpu_torch.parallel import frame_from_process_local, init_distributed

    init_distributed(f"localhost:{port}", world, rank, backend="gloo", device=dev)
    walls, launches, out = {}, {}, {}

    def timed(name, fn):
        tft.kernels.LAUNCHES.reset()
        t0 = time.perf_counter()
        res = fn()
        walls[name] = time.perf_counter() - t0
        launches[name] = launch_counts(tft)
        return res

    lo, hi = rank * SHARDED_ROWS // world, (rank + 1) * SHARDED_ROWS // world
    cols = sharded_columns(dev, lo, hi)
    fr = timed("frame_from_process_local", lambda: frame_from_process_local(cols))
    mapped = timed("map_blocks", lambda: fr.map_blocks(lambda w: {"w2": w * 2.0}).cache())
    fetch = sharded_fetches(tft, mapped)
    out["dense"] = timed("dense_aggregate",
                         lambda: table(mapped.group_by("ids").aggregate(fetch)))
    # the same call again: the first pays the process's first program
    # capture and plan decisions
    timed("dense_aggregate_again", lambda: mapped.group_by("ids").aggregate(fetch))
    out["reduce_blocks"] = timed("reduce_blocks", lambda: sharded_reduce(tft, fr))
    rel = frame_from_process_local(sharded_rel_columns(cols))
    out["strings"] = timed("string_aggregate", lambda: table(sharded_strings(tft, rel)))
    os.environ["TFTPU_SHUFFLE_DIR"] = str(work / "shuffle")
    shuffle._reset_for_tests()
    out["generic"] = timed("generic_aggregate", lambda: table(sharded_generic(tft, rel)))
    del os.environ["TFTPU_SHUFFLE_DIR"]
    shuffle._reset_for_tests()
    out["repartition"] = timed("repartition_by_key",
                               lambda: table(rel.select(["k", "c"]).repartition_by_key("k")))
    right = frame_from_process_local(sharded_right(rank * SHARDED_RIGHT // world,
                                                   (rank + 1) * SHARDED_RIGHT // world))
    budget = tft.get_config().relational_broadcast_bytes
    tft.configure(relational_broadcast_bytes=0)  # over budget: the exchange plans
    try:
        out["join"] = timed("join", lambda: table(rel.select(["k", "c"]).join(right, on="k")))
        out["sort"] = timed("sort_values",
                            lambda: table(rel.select(["k", "c"]).sort_values(["k", "c"])))
    finally:
        tft.configure(relational_broadcast_bytes=budget)
    out["dedup"] = timed("drop_duplicates",
                         lambda: table(rel.select(["k", "s"]).drop_duplicates()))
    lens, starts, flat = ragged_cells(RAGGED_ROWS)
    r0, r1 = rank * SHARDED_RAGGED, (rank + 1) * SHARDED_RAGGED
    cells = [flat[starts[i]:starts[i] + lens[i]] for i in range(r0, r1)]
    rag = frame_from_process_local({"i": np.arange(r0, r1, dtype=np.int32), "r": cells})
    out["ragged"] = timed("map_rows_ragged", lambda: rag.map_rows(
        lambda r: {"rs": r.sum() * 2.0}).to_host().column_values("rs"))
    path = str(work / "saved")

    def save_load():
        tio.save_frame_sharded(rel.select(["k", "x", "c"]), path)
        return tio.load_frame_sharded(path)

    back = timed("save_load", save_load)
    mine = table(rel.select(["k", "x", "c"]).to_host())
    loaded = table(back.to_host())
    out["save_load_equal"] = all(np.array_equal(mine[n], loaded[n]) for n in ("k", "x", "c"))
    out["to_host_rows"] = len(mine["k"])
    out["num_rows"] = fr.num_rows
    out["counters"] = {
        "all_to_all_wire_bytes": exchange.EXCHANGE_WIRE_BYTES.value,
        "all_to_all_payload_bytes": exchange.EXCHANGE_PAYLOAD_BYTES.value,
        "shuffle_bytes": shuffle.SHUFFLE_BYTES.value,
        "hostgather_bytes": HOSTGATHER_BYTES.value,
    }
    return {"rank": rank, "walls": walls, "launches": launches, "out": out}


def sharded_rank_main() -> int:
    """``python3 chip_smoke.py --sharded-rank RANK WORLD PORT WORKDIR``: one
    rank of ``sharded_leg``'s pair; pickles its report to WORKDIR."""
    import pickle

    import torch

    why = refusal(torch)
    if why:
        print(f"chip_smoke: {why}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import tensorframes_tpu_torch as tft

    rank, world, port, work = (int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
                               Path(sys.argv[5]))
    dev = torch.device("cuda", 0)
    tft.kernels.library()
    report = sharded_rank(tft, dev, rank, world, port, work)
    with open(work / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(report, f)
    from tensorframes_tpu_torch.parallel.distributed import shutdown_distributed

    shutdown_distributed()
    return 0


def sharded_world_of_one(tft, dev) -> dict:
    """A world of one under NCCL on cuda:0: the 10M rows through
    ``to_device()``, a ``map_blocks``, the keyed aggregate (sum, mean, max,
    sum, min) and ``reduce_blocks``, against the unsharded port on the
    card; ``segment_reduce`` launched once for the aggregate; the device's
    idle share of one aggregate call (``timeline_profile``)."""
    import numpy as np
    from tensorframes_tpu_torch.parallel import distributed, init_distributed

    init_distributed(f"localhost:{free_port()}", 1, 0, backend="nccl", device=dev)
    try:
        if distributed.backend() != "nccl":
            fail("sharded leg: the world of one is not on NCCL")
        cols = sharded_columns(dev, 0, SHARDED_ROWS)
        host = tft.frame_from_arrays({k: v.cpu().numpy() for k, v in cols.items()})
        t0 = time.perf_counter()
        sh = host.to_device()
        to_device_s = time.perf_counter() - t0
        mapped = sh.map_blocks(lambda w: {"w2": w * 2.0}).cache()
        fetch = sharded_fetches(tft, mapped)
        mapped.group_by("ids").aggregate(fetch)  # warm-up
        tft.kernels.LAUNCHES.reset()
        t0 = time.perf_counter()
        got = table(mapped.group_by("ids").aggregate(fetch))
        wall = time.perf_counter() - t0
        launches = launch_counts(tft)
        if launches["segment_reduce"] != 1:
            fail(f"sharded leg: the world of one's aggregate launched segment_reduce "
                 f"{launches['segment_reduce']} times (want 1)")
        red = sharded_reduce(tft, sh)
        plain_mapped = host.map_blocks(lambda w: {"w2": w * 2.0}, device=dev)
        want = table(tft.aggregate(sharded_fetches(tft, plain_mapped),
                                   plain_mapped.group_by("ids"), device=dev))
        want_red = sharded_reduce(tft, host)
        err = check_dense(got, want, cols["ids"], cols["v"], "world of one")
        if int(red[1]) != int(want_red[1]) or not np.isclose(
                float(red[0]), float(want_red[0]), rtol=1e-5):
            fail(f"sharded leg: reduce_blocks {red} against the unsharded {want_red}")
        prof = timeline_profile(lambda: mapped.group_by("ids").aggregate(fetch))
        return {"wall_s": wall, "to_device_s": to_device_s, "launches": launches,
                "max_abs_err": err, "want": want, "busy_share": prof["busy_share"],
                "profile_wall_ms": prof["wall_ms"], "reduce_blocks": [float(red[0]), int(red[1])]}
    finally:
        distributed.shutdown_distributed()


def sharded_leg(tft, dev) -> dict:
    """The data-parallel frame on the card, within SHARDED_LEG_LIMIT_S.

    1. A world of one under NCCL (:func:`sharded_world_of_one`).
    2. Two ranks sharing cuda:0 over gloo (:func:`sharded_rank`, child
       processes through SHARDED_RANK_CMD; NCCL refuses two ranks on one
       device, "Duplicate GPU detected"). The union of the ranks' results
       must equal the single-process port on the card: the dense aggregate
       (ints exact, floats within float_close of float64 sums), the string
       and generic aggregates, the join, the sort (ranks in order), the
       dedup and the ragged map; each rank's rows after
       ``repartition_by_key`` must be the ones ``partition_by_hash`` sends
       it, in (source rank, local order); ``segment_reduce`` at least once
       a rank for each device-plan aggregate, ``ragged_gather`` at least
       once a rank. A failed child fails the leg."""
    import os
    import pickle
    import tempfile

    import numpy as np
    import torch
    from tensorframes_tpu_torch.ops.exchange import partition_by_hash

    t_leg = time.perf_counter()
    one = sharded_world_of_one(tft, dev)
    log(f"# sharded world of one (NCCL, cuda:0): to_device {one['to_device_s']:.3f} s, aggregate "
        f"{one['wall_s'] * 1e3:.3f} ms host wall, segment_reduce launches "
        f"{one['launches']['segment_reduce']}, float error {one['max_abs_err']:.3g}; one "
        f"profiled aggregate {one['profile_wall_ms']:.3f} ms, device busy "
        f"{one['busy_share']:.4f}, idle {1 - one['busy_share']:.4f}")
    work = Path(tempfile.mkdtemp(prefix="sharded_", dir=str(ROOT / "build")))
    port = free_port()
    t0 = time.perf_counter()
    procs = [subprocess.Popen(SHARDED_RANK_CMD + [str(r), str(SHARDED_RANKS), str(port), str(work)],
                              cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, env=dict(os.environ, TFTPU_RUN_ID="sharded"))
             for r in range(SHARDED_RANKS)]
    logs = []
    try:
        for p in procs:
            left = max(1.0, SHARDED_LEG_LIMIT_S - (time.perf_counter() - t_leg))
            logs.append(p.communicate(timeout=left)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode != 0 for p in procs):
        fail("sharded leg: a rank failed: " + " | ".join(
            f"rank {r} rc {p.returncode}: {logs[r][-2000:] if r < len(logs) else ''}"
            for r, p in enumerate(procs)))
    ranks_s = time.perf_counter() - t0
    reports = []
    for r in range(SHARDED_RANKS):
        with open(work / f"rank{r}.pkl", "rb") as f:
            reports.append(pickle.load(f))

    # the single-process port on the card, on the same whole data
    whole = sharded_columns(dev, 0, SHARDED_ROWS)
    err = 0.0
    for rep in reports:
        if rep["out"]["num_rows"] != SHARDED_ROWS:
            fail(f"sharded leg: rank {rep['rank']} counts {rep['out']['num_rows']} rows")
        err = max(err, check_dense(rep["out"]["dense"], one["want"], whole["ids"],
                                   whole["v"], f"rank {rep['rank']} dense aggregate"))
        red = rep["out"]["reduce_blocks"]
        if int(red[1]) != one["reduce_blocks"][1] or not np.isclose(
                float(red[0]), one["reduce_blocks"][0], rtol=1e-5):
            fail(f"sharded leg: rank {rep['rank']} reduce_blocks {red}")
    halves = [sharded_columns(dev, r * SHARDED_ROWS // SHARDED_RANKS,
                              (r + 1) * SHARDED_ROWS // SHARDED_RANKS)
              for r in range(SHARDED_RANKS)]
    rels = [sharded_rel_columns(h) for h in halves]
    rel = {"k": np.concatenate([r["k"].cpu().numpy() for r in rels]),
           "x": np.concatenate([r["x"].cpu().numpy() for r in rels]),
           "c": np.concatenate([r["c"].cpu().numpy() for r in rels]),
           "s": sum((r["s"] for r in rels), [])}
    frame = tft.frame_from_arrays(rel, num_blocks=1)
    want_s = table(sharded_strings(tft, frame))
    want_g = table(sharded_generic(tft, frame))
    right = tft.frame_from_arrays(sharded_right(0, SHARDED_RIGHT))
    want_j = table(frame.select(["k", "c"]).join(right, on="k"))
    want_sort = table(frame.select(["k", "c"]).sort_values(["k", "c"]))
    want_dd = table(frame.select(["k", "s"]).drop_duplicates())
    lens, starts, flat = ragged_cells(RAGGED_ROWS)
    cells = [flat[starts[i]:starts[i] + lens[i]] for i in range(RAGGED_ROWS)]
    want_rag = tft.frame_from_arrays({"r": cells}).map_rows(
        lambda r: {"rs": r.sum() * 2.0}, device=dev).column_values("rs")

    def rows(tab, names):
        return sorted(zip(*(np.asarray(tab[n], dtype=object).tolist() for n in names)))

    def union(key, names):
        return {n: (sum((list(rep["out"][key][n]) for rep in reports), [])
                    if isinstance(reports[0]["out"][key][n], list)
                    else np.concatenate([np.asarray(rep["out"][key][n]) for rep in reports]))
                for n in names}

    for rep in reports:
        got = rep["out"]["strings"]
        if list(got["s"]) != list(want_s["s"]) or not np.array_equal(got["c"], want_s["c"]):
            fail(f"sharded leg: rank {rep['rank']} string aggregate keys or int sums")
        if not np.allclose(got["x"], want_s["x"], rtol=1e-5, atol=1e-3):
            fail(f"sharded leg: rank {rep['rank']} string aggregate float sums")
        got = rep["out"]["generic"]
        tol = LSE_RTOL * float(np.abs(want_g["x"]).max())
        if (not np.array_equal(got["k"], want_g["k"]) or not np.array_equal(got["c"], want_g["c"])
                or float(np.abs(got["x"] - want_g["x"]).max()) > tol):
            fail(f"sharded leg: rank {rep['rank']} generic aggregate")
        if not rep["out"]["save_load_equal"]:
            fail(f"sharded leg: rank {rep['rank']} save_frame_sharded/load_frame_sharded")
    if rows(union("join", ("k", "c", "rv")), ("k", "c", "rv")) != rows(want_j, ("k", "c", "rv")):
        fail("sharded leg: the exchange join's union differs from the single-process join")
    srt = union("sort", ("k", "c"))
    if not all(np.array_equal(srt[n], want_sort[n]) for n in ("k", "c")):
        fail("sharded leg: the range-exchange sort in rank order differs from the global sort")
    if rows(union("dedup", ("k", "s")), ("k", "s")) != rows(want_dd, ("k", "s")):
        fail("sharded leg: drop_duplicates' union differs")
    got_rag = np.concatenate([np.asarray(rep["out"]["ragged"]) for rep in reports])
    if not np.allclose(got_rag, want_rag, rtol=1e-6, atol=1e-6):
        fail("sharded leg: the ragged map_rows' union differs")
    parts = [partition_by_hash([r["k"].cpu().numpy()], SHARDED_RANKS) for r in rels]
    for me, rep in enumerate(reports):
        idx = [np.flatnonzero(parts[r] == me) for r in range(SHARDED_RANKS)]
        want_k = np.concatenate([rels[r]["k"].cpu().numpy()[i] for r, i in enumerate(idx)])
        want_c = np.concatenate([rels[r]["c"].cpu().numpy()[i] for r, i in enumerate(idx)])
        got = rep["out"]["repartition"]
        if not (np.array_equal(got["k"], want_k) and np.array_equal(got["c"], want_c)):
            fail(f"sharded leg: rank {me}'s rows after repartition_by_key")
    if sum(rep["out"]["to_host_rows"] for rep in reports) != 2 * SHARDED_REL_ROWS:
        fail("sharded leg: to_host's rows")
    for rep in reports:
        ln = rep["launches"]
        for agg in ("dense_aggregate", "string_aggregate"):
            if ln[agg]["segment_reduce"] < 1:
                fail(f"sharded leg: rank {rep['rank']}'s {agg} never launched segment_reduce")
        if ln["map_rows_ragged"]["ragged_gather"] < 1:
            fail(f"sharded leg: rank {rep['rank']}'s ragged map_rows never launched ragged_gather")
        log(f"# sharded rank {rep['rank']} walls (s): " + json.dumps(
            {k: round(v, 4) for k, v in rep["walls"].items()}))
        log(f"# sharded rank {rep['rank']} launches: " + json.dumps(
            {k: {n: v[n] for n in ("segment_reduce", "segment_sum", "ragged_gather")}
             for k, v in ln.items()}))
        log(f"# sharded rank {rep['rank']} counters: {json.dumps(rep['out']['counters'])}")
    leg_s = time.perf_counter() - t_leg
    log(f"# sharded leg: ranks {ranks_s:.1f} s (start-up included), dense float error "
        f"{err:.3g}, leg {leg_s:.1f} s")
    if leg_s > SHARDED_LEG_LIMIT_S:
        fail(f"sharded leg: took {leg_s:.1f} s (limit {SHARDED_LEG_LIMIT_S:g} s)")
    total = {}
    for counts in [one["launches"]] + [v for rep in reports for v in rep["launches"].values()]:
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    return {"launches": total, "leg_s": leg_s, "world_of_one": one, "ranks": reports}


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


# The model-parallel leg: gpt_small's sharded train step at a world of one
# under NCCL, then four gloo ranks sharing cuda:0 (NCCL refuses two ranks
# on one card) through the tp/sp modes, expert parallelism and the pp
# pipeline, each held against the single-process computation.
MP_RANKS = 4
MP_LEG_LIMIT_S = 150.0
MP_RANK_CMD = [sys.executable, str(ROOT / "chip_smoke.py"), "--mp-rank"]
MP_MODES = (  # name, mesh, attention_impl, mixed_precision, the single-process reference
    ("ring_mixed", {"tp": 2, "sp": 2}, "ring", True, "dense_mixed"),
    ("ulysses", {"tp": 2, "sp": 2}, "ulysses", False, "dense"),
    ("flash_tp_sp", {"tp": 2, "sp": 2}, "flash", False, "flash"),
    ("flash_dp_tp", {"dp": 2, "tp": 2}, "flash", False, "flash"),
)
MP_MOE = {"hidden": 768, "mlp_hidden": 3072, "num_experts": 8, "capacity_factor": 1.25}
MP_MOE_TOKENS = 8192   # a rank's tokens
MP_MOE_RTOL = 1e-5     # of max |moe_ffn|: f32 products, each expert's rows in another batch
MP_PP_MICRO = 8
# one step's loss and each gradient leaf (of its max) against the
# single-process step of the same impl family: ~3x the worst gap of a sound
# run (1.34e-4 and 0.0191 of a leaf's max, PERF.md)
MP_LOSS_ATOL = 4e-4
MP_GRAD_RTOL = 6e-2


def mp_setup(tr, dev):
    """gpt_small's config, seed-0 weights (on ``dev``) and seed-0 batch."""
    from tensorframes_tpu_torch.models import generation as gen

    cfg = gen.gpt_small(attention_impl="flash")
    tokens, targets = tr.synthetic_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=SEED)
    return cfg, tr.init_params(cfg, seed=SEED, device=dev), tokens, targets


def mp_stage_tree(tr, cfg, params, stages: int):
    """The layers' leaves stacked ``[stages, layers a stage, ...]``: one
    stage of the pipeline is a run of consecutive layers."""
    import torch

    per = cfg.num_layers // stages
    first = params["layers"][0]

    def stack(path):
        leaves = []
        for layer in params["layers"]:
            for k in path:
                layer = layer[k]
            leaves.append(layer)
        t = torch.stack(leaves)
        return t.reshape(stages, per, *t.shape[1:])

    return {a: {b: stack((a, b)) for b in first[a]} for a in first}


def mp_stage_fn(tr, cfg):
    def stage(p, h):
        for j in range(next(iter(p["attn"].values())).shape[0]):
            h = tr.layer_forward(cfg, {a: {b: v[j] for b, v in d.items()} for a, d in p.items()},
                                 h)
        return h

    return stage


def mp_loss_head(tr, params):
    """The LM head on a pipeline's output: the final norm, the f32 logits
    against the tied embedding, the mean cross entropy (the weights held
    fixed)."""
    import torch
    import torch.nn.functional as F

    ln = {k: v.detach() for k, v in params["final_ln"].items()}
    tok = params["embed"]["tok"].detach()

    def head(out, targets):
        hs = tr._layer_norm(out, **ln)
        logp = F.log_softmax(hs.float() @ tok.T, dim=-1)
        return -torch.gather(logp, -1, targets.long()[..., None]).mean()

    return head


def mp_embed(cfg, params, tokens, dev):
    import torch

    with torch.no_grad():
        t = torch.from_numpy(tokens).to(dev).long()
        x = params["embed"]["tok"][t].to(cfg.dtype)
        return x + params["embed"]["pos"][: t.shape[1]].to(cfg.dtype)


def mp_references(tft, dev, work: Path) -> dict:
    """The single-process computations the ranks are held against, saved
    under ``work`` on the host: one step's loss and every leaf's gradient
    with dense attention (f32 layers and, as ``mixed_precision=True``
    casts them, bf16 layers), and the 12 layers in order (flash) on the
    embedded batch: the output and one LM-head step's layer gradients."""
    import torch
    from tensorframes_tpu_torch.models import transformer as tr
    from tensorframes_tpu_torch.training import cast_float_leaves

    cfg, params, tokens, targets = mp_setup(tr, dev)
    tb, gb = torch.from_numpy(tokens).to(dev), torch.from_numpy(targets).to(dev)
    leaves = tr.tree_leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    walls = {}
    for name, mixed in (("dense", False), ("dense_mixed", True)):
        t0 = time.perf_counter()
        dcfg = dataclasses.replace(cfg, attention_impl="dense")
        p = params
        if mixed:
            p = {**params, "layers": cast_float_leaves(params["layers"], cfg.dtype),
                 "final_ln": cast_float_leaves(params["final_ln"], cfg.dtype)}
        loss = tr.loss_fn(dcfg, p, tb, gb)
        grads = torch.autograd.grad(loss, leaves)
        torch.save({"loss": float(loss.detach()), "grads": [g.cpu() for g in grads]},
                   work / f"ref_{name}.pt")
        del loss, grads
        walls[name] = time.perf_counter() - t0
    t0 = time.perf_counter()
    stages = mp_stage_tree(tr, cfg, params, MP_RANKS)
    stage_leaves = tr.tree_leaves(stages)
    stage = mp_stage_fn(tr, cfg)
    flat = {a: {b: v.reshape(cfg.num_layers, *v.shape[2:]) for b, v in d.items()}
            for a, d in stages.items()}
    h = mp_embed(cfg, params, tokens, dev)
    for i in range(cfg.num_layers):
        h = stage({a: {b: v[i:i + 1] for b, v in d.items()} for a, d in flat.items()}, h)
    loss = mp_loss_head(tr, params)(h, gb)
    grads = torch.autograd.grad(loss, stage_leaves)
    torch.save({"loss": float(loss.detach()), "out": h.detach().cpu(), "grads": [g.cpu() for g in grads]},
               work / "ref_pp.pt")
    walls["pp"] = time.perf_counter() - t0
    del params, leaves, stages, stage_leaves, flat, h, loss, grads
    torch.cuda.empty_cache()
    return walls


def mp_world_of_one(tft, dev, work: Path) -> dict:
    """A world of one under NCCL, mesh ``{"dp": 1}``: two steps of
    ``make_sharded_train_step`` (flash, AdamW) against two of
    ``make_train_step`` on the same weights and batch, bit for bit:
    losses, every gradient and every updated leaf. The plain step's first
    loss and gradients are the flash modes' reference (``ref_flash.pt``).
    Launch counts are read around the sharded steps alone."""
    import functools

    import torch
    from tensorframes_tpu_torch.models import transformer as tr
    from tensorframes_tpu_torch.parallel import distributed, init_distributed, make_mesh

    init_distributed(f"localhost:{free_port()}", 1, 0, backend="nccl", device=dev)
    try:
        if distributed.backend() != "nccl":
            fail("model-parallel leg: the world of one is not on NCCL")
        cfg, plain, tokens, targets = mp_setup(tr, dev)
        opt = tr.adamw(plain, TRAIN_LR)
        plain_step = tr.make_train_step(cfg, opt)
        mesh = make_mesh({"dp": 1})
        step, _, _, init_opt = tr.make_sharded_train_step(
            cfg, mesh, functools.partial(tr.adamw, learning_rate=TRAIN_LR))
        local = tr.shard_params(cfg, tr.init_params(cfg, seed=SEED, device=dev), mesh)
        sopt = init_opt(local)
        tb, gb = tr.shard_batch(mesh, tokens, targets)
        pb, pg = torch.from_numpy(tokens).to(dev), torch.from_numpy(targets).to(dev)
        launches = {k: 0 for k in TRAINING_BUILDS}
        step_ms = []
        for i in range(2):
            _, _, want = plain_step(plain, opt.state, pb, pg)
            if i == 0:
                torch.save({"loss": float(want),
                            "grads": [leaf.grad.cpu() for leaf in tr.tree_leaves(plain)]},
                           work / "ref_flash.pt")
            torch.cuda.synchronize()
            tft.kernels.LAUNCHES.reset()
            t0 = time.perf_counter()
            _, _, got = step(local, sopt, tb, gb)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            counts = launch_counts(tft)
            for k in launches:
                launches[k] += counts[k]
            if not torch.equal(got, want):
                fail(f"model-parallel leg: world of one step {i + 1} loss {float(got)!r} "
                     f"against make_train_step's {float(want)!r}")
            for (path, a), b in zip(mp_paths(local), tr.tree_leaves(plain)):
                if not torch.equal(a.grad, b.grad):
                    fail(f"model-parallel leg: world of one step {i + 1} gradient {path}")
                if not torch.equal(a, b):
                    fail(f"model-parallel leg: world of one step {i + 1} updated leaf {path}")
        want_launches = {k: 2 * cfg.num_layers for k in TRAINING_BUILDS}
        if launches != want_launches:
            fail(f"model-parallel leg: the world of one's two sharded steps launched "
                 f"{launches} (want {want_launches}: every flash kernel 12 times a step on "
                 "the tensor cores)")
        return {"step_ms": step_ms, "launches": launches, "losses": [float(want)],
                "peak_bytes": torch.cuda.max_memory_allocated(dev)}
    finally:
        distributed.shutdown_distributed()
        torch.cuda.empty_cache()


def mp_paths(tr, tree):
    out = []
    from tensorframes_tpu_torch.ops.quantize import _tree_map

    _tree_map(lambda path, leaf: out.append((".".join(map(str, path)), leaf)), tree)
    return out


def mp_grad_gaps(tr, cfg, local, ref_grads, ref_max, mesh) -> list:
    """Per leaf ``(path, d, r)``: this rank's max |grad - reference| over its
    shard and the whole reference leaf's max |grad| (the parent takes the
    worst rank of each leaf)."""
    import torch

    ref_local = tr.shard_params(cfg, mp_unflatten(local, ref_grads), mesh)
    out = [(path, float((leaf.grad.float() - r.float()).abs().max()), m)
           for (path, leaf), (_, r), m in zip(mp_paths(local), mp_paths(ref_local), ref_max)]
    del ref_local
    torch.cuda.empty_cache()
    return out


def mp_paths(tree):
    from tensorframes_tpu_torch.ops.quantize import _tree_map

    out = []
    _tree_map(lambda path, leaf: out.append((".".join(map(str, path)), leaf)), tree)
    return out


def mp_unflatten(like, leaves):
    from tensorframes_tpu_torch.ops.quantize import _tree_map

    it = iter(leaves)
    return _tree_map(lambda _, __: next(it), like)


def mp_moe_tokens(dev, n: int):
    """``n`` ranks' tokens ``[n · MP_MOE_TOKENS, hidden]``, N(0, 1) from the
    seed."""
    import torch

    g = torch.Generator().manual_seed(SEED)
    return torch.randn((n * MP_MOE_TOKENS, MP_MOE["hidden"]), generator=g).to(dev)


def mp_rank(tft, dev, rank: int, world: int, port: int, work: Path) -> dict:
    """One gloo rank of the model-parallel leg on cuda:0: each of MP_MODES
    for two AdamW steps (the first's loss and gradients against the
    single-process reference the parent saved, its launches and the bytes
    each collective kind sent), then ``moe_ffn_ep`` on ``{"ep": 4}``
    (MP_MOE, MP_MOE_TOKENS a rank: its output and whether every token
    kept a slot), then the pipeline on ``{"pp": 4}``: three layers a
    stage, MP_PP_MICRO microbatches, its output against the 12 layers in
    order and one SGD step's gradients against theirs."""
    import functools

    import torch
    from tensorframes_tpu_torch.models import moe
    from tensorframes_tpu_torch.models import transformer as tr
    from tensorframes_tpu_torch.parallel import (collectives, init_distributed, make_mesh,
                                                 make_pp_train_step, pipeline_apply)
    from tensorframes_tpu_torch.parallel.mesh import PartitionSpec as P, shard_tensor
    from tensorframes_tpu_torch.parallel.pipeline import shard_stage_params

    init_distributed(f"localhost:{port}", world, rank, backend="gloo", device=dev)
    cfg, full, tokens, targets = mp_setup(tr, dev)
    t0 = time.perf_counter()
    while not (work / "refs.ready").exists():  # the parent's world of one and references
        if time.perf_counter() - t0 > MP_LEG_LIMIT_S:
            fail("model-parallel rank: the references never came")
        time.sleep(0.1)
    report = {"rank": rank, "wait_s": time.perf_counter() - t0, "modes": {}}
    refs = {}

    def sent(before):
        after = collectives.collective_bytes()
        return {k: after[k] - before[k] for k in after}

    for name, axes, impl, mixed, ref in MP_MODES:
        if ref not in refs:
            r = torch.load(work / f"ref_{ref}.pt")
            refs[ref] = (r, [float(g.abs().max()) for g in r["grads"]])
        (r, ref_max) = refs[ref]
        mcfg = dataclasses.replace(cfg, attention_impl=impl)
        mesh = make_mesh(axes)
        step, _, _, init_opt = tr.make_sharded_train_step(
            mcfg, mesh, functools.partial(tr.adamw, learning_rate=TRAIN_LR),
            mixed_precision=mixed)
        local = tr.shard_params(mcfg, full, mesh)
        opt = init_opt(local)
        tb, gb = tr.shard_batch(mesh, tokens, targets)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        before = collectives.collective_bytes()
        tft.kernels.LAUNCHES.reset()
        out = {"losses": [], "step_ms": []}
        for i in range(2):
            t1 = time.perf_counter()
            _, _, loss = step(local, opt, tb, gb)
            torch.cuda.synchronize()
            out["step_ms"].append((time.perf_counter() - t1) * 1e3)
            out["losses"].append(float(loss))
            if i == 0:
                out["launches"] = launch_counts(tft)
                out["bytes"] = sent(before)
                out["gaps"] = mp_grad_gaps(tr, mcfg, local, r["grads"], ref_max, mesh)
        out["launches_total"] = launch_counts(tft)
        out["ref_loss"] = r["loss"]
        out["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        out["local_qkv"] = tuple(local["layers"][0]["attn"]["qkv"].shape)
        report["modes"][name] = out
        del step, local, opt, init_opt
        torch.cuda.empty_cache()
    del refs

    # (c) experts over 'ep'
    mcfg = moe.MoEConfig(**MP_MOE)
    mesh = make_mesh({"ep": world})
    local = moe.shard_moe_params(moe.init_moe_params(mcfg, seed=SEED, device=dev), mesh)
    x = shard_tensor(mp_moe_tokens(dev, world), P("ep", None), mesh)
    torch.cuda.reset_peak_memory_stats(dev)
    with torch.no_grad():
        dispatch = moe._route(mcfg, local["router"], x, mcfg.capacity(x.shape[0]))[0]
        kept = int(dispatch.sum())
        del dispatch
        moe.moe_ffn_ep(mcfg, local, x, mesh)  # warm-up
        torch.cuda.synchronize()
        before = collectives.collective_bytes()
        t1 = time.perf_counter()
        y = moe.moe_ffn_ep(mcfg, local, x, mesh)
        torch.cuda.synchronize()
        report["ep"] = {"ms": (time.perf_counter() - t1) * 1e3, "kept": kept,
                        "tokens": int(x.shape[0]), "bytes": sent(before), "y": y.cpu(),
                        "peak_bytes": torch.cuda.max_memory_allocated(dev)}
    del local, x, y
    torch.cuda.empty_cache()

    # (d) the pipeline over 'pp': three layers a stage
    ref = torch.load(work / "ref_pp.pt")
    mesh = make_mesh({"pp": world})
    stage = mesh.axis_index("pp")
    local = shard_stage_params(mp_stage_tree(tr, cfg, full, world), mesh)
    x0 = mp_embed(cfg, full, tokens, dev)
    gb = torch.from_numpy(targets).to(dev)
    stage_fn = mp_stage_fn(tr, cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    tft.kernels.LAUNCHES.reset()
    with torch.no_grad():
        got = pipeline_apply(stage_fn, local, x0, mesh, num_microbatches=MP_PP_MICRO)
    fwd_launches = launch_counts(tft)
    want = ref["out"].to(dev)
    out_gap = float((got.float() - want.float()).abs().max())
    out_max = float(want.float().abs().max())
    del got, want
    jit_for = make_pp_train_step(stage_fn, mp_loss_head(tr, full), mesh,
                                 lambda p: torch.optim.SGD(tr.tree_leaves(p), lr=TRAIN_LR),
                                 num_microbatches=MP_PP_MICRO)
    step, init_opt, _ = jit_for(local)
    opt = init_opt(local)
    before = collectives.collective_bytes()
    tft.kernels.LAUNCHES.reset()
    t1 = time.perf_counter()
    _, _, loss = step(local, opt, x0, gb)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t1) * 1e3
    gaps = [(path, float((leaf.grad[0].float() - g[stage].to(dev).float()).abs().max()),
             float(g.abs().max()))
            for (path, leaf), g in zip(mp_paths(local), ref["grads"])]
    report["pp"] = {"out_gap": out_gap, "out_max": out_max, "loss": float(loss),
                    "ref_loss": ref["loss"], "ms": ms, "fwd_launches": fwd_launches,
                    "launches": launch_counts(tft), "bytes": sent(before), "gaps": gaps,
                    "peak_bytes": torch.cuda.max_memory_allocated(dev)}
    return report


def mp_rank_main() -> int:
    """``python3 chip_smoke.py --mp-rank RANK WORLD PORT WORKDIR``: one rank
    of the model-parallel leg; pickles its report to WORKDIR."""
    import pickle

    import torch

    why = refusal(torch)
    if why:
        print(f"chip_smoke: {why}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import tensorframes_tpu_torch as tft

    rank, world, port, work = (int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
                               Path(sys.argv[5]))
    dev = torch.device("cuda", 0)
    tft.kernels.library()
    report = mp_rank(tft, dev, rank, world, port, work)
    with open(work / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(report, f)
    from tensorframes_tpu_torch.parallel.distributed import shutdown_distributed

    shutdown_distributed()
    return 0


def mp_bytes(cfg, tp: int) -> dict:
    """The leg's sizes reckoned before it runs: gpt_small's parameters, a
    tp-split rank's f32 parameters alone and with gradients and AdamW's
    two moments, and a tp x sp rank's f32 logits."""
    h, m, L = cfg.hidden, cfg.mlp_hidden, cfg.num_layers
    replicated = cfg.vocab_size * h + cfg.max_seq_len * h + 2 * h + L * (5 * h)
    split = L * (3 * h * h + h * h + h * m + m + m * h)
    per_rank = 4 * (replicated + split // tp)
    return {"params": replicated + split, "rank_param_bytes": per_rank,
            "rank_train_bytes": 4 * per_rank,
            "logits_bytes": 4 * TRAIN_BATCH * (TRAIN_SEQ // 2) * cfg.vocab_size}


def mp_worst(reports, mode: str) -> tuple:
    """The worst leaf's max |grad diff| over every rank / max |ref grad|."""
    worst, leaf = 0.0, None
    rows = [rep["modes"][mode]["gaps"] if mode != "pp" else rep["pp"]["gaps"] for rep in reports]
    for i, (path, _, r) in enumerate(rows[0]):
        ratio = max(row[i][1] for row in rows) / max(r, 1e-30)
        if ratio > worst:
            worst, leaf = ratio, path
    return worst, leaf


def model_parallel_leg(tft, dev) -> dict:
    """Model parallelism on the card, within MP_LEG_LIMIT_S.

    (a) A world of one under NCCL (:func:`mp_world_of_one`), bit for bit
        against ``make_train_step``, then the single-process references
        (:func:`mp_references`).
    (b) Four gloo ranks of this script (``--mp-rank``) sharing cuda:0,
        started first so their start-up overlaps (a): each of MP_MODES for
        two steps, the first's loss within MP_LOSS_ATOL and every gathered
        gradient leaf within MP_GRAD_RTOL of its max against the reference
        of its impl family (dense for ring/Ulysses, flash for flash), the
        flash modes launching each flash kernel 12 times a step on every
        rank, the others none.
    (c) ``moe_ffn_ep`` on ``{"ep": 4}`` against ``moe_ffn`` on the whole
        batch here, within MP_MOE_RTOL, with every token in a slot.
    (d) The pipeline on ``{"pp": 4}`` against the 12 layers in order: its
        output and one step's loss and layer gradients within the gates,
        each flash kernel launched 24 times a rank (8 microbatches, 3
        layers).
    A failed rank fails the leg."""
    import os
    import pickle
    import shutil
    import tempfile

    import torch
    from tensorframes_tpu_torch.models import generation as gen
    from tensorframes_tpu_torch.models import moe

    t_leg = time.perf_counter()
    cfg = gen.gpt_small(attention_impl="flash")
    sizes = mp_bytes(cfg, 2)
    log(f"# model-parallel bytes reckoned: gpt_small {sizes['params']} params; a tp=2 rank "
        f"holds {sizes['rank_param_bytes']} bytes of f32 params, {sizes['rank_train_bytes']} "
        f"with gradients and AdamW's moments; a tp x sp rank's f32 logits [{TRAIN_BATCH}, "
        f"{TRAIN_SEQ // 2}, {cfg.vocab_size}] {sizes['logits_bytes']} bytes")
    work = Path(tempfile.mkdtemp(prefix="mp_", dir=str(ROOT / "build")))
    port = free_port()
    procs = [subprocess.Popen(MP_RANK_CMD + [str(r), str(MP_RANKS), str(port), str(work)],
                              cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, env=dict(os.environ, TFTPU_RUN_ID="model_parallel"))
             for r in range(MP_RANKS)]
    logs = []
    try:
        t0 = time.perf_counter()
        one = mp_world_of_one(tft, dev, work)
        one_s = time.perf_counter() - t0
        ref_walls = mp_references(tft, dev, work)
        (work / "refs.ready").touch()
        for p in procs:
            left = max(1.0, MP_LEG_LIMIT_S - (time.perf_counter() - t_leg))
            logs.append(p.communicate(timeout=left)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode != 0 for p in procs):
        fail("model-parallel leg: a rank failed: " + " | ".join(
            f"rank {r} rc {p.returncode}: {logs[r][-2000:] if r < len(logs) else ''}"
            for r, p in enumerate(procs)))
    reports = []
    for r in range(MP_RANKS):
        with open(work / f"rank{r}.pkl", "rb") as f:
            reports.append(pickle.load(f))
    log(f"# model-parallel world of one (NCCL, mesh dp=1, flash): steps "
        + ", ".join(f"{ms:.3f}" for ms in one["step_ms"]) + f" ms host wall, bit for bit "
        f"against make_train_step (losses, every gradient and updated leaf); launches "
        f"{one['launches']}; peak memory {one['peak_bytes']} bytes; {one_s:.1f} s; references "
        f"{json.dumps({k: round(v, 2) for k, v in ref_walls.items()})} s")

    gates = {}
    total = dict(one["launches"])
    for name, axes, impl, mixed, ref in MP_MODES:
        modes = [rep["modes"][name] for rep in reports]
        losses = {m["losses"][0] for m in modes}
        if len(losses) != 1:
            fail(f"model-parallel leg: {name}'s ranks disagree on the loss: {losses}")
        loss, ref_loss = modes[0]["losses"][0], modes[0]["ref_loss"]
        worst, leaf = mp_worst(reports, name)
        gates[name] = (abs(loss - ref_loss), worst)
        flash = impl == "flash"
        for rep, m in zip(reports, modes):
            want = cfg.num_layers if flash else 0
            got = {k: m["launches"][k] for k in TRAINING_BUILDS}
            if set(got.values()) != {want}:
                fail(f"model-parallel leg: {name} rank {rep['rank']} launched {got} in a step "
                     f"(want {want} of each flash kernel, on the tensor cores)")
            if not all(np.isfinite(m["losses"])):
                fail(f"model-parallel leg: {name} rank {rep['rank']} losses {m['losses']}")
            for k in TRAINING_BUILDS:
                total[k] = total.get(k, 0) + m["launches_total"][k]
        log(f"# model-parallel {name} mesh {axes} ({impl}{', mixed precision' if mixed else ''}"
            f"; {cfg.num_heads // axes['tp']} heads a rank, local qkv {modes[0]['local_qkv']}): "
            f"loss {loss:.6f} against {ref} {ref_loss:.6f} (|diff| {abs(loss - ref_loss):.6g}, "
            f"gate {MP_LOSS_ATOL}); worst leaf {leaf} max|grad diff| / max|grad| {worst:.6g} "
            f"(gate {MP_GRAD_RTOL}); second loss {modes[0]['losses'][1]:.6f}; step ms "
            + "; ".join(f"rank {rep['rank']} " + ", ".join(f"{x:.1f}" for x in m["step_ms"])
                        for rep, m in zip(reports, modes))
            + "; launches in step 1 a rank (forward, dK/dV, dQ) "
            + json.dumps([[m["launches"][k] for k in TRAINING_KERNELS] for m in modes])
            + f", in both steps {[m['launches_total']['flash_attention'] for m in modes]}; "
            f"bytes sent in step 1 by rank 0 {json.dumps(modes[0]['bytes'])}; peak memory "
            f"{[m['peak_bytes'] for m in modes]}")
        if abs(loss - ref_loss) > MP_LOSS_ATOL:
            fail(f"model-parallel leg: {name}'s loss {loss} off {ref}'s {ref_loss} by more "
                 f"than {MP_LOSS_ATOL}")
        if worst > MP_GRAD_RTOL:
            fail(f"model-parallel leg: {name}'s gradient {leaf} off {ref}'s by {worst} of its "
                 f"max (gate {MP_GRAD_RTOL})")

    # (c) against moe_ffn on the whole batch, in this process
    mcfg = moe.MoEConfig(**MP_MOE)
    for rep in reports:
        if rep["ep"]["kept"] != rep["ep"]["tokens"]:
            fail(f"model-parallel leg: rank {rep['rank']} dropped "
                 f"{rep['ep']['tokens'] - rep['ep']['kept']} tokens over capacity")
    with torch.no_grad():
        params = moe.init_moe_params(mcfg, seed=SEED, device=dev)
        x = mp_moe_tokens(dev, MP_RANKS)
        full = moe.moe_ffn(mcfg, params, x)
        got = torch.cat([rep["ep"]["y"].to(dev) for rep in reports])
        moe_gap = float((got - full).abs().max()) / float(full.abs().max())
    del params, x, full, got
    torch.cuda.empty_cache()
    log(f"# model-parallel ep mesh {{'ep': {MP_RANKS}}}: moe_ffn_ep {MP_MOE}, "
        f"{MP_MOE_TOKENS} tokens a rank, every token in a slot; max|diff| / max|moe_ffn| on "
        f"the whole batch {moe_gap:.6g} (gate {MP_MOE_RTOL}); ms "
        f"{[round(rep['ep']['ms'], 3) for rep in reports]}; bytes sent by rank 0 "
        f"{json.dumps(reports[0]['ep']['bytes'])}; peak memory "
        f"{[rep['ep']['peak_bytes'] for rep in reports]}")
    if moe_gap > MP_MOE_RTOL:
        fail(f"model-parallel leg: moe_ffn_ep off moe_ffn by {moe_gap} of its max")

    # (d) the pipeline
    pps = [rep["pp"] for rep in reports]
    worst, leaf = mp_worst(reports, "pp")
    out_gap = max(p["out_gap"] / p["out_max"] for p in pps)
    loss_gap = abs(pps[0]["loss"] - pps[0]["ref_loss"])
    want = MP_PP_MICRO * cfg.num_layers // MP_RANKS
    for rep, p in zip(reports, pps):
        if p["fwd_launches"]["flash_attention"] != want or {
                p["launches"][k] for k in TRAINING_BUILDS} != {want}:
            fail(f"model-parallel leg: pp rank {rep['rank']} launched {p['fwd_launches']} "
                 f"forward, {p['launches']} a step (want {want} of each, on the tensor cores)")
        for k in TRAINING_BUILDS:
            total[k] = total.get(k, 0) + p["launches"][k] + p["fwd_launches"][k]
    log(f"# model-parallel pp mesh {{'pp': {MP_RANKS}}} (3 layers a stage, {MP_PP_MICRO} "
        f"microbatches, flash): output max|diff| / max|ref| {out_gap:.6g}, loss "
        f"{pps[0]['loss']:.6f} against {pps[0]['ref_loss']:.6f} (|diff| {loss_gap:.6g}); worst "
        f"leaf {leaf} {worst:.6g}; step ms {[round(p['ms'], 1) for p in pps]}; launches a rank "
        f"(forward, dK/dV, dQ): the forward alone "
        f"{[[p['fwd_launches'][k] for k in TRAINING_KERNELS] for p in pps]}, a step "
        f"{[[p['launches'][k] for k in TRAINING_KERNELS] for p in pps]}; bytes sent a step "
        f"{[p['bytes'] for p in pps]}; peak memory {[p['peak_bytes'] for p in pps]}")
    if out_gap > MP_GRAD_RTOL or loss_gap > MP_LOSS_ATOL or worst > MP_GRAD_RTOL:
        fail(f"model-parallel leg: the pipeline off the layers in order (output {out_gap}, "
             f"loss {loss_gap}, gradient {leaf} {worst})")
    log("# model-parallel ranks: waited " + ", ".join(
        f"{rep['wait_s']:.1f}" for rep in reports) + " s for the references after start-up")
    shutil.rmtree(work, ignore_errors=True)
    leg_s = time.perf_counter() - t_leg
    log(f"# model-parallel leg: {leg_s:.1f} s (limit {MP_LEG_LIMIT_S:g} s)")
    if leg_s > MP_LEG_LIMIT_S:
        fail(f"model-parallel leg: took {leg_s:.1f} s (limit {MP_LEG_LIMIT_S:g} s)")
    total = {k: total.get(k, 0) for k in set(total) | set(launch_counts(tft))}
    return {"launches": total, "leg_s": leg_s, "gates": gates, "world_of_one": one}

# The resumable_training leg: gpt_small's checkpointed resume, a kill -9
# drill, a NaN step and gradient accumulation. A resume equals the
# uninterrupted run bit for bit only when every step is deterministic: on
# CUDA the backward of loss_fn's gather and of the embedding's index
# accumulate with atomics unless torch.use_deterministic_algorithms is on,
# and cuBLAS needs CUBLAS_WORKSPACE_CONFIG set before its first handle.
RESUME_STEPS, RESUME_SAVE_EVERY = 6, 3
KILL_LAYERS, KILL_STEPS, KILL_SAVE_EVERY = 2, 4, 2
NAN_STEP, NAN_STEPS = 3, 5
ACCUM = 2
ACCUM_LOSS_RTOL = 1e-5
ACCUM_PARAM_RTOL, ACCUM_PARAM_ATOL = 2.0 ** -7, 1e-6
# AdamW's first step moves each entry by about lr·sign(g), whatever g's
# scale, so the division by accum_steps shows in the first moments (which
# hold (1 - b1)·g), not in the parameters. bf16 rounds each microbatch's
# weight gradients (2^-8 relative); an entry whose gradient is within that
# of zero can step the other way, so the parameter gate skips entries
# whose moment is below ACCUM_SMALL of its leaf's largest.
ACCUM_MOMENT_RTOL = 2.0 ** -6  # worst leaf's |m2 - m1| / |m1| (norms)
ACCUM_SMALL = 2.0 ** -5
# leg 5: each run takes 1 + OVERHEAD_WARM steps and times the warm ones;
# the four modes take turns, forwards then backwards, OVERHEAD_ROUNDS
# times (4 runs and 32 warm steps a mode)
OVERHEAD_WARM, OVERHEAD_ROUNDS = 8, 2
CHILD_TIMEOUT_S = 240

# One child of the kill -9 drill: gpt_small's width at KILL_LAYERS layers,
# run_resumable over the 16-row frame's batches (epoch-cycling, shuffled
# with seed + epoch), saving every KILL_SAVE_EVERY steps. argv: the
# checkpoint dir, and the loop edge after which an armed KillRank fires
# (0: none). Deterministic, as the parent.
RESUME_CHILD = r"""
import os, sys
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
import torch
torch.use_deterministic_algorithms(True)
sys.path.insert(0, os.environ["TFTORCH_ROOT"])
import tensorframes_tpu_torch as tft
from tensorframes_tpu_torch.checkpoint import Checkpointer
from tensorframes_tpu_torch.models import generation as gen, transformer as tr
from tensorframes_tpu_torch.resilience import KillRank, inject
ckdir, kill_after, layers, steps, save_every, rows, seq, batch, lr, seed = sys.argv[1:11]
layers, steps, save_every, kill_after = int(layers), int(steps), int(save_every), int(kill_after)
rows, seq, batch, seed = int(rows), int(seq), int(batch), int(seed)
dev = torch.device("cuda", 0)
cfg = gen.gpt_small(attention_impl="flash", num_layers=layers)
tokens, targets = tr.synthetic_batch(cfg, rows, seq, seed=seed)
frame = tft.frame_from_arrays({"tokens": tokens, "targets": targets})
batches = []
for epoch in range(steps):
    batches += list(tft.io.iterate_batches(frame, ["tokens", "targets"], batch, shuffle=True,
                                           seed=seed + epoch, drop_remainder=True))
batches = [tft.io.to_device(b, dev) for b in batches[:steps]]
params = tr.init_params(cfg, seed=seed, device=dev)
opt = tr.adamw(params, float(lr))
step = tr.make_train_step(cfg, opt)
def step_fn(state, b):
    p, o = state
    _, _, loss = step(p, o.state, b["tokens"], b["targets"])
    return (p, o), loss
def run():
    return tft.training.run_resumable(step_fn, (params, opt), Checkpointer(ckdir), batches,
                                      num_steps=steps, save_every=save_every)
if kill_after:
    with inject("fleet.rank.kill", KillRank(), after=kill_after):
        run()
else:
    run()
torch.cuda.synchronize()
print("DONE", flush=True)
"""


def state_mismatches(a, b) -> list:
    """Keys of two train states' leaves (parameters, and the optimizer's
    moments and step counts) whose bits differ."""
    import torch
    from tensorframes_tpu_torch.utils.tree import flatten_with_keys

    fa, fb = dict(flatten_with_keys(a)), dict(flatten_with_keys(b))
    if set(fa) != set(fb):
        return sorted(set(fa) ^ set(fb))
    return [k for k in fa if not (fa[k].dtype == fb[k].dtype and fa[k].shape == fb[k].shape
                                  and torch.equal(fa[k].to(fb[k].device), fb[k]))]


def ckpt_records(flight, kind: str, since: int) -> list:
    return [r for r in flight.RECORDER.records() if r["kind"] == kind and r["seq"] > since]


def dir_bytes(path) -> int:
    return sum(f.stat().st_size for f in Path(path).rglob("*") if f.is_file())


def resumable_training_leg(tft, dev) -> dict:
    """gpt_small (vocab 32,000, 12 x 768, 12 heads, seq 1,024, bf16
    activations, f32 parameters, AdamW lr 1e-3, seed 0) off the training
    path's 16-row frame in batches of 8, counts reset first:

    1. resume: under deterministic algorithms ``train_on_frame`` with
       ``Checkpointer(a)`` and ``save_every=3`` runs 6 steps; a fresh
       state (seed 1, empty AdamW state) and a Checkpointer holding only
       step 3 resume and run 4-6; parameters, moments and step counts
       equal bit for bit. Each step launches 12 of each flash kernel on
       its tensor-core build. Each save's and the restore's seconds,
       bytes and MB/s.
    2. kill -9: a child (the same width, 2 layers) SIGKILLs itself at
       the loop edge after step 2's checkpoint; a relaunch finishes 4
       steps; its step-4 checkpoint equals an uninterrupted child's bit
       for bit, and the killed child's flight spool holds the
       ``fault.kill_rank`` record.
    3. NaN step: step 3's loss times NaN under ``guard="skip"`` gives the
       bits of a run that never saw batch 3; under ``guard="raise"`` in
       ``run_resumable`` ``NonFiniteError`` is raised and the emergency
       checkpoint (step 2) is finite.
    4. accumulation: ``make_grad_accum_step(accum_steps=2)`` on one batch
       of 8 against ``accum_steps=1``: loss within 1e-5 relative, first
       moments and parameters within their tolerances, the version
       without the division outside; 24 launches of each flash kernel;
       peak memory of both.
    5. overhead: the warm step times of the plain loop, a
       ``StepTelemetry`` writing JSONL (one row a step, the steps' own
       losses), ``guard="rollback"`` and both, in alternating turns: each
       run's first step left out, each warm step's time the gap between
       CUDA events recorded at consecutive steps' ends (so a host wait
       shows as the device's idle time); median, p10, p90 and each run's
       median, a mode's gap against the plain loop's spread."""
    import math
    import os
    import shutil
    import statistics
    import tempfile

    import numpy as np
    import torch
    from tensorframes_tpu_torch.checkpoint import Checkpointer
    from tensorframes_tpu_torch.models import generation as gen
    from tensorframes_tpu_torch.models import transformer as tr
    from tensorframes_tpu_torch.observability import flight
    from tensorframes_tpu_torch.observability.steps import StepTelemetry
    from tensorframes_tpu_torch.resilience import NonFiniteError, StepGuard

    cfg = gen.gpt_small(attention_impl="flash")
    tokens, targets = tr.synthetic_batch(cfg, TRAIN_ROWS, TRAIN_SEQ, seed=SEED)
    frame = tft.frame_from_arrays({"tokens": tokens, "targets": targets})
    cols = ["tokens", "targets"]
    layers = cfg.num_layers
    per_epoch = TRAIN_ROWS // TRAIN_BATCH
    host_batches = []
    for epoch in range(NAN_STEPS // per_epoch + 1):
        host_batches += list(tft.io.iterate_batches(frame, cols, TRAIN_BATCH, shuffle=True,
                                                    seed=SEED + epoch, drop_remainder=True))

    def fresh(seed, accum=None, scale=None):
        """A train state ``(params, opt)`` and its step_fn; ``accum`` steps
        through make_grad_accum_step, with each microbatch loss times
        ``scale[0]``."""
        params = tr.init_params(cfg, seed=seed, device=dev)
        opt = tr.adamw(params, TRAIN_LR)
        if accum is None:
            step = tr.make_train_step(cfg, opt)

            def step_fn(state, b):
                _, _, loss = step(state[0], state[1].state, b["tokens"], b["targets"])
                return state, loss
        else:
            def loss_fn(p, b):
                loss = tr.loss_fn(cfg, p, b["tokens"], b["targets"])
                return loss if scale is None else loss * scale[0]

            step = tft.training.make_grad_accum_step(loss_fn, opt, accum)

            def step_fn(state, b):
                _, _, loss = step(state[0], state[1].state, b)
                return state, loss
        return (params, opt), step_fn

    def per_step_launches(snaps, want, what):
        prev = {k: 0 for k in snaps[0]}
        for i, snap in enumerate(snaps):
            got = {k: snap[k] - prev[k] for k in TRAINING_BUILDS}
            if set(got.values()) != {want}:
                fail(f"{what} step {i + 1} launched {got} (want {want} of each, every flash "
                     "kernel on the tensor cores)")
            prev = snap

    work = Path(tempfile.mkdtemp(prefix="tftorch_resume_"))
    out = {}
    torch.cuda.synchronize()
    tft.kernels.LAUNCHES.reset()
    t_leg = time.perf_counter()
    try:
        # 1. resume at full width, one process
        torch.use_deterministic_algorithms(True)
        log(f"# resumable 1: deterministic algorithms {torch.are_deterministic_algorithms_enabled()}, "
            f"CUBLAS_WORKSPACE_CONFIG={os.environ.get('CUBLAS_WORKSPACE_CONFIG')}")
        seq0 = flight.RECORDER.records()[-1]["seq"] if flight.RECORDER.records() else 0
        state_a, fn_a = fresh(SEED)
        snaps_a = []
        state_a, ran_a = tft.training.train_on_frame(
            fn_a, state_a, frame, cols, batch_size=TRAIN_BATCH, num_steps=RESUME_STEPS,
            checkpointer=Checkpointer(str(work / "a")), save_every=RESUME_SAVE_EVERY,
            shuffle=True, seed=SEED, prefetch=2,
            on_step=lambda i, l: snaps_a.append(launch_counts(tft)), device=dev)
        torch.cuda.synchronize()
        (work / "b").mkdir()
        shutil.copytree(work / "a" / f"step_{RESUME_SAVE_EVERY}",
                        work / "b" / f"step_{RESUME_SAVE_EVERY}", copy_function=os.link)
        state_b, fn_b = fresh(SEED + 1)
        snaps_b = []
        base = launch_counts(tft)
        state_b, ran_b = tft.training.train_on_frame(
            fn_b, state_b, frame, cols, batch_size=TRAIN_BATCH, num_steps=RESUME_STEPS,
            checkpointer=Checkpointer(str(work / "b")), save_every=RESUME_SAVE_EVERY,
            shuffle=True, seed=SEED, prefetch=2,
            on_step=lambda i, l: snaps_b.append(
                {k: v - base[k] for k, v in launch_counts(tft).items()}), device=dev)
        torch.cuda.synchronize()
        if (ran_a, ran_b) != (RESUME_STEPS, RESUME_STEPS - RESUME_SAVE_EVERY):
            fail(f"the resume runs ran {ran_a} and {ran_b} steps (want {RESUME_STEPS} and "
                 f"{RESUME_STEPS - RESUME_SAVE_EVERY})")
        per_step_launches(snaps_a, layers, "resume run A")
        per_step_launches(snaps_b, layers, "resume run B")
        bad = state_mismatches(state_a, state_b)
        if bad:
            fail(f"the resumed state differs from the uninterrupted one at {len(bad)} leaves, "
                 f"e.g. {bad[:3]}")
        saves = ckpt_records(flight, "checkpoint.save", seq0)
        restores = ckpt_records(flight, "checkpoint.restore", seq0)
        ck_bytes = dir_bytes(work / "b" / f"step_{RESUME_SAVE_EVERY}")
        for r in saves:
            log(f"# resumable 1: save step {r['step']}: {r['seconds']:.3f} s, {r['bytes']} bytes, "
                f"{r['bytes'] / r['seconds'] / 1e6:.1f} MB/s")
        for r in restores:
            log(f"# resumable 1: restore step {r['step']}: {r['seconds']:.3f} s, {ck_bytes} bytes, "
                f"{ck_bytes / r['seconds'] / 1e6:.1f} MB/s, ok {r['ok']}")
        log(f"# resumable 1: resumed from step {RESUME_SAVE_EVERY} to {RESUME_STEPS}: parameters, "
            "AdamW moments and step counts equal the uninterrupted run's bit for bit; 12 "
            "launches of each flash kernel a step, all on the tensor cores")
        out["resume"] = {"saves": [{k: r[k] for k in ("step", "seconds", "bytes")} for r in saves],
                         "restores": [{"step": r["step"], "seconds": r["seconds"],
                                       "bytes": ck_bytes} for r in restores]}
        del state_a, state_b
        shutil.rmtree(work / "a")
        shutil.rmtree(work / "b")

        # 2. kill -9 drill in child processes
        env = dict(os.environ, TFTORCH_ROOT=str(ROOT),
                   CUBLAS_WORKSPACE_CONFIG=os.environ.get("CUBLAS_WORKSPACE_CONFIG", ":4096:8"))
        env.pop("TFTPU_FLIGHT_DIR", None)

        def child(ckdir, kill_after, flight_dir=None):
            e = dict(env, TFTPU_FLIGHT_DIR=str(flight_dir)) if flight_dir else env
            args = [str(ckdir), str(kill_after), str(KILL_LAYERS), str(KILL_STEPS),
                    str(KILL_SAVE_EVERY), str(TRAIN_ROWS), str(TRAIN_SEQ), str(TRAIN_BATCH),
                    str(TRAIN_LR), str(SEED)]
            return subprocess.Popen([sys.executable, "-c", RESUME_CHILD, *args], env=e,
                                    cwd=str(ROOT), stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)

        # the uninterrupted child runs beside the drilled one and its relaunch
        t_kill = time.perf_counter()
        procs = {"whole": child(work / "w", 0),
                 "killed": child(work / "k", KILL_SAVE_EVERY, work / "flight")}
        walls = {}
        try:
            so, se = procs["killed"].communicate(timeout=CHILD_TIMEOUT_S)
            walls["killed"] = time.perf_counter() - t_kill
            rc = procs["killed"].returncode
            if rc != -9:
                fail(f"the drilled child exited {rc} (want -9, SIGKILL)\n{so}\n{se[-3000:]}")
            steps_k = Checkpointer(str(work / "k")).all_steps()
            if steps_k != [KILL_SAVE_EVERY]:
                fail(f"the killed child left checkpoints {steps_k} (want [{KILL_SAVE_EVERY}])")
            procs["relaunch"] = child(work / "k", 0)
            for name in ("whole", "relaunch"):
                so, se = procs[name].communicate(timeout=CHILD_TIMEOUT_S)
                walls[name] = time.perf_counter() - t_kill
                if procs[name].returncode != 0 or "DONE" not in so:
                    fail(f"the {name} child exited {procs[name].returncode}\n{so}\n{se[-3000:]}")
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
        got = Checkpointer(str(work / "k")).restore(step=KILL_STEPS)
        want = Checkpointer(str(work / "w")).restore(step=KILL_STEPS)
        bad = [k for k in want if k not in got or not torch.equal(got[k], want[k])]
        if bad or set(got) != set(want):
            fail(f"the killed-and-resumed child's step {KILL_STEPS} differs from the "
                 f"uninterrupted child's at {len(bad)} leaves, e.g. {bad[:3]}")
        box = flight.read_blackbox(str(work / "flight"))
        kills = [r for r in box if r["kind"] == "fault.kill_rank"]
        if not kills:
            fail(f"the killed child's flight spool holds no fault.kill_rank record "
                 f"({[r['kind'] for r in box][-8:]})")
        kill_s = time.perf_counter() - t_kill
        log(f"# resumable 2: kill -9 drill ({KILL_LAYERS} layers, {KILL_STEPS} steps, "
            f"save_every {KILL_SAVE_EVERY}): SIGKILL at the loop edge after step "
            f"{KILL_SAVE_EVERY}'s checkpoint, relaunch resumed to step {KILL_STEPS}, "
            f"{len(want)} leaves bit-equal to the uninterrupted child's; black box "
            f"{len(box)} records, last {kills[-1]['kind']} at {kills[-1]['site']}; {kill_s:.1f} s "
            "(each child's end from the drill's start: "
            + ", ".join(f"{k} {v:.1f} s" for k, v in walls.items()) + ")")
        out["kill"] = {"seconds": kill_s, "leaves": len(want), "blackbox_records": len(box),
                       "child_walls_s": walls}
        shutil.rmtree(work / "k")
        shutil.rmtree(work / "w")

        # 3. a NaN step
        scale = [1.0]
        calls = [0]
        state_s, fn = fresh(SEED, accum=1, scale=scale)

        def poisoned(state, b):
            calls[0] += 1
            scale[0] = math.nan if calls[0] == NAN_STEP else 1.0
            return fn(state, b)

        guard = StepGuard("skip")
        state_s, ran = tft.training.train_on_frame(
            poisoned, state_s, frame, cols, batch_size=TRAIN_BATCH, num_steps=NAN_STEPS,
            shuffle=True, seed=SEED, prefetch=2, guard=guard, device=dev)
        scale[0] = 1.0
        state_r, fn_r = fresh(SEED, accum=1, scale=scale)
        for i, b in enumerate(host_batches[:NAN_STEPS]):
            if i + 1 != NAN_STEP:
                state_r, _ = fn_r(state_r, tft.io.to_device(b, dev))
        torch.cuda.synchronize()
        if ran != NAN_STEPS or guard.skipped != 1:
            fail(f"the skip run ran {ran} steps and skipped {guard.skipped} (want {NAN_STEPS}, 1)")
        bad = state_mismatches(state_s, state_r)
        if bad:
            fail(f"guard='skip' left a state other than the run without batch {NAN_STEP} at "
                 f"{len(bad)} leaves, e.g. {bad[:3]}")
        steps_seen = int(state_s[1].state[state_s[1].param_groups[0]["params"][0]]["step"])
        del state_s, state_r
        calls[0] = 0
        state_x, fn = fresh(SEED, accum=1, scale=scale)

        def poisoned_x(state, b):
            calls[0] += 1
            scale[0] = math.nan if calls[0] == NAN_STEP else 1.0
            return fn(state, b)

        ck = Checkpointer(str(work / "r"))
        dev_batches = [tft.io.to_device(b, dev) for b in host_batches[:NAN_STEPS]]
        try:
            tft.training.run_resumable(poisoned_x, state_x, ck, dev_batches, num_steps=NAN_STEPS,
                                       save_every=0, guard="raise")
            fail("guard='raise' let a NaN step through")
        except NonFiniteError as e:
            raised = str(e)
        if ck.all_steps() != [NAN_STEP - 1]:
            fail(f"the emergency checkpoint is at {ck.all_steps()} (want [{NAN_STEP - 1}])")
        saved = ck.restore(step=NAN_STEP - 1)
        if not all(bool(torch.isfinite(v).all()) for v in saved.values() if v.is_floating_point()):
            fail("the emergency checkpoint under guard='raise' holds non-finite values")
        log(f"# resumable 3: step {NAN_STEP}'s loss x NaN: guard='skip' equals the run without "
            f"batch {NAN_STEP} bit for bit (parameters, moments, step count {steps_seen}); "
            f"guard='raise' raised ({raised}) and its emergency checkpoint (step "
            f"{NAN_STEP - 1}, {len(saved)} leaves) is finite")
        del state_x, saved
        shutil.rmtree(work / "r")
        torch.use_deterministic_algorithms(False)

        # 4. gradient accumulation at full width
        batch = tft.io.to_device(host_batches[0], dev)
        accum_runs = {}
        for name, accum, mult in (("accum 1", 1, 1.0), ("accum 2", ACCUM, 1.0),
                                  ("accum 2 without the division", ACCUM, float(ACCUM))):
            # multiplying each microbatch loss by accum_steps undoes the
            # division exactly (a power of two): the broken version
            state, fn = fresh(SEED, accum=accum, scale=[mult])
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            before = launch_counts(tft)
            state, loss = fn(state, batch)
            torch.cuda.synchronize()
            after = launch_counts(tft)
            accum_runs[name] = {
                "loss": float(loss), "state": state,
                "launches": {k: after[k] - before[k] for k in TRAINING_BUILDS},
                "peak_bytes": torch.cuda.max_memory_allocated(dev), "held_bytes": held}
        ref = accum_runs["accum 1"]

        @torch.no_grad()
        def gaps(run):
            p1, o1 = ref["state"]
            p2, o2 = run["state"]
            loss_gap = abs(run["loss"] - ref["loss"]) / abs(ref["loss"])
            moment_gap, param_bad, skipped, worst_dp = 0.0, 0, 0, 0.0
            for a, b in zip(tr.tree_leaves(p1), tr.tree_leaves(p2)):
                m1, m2 = o1.state[a]["exp_avg"], o2.state[b]["exp_avg"]
                moment_gap = max(moment_gap, float((m2 - m1).norm() / m1.norm().clamp_min(1e-30)))
                big = m1.abs() >= ACCUM_SMALL * m1.abs().max()
                dp = (b - a).abs()
                worst_dp = max(worst_dp, float(dp.max()))
                param_bad += int((big & (dp > ACCUM_PARAM_RTOL * a.abs() + ACCUM_PARAM_ATOL)).sum())
                skipped += int((~big).sum())
            return loss_gap, moment_gap, param_bad, skipped, worst_dp

        g2 = gaps(accum_runs["accum 2"])
        gb = gaps(accum_runs["accum 2 without the division"])
        for name, run in accum_runs.items():
            log(f"# resumable 4: {name}: loss {run['loss']:.7f}, launches {run['launches']}, "
                f"peak memory {run['peak_bytes']} bytes ({run['peak_bytes'] - run['held_bytes']} "
                f"above the {run['held_bytes']} held)")
        for name, (lg, mg, pb, sk, dp) in (("accum 2", g2), ("without the division", gb)):
            log(f"# resumable 4: {name} against accum 1: loss {lg:.3g} relative (tolerance "
                f"{ACCUM_LOSS_RTOL}), first moments {mg:.3g} (tolerance {ACCUM_MOMENT_RTOL}), "
                f"{pb} parameters outside 2^-7|p| + 1e-6 ({sk} entries with a moment under "
                f"{ACCUM_SMALL} of their leaf's largest not held; largest |dp| {dp:.3g})")
        if g2[0] > ACCUM_LOSS_RTOL or g2[1] > ACCUM_MOMENT_RTOL or g2[2]:
            fail(f"accum_steps=2 off accum_steps=1: {g2}")
        if not (gb[0] > ACCUM_LOSS_RTOL and gb[1] > ACCUM_MOMENT_RTOL):
            fail(f"the accumulation gate cannot see a dropped division: {gb}")
        want = {k: ACCUM * layers for k in TRAINING_BUILDS}
        if accum_runs["accum 2"]["launches"] != want:
            fail(f"an accum_steps=2 step launched {accum_runs['accum 2']['launches']} (want "
                 f"{want})")
        out["accum"] = {name: {k: run[k] for k in ("loss", "peak_bytes", "held_bytes")}
                        for name, run in accum_runs.items()}
        out["accum"]["gaps"] = {"accum 2": g2, "without the division": gb}
        del accum_runs, ref

        # 5. overhead of the guard and the telemetry (deterministic mode off)
        state, fn = fresh(SEED)
        jsonl = work / "steps.jsonl"
        step_ms = {}
        modes = ("plain", "telemetry", "guard", "guard+telemetry")
        turns = (modes + modes[::-1]) * OVERHEAD_ROUNDS
        for turn, mode in enumerate(turns):
            ends, losses = [], []

            def mark(i, loss):
                losses.append(loss)
                ends.append(torch.cuda.Event(enable_timing=True))
                ends[-1].record()

            telemetry = StepTelemetry(str(jsonl)) if "telemetry" in mode else None
            jsonl.unlink(missing_ok=True)
            state, ran = tft.training.train_on_frame(
                fn, state, frame, cols, batch_size=TRAIN_BATCH, num_steps=1 + OVERHEAD_WARM,
                shuffle=True, seed=SEED + turn, prefetch=2,
                guard="rollback" if "guard" in mode else None, telemetry=telemetry,
                on_step=mark, device=dev)
            torch.cuda.synchronize()
            step_ms.setdefault(mode, []).append([a.elapsed_time(b) for a, b in zip(ends, ends[1:])])
            if telemetry is not None:
                telemetry.close()
                rows = [json.loads(x) for x in jsonl.read_text().splitlines()]
                if [r["step"] for r in rows] != list(range(1, OVERHEAD_WARM + 2)) or any(
                        r["loss"] != float(l) or not math.isfinite(r["loss"])
                        for r, l in zip(rows, losses)):
                    fail(f"the telemetry JSONL rows {rows} do not match the steps' losses")
        overhead = {}
        for mode, runs in step_ms.items():
            flat = sorted(x for r in runs for x in r)
            overhead[mode] = {"steps": len(flat), "median_ms": statistics.median(flat),
                              "p10_ms": flat[len(flat) // 10],
                              "p90_ms": flat[(9 * len(flat)) // 10],
                              "run_medians_ms": [statistics.median(r) for r in runs]}
        plain = overhead["plain"]
        spread = (max(plain["run_medians_ms"]) - min(plain["run_medians_ms"])) / plain["median_ms"]
        for mode, o in overhead.items():
            o["vs_plain"] = o["median_ms"] / plain["median_ms"] - 1
            log(f"# resumable 5: {mode}: {o['steps']} warm steps in {len(o['run_medians_ms'])} "
                f"runs of {OVERHEAD_WARM}, median {o['median_ms']:.3f} ms "
                f"({1000 / o['median_ms']:.3f} steps/s), p10 {o['p10_ms']:.3f}, p90 "
                f"{o['p90_ms']:.3f}, run medians "
                + ", ".join(f"{x:.3f}" for x in o["run_medians_ms"])
                + f"; {100 * o['vs_plain']:+.2f}% of the plain median")
        log(f"# resumable 5: turns {', '.join(turns)}; the plain loop's run medians span "
            f"{100 * spread:.2f}% of its median; guard='rollback', StepTelemetry writing JSONL: "
            "one row a step, the steps' own finite losses")
        out["overhead"] = dict(overhead, plain_run_spread=spread)
        del state
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.synchronize()
    out["launches"] = launch_counts(tft)
    out["seconds"] = time.perf_counter() - t_leg
    return out


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


def refusal(torch):
    """Why this script cannot run here (no card; the port not beside it),
    or None."""
    if not torch.cuda.is_available():
        return "no CUDA device (torch.cuda.is_available() is False)"
    if not (ROOT / "tensorframes_tpu_torch" / "csrc").is_dir():
        return "tensorframes_tpu_torch is not beside this script"
    return None


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


def main() -> int:
    import os

    # before CUDA starts: cuBLAS reads it when it makes its first handle,
    # and the resumable leg's deterministic mode needs it
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    why = refusal(torch)
    if why:
        print(f"chip_smoke: {why}", file=sys.stderr)
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
                        "legs": {k: leg["segment_sum"] for k, leg in legs.items()
                                 if "segment_sum" in leg}},
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
    t_plan = time.perf_counter()
    plan = plan_leg(tft, dev)
    plan_s = time.perf_counter() - t_plan
    log(f"# plan leg: {plan_s:.1f} s")
    t_data = time.perf_counter()
    data = data_plane_leg(tft, dev)
    log(f"# data plane leg: {time.perf_counter() - t_data:.1f} s "
        f"({json.dumps({k: round(v, 1) for k, v in data['walls_s'].items()})})")
    dq, ds, dr = data["query"], data["stream"], data["round_trips"]
    log(f"# data plane query: {dq['rows']} rows in {QUERY_PARTS + 1} CSV parts; first execute "
        f"{dq['first_execute_s']:.4f} s, repeat p50 {dq['repeat_p50_s'] * 1e3:.4f} ms "
        f"({QUERY_REPEATS} hits; beside it, p50 of the listing "
        f"{dq['hit_split_p50_s']['list_s'] * 1e3:.4f} ms, the manifest "
        f"{dq['hit_split_p50_s']['manifest_s'] * 1e3:.4f} ms, the digest "
        f"{dq['hit_split_p50_s']['digest_s'] * 1e3:.4f} ms), refresh after one appended part "
        f"{dq['refresh_s']:.4f} s, full "
        f"recompute {dq['full_recompute_s']:.4f} s (refresh / full "
        f"{dq['refresh_over_full']:.4f}); segment_reduce launches cold "
        f"{dq['cold_launches']['segment_reduce']}, refresh "
        f"{dq['refresh_launches']['segment_reduce']}")
    log(f"# data plane query, the dispatch-key store's cost: first execute (armed) "
        f"{json.dumps(dq['first_execute_store'])} of {dq['first_execute_s']:.4f} s; "
        f"fresh cold executes off/armed/armed/off {json.dumps(dq['store_ab'])}")
    log(f"# data plane stream: {ds['rows']} rows, {ds['csv_bytes']} CSV bytes in {ds['parts']} "
        f"parts ({ds['chunks']} chunks, {ds['kept_rows']} rows kept by the filter), budget {ds['budget_bytes']} bytes; streamed {ds['stream_rows_per_s']:.1f} rows/s "
        f"({ds['stream_s']:.4f} s), in memory {ds['in_memory_rows_per_s']:.1f} rows/s "
        f"({ds['in_memory_s']:.4f} s); peak RSS growth {ds['rss_growth_bytes']} bytes (cap "
        f"{ds['rss_cap_bytes']}); resident {ds['resident_bytes']}, spilled "
        f"{ds['spilled_bytes']} bytes; {ds['groups']} groups; segment_reduce launches "
        f"{ds['launches']['segment_reduce']}")
    log(f"# data plane round trips: save_frame {dr['save_s']:.4f} s / load_frame "
        f"{dr['load_s']:.4f} s of {dr['rows']} rows ({dr['saved_bytes']} bytes), bit for bit; "
        f"read_csv native {dr['read_csv_rows_per_s']:.1f} rows/s ({dr['read_csv_s']:.4f} s) = "
        f"numpy's parse; native row pass {dr['native_library']}, built in this process in "
        + (f"{dr['native_build_s']:.2f} s" if dr["native_build_s"] is not None
           else "no time (an existing build was loaded)"))
    for name, r in data["native_sites"].items():
        log(f"# data plane native site {name}: native {r['native_s']:.4f} s, pure "
            f"{r['pure_s']:.4f} s (pure / native {r['pure_over_native']:.2f}), outputs equal")

    lift = lift_leg(tft, dev)
    if lift["launches"]["segment_reduce"] <= 0:
        fail("segment_reduce never launched on the lift leg's chain")

    t2 = time.perf_counter()
    serving = serving_path(tft, dev)
    log(f"# serving path: {time.perf_counter() - t2:.1f} s")
    missing = [k for k in SERVING_KERNELS if serving["launches"][k] <= 0]
    if missing:
        fail(f"kernels never launched on the decode server's path: {missing}")
    state = check_step_logits(serving, dev)
    t_kv = time.perf_counter()
    kv = kv_tiers_leg(tft, dev, serving)
    log(f"# kv tiers leg: {time.perf_counter() - t_kv:.1f} s")
    missing = [k for k in SERVING_KERNELS if kv["launches"][k] <= 0]
    if missing:
        fail(f"kernels never launched on the KV tiers' path: {missing}")

    t3 = time.perf_counter()
    encoder = encoder_path(tft, dev)
    log(f"# encoder path: {time.perf_counter() - t3:.1f} s")
    missing = [k for k in ENCODER_KERNELS if encoder["launches"][k] <= 0]
    if missing:
        fail(f"kernels never launched on the encoder's path: {missing}")
    for verb in ("map_rows", "map_blocks"):
        log(f"# encoder BERT-base {verb}: {encoder['rows_per_s'][verb]:.1f} rows/s (1,024 rows "
            f"x 128 tokens in {encoder['seconds'][verb]:.4f} s, flash attention)")
    t_flush = time.perf_counter()
    flush = flush_serving_leg(tft, dev, encoder)
    log(f"# flush serving leg: {time.perf_counter() - t_flush:.1f} s")
    if flush["launches"]["flash_attention"] <= 0:
        fail("flash_attention never launched on the flush endpoint's path")
    t_fleet = time.perf_counter()
    fleet = fleet_serving_leg(tft, dev, encoder)
    log(f"# fleet serving leg: {time.perf_counter() - t_fleet:.1f} s")
    if fleet["launches"]["flash_attention"] <= 0:
        fail("flash_attention never launched in the fleet's replicas")
    t_infra = time.perf_counter()
    infra = infra_leg(tft, dev, encoder)
    log(f"# infra leg: {time.perf_counter() - t_infra:.1f} s")
    missing = [k for k in ("segment_reduce", "flash_attention") if infra["launches"][k] <= 0]
    if missing:
        fail(f"kernels never launched on the infra leg's path: {missing}")
    t_sharded = time.perf_counter()
    sharded = sharded_leg(tft, dev)
    log(f"# sharded leg: {time.perf_counter() - t_sharded:.1f} s")
    missing = [k for k in ("segment_reduce", "ragged_gather") if sharded["launches"][k] <= 0]
    if missing:
        fail(f"kernels never launched on the sharded leg's path: {missing}")

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

    t_res = time.perf_counter()
    resumable = resumable_training_leg(tft, dev)
    log(f"# resumable_training leg: {time.perf_counter() - t_res:.1f} s")
    missing = [k for k in TRAINING_KERNELS if resumable["launches"][k] <= 0]
    if missing:
        fail(f"kernels never launched on the resumable_training leg: {missing}")
    t_mp = time.perf_counter()
    mp = model_parallel_leg(tft, dev)
    log(f"# model-parallel leg: {time.perf_counter() - t_mp:.1f} s")
    missing = [k for k in TRAINING_KERNELS if mp["launches"][k] <= 0]
    if missing:
        fail(f"kernels never launched on the model-parallel leg: {missing}")

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
             (data, ("segment_reduce", "segment_sum")), (lift, ("segment_reduce",)),
             (serving, SERVING_KERNELS), (kv, SERVING_KERNELS),
             (encoder, ENCODER_KERNELS), (flush, ENCODER_KERNELS), (fleet, ENCODER_KERNELS),
             (infra, ("segment_reduce", "flash_attention")),
             (sharded, ("segment_reduce", "segment_sum", "ragged_gather")),
             (train, TRAINING_KERNELS), (resumable, TRAINING_KERNELS),
             (mp, TRAINING_KERNELS),
             (imported["int8"], ("int8_matmul",)),
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
    log(f"# serving kv tiers: TTFT p50 cold {kv['prefix']['ttft_p50_s']['cold']:.4f} s, suffix "
        f"hit {kv['prefix']['ttft_p50_s']['hit']:.4f} s (bursts of 12, not gated); swap run "
        f"{kv['swap']['wall_s']:.3f} s for 32 requests, resumes {kv['swap']['resumes']}")
    log(f"# flush serving BERT-base: {flush['rows_per_s']:.1f} rows/s ({flush['rows']} rows in "
        f"{flush['requests']} requests at {FLUSH_RATE:.0f} requests/s, {flush['flushes']} "
        f"flushes in {flush['wall_s']:.3f} s); latency p50 {flush['latency_s']['p50']:.4f} s, "
        f"p99 {flush['latency_s']['p99']:.4f} s; "
        + "; ".join(f"{h} half {v['rows_per_s']:.1f} rows/s, p50 {v['latency_s']['p50']:.4f} s, "
                    f"p99 {v['latency_s']['p99']:.4f} s" for h, v in flush["halves"].items())
        + f" (HTTP sends at most {flush['http_send_late_max_s']:.4f} s late, listen overflows "
        f"{flush['listen_overflows']})"
        + f"; server process CPU share {flush['process_cpu_share']:.3f}, flush median wall "
        f"{flush['flush_wall_ms']['median']:.2f} ms against {flush['flush_cpu_ms']['median']:.2f} "
        f"ms of the worker's CPU; {flush['bit_identical_rows']} of "
        f"{flush['rows']} rows bit-identical to map_rows")
    log(f"# fleet serving BERT-base, {FLEET_REPLICAS} replicas behind the router: "
        + "; ".join(f"burst {b} {v['rows_per_s']:.1f} rows/s ({v['rows']} rows in "
                    f"{v['wall_s']:.3f} s), p50 {v['latency_s']['p50']:.4f} s, p99 "
                    f"{v['latency_s']['p99']:.4f} s" for b, v in enumerate(fleet["bursts"]))
        + f" (replica 1 SIGKILLed in burst 0, replica 0 drained in burst 1); recovery "
        f"{fleet['recovery_s']:.3f} s after the kill, {fleet['drain_recovery_s']:.3f} s after "
        f"the drain; router redrives {fleet['redrives']}; fleet start {fleet['start_s']:.1f} s, "
        f"leg {fleet['leg_s']:.1f} s")
    log(f"# total: {time.perf_counter() - t0:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(gpu_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--fleet-replica"]:
        sys.exit(fleet_replica_main())
    if sys.argv[1:2] == ["--sharded-rank"]:
        sys.exit(sharded_rank_main())
    if sys.argv[1:2] == ["--mp-rank"]:
        sys.exit(mp_rank_main())
    sys.exit(infra_warm_main() if sys.argv[1:2] == ["--infra-warm"] else main())
