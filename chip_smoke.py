#!/usr/bin/env python3
"""Chip smoke for tensorframes_tpu_torch: build the CUDA kernels, hold each
against its plain PyTorch version on the card, then drive the five verbs
through the package's entry points at full size on one GPU.

    python3 chip_smoke.py

Needs one CUDA GPU and ``nvcc`` (the kernels build on first use into
``build/torch_kernels/``). Exits nonzero, printing no result, when no GPU
is visible or when the package is not beside this script. Phases:

1. kernels against their plain versions at the main path's shapes:
   ``segment_reduce`` (10M rows, 4096 groups: f32 sum and mean, f32 [n, 8]
   max, int32 sum), ``segment_sum`` (f32 [10M, 8]) and ``ragged_gather``
   (200,000 rows of lengths 16/32/64/128, bit-exact); median times from
   CUDA events for the kernel, the plain version and one PyTorch library
   call per (column, op) (``index_add_``/``scatter_reduce``, or
   ``index_select`` on an unfolded view for the gather);
2. the main path with every launch count reset first: add-3
   ``map_blocks`` over 20M float64 rows, ``reduce_blocks`` sum/min over
   ``double[?,2]`` (10M rows), ``map_rows`` on fixed and ragged cells,
   full-width logreg scoring (262,144 × 784) and an aggregate of its
   scores by predicted label, the 10M-row aggregate above, and an
   aggregate mixing float32 and int64 sums (the per-op route). Each output
   is checked; every kernel must have launched. Rows/s per verb follow.
3. where the time goes: ``torch.profiler`` device time by kernel for
   each segment kernel alone and for two verbs (aggregate, map_blocks),
   with the device's busy share of each call's host wall time;
4. one JSON line listing every kernel, the card's name and power limit,
   and as the last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median wall time of ``fn`` on the card, from CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(nbytes: int) -> float:
    return nbytes / H100_BYTES_PER_S * 1e3


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
    ops = (("v_sum", "reduce_sum"), ("v_mean", "reduce_mean"),
           ("w", "reduce_max"), ("c", "reduce_sum"))
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
        "ms": time_ms(lambda: ksr.segment_reduce(ops, groups, cols, ids)),
        "plain_ms": time_ms(lambda: ksr.segment_reduce_plain(ops, groups, cols, ids)),
        "library_ms": time_ms(library),
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
        "ms": time_ms(lambda: seg.segment_sum_kernel(w, ids, groups)),
        "plain_ms": time_ms(lambda: seg.segment_sum_plain(w, ids, groups)),
        "library_ms": time_ms(
            lambda: torch.zeros((groups, 8), device=dev).index_add_(0, idx, w)),
        "bound_ms": bound_ms(nbytes),
        "bound_by": "bytes",
    }


def ragged_cells(n_rows: int):
    import numpy as np

    rng = np.random.default_rng(SEED)
    lens = rng.choice(np.array([16, 32, 64, 128]), size=n_rows)
    flat = rng.standard_normal(int(lens.sum()), dtype=np.float32)
    starts = np.zeros(n_rows, np.int64)
    np.cumsum(lens[:-1], out=starts[1:])
    return lens, starts, flat


def check_ragged_gather(dev, n_rows: int) -> dict:
    """The main path's gathers: one per length group, bucket-padded."""
    import numpy as np
    import torch
    from tensorframes_tpu_torch.kernels import ragged_gather as krg
    from tensorframes_tpu_torch.ops.executor import bucket_rows

    lens, starts, flat = ragged_cells(n_rows)
    flat_dev = torch.from_numpy(flat).to(dev)
    groups = []
    for L in np.unique(lens):
        idx = np.flatnonzero(lens == L)
        st = np.zeros(bucket_rows(len(idx)), np.int32)
        st[:len(idx)] = starts[idx]
        groups.append((int(L), torch.from_numpy(st).to(dev)))
    err = 0.0
    for L, st in groups:
        got, plain = krg.ragged_gather_rows(flat_dev, st, L), krg.gather_plain(flat_dev, st, L)
        exact(got, plain, f"ragged_gather length {L}")
        err = max(err, float((got.double() - plain.double()).abs().max()))

    def run(fn):
        return lambda: [fn(flat_dev, st, L) for L, st in groups]

    def library(flat_t, st, L):
        return flat_t.unfold(0, L, 1).index_select(0, st.long())

    out_bytes = sum(int(st.shape[0]) * L * 4 for L, st in groups)
    nbytes = 2 * out_bytes + sum(int(st.shape[0]) * 4 for _, st in groups)
    return {
        "max_abs_err": err,
        "ms": time_ms(run(krg.ragged_gather_rows)),
        "plain_ms": time_ms(run(krg.gather_plain)),
        "library_ms": time_ms(run(library)),
        "bound_ms": bound_ms(nbytes),
        "bound_by": "bytes",
    }


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
    lens, starts, flat = ragged_cells(200_000)
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
    device = {
        ev.key: ev.device_time_total / reps / 1e3
        for ev in prof.key_averages()
        if ev.device_type == torch.autograd.DeviceType.CUDA and ev.device_time_total > 0
    }
    return wall / reps * 1e3, device


def where_the_time_goes(tft, dev) -> None:
    """Profile each segment kernel alone (its passes) and two verbs of
    the main path (the device's busy share of the verb's wall time)."""
    import numpy as np
    from tensorframes_tpu_torch.kernels import segment_reduce as ksr
    from tensorframes_tpu_torch.ops import segment as seg

    n, groups = 10_000_000, 4096
    ids, v, w, c = segment_inputs(n, groups, dev)
    ops = (("v_sum", "reduce_sum"), ("v_mean", "reduce_mean"),
           ("w", "reduce_max"), ("c", "reduce_sum"))
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
    for line in tft.kernels.BUILD_LOG.read_text().splitlines() if tft.kernels.BUILD_LOG.exists() else []:
        if "registers" in line or "spill" in line or "rc " in line:
            log(f"# nvcc | {line.strip()}")

    results = {
        "segment_reduce": check_segment_reduce(dev, 10_000_000, 4096),
        "segment_sum": check_segment_sum(dev, 10_000_000, 4096),
        "ragged_gather": check_ragged_gather(dev, 200_000),
    }
    for name, r in results.items():
        log(f"# kernel {name}: {json.dumps(r)}")

    t1 = time.perf_counter()
    path = main_path(tft, dev)
    log(f"# main path: {time.perf_counter() - t1:.1f} s")
    for name, r in sorted(path["verbs"].items()):
        log(f"# verb {name}: {r['rows_per_s']:.0f} rows/s ({r['rows']} rows, "
            f"{r['calls']} calls, {r['seconds']:.4f} s)")
    missing = [k for k, n in path["launches"].items() if n <= 0]
    if missing:
        fail(f"kernels never launched on the main path: {missing}")

    where_the_time_goes(tft, dev)

    kernels = []
    for name, info in tft.kernels.KERNELS.items():
        kernels.append({
            "name": name, "route": "cuda", "source": info.source,
            "replaces": info.replaces, "launches": path["launches"][name],
            **results[name],
        })
    log(json.dumps({"kernels": kernels}))
    log(gpu_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
