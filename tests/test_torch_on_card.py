"""The PyTorch port's CUDA kernels against their plain versions on the card.

Every test here is marked ``cuda`` and skips where
``torch.cuda.is_available()`` is false. The file imports neither JAX nor
the JAX package, so on a machine with an NVIDIA GPU it runs without
them::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_on_card.py

Tolerances: exact for integer sums (i32 wraparound included), counts,
min/max and the gather; float32 sums rtol 1e-5 / atol 1e-5·max|v|·√n for
a segment of n rows, because the kernel sums in another order than the
plain version, and means that atol over n; bfloat16 rtol 1e-2. The int8
matmul and the decode attention differ from their plain versions only in
the order of f32 sums, so a bf16 output may land one bf16 step (2^-8
relative) away: |got - want| <= 2^-7·|want| + 1e-3·max|want|; in f32,
rtol 1e-5 / atol 1e-5·max|want|. Decode tokens are exact where both
sides run the same code (batched against solo). Flash attention differs
from its plain version in the order of f32 sums and in taking p against
the running max before rounding it to bf16: each side's p rounds by at
most half a bf16 step, so the outputs differ by at most a step of A, the
same attention over |v|, plus a step of |want| where the f32 sums round
apart: |got - want| <= 2^-7·(|want| + A) in bf16 (twice that), 1e-5·(|want|
+ A) in f32.
The vmap rules launch one kernel for the whole vmapped batch, with the
same bits as the un-vmapped call. The flash backward kernels differ from
their plain versions in the order of f32 sums, so each side may round p
and dS to a neighbouring bf16 value (up to 2^-8 of it each): a gradient
moves by at most 2^-7 of A, the same sums over absolute values
(``kfa.flash_attention_bwd_bound``), and its own rounding by 2^-7 of
|want|; the tests allow twice that, |got - want| <= 2^-6·(|want| + A) in
bf16, and 1e-5·(|want| + A) in f32. The tensor-core build sums dP = dO·vᵀ
in the mma's own order, which moves dS by an amount A cannot hold where
dP − di cancels: it is held to 2^-6·(|want| + A) + E, E the term of that
order (``kfa.flash_attention_bwd_order_bound``); the scalar build, whose
order is the plain version's, to A alone. Two launches give the same
bits, and prefetched batches arrive bit for bit.
"""

import numpy as np
import pytest
import torch

import tensorframes_tpu_torch as tft
from tensorframes_tpu_torch.kernels import ragged_gather as krg
from tensorframes_tpu_torch.kernels import segment_reduce as ksr
from tensorframes_tpu_torch.kernels import decode_attention as kda
from tensorframes_tpu_torch.kernels import flash_attention as kfa
from tensorframes_tpu_torch.models import generation as tgen
from tensorframes_tpu_torch.models import transformer as ttr
from tensorframes_tpu_torch.ops import quantize as tq
from tensorframes_tpu_torch import io as tio
from tensorframes_tpu_torch.ops import segment as tseg

pytestmark = pytest.mark.cuda

_DTYPES = ("float32", "bfloat16", "int8", "int16", "int32", "uint8", "bool")
_OPS = ("reduce_sum", "reduce_mean", "reduce_min", "reduce_max")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda", 0)


def _values(rng, name, shape, device) -> torch.Tensor:
    """Seeded values of dtype ``name`` on ``device`` (bfloat16 rounds from
    float32 on the torch side)."""
    if name in ("float32", "bfloat16"):
        v = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        return v.to(device=device, dtype=getattr(torch, name))
    if name == "bool":
        return torch.from_numpy(rng.integers(0, 2, shape).astype(bool)).to(device)
    if name == "int32":  # large magnitudes so the i32 sums wrap
        return torch.from_numpy(rng.integers(-(2**30), 2**30, shape).astype(np.int32)).to(device)
    info = np.iinfo(name)
    return torch.from_numpy(rng.integers(info.min, int(info.max) + 1, shape).astype(name)).to(device)


def _float_close(got, want, rtol, vmax, counts, mean):
    """|got - want| <= rtol·|want| + atol per segment, atol = 1e-5·vmax·√n
    for a sum of n rows and that over n for a mean."""
    n = counts.double().clamp(min=1).reshape(-1, *([1] * (want.ndim - 1)))
    atol = 1e-5 * vmax * (n.rsqrt() if mean else n.sqrt())
    diff = (got.double() - want.double()).abs()
    assert bool((diff <= rtol * want.double().abs() + atol).all()), float(diff.max())


@pytest.mark.parametrize("name", _DTYPES)
def test_segment_reduce_kernel_matches_plain_on_card(cuda_device, name):
    n, s = 50_000, 300
    rng = np.random.default_rng(3)
    ids = torch.from_numpy(rng.permutation(np.arange(n) % s).astype(np.int32)).to(cuda_device)
    cols = {op: _values(rng, name, (n, 2), cuda_device) for op in _OPS}
    cols["reduce_sum_1d"] = _values(rng, name, (n,), cuda_device)
    ops = tuple((op, op) for op in _OPS) + (("reduce_sum_1d", "reduce_sum"),)
    got = ksr.segment_reduce(ops, s, cols, ids)
    want = ksr.segment_reduce_plain(ops, s, cols, ids)
    again = ksr.segment_reduce(ops, s, cols, ids)
    counts = torch.bincount(ids.long(), minlength=s)
    for key, op in ops:
        assert torch.equal(got[key], again[key]), f"{key}: not deterministic"
        assert got[key].dtype == want[key].dtype and got[key].shape == want[key].shape, key
        if op in ("reduce_min", "reduce_max") or name not in ("float32", "bfloat16"):
            assert torch.equal(got[key], want[key]), key
        else:
            _float_close(got[key], want[key], 1e-5 if name == "float32" else 1e-2,
                         float(cols[key].float().abs().max()), counts, op == "reduce_mean")


def test_segment_reduce_kernel_counts_exact_on_card(cuda_device):
    """The count lane that divides the means equals the rows per segment,
    empty segments (ids skip 7) included."""
    rng = np.random.default_rng(5)
    ids_np = rng.integers(0, 4096, 300_000).astype(np.int32)
    ids_np[ids_np == 7] = 8
    ids = torch.from_numpy(ids_np).to(cuda_device)
    cols = {"v": torch.from_numpy(rng.standard_normal(len(ids_np)).astype(np.float32)).to(cuda_device)}
    _, counts = ksr.segment_reduce_tables((("v", "reduce_mean"),), 4096, cols, ids)
    assert counts.dtype == torch.int32
    want = torch.bincount(ids.long(), minlength=4096).to(torch.int32)
    assert torch.equal(counts, want) and int(counts[7]) == 0


def test_segment_reduce_kernel_empty_segments_on_card(cuda_device):
    """Segments no row lands in read the identities: 0 sums, NaN float
    means, dtype extremes for min/max."""
    ids = torch.tensor([0, 0, 2], dtype=torch.int32, device=cuda_device)
    cols = {
        "m": torch.tensor([1.0, 3.0, 5.0], device=cuda_device),
        "s": torch.tensor([1, 2, 3], dtype=torch.int32, device=cuda_device),
        "lo": torch.tensor([4, 5, 6], dtype=torch.int8, device=cuda_device),
        "hi": torch.tensor([1.5, -2.0, 3.0], device=cuda_device),
    }
    ops = (("m", "reduce_mean"), ("s", "reduce_sum"), ("lo", "reduce_min"), ("hi", "reduce_max"))
    got = ksr.segment_reduce(ops, 5, cols, ids)
    want = ksr.segment_reduce_plain(ops, 5, cols, ids)
    for key, _ in ops:
        torch.testing.assert_close(got[key], want[key], rtol=0, atol=0, equal_nan=True)
    assert int(got["lo"][1]) == 127 and float(got["hi"][1]) == float("-inf")


def test_segment_sum_kernel_matches_plain_on_card(cuda_device):
    rng = np.random.default_rng(4)
    n, s = 100_000, 4096
    ids = torch.from_numpy(rng.integers(0, s, n).astype(np.int32)).to(cuda_device)
    for dtype in (torch.float32, torch.bfloat16):
        v = torch.from_numpy(rng.standard_normal((n, 8)).astype(np.float32)).to(cuda_device, dtype)
        got = tseg.segment_sum_kernel(v, ids, s)
        assert torch.equal(got, tseg.segment_sum_kernel(v, ids, s)), "not deterministic"
        want = tseg.segment_sum_plain(v, ids, s)
        _float_close(got.float(), want.float(), 1e-5 if dtype == torch.float32 else 1e-2,
                     float(v.float().abs().max()), torch.bincount(ids.long(), minlength=s), False)


def _segment_case(rng, n, s, device, ids=None):
    """Seeded ids (uniform over ``[0, s)`` unless given) and the feed every
    segment test below folds: f32 sum and mean, an f32 [n, 8] max, a bf16
    [n, 3] sum, an int32 sum and an int8 min."""
    if ids is None:
        ids = rng.integers(0, s, n).astype(np.int32)
    cols = {"v_sum": _values(rng, "float32", (n,), device),
            "v_mean": _values(rng, "float32", (n,), device),
            "w": _values(rng, "float32", (n, 8), device),
            "h": _values(rng, "bfloat16", (n, 3), device),
            "c": _values(rng, "int32", (n,), device),
            "b": _values(rng, "int8", (n, 2), device)}
    ops = (("v_sum", "reduce_sum"), ("v_mean", "reduce_mean"), ("w", "reduce_max"),
           ("h", "reduce_sum"), ("c", "reduce_sum"), ("b", "reduce_min"))
    return torch.from_numpy(ids).to(device), cols, ops


def _f64_sums(v, ids, s):
    """Float sums by segment in float64: the reference for f32/bf16 sums and
    means. The plain versions add in f32 into one accumulator per segment,
    which over millions of rows of one key drifts past the tolerance by
    itself."""
    v = v.double().reshape(v.shape[0], -1)
    return torch.zeros((s, v.shape[1]), dtype=torch.float64, device=v.device).index_add_(
        0, ids.long(), v)


def _check_segment_kernels(ids, cols, ops, s):
    """Both kernels against their plain versions on the rows whose ids lie
    in ``[0, s)`` (the kernels drop the others) — exact for min/max, integer
    sums and counts, float sums and means within the tolerance of the f64
    sums — their float sums against the kernel-order emulation bit for bit,
    and a relaunch bit for bit."""
    keep = (ids >= 0) & (ids < s)
    kept = {k: v[keep] for k, v in cols.items()}
    got = ksr.segment_reduce(ops, s, cols, ids)
    again = ksr.segment_reduce(ops, s, cols, ids)
    want = ksr.segment_reduce_plain(ops, s, kept, ids[keep])
    raw, counts = ksr.segment_reduce_tables(ops, s, cols, ids)
    n = int(ids.shape[0])
    lanes = 1 + 1 + 8 + 3 + 1 + 2 + 1
    chunks = ksr.num_chunks(n, s, lanes)
    bins = torch.bincount(ids[keep].long(), minlength=s)
    assert torch.equal(counts, bins.to(torch.int32))
    for key, op in ops:  # (a mean of an empty segment is NaN on both launches)
        torch.testing.assert_close(got[key], again[key], rtol=0, atol=0, equal_nan=True)
        if op in ("reduce_sum", "reduce_mean") and cols[key].dtype in (torch.float32,
                                                                       torch.bfloat16):
            order = ksr.segment_sum_in_kernel_order(cols[key], ids, s, chunks)
            assert torch.equal(raw[key].cpu(), order), f"{key}: not the kernel's order"
            rtol = 1e-5 if cols[key].dtype == torch.float32 else 1e-2
            ref = _f64_sums(kept[key], ids[keep], s)
            if op == "reduce_mean":
                ref = ref / bins[:, None]
            ref = ref.reshape(want[key].shape)
            seen = bins > 0  # a mean of no rows is NaN on both sides
            assert torch.equal(got[key][~seen].isnan(), want[key][~seen].isnan()), key
            _float_close(got[key][seen], ref[seen], rtol,
                         float(cols[key].float().abs().max()), bins[seen], op == "reduce_mean")
        else:
            torch.testing.assert_close(got[key], want[key], rtol=0, atol=0, equal_nan=True)
    w = cols["w"]
    got = tseg.segment_sum_kernel(w, ids, s)
    assert torch.equal(got, tseg.segment_sum_kernel(w, ids, s)), "segment_sum: not deterministic"
    order = ksr.segment_sum_in_kernel_order(w, ids, s, ksr.num_chunks(n, s, 8))
    assert torch.equal(got.cpu(), order), "segment_sum: not the kernel's order"
    _float_close(got, _f64_sums(w[keep], ids[keep], s), 1e-5, float(w.abs().max()), bins, False)


@pytest.mark.parametrize("n", [1, 15, 17, 100, 1025, 2049, 4097, 270_337])
def test_segment_kernels_edge_row_counts_on_card(cuda_device, n):
    """One row; fewer rows than a tile; one row past the 1,024-row tile, the
    2,048-row chunk and a multiple of 16 (the last tile then reads device
    memory directly instead of the staged copy)."""
    rng = np.random.default_rng(n)
    _check_segment_kernels(*_segment_case(rng, n, 37, cuda_device), 37)


def test_segment_kernels_ids_outside_range_on_card(cuda_device):
    """Ids below 0 or at/after S match nothing, in sums, min/max and counts."""
    rng = np.random.default_rng(11)
    n, s = 70_000, 300
    ids = rng.integers(-20, s + 20, n).astype(np.int32)
    _check_segment_kernels(*_segment_case(rng, n, s, cuda_device, ids), s)


def test_segment_kernels_skewed_key_on_card(cuda_device):
    """One key holds half of 10M rows (the others uniform over 4,096): one
    warp owns it in every block."""
    rng = np.random.default_rng(12)
    n, s = 10_000_000, 4096
    ids = rng.integers(0, s, n).astype(np.int32)
    ids[rng.random(n) < 0.5] = 1234
    _check_segment_kernels(*_segment_case(rng, n, s, cuda_device, ids), s)


def test_segment_kernels_ten_groups_on_card(cuda_device):
    """The logreg aggregate's shape: [262,144, 10] f32 scores over 10 labels."""
    rng = np.random.default_rng(13)
    n, s = 262_144, 10
    ids = torch.from_numpy(rng.integers(0, s, n).astype(np.int32)).to(cuda_device)
    scores = _values(rng, "float32", (n, 10), cuda_device)
    got = tseg.segment_sum_kernel(scores, ids, s)
    assert torch.equal(got, tseg.segment_sum_kernel(scores, ids, s))
    chunks = ksr.num_chunks(n, s, 10)
    assert torch.equal(got.cpu(), ksr.segment_sum_in_kernel_order(scores, ids, s, chunks))
    bins = torch.bincount(ids.long(), minlength=s)
    _float_close(got, tseg.segment_sum_plain(scores, ids, s), 1e-5,
                 float(scores.abs().max()), bins, False)
    ops = (("scores", "reduce_sum"),)
    raw, _ = ksr.segment_reduce_tables(ops, s, {"scores": scores}, ids)
    assert torch.equal(raw["scores"], got)


@pytest.mark.parametrize("s", [256, 4096])
def test_segment_reduce_wide_feed_on_card(cuda_device, s):
    """16 columns of [n, 64] f32, max and sum in turn: at 256 segments each
    column is a pass of its own (16 lane groups, staged); at 4,096 a table
    holds 8 lanes, so each column runs in 8 slices read straight from
    device memory."""
    rng = np.random.default_rng(s)
    n = 60_001
    ids = torch.from_numpy(rng.integers(0, s, n).astype(np.int32)).to(cuda_device)
    cols = {f"x{i}": _values(rng, "float32", (n, 64), cuda_device) for i in range(16)}
    ops = tuple((f"x{i}", "reduce_max" if i % 2 else "reduce_sum") for i in range(16))
    got = ksr.segment_reduce(ops, s, cols, ids)
    again = ksr.segment_reduce(ops, s, cols, ids)
    want = ksr.segment_reduce_plain(ops, s, cols, ids)
    chunks = ksr.num_chunks(n, s, 16 * 64)
    bins = torch.bincount(ids.long(), minlength=s)
    for key, op in ops:
        assert torch.equal(got[key], again[key]), key
        if op == "reduce_max":
            assert torch.equal(got[key], want[key]), key
        else:
            order = ksr.segment_sum_in_kernel_order(cols[key], ids, s, chunks)
            assert torch.equal(got[key].cpu(), order), key
            _float_close(got[key], want[key], 1e-5, float(cols[key].abs().max()), bins, False)


def test_segment_kernels_unaligned_columns_on_card(cuda_device):
    """Columns and ids whose data starts off a 16-byte boundary are read by
    threads from device memory, in the same order as staged ones."""
    rng = np.random.default_rng(14)
    n, s = 50_000, 500
    ids, cols, ops = _segment_case(rng, n, s, cuda_device)
    shifted = {k: torch.cat([v[:1], v])[1:] for k, v in cols.items()}  # 1-row offset views
    ids_shifted = torch.cat([ids[:1], ids])[1:]
    assert ids_shifted.data_ptr() % 16 != 0 and shifted["b"].data_ptr() % 16 != 0
    _check_segment_kernels(ids_shifted, shifted, ops, s)
    for key, _ in ops:
        a = ksr.segment_reduce(ops, s, cols, ids)[key]
        b = ksr.segment_reduce(ops, s, shifted, ids_shifted)[key]
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


def _gather_groups(lens, starts, pad):
    groups = []
    for L in np.unique(lens):
        st = np.zeros(int((lens == L).sum()) + pad, np.int32)  # pad padding rows
        st[:-pad] = starts[lens == L]
        groups.append((st, int(L)))
    return groups


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.int8, torch.bfloat16,
                                   torch.int16, torch.complex128])
@pytest.mark.parametrize("shift", [0, 1, 3, 8])
def test_gather_kernel_matches_plain_on_card(cuda_device, dtype, shift):
    """Every alignment: lengths 1-256 put row starts at every element
    offset, and the flat buffer itself starts ``shift`` elements into its
    allocation (an int8 buffer at a byte offset, bf16 at 2 bytes, ...).
    Every group of the call in one launch, bit for bit against the plain
    version; padding rows re-read offset 0."""
    rng = np.random.default_rng(2)
    lens = rng.integers(1, 257, 3000)
    starts = np.zeros(len(lens), np.int64)
    np.cumsum(lens[:-1], out=starts[1:])
    base = torch.from_numpy(rng.standard_normal(int(lens.sum()) + shift) * 100)
    flat = base.to(cuda_device, dtype)[shift:]
    groups = _gather_groups(lens, starts, 5)
    tft.kernels.LAUNCHES.reset()
    got = krg.ragged_gather_groups(flat, groups)
    assert tft.kernels.LAUNCHES.snapshot()["ragged_gather"] == 1
    for (st, L), g in zip(groups, got):
        st_t = torch.from_numpy(st).to(cuda_device)
        assert torch.equal(g, krg.gather_plain(flat, st_t, L)), int(L)
        assert torch.equal(g, krg.ragged_gather_rows(flat, st_t, L)), int(L)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64, torch.int8])
@pytest.mark.parametrize("aligned", [True, False])
def test_gather_long_rows_on_card(cuda_device, dtype, aligned):
    """Rows of 1-5 KB, their starts on 16-byte bounds or anywhere, in groups
    that span many blocks; padding rows re-read offset 0. Bit for bit
    against the plain version, in one launch."""
    rng = np.random.default_rng(6)
    es = torch.empty(0, dtype=dtype).element_size()
    step = 16 // es if aligned else 1  # lengths and so starts on 16-byte bounds, or anywhere
    # six lengths, so each group spans many 16 KB blocks
    lens = rng.choice(rng.integers(1024 // es // step, 5000 // es // step, 6) * step, 1500)
    starts = np.zeros(len(lens), np.int64)
    np.cumsum(lens[:-1], out=starts[1:])
    flat = torch.from_numpy(rng.standard_normal(int(lens.sum())) * 100).to(cuda_device, dtype)
    groups = _gather_groups(lens, starts, 3)
    tft.kernels.LAUNCHES.reset()
    got = krg.ragged_gather_groups(flat, groups)
    assert tft.kernels.LAUNCHES.snapshot()["ragged_gather"] == 1
    for (st, L), g in zip(groups, got):
        assert torch.equal(g, krg.gather_plain(flat, torch.from_numpy(st).to(cuda_device), L)), L


def test_gather_launches_follow_the_budget(cuda_device, monkeypatch):
    """Past the launch budget the groups take ceil(padded bytes / budget)
    launches or more (groups are not split), each result unchanged."""
    rng = np.random.default_rng(3)
    lens = rng.integers(1, 200, 4000)
    starts = np.zeros(len(lens), np.int64)
    np.cumsum(lens[:-1], out=starts[1:])
    flat = torch.from_numpy(rng.standard_normal(int(lens.sum())).astype(np.float32)).to(cuda_device)
    groups = _gather_groups(lens, starts, 1)
    want = krg.ragged_gather_groups(flat, groups)
    budget = 64 << 10
    monkeypatch.setattr(krg, "LAUNCH_BUDGET_BYTES", budget)
    padded = sum(-(-len(st) * L * 4 // 16) * 16 for st, L in groups)
    tft.kernels.LAUNCHES.reset()
    got = krg.ragged_gather_groups(flat, groups)
    n = tft.kernels.LAUNCHES.snapshot()["ragged_gather"]
    assert n == len(krg.launch_groups([(len(st), L) for st, L in groups], 4))
    assert n >= -(-padded // budget) > 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_ragged_map_rows_launches_the_gather_once(cuda_device):
    """A ragged ``map_rows`` over many lengths gathers every group in one
    launch, and its results equal the CPU run's."""
    rng = np.random.default_rng(4)
    rows = [{"r": rng.standard_normal(int(m)).astype(np.float32)} for m in rng.integers(1, 90, 3000)]
    out = {}
    for device in (cuda_device, "cpu"):
        tft.kernels.LAUNCHES.reset()
        df = tft.frame_from_rows(rows, num_blocks=1)
        with tft.with_graph():
            r = tft.placeholder(np.float32, (None,), name="r")
            out[str(device)] = tft.map_rows(tft.reduce_max(r, name="m"), df,
                                            device=device).column_values("m")
        if device != "cpu":
            assert tft.kernels.LAUNCHES.snapshot()["ragged_gather"] == 1
    np.testing.assert_array_equal(out[str(cuda_device)], out["cpu"])


def test_slice_on_card_launches_every_kernel(cuda_device):
    tft.kernels.LAUNCHES.reset()
    rng = np.random.default_rng(0)
    n = 20_000
    df = tft.frame_from_arrays({
        "k": rng.integers(0, 50, n), "v": rng.standard_normal(n).astype(np.float32),
        "i": rng.integers(0, 9, n),
    })
    with tft.with_graph():
        one = tft.aggregate(tft.reduce_sum(tft.block(df, "v", tf_name="v_input"), name="v"),
                            df.group_by("k"), device=cuda_device)
    with tft.with_graph():
        two = tft.aggregate([tft.reduce_sum(tft.block(df, "v", tf_name="v_input"), name="v"),
                             tft.reduce_sum(tft.block(df, "i", tf_name="i_input"), name="i")],
                            df.group_by("k"), device=cuda_device)
    want_i = np.zeros(50, np.int64)
    np.add.at(want_i, df.column_values("k"), df.column_values("i"))
    np.testing.assert_array_equal(two.column_values("i"), want_i)
    np.testing.assert_array_equal(one.column_values("v"), two.column_values("v"))
    rows = [{"r": rng.standard_normal(int(m))} for m in rng.integers(1, 6, 200)]
    rf = tft.frame_from_rows(rows)
    with tft.with_graph():
        out = tft.map_rows(tft.reduce_sum(tft.placeholder(np.float64, (None,), name="r"),
                                          name="s"), rf, device=cuda_device)
    np.testing.assert_allclose(out.column_values("s"), [r["r"].sum() for r in rows], rtol=1e-12)
    launches = tft.kernels.LAUNCHES.snapshot()
    assert all(launches[k] > 0 for k in ("segment_reduce", "segment_sum", "ragged_gather"))


def _assert_kernel_close(got, want, dtype):
    """The kernel/plain tolerance of the module docstring."""
    got, want = got.double(), want.double()
    scale = float(want.abs().max())
    if dtype == torch.bfloat16:
        tol = 2.0 ** -7 * want.abs() + 1e-3 * scale
    else:
        tol = 1e-5 * want.abs() + 1e-5 * scale
    diff = (got - want).abs()
    assert bool((diff <= tol).all()), float(diff.max())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k,n", [(1, 768, 2304), (16, 768, 768), (128, 3072, 768),
                                   (37, 100, 72), (5, 64, 30),
                                   # the tensor-core build's edges: k not a multiple of
                                   # its chunk, n not of its 32-wide tile, m past 64
                                   (16, 776, 96), (9, 1000, 304), (130, 776, 48)])
def test_int8_matmul_kernel_matches_plain_on_card(cuda_device, dtype, m, k, n):
    """Ragged m, k and n (the kernels mask their own edges), each through
    the build ``int8_matmul_build`` chooses: bf16 with k % 8 == 0 and n %
    16 == 0 on the tensor cores; k = 100, n = 30 and f32 on the scalar
    kernel (n = 30 takes its byte path for the weight tile). Two launches
    give the same bits."""
    rng = np.random.default_rng(m + k + n)
    w = tq.quantize(torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32)))
    w = w.to(cuda_device)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(cuda_device, dtype)
    want = "mma" if dtype == torch.bfloat16 and (k, n) not in ((100, 72), (64, 30)) else "scalar"
    assert tq.int8_matmul_build(x, w) == want
    tft.kernels.LAUNCHES.reset()
    got = tq.matmul_int8(x, w)
    assert tft.kernels.LAUNCHES.snapshot()["int8_matmul"] == 1
    assert tft.kernels.LAUNCHES.builds()["int8_matmul_mma"] == (want == "mma")
    assert got.dtype == dtype and got.shape == (m, n)
    assert torch.equal(tq.matmul_int8(x, w), got)
    _assert_kernel_close(got, tq.matmul_int8_plain(x, w), dtype)


def test_int8_matmul_rows_do_not_depend_on_the_batch_on_card(cuda_device):
    """On the tensor-core build, at each of gpt_small's four (k, n): a
    row's bits are the same alone, among 15 others and among 127 others."""
    rng = np.random.default_rng(9)
    for k, n in ((768, 2304), (768, 768), (768, 3072), (3072, 768)):
        w = tq.quantize(torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32)))
        w = w.to(cuda_device)
        x = torch.from_numpy(rng.standard_normal((128, k)).astype(np.float32)).to(
            cuda_device, torch.bfloat16)
        tft.kernels.LAUNCHES.reset()
        full = tq.matmul_int8(x, w)
        for r in (0, 7, 77, 127):
            assert torch.equal(tq.matmul_int8(x[r:r + 1], w), full[r:r + 1]), (k, n, r)
            assert torch.equal(tq.matmul_int8(x[r:r + 16], w)[0], full[r]), (k, n, r)
        assert tft.kernels.LAUNCHES.builds()["int8_matmul_mma"] == 9, (k, n)


def _paged_inputs(rng, S, P, L, nh, page, hd, maxp, device, dtype):
    kp = torch.from_numpy(rng.integers(-127, 128, (P, L, nh, page, hd)).astype(np.int8))
    vp = torch.from_numpy(rng.integers(-127, 128, (P, L, nh, page, hd)).astype(np.int8))
    ks = torch.from_numpy(rng.uniform(0.001, 0.02, (P, L, nh, page, 1)).astype(np.float32))
    vs = torch.from_numpy(rng.uniform(0.001, 0.02, (P, L, nh, page, 1)).astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((S, nh, hd)).astype(np.float32))
    pos = rng.integers(0, maxp * page, S).astype(np.int32)
    tables = np.zeros((S, maxp), np.int32)
    for s in range(S):
        n = pos[s] // page + 1
        tables[s, :n] = rng.choice(np.arange(1, P), n, replace=False)
    pos[-1], tables[-1] = 0, 0  # a padding slot: null table, position 0
    return [t.to(device) for t in (q.to(dtype), kp, vp, ks, vs)] + [
        torch.from_numpy(tables).to(device), torch.from_numpy(pos).to(device)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("S,nh,page,hd,maxp", [(1, 12, 16, 64, 12), (16, 12, 16, 64, 12),
                                               (5, 4, 8, 8, 6), (3, 2, 4, 128, 3),
                                               # contexts past the 256-position staging
                                               (4, 4, 16, 64, 64), (3, 2, 16, 128, 40)])
def test_decode_attention_kernel_matches_plain_on_card(cuda_device, dtype, S, nh, page, hd,
                                                       maxp):
    rng = np.random.default_rng(S * 100 + hd)
    q, kp, vp, ks, vs, tables, pos = _paged_inputs(rng, S, max(40, maxp + 8), 3, nh, page, hd,
                                                   maxp, cuda_device, dtype)
    tft.kernels.LAUNCHES.reset()
    got = kda.paged_decode_attention(q, kp, vp, ks, vs, 1, tables, pos)
    assert tft.kernels.LAUNCHES.snapshot()["decode_attention"] == 1
    want = kda.paged_attention_reference(q, kp, vp, ks, vs, 1, tables, pos)
    assert got.dtype == dtype and got.shape == q.shape
    _assert_kernel_close(got, want, dtype)
    assert torch.equal(kda.paged_decode_attention(q, kp, vp, ks, vs, 1, tables, pos), got)
    # a slot's context is the same alone and in the batch
    for s in range(S):
        alone = kda.paged_decode_attention(q[s:s + 1], kp, vp, ks, vs, 1, tables[s:s + 1],
                                           pos[s:s + 1])
        assert torch.equal(alone[0], got[s]), s


def test_decode_engine_on_card_batched_equals_solo(cuda_device):
    """A small bf16 model through the engine on the card: every decode
    step launches the attention kernel once per layer, every weight
    product the int8 kernel, and batched tokens equal solo tokens."""
    from tensorframes_tpu_torch.serving import DecodeConfig, DecodeEngine

    cfg = tgen.gpt_small(num_layers=2, vocab_size=512, max_seq_len=128)
    params = ttr.quantize_params(ttr.init_params(cfg, seed=0, device=cuda_device))
    eng = DecodeEngine("card", cfg, params, DecodeConfig(
        max_slots=4, page_size=16, max_prompt_len=32, max_new_tokens=16), device=cuda_device)
    eng.start()
    try:
        rng = np.random.default_rng(1)
        prompts = [rng.integers(0, 512, int(rng.integers(4, 33))).astype(np.int32)
                   for _ in range(6)]
        tft.kernels.LAUNCHES.reset()
        futs = [eng.submit({"prompt": p}) for p in prompts]
        batched = [f.result(300)["tokens"] for f in futs]
        launches = tft.kernels.LAUNCHES.snapshot()
        solo = [eng.call({"prompt": p}, timeout=300)["tokens"] for p in prompts]
    finally:
        eng.stop(drain=True, timeout=300)
    assert launches["decode_attention"] > 0 and launches["int8_matmul"] > 0
    assert launches["decode_attention"] % 2 == 0 and launches["int8_matmul"] % 8 == 0
    for b, s in zip(batched, solo):
        np.testing.assert_array_equal(b, s)


def _assert_flash_close(got, want, bound, dtype):
    """The flash tolerance of the module docstring; ``bound`` is the same
    attention over |v|."""
    got, want = got.double(), want.double()
    rtol = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
    diff = (got - want).abs()
    assert bool((diff <= rtol * (want.abs() + bound.double())).all()), float(diff.max())


@pytest.mark.parametrize("shape,sk,dtype,causal,layout,build", [
    ((1024, 12, 128, 64), None, torch.bfloat16, False, "views", "mma"),  # BERT-base map_rows, views
    ((4, 8, 4096, 128), None, torch.bfloat16, True, "dense", "mma"),    # the attention bench
    ((3, 4, 200, 64), None, torch.float32, True, "dense", "scalar"),    # tile edges
    ((2, 3, 77, 40), None, torch.bfloat16, True, "dense", "mma"),
    ((2, 2, 100, 128), None, torch.float32, False, "views", "scalar"),
    ((1, 1, 1, 8), None, torch.float32, True, "dense", "scalar"),
    # the tensor-core build's edges: head_dims padded to 64 or 128, ragged
    # last tiles, sq != sk, one row or one key
    ((2, 4, 150, 32), None, torch.bfloat16, False, "dense", "mma"),
    ((2, 4, 333, 80), None, torch.bfloat16, True, "views", "mma"),
    ((2, 4, 200, 96), None, torch.bfloat16, False, "views", "mma"),
    ((3, 2, 100, 128), None, torch.bfloat16, False, "dense", "mma"),
    ((3, 2, 100, 128), None, torch.bfloat16, True, "views", "mma"),
    ((2, 3, 70, 64), 190, torch.bfloat16, False, "dense", "mma"),
    ((2, 3, 190, 64), 70, torch.bfloat16, True, "dense", "mma"),
    ((4, 2, 1, 64), None, torch.bfloat16, True, "dense", "mma"),
    ((4, 2, 1, 64), 100, torch.bfloat16, False, "dense", "mma"),
    ((2, 3, 64, 64), 1, torch.bfloat16, False, "dense", "mma"),
    ((1, 2, 8, 8), None, torch.bfloat16, True, "dense", "mma"),
    # bf16 the tensor-core build cannot copy 16 bytes at a time: the scalar one
    ((2, 3, 77, 36), None, torch.bfloat16, True, "dense", "scalar"),
    ((2, 3, 77, 64), None, torch.bfloat16, False, "offset", "scalar"),
])
def test_flash_attention_kernel_matches_plain_on_card(cuda_device, shape, sk, dtype, causal,
                                                      layout, build):
    b, h, s, d = shape
    sk = s if sk is None else sk
    rng = np.random.default_rng(s + d + 7 * sk)
    if layout == "offset":  # every row one element past a 16-byte boundary
        q, k, v = (torch.from_numpy(rng.standard_normal(int(np.prod(x)) + 1).astype(np.float32))
                   .to(cuda_device, dtype)[1:].view(x) for x in (shape, (b, h, sk, d), (b, h, sk, d)))
    elif layout == "views":  # [b, s, 3, h, d] → three [b, h, s, d] views, as the encoder passes them
        assert sk == s
        qkv = torch.from_numpy(rng.standard_normal((b, s, 3, h, d)).astype(np.float32))
        q, k, v = (qkv.to(cuda_device, dtype)[:, :, i].permute(0, 2, 1, 3) for i in range(3))
    else:
        q, k, v = (torch.from_numpy(rng.standard_normal(x).astype(np.float32)).to(
            cuda_device, dtype) for x in (shape, (b, h, sk, d), (b, h, sk, d)))
    assert kfa.forward_build(q, k, v) == build
    tft.kernels.LAUNCHES.reset()
    got = kfa.flash_attention(q, k, v, causal=causal)
    assert tft.kernels.LAUNCHES.snapshot()["flash_attention"] == 1
    assert tft.kernels.LAUNCHES.builds()["flash_attention_mma"] == (build == "mma")
    assert got.dtype == dtype and tuple(got.shape) == shape
    scale = kfa.default_scale(d)
    want = kfa.flash_attention_reference(q, k, v, causal, scale)
    _assert_flash_close(got, want, kfa.flash_attention_reference(q, k, v.abs(), causal, scale),
                        dtype)
    assert torch.equal(kfa.flash_attention(q, k, v, causal=causal), got)  # deterministic
    o, l, m = kfa.flash_attention_fwd(q, k, v, causal, scale)  # the build that keeps l and m
    _, l_want, m_want = kfa.flash_attention_fwd_reference(q, k, v, causal, scale)
    assert torch.equal(o, got)
    assert bool(((l - l_want).abs() <= 1e-5 * l_want.abs()).all())
    assert bool(((m - m_want).abs() <= 1e-5 * m_want.abs().clamp(min=1.0)).all())


def test_flash_attention_kernel_limits_raise_on_card(cuda_device):
    q = torch.zeros((1, 2, 8, 160), device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim <= 128"):
        kfa.flash_attention(q, q, q)
    q = torch.zeros((1, 2, 8, 64), device=cuda_device, dtype=torch.float16)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        kfa.flash_attention(q, q, q)


def test_vmap_rules_launch_once_on_card(cuda_device):
    """``torch.func.vmap`` (under inference mode, as ``map_rows``) of the
    flash op and of ``quantize.matmul`` over a quantized weight: one
    launch each, the same bits as the un-vmapped call."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal((16, 1, 12, 128, 64)).astype(np.float32)).to(
        cuda_device, torch.bfloat16) for _ in range(3))
    w = tq.quantize(torch.from_numpy(rng.standard_normal((768, 2304)).astype(np.float32)))
    w = w.to(cuda_device)
    x = torch.from_numpy(rng.standard_normal((16, 1, 128, 768)).astype(np.float32)).to(
        cuda_device, torch.bfloat16)
    tft.kernels.LAUNCHES.reset()
    with torch.inference_mode():
        att = torch.func.vmap(kfa.flash_attention)(q, k, v)
        mm = torch.func.vmap(lambda r: tq.matmul(r, w))(x)
    launches = tft.kernels.LAUNCHES.snapshot()
    assert launches["flash_attention"] == 1 and launches["int8_matmul"] == 1
    assert torch.equal(att[:, 0], kfa.flash_attention(q[:, 0], k[:, 0], v[:, 0]))
    assert torch.equal(mm, tq.matmul(x, w))


def test_encoder_map_rows_launches_per_layer_on_card(cuda_device):
    """A 2-layer 768-wide bf16 encoder with int8 weights through
    ``map_rows`` and ``map_blocks``: per call, one flash launch and four
    int8 launches per layer, and the two verbs' embeddings agree."""
    cfg = ttr.bert_base(num_layers=2, attention_impl="flash")
    params = ttr.quantize_params(ttr.init_params(cfg, seed=0, device=cuda_device))
    tokens, _ = ttr.synthetic_batch(cfg, 32, 128, seed=0)
    frame = tft.frame_from_arrays({"tokens": tokens}, num_blocks=1)
    prog = tft.compile_program(ttr.embed_row_program(cfg, params), frame, block=False,
                               device=cuda_device)
    tft.kernels.LAUNCHES.reset()
    rows = tft.map_rows(prog, frame, device=cuda_device).column_values("embedding")
    launches = tft.kernels.LAUNCHES.snapshot()
    assert launches["flash_attention"] == 2 and launches["int8_matmul"] == 8
    blocks = tft.map_blocks(ttr.embed_program(cfg, params), frame,
                            device=cuda_device).column_values("embedding")
    assert rows.shape == (32, 768) and np.isfinite(rows).all()
    np.testing.assert_allclose(rows, blocks, rtol=0, atol=1e-2 * np.abs(blocks).max())


def _bwd_case(device, shape, dtype, causal, strided, seed, sk=None, offset=False):
    """q/k/v (views of one ``[b, s, 3, h, d]`` tensor when ``strided``; k
    and v of ``sk`` rows when given; each starting one element past a
    16-byte boundary when ``offset``), dO, and the forward kernel's o, l, m."""
    b, h, s, d = shape
    rng = np.random.default_rng(seed)
    kv = (b, h, sk or s, d)

    def make(sh):
        t = torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
        if not offset:
            return t.to(device, dtype)
        flat = torch.empty(t.numel() + 1, dtype=dtype, device=device)
        return flat[1:].view(sh).copy_(t)

    if strided:
        qkv = torch.from_numpy(rng.standard_normal((b, s, 3, h, d)).astype(np.float32))
        q, k, v = (qkv.to(device, dtype)[:, :, i].permute(0, 2, 1, 3) for i in range(3))
    else:
        q, k, v = make(shape), make(kv), make(kv)
    do = make(shape)
    with torch.no_grad():
        o, l, m = kfa.flash_attention_fwd(q, k, v, causal, kfa.default_scale(d))
    return q, k, v, do, o, l, m


@pytest.mark.parametrize("shape,sk,dtype,causal,strided,offset,build", [
    ((8, 12, 1024, 64), None, torch.bfloat16, True, True, False, "mma"),  # the training path's
    ((2, 3, 77, 40), None, torch.bfloat16, True, False, False, "mma"),    # tile edges, head_dim 40
    ((2, 2, 100, 128), None, torch.float32, False, True, False, "scalar"),
    ((2, 3, 130, 32), None, torch.bfloat16, True, False, False, "mma"),   # head_dim 32
    ((2, 3, 130, 80), None, torch.bfloat16, False, False, False, "mma"),  # 80, ragged, not causal
    ((2, 3, 200, 96), None, torch.bfloat16, True, False, False, "mma"),   # 96, ragged, causal
    ((2, 4, 300, 128), None, torch.bfloat16, True, False, False, "mma"),  # head_dim 128
    ((2, 3, 150, 64), 77, torch.bfloat16, True, False, False, "mma"),     # sq > sk, causal
    ((2, 3, 50, 64), 170, torch.bfloat16, True, False, False, "mma"),     # keys no row sees
    ((2, 3, 77, 64), 150, torch.bfloat16, False, False, False, "mma"),    # sq < sk
    ((3, 2, 1, 64), None, torch.bfloat16, True, False, False, "mma"),     # one row
    ((1, 2, 1, 64), 100, torch.bfloat16, False, False, False, "mma"),     # one row, 100 keys
    ((2, 3, 77, 36), None, torch.bfloat16, True, False, False, "scalar"),  # 72-byte rows
    ((2, 3, 77, 64), None, torch.bfloat16, True, False, True, "scalar"),  # rows off 16 bytes
])
def test_flash_backward_kernels_match_plain_on_card(cuda_device, shape, sk, dtype, causal,
                                                    strided, offset, build):
    q, k, v, do, o, l, m = _bwd_case(cuda_device, shape, dtype, causal, strided,
                                     seed=shape[2], sk=sk, offset=offset)
    scale = kfa.default_scale(shape[-1])
    di = kfa.flash_attention_di(o, do)
    assert kfa.backward_build(q, k, v, do) == build
    tft.kernels.LAUNCHES.reset()
    dk, dv = kfa.flash_attention_bwd_dkv(q, k, v, l, m, do, di, causal, scale)
    dq = kfa.flash_attention_bwd_dq(q, k, v, l, m, do, di, causal, scale)
    launches = tft.kernels.LAUNCHES.snapshot()
    builds = tft.kernels.LAUNCHES.builds()
    n_mma = int(build == "mma")
    assert launches["flash_attention_bwd_dkv"] == 1 and launches["flash_attention_bwd_dq"] == 1
    assert (builds["flash_attention_bwd_dkv_mma"], builds["flash_attention_bwd_dq_mma"]) == (
        n_mma, n_mma)
    want = (kfa.flash_attention_bwd_dq_reference(q, k, v, l, m, do, di, causal, scale),
            *kfa.flash_attention_bwd_dkv_reference(q, k, v, l, m, do, di, causal, scale))
    bound = kfa.flash_attention_bwd_bound(q, k, v, o, l, m, do, causal, scale)
    # the tensor-core build also carries E, the term of dP's summation order
    order = (kfa.flash_attention_bwd_order_bound(q, k, v, l, m, do, causal, scale)
             if build == "mma" else (None,) * 3)
    rtol = 2.0 ** -6 if dtype == torch.bfloat16 else 1e-5
    for got, w, a, e in zip((dq, dk, dv), want, bound, order):
        assert got.dtype == dtype and got.shape == w.shape
        diff = (got.double() - w.double()).abs()
        tol = rtol * (w.double().abs() + a.double())
        if e is not None:
            tol = tol + e.double()
        assert bool((diff <= tol).all()), float(diff.max())
    # deterministic: no float atomics, every sum in a fixed order
    dk2, dv2 = kfa.flash_attention_bwd_dkv(q, k, v, l, m, do, di, causal, scale)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)
    assert torch.equal(dq, kfa.flash_attention_bwd_dq(q, k, v, l, m, do, di, causal, scale))


def test_flash_gradient_launches_both_kernels_on_card(cuda_device):
    """``torch.autograd.grad`` through ``flash_attention`` on the card: one
    forward (with l and m, the o bits of the forward without them), one
    dK/dV and one dQ launch, all three on their tensor-core builds, and the
    kernels' own results."""
    shape = (2, 4, 200, 64)
    q, k, v, do, o, l, m = _bwd_case(cuda_device, shape, torch.bfloat16, True, True, seed=9)
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    tft.kernels.LAUNCHES.reset()
    out = kfa.flash_attention(*leaves, causal=True)
    grads = torch.autograd.grad(out, leaves, do)
    launches = {**tft.kernels.LAUNCHES.snapshot(), **tft.kernels.LAUNCHES.builds()}
    assert (launches["flash_attention"], launches["flash_attention_bwd_dkv"],
            launches["flash_attention_bwd_dq"]) == (1, 1, 1)
    assert (launches["flash_attention_mma"], launches["flash_attention_bwd_dkv_mma"],
            launches["flash_attention_bwd_dq_mma"]) == (1, 1, 1)
    assert torch.equal(out.detach(), o)
    want = kfa.flash_attention_backward(q, k, v, o, l, m, do, True, kfa.default_scale(64))
    assert all(torch.equal(g, w) for g, w in zip(grads, want))


def test_prefetch_delivers_batches_bit_for_bit_on_card(cuda_device):
    """Batches staged on a side stream arrive as ``iterate_batches`` gives
    them, though the consumer's stream is busy when each is handed over
    and the staged memory is freed while the consumer still reads it."""
    rng = np.random.default_rng(11)
    frame = tft.frame_from_arrays({
        "x": rng.standard_normal((64, 1 << 16)).astype(np.float32),
        "t": rng.integers(0, 1 << 30, (64, 4096)).astype(np.int32),
    })
    want = list(tio.iterate_batches(frame, ["x", "t"], 8, shuffle=True, seed=3))
    got = []
    for batch in tio.prefetch_to_device(iter(want), size=2, device=cuda_device):
        torch.cuda._sleep(2_000_000)  # the consumer's stream is still busy
        got.append({k: (v * 1).cpu() for k, v in batch.items()})
        del batch
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for c in w:
            np.testing.assert_array_equal(g[c].numpy(), w[c])


def test_padding_graph_on_card_matches_cpu(cuda_device):
    """The padding graph of ``chip_smoke.py`` (stride-2 SAME Conv2D 3x3
    and 2x2, depthwise, MaxPool and AvgPool at sizes 17 and 16) imported
    f32 on the card, TF32 off, within ``PAD_RTOL`` of the same import on
    the CPU; TF's split placed on the wrong side falls outside."""
    import chip_smoke as cs
    from tensorframes_tpu_torch import graphdef as tgd

    data, fetches = cs.padding_graphdef()
    feeds = cs.padding_feeds()
    cpu = tft.program_from_graphdef(tft.parse_graphdef(data), fetches=fetches,
                                    compute_dtype=None, device="cpu")
    with torch.inference_mode():
        want = {k: v.numpy() for k, v in cpu.fn(
            {k: torch.from_numpy(v) for k, v in feeds.items()}).items()}
    assert cs.padding_ratio(tft, data, fetches, feeds, cuda_device, want) <= 1
    real = tgd._same_pads
    tgd._same_pads = lambda *a: real(*a)[::-1]
    try:
        assert cs.padding_ratio(tft, data, fetches, feeds, cuda_device, want) > 1
    finally:
        tgd._same_pads = real


def test_vgg_int8_fc_layers_launch_their_builds_on_card(cuda_device):
    """VGG's int8 fc layers in bf16 on the card: fc6 and fc7 (n a
    multiple of 16) launch ``int8_matmul``'s tensor-core build, fc8 (10
    classes) its scalar build, one launch each; the logits within 2e-2 of
    max |logit| of the same forward with the kernel's plain version (a
    bf16 activation may round to its neighbour between the two)."""
    from tensorframes_tpu_torch.models import vgg as tvgg

    cfg = tvgg.tiny(compute_dtype="bfloat16")
    params = tvgg.quantize_params(tvgg.init_params(cfg, seed=0, device=cuda_device))
    images = torch.from_numpy(tvgg.synthetic_images(cfg, 4, seed=1)).to(cuda_device)
    tft.kernels.LAUNCHES.reset()
    with torch.inference_mode():
        logits = tvgg.forward(cfg, params, images)
    torch.cuda.synchronize()
    launches = {**tft.kernels.LAUNCHES.snapshot(), **tft.kernels.LAUNCHES.builds()}
    assert (launches["int8_matmul"], launches["int8_matmul_mma"]) == (3, 2)
    assert logits.shape == (4, cfg.num_classes) and bool(torch.isfinite(logits).all())
    kernel_matmul, tvgg.matmul = tvgg.matmul, tq.matmul_plain
    try:
        with torch.inference_mode():
            plain = tvgg.forward(cfg, params, images)
    finally:
        tvgg.matmul = kernel_matmul
    assert float((logits - plain).abs().max()) <= 2e-2 * float(plain.abs().max())


def test_vgg_bf16_fc_layers_keep_f32_sums_on_card(cuda_device):
    """VGG's plain bf16 fc layer on the card returns the f32 sum of the
    bf16 products, as the reference's ``preferred_element_type=f32``:
    within 1e-4 of max |sum| of the f64 product, where a bf16 output
    would be off by ~2^-9 of each sum."""
    from tensorframes_tpu_torch.models import vgg as tvgg

    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn((64, 4096), generator=g, device=cuda_device).bfloat16()
    w = (torch.randn((4096, 1000), generator=g, device=cuda_device) / 64).bfloat16()
    b = torch.zeros(1000, dtype=torch.bfloat16, device=cuda_device)
    y = tvgg._dense({"w": w, "b": b}, x)
    ref = x.double() @ w.double()
    assert y.dtype == torch.float32
    assert float((y - ref).abs().max()) <= 1e-4 * float(ref.abs().max())
    assert float(((x @ w).double() - ref).abs().max()) > 1e-4 * float(ref.abs().max())


@pytest.mark.parametrize("depth,prefetch", [(0, 0), (1, 0), (2, 2), (3, 2)])
def test_map_blocks_pipeline_bit_for_bit_on_card(cuda_device, depth, prefetch):
    """``map_blocks`` with blocks staged ahead on a side stream and
    outputs read back on another gives the serial run's bits, while the
    compute stream is kept busy (a spin before each block's program)."""
    rng = np.random.default_rng(12)
    frame = tft.frame_from_arrays({"x": rng.standard_normal((4096, 256)).astype(np.float32)},
                                  num_blocks=7)

    def prog(x):
        torch.cuda._sleep(1_000_000)
        return {"y": torch.tanh(x @ x.T[:, :64]) * 2.0}

    cfg = tft.get_config()
    was = (cfg.map_pipeline_depth, cfg.map_prefetch_depth)
    try:
        tft.configure(map_pipeline_depth=0, map_prefetch_depth=0)
        want = tft.map_blocks(prog, frame, device=cuda_device).column_values("y")
        tft.configure(map_pipeline_depth=depth, map_prefetch_depth=prefetch)
        got = tft.map_blocks(prog, frame, device=cuda_device).column_values("y")
    finally:
        tft.configure(map_pipeline_depth=was[0], map_prefetch_depth=was[1])
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


def test_readback_waits_on_its_own_event_on_card(cuda_device):
    """A readback started behind queued work returns that work's values;
    bf16 crosses as bf16."""
    from tensorframes_tpu_torch.ops import executor as texec

    x = torch.arange(1 << 20, device=cuda_device, dtype=torch.float32)
    torch.cuda._sleep(20_000_000)
    pending = texec.Readback({"a": x * 2, "b": (x[:8] + 0.5).bfloat16()})
    out = pending.wait()
    np.testing.assert_array_equal(out["a"], np.arange(1 << 20, dtype=np.float32) * 2)
    assert str(out["b"].dtype) == "bfloat16"
    np.testing.assert_array_equal(out["b"].astype(np.float32), np.arange(8) + 0.5)


def test_generic_aggregate_on_card_matches_cpu(cuda_device):
    """The generic (UDAF) aggregate on the card equals the CPU run: int
    sums exactly, f32 sums within rtol 1e-5 / atol 1e-5·max|v|·√n."""
    rng = np.random.default_rng(13)
    n = 50_000
    frame = tft.frame_from_arrays({"k": rng.integers(0, 97, n),
                                   "v": rng.standard_normal((n, 4)).astype(np.float32),
                                   "i": rng.integers(-9, 9, n).astype(np.int32)})

    def fetches(v_input, i_input):
        return {"v": v_input.sum(0), "i": i_input.sum(0, dtype=torch.int32)}

    got = tft.aggregate(fetches, frame.group_by("k"), device=cuda_device)
    want = tft.aggregate(fetches, frame.group_by("k"), device="cpu")
    np.testing.assert_array_equal(got.column_values("k"), want.column_values("k"))
    np.testing.assert_array_equal(got.column_values("i"), want.column_values("i"))
    counts = np.bincount(frame.column_values("k"))[want.column_values("k")]
    np.testing.assert_allclose(got.column_values("v"), want.column_values("v"), rtol=1e-5,
                               atol=1e-5 * 5 * np.sqrt(counts.max()))


def test_tree_all_finite_on_card_reduces_on_the_device(cuda_device):
    """``tree_all_finite`` over CUDA leaves (f32, bf16, f64, an optimizer's
    moments) finds a NaN or an inf in any one of them, passes a finite
    tree, and never copies a leaf to the host (no device-to-host copy of
    a leaf's size: the profiler sees only the flags' few bytes)."""
    from tensorframes_tpu_torch.resilience import tree_all_finite

    def tree():
        return {"a": torch.randn(1 << 20, device=cuda_device),
                "b": [torch.ones(3, 5, dtype=torch.bfloat16, device=cuda_device),
                      torch.full((2,), 1e300, dtype=torch.float64, device=cuda_device)],
                "i": torch.arange(4, device=cuda_device), "s": torch.tensor(2.0)}

    assert tree_all_finite(tree())
    for where, bad in (("a", float("nan")), ("b0", float("inf")), ("b1", float("-inf"))):
        t = tree()
        leaf = t["a"] if where == "a" else t["b"][int(where[1])]
        leaf.view(-1)[-1] = bad
        assert not tree_all_finite(t), where
    w = torch.zeros(8, device=cuda_device, requires_grad=True)
    opt = torch.optim.AdamW([w], lr=1e-3)
    w.grad = torch.full_like(w, float("nan"))
    opt.step()
    w.data.zero_()
    assert not tree_all_finite((w, opt))  # the NaN lives in the moments alone
    big = tree()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        assert tree_all_finite(big)
    moved = [e for e in prof.events() if "DtoH" in e.name and getattr(e, "device_type", None)]
    assert all(getattr(e, "bytes", 0) < 1024 for e in moved)


def test_guarded_step_on_card_skips_a_nan_step_bit_for_bit(cuda_device):
    """One guarded step on the card: gpt_tiny under the port's AdamW, a
    NaN loss at step 2 under ``guard="skip"`` leaves parameters, moments
    and step counts equal bit for bit to a run that never took it (deterministic
    algorithms on for the comparison)."""
    import math
    import os

    from tensorframes_tpu_torch import training
    from tensorframes_tpu_torch.utils.tree import flatten_with_keys

    if os.environ.get("CUBLAS_WORKSPACE_CONFIG") is None:
        pytest.skip("needs CUBLAS_WORKSPACE_CONFIG=:4096:8 set before CUDA starts")
    cfg = tgen.gpt_tiny(attention_impl="dense")
    toks, tg = ttr.synthetic_batch(cfg, 8, 16, seed=0)
    batches = [{"tokens": torch.from_numpy(toks[i:i + 4]).to(cuda_device),
                "targets": torch.from_numpy(tg[i:i + 4]).to(cuda_device)} for i in (0, 4, 0)]

    def state(poison):
        params = ttr.init_params(cfg, seed=0, device=cuda_device)
        opt = ttr.adamw(params, 1e-3)
        scale, calls = [1.0], [0]
        step = training.make_grad_accum_step(
            lambda p, b: ttr.loss_fn(cfg, p, b["tokens"], b["targets"]) * scale[0], opt, 1)

        def fn(s, b):
            calls[0] += 1
            scale[0] = math.nan if calls[0] == poison else 1.0
            _, _, loss = step(s[0], s[1].state, b)
            return s, loss

        return (params, opt), fn

    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        s, fn = state(poison=2)
        guard = tft.StepGuard("skip")
        guard.seed(0, s)
        for i, b in enumerate(batches, 1):
            s, _ = guard.admit(i, *fn(s, b), prev_state=s)
        r, rfn = state(poison=None)
        for b in (batches[0], batches[2]):
            r, _ = rfn(r, b)
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(was)
    assert guard.skipped == 1
    fa, fb = dict(flatten_with_keys(s)), dict(flatten_with_keys(r))
    assert list(fa) == list(fb) and all(torch.equal(fa[k], fb[k]) for k in fa)


# ---------------------------------------------------------------------------
# the data-parallel frame on the card
# ---------------------------------------------------------------------------

def _sharded_agg_inputs(rng, n=200_000, groups=512):
    return {"k": rng.integers(0, groups, n).astype(np.int32),
            "v": rng.standard_normal(n).astype(np.float32),
            "u": rng.standard_normal((n, 4)).astype(np.float32),
            "c": rng.integers(-1000, 1000, n).astype(np.int32)}


def _sharded_fetches(frame):
    with tft.with_graph():
        b = lambda col: tft.block(frame, col, tf_name=f"{col}_input")  # noqa: E731
        return [tft.reduce_sum(b("v"), name="v"), tft.reduce_mean(b("u"), name="u"),
                tft.reduce_max(b("c"), name="c")]


def _free_port():
    import socket

    sock = socket.socket()
    sock.bind(("localhost", 0))
    port = sock.getsockname()[1]
    sock.close()
    return port


def test_world_of_one_nccl_aggregate_matches_unsharded_on_card(cuda_device):
    """A world of one under NCCL: the dense-span aggregate of a sharded
    frame equals the unsharded port's (int max exact, float sum and mean
    within the float tolerance) and launches segment_reduce once."""
    from tensorframes_tpu_torch.parallel import distributed, init_distributed

    data = _sharded_agg_inputs(np.random.default_rng(5))
    host = tft.frame_from_arrays(data)
    init_distributed(f"localhost:{_free_port()}", 1, 0, backend="nccl", device=cuda_device)
    try:
        sh = host.to_device()
        tft.kernels.LAUNCHES.reset()
        got = sh.group_by("k").aggregate(_sharded_fetches(sh))
        launches = tft.kernels.LAUNCHES.snapshot()["segment_reduce"]
    finally:
        distributed.shutdown_distributed()
    want = tft.aggregate(_sharded_fetches(host), host.group_by("k"), device=cuda_device)
    assert launches == 1
    np.testing.assert_array_equal(got.column_values("k"), want.column_values("k"))
    np.testing.assert_array_equal(got.column_values("c"), want.column_values("c"))
    counts = torch.from_numpy(np.bincount(data["k"])[want.column_values("k")])
    vmax = float(np.abs(data["v"]).max())
    _float_close(torch.from_numpy(got.column_values("v")), torch.from_numpy(want.column_values("v")),
                 1e-5, vmax, counts, mean=False)
    _float_close(torch.from_numpy(got.column_values("u")), torch.from_numpy(want.column_values("u")),
                 1e-5, float(np.abs(data["u"]).max()), counts, mean=True)


_RANK_SCRIPT = r"""
import sys
import numpy as np
import torch
import tensorframes_tpu_torch as tft
from tensorframes_tpu_torch.parallel import distributed, frame_from_process_local, init_distributed

rank, port = int(sys.argv[1]), sys.argv[2]
init_distributed(f"localhost:{port}", 2, rank, backend="gloo", device="cuda:0")
rng = np.random.default_rng(5)
n = 200_000
data = {"k": rng.integers(0, 512, n).astype(np.int32), "v": rng.standard_normal(n).astype(np.float32)}
lo, hi = rank * n // 2, (rank + 1) * n // 2
fr = frame_from_process_local({c: data[c][lo:hi] for c in data})
with tft.with_graph():
    fetch = tft.reduce_sum(tft.block(fr, "v", tf_name="v_input"), name="v")
tft.kernels.LAUNCHES.reset()
res = fr.group_by("k").aggregate(fetch)
print("LAUNCHES", tft.kernels.LAUNCHES.snapshot()["segment_reduce"], len(res.column_values("k")))
distributed.shutdown_distributed()
"""


def test_segment_reduce_launches_once_a_rank_on_card(cuda_device):
    """Two gloo ranks sharing the card: each rank's dense table comes from
    one segment_reduce launch, and both hold every group."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    port = str(_free_port())
    env = dict(os.environ, PYTHONPATH=str(root))
    procs = [subprocess.Popen([sys.executable, "-c", _RANK_SCRIPT, str(r), port], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    outs = [p.communicate(timeout=180)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    for out in outs:
        line = [ln for ln in out.splitlines() if ln.startswith("LAUNCHES")][-1]
        assert line.split()[1:] == ["1", "512"]


def test_world_of_one_sharded_step_is_make_train_step_bit_for_bit_on_card(cuda_device):
    """A world of one under NCCL, mesh ``{"dp": 1}``: two steps of the
    sharded train step with flash attention equal two of
    ``make_train_step`` on the same weights, bit for bit (losses, every
    gradient, every updated leaf), and launch the three flash kernels
    once a layer a step."""
    import functools

    from tensorframes_tpu_torch.parallel import distributed, init_distributed, make_mesh

    cfg = tgen.gpt_small(attention_impl="flash", num_layers=2, vocab_size=4096)
    tokens, targets = ttr.synthetic_batch(cfg, 2, 256, seed=1)
    plain = ttr.init_params(cfg, seed=1, device=cuda_device)
    opt = ttr.adamw(plain, 1e-3)
    plain_step = ttr.make_train_step(cfg, opt)
    init_distributed(f"localhost:{_free_port()}", 1, 0, backend="nccl", device=cuda_device)
    try:
        mesh = make_mesh({"dp": 1})
        step, _, _, init_opt = ttr.make_sharded_train_step(
            cfg, mesh, functools.partial(ttr.adamw, learning_rate=1e-3))
        local = ttr.shard_params(cfg, ttr.init_params(cfg, seed=1, device=cuda_device), mesh)
        sopt = init_opt(local)
        tb, gb = ttr.shard_batch(mesh, tokens, targets)
        for _ in range(2):
            _, _, want = plain_step(plain, opt.state, torch.from_numpy(tokens).to(cuda_device),
                                    torch.from_numpy(targets).to(cuda_device))
            tft.kernels.LAUNCHES.reset()
            _, _, got = step(local, sopt, tb, gb)
            counts = tft.kernels.LAUNCHES.snapshot()
            assert torch.equal(got, want)
            for a, b in zip(ttr.tree_leaves(local), ttr.tree_leaves(plain)):
                assert torch.equal(a.grad, b.grad) and torch.equal(a, b)
            assert [counts[k] for k in ("flash_attention", "flash_attention_bwd_dkv",
                                        "flash_attention_bwd_dq")] == [2, 2, 2]
    finally:
        distributed.shutdown_distributed()


def test_paged_decode_attention_public_face_is_the_kernel_on_card(cuda_device):
    """``ops.attention.paged_decode_attention`` launches the hand kernel
    once and returns its bits."""
    from tensorframes_tpu_torch.ops import attention as tatt

    rng = np.random.default_rng(21)
    args = _paged_inputs(rng, 16, 40, 3, 12, 16, 64, 12, cuda_device, torch.bfloat16)
    q, kp, vp, ks, vs, tables, pos = args
    tft.kernels.LAUNCHES.reset()
    got = tatt.paged_decode_attention(q, kp, vp, ks, vs, 1, tables, pos)
    assert tft.kernels.LAUNCHES.snapshot()["decode_attention"] == 1
    assert torch.equal(got, kda.paged_decode_attention(q, kp, vp, ks, vs, 1, tables, pos))
