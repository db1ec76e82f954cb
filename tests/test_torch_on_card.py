"""The PyTorch port's CUDA kernels against their plain versions on the card.

Every test here is marked ``cuda`` and skips where
``torch.cuda.is_available()`` is false. The file imports neither JAX nor
the JAX package, so on a machine with an NVIDIA GPU it runs without
them::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_on_card.py

Tolerances: exact for integer sums (i32 wraparound included), counts,
min/max and the gather; float32 sums rtol 1e-5 / atol 1e-5·max|v|·√n for
a segment of n rows, because the kernel sums in another order than the
plain version, and means that atol over n; bfloat16 rtol 1e-2.
"""

import numpy as np
import pytest
import torch

import tensorframes_tpu_torch as tft
from tensorframes_tpu_torch.kernels import ragged_gather as krg
from tensorframes_tpu_torch.kernels import segment_reduce as ksr
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.int8, torch.bfloat16])
def test_gather_kernel_matches_plain_on_card(cuda_device, dtype):
    """16-byte, word and byte alignments all appear: lengths vary and int8
    offsets land on every byte. Padding rows re-read offset 0."""
    rng = np.random.default_rng(2)
    lens = rng.integers(1, 40, 5000)
    starts = np.zeros(len(lens), np.int64)
    np.cumsum(lens[:-1], out=starts[1:])
    flat = torch.from_numpy(rng.standard_normal(int(lens.sum())) * 100).to(cuda_device, dtype)
    for L in np.unique(lens):
        st = np.zeros(len(np.flatnonzero(lens == L)) + 5, np.int32)  # 5 padding rows
        st[:-5] = starts[lens == L]
        st_t = torch.from_numpy(st).to(cuda_device)
        got = krg.ragged_gather_rows(flat, st_t, int(L))
        assert torch.equal(got, krg.gather_plain(flat, st_t, int(L))), int(L)


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
    assert all(v > 0 for v in tft.kernels.LAUNCHES.snapshot().values())
