"""Parity of the PyTorch port's ragged row gather with the JAX package.

The port's ``ragged_gather_groups`` (and its one-group form
``ragged_gather_rows``) on a CPU tensor computes its plain PyTorch version
group by group, through the same launch plan and device table a GPU call
builds; the JAX side runs ``gather_reference`` and its Pallas kernel in
interpret mode (as tests/test_kernels.py does). The gather only moves
data, so every comparison is bit-exact, padding rows (offset 0) included.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tensorframes_tpu.kernels import ragged_gather as jkrg

from tensorframes_tpu_torch import dtypes as tdt
from tensorframes_tpu_torch.kernels import ragged_gather as krg


def _cells(dtype, n=80, seed=11, max_len=40):
    rng = np.random.default_rng(seed)
    np_dtype = tdt.bfloat16.np_dtype if dtype == "bfloat16" else np.dtype(dtype)
    cells = [
        (rng.standard_normal(int(rng.integers(1, max_len))) * 100).astype(np_dtype)
        for _ in range(n)
    ]
    lens = np.asarray([len(c) for c in cells])
    starts = np.zeros(n, np.int64)
    np.cumsum(lens[:-1], out=starts[1:])
    return np.concatenate(cells), lens, starts


def _assert_same(got: np.ndarray, want: np.ndarray, msg: str):
    assert got.dtype == want.dtype, (msg, got.dtype, want.dtype)
    assert got.shape == want.shape, (msg, got.shape, want.shape)
    assert got.tobytes() == want.tobytes(), msg


@pytest.mark.parametrize("dtype", ["float32", "float64", "int32", "int8", "bfloat16"])
def test_gather_matches_reference_and_pallas(dtype):
    flat, lens, starts = _cells(dtype)
    flat_t = tdt.to_torch(flat, "cpu")
    uniq = np.unique(lens)
    for i, L in enumerate(uniq):
        st = starts[lens == L].astype(np.int32)
        got = tdt.to_numpy(krg.ragged_gather_rows(flat_t, st, int(L)))
        _assert_same(got, jkrg.gather_reference(flat, st, int(L)), f"length {L}")
        if i % 8 == 0:  # the interpreter builds one kernel per length
            pallas = np.asarray(jkrg.ragged_gather_rows(jnp.asarray(flat), st, int(L),
                                                        interpret=True))
            _assert_same(got, pallas, f"pallas length {L}")


def test_padding_rows_reread_offset_zero():
    flat, lens, starts = _cells("float32")
    st = np.zeros(8, np.int32)  # a group of 3 padded to the 8-row bucket
    st[:3] = starts[:3]
    got = krg.ragged_gather_rows(torch.from_numpy(flat), st, int(lens[0])).numpy()
    _assert_same(got, jkrg.gather_reference(flat, st, int(lens[0])), "padded rows")
    _assert_same(got[3:], np.broadcast_to(flat[: lens[0]], (5, lens[0])).copy(), "offset 0")


def test_rejects_zero_length_and_out_of_range_offsets():
    flat = torch.arange(10, dtype=torch.float32)
    with pytest.raises(ValueError, match="length >= 1"):
        krg.ragged_gather_rows(flat, np.zeros(2, np.int32), 0)
    with pytest.raises(ValueError, match="outside the flat buffer"):
        krg.ragged_gather_rows(flat, np.asarray([0, 8], np.int32), 3)
    with pytest.raises(ValueError, match="outside the flat buffer"):
        krg.ragged_gather_rows(flat, np.asarray([-1], np.int32), 1)


def _padded_groups(lens, starts, pad=5):
    """One group per distinct length, its rows' starts then ``pad``
    padding rows at offset 0 (as the verb's bucket padding)."""
    groups = []
    for L in np.unique(lens):
        st = np.zeros(int((lens == L).sum()) + pad, np.int32)
        st[:-pad] = starts[lens == L]
        groups.append((st, int(L)))
    return groups


@pytest.mark.parametrize("dtype", ["float32", "float64", "bfloat16", "int8"])
def test_grouped_gather_matches_reference_and_pallas(dtype):
    """Lengths 1-256 in one call, padding rows included, group by group
    against ``gather_reference``; every 16th length also against the
    interpreted Pallas kernel."""
    flat, lens, starts = _cells(dtype, n=600, seed=5, max_len=257)
    groups = _padded_groups(lens, starts)
    assert len(groups) > 150
    got = krg.ragged_gather_groups(tdt.to_torch(flat, "cpu"), groups)
    assert len(got) == len(groups)
    for i, ((st, L), g) in enumerate(zip(groups, got)):
        g = tdt.to_numpy(g)
        _assert_same(g, jkrg.gather_reference(flat, st, L), f"length {L}")
        if i % 16 == 0:
            pallas = np.asarray(jkrg.ragged_gather_rows(jnp.asarray(flat), st, L, interpret=True))
            _assert_same(g, pallas, f"pallas length {L}")


def test_launch_plan_table_and_one_upload():
    """One launch under the budget; its table holds each group's first
    16-byte chunk (the prefix sum of the padded outputs), its first start,
    rows and row bytes; the starts lie back to back in group order."""
    flat, lens, starts = _cells("bfloat16", n=200, seed=3, max_len=30)
    groups = _padded_groups(lens, starts, pad=3)
    flat_t = tdt.to_torch(flat, "cpu")
    (launch,) = krg.plan_launches(flat_t, groups)
    table = launch.table.numpy()
    rows = np.asarray([len(st) for st, _ in groups])
    row_bytes = np.asarray([L * 2 for _, L in groups])
    chunks = -(-rows * row_bytes // 16)
    np.testing.assert_array_equal(table[:, 0], np.concatenate([[0], np.cumsum(chunks)[:-1]]))
    np.testing.assert_array_equal(table[:, 1], np.concatenate([[0], np.cumsum(rows)[:-1]]))
    np.testing.assert_array_equal(table[:, 2], rows)
    np.testing.assert_array_equal(table[:, 3], row_bytes)
    assert launch.chunks == int(chunks.sum())
    np.testing.assert_array_equal(launch.starts.numpy(), np.concatenate([st for st, _ in groups]))
    # the table and the starts are views of one buffer: one copy to the device
    assert launch.table.untyped_storage().data_ptr() == launch.starts.untyped_storage().data_ptr()


def test_launch_budget_splits_the_groups(monkeypatch):
    """A group table past the budget takes several launches, each within
    the budget unless one group alone exceeds it; the results stay the
    same bits, in group order."""
    flat, lens, starts = _cells("float32", n=400, seed=9, max_len=100)
    groups = _padded_groups(lens, starts)
    flat_t = torch.from_numpy(flat)
    want = krg.ragged_gather_groups(flat_t, groups)
    assert len(krg.plan_launches(flat_t, groups)) == 1
    budget = 2048
    monkeypatch.setattr(krg, "LAUNCH_BUDGET_BYTES", budget)
    launches = krg.plan_launches(flat_t, groups)
    assert len(launches) > 5
    order = [i for launch in launches for i, _, _ in launch.groups]
    assert order == list(range(len(groups)))
    for launch in launches:
        padded = [-(-r * L * 4 // 16) * 16 for _, r, L in launch.groups]
        assert sum(padded) <= budget or len(padded) == 1
        assert launch.chunks * 16 == sum(padded)
    got = krg.ragged_gather_groups(flat_t, groups)
    for (st, L), a, b in zip(groups, got, want):
        _assert_same(a.numpy(), b.numpy(), f"length {L}")
        _assert_same(a.numpy(), jkrg.gather_reference(flat, st, L), f"reference length {L}")


def test_launch_groups_rules(monkeypatch):
    monkeypatch.setattr(krg, "LAUNCH_BUDGET_BYTES", 64)
    # (rows, length) of f32: 16, 0 (no rows: no launch), 80 (alone past the
    # budget), 48 and 16 bytes (together 64), 4 padded to 16
    sizes = [(1, 4), (0, 9), (5, 4), (3, 4), (1, 4), (1, 1)]
    assert krg.launch_groups(sizes, 4) == [[0], [2], [3, 4], [5]]
    assert krg.launch_groups([(0, 3)], 4) == []


def test_device_starts_and_empty_groups():
    """Starts given as tensors are joined with the host ones in group
    order; a group of no rows comes back as an empty [0, length] tensor."""
    flat, lens, starts = _cells("float64", n=120, seed=4)
    groups = _padded_groups(lens, starts, pad=2)
    mixed = [(torch.from_numpy(st) if i % 3 == 0 else st, L) for i, (st, L) in enumerate(groups)]
    mixed.insert(2, (np.zeros(0, np.int32), 7))
    got = krg.ragged_gather_groups(torch.from_numpy(flat), mixed)
    assert got[2].shape == (0, 7) and got[2].dtype == torch.float64
    del got[2]
    for (st, L), g in zip(groups, got):
        _assert_same(g.numpy(), jkrg.gather_reference(flat, st, L), f"length {L}")
