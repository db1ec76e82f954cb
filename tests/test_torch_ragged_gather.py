"""Parity of the PyTorch port's ragged row gather with the JAX package.

The port's ``ragged_gather_rows`` on a CPU tensor computes its plain
PyTorch version; the JAX side runs ``gather_reference`` and its Pallas
kernel in interpret mode (as tests/test_kernels.py does). The gather only
moves data, so every comparison is bit-exact, padding rows (offset 0)
included.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tensorframes_tpu.kernels import ragged_gather as jkrg

from tensorframes_tpu_torch import dtypes as tdt
from tensorframes_tpu_torch.kernels import ragged_gather as krg


def _cells(dtype, n=80, seed=11):
    rng = np.random.default_rng(seed)
    np_dtype = tdt.bfloat16.np_dtype if dtype == "bfloat16" else np.dtype(dtype)
    cells = [
        (rng.standard_normal(int(rng.integers(1, 40))) * 100).astype(np_dtype)
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
