"""The int8-weight matmul's two builds, on the CPU: the rule that chooses
between them, the tensor-core build's partition of k, and its order of
sums held against the reference's Pallas kernel.

``int8_matmul_build`` reads dtypes, shapes and data pointers, so CPU
tensors exercise it. ``int8_matmul_split`` is plain arithmetic. The
tensor-core build sums each 16-deep k step exactly in f32 (bf16 products
of widened int8 are exact), step i of every 64-row stage into k-group
i, the four k-groups of a split in order, then the splits in order; the
model below takes those sums in that order (each step's 16 products in
torch's own f32 order), and is held against the JAX package's Pallas
kernel in interpret mode within the on-card tolerance, 2^-7·|ref| +
1e-3·max|ref| in bf16: the same tolerance that holds the kernel against
its plain version on the card.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorframes_tpu.ops import quantize as jq
from tensorframes_tpu_torch.ops import quantize as tq

GPT_SMALL = ((768, 2304), (768, 768), (768, 3072), (3072, 768))


def _q(k, n):
    return tq.QuantizedTensor(torch.zeros((k, n), dtype=torch.int8),
                              torch.ones((1, n), dtype=torch.float32))


def _off_by_one(shape, dtype):
    """A contiguous tensor whose data starts one element past a 16-byte
    boundary."""
    return torch.zeros(int(np.prod(shape)) + 1, dtype=dtype)[1:].view(shape)


@pytest.mark.parametrize("what,make,build", [
    ("a decode step's bf16 rows", lambda: (torch.zeros((16, 768), dtype=torch.bfloat16),
                                           _q(768, 2304)), "mma"),
    ("one bf16 row", lambda: (torch.zeros((1, 3072), dtype=torch.bfloat16), _q(3072, 768)), "mma"),
    ("a prefill's [1, 128, 768] bf16", lambda: (torch.zeros((1, 128, 768), dtype=torch.bfloat16),
                                                _q(768, 3072)), "mma"),
    ("a non-contiguous bf16 view (copied, aligned)",
     lambda: (torch.zeros((768, 16), dtype=torch.bfloat16).t(), _q(768, 768)), "mma"),
    ("bf16, n a multiple of 16 only", lambda: (torch.zeros((4, 64), dtype=torch.bfloat16),
                                               _q(64, 48)), "mma"),
    ("bf16 given the raw int8 q", lambda: (torch.zeros((4, 64), dtype=torch.bfloat16),
                                           _q(64, 48).q), "mma"),
    ("f32 rows", lambda: (torch.zeros((16, 768)), _q(768, 2304)), "scalar"),
    ("bf16, k % 8 != 0", lambda: (torch.zeros((37, 100), dtype=torch.bfloat16), _q(100, 72)),
     "scalar"),
    ("bf16, n % 16 != 0", lambda: (torch.zeros((5, 64), dtype=torch.bfloat16), _q(64, 30)),
     "scalar"),
    ("bf16 rows off a 16-byte boundary", lambda: (_off_by_one((3, 64), torch.bfloat16),
                                                  _q(64, 32)), "scalar"),
    ("an int8 weight off a 16-byte boundary", lambda: (
        torch.zeros((3, 64), dtype=torch.bfloat16),
        tq.QuantizedTensor(_off_by_one((64, 32), torch.int8), torch.ones((1, 32)))), "scalar"),
])
def test_int8_matmul_build_chooses_the_kernel(what, make, build):
    """The one rule between the two builds: bf16 x whose rows, and the
    weight's, can be copied 16 bytes at a time takes the tensor cores; f32
    and the rest the scalar kernel."""
    x, w = make()
    assert tq.int8_matmul_build(x, w) == build, what


def test_int8_matmul_split_reads_k_and_n_only():
    assert list(inspect.signature(tq.int8_matmul_split).parameters) == ["k", "n"]
    with pytest.raises(ValueError):
        tq.int8_matmul_split(0, 16)


@pytest.mark.parametrize("k,n", [*GPT_SMALL, (776, 96), (1000, 304), (776, 48), (8, 16),
                                 (64, 16), (50_000, 16), (32, 100_000), (100, 72)])
def test_int8_matmul_split_covers_k_exactly(k, n):
    """Chunks of a multiple of 32 rows, at most 8 splits (one cluster), none
    empty, and together exactly k."""
    chunk, splits = tq.int8_matmul_split(k, n)
    assert chunk % tq.SPLIT_QUANTUM == 0 and 1 <= splits <= tq.MAX_SPLITS
    assert (splits - 1) * chunk < k <= splits * chunk
    bounds = [(s * chunk, min(k, (s + 1) * chunk)) for s in range(splits)]
    assert bounds[0][0] == 0 and bounds[-1][1] == k
    assert all(a < b for a, b in bounds) and all(b == c for (_, b), (c, _) in zip(bounds,
                                                                                   bounds[1:]))


@pytest.mark.parametrize("k,n", GPT_SMALL)
def test_int8_matmul_split_fills_the_card_at_m16(k, n):
    """Each of gpt_small's four products at m = 16 (one 16-token block row)
    puts at least one block on each of the H100's 132 SMs."""
    _, splits = tq.int8_matmul_split(k, n)
    assert splits * -(-n // tq.SPLIT_TILE_N) >= 132


def _split_order_model(x, w):
    """The tensor-core build's sums in its order, on the CPU (see the module
    docstring): f32 per 16-deep step, steps into k-groups by their place in
    each 64-row stage, k-groups then splits added in order, the scale on
    the sum, one rounding to x's dtype."""
    k, n = w.q.shape
    chunk, splits = tq.int8_matmul_split(k, n)
    xf, qf = x.float(), w.q.float()
    total = None
    for s in range(splits):
        lo, hi = s * chunk, min(k, (s + 1) * chunk)
        groups = [torch.zeros((x.shape[0], n)) for _ in range(4)]
        for step in range(lo, hi, 16):
            groups[(step - lo) // 16 % 4] += xf[:, step:step + 16] @ qf[step:step + 16]
        part = ((groups[0] + groups[1]) + groups[2]) + groups[3]
        total = part if total is None else total + part
    return (total * w.scale.reshape(-1)).to(x.dtype)


@pytest.mark.parametrize("k,n", [*GPT_SMALL, (776, 96)])
def test_split_order_matches_interpreted_pallas(k, n):
    """The build's order of sums, at m = 16, within the on-card tolerance
    of the reference's Pallas kernel; a model that drops the last split
    does not."""
    rng = np.random.default_rng(k + n)
    x = rng.standard_normal((16, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) * k ** -0.5).astype(np.float32)
    want = jq.matmul_pallas_int8(jnp.asarray(x, jnp.bfloat16), jq.quantize(jnp.asarray(w)),
                                 interpret=True)
    want = np.asarray(want.astype(jnp.float32), np.float64)
    tw = tq.quantize(torch.from_numpy(w))
    got = _split_order_model(torch.from_numpy(x).to(torch.bfloat16), tw).double().numpy()
    tol = 2.0 ** -7 * np.abs(want) + 1e-3 * np.abs(want).max()
    assert np.all(np.abs(got - want) <= tol), np.abs(got - want).max()
    chunk, splits = tq.int8_matmul_split(k, n)
    cut = (splits - 1) * chunk
    short = tq.matmul_int8_plain(torch.from_numpy(x[:, :cut]).to(torch.bfloat16),
                                 tq.QuantizedTensor(tw.q[:cut], tw.scale)).double().numpy()
    assert not np.all(np.abs(short - want) <= tol)
