"""The generic (UDAF) route of ``aggregate``: fetches that are not DSL
reducers run as level-batched compaction, the program applied to chunks
of at most ``aggregate_buffer_size`` rows of a group and again to the
stacked partials. The same seeded frames and programs go through the JAX
package's ``aggregate`` and the port's (``device="cpu"``).

Tolerances: keys, group order, dtypes, shapes, integer results and
min/max exact; float sums and log-sum-exps rtol 1e-5 / atol
1e-5·max|v|·√n for a group of n rows (the two packages sum each chunk in
their own order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import tensorframes_tpu as tfs
import tensorframes_tpu_torch as tft
from tensorframes_tpu import config as jconfig
from tensorframes_tpu.ops import executor as jexec
from tensorframes_tpu.ops import verbs as jverbs
from tensorframes_tpu_torch.ops import executor as texec
from tensorframes_tpu_torch.ops import verbs as tverbs

RTOL = 1e-5


@pytest.fixture
def buffer_size(request):
    """Sets both packages' ``aggregate_buffer_size`` for one test."""
    was = (jconfig.get_config().aggregate_buffer_size,
           tft.get_config().aggregate_buffer_size)
    tfs.configure(aggregate_buffer_size=request.param)
    tft.configure(aggregate_buffer_size=request.param)
    yield request.param
    tfs.configure(aggregate_buffer_size=was[0])
    tft.configure(aggregate_buffer_size=was[1])


def _group_sizes(buf):
    """Groups of 1, buf, buf + 1 and more than buf² rows, and a few more."""
    return [1, buf, buf + 1, buf * buf + 3, 2 * buf + 1, 5, 1, buf]


def _data(sizes, seed=0, width=3):
    rng = np.random.default_rng(seed)
    k = np.repeat(np.arange(len(sizes)) * 3 - 4, sizes)
    rng.shuffle(k)  # groups interleaved, as real rows are
    n = len(k)
    return {
        "k": k,
        "v": rng.standard_normal((n, width)).astype(np.float32),
        "i": rng.integers(-1000, 1000, n).astype(np.int32),
        "d": rng.standard_normal(n),
    }


def _fns(pkg):
    """Plain-function fetches: a log-sum-exp over rows, an int32 sum and a
    float64 max — each valid on stacked partials."""
    if pkg is tfs:
        return lambda v_input, i_input, d_input: {
            "v": jax.nn.logsumexp(v_input, axis=0),
            "i": jnp.sum(i_input, axis=0, dtype=jnp.int32),
            "d": jnp.max(d_input, axis=0),
        }
    return lambda v_input, i_input, d_input: {
        "v": torch.logsumexp(v_input, 0),
        "i": i_input.sum(0, dtype=torch.int32),
        "d": d_input.max(0).values,
    }


def _aggregate(pkg, data, keys=("k",), fetches=None, num_blocks=3):
    df = pkg.frame_from_arrays(dict(data), num_blocks=num_blocks)
    kw = {"device": "cpu"} if pkg is tft else {}
    return pkg.aggregate(fetches(pkg) if fetches else _fns(pkg), df.group_by(*keys), **kw)


def _counts(data, keys, res):
    """Rows per group of ``res``, in its row order."""
    rows = {}
    for tup in zip(*(np.asarray(data[k]).tolist() for k in keys)):
        rows[tup] = rows.get(tup, 0) + 1
    return np.array([rows[tup] for tup in zip(*(
        np.asarray(res.column_values(k)).tolist() for k in keys))])


def _assert_close(j, t, data, keys=("k",), floats=("v",)):
    assert str(t.schema) == str(j.schema)
    for c in j.schema.names:
        a, b = j.column_values(c), t.column_values(c)
        assert a.dtype == b.dtype and a.shape == b.shape, c
        if c in floats:
            n = _counts(data, keys, j).reshape((-1,) + (1,) * (a.ndim - 1))
            vmax = float(np.abs(np.asarray(data[c])).max())
            np.testing.assert_allclose(b, a, rtol=RTOL, atol=RTOL * vmax * np.sqrt(n).max())
        else:
            np.testing.assert_array_equal(b, a, err_msg=c)


@pytest.mark.parametrize("buffer_size", [2, 3, 10], indirect=True)
def test_generic_aggregate_matches_reference(buffer_size):
    data = _data(_group_sizes(buffer_size))
    j, t = _aggregate(tfs, data), _aggregate(tft, data)
    _assert_close(j, t, data)


@pytest.mark.parametrize("buffer_size", [2, 3, 10], indirect=True)
def test_generic_aggregate_int_sum_exact_against_numpy(buffer_size):
    data = _data(_group_sizes(buffer_size), seed=4)
    t = _aggregate(tft, data)
    want = np.zeros(data["k"].max() + 5, np.int64)
    np.add.at(want, data["k"] + 4, data["i"])
    np.testing.assert_array_equal(t.column_values("i"), want[t.column_values("k") + 4])
    want_d = np.full(want.shape, -np.inf)
    np.maximum.at(want_d, data["k"] + 4, data["d"])
    np.testing.assert_array_equal(t.column_values("d"), want_d[t.column_values("k") + 4])


@pytest.mark.parametrize("buffer_size", [2, 10], indirect=True)
@pytest.mark.parametrize("num_blocks", [1, 4])
def test_generic_aggregate_dispatch_count_matches_reference(buffer_size, num_blocks,
                                                           monkeypatch):
    """Both packages run the same levels: as many vmapped dispatches, each
    over as many chunks of as many rows."""
    seen = {}
    for name, mod in (("jax", jexec), ("torch", texec)):
        calls = seen.setdefault(name, [])
        real = mod.CompiledProgram.run_rows

        def wrapped(self, feeds, *a, _real=real, _calls=calls, **k):
            _calls.append(tuple(tuple(v.shape) for _, v in sorted(feeds.items())))
            return _real(self, feeds, *a, **k)

        monkeypatch.setattr(mod.CompiledProgram, "run_rows", wrapped)
    data = _data(_group_sizes(buffer_size) * 3, seed=1)
    _aggregate(tfs, data, num_blocks=num_blocks)
    _aggregate(tft, data, num_blocks=num_blocks)
    assert seen["torch"] == seen["jax"]
    assert len(seen["torch"]) >= 2


@pytest.mark.parametrize("buffer_size", [3], indirect=True)
def test_generic_aggregate_dsl_fetch_and_two_keys(buffer_size):
    data = _data([4, 9, 1, 30, 2, 11], seed=2)
    data["s"] = [f"g{v % 3}" for v in range(len(data["k"]))]

    def fetch(pkg):
        def build(df):
            x = pkg.block(df, "d", tf_name="d_input")
            lib = jnp if pkg is tfs else torch
            return pkg.apply_fn(lambda v: lib.sum(v * 1.0, 0), x, name="d")
        return build

    outs = []
    for pkg in (tfs, tft):
        df = pkg.frame_from_arrays(dict(data), num_blocks=2)
        with pkg.with_graph():
            node = fetch(pkg)(df)
            kw = {"device": "cpu"} if pkg is tft else {}
            outs.append(pkg.aggregate(node, df.group_by("k", "s"), **kw))
    _assert_close(*outs, data, keys=("k", "s"), floats=("d",))


def test_generic_aggregate_single_row_groups_run_the_program():
    """Every group passes through the program once, single rows too (the
    UDAF's final evaluate): a program that doubles its rows' sum doubles
    a lone row."""
    data = {"k": np.arange(5), "d": np.arange(5.0)}
    outs = []
    for pkg, fn in ((tfs, lambda d_input: {"d": jnp.sum(d_input, 0) * 2.0}),
                    (tft, lambda d_input: {"d": torch.sum(d_input, 0) * 2.0})):
        df = pkg.frame_from_arrays(dict(data))
        kw = {"device": "cpu"} if pkg is tft else {}
        outs.append(pkg.aggregate(fn, df.group_by("k"), **kw))
    np.testing.assert_array_equal(outs[1].column_values("d"), np.arange(5.0) * 2)
    np.testing.assert_array_equal(outs[1].column_values("d"), outs[0].column_values("d"))


def test_generic_aggregate_empty_frame():
    data = _data([3, 4])
    outs = []
    for pkg in (tfs, tft):
        df = pkg.frame_from_arrays(dict(data)).limit(0)
        kw = {"device": "cpu"} if pkg is tft else {}
        outs.append(pkg.aggregate(_fns(pkg), df.group_by("k"), **kw))
    j, t = outs
    assert str(t.schema) == str(j.schema)
    for c in j.schema.names:
        a, b = j.column_values(c), t.column_values(c)
        assert a.shape == b.shape == (0,) + a.shape[1:] and a.dtype == b.dtype


def test_batched_compaction_with_zero_groups():
    """No group: the empty result of each output's dtype and cell shape."""
    data = _data([3, 4])
    outs = []
    for pkg, mod in ((tfs, jverbs), (tft, tverbs)):
        df = pkg.frame_from_arrays(dict(data))
        kw = {"device": "cpu"} if pkg is tft else {}
        prog = pkg.compile_program(_fns(pkg), df, reduce_mode="blocks", **kw)
        extra = ("cpu",) if pkg is tft else ()
        outs.append(mod._batched_compaction(prog, {}, np.zeros(0, np.int64), 0,
                                            ["v", "i", "d"], *extra))
    assert sorted(outs[0]) == sorted(outs[1])
    for c in outs[0]:
        assert outs[0][c].shape == outs[1][c].shape and outs[0][c].dtype == outs[1][c].dtype


@pytest.mark.parametrize("num_blocks", [None, 6])
def test_generic_aggregate_ragged_column_error(num_blocks):
    """A ragged value column raises the reference's error, word for word
    (numpy's, as it gathers the column, whether the ragged cells share a
    block or not)."""
    rows = [{"k": i % 2, "r": [1.0] * (1 + i % 3)} for i in range(6)]
    msgs = []
    for pkg, fn in ((tfs, lambda r_input: {"r": jnp.sum(r_input, 0)}),
                    (tft, lambda r_input: {"r": torch.sum(r_input, 0)})):
        df = pkg.frame_from_rows(rows, num_blocks=num_blocks)
        kw = {"device": "cpu"} if pkg is tft else {}
        with pytest.raises(ValueError) as ei:
            pkg.aggregate(fn, df.group_by("k"), **kw)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


def test_generic_aggregate_no_longer_raises_not_implemented():
    df = tft.frame_from_arrays({"k": np.arange(4) % 2, "v": np.arange(4.0)})
    out = tft.aggregate(lambda v_input: {"v": v_input.sum(0) * 2}, df.group_by("k"),
                        device="cpu")
    # two rows a group, under the buffer: one pass of the program
    np.testing.assert_array_equal(out.column_values("v"), [4.0, 8.0])
