"""The verbs' block pipeline: ``map_blocks`` with ``map_prefetch_depth``
blocks staged ahead by a worker thread and ``map_pipeline_depth`` blocks
in flight, and the ragged ``map_rows`` in waves of groups with a window
of outputs in flight. Every setting gives the serial run's bits, and the
JAX package's results (exact: the programs here are elementwise, maxima
and integer sums). Errors keep the reference's words, and an error in a
block's feeds reaches the caller.
"""

import functools
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import tensorframes_tpu as tfs
import tensorframes_tpu_torch as tft
from tensorframes_tpu import config as jconfig
from tensorframes_tpu_torch.ops import executor as texec
from tensorframes_tpu_torch.ops import verbs as tverbs

DEPTHS = [0, 1, 2, 3]
PREFETCH = [0, 2]


@pytest.fixture
def pipeline(request):
    """The port's (depth, prefetch) for one test; restored after."""
    cfg = tft.get_config()
    was = (cfg.map_pipeline_depth, cfg.map_prefetch_depth)
    depth, prefetch = request.param
    tft.configure(map_pipeline_depth=depth, map_prefetch_depth=prefetch)
    yield depth, prefetch
    tft.configure(map_pipeline_depth=was[0], map_prefetch_depth=was[1])


SETTINGS = [(d, p) for d in DEPTHS for p in PREFETCH]


def _serial(fn):
    cfg = tft.get_config()
    was = (cfg.map_pipeline_depth, cfg.map_prefetch_depth)
    tft.configure(map_pipeline_depth=0, map_prefetch_depth=0)
    try:
        return fn()
    finally:
        tft.configure(map_pipeline_depth=was[0], map_prefetch_depth=was[1])


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def _blocks_data(n=1000, seed=0):
    rng = np.random.default_rng(seed)
    return {"x": rng.standard_normal((n, 4)).astype(np.float32),
            "i": rng.integers(-100, 100, n).astype(np.int32)}


# ---------------------------------------------------------------------------
# map_blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pipeline", SETTINGS, indirect=True)
@pytest.mark.parametrize("num_blocks", [1, 7])
def test_map_blocks_pipelined_equals_serial_and_reference(pipeline, num_blocks):
    data = _blocks_data()

    def port():
        df = tft.frame_from_arrays(dict(data), num_blocks=num_blocks)
        return tft.map_blocks(lambda x, i: {"y": x * 2.0 + 1.0, "j": i * 3}, df,
                              device="cpu")

    t, serial = port(), _serial(port)
    j = tfs.map_blocks(lambda x, i: {"y": x * 2.0 + 1.0, "j": i * 3},
                       tfs.frame_from_arrays(dict(data), num_blocks=num_blocks))
    assert str(t.schema) == str(j.schema)
    assert [len(b["y"]) for b in t.blocks()] == [len(b["y"]) for b in j.blocks()]
    for c in ("y", "j", "x", "i"):
        _bits_equal(t.column_values(c), serial.column_values(c))
        _bits_equal(t.column_values(c), j.column_values(c))


@pytest.mark.parametrize("pipeline", SETTINGS, indirect=True)
def test_map_blocks_trim_pipelined(pipeline):
    data = _blocks_data(300)

    def run(pkg, lib):
        df = pkg.frame_from_arrays(dict(data), num_blocks=5)
        kw = {"device": "cpu"} if pkg is tft else {}
        return pkg.map_blocks(lambda x: {"s": lib.sum(x, 0, keepdims=True)}, df, trim=True,
                              **kw)

    t, j = run(tft, torch), run(tfs, jnp)
    assert [len(b["s"]) for b in t.blocks()] == [1] * 5
    np.testing.assert_allclose(t.column_values("s"), j.column_values("s"), rtol=1e-6)
    _bits_equal(t.column_values("s"), _serial(lambda: run(tft, torch)).column_values("s"))


@pytest.mark.parametrize("pipeline", SETTINGS, indirect=True)
def test_map_blocks_readbacks_lag_by_the_depth(pipeline, monkeypatch):
    """Block k's outputs are waited for only after block k + depth has
    been dispatched; the prefetcher runs iff asked for and the frame has
    more than one block."""
    depth, prefetch = pipeline
    events, prefetched = [], []
    real_start = tverbs.Readback

    class Tracked:
        def __init__(self, k, pending):
            self.k, self.pending = k, pending

        def wait(self):
            events.append(("wait", self.k))
            return self.pending.wait()

    def start(outs):
        k = sum(1 for e in events if e[0] == "dispatch")
        events.append(("dispatch", k))
        return Tracked(k, real_start(outs))

    from tensorframes_tpu_torch import io as tio

    real_prefetch = tio.prefetch_to_device
    monkeypatch.setattr(tverbs, "Readback", start)
    monkeypatch.setattr(tio, "prefetch_to_device",
                        lambda *a, **k: prefetched.append(k["size"]) or real_prefetch(*a, **k))
    df = tft.frame_from_arrays(_blocks_data(60), num_blocks=6)
    tft.map_blocks(lambda x: {"y": x + 1.0}, df, device="cpu").blocks()
    want = []
    for k in range(6):
        want.append(("dispatch", k))
        if k - depth >= 0:
            want.append(("wait", k - depth))
    want += [("wait", k) for k in range(max(0, 6 - depth), 6)]
    assert events == want
    assert prefetched == ([prefetch] if prefetch else [])


@pytest.mark.parametrize("pipeline", SETTINGS, indirect=True)
def test_map_blocks_row_count_error_inside_the_window(pipeline):
    """A block whose output has the wrong row count raises the reference's
    ValidationError, word for word, whichever block of the window it is."""
    data = {"x": np.arange(40.0)}
    msgs = []
    for pkg, kw in ((tfs, {}), (tft, {"device": "cpu"})):
        df = pkg.frame_from_arrays(dict(data), num_blocks=4)
        with pytest.raises(pkg.ValidationError) as ei:
            pkg.map_blocks(lambda x: {"y": x[1:]}, df, **kw).blocks()
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]
    assert "produced 9 rows for a block of 10 rows" in msgs[1]


@pytest.mark.parametrize("pipeline", SETTINGS, indirect=True)
def test_map_blocks_feed_error_reaches_the_caller(pipeline, monkeypatch):
    """An exception raised while a block's feeds are gathered (on the
    prefetch worker when there is one) reaches the caller, and no worker
    thread outlives the call."""
    real = tverbs.gather_feeds
    seen = []

    def failing(b, names, program):
        seen.append(1)
        if len(seen) == 3:
            raise RuntimeError("feed 3 failed")
        return real(b, names, program)

    monkeypatch.setattr(tverbs, "gather_feeds", failing)
    before = set(threading.enumerate())
    df = tft.frame_from_arrays(_blocks_data(60), num_blocks=6)
    with pytest.raises(RuntimeError, match="feed 3 failed"):
        tft.map_blocks(lambda x: {"y": x + 1.0}, df, device="cpu").blocks()
    for t in threading.enumerate():
        if t.name == "tftorch-prefetch" and t not in before:
            t.join(timeout=10)
            assert not t.is_alive()


@pytest.mark.parametrize("pipeline", SETTINGS, indirect=True)
def test_map_blocks_ragged_block_error_matches_reference(pipeline):
    """A ragged column fed whole to map_blocks raises the reference's
    ValueError from the feed gather, through the prefetch worker too."""
    rows = [{"r": [1.0] * (1 + i % 2)} for i in range(8)]
    msgs = []
    for pkg, fn, kw in ((tfs, lambda r: {"y": r + 1.0}, {}),
                        (tft, lambda r: {"y": r + 1.0}, {"device": "cpu"})):
        df = pkg.frame_from_rows(rows, num_blocks=4)
        with pytest.raises(ValueError) as ei:
            pkg.map_blocks(fn, df, **kw).blocks()
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]
    assert "map_rows" in msgs[1]


def test_readback_on_the_cpu_returns_numpy():
    out = texec.Readback({"a": torch.arange(4), "b": torch.ones(2, 3)}).wait()
    assert isinstance(out["a"], np.ndarray) and out["a"].tolist() == [0, 1, 2, 3]
    assert out["b"].shape == (2, 3)


# ---------------------------------------------------------------------------
# ragged map_rows
# ---------------------------------------------------------------------------

def _ragged_rows(n=600, seed=3, dtype="float32"):
    rng = np.random.default_rng(seed)
    return [{"r": (rng.standard_normal(int(m)) * 10).astype(dtype)}
            for m in rng.integers(1, 40, n)]


def _host_rows():
    rng = np.random.default_rng(9)
    rows = []
    for m in rng.integers(1, 12, 200):
        v = rng.standard_normal(int(m)).astype(np.float32)
        rows.append({"r": v, "q": v[::-1].copy()})
    return rows


def _ragged_call(pkg, rows, two_inputs=False, num_blocks=3):
    df = pkg.frame_from_rows(rows, num_blocks=num_blocks)
    kw = {"device": "cpu"} if pkg is tft else {}
    with pkg.with_graph():
        r = pkg.placeholder("float32", (None,), name="r")
        fetches = [pkg.reduce_max(r, name="m"), pkg.mul(r, 2.0, name="t")]
        if two_inputs:
            q = pkg.placeholder("float32", (None,), name="q")
            fetches = [pkg.reduce_max(pkg.add(r, q), name="m")]
        return pkg.map_rows(fetches, df, **kw)


def _cells(frame, names=("m", "t")):
    return {c: [r[c] for r in frame.collect()] for c in names if c in frame.schema.names}


@functools.lru_cache(maxsize=None)
def _references(two_inputs):
    """The JAX package's and the port's serial cells for a feed, computed
    once for the module (the feed is fixed by its seed)."""
    rows = _host_rows() if two_inputs else _ragged_rows()
    return (_cells(_ragged_call(tfs, rows, two_inputs)),
            _cells(_serial(lambda: _ragged_call(tft, rows, two_inputs))))


def _ragged_equal(got, two_inputs=False):
    """``got``'s cells equal, bit for bit, the serial run's and the JAX
    package's."""
    cells = _cells(got)
    for ref in _references(two_inputs):
        assert list(cells) == list(ref)
        for c in cells:
            assert len(cells[c]) == len(ref[c])
            for x, y in zip(cells[c], ref[c]):
                _bits_equal(x, y)


@pytest.mark.parametrize("pipeline", SETTINGS, indirect=True)
@pytest.mark.parametrize("stage_bytes", [None, 4096, 0])
def test_ragged_map_rows_waves_equal_serial_and_reference(pipeline, stage_bytes,
                                                          monkeypatch):
    """Waves forced by a small staging cap (0: one group a wave): one
    gather plan per wave, and the same bits as the serial run and the JAX
    package."""
    from tensorframes_tpu_torch.kernels import ragged_gather as krg

    rows = _ragged_rows()
    groups = len({len(r["r"]) for r in rows})
    _references(False)  # before the cap is patched
    if stage_bytes is not None:
        monkeypatch.setattr(tverbs, "_RAGGED_STAGE_BYTES", stage_bytes)
    plans = []
    real = krg.plan_launches
    monkeypatch.setattr(krg, "plan_launches",
                        lambda flat, g: plans.append(len(g)) or real(flat, g))
    t = _ragged_call(tft, rows)
    t.blocks()
    assert sum(plans) == groups
    if stage_bytes == 0:
        assert plans == [1] * groups
    elif stage_bytes is None:
        assert plans == [groups]
    else:
        assert 1 < len(plans) < groups
    _ragged_equal(t)


@pytest.mark.parametrize("pipeline", SETTINGS, indirect=True)
@pytest.mark.parametrize("stage_bytes", [None, 0])
def test_ragged_map_rows_host_staged_waves(pipeline, stage_bytes, monkeypatch):
    """Two ragged inputs stage on the host, wave by wave; the same bits as
    the serial run and the JAX package."""
    _references(True)  # before the cap is patched
    if stage_bytes is not None:
        monkeypatch.setattr(tverbs, "_RAGGED_STAGE_BYTES", stage_bytes)
    _ragged_equal(_ragged_call(tft, _host_rows(), two_inputs=True), two_inputs=True)


@pytest.mark.parametrize("pipeline", SETTINGS, indirect=True)
def test_ragged_map_rows_window(pipeline, monkeypatch):
    """Group g's outputs are waited for only once group g + depth has been
    dispatched (depth 0: right after its own dispatch)."""
    depth, _ = pipeline
    events = []
    real_start = tverbs.Readback

    class Tracked:
        def __init__(self, k, pending):
            self.k, self.pending = k, pending

        def wait(self):
            events.append(("wait", self.k))
            return self.pending.wait()

    def start(outs):
        k = sum(1 for e in events if e[0] == "dispatch")
        events.append(("dispatch", k))
        return Tracked(k, real_start(outs))

    monkeypatch.setattr(tverbs, "Readback", start)
    rows = _ragged_rows(100)
    groups = len({len(r["r"]) for r in rows})
    _ragged_call(tft, rows).blocks()
    want = []
    for k in range(groups):
        want.append(("dispatch", k))
        if k - depth >= 0:
            want.append(("wait", k - depth))
    want += [("wait", k) for k in range(max(0, groups - depth), groups)]
    assert events == want


def test_knob_defaults_and_environment_names():
    """The reference's defaults and environment variables."""
    import subprocess
    import sys

    cfg, ref = tft.get_config(), jconfig.Config()
    assert (cfg.map_pipeline_depth, cfg.map_prefetch_depth, cfg.aggregate_buffer_size) == (
        ref.map_pipeline_depth, ref.map_prefetch_depth, ref.aggregate_buffer_size) == (2, 2, 10)
    code = ("from tensorframes_tpu_torch.config import get_config as g; c = g(); "
            "print(c.map_pipeline_depth, c.map_prefetch_depth, c.aggregate_buffer_size)")
    env = {"TFTPU_MAP_PIPELINE_DEPTH": "5", "TFTPU_MAP_PREFETCH_DEPTH": "0",
           "TFTPU_AGG_BUFFER": "3"}
    import os
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=dict(os.environ, **env), timeout=120)
    assert out.stdout.split() == ["5", "0", "3"], out.stderr
