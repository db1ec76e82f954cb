"""The decode server of the port on the CPU: the engine's tokens against
the port's ``generate`` and the JAX package's ``generate(kv_quant=True)``
(exact: ``gpt_tiny`` in f32, the reference's weights carried across),
batched against solo and preempted against unpreempted (exact: both sides
run the same code), the pool's accounting, the admission and deadline
taxonomy, and the device and option contracts. Inputs come from numpy
seeds.
"""

import time

import jax
import numpy as np
import pytest
import torch

import tensorframes_tpu_torch as tft
from tensorframes_tpu.models import generation as jgen
from tensorframes_tpu.models import transformer as jtr
from tensorframes_tpu_torch.models import generation as tgen
from tensorframes_tpu_torch.models import transformer as ttr
from tensorframes_tpu_torch.serving import (
    DeadlineExceededError,
    DecodeConfig,
    DecodeEngine,
    PagedKVPool,
    PoolAccountingError,
    PoolExhaustedError,
    RejectedError,
    Server,
    ServingConfig,
    ServingError,
    UnknownEndpointError,
)
from tensorframes_tpu_torch.serving import metrics as sm
from tensorframes_tpu_torch.validation import ValidationError

CPU = "cpu"


@pytest.fixture(scope="module")
def model():
    cj = jgen.gpt_tiny()
    pj = jtr.quantize_params(jtr.init_params(cj, seed=0))
    pt = ttr.params_from_jax(jax.tree_util.tree_map(np.asarray, pj), CPU)
    return tgen.gpt_tiny(), pt, cj, pj


@pytest.fixture(scope="module")
def engine(model):
    cfg, params, _, _ = model
    eng = DecodeEngine("t_shared", cfg, params, DecodeConfig(
        max_slots=4, page_size=8, max_prompt_len=16, max_new_tokens=8), device=CPU)
    eng.start()
    yield eng
    eng.stop(drain=True, timeout=120)


def _prompts(n, lo, hi, seed, vocab):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (int(rng.integers(lo, hi + 1)),)).astype(np.int32)
            for _ in range(n)]


def _port_reference(model, prompt, new):
    cfg, params, _, _ = model
    return tgen.generate(cfg, params, prompt[None], new, kv_quant=True).numpy()


def _hog_pool(pool):
    seqs = []
    while pool.num_free:
        seq = 10_000 + len(seqs)
        pool.alloc(seq, min(pool.num_free, pool.max_pages_per_seq))
        seqs.append(seq)
    return seqs


def _unhog_pool(pool, seqs):
    for s in seqs:
        pool.free_seq(s)


# ---------------------------------------------------------------------------
# engine correctness
# ---------------------------------------------------------------------------

def test_engine_tokens_equal_port_and_jax_generate(model, engine):
    cfg, _, cj, pj = model
    rng = np.random.default_rng(5)
    prompts = rng.integers(0, cfg.vocab_size, (4, 11)).astype(np.int32)
    outs = [f.result(120)["tokens"] for f in [engine.submit({"prompt": p}) for p in prompts]]
    want = np.asarray(jgen.generate(cj, pj, prompts, 8, kv_quant=True))
    np.testing.assert_array_equal(np.concatenate(outs), want)
    np.testing.assert_array_equal(
        tgen.generate(cfg, model[1], prompts, 8, kv_quant=True).numpy(), want)


def test_batched_decode_bit_identical_to_solo(model, engine):
    cfg = model[0]
    prompts = _prompts(6, 3, 16, seed=11, vocab=cfg.vocab_size)
    futs = [engine.submit({"prompt": p}) for p in prompts]
    outs = [f.result(120)["tokens"] for f in futs]
    solo = [engine.call({"prompt": p}, timeout=120)["tokens"] for p in prompts]
    for i, p in enumerate(prompts):
        assert outs[i].shape == (1, 8) and outs[i].dtype == np.int32
        np.testing.assert_array_equal(outs[i], solo[i], err_msg=f"request {i}: batched != solo")
        np.testing.assert_array_equal(outs[i], _port_reference(model, p, 8))


def test_decode_future_records_its_ttft(model, engine):
    """Each decode future carries its own submit-to-first-token time, one
    observation of the TTFT histogram, no later than its whole latency."""
    cfg = model[0]
    n0 = sm.DECODE_TTFT.count
    t0 = time.perf_counter()
    futs = [engine.submit({"prompt": p}) for p in _prompts(5, 3, 16, seed=13,
                                                           vocab=cfg.vocab_size)]
    for f in futs:
        f.result(120)
    wall = time.perf_counter() - t0
    assert sm.DECODE_TTFT.count - n0 == 5
    for f in futs:
        assert f.ttft_s is not None and 0.0 < f.ttft_s <= wall


def test_variable_max_new_tokens_per_request(model, engine):
    p = _prompts(1, 5, 10, seed=31, vocab=model[0].vocab_size)[0]
    out3 = engine.call({"prompt": p, "max_new_tokens": 3}, timeout=120)
    out8 = engine.call({"prompt": p, "max_new_tokens": 8}, timeout=120)
    assert out3["tokens"].shape == (1, 3) and out8["tokens"].shape == (1, 8)
    np.testing.assert_array_equal(out3["tokens"][0], out8["tokens"][0, :3])


@pytest.mark.parametrize("slots,page,pages,plen,new,n", [
    (4, 8, 5, 16, 8, 5),   # one horizon + 1 spare page
    (3, 4, 5, 8, 8, 4),    # the floor: exactly one horizon
])
def test_undersized_pool_preempts_and_completes_bit_identically(model, slots, page, pages,
                                                                plen, new, n):
    cfg, params, _, _ = model
    eng = DecodeEngine(f"t_small_pool_{pages}_{page}", cfg, params, DecodeConfig(
        max_slots=slots, page_size=page, num_pages=pages, max_prompt_len=plen,
        max_new_tokens=new), device=CPU)
    eng.start()
    try:
        pre0, ev0 = sm.DECODE_PREEMPTIONS.value, sm.DECODE_EVICTIONS.value
        tok0 = sm.DECODE_TOKENS.value
        prompts = _prompts(n, plen - 4, plen, seed=41 + page, vocab=cfg.vocab_size)
        outs = [f.result(300)["tokens"] for f in [eng.submit({"prompt": p}) for p in prompts]]
        assert sm.DECODE_PREEMPTIONS.value - pre0 > 0, "undersized pool never preempted"
        assert sm.DECODE_EVICTIONS.value - ev0 > 0
        # replayed tokens are recompute, not progress
        assert sm.DECODE_TOKENS.value - tok0 == n * new
        for p, o in zip(prompts, outs):
            np.testing.assert_array_equal(o, _port_reference(model, p, new))
    finally:
        eng.stop(drain=True, timeout=300)
    eng.pool.check()
    assert eng.pool.num_free == eng.pool.usable_pages


def test_replay_divergence_fails_the_request_loudly(model):
    """A resumed sequence whose recomputed token differs from its record
    fails with ServingError (counted); the engine keeps serving."""
    cfg, params, _, _ = model
    eng = DecodeEngine("t_diverge", cfg, params, DecodeConfig(
        max_slots=2, page_size=4, max_prompt_len=8, max_new_tokens=4), device=CPU)
    eng.start()
    try:
        p = np.arange(5, dtype=np.int32)
        want = eng.call({"prompt": p}, timeout=120)["tokens"][0]
        hogs = _hog_pool(eng.pool)
        fut = eng.submit({"prompt": p})
        req = eng._admission._queue[0]
        eng._resume[req] = [int(want[0]) + 1, int(want[1])]  # a corrupted record
        e0 = sm.DISPATCH_ERRORS.value
        _unhog_pool(eng.pool, hogs)
        with pytest.raises(ServingError, match="diverged"):
            fut.result(120)
        assert sm.DISPATCH_ERRORS.value - e0 == 1
        np.testing.assert_array_equal(eng.call({"prompt": p}, timeout=120)["tokens"][0], want)
    finally:
        eng.stop(drain=True, timeout=120)
    eng.pool.check()


def test_step_failure_fails_running_requests_loudly(model):
    cfg, params, _, _ = model
    eng = DecodeEngine("t_fail", cfg, params, DecodeConfig(
        max_slots=2, page_size=4, max_prompt_len=8, max_new_tokens=4), device=CPU)
    eng.start()

    def broken(*args, **kwargs):
        raise RuntimeError("decode_attention kernel launch failed: CUDA error 700")

    eng._step = broken
    try:
        hogs = _hog_pool(eng.pool)  # all three queue before the first step fails
        futs = [eng.submit({"prompt": np.arange(3 + i, dtype=np.int32)}) for i in range(3)]
        _unhog_pool(eng.pool, hogs)
        for f in futs:
            with pytest.raises(ServingError, match="CUDA error 700"):
                f.result(60)
        with pytest.raises(RejectedError):
            eng.submit({"prompt": np.arange(3, dtype=np.int32)})
    finally:
        eng.stop(drain=False, timeout=60)


# ---------------------------------------------------------------------------
# KV pool accounting
# ---------------------------------------------------------------------------

def test_kvpool_property_sweep_no_leak_no_double_free(model):
    cfg = model[0]
    pool = PagedKVPool(cfg, num_pages=17, page_size=4, max_pages_per_seq=4, device=CPU)
    rng = np.random.default_rng(7)
    live, next_seq = {}, 0
    for _ in range(500):
        op = rng.integers(0, 3)
        if op == 0:
            n = int(rng.integers(1, 4))
            if pool.num_free >= n:
                pool.alloc(next_seq, n)
                live[next_seq] = n
                next_seq += 1
        elif op == 1 and live:
            seq = int(rng.choice(list(live)))
            if live[seq] < pool.max_pages_per_seq and pool.num_free:
                pool.alloc(seq, 1)
                live[seq] += 1
        elif op == 2 and live:
            seq = int(rng.choice(list(live)))
            assert pool.free_seq(seq) == live.pop(seq)
        pool.check()
        assert pool.num_free == pool.usable_pages - sum(live.values())
    for seq in list(live):
        pool.free_seq(seq)
    pool.check()
    assert pool.num_free == pool.usable_pages
    pool.close()


def test_kvpool_exhaustion_double_free_floor_and_table(model):
    cfg = model[0]
    pool = PagedKVPool(cfg, num_pages=4, page_size=4, max_pages_per_seq=3, device=CPU)
    pool.alloc(0, 3)
    with pytest.raises(PoolExhaustedError):
        pool.alloc(1, 1)
    with pytest.raises(PoolAccountingError):
        pool.alloc(0, 1)  # over the per-sequence cap
    assert pool.free_seq(0) == 3 and pool.free_seq(0) == 0
    pool._owned[5] = [1]  # page 1 is free: corruption
    with pytest.raises(PoolAccountingError):
        pool.free_seq(5)
    with pytest.raises(PoolAccountingError):
        pool.check()
    del pool._owned[5]
    pool.check()
    with pytest.raises(ValueError):
        PagedKVPool(cfg, num_pages=3, page_size=4, max_pages_per_seq=3, device=CPU)
    pool = PagedKVPool(cfg, num_pages=5, page_size=4, max_pages_per_seq=3, device=CPU)
    got = pool.alloc(9, 2)
    table = pool.table(9)
    assert table.shape == (3,) and table.dtype == np.int32
    assert list(table[:2]) == got and table[2] == 0
    assert not pool.null_table().any() and pool.pages_needed(9) == 3
    fr = pool.as_frame()
    assert fr.num_rows == 5
    assert set(fr.schema.names) == {"k", "v", "k_scale", "v_scale"}
    free0 = sm.DECODE_FREE_PAGES.value
    pool.close()
    assert sm.DECODE_FREE_PAGES.value == free0 - pool.num_free
    pool.reopen()
    assert sm.DECODE_FREE_PAGES.value == free0


def test_bucket_ladders_match_jax():
    from tensorframes_tpu import compilecache as jcc
    from tensorframes_tpu_torch import compilecache as tcc

    for n in (1, 4, 13, 16, 128):
        assert tcc.serving_row_buckets(n) == jcc.serving_row_buckets(n)
        assert tcc.decode_slot_buckets(n) == jcc.decode_slot_buckets(n)
    assert tcc.decode_warmup_grid(16, 128) == jcc.decode_warmup_grid(16, 128)
    with pytest.raises(ValueError):
        tcc.decode_slot_buckets(0)


# ---------------------------------------------------------------------------
# admission, deadlines, lifecycle
# ---------------------------------------------------------------------------

def test_full_pool_cannot_hold_request_past_deadline(model):
    cfg, params, _, _ = model
    eng = DecodeEngine("t_deadline", cfg, params, DecodeConfig(
        max_slots=2, page_size=4, max_prompt_len=8, max_new_tokens=4), device=CPU)
    eng.start()
    try:
        hogs = _hog_pool(eng.pool)
        d0 = sm.DEADLINE_EXPIRED.value
        fut = eng.submit({"prompt": np.arange(5, dtype=np.int32)}, deadline_s=0.2)
        t0 = time.perf_counter()
        with pytest.raises(DeadlineExceededError):
            fut.result(10)
        assert time.perf_counter() - t0 < 5.0
        assert sm.DEADLINE_EXPIRED.value - d0 >= 1
        _unhog_pool(eng.pool, hogs)
        assert eng.call({"prompt": np.arange(5, dtype=np.int32)},
                        timeout=120)["tokens"].shape == (1, 4)
    finally:
        eng.stop(drain=True, timeout=120)


def test_admission_taxonomy_and_validation(model):
    cfg, params, _, _ = model
    eng = DecodeEngine("t_taxonomy", cfg, params, DecodeConfig(
        max_slots=1, page_size=4, max_prompt_len=8, max_new_tokens=4,
        max_queue_requests=2, warmup=False), device=CPU)
    with pytest.raises(RejectedError) as ri:
        eng.submit({"prompt": np.arange(3, dtype=np.int32)})
    assert ri.value.reason == "closed"
    eng.start()
    try:
        for bad in ([1, 2, 3], {"tokens": [1, 2]}, {"prompt": [1, 2], "temperature": 0.5},
                    {"prompt": []}, {"prompt": [[1, 2], [3, 4]]},
                    {"prompt": [0, cfg.vocab_size]}, {"prompt": [1], "max_new_tokens": 0},
                    {"prompt": [1], "max_new_tokens": "x"}):
            with pytest.raises(ValidationError):
                eng.submit(bad)
        with pytest.raises(ValueError):
            eng.submit({"prompt": [1]}, deadline_s=0.0)
        r0 = sm.rejected("too_large").value
        with pytest.raises(RejectedError) as ri:
            eng.submit({"prompt": np.zeros(9, np.int32)})
        assert ri.value.reason == "too_large" and sm.rejected("too_large").value == r0 + 1
        hogs = _hog_pool(eng.pool)
        futs = [eng.submit({"prompt": np.arange(4, dtype=np.int32)}) for _ in range(2)]
        with pytest.raises(RejectedError) as ri:
            eng.submit({"prompt": np.arange(4, dtype=np.int32)})
        assert ri.value.reason == "queue_full"
        assert eng.counters()["rejected"]["queue_full"] == 1
        _unhog_pool(eng.pool, hogs)
        for f in futs:
            assert f.result(120)["tokens"].shape == (1, 4)
    finally:
        eng.stop(drain=True, timeout=120)
    with pytest.raises(RejectedError) as ri:
        eng.submit({"prompt": np.arange(3, dtype=np.int32)})
    assert ri.value.reason == "closed"


def test_stop_without_drain_fails_loudly(model):
    cfg, params, _, _ = model
    eng = DecodeEngine("t_nodrain", cfg, params, DecodeConfig(
        max_slots=1, page_size=4, max_prompt_len=8, max_new_tokens=4, warmup=False),
        device=CPU)
    eng.start()
    _hog_pool(eng.pool)
    futs = [eng.submit({"prompt": np.arange(4, dtype=np.int32)}) for _ in range(2)]
    eng.stop(drain=False, timeout=60)
    for f in futs:
        with pytest.raises(ServingError):
            f.result(10)


def test_engine_config_validation_and_unported_options(model):
    cfg, params, _, _ = model
    with pytest.raises(ValueError):
        DecodeEngine("t_bad", cfg, params, DecodeConfig(max_prompt_len=40, max_new_tokens=40),
                     device=CPU)
    with pytest.raises(ValueError):
        DecodeEngine("t_bad2", cfg, params, DecodeConfig(max_slots=0), device=CPU)
    # the KV tiers are ported: both options build an engine that arms them
    for opt in ("prefix_cache", "kv_swap"):
        eng = DecodeEngine("t_opt", cfg, params, DecodeConfig(warmup=False, **{opt: True}),
                           device=CPU)
        assert getattr(eng, f"_{opt}") is True
        eng.stop()


def test_cuda_asked_without_a_gpu_raises(model, monkeypatch):
    cfg, params, _, _ = model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        DecodeEngine("t_cuda", cfg, params, DecodeConfig())
    with pytest.raises(RuntimeError, match="is_available"):
        DecodeEngine("t_cuda", cfg, params, DecodeConfig(), device="cuda")
    with pytest.raises(RuntimeError, match="is_available"):
        Server()
    assert tft.get_config().device == "cuda"


def test_server_register_decode_submit_and_stats(model):
    cfg, params, _, _ = model
    srv = Server(ServingConfig(default_deadline_s=60.0), device=CPU)
    eng = srv.register_decode("gen", cfg, params, DecodeConfig(
        max_slots=2, page_size=4, max_prompt_len=8, max_new_tokens=4))
    assert eng.config.default_deadline_s == 60.0 and eng.device == torch.device("cpu")
    with pytest.raises(ValueError):
        srv.register_decode("gen", cfg, params)
    with pytest.raises(ValueError):
        srv.register_decode("a/b", cfg, params)
    assert srv.state == "stopped" and srv.endpoints() == ["gen"]
    with srv:
        assert srv.running and srv.state == "running"
        p = np.arange(6, dtype=np.int32)
        out = srv.call("gen", {"prompt": p}, timeout=120)
        np.testing.assert_array_equal(out["tokens"], _port_reference(model, p, 4))
        futs = [srv.submit("gen", {"prompt": p + i}) for i in range(3)]
        assert all(f.result(120)["tokens"].shape == (1, 4) for f in futs)
        with pytest.raises(UnknownEndpointError):
            srv.submit("nope", {"prompt": p})
        # a late registration on a live server warms and starts at once
        late = srv.register_decode("late", cfg, params, DecodeConfig(
            max_slots=1, page_size=4, max_prompt_len=8, max_new_tokens=2))
        assert late.running
        assert srv.call("late", {"prompt": p}, timeout=120)["tokens"].shape == (1, 2)
        st = srv.stats()
        assert st["endpoints"] == ["gen", "late"] and st["state"] == "running"
        assert st["admitted_requests"] == 5 and st["decode"]["gen"]["running_slots"] == 0
        assert st["latency"]["gen"]["p50"] is not None
    assert srv.state == "stopped"
    with pytest.raises(RejectedError):
        srv.submit("gen", {"prompt": p})


def test_decode_metrics_preregistered():
    from tensorframes_tpu.serving import metrics as jsm
    from tensorframes_tpu_torch.observability.metrics import REGISTRY

    names = {d["name"] for d in REGISTRY.snapshot()}
    for inst in ("DECODE_TOKENS", "DECODE_TTFT", "DECODE_SLOTS", "DECODE_FREE_PAGES",
                 "DECODE_PREEMPTIONS", "DECODE_EVICTIONS", "REQUESTS", "QUEUE_DEPTH",
                 "REQUEST_LATENCY", "DEADLINE_EXPIRED", "DISPATCH_ERRORS"):
        assert getattr(sm, inst).name == getattr(jsm, inst).name
        assert getattr(sm, inst).name in names
    for phase in sm.DECODE_PHASES:
        assert sm.DECODE_STEPS[phase].name == jsm.DECODE_STEPS[phase].name
    assert sm.REJECT_REASONS == jsm.REJECT_REASONS


def test_gauge_and_histogram_quantiles_match_jax():
    import threading as th

    from tensorframes_tpu.observability import metrics as jm
    from tensorframes_tpu_torch.observability import metrics as tm

    rng = np.random.default_rng(3)
    obs = rng.exponential(0.05, 200)
    a = jm.Histogram("h", "", (), th.Lock(), buckets=sm.LATENCY_BUCKETS)
    b = tm.Histogram("h", "", (), th.Lock(), buckets=sm.LATENCY_BUCKETS)
    assert b.quantile(0.5) is None
    for v in obs:
        a.observe(v)
        b.observe(v)
    assert b.quantiles() == a.quantiles()
    assert b.quantiles((0.1, 0.9)) == a.quantiles((0.1, 0.9))
    g = tm.Gauge("g", "", (), th.Lock())
    g.inc(3)
    g.dec(1.5)
    assert g.value == 1.5
    g.set(7)
    assert g.value == 7.0
    g._zero()
    assert g.value == 0.0
    assert tm.gauge("tftpu_decode_free_pages") is sm.DECODE_FREE_PAGES
    with pytest.raises(ValueError):
        tm.counter("tftpu_decode_free_pages")


def test_concurrent_submitters_all_answered(model, engine):
    """Eight threads submit at once, with the interpreter switching often:
    every request is admitted once and answered with its solo tokens."""
    import sys
    import threading

    cfg = model[0]
    prompts = _prompts(16, 3, 16, seed=53, vocab=cfg.vocab_size)
    want = [_port_reference(model, p, 8) for p in prompts]
    admitted0 = engine.counters()["admitted_requests"]
    results = [None] * len(prompts)

    def worker(i0):
        for i in range(i0, len(prompts), 8):
            results[i] = engine.submit({"prompt": prompts[i]}).result(120)["tokens"]

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(180)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert engine.counters()["admitted_requests"] - admitted0 == len(prompts)
    for got, w in zip(results, want):
        np.testing.assert_array_equal(got, w)
