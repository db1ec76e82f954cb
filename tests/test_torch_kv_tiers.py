"""The decode server's two KV tiers in the port against the JAX package on
the CPU, at ``gpt_tiny`` (f32, the reference's int8 weights carried
across by ``params_from_jax``), inputs from numpy seeds:

* ``paged_suffix_prefill_fn`` and ``paged_page_ops_fns`` against the JAX
  functions: the written pages' int8 K/V and the page ops exactly equal,
  the suffix prefill's f32 scales within rtol 2e-6 (the K/V feeding them
  differ in the last f32 bits, from another matmul summation order — the
  tolerance ``test_torch_generation`` states for the cold prefill), the
  first token equal;
* the pool's prefix-cache and swap operations interleaved at random on
  both pools: the same tables, refcounts, free lists and LRU after every
  step, ``check()`` passing; swap misuse raising alike;
* the engines: prefix hits (suffix prefill and copy-on-extend), swap
  resume on an undersized pool, a corrupted segment's counted fallback
  and spill/restore across engines all return the JAX engine's tokens
  exactly, with the same hit/miss counts and ineligibility records.
"""

import os
import time

import jax
import numpy as np
import pytest
import torch

from tensorframes_tpu.blockstore import BlockStore as JBlockStore
from tensorframes_tpu.models import generation as jgen
from tensorframes_tpu.models import transformer as jtr
from tensorframes_tpu.serving import DecodeConfig as JDecodeConfig
from tensorframes_tpu.serving import DecodeEngine as JDecodeEngine
from tensorframes_tpu.serving import PagedKVPool as JPagedKVPool
from tensorframes_tpu.serving import decode as jdec
from tensorframes_tpu_torch.blockstore import BlockCorruptionError, BlockStore
from tensorframes_tpu_torch.models import generation as tgen
from tensorframes_tpu_torch.models import transformer as ttr
from tensorframes_tpu_torch.observability import context as tctx
from tensorframes_tpu_torch.serving import (
    DecodeConfig,
    DecodeEngine,
    PagedKVPool,
    prefix_cache_events,
)
from tensorframes_tpu_torch.serving import metrics as sm

CPU = "cpu"
KV = ("k", "v", "k_scale", "v_scale")
NEW = 8


@pytest.fixture(scope="module")
def model():
    cj = jgen.gpt_tiny()
    pj = jtr.quantize_params(jtr.init_params(cj, seed=0))
    pt = ttr.params_from_jax(jax.tree_util.tree_map(np.asarray, pj), CPU)
    return tgen.gpt_tiny(), pt, cj, pj


def _prompts(n, lo, hi, seed, vocab=97):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (int(rng.integers(lo, hi + 1)),)).astype(np.int32)
            for _ in range(n)]


def _swap_cfg(cls, **kw):
    return cls(max_slots=4, page_size=8, num_pages=1 + 2 * 3, max_prompt_len=16,
               max_new_tokens=NEW, kv_swap=True, **kw)


@pytest.fixture(scope="module")
def swap_prompts():
    return _prompts(8, 9, 16, seed=61)


@pytest.fixture(scope="module")
def jax_swap_tokens(model, swap_prompts, tmp_path_factory):
    """The JAX engine's tokens for ``swap_prompts`` on the undersized
    swapping pool (its own tests hold them to its cold oracle)."""
    _, _, cj, pj = model
    eng = JDecodeEngine("j_swap", cj, pj, _swap_cfg(
        JDecodeConfig, swap_dir=str(tmp_path_factory.mktemp("jswap"))))
    eng.start()
    try:
        futs = [eng.submit({"prompt": p}) for p in swap_prompts]
        return [np.asarray(f.result(300)["tokens"]) for f in futs]
    finally:
        eng.stop(drain=True, timeout=300)


# ---------------------------------------------------------------------------
# the step functions
# ---------------------------------------------------------------------------

def _random_pool(cj, ct, num_pages, page, seed):
    """The same random pool contents in both packages (int8 K/V, positive
    f32 scales)."""
    rng = np.random.default_rng(seed)
    shape = (num_pages, cj.num_layers, cj.num_heads, page, cj.head_dim)
    host = {
        "k": rng.integers(-127, 128, shape).astype(np.int8),
        "v": rng.integers(-127, 128, shape).astype(np.int8),
        "k_scale": rng.uniform(0.01, 0.1, shape[:-1] + (1,)).astype(np.float32),
        "v_scale": rng.uniform(0.01, 0.1, shape[:-1] + (1,)).astype(np.float32),
    }
    return ({k: jax.numpy.asarray(v) for k, v in host.items()},
            {k: torch.from_numpy(v.copy()) for k, v in host.items()})


@pytest.mark.parametrize("start,length", [(0, 5), (0, 13), (8, 3), (8, 8), (16, 7)])
def test_suffix_prefill_matches_jax(model, start, length):
    """A cold prefill writes the first ``start`` positions, then the suffix
    prefill writes ``[start, start + length)`` and attends the whole
    sequence through its table: the same pages and first token as the JAX
    package's."""
    ct, pt, cj, pj = model
    page, maxp, P = 8, 4, 8
    rng = np.random.default_rng(start * 31 + length)
    toks = rng.integers(0, cj.vocab_size, start + length).astype(np.int32)
    table = np.array([3, 6, 2, 0], np.int32)
    poolj = jgen.init_paged_kv(cj, P, page)
    poolt = tgen.init_paged_kv(ct, P, page, CPU)
    if start:
        padded = np.zeros(16, np.int32)
        padded[:start] = toks[:start]
        poolj, _ = jgen.paged_prefill_fn(cj, page, maxp)(pj, poolj, padded, np.int32(start),
                                                          table)
        tgen.paged_prefill_fn(ct, page, maxp)(pt, poolt, padded, start, table)
    suffix = np.zeros(16, np.int32)
    suffix[:length] = toks[start:]
    poolj, fj = jgen.paged_suffix_prefill_fn(cj, page, maxp)(
        pj, poolj, suffix, np.int32(start), np.int32(length), table)
    out, ft = tgen.paged_suffix_prefill_fn(ct, page, maxp)(pt, poolt, suffix, start, length,
                                                           table)
    assert out is poolt  # updated in place
    assert int(ft) == int(fj)
    pages = [int(p) for p in table[:-(-(start + length) // page)]]
    for k in KV:
        a, b = np.asarray(poolj[k])[pages], poolt[k].numpy()[pages]
        if k in ("k", "v"):
            np.testing.assert_array_equal(b, a)
        else:
            np.testing.assert_allclose(b, a, rtol=2e-6)


def test_page_ops_match_jax(model):
    ct, _, cj, _ = model
    poolj, poolt = _random_pool(cj, ct, 9, 4, seed=3)
    ex_j, rs_j, cp_j = jgen.paged_page_ops_fns(4)
    ex_t, rs_t, cp_t = tgen.paged_page_ops_fns(4)
    idx = np.array([3, 5, 0, 0], np.int32)
    got, want = ex_t(poolt, idx), ex_j(poolj, idx)
    for k in KV:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    # restore another pool's pages into 7, 2 (padding rows: the null page,
    # written with zeros by both)
    src_j, src_t = _random_pool(cj, ct, 9, 4, seed=4)
    pay = {k: np.array(ex_j(src_j, np.array([1, 8, 0, 0], np.int32))[k]) for k in KV}
    for k in KV:
        pay[k][2:] = 0
    dst = np.array([7, 2, 0, 0], np.int32)
    poolj = rs_j(poolj, dst, *(pay[k] for k in KV))
    assert rs_t(poolt, dst, *(pay[k] for k in KV)) is poolt
    poolj = cp_j(poolj, np.int32(3), np.int32(6))
    cp_t(poolt, 3, 6)
    for k in KV:
        np.testing.assert_array_equal(poolt[k].numpy(), np.asarray(poolj[k]))


# ---------------------------------------------------------------------------
# the pool
# ---------------------------------------------------------------------------

def _pool_state(pool):
    return (list(pool._free), {s: list(p) for s, p in pool._owned.items()},
            {s: list(p) for s, p in pool._refs.items() if p}, dict(pool._shared_ref),
            list(pool._shared_lru), pool.num_allocatable, pool.num_shared)


def test_pool_prefix_and_swap_interleaved_match_jax(model, tmp_path):
    """The random interleaving of the JAX package's pool sweep (join with
    prefix match, copy-on-extend and publish; extend; leave; swap out;
    swap in; publish again; a pressure burst) on both pools at once: the
    same state after every step, both ``check()``s passing, every op
    exercised, and the pool whole again at the end."""
    ct, _, cj, _ = model
    ps = 4
    pools = (JPagedKVPool(cj, num_pages=33, page_size=ps, max_pages_per_seq=6),
             PagedKVPool(ct, num_pages=33, page_size=ps, max_pages_per_seq=6, device=CPU))
    stores = (JBlockStore(root=str(tmp_path / "j"), budget_bytes=0),
              BlockStore(root=str(tmp_path / "t"), budget_bytes=0))
    rng = np.random.default_rng(19)
    vocab = 40
    templates = [rng.integers(0, vocab, (ps * 4,)).astype(np.int32) for _ in range(3)]
    live, swapped, next_seq = {}, [], [0]
    counts = dict(hits=0, cows=0, outs=0, resumes=0, published=0)

    def both(fn):
        out = [fn(p, s) for p, s in zip(pools, stores)]
        assert _pool_state(pools[0]) == _pool_state(pools[1])
        return out

    def fresh():
        next_seq[0] += 1
        return next_seq[0] - 1

    for _ in range(300):
        op = int(rng.integers(0, 7))
        if op == 0:
            t = templates[int(rng.integers(0, len(templates)))]
            plen = int(rng.integers(1, ps * 4 + 1))
            cut = int(rng.integers(0, plen + 1))
            tokens = np.concatenate([t[:cut], rng.integers(0, vocab, (plen - cut,))]
                                    ).astype(np.int32)
            need = pools[1].pages_needed(plen)
            if pools[1].num_allocatable < need:
                continue
            seq = fresh()
            m_j, m_t = both(lambda p, s: p.prefix_match(tokens))
            assert m_j == m_t
            matched, _, cow, _ = m_t
            if matched:
                both(lambda p, s: p.prefix_acquire(seq, matched))
                counts["hits"] += 1
            if cow is not None:
                d_j, d_t = both(lambda p, s: p.copy_on_extend(seq, cow))
                assert d_j == d_t
                counts["cows"] += 1
            else:
                both(lambda p, s: p.alloc(seq, need - len(matched)))
            if rng.integers(0, 2):
                n_j, n_t = both(lambda p, s: p.publish_prefix(seq, tokens))
                assert n_j == n_t
                counts["published"] += n_t
            live[seq] = tokens
        elif op == 1 and live:
            seq = int(rng.choice(sorted(live)))
            if (len(pools[1].seq_pages(seq)) < pools[1].max_pages_per_seq
                    and pools[1].num_allocatable >= 1):
                both(lambda p, s: p.alloc(seq, 1))
        elif op == 2 and live:
            seq = int(rng.choice(sorted(live)))
            f_j, f_t = both(lambda p, s: p.free_seq(seq))
            assert f_j == f_t
            del live[seq]
        elif op == 3 and live:
            seq = int(rng.choice(sorted(live)))
            npg = len(pools[1].seq_pages(seq))
            block = {"payload": np.full((npg, 3), seq, np.int32)}
            s_j, s_t = both(lambda p, s: p.swap_out_seq(s, seq, block))
            assert (s_j["pages"], s_j["freed"]) == (s_t["pages"], s_t["freed"]) == (
                npg, s_t["freed"])
            swapped.append((s_j, s_t, live.pop(seq)))
            counts["outs"] += 1
        elif op == 4 and swapped:
            s_j, s_t, toks = swapped.pop(int(rng.integers(0, len(swapped))))
            if pools[1].num_allocatable < int(s_t["pages"]):
                swapped.append((s_j, s_t, toks))
                continue
            seq = fresh()
            (pg_j, b_j), (pg_t, b_t) = both(
                lambda p, s: p.swap_in_seq(s, s_j if p is pools[0] else s_t, seq))
            assert pg_j == pg_t and len(pg_t) == int(s_t["pages"])
            np.testing.assert_array_equal(b_t["payload"], np.asarray(b_j["payload"]))
            live[seq] = toks
            counts["resumes"] += 1
        elif op == 5 and live:
            seq = int(rng.choice(sorted(live)))
            n_j, n_t = both(lambda p, s: p.publish_prefix(seq, live[seq]))
            assert n_j == n_t
            counts["published"] += n_t
        elif op == 6 and pools[1].num_allocatable >= 2:
            seq = fresh()
            both(lambda p, s: p.alloc(seq, 2))
            live[seq] = np.zeros(0, np.int32)
        for p in pools:
            p.check()
    assert all(counts.values()), counts
    for seq in sorted(live):
        both(lambda p, s: p.free_seq(seq))
    for s_j, s_t, _ in swapped:
        stores[0].drop(s_j["ref"])
        stores[1].drop(s_t["ref"])
    for p in pools:
        p.check()
        assert p.num_allocatable == p.usable_pages
    big = fresh()
    both(lambda p, s: p.alloc(big, p.max_pages_per_seq))
    both(lambda p, s: p.free_seq(big))
    for p, s in zip(pools, stores):
        p.check()
        p.close()
        s.close()


def _misuse(pool_cls, store_cls, cfg, root, **dev):
    """The JAX package's swap-misuse sequence; returns what each step
    raised (type name and message) or returned."""
    out = []
    pool = pool_cls(cfg, num_pages=9, page_size=4, max_pages_per_seq=4, **dev)
    store = store_cls(root=root, budget_bytes=0)
    try:
        pool.swap_out_seq(store, 7, {"x": np.zeros((1, 2), np.int8)})
    except Exception as e:
        out.append((type(e).__name__, str(e)))
    pool.alloc(1, 2)
    snap = pool.swap_out_seq(store, 1, {"x": np.zeros((2, 2), np.int8)})
    other = pool_cls(cfg, num_pages=9, page_size=8, max_pages_per_seq=4, **dev)
    try:
        other.swap_in_seq(store, snap, 1)
    except Exception as e:
        out.append((type(e).__name__, str(e)))
    try:
        pool.prefix_acquire(2, [5])
    except Exception as e:
        out.append((type(e).__name__, str(e)))
    try:
        pool.copy_on_extend(2, 3)
    except Exception as e:
        out.append((type(e).__name__, str(e)))
    pages, _ = pool.swap_in_seq(store, snap, 2)
    out.append(len(pages))
    pool.free_seq(2)
    pool.check()
    pool.close()
    other.close()
    store.close()
    return out


def test_swap_misuse_raises_alike(model, tmp_path):
    ct, _, cj, _ = model
    want = _misuse(JPagedKVPool, JBlockStore, cj, str(tmp_path / "j"))
    got = _misuse(PagedKVPool, BlockStore, ct, str(tmp_path / "t"), device=CPU)
    assert got == want
    assert [w[0] for w in want[:4]] == ["PoolAccountingError"] * 4 and want[4] == 2


def test_blockstore_corruption_is_quarantined_and_counted(tmp_path):
    store = BlockStore(root=str(tmp_path / "s"), budget_bytes=0)
    block = {"a": np.arange(12, dtype=np.float32).reshape(3, 4),
             "b": torch.arange(6, dtype=torch.int8), "s": ["x", "y", "z"]}
    ref = store.put(block)  # budget 0: spills on arrival
    assert store.resident_bytes == 0 and store.spilled_bytes > 0
    got = store.get(ref)
    np.testing.assert_array_equal(got["a"], block["a"])
    np.testing.assert_array_equal(got["b"], block["b"].numpy())
    assert got["s"] == ["x", "y", "z"]
    seg = store._seg_dir(ref.block_id)
    with open(os.path.join(seg, "c0.bin"), "r+b") as f:
        f.write(b"\xff")
    q0 = store_metric("tftpu_blockstore_quarantines_total")
    with pytest.raises(BlockCorruptionError, match="quarantined"):
        store.get(ref)
    assert store_metric("tftpu_blockstore_quarantines_total") - q0 == 1
    healed = store.get_or_recompute(ref, lambda: block)
    np.testing.assert_array_equal(healed["a"], block["a"])
    store.close()
    assert not os.path.exists(str(tmp_path / "s" / f"blk-{ref.block_id:08d}"))


def test_blockstore_resident_budget_spills_lru_like_jax(tmp_path):
    """A positive ``budget_bytes``: ``put`` spills the least-recently-used
    residents past it, a ``get`` counts as a use; after every step the
    same blocks are resident as in the JAX store, and reloads return the
    bytes put."""
    rng = np.random.default_rng(3)
    blocks = [{"a": rng.standard_normal((4, 8)).astype(np.float32)} for _ in range(6)]
    budget = 3 * blocks[0]["a"].nbytes  # three blocks resident at most
    stores = (JBlockStore(root=str(tmp_path / "j"), budget_bytes=budget),
              BlockStore(root=str(tmp_path / "t"), budget_bytes=budget))
    refs = ([], [])

    def resident():
        return [sorted(r.block_id for r in rs if s._entries[r.block_id].block is not None)
                for s, rs in zip(stores, refs)]

    for i, b in enumerate(blocks):
        for s, rs in zip(stores, refs):
            rs.append(s.put(b))
        if i == 3:  # touch the oldest resident: the next put spills another
            for s, rs in zip(stores, refs):
                s.get(rs[resident()[0][0]])
        want, got = resident()
        assert got == want and len(got) == min(i + 1, 3)
        assert stores[1].resident_bytes == stores[0].resident_bytes
    for s, rs in zip(stores, refs):
        for r, b in zip(rs, blocks):
            np.testing.assert_array_equal(np.asarray(s.get(r)["a"]), b["a"])
        s.close()


def store_metric(name):
    from tensorframes_tpu_torch.observability.metrics import REGISTRY

    return sum(d["value"] for d in REGISTRY.snapshot() if d["name"] == name)


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------

def _prefix_traffic(eng, rng_seed, vocab):
    """Cold → exact repeat (copy-on-extend) → shared first page with a fresh
    suffix (suffix prefill) → the repeat again."""
    rng = np.random.default_rng(rng_seed)
    shared = rng.integers(0, vocab, (16,)).astype(np.int32)
    p2 = np.concatenate([shared[:8], rng.integers(0, vocab, (6,))]).astype(np.int32)
    p3 = np.concatenate([shared[:12], rng.integers(0, vocab, (3,))]).astype(np.int32)
    return [np.asarray(eng.call({"prompt": p}, timeout=300)["tokens"])
            for p in (shared, shared, p2, p3, shared)]


def test_prefix_cache_tokens_and_counts_match_jax(model):
    ct, pt, cj, pj = model
    kw = dict(max_slots=4, page_size=8, max_prompt_len=16, max_new_tokens=NEW)
    jeng = JDecodeEngine("kv_prefix", cj, pj, JDecodeConfig(prefix_cache=True, **kw))
    jeng.start()
    try:
        want = _prefix_traffic(jeng, 53, cj.vocab_size)
        jc = jeng.counters()
    finally:
        jeng.stop(drain=True, timeout=300)
    h0, c0 = sm.PREFIX_HITS.value, sm.PREFIX_MISSES.value
    eng = DecodeEngine("kv_prefix", ct, pt, DecodeConfig(prefix_cache=True, **kw), device=CPU)
    eng.start()
    try:
        got = _prefix_traffic(eng, 53, ct.vocab_size)
        tc = eng.counters()
        assert eng.pool.num_shared > 0
    finally:
        eng.stop(drain=True, timeout=300)
    eng.pool.check()
    cold = DecodeEngine("kv_cold", ct, pt, DecodeConfig(**kw), device=CPU).start()
    try:
        base = _prefix_traffic(cold, 53, ct.vocab_size)
    finally:
        cold.stop(drain=True, timeout=300)
    for i, (g, w, b) in enumerate(zip(got, want, base)):
        np.testing.assert_array_equal(g, w, err_msg=f"request {i}: port != JAX engine")
        np.testing.assert_array_equal(g, b, err_msg=f"request {i}: hit != cold route")
    for k in ("prefix_hits", "prefix_misses", "shared_pages", "allocatable_pages"):
        assert tc[k] == jc[k], k
    assert tc["prefix_hits"] >= 3
    assert (sm.PREFIX_HITS.value - h0, sm.PREFIX_MISSES.value - c0) == (
        tc["prefix_hits"], tc["prefix_misses"])


def _swap_engine(model, name, root):
    ct, pt, _, _ = model
    return DecodeEngine(name, ct, pt, _swap_cfg(DecodeConfig, swap_dir=root), device=CPU)


def test_swap_resume_undersized_pool_matches_jax(model, swap_prompts, jax_swap_tokens,
                                                  tmp_path):
    eng = _swap_engine(model, "kv_swap", str(tmp_path / "swap")).start()
    o0, r0, f0 = sm.KVSWAP_OUTS.value, sm.KVSWAP_RESUMES.value, sm.KVSWAP_FALLBACKS.value
    t0 = sm.DECODE_TOKENS.value
    try:
        outs = [f.result(300)["tokens"] for f in
                [eng.submit({"prompt": p}) for p in swap_prompts]]
    finally:
        eng.stop(drain=True, timeout=300)
    for i, (o, w) in enumerate(zip(outs, jax_swap_tokens)):
        np.testing.assert_array_equal(o, w, err_msg=f"request {i}")
    assert sm.KVSWAP_OUTS.value - o0 > 0 and sm.KVSWAP_RESUMES.value - r0 > 0
    assert sm.KVSWAP_FALLBACKS.value - f0 == 0
    # a swap resume regenerates nothing: each fresh token counted once
    assert sm.DECODE_TOKENS.value - t0 == len(swap_prompts) * NEW
    eng.pool.check()
    assert eng.pool.num_free == eng.pool.usable_pages
    assert not os.path.exists(str(tmp_path / "swap")) or not os.listdir(str(tmp_path / "swap"))


def test_corrupted_swap_segment_counted_fallback_matches_jax(model, swap_prompts,
                                                             jax_swap_tokens, tmp_path):
    eng = _swap_engine(model, "kv_swapcorrupt", str(tmp_path / "swap")).start()
    store = eng._swap_store
    orig_put = store.put_spilled

    def corrupting_put(block):
        ref = orig_put(block)
        path = os.path.join(store._seg_dir(ref.block_id), "c0.bin")
        with open(path, "r+b") as f:
            b = f.read(1)
            f.seek(0)
            f.write(bytes([b[0] ^ 0xFF]))
        return ref

    store.put_spilled = corrupting_put
    f0, r0 = sm.KVSWAP_FALLBACKS.value, sm.KVSWAP_RESUMES.value
    try:
        outs = [f.result(300)["tokens"] for f in
                [eng.submit({"prompt": p}) for p in swap_prompts]]
        assert eng.counters()["swap_fallbacks"] > 0
    finally:
        eng.stop(drain=True, timeout=300)
    assert sm.KVSWAP_FALLBACKS.value - f0 > 0 and sm.KVSWAP_RESUMES.value - r0 == 0
    for i, (o, w) in enumerate(zip(outs, jax_swap_tokens)):
        np.testing.assert_array_equal(o, w, err_msg=f"request {i}")
    eng.pool.check()


def test_swap_segments_survive_engine_restart_match_jax(model, swap_prompts, jax_swap_tokens,
                                                        tmp_path):
    """A hard stop parks the keyed swap segments, ``spill()`` folds them
    into a snapshot, a fresh engine ``restore()``s them, and the redriven
    requests (same trace ids) resume from their pages with the JAX
    engine's tokens."""
    def drive(eng):
        futs = []
        for i, p in enumerate(swap_prompts):
            with tctx.request_scope(f"restart-{i}"):
                futs.append(eng.submit({"prompt": p}))
        return futs

    eng = None
    for attempt in range(8):
        eng = _swap_engine(model, f"kv_swapstop{attempt}", str(tmp_path / f"s{attempt}"))
        eng.start()
        drive(eng)
        deadline = time.time() + 60
        while time.time() < deadline and not eng._swap:
            time.sleep(0.001)
        eng.stop(drain=False, timeout=300)
        if eng._swap_parked:
            break
        eng.pool.check()
    assert eng._swap_parked, "never caught a pending swapped sequence across 8 hard stops"
    st = BlockStore(root=str(tmp_path / "handoff"), budget_bytes=0)
    snap = eng.spill(st)
    assert snap["swapped"] and eng._swap_store is None
    eng2 = _swap_engine(model, "kv_swaprestored", str(tmp_path / "s-b")).start()
    try:
        assert eng2.restore(st, snap) == len(snap["swapped"])
        r0 = sm.KVSWAP_RESUMES.value
        outs = [f.result(300)["tokens"] for f in drive(eng2)]
        assert sm.KVSWAP_RESUMES.value - r0 > 0
        assert not eng2._swap_restored
    finally:
        eng2.stop(drain=True, timeout=300)
    for i, (o, w) in enumerate(zip(outs, jax_swap_tokens)):
        np.testing.assert_array_equal(o, w, err_msg=f"request {i}")
    eng2.pool.check()
    assert eng2.pool.num_free == eng2.pool.usable_pages
    st.close()


def test_prefix_cache_events_match_jax(model):
    """Repeated first pages on an unarmed engine leave the same
    ``store_unarmed`` record in both packages; a within-one-page prompt
    on an armed engine the same ``page_misalignment`` record; stopping
    withdraws them."""
    ct, pt, cj, pj = model
    kw = dict(max_slots=2, page_size=8, max_prompt_len=16, max_new_tokens=2)
    rng = np.random.default_rng(59)
    p = rng.integers(0, cj.vocab_size, (12,)).astype(np.int32)
    short = rng.integers(0, cj.vocab_size, (5,)).astype(np.int32)
    records = []
    for eng_cls, cfg_cls, c, prm, events, dev in (
            (JDecodeEngine, JDecodeConfig, cj, pj, jdec.prefix_cache_events, {}),
            (DecodeEngine, DecodeConfig, ct, pt, prefix_cache_events, {"device": CPU})):
        off = eng_cls("kv_tfg113", c, prm, cfg_cls(**kw), **dev)
        on = eng_cls("kv_tfg113_on", c, prm, cfg_cls(prefix_cache=True, **kw), **dev)
        off.start()
        on.start()
        try:
            off.call({"prompt": p}, timeout=300)
            first = [e for e in events() if e["endpoint"].startswith("kv_tfg113")]
            off.call({"prompt": p.copy()}, timeout=300)
            on.call({"prompt": short}, timeout=300)
            mine = [e for e in events() if e["endpoint"].startswith("kv_tfg113")]
        finally:
            off.stop(drain=True, timeout=300)
            on.stop(drain=True, timeout=300)
        assert not first
        assert not [e for e in events() if e["endpoint"].startswith("kv_tfg113")]
        records.append(mine)
    assert records[1] == records[0]
    assert {e["reason"] for e in records[1]} == {"store_unarmed", "page_misalignment"}
