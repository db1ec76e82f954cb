"""Iterative decode engine: token-level continuous batching over a paged
int8 KV pool.

The reference package's ``serving/decode.py``. A persistent decode loop,
on its own thread, where per-request sequence slots join and leave the
running batch every step, over a block-paged KV pool
(:class:`~tensorframes_tpu_torch.serving.kvpool.PagedKVPool`) shared by
all sequences. Per loop iteration:

1. **join** — poll the admission queue (a pull-mode
   :class:`~tensorframes_tpu_torch.serving.batcher.ContinuousBatcher`,
   whose expirer covers requests waiting for a slot) while slots and
   prompt pages are free; each join runs one **prefill** (the prompt
   padded to a ladder bucket) producing the first token.
2. **decode** — one batched single-token step over every running slot,
   padded to the slot-count bucket. A slot that needs a new KV page and
   finds the pool empty triggers **preemption**: the youngest running
   sequence is evicted and requeued at the head with its tokens kept; on
   rejoin it replays prefill plus teacher-forced decode and must
   reproduce its recorded tokens exactly, or its request fails loudly.
   The oldest sequence is never preempted and the pool floor holds one
   full horizon, so forward progress is structural.
3. **leave** — finished sequences resolve their futures and free their
   pages.

Decode is greedy (an argmax in the step): determinism is what makes the
preemption replay and the batched-equals-solo contract meaningful. On
the card every step launches the paged decode-attention kernel once per
layer and the int8-weight kernel for every weight product; there is no
fallback — a build or launch failure fails the running requests.

KV memory hierarchy, both tiers off by default:

* ``prefix_cache=True`` arms the content-addressed prefix cache: a fresh
  prompt's page-granular prefix is hash-matched against pages other
  sequences prefilled and published read-only (refcounted;
  ``PagedKVPool.check()``'s partition extends to them). A hit skips those
  pages' prefill: the suffix runs through ``paged_suffix_prefill_fn`` (the
  decode step's paged attention, one row a slot), or copy-on-extend
  duplicates a shared ragged-tail page and teacher-forces only the final
  prompt token through the solo decode step. Outputs equal the cold
  path's exactly (the same quantized-KV arithmetic end to end).
* ``kv_swap=True`` arms per-sequence swap: a preempted sequence's pages
  (slot scales and generated prefix included) travel to a CRC-stamped
  :class:`~tensorframes_tpu_torch.blockstore.BlockStore` segment under
  ``swap_dir``, and rejoin restores them instead of replaying. The replay
  data is kept beside every swap snapshot: a corrupt segment falls back
  to replay, counted (``tftpu_kvswap_fallback_total``), so no store
  problem loses a request. :meth:`DecodeEngine.spill` and
  :meth:`DecodeEngine.restore` carry parked segments across engines.

Joins, steps, preemptions, swaps, prefix hits and finishes leave
``serving.decode.*`` flight records and, with the tracer on,
``decode.join``/``decode.step``/``decode.finish`` spans carrying the
requests' trace ids. Capturing the step in a CUDA graph is a speed item
(ROADMAP), not yet done.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import resolve_device
from ..observability import events as _events
from ..observability import flight as _flight
from ..utils import get_logger
from ..validation import ValidationError
from . import metrics as m
from .batcher import (
    ContinuousBatcher,
    DeadlineExceededError,
    RejectedError,
    ResultFuture,
    ServingError,
    _Request,
)
from .kvpool import PagedKVPool, PoolExhaustedError

logger = get_logger(__name__)

__all__ = ["DecodeConfig", "DecodeEngine", "prefix_cache_events"]

# Prefix-cache ineligibility evidence: one entry per (endpoint, reason)
# the first time it arises, bounded, withdrawn when the engine stops.
_PREFIX_INELIGIBLE: Deque[Dict[str, object]] = collections.deque(maxlen=128)
_PREFIX_INELIGIBLE_SEEN: set = set()
_KV_COLUMNS = ("k", "v", "k_scale", "v_scale")


def prefix_cache_events() -> List[Dict[str, object]]:
    """Recent prefix-cache ineligibility evidence (deduplicated per
    endpoint and reason): ``store_unarmed`` (an unarmed engine saw a
    prompt's first page repeat), ``sampling_state_mismatch`` (a replayed
    join bypasses the cache by design) and ``page_misalignment`` (a prompt
    within one page can never share)."""
    return list(_PREFIX_INELIGIBLE)


@dataclasses.dataclass
class DecodeConfig:
    """Sizing knobs for one decode endpoint (the reference's fields and
    defaults).

    ``max_slots`` — running-batch width (slot counts pad through the
    bucket ladder). ``page_size`` — KV positions per pool page.
    ``num_pages`` — total pool pages incl. the null page; ``None`` sizes
    the pool to hold every slot's full horizon (no preemption). Smaller
    trades preemptions for memory. ``max_prompt_len`` /
    ``max_new_tokens`` — per-request bounds; their sum is the decode
    horizon (must fit the model's ``max_seq_len``).
    ``max_queue_requests`` — admission bound (``queue_full`` past it).
    ``default_deadline_s`` — total-elapsed deadline for requests that
    carry none (covers queue and slot wait). ``warmup`` — run every point
    of the slot × phase bucket grid once at start.
    ``kv_swap`` — swap a preempted sequence's pages to a BlockStore
    segment and restore them on rejoin (counted fallback to replay on
    corruption); ``swap_dir`` roots the swap store (default: a private
    temp dir, deleted at stop). ``prefix_cache`` — share read-only
    prompt-prefix pages across requests by content hash (refcounted,
    copy-on-extend at the ragged tail, evicted only at refcount 0).
    """

    max_slots: int = 8
    page_size: int = 16
    num_pages: Optional[int] = None
    max_prompt_len: int = 32
    max_new_tokens: int = 16
    max_queue_requests: int = 1024
    default_deadline_s: Optional[float] = None
    warmup: bool = True
    kv_swap: bool = False
    prefix_cache: bool = False
    swap_dir: Optional[str] = None


class _Seq:
    """One running sequence slot (engine-thread private)."""

    __slots__ = ("req", "seq", "prompt", "want", "pos", "joined", "generated", "replay")

    def __init__(self, req: _Request, seq: int, prompt: np.ndarray, want: int, joined: int):
        self.req = req
        self.seq = seq
        self.prompt = prompt
        self.want = want
        self.pos = int(prompt.shape[0])  # next KV position to write
        self.joined = joined             # monotonic join counter
        self.generated: List[int] = []
        self.replay: Optional[Deque[int]] = None


class DecodeEngine:
    """The persistent decode loop over one model and one paged KV pool.

    Usually built by :meth:`~tensorframes_tpu_torch.serving.Server.register_decode`.
    Standalone::

        eng = DecodeEngine("gen", cfg, params, DecodeConfig(), device="cpu")
        eng.start()
        eng.call({"prompt": np.arange(7, dtype=np.int32)})["tokens"]  # [1, new]
        eng.stop(drain=True)

    The engine runs on ``device`` (default ``config.device``, ``"cuda"``;
    asking for CUDA with no GPU raises). ``params`` are moved there.
    """

    def __init__(self, name: str, model_cfg, params, config: Optional[DecodeConfig] = None,
                 device=None):
        from ..compilecache import decode_warmup_grid
        from ..models import generation as gen
        from ..ops.quantize import tree_to

        self.name = name
        self.cfg = model_cfg
        self.config = cfg = config or DecodeConfig()
        if cfg.max_slots < 1:
            raise ValueError("max_slots must be >= 1")
        if cfg.max_prompt_len < 1 or cfg.max_new_tokens < 1:
            raise ValueError("max_prompt_len and max_new_tokens must be >= 1")
        horizon = cfg.max_prompt_len + cfg.max_new_tokens
        if horizon > model_cfg.max_seq_len:
            raise ValueError(
                f"decode horizon {horizon} (max_prompt_len + max_new_tokens) exceeds "
                f"the model's max_seq_len={model_cfg.max_seq_len}"
            )
        self.device = resolve_device(device)
        self.params = tree_to(params, self.device)
        max_pages = -(-horizon // cfg.page_size)
        num_pages = cfg.num_pages
        if num_pages is None:
            num_pages = 1 + cfg.max_slots * max_pages  # no-preemption sizing
        self._pool = PagedKVPool(model_cfg, num_pages, cfg.page_size, max_pages,
                                 device=self.device)
        grid = decode_warmup_grid(cfg.max_slots, cfg.max_prompt_len)
        self._slot_buckets = grid["decode"]
        self._prefill_buckets = grid["prefill"]
        self._prefill = gen.paged_prefill_fn(model_cfg, cfg.page_size, max_pages)
        # decode-attention lowering: a counted cost-model decision made
        # ONCE per engine, so batched and solo steps run the same choice
        # and the batched == solo and preemption-replay gates hold
        from ..plan import rules as _prules
        from ..plan.lower import _note_decision

        decision = _prules.decide_decode_attention(
            model_cfg.num_heads, model_cfg.head_dim, cfg.page_size, max_pages,
            device=self.device,
        )
        _note_decision(decision)
        # the logits product pads to the top slot bucket: one library
        # shape whatever the running slot count (batched == solo)
        self._step = gen.paged_decode_step_fn(
            model_cfg, cfg.page_size, max_pages, logits_rows=self._slot_buckets[-1],
        )
        # the KV memory hierarchy's steps, warmed with the grid
        self._prefix_cache = bool(cfg.prefix_cache)
        self._kv_swap = bool(cfg.kv_swap)
        self._suffix_prefill = None
        self._extract = self._restore = self._copy_page = None
        if self._prefix_cache:
            self._suffix_prefill = gen.paged_suffix_prefill_fn(model_cfg, cfg.page_size,
                                                               max_pages)
        if self._prefix_cache or self._kv_swap:
            ex_fn, rs_fn, cp_fn = gen.paged_page_ops_fns(max_pages)
            if self._kv_swap:
                self._extract, self._restore = ex_fn, rs_fn
            if self._prefix_cache:
                self._copy_page = cp_fn
        self._swap_store = None
        self._swap: Dict[_Request, Dict[str, object]] = {}
        # swap segments outlive the engine: stop() parks the pending keyed
        # sequences' segments (trace_id → swap snapshot), spill() folds
        # them into the whole-pool snapshot, and restore() on a fresh
        # engine re-homes them here; a redriven request with the same
        # trace id resumes from its pages
        self._swap_parked: Dict[str, Dict[str, object]] = {}
        self._swap_restored: Dict[str, Dict[str, object]] = {}
        # first-page fingerprints of fresh prompts on an unarmed engine:
        # a repeat is evidence the prefill work was shareable (bounded)
        self._seen_first_pages: set = set()
        self._swap_outs = 0
        self._swap_resumes = 0
        self._swap_fallbacks = 0
        self._prefix_hits = 0
        self._prefix_misses = 0
        self._admission = ContinuousBatcher(name, None, max_batch_rows=1, max_latency_s=0.0,
                                            max_queue_rows=cfg.max_queue_requests)
        self._slots: List[Optional[_Seq]] = [None] * cfg.max_slots
        self._resume: Dict[_Request, List[int]] = {}
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._running = False
        self._starting = False
        self._stopping = False
        self._drain = True
        self._next_seq = 0
        self._join_counter = 0

    # -- introspection ------------------------------------------------------

    @property
    def pool(self) -> PagedKVPool:
        return self._pool

    @property
    def running(self) -> bool:
        return self._running

    def counters(self) -> Dict[str, object]:
        """Admission counters plus engine state."""
        snap = self._admission.counters()
        with self._lock:
            snap["running_slots"] = sum(1 for s in self._slots if s is not None)
        snap["free_pages"] = self._pool.num_free
        snap["allocatable_pages"] = self._pool.num_allocatable
        snap["shared_pages"] = self._pool.num_shared
        snap["swap_outs"] = self._swap_outs
        snap["swap_resumes"] = self._swap_resumes
        snap["swap_fallbacks"] = self._swap_fallbacks
        snap["prefix_hits"] = self._prefix_hits
        snap["prefix_misses"] = self._prefix_misses
        return snap

    # -- lifecycle ----------------------------------------------------------

    def _new_swap_store(self):
        from ..blockstore import BlockStore

        # budget 0: swap segments go straight to disk (put_spilled), and
        # the swap store never holds pages resident for the pool it relieves
        return BlockStore(root=self.config.swap_dir, budget_bytes=0)

    def start(self) -> "DecodeEngine":
        with self._lock:
            if self._running or self._starting:
                return self
            if self._thread is not None and self._thread.is_alive():
                raise ServingError(
                    f"decode engine {self.name!r} is still draining from a timed-out "
                    "stop(); retry once it finishes"
                )
            self._starting = True
        t0 = time.perf_counter()
        try:
            # _running commits only after warmup, admission and the loop
            # thread all succeed: a failed warm leaves it restartable
            self._pool.reopen()
            if self._kv_swap and self._swap_store is None:
                self._swap_store = self._new_swap_store()
            if self.config.warmup:
                self._warm()
            self._admission.start()
            thread = threading.Thread(target=self._loop, daemon=True,
                                      name=f"tfs-decode-{self.name}")
            with self._lock:
                self._thread = thread
                self._stopping = False
                self._running = True
            thread.start()
        finally:
            with self._lock:
                self._starting = False
        _flight.record("serving.decode.start", endpoint=self.name,
                       slots=self.config.max_slots, pages=self._pool.num_pages,
                       page_size=self.config.page_size,
                       warmup_s=round(time.perf_counter() - t0, 6))
        return self

    def _warm(self) -> None:
        """Run every point of the slot × phase bucket grid once against
        null tables (writes land in the null page; results are discarded),
        and the prefix and swap tiers' steps: the kernel build and the
        library handles are paid here, before the first request."""
        t0 = time.perf_counter()
        cols = self._pool.columns
        null = self._pool.null_table()
        maxp = self._pool.max_pages_per_seq
        for tb in self._prefill_buckets:
            self._prefill(self.params, cols, np.zeros(tb, np.int32), 1, null)
        for sb in self._slot_buckets:
            self._step(self.params, cols, np.zeros(sb, np.int32), np.zeros(sb, np.int32),
                       np.zeros((sb, maxp), np.int32))
        if self._suffix_prefill is not None:
            for tb in self._prefill_buckets:
                self._suffix_prefill(self.params, cols, np.zeros(tb, np.int32), 0, 1, null)
        if self._copy_page is not None:
            self._copy_page(cols, 0, 0)  # the null page onto itself: garbage either way
        if self._extract is not None:
            idx = np.zeros(1, np.int32)
            ex = self._extract(cols, idx)
            self._restore(cols, idx, *(ex[k] for k in _KV_COLUMNS))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        logger.info("decode warmup[%s]: prefill buckets %s + decode buckets %s in %.2fs",
                    self.name, self._prefill_buckets, self._slot_buckets,
                    time.perf_counter() - t0)

    def stop(self, drain: bool = True, timeout: Optional[float] = None) -> None:
        """Close admission; ``drain=True`` completes every admitted and
        queued sequence first, ``drain=False`` fails them with
        :class:`ServingError`. Bounded by ``timeout``. Swap segments of
        unanswered requests that carry a trace id are parked for
        :meth:`spill`; the rest are dropped with the swap store."""
        with self._lock:
            if not self._running and self._thread is None:
                self._pool.close()
                return
            self._stopping = True
            self._drain = drain
            thread = self._thread
        self._admission.close(drain=drain)
        if thread is not None:
            thread.join(timeout)
            if thread.is_alive():
                logger.warning("decode engine %r still draining after stop timeout",
                               self.name)
        self._admission.stop(drain=drain, timeout=timeout)
        with self._lock:
            self._running = False
            if self._thread is thread and not (thread is not None and thread.is_alive()):
                self._thread = None
        self._pool.close()
        store = self._swap_store
        if store is not None:
            for r in list(self._swap):
                if r.trace_id:
                    self._swap_parked[str(r.trace_id)] = self._swap.pop(r)
                else:
                    self._drop_swap(r)
            # restored but never redriven segments live in this store too:
            # park them, so chained restarts keep them
            self._swap_parked.update(self._swap_restored)
            self._swap_restored.clear()
            if not self._swap_parked:
                self._swap_store = None
                store.close()  # deletes the root if the engine made it
        # ineligibility evidence is scoped to running endpoints
        kept = [e for e in _PREFIX_INELIGIBLE if e.get("endpoint") != self.name]
        _PREFIX_INELIGIBLE.clear()
        _PREFIX_INELIGIBLE.extend(kept)
        for key in [k for k in _PREFIX_INELIGIBLE_SEEN if k[0] == self.name]:
            _PREFIX_INELIGIBLE_SEEN.discard(key)
        _flight.record("serving.decode.stop", endpoint=self.name, drain=drain)

    def spill(self, store) -> Dict[str, object]:
        """Whole-engine KV snapshot (call after ``stop()``): the pool's
        whole-pool spill plus every parked per-sequence swap segment,
        folded into one snapshot dict. Hand it to a fresh engine's
        :meth:`restore` and redrive the pending requests with the same
        trace ids: each resumes from its swapped pages through the swap-in
        path, with no prefill recompute. The engine's own swap store is
        emptied and closed (the segments now live in ``store``)."""
        with self._lock:
            if self._running or self._starting:
                raise ServingError(
                    f"decode engine {self.name!r}: spill() requires a stopped engine "
                    "(stop() first — a live loop would race the snapshot)"
                )
            parked = dict(self._swap_parked)
        snap = self._pool.spill(store, swaps=parked, swap_store=self._swap_store)
        swap_store = self._swap_store
        if swap_store is not None:
            for entry in parked.values():
                try:
                    swap_store.drop(entry["ref"])
                except Exception:  # pragma: no cover - already dropped
                    pass
            self._swap_parked.clear()
            self._swap_store = None
            swap_store.close()
        _flight.record("serving.decode.spill", endpoint=self.name,
                       swapped=len(snap.get("swapped", {})))
        return snap

    def restore(self, store, snapshot: Dict[str, object]) -> int:
        """Adopt a :meth:`spill` snapshot's swapped sequences: segments are
        re-homed into this engine's swap store and parked by trace id;
        a redriven request with the same trace id resumes from its pages.
        Pool page state is not restored (a fresh engine owns a fresh pool,
        and swapped sequences hold no pages). Returns the number adopted
        (corrupt segments are skipped, counted by the store)."""
        if not self._kv_swap:
            return 0
        if self._swap_store is None:
            self._swap_store = self._new_swap_store()
        manifest = self._pool.adopt_swapped(store, snapshot, self._swap_store)
        with self._lock:
            self._swap_restored.update(manifest)
        _flight.record("serving.decode.restore", endpoint=self.name, adopted=len(manifest),
                       offered=len(snapshot.get("swapped", {})))
        return len(manifest)

    def _adopt_restored(self, req: _Request) -> Optional[Dict]:
        """Move a restored swap snapshot onto a redriven request (same
        trace id), keeping the replay data beside it — the counted
        fallback if the segment comes back corrupt."""
        if not self._swap_restored or not req.trace_id:
            return None
        snap = self._swap_restored.pop(str(req.trace_id), None)
        if snap is None:
            return None
        self._swap[req] = snap
        self._resume[req] = list(snap["generated"]) + list(snap["replay"] or ())
        return snap

    # -- request path -------------------------------------------------------

    def validate_feeds(self, feeds) -> Dict[str, object]:
        """Normalize one request: ``{"prompt": 1-D int tokens (or [1, plen]),
        "max_new_tokens": optional int}``. Over-long prompts reject as
        ``too_large``; malformed feeds raise :class:`ValidationError`."""
        if not isinstance(feeds, dict) or "prompt" not in feeds:
            raise ValidationError(
                f"decode endpoint {self.name!r}: feeds must be a dict with a 'prompt' "
                "key (int token ids)"
            )
        extra = set(feeds) - {"prompt", "max_new_tokens"}
        if extra:
            raise ValidationError(
                f"decode endpoint {self.name!r}: unexpected feed(s) {sorted(extra)}; "
                "accepted: prompt, max_new_tokens"
            )
        try:
            prompt = np.asarray(feeds["prompt"], dtype=np.int32)
        except (TypeError, ValueError) as e:
            raise ValidationError(
                f"decode endpoint {self.name!r}: prompt does not convert to int32 "
                f"tokens: {e}"
            ) from None
        if prompt.ndim == 2 and prompt.shape[0] == 1:
            prompt = prompt[0]
        if prompt.ndim != 1 or prompt.shape[0] < 1:
            raise ValidationError(
                f"decode endpoint {self.name!r}: prompt must be a non-empty 1-D token "
                f"vector (or [1, plen]), got shape {prompt.shape}"
            )
        vocab = int(self.cfg.vocab_size)
        if prompt.min() < 0 or prompt.max() >= vocab:
            raise ValidationError(
                f"decode endpoint {self.name!r}: prompt tokens must be in [0, {vocab})"
            )
        new = feeds.get("max_new_tokens", self.config.max_new_tokens)
        try:
            new = int(new)
        except (TypeError, ValueError):
            raise ValidationError(
                f"decode endpoint {self.name!r}: max_new_tokens must be an int, got "
                f"{feeds['max_new_tokens']!r}"
            ) from None
        if new < 1 or new > self.config.max_new_tokens:
            raise ValidationError(
                f"decode endpoint {self.name!r}: max_new_tokens={new} outside "
                f"[1, {self.config.max_new_tokens}]"
            )
        plen = int(prompt.shape[0])
        if plen > self.config.max_prompt_len:
            m.rejected("too_large").inc()
            raise RejectedError(
                f"decode endpoint {self.name!r}: prompt of {plen} tokens exceeds "
                f"max_prompt_len={self.config.max_prompt_len} — split or raise the "
                "engine's DecodeConfig",
                reason="too_large",
            )
        return {"prompt": prompt, "new": new}

    def submit(self, feeds, deadline_s: Optional[float] = None) -> ResultFuture:
        """Admit one request; the future resolves to ``{"tokens": int32
        [1, max_new_tokens]}`` when its last token is generated. Raises
        :class:`RejectedError` on shed/closed/oversize; the deadline covers
        queue and slot wait. The request carries the calling thread's
        bound request id (``observability.context.request_scope``) as its
        trace id."""
        norm = self.validate_feeds(feeds)
        if deadline_s is None:
            deadline_s = self.config.default_deadline_s
        if deadline_s is not None and deadline_s <= 0:
            raise ValueError(
                f"deadline_s must be > 0 (got {deadline_s}): total elapsed wall-clock"
            )
        return self._admission.offer(norm, 1, deadline_s)

    def call(self, feeds, deadline_s: Optional[float] = None,
             timeout: Optional[float] = None) -> Dict[str, np.ndarray]:
        return self.submit(feeds, deadline_s).result(timeout)

    # -- the engine loop ----------------------------------------------------

    def _loop(self) -> None:
        try:
            self._loop_body()
        except Exception as e:
            logger.exception("decode engine %r loop died", self.name)
            _flight.record("serving.decode.error", endpoint=self.name,
                           error=type(e).__name__, message=str(e))
            self._fail_all(ServingError(
                f"decode engine {self.name!r} failed: {type(e).__name__}: {e}"
            ))

    def _loop_body(self) -> None:
        while True:
            with self._lock:
                stopping, drain = self._stopping, self._drain
            if stopping and not drain:
                self._fail_all(ServingError(
                    f"decode engine {self.name!r} stopped without drain; running "
                    "sequences abandoned"
                ))
                return
            self._purge_resume()
            free = [i for i, s in enumerate(self._slots) if s is None]
            if free:
                for req in self._admission.poll(len(free), can_take=self._admit_budget()):
                    self._join(req)
            if any(s is not None for s in self._slots):
                self._decode_step()
                continue
            if stopping and self._admission.queued_rows == 0:
                return
            if self._admission.queued_rows > 0:
                # queued but unadmittable (pages held elsewhere): a bounded
                # nap; the expirer thread owns deadline expiry
                time.sleep(0.005)
            else:
                self._admission.wait_for_work(0.02)

    def _admit_budget(self):
        """A fresh admission predicate for ONE poll: each accepted request
        claims its pages from a snapshot budget (``num_allocatable``: free
        plus reclaimable shared pages), so a multi-request poll never
        overcommits the pool. A swapped request claims its snapshot's page
        count, not its prompt's."""
        budget = [self._pool.num_allocatable]

        def can_take(req: _Request) -> bool:
            snap = self._swap.get(req)
            if snap is None:
                # a redriven request adopting a restored swap segment
                snap = self._adopt_restored(req)
            if snap is not None:
                need = int(snap["pages"])
            else:
                need = self._pool.pages_needed(int(req.feeds["prompt"].shape[0]))
            if need > budget[0]:
                return False
            budget[0] -= need
            return True

        return can_take

    def _purge_resume(self) -> None:
        # a preempted request can expire while requeued: drop its replay
        # state and its swap segment
        if self._resume:
            for r in [r for r in self._resume if r.future.done()]:
                del self._resume[r]
        if self._swap:
            for r in [r for r in self._swap if r.future.done()]:
                self._drop_swap(r)

    def _drop_swap(self, req: _Request) -> None:
        snap = self._swap.pop(req, None)
        if snap is not None and self._swap_store is not None:
            try:
                self._swap_store.drop(snap["ref"])
            except Exception:  # pragma: no cover - already dropped
                pass

    def _prefill_bucket(self, plen: int) -> int:
        for b in self._prefill_buckets:
            if b >= plen:
                return b
        raise AssertionError(  # pragma: no cover - validated at submit
            f"prompt of {plen} tokens above the prefill ladder {self._prefill_buckets}"
        )

    def _note_prefix_ineligible(self, reason: str, plen: int) -> None:
        key = (self.name, reason)
        if key in _PREFIX_INELIGIBLE_SEEN:
            return
        _PREFIX_INELIGIBLE_SEEN.add(key)
        _PREFIX_INELIGIBLE.append({"endpoint": self.name, "reason": reason,
                                   "prompt_len": int(plen),
                                   "page_size": int(self.config.page_size)})

    def _solo_step(self, seq: int, token: int, pos: int) -> int:
        """One decode step for one sequence in the smallest slot bucket
        (the copy-on-extend route): writes ``token``'s KV at ``pos`` and
        returns the next token."""
        sb = self._slot_buckets[0]
        tokens = np.zeros(sb, np.int32)
        positions = np.zeros(sb, np.int32)
        tables = np.zeros((sb, self._pool.max_pages_per_seq), np.int32)
        tokens[0], positions[0], tables[0] = token, pos, self._pool.table(seq)
        _, nxt = self._step(self.params, self._pool.columns, tokens, positions, tables)
        return int(nxt[0])

    def _prefill_seq(self, seq: int, prompt: np.ndarray, plen: int,
                     resumed: bool) -> Tuple[int, int]:
        """Write the prompt's KV for a fresh sequence and produce its first
        token (one host sync) through the cheapest eligible route:
        shared-prefix suffix prefill, copy-on-extend, or cold prefill.
        Returns ``(first_token, shared_pages_referenced)``."""
        hit_pages: List[int] = []
        covered = 0
        cow = None
        ps = self.config.page_size
        if not self._prefix_cache:
            # evidence only on an observed repeat: a prompt whose first
            # page an earlier fresh request already prefilled
            if not resumed and plen > ps:
                fp = prompt[:ps].tobytes()
                if fp in self._seen_first_pages:
                    self._note_prefix_ineligible("store_unarmed", plen)
                elif len(self._seen_first_pages) < 512:
                    self._seen_first_pages.add(fp)
        elif resumed:
            # a replayed join reproduces its recorded tokens against the
            # page state of its first admission: not through cache pages
            # published since — ineligible by design
            self._note_prefix_ineligible("sampling_state_mismatch", plen)
        else:
            hit_pages, covered, cow, _r = self._pool.prefix_match(prompt)
            if not hit_pages and cow is None:
                if plen <= ps:
                    self._note_prefix_ineligible("page_misalignment", plen)
                m.PREFIX_MISSES.inc()
                self._prefix_misses += 1
        if hit_pages:
            self._pool.prefix_acquire(seq, hit_pages)
        if hit_pages or cow is not None:
            m.PREFIX_HITS.inc()
            self._prefix_hits += 1
        if cow is not None:
            # the whole remaining tail is resident in a published page:
            # copy it (a shared page is never written), then teacher-force
            # only the final prompt token through the solo decode step —
            # it rewrites the last position's KV and yields the first
            # token's logits
            dst = self._pool.copy_on_extend(seq, cow)
            self._copy_page(self._pool.columns, cow, dst)
            first = self._solo_step(seq, int(prompt[plen - 1]), plen - 1)
        elif hit_pages:
            # matched pages cover [0, covered): prefill only the suffix,
            # whose rows see the shared pages through the sequence's table
            self._pool.alloc(seq, self._pool.pages_needed(plen) - len(hit_pages))
            tlen = plen - covered
            padded = np.zeros(self._prefill_bucket(tlen), np.int32)
            padded[:tlen] = prompt[covered:]
            _, fd = self._suffix_prefill(self.params, self._pool.columns, padded, covered,
                                         tlen, self._pool.table(seq))
            first = int(fd)
        else:
            self._pool.alloc(seq, self._pool.pages_needed(plen))
            padded = np.zeros(self._prefill_bucket(plen), np.int32)
            padded[:plen] = prompt
            _, fd = self._prefill(self.params, self._pool.columns, padded, plen,
                                  self._pool.table(seq))
            first = int(fd)
        m.DECODE_STEPS["prefill"].inc()
        if self._prefix_cache and not resumed:
            # publish this prompt's freshly written full pages (a no-op on
            # total overlap; stops at another lineage's chain key)
            self._pool.publish_prefix(seq, prompt)
        if hit_pages or cow is not None:
            _flight.record("serving.decode.prefix_hit", endpoint=self.name, seq=seq,
                           prompt_len=plen, shared_pages=len(hit_pages),
                           covered_tokens=covered, copy_on_extend=cow is not None)
        return first, len(hit_pages)

    def _join(self, req: _Request) -> None:
        now = time.perf_counter()
        if req.deadline is not None and req.deadline <= now:
            # lost the race with the expirer between poll and here
            m.DEADLINE_EXPIRED.inc()
            req.future._fail(DeadlineExceededError(
                f"request to {self.name!r} expired after {now - req.t_submit:.4f}s "
                "waiting for a decode slot"
            ))
            self._resume.pop(req, None)
            self._drop_swap(req)
            return
        if self._swap_store is not None and req in self._swap:
            if self._swap_in(req, self._swap.pop(req), now):
                return
            # counted fallback: the replay data kept beside the snapshot
            # resumes it through the route below
        prompt = req.feeds["prompt"]
        plen = int(prompt.shape[0])
        seq = self._next_seq
        self._next_seq += 1
        replay = self._resume.pop(req, None)
        try:
            tok, prefix_pages = self._prefill_seq(seq, prompt, plen, resumed=bool(replay))
        except BaseException as e:
            # the joining request holds no slot yet: fail it here, then let
            # the loop fail the rest
            self._pool.free_seq(seq)
            req.future._fail(ServingError(
                f"decode engine {self.name!r} failed: {type(e).__name__}: {e}"
            ))
            raise
        self._join_counter += 1
        s = _Seq(req, seq, prompt, int(req.feeds["new"]), self._join_counter)
        if replay:
            s.replay = collections.deque(replay)
            expect = s.replay.popleft()
            if tok != expect:
                self._bit_identity_violation(s, tok, expect)
                return
            if not s.replay:
                s.replay = None
        else:
            req.future.ttft_s = time.perf_counter() - req.t_submit
            m.DECODE_TTFT.observe(req.future.ttft_s)
            m.DECODE_TOKENS.inc()
        s.generated.append(tok)
        self._slots[self._slots.index(None)] = s
        m.DECODE_SLOTS.inc()
        _flight.record("serving.decode.join", endpoint=self.name, seq=seq, prompt_len=plen,
                       new_tokens=s.want, resumed=bool(replay), prefix_pages=prefix_pages,
                       waited_s=round(now - req.t_submit, 6))
        if _events.TRACER.enabled:
            args = {"endpoint": self.name, "seq": seq, "prompt_len": plen,
                    "resumed": bool(replay)}
            if req.trace_id:
                args["request_id"] = req.trace_id
            _events.TRACER.emit_complete("decode.join", now, time.perf_counter() - now,
                                         args=args, cat="serving")
        if len(s.generated) >= s.want:
            self._finish(s)

    def _swap_in(self, req: _Request, snap: Dict[str, object], now: float) -> bool:
        """Restore a swapped sequence's pages bit for bit and put it
        straight back into a slot — no prefill, no replay. Returns False on
        any store or pool problem (counted as
        ``tftpu_kvswap_fallback_total``; the caller's replay route still
        resumes the request)."""
        seq = self._next_seq
        self._next_seq += 1
        try:
            pages, block = self._pool.swap_in_seq(self._swap_store, snap, seq)
        except Exception as e:
            # a corrupt segment was already quarantined and counted by the
            # store; drop the ref if it survived, count the fallback
            try:
                self._swap_store.drop(snap["ref"])
            except Exception:
                pass
            m.KVSWAP_FALLBACKS.inc()
            self._swap_fallbacks += 1
            logger.warning("decode engine %r: swap-in failed (%s: %s); falling back to "
                           "recompute-replay", self.name, type(e).__name__, e)
            _flight.record("serving.decode.swap_fallback", endpoint=self.name,
                           error=type(e).__name__, message=str(e)[:200])
            return False
        self._restore(self._pool.columns, np.asarray(pages, np.int32),
                      *(block[k] for k in _KV_COLUMNS))
        self._join_counter += 1
        s = _Seq(req, seq, req.feeds["prompt"], int(req.feeds["new"]), self._join_counter)
        s.pos = int(snap["pos"])
        s.generated = list(snap["generated"])
        s.replay = collections.deque(snap["replay"]) if snap["replay"] else None
        self._resume.pop(req, None)
        self._slots[self._slots.index(None)] = s
        m.DECODE_SLOTS.inc()
        m.KVSWAP_RESUMES.inc()
        self._swap_resumes += 1
        _flight.record("serving.decode.swap_in", endpoint=self.name, seq=seq,
                       pages=len(pages), tokens_done=len(s.generated),
                       waited_s=round(now - req.t_submit, 6))
        if _events.TRACER.enabled:
            args = {"endpoint": self.name, "seq": seq, "swap_resumed": True}
            if req.trace_id:
                args["request_id"] = req.trace_id
            _events.TRACER.emit_complete("decode.join", now, time.perf_counter() - now,
                                         args=args, cat="serving")
        if len(s.generated) >= s.want:
            self._finish(s)
        return True

    def _active(self) -> List[_Seq]:
        return [s for s in self._slots if s is not None]

    def _decode_step(self) -> None:
        # page faults first, oldest slot first; the victim is always the
        # YOUNGEST running sequence (possibly the faulting one) — the
        # oldest is never evicted, so preemption cannot livelock
        for s in sorted(self._active(), key=lambda x: x.joined):
            if s not in self._slots:
                continue  # preempted by an earlier fault in this pass
            if s.pos // self._pool.page_size < len(self._pool.seq_pages(s.seq)):
                continue
            preempted_self = False
            while self._pool.num_allocatable < 1:
                victim = max(self._active(), key=lambda x: x.joined)
                self._preempt(victim)
                if victim is s:
                    preempted_self = True
                    break
            if preempted_self:
                continue
            try:
                self._pool.alloc(s.seq, 1)
            except PoolExhaustedError:  # pragma: no cover - guarded above
                self._preempt(s)
        active = self._active()
        if not active:
            return
        n = len(active)
        sb = next(b for b in self._slot_buckets if b >= n)
        maxp = self._pool.max_pages_per_seq
        tokens = np.zeros(sb, np.int32)
        pos = np.zeros(sb, np.int32)
        tables = np.zeros((sb, maxp), np.int32)
        for row, s in enumerate(active):
            tokens[row] = s.generated[-1]
            pos[row] = s.pos
            tables[row] = self._pool.table(s.seq)
        t_step = time.perf_counter()
        _, nxt = self._step(self.params, self._pool.columns, tokens, pos, tables)
        nxt = nxt.cpu().numpy()  # the step's one host sync
        m.DECODE_STEPS["decode"].inc()
        if _events.TRACER.enabled:
            args = {"endpoint": self.name, "slots": n}
            rids = [s.req.trace_id for s in active if s.req.trace_id]
            if rids:
                args["request_ids"] = rids[:16]
            _events.TRACER.emit_complete("decode.step", t_step, time.perf_counter() - t_step,
                                         args=args, cat="serving")
        for row, s in enumerate(active):
            s.pos += 1
            tok = int(nxt[row])
            if s.replay:
                expect = s.replay.popleft()
                if tok != expect:
                    self._bit_identity_violation(s, tok, expect)
                    continue
                if not s.replay:
                    s.replay = None
            else:
                m.DECODE_TOKENS.inc()
            s.generated.append(tok)
            if len(s.generated) >= s.want:
                self._finish(s)

    def _swap_out(self, s: _Seq) -> Optional[Dict[str, object]]:
        """Copy the sequence's pages to the host and publish them to the
        swap store's CRC-stamped disk segment. Returns the snapshot, or
        None if the store write failed — the caller then evicts and the
        request replays, so a swap problem never loses a request."""
        pages = self._pool.seq_pages(s.seq)
        ex = self._extract(self._pool.columns, np.asarray(pages, np.int32))
        block = {name: col.cpu().numpy() for name, col in ex.items()}
        try:
            snap = self._pool.swap_out_seq(self._swap_store, s.seq, block)
        except Exception as e:
            logger.warning("decode engine %r: swap-out failed (%s: %s); evicting with "
                           "recompute-replay resume", self.name, type(e).__name__, e)
            return None
        snap["pos"] = s.pos
        snap["generated"] = list(s.generated)
        snap["replay"] = list(s.replay or ())
        m.KVSWAP_OUTS.inc()
        m.KVSWAP_BYTES.inc(int(snap["ref"].nbytes))
        self._swap_outs += 1
        _flight.record("serving.decode.swap_out", endpoint=self.name, seq=s.seq,
                       pages=int(snap["pages"]), bytes=int(snap["ref"].nbytes),
                       tokens_done=len(s.generated))
        return snap

    def _preempt(self, s: _Seq) -> None:
        self._slots[self._slots.index(s)] = None
        m.DECODE_SLOTS.dec()
        snap = self._swap_out(s) if self._swap_store is not None else None
        freed = int(snap["freed"]) if snap is not None else self._pool.free_seq(s.seq)
        m.DECODE_PREEMPTIONS.inc()
        m.DECODE_EVICTIONS.inc(freed)
        _flight.record("serving.decode.preempt", endpoint=self.name, seq=s.seq,
                       tokens_done=len(s.generated), pages_evicted=freed,
                       swapped=snap is not None)
        # requeue at the HEAD with the generated prefix (and any
        # unreplayed suffix) kept: a swap snapshot restores the pages on
        # rejoin, and the replay data beside it is the counted fallback
        self._resume[s.req] = list(s.generated) + list(s.replay or ())
        if snap is not None:
            self._swap[s.req] = snap
        if not self._admission.requeue_front(s.req):
            self._resume.pop(s.req, None)
            self._drop_swap(s.req)

    def _finish(self, s: _Seq) -> None:
        self._slots[self._slots.index(s)] = None
        m.DECODE_SLOTS.dec()
        self._pool.free_seq(s.seq)
        out = np.asarray(s.generated[:s.want], np.int32)[None, :]
        done = time.perf_counter()
        self._admission.observe_latency(done - s.req.t_submit)
        s.req.future._set({"tokens": out})
        _flight.record("serving.decode.finish", endpoint=self.name, seq=s.seq,
                       tokens=int(out.shape[1]), seconds=round(done - s.req.t_submit, 6))
        if _events.TRACER.enabled:
            args = {"endpoint": self.name, "seq": s.seq, "tokens": int(out.shape[1])}
            if s.req.trace_id:
                args["request_id"] = s.req.trace_id
            _events.TRACER.emit_complete("decode.finish", s.req.t_submit,
                                         done - s.req.t_submit, args=args, cat="serving")

    def _bit_identity_violation(self, s: _Seq, got: int, expect: int) -> None:
        """A resumed sequence diverged from its recorded tokens — a
        determinism bug, never load. Fail THIS request loudly; the engine
        keeps serving."""
        if s in self._slots:
            self._slots[self._slots.index(s)] = None
            m.DECODE_SLOTS.dec()
        self._pool.free_seq(s.seq)
        m.DISPATCH_ERRORS.inc()
        _flight.record("serving.decode.replay_divergence", endpoint=self.name, seq=s.seq,
                       got=got, expected=expect, at_token=len(s.generated))
        s.req.future._fail(ServingError(
            f"decode engine {self.name!r}: resumed sequence diverged from its "
            f"pre-preemption prefix (got token {got}, recorded {expect} at index "
            f"{len(s.generated)}) — determinism bug, please report"
        ))

    def _fail_all(self, exc: BaseException) -> None:
        for i, s in enumerate(self._slots):
            if s is not None:
                self._slots[i] = None
                m.DECODE_SLOTS.dec()
                self._pool.free_seq(s.seq)
                s.req.future._fail(exc)
        # queued requests fail with the same error, then admission closes
        for req in self._admission.poll(self._admission.max_queue_rows + len(self._slots)):
            self._resume.pop(req, None)
            req.future._fail(exc)
        self._admission.close(drain=False)
