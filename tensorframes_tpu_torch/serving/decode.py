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

Not ported yet (ROADMAP queue 1): the prefix cache and KV swap tiers,
flight/event hooks and fault-injection sites, CUDA graphs for the step.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Deque, Dict, List, Optional

import numpy as np
import torch

from ..config import resolve_device
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

__all__ = ["DecodeConfig", "DecodeEngine"]


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
    of the slot × phase bucket grid once at start. ``kv_swap``,
    ``prefix_cache`` and ``swap_dir`` belong to tiers not ported yet:
    ``True`` raises.
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
        if cfg.prefix_cache or cfg.kv_swap:
            raise NotImplementedError(
                "DecodeConfig(prefix_cache=True) and DecodeConfig(kv_swap=True) are not "
                "ported yet: the prefix cache and KV swap tiers wait in ROADMAP queue 1 "
                "(serving: paged_suffix_prefill_fn, paged_page_ops_fns, the pool's "
                "shared-page and swap methods)"
            )
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
        # the logits product pads to the top slot bucket: one library
        # shape whatever the running slot count (batched == solo)
        self._step = gen.paged_decode_step_fn(
            model_cfg, cfg.page_size, max_pages, logits_rows=self._slot_buckets[-1],
        )
        self._admission = ContinuousBatcher(name, max_queue_rows=cfg.max_queue_requests)
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
        return snap

    # -- lifecycle ----------------------------------------------------------

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
        try:
            # _running commits only after warmup, admission and the loop
            # thread all succeed: a failed warm leaves it restartable
            self._pool.reopen()
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
        return self

    def _warm(self) -> None:
        """Run every point of the slot × phase bucket grid once against
        null tables (writes land in the null page; results are discarded):
        the kernel build and the library handles are paid here, before
        the first request."""
        t0 = time.perf_counter()
        cols = self._pool.columns
        null = self._pool.null_table()
        maxp = self._pool.max_pages_per_seq
        for tb in self._prefill_buckets:
            self._prefill(self.params, cols, np.zeros(tb, np.int32), 1, null)
        for sb in self._slot_buckets:
            self._step(self.params, cols, np.zeros(sb, np.int32), np.zeros(sb, np.int32),
                       np.zeros((sb, maxp), np.int32))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        logger.info("decode warmup[%s]: prefill buckets %s + decode buckets %s in %.2fs",
                    self.name, self._prefill_buckets, self._slot_buckets,
                    time.perf_counter() - t0)

    def stop(self, drain: bool = True, timeout: Optional[float] = None) -> None:
        """Close admission; ``drain=True`` completes every admitted and
        queued sequence first, ``drain=False`` fails them with
        :class:`ServingError`. Bounded by ``timeout``."""
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
        queue and slot wait."""
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
        claims its prompt pages from a snapshot budget, so a multi-request
        poll never overcommits the pool."""
        budget = [self._pool.num_allocatable]

        def can_take(req: _Request) -> bool:
            need = self._pool.pages_needed(int(req.feeds["prompt"].shape[0]))
            if need > budget[0]:
                return False
            budget[0] -= need
            return True

        return can_take

    def _purge_resume(self) -> None:
        # a preempted request can expire while requeued: drop its replay
        if self._resume:
            for r in [r for r in self._resume if r.future.done()]:
                del self._resume[r]

    def _prefill_bucket(self, plen: int) -> int:
        for b in self._prefill_buckets:
            if b >= plen:
                return b
        raise AssertionError(  # pragma: no cover - validated at submit
            f"prompt of {plen} tokens above the prefill ladder {self._prefill_buckets}"
        )

    def _prefill_seq(self, seq: int, prompt: np.ndarray, plen: int) -> int:
        """Allocate the prompt's pages, write its KV and return the first
        token (one host sync)."""
        self._pool.alloc(seq, self._pool.pages_needed(plen))
        padded = np.zeros(self._prefill_bucket(plen), np.int32)
        padded[:plen] = prompt
        _, first = self._prefill(self.params, self._pool.columns, padded, plen,
                                 self._pool.table(seq))
        m.DECODE_STEPS["prefill"].inc()
        return int(first)

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
            return
        prompt = req.feeds["prompt"]
        plen = int(prompt.shape[0])
        seq = self._next_seq
        self._next_seq += 1
        replay = self._resume.pop(req, None)
        try:
            tok = self._prefill_seq(seq, prompt, plen)
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
        if len(s.generated) >= s.want:
            self._finish(s)

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
        _, nxt = self._step(self.params, self._pool.columns, tokens, pos, tables)
        nxt = nxt.cpu().numpy()  # the step's one host sync
        m.DECODE_STEPS["decode"].inc()
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

    def _preempt(self, s: _Seq) -> None:
        self._slots[self._slots.index(s)] = None
        m.DECODE_SLOTS.dec()
        freed = self._pool.free_seq(s.seq)
        m.DECODE_PREEMPTIONS.inc()
        m.DECODE_EVICTIONS.inc(freed)
        # requeue at the HEAD with the generated prefix (and any
        # unreplayed suffix) kept: on rejoin prefill + teacher-forced
        # replay must reproduce it exactly
        self._resume[s.req] = list(s.generated) + list(s.replay or ())
        if not self._admission.requeue_front(s.req):
            self._resume.pop(s.req, None)

    def _finish(self, s: _Seq) -> None:
        self._slots[self._slots.index(s)] = None
        m.DECODE_SLOTS.dec()
        self._pool.free_seq(s.seq)
        out = np.asarray(s.generated[:s.want], np.int32)[None, :]
        self._admission.observe_latency(time.perf_counter() - s.req.t_submit)
        s.req.future._set({"tokens": out})

    def _bit_identity_violation(self, s: _Seq, got: int, expect: int) -> None:
        """A resumed sequence diverged from its recorded tokens — a
        determinism bug, never load. Fail THIS request loudly; the engine
        keeps serving."""
        if s in self._slots:
            self._slots[self._slots.index(s)] = None
            m.DECODE_SLOTS.dec()
        self._pool.free_seq(s.seq)
        m.DISPATCH_ERRORS.inc()
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
