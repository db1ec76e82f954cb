"""Data loading: batch iteration and host → device prefetch.

The reference package's ``io.py`` in its training subset:
:func:`iterate_batches` walks a frame's columns in minibatches on the
host, and :func:`prefetch_to_device` stages the next batches on the GPU
from a worker thread, so the next batch's host → device copy overlaps
the current step's compute. On the card each batch goes into pinned host
memory and is copied on a side CUDA stream; the consumer's stream waits
on an event recorded after the copy, and each handed-over tensor is
marked as used by the consumer's stream (``record_stream``), so the
allocator does not reuse its memory while the step still reads it.

Each staging copy runs under an optional retry policy, with the
``io.prefetch.device_put`` fault site inside the retry scope, as in the
reference. Readers and writers, ``save_frame``/``load_frame`` and sharded
placement are not ported yet (ROADMAP queue 1).
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterable, Iterator, List, Optional, Sequence

import numpy as np
import torch

from . import dtypes as dt
from .config import resolve_device
from .resilience.faults import fault_point
from .resilience.retry import RetryPolicy, retry_call
from .utils import get_logger

logger = get_logger(__name__)


def iterate_batches(
    frame,
    columns: Optional[Sequence[str]] = None,
    batch_size: int = 256,
    shuffle: bool = False,
    seed: int = 0,
    drop_remainder: bool = False,
) -> Iterator[Dict[str, np.ndarray]]:
    """Yield ``{col: array[batch, ...]}`` minibatches from a frame's dense
    columns (host-side). ``shuffle`` permutes the rows with
    ``np.random.default_rng(seed)``, as the reference does, so both
    packages yield the same rows in the same order."""
    if columns is None:
        columns = [c.name for c in frame.schema.device_columns]
    else:
        columns = list(columns)
    if not columns:
        raise ValueError(
            "iterate_batches: no columns to batch (frame has no dense "
            "device columns, or an empty selection was passed)"
        )
    cols = {c: np.asarray(frame.column_values(c)) for c in columns}
    n = len(next(iter(cols.values())))
    order = np.arange(n)
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    stop = n - (n % batch_size) if drop_remainder else n
    for lo in range(0, stop, batch_size):
        idx = order[lo : lo + batch_size]
        yield {c: v[idx] for c, v in cols.items()}


_SENTINEL = object()


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """One batch as tensors on ``device``, copied synchronously (the
    unprefetched path)."""
    return {k: dt.host_tensor(v).to(device) for k, v in batch.items()}


def prefetch_to_device(
    batches: Iterable[Dict[str, np.ndarray]],
    size: int = 2,
    device=None,
    join_timeout: float = 5.0,
    retry: Optional[RetryPolicy] = None,
) -> Iterator[Dict[str, torch.Tensor]]:
    """Wrap a batch iterator with background staging on ``device``
    (default ``config.device``): a worker thread keeps up to ``size``
    batches staged ahead of the consumer.

    On a CUDA device the worker copies each array into pinned host memory
    and then to the card on a side stream, and records an event; the
    consumer's current stream waits on that event before the batch is
    handed over, and every tensor handed over is ``record_stream``-ed on
    the consumer's stream. On the CPU the worker stages without streams.

    Failure semantics are the reference's: a worker exception is parked
    beside the data queue and re-raised by the consumer's next
    ``__next__`` once the already-staged batches are used; the consumer
    polls the worker's liveness, so a worker that died without a word
    ends the stream instead of hanging it; ``close()`` (or leaving the
    loop) stops the worker, drops staged batches and joins the worker
    with ``join_timeout``. ``retry`` (a
    :class:`~.resilience.RetryPolicy`) retries a failed staging copy,
    absorbing transient faults; ``None`` makes one attempt."""
    device = resolve_device(device)
    if size < 1:
        raise ValueError(f"prefetch_to_device: size must be >= 1, got {size}")
    return _staged(batches, size, device, join_timeout, retry)


def _staged(batches, size: int, device: torch.device, join_timeout: float,
            retry: Optional[RetryPolicy]):
    q: "queue.Queue" = queue.Queue(maxsize=size)
    stop = threading.Event()
    done = threading.Event()
    err: List[Optional[BaseException]] = [None]
    side = torch.cuda.Stream(device) if device.type == "cuda" else None

    def put(batch):
        fault_point("io.prefetch.device_put")
        if side is None:
            return to_device(batch, device), None
        pinned = {k: dt.host_tensor(v).pin_memory() for k, v in batch.items()}
        with torch.cuda.stream(side):
            staged = {k: t.to(device, non_blocking=True) for k, t in pinned.items()}
            ready = torch.cuda.Event()
            ready.record(side)
        return staged, ready

    def stage(batch):
        return retry_call(put, batch, policy=retry, describe="prefetch.device_put")

    def enqueue(item) -> bool:
        # a bounded put that gives up when the consumer is gone, so an
        # abandoned iterator cannot pin the worker (and its staged
        # device buffers) forever
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for batch in batches:
                if stop.is_set() or not enqueue(stage(batch)):
                    return
        except BaseException as e:  # parked for the consumer: a worker that
            # dies must surface as an error, not as a clean end of data
            err[0] = e
        finally:
            done.set()
            enqueue(_SENTINEL)

    t = threading.Thread(target=worker, daemon=True, name="tftorch-prefetch")
    t.start()
    try:
        while True:
            try:
                item = q.get(timeout=0.2)
            except queue.Empty:
                if done.is_set() or not t.is_alive():
                    try:
                        item = q.get_nowait()  # racing final enqueue
                    except queue.Empty:
                        if err[0] is not None:
                            raise err[0]
                        return
                else:
                    continue
            if item is _SENTINEL:
                if err[0] is not None:
                    raise err[0]
                return
            staged, ready = item
            if ready is not None:
                consumer = torch.cuda.current_stream(device)
                consumer.wait_event(ready)
                for tensor in staged.values():
                    tensor.record_stream(consumer)
            yield staged
    finally:
        stop.set()
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
        t.join(timeout=join_timeout)
        if t.is_alive():  # pragma: no cover - needs a wedged copy
            logger.warning(
                "prefetch_to_device: worker still running %.1fs after shutdown; "
                "leaving the daemon thread behind", join_timeout,
            )
