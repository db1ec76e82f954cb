"""Per-step training telemetry: JSONL step log, live metrics, trace.

``StepTelemetry`` is an ``on_step``-shaped callable
(``telemetry(step, metrics)``) that ``training.run_resumable`` and
``training.train_on_frame`` invoke through their ``telemetry=``
parameter, as in the reference package. Each call it:

* measures the wall-clock since the previous step (the first step: since
  construction) and derives rows/s when the per-step row count is known —
  ``train_on_frame`` fills ``rows_per_step`` in from its batch size;
* extracts a scalar loss from the step's metrics (a bare scalar — a 0-d
  tensor on any device, which waits for that device — or a mapping with
  a ``"loss"`` entry; anything else records null);
* updates the registry: ``tftpu_train_steps_total``,
  ``tftpu_train_step_seconds``, ``tftpu_train_loss``,
  ``tftpu_train_rows_per_sec``;
* appends one JSON line to ``jsonl_path`` (when given) —
  ``{"step", "ts", "step_seconds", "loss", "rows_per_sec"}`` plus the
  ``run_id``/``process_index`` context stamp — flushed per line so a
  preempted run's log is complete up to the kill; and
* lands a ``train.step`` complete event on the trace timeline when
  tracing is enabled.

The instance is reusable across a resume.
"""

from __future__ import annotations

import json
import math
import time
from typing import IO, Any, Optional

import numpy as np
import torch

from . import context as _context
from . import events
from .metrics import REGISTRY, counter, gauge, histogram

__all__ = ["StepTelemetry", "extract_loss"]

_STEPS = counter("tftpu_train_steps_total", "Training steps observed by StepTelemetry")
_STEP_SECONDS = histogram("tftpu_train_step_seconds", "Wall-clock per training step (seconds)")
_LOSS = gauge("tftpu_train_loss", "Most recent per-step training loss")
_ROWS_PER_SEC = gauge("tftpu_train_rows_per_sec", "Most recent training throughput (rows/s)")


def extract_loss(metrics: Any) -> Optional[float]:
    """Best-effort scalar loss from a step's metrics: a mapping's
    ``"loss"`` entry, or the value itself when it is scalar-shaped.
    Returns None (→ JSON null) when no scalar is found."""
    v = metrics
    if hasattr(metrics, "get"):
        v = metrics.get("loss")
        if v is None:
            return None
    if torch.is_tensor(v):
        if v.dim() != 0 or v.is_complex():
            return None
        return float(v.detach().item())
    try:
        arr = np.asarray(v)
    except (TypeError, ValueError):
        return None
    if arr.shape != () or arr.dtype == object:
        return None
    try:
        return float(arr)
    except (TypeError, ValueError):
        return None


class StepTelemetry:
    """Step-telemetry sink; pass as ``telemetry=`` to the training loops
    (or call directly from a custom loop).

    ``rows_per_step`` enables rows/s; ``train_on_frame`` sets it from its
    batch size when left None. ``registry=None`` uses the process
    registry. Use as a context manager — or call :meth:`close` — to
    release the JSONL file handle."""

    def __init__(self, jsonl_path: Optional[str] = None, rows_per_step: Optional[int] = None,
                 registry=None):
        self.jsonl_path = jsonl_path
        self.rows_per_step = rows_per_step
        self.steps_seen = 0
        self.last_loss: Optional[float] = None
        if registry is None or registry is REGISTRY:
            self._steps, self._step_seconds = _STEPS, _STEP_SECONDS
            self._loss, self._rows_per_sec = _LOSS, _ROWS_PER_SEC
        else:
            self._steps = registry.counter("tftpu_train_steps_total")
            self._step_seconds = registry.histogram("tftpu_train_step_seconds")
            self._loss = registry.gauge("tftpu_train_loss")
            self._rows_per_sec = registry.gauge("tftpu_train_rows_per_sec")
        self._file: Optional[IO[str]] = None
        # the first step is charged from construction, so its time holds
        # the start-up (kernel loads, a restore) and every row is populated
        self._last_t: float = time.perf_counter()

    def _sink(self) -> Optional[IO[str]]:
        if self.jsonl_path is None:
            return None
        if self._file is None or self._file.closed:
            self._file = open(self.jsonl_path, "a")
        return self._file

    def __call__(self, step: int, metrics: Any) -> None:
        loss = extract_loss(metrics)  # waits for the step's device, so dt is the step's
        now = time.perf_counter()
        dt = now - self._last_t
        self._last_t = now
        self.steps_seen += 1
        self.last_loss = loss
        # a guard-tripped step hands its non-finite metrics through:
        # strict JSON has no NaN token, so record null and leave the gauge
        json_loss = loss if loss is not None and math.isfinite(loss) else None
        rows_per_sec = None
        self._steps.inc()
        self._step_seconds.observe(dt)
        if self.rows_per_step and dt > 0:
            rows_per_sec = self.rows_per_step / dt
        if json_loss is not None:
            self._loss.set(json_loss)
        if rows_per_sec is not None:
            self._rows_per_sec.set(rows_per_sec)
        if events.active():
            events.TRACER.emit_complete("train.step", now - dt, dt,
                                        args={"step": step, "loss": json_loss}, cat="train")
        f = self._sink()
        if f is not None:
            f.write(json.dumps({
                "step": int(step),
                "ts": round(time.time(), 6),
                "step_seconds": round(dt, 6),
                "loss": json_loss,
                "rows_per_sec": round(rows_per_sec, 3) if rows_per_sec is not None else None,
                **_context.snapshot(),
            }) + "\n")
            f.flush()

    def close(self) -> None:
        if self._file is not None and not self._file.closed:
            self._file.close()

    def __enter__(self) -> "StepTelemetry":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
