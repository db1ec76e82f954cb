"""Resumable training, gradient accumulation and training off a frame.

The reference package's ``training.py``:

* :func:`run_resumable` runs ``state, metrics = step_fn(state, batch)``
  with periodic checkpoints (:class:`~.checkpoint.Checkpointer`) and
  resume-on-restart: a relaunched process calls it with the same
  arguments and continues from the newest intact checkpoint, replaying
  the batch stream deterministically. A ``guard=`` policy
  (:class:`~.resilience.StepGuard`) skips, rolls back or stops a
  non-finite step; ``telemetry=`` (:class:`~.observability.StepTelemetry`)
  logs each step.
* :func:`make_grad_accum_step` takes one optimizer step from several
  microbatches.
* :func:`train_on_frame` feeds a step function epoch-cycling minibatches
  of a frame's columns through background host → device prefetch
  (:func:`tensorframes_tpu_torch.io.prefetch_to_device`), resuming
  through :func:`run_resumable` when given a checkpointer.

The port's train steps update their tensors in place, so a train state
holds the ``torch.optim.Optimizer`` itself, e.g. ``(params, opt)``: the
checkpoint saves and restores it in place, the guard snapshots it on the
device (:mod:`.utils.tree`). Fleet supervision (``TFTPU_FLEET_DIR``) is
not ported yet: it is the fleet-supervision slice of ROADMAP queue 1.
"""

from __future__ import annotations

import itertools
import os
from typing import Any, Callable, Iterable, Optional, Tuple, Union

import torch

from .checkpoint import Checkpointer
from .config import resolve_device
from .io import iterate_batches, prefetch_to_device, to_device
from .observability import flight as _flight
from .observability.steps import StepTelemetry
from .ops.quantize import _tree_map
from .resilience.faults import kill_point
from .resilience.guards import StepGuard
from .utils import get_logger
from .utils import tree as _tree

logger = get_logger(__name__)


def run_resumable(
    step_fn: Callable[[Any, Any], Tuple[Any, Any]],
    init_state: Any,
    checkpointer: Optional[Checkpointer],
    batches: Iterable,
    num_steps: int,
    save_every: int = 100,
    on_step: Optional[Callable[[int, Any], None]] = None,
    skip_consumed: bool = True,
    guard: Optional[Union[StepGuard, str]] = None,
    resume_from: Optional[Tuple[int, Any]] = None,
    telemetry: Optional[StepTelemetry] = None,
) -> Tuple[Any, int]:
    """Run up to ``num_steps`` of ``state, metrics = step_fn(state, batch)``,
    checkpointing every ``save_every`` steps and resuming from the newest
    intact checkpoint if one exists.

    ``init_state`` doubles as the restore template; a train state that
    holds its optimizer is restored into in place. ``batches`` is
    consumed from the beginning on every (re)start and the steps the
    checkpoint already covers are skipped, so the data order stays
    deterministic across preemptions. Returns ``(final_state,
    steps_run_in_this_process)``.

    A checkpoint is written on normal loop exit and before an exception
    propagates (the emergency checkpoint), so a crash between
    ``save_every`` boundaries loses at most the step in flight
    (``save_every=0`` disables only the periodic saves). The emergency
    checkpoint is left out when the exception came out of ``step_fn``
    after it had written the state in place (its tensors' version
    counters moved): a torn state is never persisted, and the relaunch
    resumes from the previous checkpoint. ``guard`` — a
    :class:`~.resilience.StepGuard` or a policy string — inspects every
    update and writes the last admitted state back on a trip, so a
    ``"raise"`` leaves a finite emergency checkpoint; the restored
    checkpoint seeds it. ``telemetry`` runs after ``on_step`` with the
    same (global step, metrics) arguments. The loop edge is the
    ``fleet.rank.kill`` kill point. ``resume_from=(step, state)`` skips
    the restore (the caller restored already). ``checkpointer=None``
    (the port's addition, :func:`train_on_frame`'s plain loop) runs the
    same loop with no restore and no save."""
    if os.environ.get("TFTPU_FLEET_DIR"):
        raise RuntimeError(
            "run_resumable: TFTPU_FLEET_DIR is set, but fleet supervision (heartbeats, "
            "peer watch, coordinated abort: resilience/fleet.py's FleetMonitor and "
            "enroll) is not ported yet; it comes with the fleet-supervision slice "
            "(ROADMAP queue 1). Unset TFTPU_FLEET_DIR to train one process.")
    if guard is not None:
        guard = StepGuard.coerce(guard)
    start_step = 0
    state = init_state
    if resume_from is not None:
        start_step, state = resume_from
        logger.info("run_resumable: resuming from step %d (caller-restored)", start_step)
    elif checkpointer is not None and checkpointer.latest_step() is not None:
        # restore_latest, not restore(step=latest): a step torn by the
        # previous crash falls back to the prior intact one, and the
        # replay below skips to the step that actually loaded
        start_step, state = checkpointer.restore_latest(like=init_state)
        logger.info("run_resumable: resuming from step %d", start_step)
    if guard is not None:
        guard.seed(start_step, state)
    if start_step >= num_steps:
        return state, 0  # already complete: don't touch the iterator

    ran = 0
    step = start_step
    it = iter(batches)
    for i in range(start_step if skip_consumed else 0):
        try:
            next(it)
        except StopIteration:
            raise ValueError(
                f"run_resumable: dataset exhausted at batch {i} while skipping to "
                f"checkpointed step {start_step} — the batches passed on resume are "
                "shorter than the original run's") from None
    saving = checkpointer is not None
    before = None  # the state's version counters while step_fn runs
    try:
        while step < num_steps:
            kill_point()
            try:
                batch = next(it)
            except StopIteration:
                break
            if saving:
                before = _tree.versions(state)
            candidate, metrics = step_fn(state, batch)
            before = None
            if guard is not None:
                # on a trip the guard writes the last admitted state back
                # (in place) before it returns or raises, so `state` never
                # holds the NaN update when the emergency save runs
                candidate, _admitted = guard.admit(step + 1, candidate, metrics, prev_state=state)
            state = candidate
            step += 1
            ran += 1
            if on_step is not None:
                on_step(step, metrics)
            if telemetry is not None:
                telemetry(step, metrics)
            if saving and save_every and step % save_every == 0:
                checkpointer.save(step, state)
    except BaseException:
        if not saving:
            raise
        if before is not None and _tree.versions(state) != before:
            _flight.record("checkpoint.emergency_skipped", step=step)
            logger.error("run_resumable: step %d raised after writing the state in place; "
                         "no emergency checkpoint (the relaunch resumes from step %s)",
                         step + 1, checkpointer.latest_step())
            raise
        try:
            checkpointer.save(step, state)
            logger.warning("run_resumable: saved emergency checkpoint @ %d", step)
        except Exception:  # pragma: no cover
            logger.exception("run_resumable: emergency checkpoint failed")
        raise
    # final checkpoint on loop exit — also when periodic saves are off
    # (save_every=0), so a later relaunch never replays completed work
    if saving and ran and (not save_every or step % save_every != 0):
        checkpointer.save(step, state)
    return state, ran


def cast_float_leaves(tree, dtype):
    """Cast every floating tensor leaf of a parameter tree to ``dtype``
    (other leaves pass through): the mixed-precision parameter cast."""
    dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    return _tree_map(
        lambda _, x: x.to(dtype) if torch.is_tensor(x) and x.is_floating_point() else x, tree
    )


def make_grad_accum_step(
    loss_fn: Callable,
    opt: torch.optim.Optimizer,
    accum_steps: int,
    compute_dtype: Optional[str] = None,
) -> Callable:
    """Gradient accumulation: one optimizer step from ``accum_steps``
    microbatches, averaged.

    ``loss_fn(params, batch) -> scalar`` and ``opt`` an optimizer over the
    parameter tree's leaves (``transformer.adamw``). The returned
    ``step(params, opt_state, batch) -> (params, opt_state, loss)`` keeps
    the reference's signature and works in place, as
    ``transformer.make_train_step``: it splits every leaf of ``batch``
    along its leading dim into ``accum_steps`` microbatches, runs each
    one's backward (the gradients sum in the leaves' ``.grad``), divides
    the sums once by ``accum_steps`` — the reference's order — and takes
    one ``opt.step()``. ``loss`` is the mean of the microbatch losses, an
    f32 scalar. Activations are held for one microbatch at a time.

    ``compute_dtype`` (e.g. ``"bfloat16"``) casts the float parameters
    inside the differentiated function, so the forward and backward run
    in that dtype while the gradients land in f32 on the f32 masters."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")

    if compute_dtype is not None:
        def run_loss(p, mb):
            return loss_fn(cast_float_leaves(p, compute_dtype), mb)
    else:
        run_loss = loss_fn

    def split(x):
        n = x.shape[0]
        if n % accum_steps:
            raise ValueError(f"batch dim {n} not divisible by accum_steps={accum_steps}")
        return x.reshape((accum_steps, n // accum_steps) + tuple(x.shape[1:]))

    def step(params, opt_state, batch):
        micro = _tree_map(lambda _, x: split(x), batch)
        opt.zero_grad(set_to_none=True)
        loss_sum = None
        for i in range(accum_steps):
            loss = run_loss(params, _tree_map(lambda _, x: x[i], micro))
            loss.backward()
            part = loss.detach().float()
            loss_sum = part if loss_sum is None else loss_sum + part
        with torch.no_grad():
            grads = [p.grad for g in opt.param_groups for p in g["params"] if p.grad is not None]
            if grads and accum_steps > 1:
                torch._foreach_div_(grads, float(accum_steps))
        opt.step()
        return params, opt_state, loss_sum / accum_steps

    return step


def train_on_frame(
    step_fn: Callable[[Any, Any], Tuple[Any, Any]],
    init_state: Any,
    frame,
    columns,
    batch_size: int,
    num_steps: int,
    checkpointer: Optional[Checkpointer] = None,
    save_every: int = 100,
    shuffle: bool = True,
    seed: int = 0,
    prefetch: int = 2,
    on_step: Optional[Callable[[int, Any], None]] = None,
    guard: Optional[Union[StepGuard, str]] = None,
    telemetry: Optional[StepTelemetry] = None,
    device=None,
) -> Tuple[Any, int]:
    """Train straight off a frame: ``num_steps`` of ``state, metrics =
    step_fn(state, batch)`` over epoch-cycling minibatches of ``columns``
    (the epoch-``e`` pass shuffled with ``seed + e``, the remainder
    dropped so every batch has ``batch_size`` rows), staged on ``device``
    (default ``config.device``) ``prefetch`` batches ahead, or copied in
    line when ``prefetch`` is 0. ``batch`` is ``{column: tensor[batch_size,
    ...]}`` on the device. Returns ``(final_state, steps_run)``.

    The steps run through :func:`run_resumable`. With a ``checkpointer``
    the newest intact checkpoint is restored first, the batches it covers
    are skipped on the host before the prefetch starts, and
    ``on_step(i, metrics)`` gets the global step index (e.g. 701 after a
    resume at 700); without one nothing is restored or saved, and
    ``guard`` still inspects every step. ``telemetry``'s ``rows_per_step`` is filled in from
    ``batch_size`` when unset."""
    device = resolve_device(device)
    if telemetry is not None and telemetry.rows_per_step is None:
        telemetry.rows_per_step = batch_size

    def batches():
        epoch = 0
        while True:
            yield from iterate_batches(
                frame, columns, batch_size=batch_size, shuffle=shuffle,
                seed=seed + epoch, drop_remainder=True,
            )
            epoch += 1

    def staged(raw):
        if prefetch:
            return prefetch_to_device(raw, size=prefetch, device=device)
        return (to_device(b, device) for b in raw)

    raw = batches()
    stream = None
    try:
        # restore first (restore_latest falls back past corrupt steps and
        # reports the step that loaded), then skip the replay on the host
        # — before the prefetch exists, so a resume copies no batch it
        # only discards
        resume = None
        if checkpointer is not None and checkpointer.latest_step() is not None:
            latest, restored = checkpointer.restore_latest(like=init_state)
            resume = (latest, restored)
            for _ in itertools.islice(raw, min(latest, num_steps)):
                pass
        stream = staged(raw)
        return run_resumable(
            step_fn, init_state, checkpointer, stream, num_steps, save_every=save_every,
            on_step=on_step, skip_consumed=False, guard=guard, resume_from=resume,
            telemetry=telemetry,
        )
    finally:
        # the epoch stream is infinite: close it, which stops and joins
        # the prefetch worker, so its staged batches are released now
        if stream is not None:
            stream.close()
