"""Training straight off a frame.

The reference package's ``training.py`` in its plain-loop subset:
:func:`train_on_frame` feeds a step function epoch-cycling minibatches
of a frame's columns, reshuffled per epoch, through background
host → device prefetch (:func:`tensorframes_tpu_torch.io.prefetch_to_device`),
and :func:`cast_float_leaves` casts a parameter tree.

Not ported yet (ROADMAP queue 1): checkpointed resume
(``run_resumable``, ``checkpoint.py``), non-finite-step guards
(``resilience/``), step telemetry (``observability/steps.py``) and
gradient accumulation (``make_grad_accum_step``). The arguments that
would reach them raise.
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Optional, Tuple

import torch

from .config import resolve_device
from .io import iterate_batches, prefetch_to_device, to_device
from .ops.quantize import _tree_map


def cast_float_leaves(tree, dtype):
    """Cast every floating tensor leaf of a parameter tree to ``dtype``
    (other leaves pass through): the mixed-precision parameter cast."""
    dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    return _tree_map(
        lambda _, x: x.to(dtype) if torch.is_tensor(x) and x.is_floating_point() else x, tree
    )


def _not_ported(name: str, module: str) -> NotImplementedError:
    return NotImplementedError(
        f"train_on_frame: {name}= is not ported yet: it needs {module} "
        "(ROADMAP queue 1)"
    )


def train_on_frame(
    step_fn: Callable[[Any, Any], Tuple[Any, Any]],
    init_state: Any,
    frame,
    columns,
    batch_size: int,
    num_steps: int,
    checkpointer=None,
    shuffle: bool = True,
    seed: int = 0,
    prefetch: int = 2,
    on_step: Optional[Callable[[int, Any], None]] = None,
    guard=None,
    telemetry=None,
    device=None,
) -> Tuple[Any, int]:
    """Run ``num_steps`` of ``state, metrics = step_fn(state, batch)`` off
    a frame: epoch-cycling minibatches of ``columns`` (the epoch-``e``
    pass shuffled with ``seed + e``, the remainder dropped so every batch
    has ``batch_size`` rows), staged on ``device`` (default
    ``config.device``) ``prefetch`` batches ahead, or copied in line when
    ``prefetch`` is 0. ``batch`` is ``{column: tensor[batch_size, ...]}``
    on the device; ``on_step(i, metrics)`` gets the 1-based step index.
    Returns ``(final_state, steps_run)``.

    ``checkpointer``, ``guard`` and ``telemetry`` raise
    ``NotImplementedError`` until checkpointing, the resilience guards
    and step telemetry are ported (the reference's ``save_every`` comes
    with the first)."""
    if checkpointer is not None:
        raise _not_ported("checkpointer", "checkpoint.py and run_resumable")
    if guard is not None:
        raise _not_ported("guard", "resilience/guards.py")
    if telemetry is not None:
        raise _not_ported("telemetry", "observability/steps.py")
    device = resolve_device(device)

    def batches():
        epoch = 0
        while True:
            yield from iterate_batches(
                frame, columns, batch_size=batch_size, shuffle=shuffle,
                seed=seed + epoch, drop_remainder=True,
            )
            epoch += 1

    raw = batches()
    if prefetch:
        stream = prefetch_to_device(raw, size=prefetch, device=device)
    else:
        stream = (to_device(b, device) for b in raw)
    try:
        state, ran = init_state, 0
        for batch in itertools.islice(stream, num_steps):
            state, metrics = step_fn(state, batch)
            ran += 1
            if on_step is not None:
                on_step(ran, metrics)
        return state, ran
    finally:
        # the epoch stream is infinite: close it, which stops and joins
        # the prefetch worker, so its staged batches are released now
        stream.close()
