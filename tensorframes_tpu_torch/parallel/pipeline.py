"""Pipeline parallelism: a GPipe-style microbatch schedule over a mesh
``pp`` axis of ranks.

The reference package's ``parallel/pipeline.py`` runs every stage in one
SPMD program under ``shard_map``: a ``lax.scan`` over ``num_microbatches
+ num_stages - 1`` ticks, each device's activation shifted one hop down
the ring by ``lax.ppermute``, the last stage's outputs broadcast by a
masked ``psum``. Here each stage is a rank of the ``pp`` axis
(``Mesh.group``), on the same schedule: at tick ``t`` stage ``s``
computes microbatch ``t - s`` (a bubble tick computes nothing), then
every rank shifts its output one hop (:func:`.collectives.ring_permute`'s
exchange); stage 0 feeds from the microbatch queue, and the last stage's
outputs reach every stage by a broadcast.

Differentiable end to end: the schedule is one ``autograd.Function``
whose backward runs the ticks in reverse, each stage taking its
output's gradient from the next stage by the inverse permute and
differentiating its own stage at that tick, so every rank calls every
collective of the backward in the same order, whatever its bubbles.

Where the reference's stage weights are global arrays sharded ``P(pp)``,
a rank here holds its stage's slice (:func:`shard_stage_params`).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..ops.quantize import _tree_map, tree_leaves
from . import collectives as _coll

__all__ = ["pipeline_apply", "make_pp_train_step", "shard_stage_params",
           "gather_stage_params"]


def _leaf_paths(tree):
    out = []
    _tree_map(lambda path, leaf: out.append((path, leaf)), tree)
    return out


def _keystr(path) -> str:
    return "".join(f"[{k!r}]" for k in path)


class _Schedule:
    """What one rank's schedule needs: its stage, the microbatch count,
    the stage function and how to rebuild its parameter tree."""

    def __init__(self, stage_fn, tree, group, n_stages, stage, n_micro, grad):
        self.stage_fn, self.tree = stage_fn, tree
        self.group, self.n_stages, self.stage, self.n_micro = group, n_stages, stage, n_micro
        self.grad = grad
        self.ticks = n_micro + n_stages - 1

    def active(self, t: int) -> bool:
        return self.stage <= t < self.stage + self.n_micro

    def params(self, leaves):
        """The stage's tree: each ``[1, ...]`` slice without its stage dim."""
        it = iter(leaves)
        return _tree_map(lambda _, __: next(it)[0], self.tree)

    def permute(self, x, shift: int):
        if self.group is None:
            return x
        return _coll._permute(x, self.group, shift)


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, run: _Schedule, xs, *leaves):
        S, s, m = run.n_stages, run.stage, run.n_micro
        zeros = torch.zeros_like(xs[0])
        out = torch.zeros_like(xs)
        records, h = {}, zeros
        with torch.enable_grad() if run.grad else torch.no_grad():
            det = [leaf.detach().requires_grad_(leaf.requires_grad) for leaf in leaves]
            params = run.params(det)
            for t in range(run.ticks):
                send = zeros
                if run.active(t):
                    src = xs[t] if s == 0 else h
                    cur = src.detach().requires_grad_(run.grad and (s > 0 or xs.requires_grad))
                    y = run.stage_fn(params, cur)
                    if y.shape != cur.shape or y.dtype != cur.dtype:
                        raise ValueError(
                            f"pipeline_apply: a stage must keep its input's shape and dtype "
                            f"({tuple(cur.shape)} {cur.dtype} in, {tuple(y.shape)} {y.dtype} out)")
                    if run.grad:
                        records[t] = (cur, y)
                    send = y.detach()
                    if s == S - 1:
                        out[t - (S - 1)] = send
                if t < run.ticks - 1:  # the reference's last shift feeds nothing
                    h = run.permute(send, 1)
        ctx.run, ctx.records, ctx.det = run, records, det
        ctx.x_grad = xs.requires_grad
        if run.group is not None:
            out = _coll._broadcast(out, run.group, S - 1)
        return out

    @staticmethod
    def backward(ctx, g_out):
        run, records, det = ctx.run, ctx.records, ctx.det
        S, s = run.n_stages, run.stage
        zeros = torch.zeros_like(g_out[0])
        gx = torch.zeros_like(g_out) if ctx.x_grad and s == 0 else None
        grads = [None] * len(det)
        want = [i for i, leaf in enumerate(det) if leaf.requires_grad]
        g_next = zeros  # this rank's gradient of its input at tick t + 1
        for t in reversed(range(run.ticks)):
            g_y = run.permute(g_next, -1) if t < run.ticks - 1 else zeros
            g_next = zeros
            if not run.active(t):
                continue
            if s == S - 1:  # every stage computes the same loss: keep the source's
                g_y = g_y + g_out[t - (S - 1)]
            cur, y = records[t]
            inputs = ([cur] if cur.requires_grad else []) + [det[i] for i in want]
            if not inputs:
                continue
            got = torch.autograd.grad(y, inputs, g_y, allow_unused=True)
            if cur.requires_grad:
                g_cur, got = got[0], got[1:]
                if s == 0:
                    gx[t] = g_cur
                else:
                    g_next = g_cur
            for i, g in zip(want, got):
                if g is not None:
                    grads[i] = g if grads[i] is None else grads[i] + g
        ctx.records = None
        return (None, gx, *grads)


def _stage_slice(leaves, paths, n_stages: int, stage: int, axis: str):
    """Each leaf's ``[1, ...]`` slice for this stage: a leaf of leading dim
    ``n_stages`` is the whole stack, one of leading dim 1 this rank's
    slice already (what :func:`shard_stage_params` gives)."""
    out = []
    for path, leaf in zip(paths, leaves):
        d = int(leaf.shape[0]) if leaf.dim() else 0
        if d == n_stages:
            out.append(leaf[stage:stage + 1])
        elif d == 1:
            out.append(leaf)
        else:
            raise ValueError(
                f"stage_params leaf {_keystr(path)} has leading "
                f"dim {d}, expected num_stages={n_stages} "
                f"(mesh axis {axis!r})"
            )
    return out


def pipeline_apply(
    stage_fn: Callable,
    stage_params,
    x: torch.Tensor,
    mesh,
    axis: str = "pp",
    num_microbatches: Optional[int] = None,
    batch_axis: Optional[str] = "dp",
):
    """Run ``num_stages`` chained applications of ``stage_fn`` as a
    pipeline over the mesh's ``axis`` (one stage a rank).

    ``stage_fn(params_slice, h) -> h`` is one stage's computation; ``h``
    keeps its shape and dtype from stage to stage. ``stage_params`` is a
    tree whose leaves have a leading stage dim: this rank's slice
    (leading dim 1, :func:`shard_stage_params`) or the whole stack
    (leading dim ``num_stages``, of which this rank takes its stage's
    slice). ``x`` is this rank's block of the batch (split over
    ``batch_axis`` when the mesh has it), cut into ``num_microbatches``
    equal microbatches (default: the pp degree).

    Returns ``stage_{S-1}(... stage_0(x))`` on every rank of ``axis``.
    Differentiable in ``x`` and in the stage parameters."""
    del batch_axis  # x is already this rank's block of the batch
    n_stages = mesh.shape[axis]
    paths = _leaf_paths(stage_params)
    leaves = [leaf for _, leaf in paths]
    stage = mesh.axis_index(axis)
    local = _stage_slice(leaves, [p for p, _ in paths], n_stages, stage, axis)
    m = num_microbatches or n_stages
    batch = x.shape[0]
    if batch % m != 0:
        raise ValueError(f"batch {batch} not divisible by {m} microbatches")
    xs = x.reshape(m, batch // m, *x.shape[1:])
    grad = torch.is_grad_enabled() and (x.requires_grad or any(
        leaf.requires_grad for leaf in local))
    run = _Schedule(stage_fn, stage_params, mesh.group(axis), n_stages, stage, m, grad)
    out = _Pipeline.apply(run, xs, *local)
    return out.reshape(batch, *x.shape[1:])


def shard_stage_params(stage_params, mesh, axis: str = "pp", device=None):
    """This rank's ``[1, ...]`` slice of every leaf of a whole stage stack
    (leading dim ``num_stages``), fresh tensors on ``device`` (default:
    this rank's): the counterpart of ``jax.device_put`` with ``P(axis)``."""
    from .mesh import PartitionSpec as P, shard_tensor

    return _tree_map(lambda path, leaf: shard_tensor(leaf, P(axis), mesh, device=device,
                                                     what=_keystr(path)), stage_params)


def gather_stage_params(local, mesh, axis: str = "pp"):
    """The whole stage stack from every rank's slice (collective)."""
    from .mesh import PartitionSpec as P, gather_tensor

    return _tree_map(lambda _, leaf: gather_tensor(leaf.detach(), P(axis), mesh), local)


def make_pp_train_step(
    stage_fn: Callable,
    loss_head: Callable,
    mesh,
    tx,
    axis: str = "pp",
    num_microbatches: Optional[int] = None,
    batch_axis: Optional[str] = "dp",
):
    """The train step of one rank of a pipelined model, as the
    reference's: returns ``jit_for(stage_params) -> (step, init_opt,
    shardings)``.

    ``loss_head(h, targets) -> scalar`` consumes the last stage's output
    on this rank's block of the batch; the step's loss is its mean over
    ``batch_axis`` (each rank's value divided by the axis size and summed,
    Megatron's g), and each stage's gradients are summed over
    ``batch_axis``. Gradients flow back through the schedule in reverse.
    ``tx`` is an optimizer factory over a tree's leaves (where the
    reference takes an optax transformation); ``init_opt(local)`` builds
    it over this rank's stage slice (``shardings``: ``P(axis)`` for every
    leaf; :func:`shard_stage_params` cuts them). ``step(local, opt, x,
    targets) -> (local, opt, loss)`` updates in place."""
    from .mesh import NamedSharding, PartitionSpec as P

    db = batch_axis if (batch_axis and batch_axis in mesh.shape) else None
    n_db = mesh.axis_size(db) if db else 1
    grad_group = mesh.group(db) if db else None
    mesh.group(axis)

    def step(stage_params, opt, x, targets):
        opt.zero_grad(set_to_none=True)
        out = pipeline_apply(stage_fn, stage_params, x, mesh, axis=axis,
                             num_microbatches=num_microbatches, batch_axis=db)
        loss = _coll.reduce_from_group(loss_head(out, targets) / n_db, grad_group)
        loss.backward()
        _coll.allreduce_grads(tree_leaves(stage_params), grad_group)
        opt.step()
        return stage_params, opt, loss.detach()

    def param_shardings(stage_params):
        return _tree_map(lambda _, __: NamedSharding(mesh, P(axis)), stage_params)

    def jit_for(stage_params):
        sh = param_shardings(stage_params)

        def init_opt(local):
            for leaf in tree_leaves(local):
                leaf.requires_grad_(True)
            return tx(local)

        return step, init_opt, sh

    return jit_for
