"""Mixture-of-Experts FFN with expert parallelism (EP).

The reference package's ``models/moe.py`` (GShard/Switch style):

* **Routing** is switch (top-1) with a per-shard expert capacity;
  dispatch and combine are one-hot einsums: dense products with static
  shapes, no gather/scatter, no data-dependent control flow.
* **Expert parallelism** splits the expert dim of the weight stacks over
  the mesh's ``ep`` axis of ranks; tokens travel to their expert's rank
  and back through two ``all_to_all`` exchanges over the axis's group
  (:func:`..parallel.collectives.all_to_all`, differentiable).
* Dropped tokens (over capacity) pass through on the residual path, as
  in Switch Transformers.

:func:`moe_ffn` (one process) and :func:`moe_ffn_ep` (ranks) compute the
same function when capacity is not exceeded. Where the reference's
``moe_ffn_ep`` takes global arrays under ``shard_map``, the port's takes
this rank's tokens and expert shard (:func:`shard_moe_params`), as its
``shard_fn`` does.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..config import resolve_device


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    hidden: int = 64
    mlp_hidden: int = 256
    num_experts: int = 8
    # per-expert slots as a multiple of (tokens / experts); tokens over
    # capacity fall through to the residual connection
    capacity_factor: float = 1.25
    dtype: Any = torch.float32

    def capacity(self, tokens_per_shard: int) -> int:
        c = int(np.ceil(self.capacity_factor * tokens_per_shard / self.num_experts))
        return max(c, 1)


def init_moe_params(cfg: MoEConfig, seed: int = 0, device=None) -> Dict:
    """The f32 parameter tree on ``device`` (default ``config.device``),
    drawn from a ``torch.Generator`` seeded with ``seed`` (the reference's
    scales; its ``jax.random`` numbers differ: carry its weights across
    with :func:`moe_params_from_jax`)."""
    device = resolve_device(device)
    g = torch.Generator().manual_seed(int(seed))
    h, m, e = cfg.hidden, cfg.mlp_hidden, cfg.num_experts
    s_in, s_out = float(1.0 / np.sqrt(h)), float(1.0 / np.sqrt(m))

    def normal(shape, scale):
        return (torch.randn(shape, generator=g, dtype=torch.float32) * scale).to(device)

    return {
        "router": normal((h, e), s_in),
        "w_in": normal((e, h, m), s_in),
        "b_in": torch.zeros((e, m), dtype=torch.float32, device=device),
        "w_out": normal((e, m, h), s_out),
        "b_out": torch.zeros((e, h), dtype=torch.float32, device=device),
    }


def moe_params_from_jax(tree, device=None) -> Dict:
    """A reference MoE tree, its arrays converted to numpy, as the port's:
    the same keys and layouts, each a tensor on ``device`` (default
    ``config.device``)."""
    from .transformer import params_from_jax

    if set(tree) != {"router", "w_in", "b_in", "w_out", "b_out"}:
        raise ValueError(f"MoE params need router/w_in/b_in/w_out/b_out, got {sorted(tree)}")
    return params_from_jax(tree, device=device)


def moe_param_shardings(mesh, axis: str = "ep") -> Dict:
    """Expert dim sharded over ``axis``; the router is replicated."""
    from ..parallel.mesh import NamedSharding, PartitionSpec as P

    ep = axis if axis in mesh.shape else None

    def ns(*spec):
        return NamedSharding(mesh, P(*spec))

    return {
        "router": ns(),
        "w_in": ns(ep, None, None),
        "b_in": ns(ep, None),
        "w_out": ns(ep, None, None),
        "b_out": ns(ep, None),
    }


def shard_moe_params(params: Dict, mesh, axis: str = "ep", device=None) -> Dict:
    """This rank's shard of a whole MoE tree under
    :func:`moe_param_shardings` (its experts' stacks, the router whole),
    fresh tensors on ``device`` (default: this rank's)."""
    from ..parallel.mesh import shard_tensor

    sh = moe_param_shardings(mesh, axis=axis)
    return {k: shard_tensor(v, sh[k], mesh, device=device, what=k) for k, v in params.items()}


def _token_spec(mesh, axis: str, batch_axis: Optional[str]):
    from ..parallel.mesh import NamedSharding, PartitionSpec as P

    db = batch_axis if (batch_axis and batch_axis in mesh.shape) else None
    return NamedSharding(mesh, P((axis, db) if db else axis, None))


# ---------------------------------------------------------------------------
# Routing (shared by both impls)
# ---------------------------------------------------------------------------

def _route(cfg: MoEConfig, router_w, x, capacity: int):
    """Switch top-1 routing with capacity.

    Returns (dispatch ``[t, e, c]`` one-hot, combine ``[t, e, c]``
    gate-weighted, the load-balancing stats (frac, prob))."""
    logits = x.float() @ router_w  # [t, e]
    gates = torch.softmax(logits, dim=-1)
    idx = torch.argmax(gates, dim=-1)  # [t], the first of equal maxima
    gate = torch.gather(gates, -1, idx[:, None])[:, 0]  # [t]
    expert_1h = F.one_hot(idx, cfg.num_experts).float()  # [t, e]
    # position of each token within its expert's queue (first-come)
    pos = torch.cumsum(expert_1h, dim=0) * expert_1h  # [t, e]; 1-based
    pos = (pos.sum(dim=-1) - 1.0).to(torch.int32)  # [t]
    keep = (pos < capacity) & (pos >= 0)
    # jax.nn.one_hot of an index past the last class is a zero row
    pos_1h = (pos[:, None] == torch.arange(capacity, device=x.device)[None, :]).float()
    dispatch = expert_1h[:, :, None] * pos_1h[:, None, :]  # [t, e, c]
    dispatch = dispatch * keep[:, None, None]
    combine = dispatch * gate[:, None, None]
    # Switch aux loss stats: fraction routed + mean gate prob per expert
    frac = expert_1h.mean(dim=0)
    prob = gates.mean(dim=0)
    return dispatch, combine, (frac, prob)


def load_balancing_loss(frac: torch.Tensor, prob: torch.Tensor) -> torch.Tensor:
    """Switch Transformers aux loss: E · Σ_e frac_e · prob_e."""
    e = frac.shape[-1]
    return e * torch.sum(frac * prob, dim=-1)


def _expert_ffn(w_in, b_in, w_out, b_out, tokens, dtype):
    """tokens ``[e, c, h]`` through each expert's 2-layer MLP (one batched
    product per projection across the local experts)."""
    y = torch.einsum("ech,ehm->ecm", tokens.to(dtype), w_in.to(dtype))
    y = F.gelu(y + b_in[:, None, :].to(dtype), approximate="tanh")  # jax.nn.gelu's default
    y = torch.einsum("ecm,emh->ech", y, w_out.to(dtype))
    return y + b_out[:, None, :].to(dtype)


# ---------------------------------------------------------------------------
# One process
# ---------------------------------------------------------------------------

def moe_ffn(cfg: MoEConfig, params: Dict, x: torch.Tensor, return_stats: bool = False):
    """x ``[t, h]`` → ``[t, h]``: einsum dispatch and combine in one
    process. With ``return_stats`` also the (frac, prob) load-balancing
    stats of the routing pass (so losses do not route twice)."""
    capacity = cfg.capacity(x.shape[0])
    dispatch, combine, stats = _route(cfg, params["router"], x, capacity)
    dispatched = torch.einsum("tec,th->ech", dispatch, x.float())
    outs = _expert_ffn(params["w_in"], params["b_in"], params["w_out"], params["b_out"],
                       dispatched, cfg.dtype)
    y = torch.einsum("tec,ech->th", combine, outs.float()).to(x.dtype)
    return (y, stats) if return_stats else y


# ---------------------------------------------------------------------------
# Across ranks (two all_to_all exchanges over 'ep')
# ---------------------------------------------------------------------------

def moe_ffn_ep(
    cfg: MoEConfig,
    params: Dict,
    x: torch.Tensor,
    mesh,
    axis: str = "ep",
    batch_axis: Optional[str] = "dp",
    return_stats: bool = False,
):
    """This rank's tokens ``x [t_local, h]`` (the batch split over
    ``axis`` × ``batch_axis``) → ``[t_local, h]``, with this rank's experts
    (``params``: :func:`shard_moe_params`). Each rank routes its tokens,
    ships them to the owning expert's rank (``all_to_all``), runs its
    experts, and ships the results back. A ``batch_axis`` on the mesh
    splits the tokens further (each of its replicas exchanges over its
    own ``ep`` group). The stats are the global means (the per-rank ones
    averaged over ``axis`` × ``batch_axis``)."""
    from ..parallel.collectives import all_to_all, reduce_from_group

    n_ep = mesh.shape[axis]
    if cfg.num_experts % n_ep != 0:
        raise ValueError(
            f"num_experts={cfg.num_experts} not divisible by mesh axis "
            f"{axis!r}={n_ep}"
        )
    e_local = cfg.num_experts // n_ep
    if params["w_in"].shape[0] != e_local:
        raise ValueError(f"moe_ffn_ep: this rank holds {params['w_in'].shape[0]} experts, "
                         f"expected {e_local} (shard_moe_params)")
    db = batch_axis if (batch_axis and batch_axis in mesh.shape) else None
    stat_axes = (axis, db) if db else (axis,)
    t_local = x.shape[0]
    capacity = cfg.capacity(t_local)
    dispatch, combine, (frac, prob) = _route(cfg, params["router"], x, capacity)
    # global load-balance stats = mean of per-rank stats (equal sizes)
    stats_group, n_stats = mesh.group(stat_axes), mesh.axis_size(stat_axes)
    frac = reduce_from_group(frac, stats_group) / n_stats
    prob = reduce_from_group(prob, stats_group) / n_stats
    group = mesh.group(axis)
    # [t, e, c] → [e, c, h], expert-major so the exchange's split is
    # contiguous: [ep, e_local, c, h]; after it, dim 0 is the source rank
    dispatched = torch.einsum("tec,th->ech", dispatch, x.float())
    recv = all_to_all(dispatched.reshape(n_ep, e_local, capacity, -1), group, 0, 0)
    tokens = recv.transpose(0, 1).reshape(e_local, n_ep * capacity, -1)
    outs = _expert_ffn(params["w_in"], params["b_in"], params["w_out"], params["b_out"],
                       tokens, cfg.dtype)
    # reverse the exchange: [ep(expert group), e_local, c, h] → [e, c, h]
    outs = outs.reshape(e_local, n_ep, capacity, -1).transpose(0, 1)
    back = all_to_all(outs.float().contiguous(), group, 0, 0)
    back = back.reshape(cfg.num_experts, capacity, -1)
    y = torch.einsum("tec,ech->th", combine, back).to(x.dtype)
    return (y, (frac, prob)) if return_stats else y


# ---------------------------------------------------------------------------
# Training helpers
# ---------------------------------------------------------------------------

def loss_fn(
    cfg: MoEConfig,
    params: Dict,
    x: torch.Tensor,
    y: torch.Tensor,
    mesh=None,
    axis: str = "ep",
    batch_axis: Optional[str] = "dp",
    aux_weight: float = 0.01,
) -> torch.Tensor:
    """Regression loss through the MoE layer plus the Switch aux loss,
    in one process or, on a mesh with ``axis``, on this rank's tokens and
    experts: the mean squared error over every rank's tokens (each rank's
    mean divided by the ranks and summed: Megatron's g) plus the aux loss
    of the global stats. The aux stats come from the forward's own
    routing."""
    from ..parallel.collectives import reduce_from_group

    if mesh is not None and axis in mesh.shape:
        out, (frac, prob) = moe_ffn_ep(cfg, params, x, mesh, axis=axis, batch_axis=batch_axis,
                                       return_stats=True)
        db = batch_axis if (batch_axis and batch_axis in mesh.shape) else None
        axes = (axis, db) if db else (axis,)
        mse = torch.mean((out.float() - y.float()) ** 2) / mesh.axis_size(axes)
        mse = reduce_from_group(mse, mesh.group(axes))
    else:
        out, (frac, prob) = moe_ffn(cfg, params, x, return_stats=True)
        mse = torch.mean((out.float() - y.float()) ** 2)
    return mse + aux_weight * load_balancing_loss(frac, prob)


def make_ep_train_step(cfg: MoEConfig, mesh, tx, axis: str = "ep",
                       batch_axis: Optional[str] = "dp"):
    """The expert-parallel train step of one rank, as the reference's:
    returns ``(step, data_sharding, shardings, init_opt)``. Tokens split
    over ``axis`` × ``batch_axis`` (each replica of ``batch_axis`` trains
    on its own slice), expert stacks over ``axis``. ``tx`` is an
    optimizer factory over a tree's leaves (where the reference takes an
    optax transformation); ``init_opt(local)`` builds it over this rank's
    shard, so its state is split like the parameters. ``step(local,
    opt, x, y) -> (local, opt, loss)`` takes this rank's tokens and
    targets and updates in place; the router's gradient is summed over
    ``axis`` × ``batch_axis``, the experts' over ``batch_axis`` (the
    exchange's backward already brought every rank's tokens to them)."""
    from ..ops.quantize import tree_leaves
    from ..parallel.collectives import allreduce_grads

    db = batch_axis if (batch_axis and batch_axis in mesh.shape) else None
    shardings = moe_param_shardings(mesh, axis=axis)
    data_sharding = _token_spec(mesh, axis, db)
    router_group = mesh.group((axis, db) if db else (axis,))
    expert_group = mesh.group(db) if db else None
    mesh.group(axis)

    def step(params, opt, x, y):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(cfg, params, x, y, mesh=mesh, axis=axis, batch_axis=db)
        loss.backward()
        allreduce_grads([params["router"]], router_group)
        allreduce_grads([params[k] for k in ("w_in", "b_in", "w_out", "b_out")], expert_group)
        opt.step()
        return params, opt, loss.detach()

    def init_opt(local_params):
        for leaf in tree_leaves(local_params):
            leaf.requires_grad_(True)
        return tx(local_params)

    return step, data_sharding, shardings, init_opt


def scoring_program(cfg: MoEConfig, params: Dict):
    """``map_blocks`` program: token-feature block ``[n, hidden]`` →
    ``{"moe_out": [n, hidden]}``, MoE inference through the same verb as
    every other model family (the weights read at every call)."""

    def program(features):
        return {"moe_out": moe_ffn(cfg, params, features)}

    return program
