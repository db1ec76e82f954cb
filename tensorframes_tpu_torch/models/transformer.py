"""A compact transformer encoder/decoder stack, as plain dicts of tensors.

The reference package's flagship model (``models/transformer.py``),
unsharded: the config, parameter initialisation, the forward pass with
dense, blockwise or flash attention (the last through the hand-written
flash-attention kernels on the card, forward and backward), each layer
recomputed in the backward pass when ``cfg.remat`` is set, the
BERT-style embedding programs for ``map_blocks`` (:func:`embed_program`)
and ``map_rows`` (:func:`embed_row_program`, BASELINE config 5),
:func:`synthetic_batch`, weight-only int8 quantization,
:func:`params_from_jax`, which carries a reference parameter tree across
so both packages run the same weights, and training: the causal-LM
:func:`loss_fn`, :func:`make_train_step` and its optimizer
(:func:`adamw`, optax's ``adamw`` defaults). Parameters keep the
reference's names and layouts (``embed.tok [vocab, h]``,
``layers[i].attn.qkv [h, 3h]``, ...); activations run in ``cfg.dtype``
(bf16 by default) and the parameters stay f32 unless quantized.

Across ranks (a :class:`..parallel.mesh.Mesh` over ``torch.distributed``,
one device a rank): :func:`param_shardings` is the reference's
Megatron layout over ``tp`` (qkv and the MLP's input column-parallel,
their outputs row-parallel), :func:`shard_params` / :func:`gather_params`
cut a whole tree into this rank's shards and back, :func:`shard_batch`
splits tokens over ``dp`` × ``sp``, ``forward``/``loss_fn`` take
``mesh=`` (ring or Ulysses sequence parallelism, or the other impls on
the sequence gathered over ``sp``), and :func:`make_sharded_train_step`
trains the shards with the optimizer state split like them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..config import resolve_device
from ..ops.quantize import QuantizedTensor, matmul as _mm, quantize_tree, tree_leaves


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32_000
    hidden: int = 768
    num_heads: int = 12
    num_layers: int = 12
    mlp_ratio: int = 4
    max_seq_len: int = 512
    dtype: Any = torch.bfloat16  # activations/compute; params stay f32
    # attention implementation: 'dense' | 'blockwise' | 'flash' (the
    # hand-written kernel on the card) | 'ring' | 'ulysses' (sequence
    # parallelism over the mesh's 'sp' axis: a ring of k/v shards or an
    # all-to-all head exchange; see ops/attention.py)
    attention_impl: str = "dense"
    causal: bool = False
    # recompute each layer's activations in the backward pass (a
    # torch.utils.checkpoint per layer) instead of keeping them resident
    remat: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden // self.num_heads

    @property
    def mlp_hidden(self) -> int:
        return self.hidden * self.mlp_ratio


def bert_base(**kw) -> TransformerConfig:
    """BERT-base geometry (12L/768H/12 heads)."""
    return TransformerConfig(vocab_size=30_522, **kw)


def tiny(**kw) -> TransformerConfig:
    """A tiny config for tests and CPU dry-runs."""
    return TransformerConfig(
        vocab_size=128, hidden=32, num_heads=4, num_layers=2, max_seq_len=16, **kw
    )


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

def init_params(cfg: TransformerConfig, seed: int = 0, device=None) -> Dict:
    """The f32 parameter tree on ``device`` (default ``config.device``),
    drawn from a ``torch.Generator`` seeded with ``seed`` (the numbers
    differ from the reference's ``jax.random`` draw; carry the reference's
    weights across with :func:`params_from_jax`). Same scales as the
    reference: embeddings N(0, 0.02²), dense weights N(0, 1/fan_in), norms
    1/0, biases 0."""
    device = resolve_device(device)
    g = torch.Generator().manual_seed(int(seed))
    h, m = cfg.hidden, cfg.mlp_hidden

    def dense(shape, scale=None):
        scale = float(scale if scale is not None else 1.0 / np.sqrt(shape[0]))
        return (torch.randn(shape, generator=g, dtype=torch.float32) * scale).to(device)

    def ones(n):
        return torch.ones((n,), dtype=torch.float32, device=device)

    def zeros(n):
        return torch.zeros((n,), dtype=torch.float32, device=device)

    params = {
        "embed": {
            "tok": dense((cfg.vocab_size, h), 0.02),
            "pos": dense((cfg.max_seq_len, h), 0.02),
        },
        "final_ln": {"scale": ones(h), "bias": zeros(h)},
        "layers": [],
    }
    for _ in range(cfg.num_layers):
        params["layers"].append({
            "ln1": {"scale": ones(h), "bias": zeros(h)},
            "ln2": {"scale": ones(h), "bias": zeros(h)},
            "attn": {"qkv": dense((h, 3 * h)), "out": dense((h, h))},
            "mlp": {
                "in": dense((h, m)),
                "in_bias": zeros(m),
                "out": dense((m, h)),
                "out_bias": zeros(h),
            },
        })
    return params


def params_from_jax(tree, device=None):
    """A reference parameter tree, its arrays already converted to numpy
    (``jax.tree_util.tree_map(np.asarray, ...)`` with quantized leaves
    kept whole), as the port's: the same nesting of dicts and lists, each
    array a tensor on ``device`` (default ``config.device``), and each
    quantized leaf (any object with ``q`` and ``scale``) a
    :class:`QuantizedTensor` with its int8 values and f32 scales copied
    exactly."""
    return _from_numpy(tree, resolve_device(device))


def _from_numpy(tree, device):
    if isinstance(tree, dict):
        return {k: _from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_from_numpy(v, device) for v in tree)
    if hasattr(tree, "q") and hasattr(tree, "scale"):
        q, scale = np.asarray(tree.q), np.asarray(tree.scale)
        if q.dtype != np.int8 or scale.dtype != np.float32:
            raise ValueError(
                f"quantized leaf needs int8 q and float32 scale, got {q.dtype}/{scale.dtype}"
            )
        return QuantizedTensor(torch.tensor(q, device=device), torch.tensor(scale, device=device))
    arr = np.asarray(tree)
    if arr.dtype == np.float64:
        raise ValueError("float64 parameter: the model's parameters are float32")
    return torch.tensor(arr, device=device)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _layer_norm(x, scale, bias, eps=1e-6):
    """LayerNorm in f32 with the population variance and eps 1e-6, cast
    back to ``x.dtype``. ``F.layer_norm`` computes each row's moments on
    its own, so a row's result does not depend on the rows beside it
    (the decode engine's batched-equals-solo contract needs that; a
    ``mean``/``var`` reduction over a batch picks its thread split from
    the batch size on the card)."""
    y = F.layer_norm(x.float(), (x.shape[-1],), scale.float(), bias.float(), eps)
    return y.to(x.dtype)


def _group(mesh, axis: str):
    """The process group of ``mesh``'s ``axis`` (None without a mesh, without
    the axis, or when the axis is this rank alone)."""
    if mesh is None or axis not in mesh.shape:
        return None
    return mesh.group(axis)


def _attention(cfg: TransformerConfig, p, x, mask, mesh=None):
    from ..ops import attention as att
    from ..parallel.collectives import copy_to_group, gather_along, reduce_from_group

    b, s, _ = x.shape
    impl = cfg.attention_impl
    if mask is not None and impl != "dense":
        raise NotImplementedError(
            f"attention_impl={impl!r} does not support a padding mask yet; "
            "use attention_impl='dense' for padded batches"
        )
    if impl in ("ring", "ulysses"):
        if mesh is None or "sp" not in mesh.shape:
            raise ValueError(
                f"attention_impl={impl!r} requires a mesh with an 'sp' axis "
                "passed to forward(...); got "
                f"{None if mesh is None else dict(mesh.shape)}"
            )
    elif impl not in ("dense", "blockwise", "flash"):
        raise ValueError(f"Unknown attention_impl {impl!r}")
    tp = _group(mesh, "tp")
    heads = cfg.num_heads // (mesh.shape["tp"] if tp is not None else 1)
    x = copy_to_group(x, tp)
    qkv = _mm(x, p["qkv"]).reshape(b, s, 3, heads, cfg.head_dim)
    q, k, v = (qkv[:, :, i].permute(0, 2, 1, 3) for i in range(3))
    if impl == "ring":
        ctx = att.ring_attention(q, k, v, mesh, axis="sp", causal=cfg.causal)
    elif impl == "ulysses":
        ctx = att.ulysses_attention(q, k, v, mesh, axis="sp", causal=cfg.causal)
    else:
        sp = _group(mesh, "sp")
        if sp is not None:
            # the k/v all-gathers XLA inserts, here of q too: the impl
            # runs unchanged on the whole sequence, this rank keeps its rows
            q, k, v = gather_along(torch.stack([q, k, v]), sp, dim=3).unbind(0)
            if mask is not None:
                mask = gather_along(mask.to(torch.uint8), sp, dim=1).bool()
        if impl == "dense":
            ctx = att.dense_attention(q, k, v, causal=cfg.causal, padding_mask=mask)
        elif impl == "blockwise":
            ctx = att.blockwise_attention(q, k, v, causal=cfg.causal)
        else:
            ctx = att.flash_attention(q, k, v, causal=cfg.causal)
        if sp is not None:
            me = mesh.axis_index("sp")
            ctx = ctx[:, :, me * s:(me + 1) * s]
    ctx = ctx.permute(0, 2, 1, 3).reshape(b, s, heads * cfg.head_dim)
    return reduce_from_group(_mm(ctx, p["out"]), tp)


def _mlp(p, x, mm=_mm, tp=None):
    """The MLP block; ``mm`` is the weight product (the decode step's
    plain path passes the int8 kernel's plain version). ``tp``: the
    tensor-parallel group whose ranks each hold a column block of ``in``
    and a row block of ``out`` (Megatron's f first, g before the
    replicated ``out_bias``)."""
    from ..parallel.collectives import copy_to_group, reduce_from_group

    x = copy_to_group(x, tp)
    y = mm(x, p["in"]) + p["in_bias"].to(x.dtype)
    y = F.gelu(y, approximate="tanh")  # jax.nn.gelu's default
    return reduce_from_group(mm(y, p["out"]), tp) + p["out_bias"].to(x.dtype)


def layer_forward(cfg: TransformerConfig, p: Dict, x: torch.Tensor,
                  mask: Optional[torch.Tensor] = None, mesh=None) -> torch.Tensor:
    """One pre-norm layer (attention, then the MLP, each on the residual
    path) of :func:`forward`, on ``x [b, s, h]``: the stage a pipeline
    runs a few of (``parallel.pipeline_apply``)."""
    x = x + _attention(cfg, p["attn"], _layer_norm(x, **p["ln1"]), mask, mesh)
    return x + _mlp(p["mlp"], _layer_norm(x, **p["ln2"]), tp=_group(mesh, "tp"))


def forward(
    cfg: TransformerConfig,
    params: Dict,
    tokens: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    mesh=None,
) -> torch.Tensor:
    """Encoder forward: int tokens ``[b, s]`` → hidden states ``[b, s, h]``
    in ``cfg.dtype``. ``mask`` (bool ``[b, s]``) is the padding mask. With
    ``cfg.remat`` each layer runs under ``torch.utils.checkpoint``
    (non-reentrant), as the reference wraps it in ``jax.checkpoint``: its
    activations are recomputed in the backward pass, not kept.

    ``mesh``: run as one rank of a model-parallel mesh, on this rank's
    shards (:func:`shard_params`, :func:`shard_batch`): ``tokens`` are its
    block of the batch and sequence, positions start at its ``sp``
    offset, each layer runs ``num_heads/tp`` heads and its MLP column
    block between Megatron's f and g over ``tp``. ``attention_impl``
    ``"ring"``/``"ulysses"`` need the mesh's ``sp`` axis; the other impls
    run on q/k/v gathered over ``sp``."""
    tokens = torch.as_tensor(tokens, device=params["embed"]["tok"].device).long()
    x = params["embed"]["tok"][tokens].to(cfg.dtype)
    s = tokens.shape[1]
    off = mesh.axis_index("sp") * s if mesh is not None and "sp" in mesh.shape else 0
    x = x + params["embed"]["pos"][off:off + s].to(cfg.dtype)

    def layer(x, p):
        return layer_forward(cfg, p, x, mask, mesh)

    remat = cfg.remat and torch.is_grad_enabled()  # nothing to recompute without a graph
    for p in params["layers"]:
        x = checkpoint(layer, x, p, use_reentrant=False) if remat else layer(x, p)
    return _layer_norm(x, **params["final_ln"])


def embed_program(cfg: TransformerConfig, params: Dict):
    """``map_blocks`` program: token block ``[n, s]`` → ``{"embedding":
    [n, h]}``, the mean-pooled final hidden states in f32 (BERT-style
    sentence embeddings, BASELINE config 5)."""

    def program(tokens):
        hs = forward(cfg, params, tokens)
        return {"embedding": hs.mean(dim=1).float()}

    return program


def embed_row_program(cfg: TransformerConfig, params: Dict):
    """``map_rows`` program: one token cell ``[s]`` → ``{"embedding":
    [h]}``. ``map_rows`` vmaps it over the block, and the kernels' vmap
    rules fold the rows back into one batch, so the block still runs as
    one batched forward."""

    def program(tokens):
        hs = forward(cfg, params, tokens[None, :])
        return {"embedding": hs[0].mean(dim=0).float()}

    return program


def synthetic_batch(cfg: TransformerConfig, batch: int, seq: int, seed: int = 0):
    """``(tokens, targets)``, int32 ``[batch, seq]`` each, uniform over the
    vocabulary: the reference's numpy draw, so both packages get the same
    arrays."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (batch, seq), dtype=np.int32)
    targets = rng.integers(0, cfg.vocab_size, (batch, seq), dtype=np.int32)
    return tokens, targets


def quantize_params(params: Dict) -> Dict:
    """Weight-only int8 quantization of the layer weights (attn qkv/out,
    mlp in/out). Embeddings, norms and biases stay full precision: they
    are gathered or broadcast, not multiplied, so quantizing them saves
    little and costs accuracy."""
    return quantize_tree(params, predicate=lambda path, _: "embed" not in path)


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

def loss_fn(cfg: TransformerConfig, params: Dict, tokens, targets, mesh=None) -> torch.Tensor:
    """Causal-LM-style cross entropy against the token embedding matrix,
    as the reference: the hidden states widened to f32 times ``embed.tok``
    transposed, an f32 product (this function sets no ``torch.backends``
    flag: on the card it relies on PyTorch's default of no TF32 for f32
    matmuls), ``log_softmax``, the targets' entries gathered, their mean
    negated. Returns an f32 scalar.

    With ``mesh`` (one rank's shards, :func:`forward`) it is the global
    token mean: this rank's mean divided by the ranks of ``dp`` × ``sp``
    and summed over them (Megatron's g: each rank's gradient is that of
    its own term, and the train step sums them). With one data rank that
    is the local mean itself, bit for bit."""
    hs = forward(cfg, params, tokens, mesh=mesh)
    logits = hs.float() @ params["embed"]["tok"].T
    logp = F.log_softmax(logits, dim=-1)
    targets = torch.as_tensor(targets, device=logits.device).long()
    nll = -torch.gather(logp, -1, targets[..., None])
    if mesh is None:
        return nll.mean()
    from ..parallel.collectives import reduce_from_group

    axes = _data_axes(mesh)
    return reduce_from_group(nll.mean() / mesh.axis_size(axes), mesh.group(axes))


def adamw(params: Dict, learning_rate: float, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 1e-4) -> torch.optim.AdamW:
    """The counterpart of ``optax.adamw(learning_rate)`` with its defaults
    (decoupled weight decay 1e-4, bias-corrected moments): a
    ``torch.optim.AdamW`` over the tree's leaves, in the tree's order.
    Each leaf is made to require grad."""
    leaves = tree_leaves(params)
    for leaf in leaves:
        if not (torch.is_tensor(leaf) and leaf.is_floating_point()):
            raise ValueError(f"adamw: every leaf must be a float tensor; got {type(leaf)}")
        leaf.requires_grad_(True)
    return torch.optim.AdamW(leaves, lr=learning_rate, betas=(b1, b2), eps=eps,
                             weight_decay=weight_decay)


def make_train_step(cfg: TransformerConfig, opt: torch.optim.Optimizer):
    """Plain (unsharded) train step over ``opt``, an optimizer over the
    parameter tree's leaves (:func:`adamw`).

    ``step(params, opt_state, tokens, targets) -> (params, opt_state,
    loss)`` keeps the reference's signature, but works in place: the
    gradients of :func:`loss_fn` land in the leaves' ``.grad`` and
    ``opt.step()`` updates the leaves and the optimizer's state, so the
    returned ``params`` and ``opt_state`` are the objects passed in
    (``opt_state`` is ``opt.state``; pass it along unchanged). ``loss`` is
    the pre-update loss, a detached f32 scalar on the parameters' device."""

    def step(params, opt_state, tokens, targets):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(cfg, params, tokens, targets)
        loss.backward()
        opt.step()
        return params, opt_state, loss.detach()

    return step


# ---------------------------------------------------------------------------
# Across ranks: the Megatron layout, shards, and the sharded train step
# ---------------------------------------------------------------------------

def _data_axes(mesh, seq_axis: Optional[str] = "sp") -> tuple:
    """The mesh axes the batch and sequence split over (dp, then sp)."""
    return tuple(a for a in ("dp", seq_axis) if a and a in mesh.shape)


def param_shardings(cfg: TransformerConfig, mesh) -> Dict:
    """The reference's sharding tree: Megatron-style tensor parallelism
    over ``tp`` (degraded to replicated on a mesh without it). qkv and
    the MLP's ``in`` are column-parallel (``P(None, tp)``, ``in_bias``
    ``P(tp)``), ``attn.out`` and the MLP's ``out`` row-parallel
    (``P(tp, None)``), the rest replicated. Each leaf is a
    :class:`..parallel.mesh.NamedSharding`. The port splits qkv per head
    within each of q, k and v (:func:`shard_params`), where the spec's
    contiguous column split would hand rank 0 all of q."""
    from ..parallel.mesh import NamedSharding, PartitionSpec as P

    tp = "tp" if "tp" in mesh.shape else None

    def ns(*spec):
        return NamedSharding(mesh, P(*spec))

    layer = {
        "ln1": {"scale": ns(), "bias": ns()},
        "ln2": {"scale": ns(), "bias": ns()},
        "attn": {"qkv": ns(None, tp), "out": ns(tp, None)},
        "mlp": {
            "in": ns(None, tp),
            "in_bias": ns(tp),
            "out": ns(tp, None),
            "out_bias": ns(),
        },
    }
    return {
        "embed": {"tok": ns(), "pos": ns()},
        "final_ln": {"scale": ns(), "bias": ns()},
        "layers": [layer for _ in range(cfg.num_layers)],
    }


def _qkv_by_rank(qkv, tp: int, inverse: bool = False):
    """qkv's columns ``(3, heads, hd)`` reordered ``(tp, 3, heads/tp, hd)``
    so a contiguous split over ``tp`` gives each rank its heads of q, k
    and v (``inverse``: back)."""
    h = qkv.shape[0]
    if inverse:
        return qkv.reshape(h, tp, 3, -1).permute(0, 2, 1, 3).reshape(h, -1)
    return qkv.reshape(h, 3, tp, -1).permute(0, 2, 1, 3).reshape(h, -1)


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def shard_params(cfg: TransformerConfig, params: Dict, mesh, device=None) -> Dict:
    """This rank's shards of a whole parameter tree (tensors or numpy
    arrays, as :func:`params_from_jax` takes them) under
    :func:`param_shardings`, each a fresh tensor on ``device`` (default:
    this rank's), the counterpart of ``jax.device_put(params,
    shardings)``. qkv splits per head within each of q, k and v."""
    from ..ops.quantize import _tree_map
    from ..parallel.mesh import shard_tensor

    tp = mesh.shape.get("tp", 1)
    sh = param_shardings(cfg, mesh)

    def cut(path, leaf):
        if isinstance(leaf, QuantizedTensor):
            raise ValueError("shard_params: quantized leaves are not sharded")
        t = leaf if torch.is_tensor(leaf) else torch.tensor(np.asarray(leaf))
        if path[-1] == "qkv":
            t = _qkv_by_rank(t, tp)
        return shard_tensor(t, _at(sh, path), mesh, device=device,
                            what=".".join(map(str, path)))

    return _tree_map(cut, params)


def gather_params(cfg: TransformerConfig, local: Dict, mesh) -> Dict:
    """The whole parameter tree from every rank's shards (the inverse of
    :func:`shard_params`, bit for bit), on this rank's device. Collective:
    every rank calls it."""
    from ..ops.quantize import _tree_map
    from ..parallel.mesh import gather_tensor

    tp = mesh.shape.get("tp", 1)
    sh = param_shardings(cfg, mesh)

    def join(path, leaf):
        whole = gather_tensor(leaf.detach(), _at(sh, path), mesh)
        return _qkv_by_rank(whole, tp, inverse=True) if path[-1] == "qkv" else whole

    return _tree_map(join, local)


def shard_batch(mesh, tokens, targets, seq_axis: Optional[str] = "sp", device=None):
    """This rank's block of ``tokens`` and ``targets`` (``[b, s]`` each)
    under the train step's data sharding ``P("dp", seq_axis)``, on
    ``device`` (default: this rank's). A batch or sequence that does not
    divide raises."""
    from ..parallel.mesh import PartitionSpec as P, shard_tensor

    seq_axis = seq_axis if seq_axis in mesh.shape else None
    spec = P("dp" if "dp" in mesh.shape else None, seq_axis)
    return tuple(shard_tensor(a if torch.is_tensor(a) else np.asarray(a), spec, mesh,
                              device=device, what=name)
                 for name, a in (("tokens", tokens), ("targets", targets)))


def make_sharded_train_step(
    cfg: TransformerConfig,
    mesh,
    tx,
    seq_axis: Optional[str] = "sp",
    mixed_precision: bool = False,
):
    """The train step of one rank of ``mesh`` (dp / tp / sp), as the
    reference's: returns ``(step, data_sharding, shardings,
    init_opt_state)``.

    * ``data_sharding``: tokens and targets ``P("dp", seq_axis)`` (an axis
      the mesh lacks stays whole: a pure-dp mesh needs no ``sp``);
      :func:`shard_batch` cuts them.
    * ``shardings``: :func:`param_shardings`; :func:`shard_params` cuts a
      whole tree into this rank's shards.
    * ``tx``: an optimizer factory over a tree's leaves (e.g.
      ``functools.partial(adamw, learning_rate=1e-3)``) where the
      reference takes an optax transformation; ``init_opt_state(local)``
      builds it over this rank's shards, so its state is split like the
      parameters.
    * ``step(local_params, opt, tokens, targets) -> (local_params, opt,
      loss)`` takes this rank's shards and the optimizer, updates both in
      place, and returns the global loss (detached, the pre-update value,
      equal on every rank). Gradients are summed over ``dp`` × ``sp``; a
      replicated leaf's gradient is whole on every ``tp`` rank already
      (Megatron's f and g), so every rank applies the same update to it.

    ``mixed_precision=True`` casts ``layers`` and ``final_ln`` to
    ``cfg.dtype`` inside the differentiated function; ``embed`` stays f32
    (the f32 logits head), and the optimizer updates the f32 leaves.
    Every rank builds the step at the same point: the mesh's process
    groups are made here."""
    from ..parallel.collectives import allreduce_grads
    from ..parallel.mesh import NamedSharding, PartitionSpec as P

    if seq_axis is not None and seq_axis not in mesh.shape:
        seq_axis = None  # e.g. a pure-dp mesh: the sequence stays whole
    if seq_axis is None and "sp" in mesh.shape:
        raise ValueError("make_sharded_train_step: a mesh with 'sp' needs seq_axis='sp'")
    data_sharding = NamedSharding(mesh, P("dp" if "dp" in mesh.shape else None, seq_axis))
    shardings = param_shardings(cfg, mesh)
    grad_group = mesh.group(_data_axes(mesh, seq_axis))
    for axis in ("tp", "sp"):  # made now, in one order on every rank
        if axis in mesh.shape:
            mesh.group(axis)

    def run_loss(p, tokens, targets):
        if mixed_precision:
            from ..training import cast_float_leaves

            # embed stays f32: the large-vocab logits product stays f32
            p = {**p, "layers": cast_float_leaves(p["layers"], cfg.dtype),
                 "final_ln": cast_float_leaves(p["final_ln"], cfg.dtype)}
        return loss_fn(cfg, p, tokens, targets, mesh=mesh)

    def step(params, opt, tokens, targets):
        opt.zero_grad(set_to_none=True)
        loss = run_loss(params, tokens, targets)
        loss.backward()
        allreduce_grads(tree_leaves(params), grad_group)
        opt.step()
        return params, opt, loss.detach()

    def init_opt_state(local_params):
        for leaf in tree_leaves(local_params):
            leaf.requires_grad_(True)
        return tx(local_params)

    return step, data_sharding, shardings, init_opt_state
