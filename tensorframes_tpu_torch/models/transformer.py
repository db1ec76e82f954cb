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

The sharded train step and sequence-parallel attention wait for the
multi-device work (ROADMAP queue 1).
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
    # hand-written kernel on the card); the reference's 'ring' | 'ulysses'
    # (sequence parallelism) wait for the multi-device work
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


def _attention(cfg: TransformerConfig, p, x, mask):
    from ..ops import attention as att

    b, s, h = x.shape
    impl = cfg.attention_impl
    if mask is not None and impl != "dense":
        raise NotImplementedError(
            f"attention_impl={impl!r} does not support a padding mask yet; "
            "use attention_impl='dense' for padded batches"
        )
    if impl in ("ring", "ulysses"):
        raise NotImplementedError(
            f"attention_impl={impl!r} is not ported yet: sequence parallelism comes "
            "with the multi-device work (ROADMAP queue 1 item 9)"
        )
    if impl not in ("dense", "blockwise", "flash"):
        raise ValueError(f"Unknown attention_impl {impl!r}")
    qkv = _mm(x, p["qkv"]).reshape(b, s, 3, cfg.num_heads, cfg.head_dim)
    q, k, v = (qkv[:, :, i].permute(0, 2, 1, 3) for i in range(3))
    if impl == "dense":
        ctx = att.dense_attention(q, k, v, causal=cfg.causal, padding_mask=mask)
    elif impl == "blockwise":
        ctx = att.blockwise_attention(q, k, v, causal=cfg.causal)
    else:
        ctx = att.flash_attention(q, k, v, causal=cfg.causal)
    ctx = ctx.permute(0, 2, 1, 3).reshape(b, s, h)
    return _mm(ctx, p["out"])


def _mlp(p, x, mm=_mm):
    """The MLP block; ``mm`` is the weight product (the decode step's
    plain path passes the int8 kernel's plain version)."""
    y = mm(x, p["in"]) + p["in_bias"].to(x.dtype)
    y = F.gelu(y, approximate="tanh")  # jax.nn.gelu's default
    return mm(y, p["out"]) + p["out_bias"].to(x.dtype)


def forward(
    cfg: TransformerConfig,
    params: Dict,
    tokens: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Encoder forward: int tokens ``[b, s]`` → hidden states ``[b, s, h]``
    in ``cfg.dtype``. ``mask`` (bool ``[b, s]``) is the padding mask. With
    ``cfg.remat`` each layer runs under ``torch.utils.checkpoint``
    (non-reentrant), as the reference wraps it in ``jax.checkpoint``: its
    activations are recomputed in the backward pass, not kept."""
    tokens = torch.as_tensor(tokens, device=params["embed"]["tok"].device).long()
    x = params["embed"]["tok"][tokens].to(cfg.dtype)
    s = tokens.shape[1]
    x = x + params["embed"]["pos"][:s].to(cfg.dtype)

    def layer(x, p):
        x = x + _attention(cfg, p["attn"], _layer_norm(x, **p["ln1"]), mask)
        return x + _mlp(p["mlp"], _layer_norm(x, **p["ln2"]))

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

def loss_fn(cfg: TransformerConfig, params: Dict, tokens, targets) -> torch.Tensor:
    """Causal-LM-style cross entropy against the token embedding matrix,
    as the reference: the hidden states widened to f32 times ``embed.tok``
    transposed, an f32 product (this function sets no ``torch.backends``
    flag: on the card it relies on PyTorch's default of no TF32 for f32
    matmuls), ``log_softmax``, the targets' entries gathered, their mean
    negated. Returns an f32 scalar."""
    hs = forward(cfg, params, tokens)
    logits = hs.float() @ params["embed"]["tok"].T
    logp = F.log_softmax(logits, dim=-1)
    targets = torch.as_tensor(targets, device=logits.device).long()
    nll = -torch.gather(logp, -1, targets[..., None])
    return nll.mean()


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
