"""Multinomial logistic regression (MNIST-class scoring workload).

BASELINE config 3: "MNIST logistic-regression scoring: map_blocks over a
784-dim feature column". One dense layer + softmax: one 784×10 matrix
product per block (``torch.matmul``, outside any hand-written kernel, as
the reference leaves it to XLA); scoring plugs into ``map_blocks`` as a
plain function program.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..config import resolve_device


def init_params(
    num_features: int = 784,
    num_classes: int = 10,
    seed: int = 0,
    dtype=torch.float32,
    device=None,
) -> Dict[str, torch.Tensor]:
    """Random weights from ``seed`` on ``device`` (default
    ``config.device``), drawn from a ``torch.Generator``: the numbers
    differ from the reference's ``jax.random`` draw; carry the reference's
    weights across with :func:`params_from_jax` to score identically."""
    device = resolve_device(device)
    g = torch.Generator().manual_seed(seed)
    w = torch.randn((num_features, num_classes), generator=g, dtype=dtype) * 0.01
    b = torch.zeros((num_classes,), dtype=dtype)
    return {"w": w.to(device), "b": b.to(device)}


def params_from_jax(params: Dict[str, np.ndarray], device=None) -> Dict[str, torch.Tensor]:
    """The reference package's logreg parameters (as numpy arrays) as the
    port's: the layouts are the same (``w [features, classes]``,
    ``b [classes]``), so this is a checked copy onto ``device`` (default
    ``config.device``)."""
    if set(params) != {"w", "b"}:
        raise ValueError(f"logreg params need keys 'w' and 'b', got {sorted(params)}")
    w, b = np.asarray(params["w"]), np.asarray(params["b"])
    if w.ndim != 2 or b.shape != (w.shape[1],):
        raise ValueError(
            f"logreg params need w [features, classes] and b [classes]; "
            f"got w {w.shape}, b {b.shape}"
        )
    if w.dtype != b.dtype or w.dtype not in (np.float32, np.float64):
        raise ValueError(
            f"logreg params need matching float32/float64 dtypes; got "
            f"w {w.dtype}, b {b.dtype}"
        )
    device = resolve_device(device)
    return {"w": torch.tensor(w, device=device), "b": torch.tensor(b, device=device)}


def scoring_program(params: Dict[str, torch.Tensor]):
    """A map_blocks program: features block [n, d] → {"scores", "label"}.

    The weights are the device tensors in ``params``, read at every call
    (≙ frozen tf.Variables, core.py:42-56)."""

    def program(features):
        logits = features @ params["w"] + params["b"]
        probs = torch.softmax(logits, dim=-1)
        return {
            "scores": probs.to(features.dtype),
            "label": torch.argmax(logits, dim=-1).to(torch.int32),
        }

    return program


def loss_fn(params, features, labels) -> torch.Tensor:
    """Mean negative log-likelihood of ``labels`` under the softmax of
    ``features @ w + b``, as the reference: ``log_softmax``, the labels'
    entries gathered, their mean negated."""
    logits = features @ params["w"] + params["b"]
    logp = torch.log_softmax(logits, dim=-1)
    labels = torch.as_tensor(labels, device=logits.device).long()
    return -torch.gather(logp, -1, labels[:, None]).mean()


def train_step(params, opt_state, features, labels, tx: torch.optim.Optimizer):
    """One optimizer step on :func:`loss_fn`, the reference's signature:
    ``tx`` is an optimizer over ``params``' tensors (``torch.optim``, where
    the reference takes an optax transformation), so the step works in
    place and returns ``(params, opt_state, loss)`` with ``params`` and
    ``opt_state`` the objects passed in and ``loss`` the pre-update loss,
    detached."""
    tx.zero_grad(set_to_none=True)
    loss = loss_fn(params, features, labels)
    loss.backward()
    tx.step()
    return params, opt_state, loss.detach()


def make_synthetic_mnist(
    n: int = 10_000, num_features: int = 784, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, num_features), dtype=np.float32)
    y = rng.integers(0, 10, size=(n,), dtype=np.int64)
    return x, y
