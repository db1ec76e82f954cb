"""Train-state trees: nested dicts, lists and tuples whose leaves are
tensors, numpy arrays or Python scalars, and which may hold a
``torch.optim.Optimizer``.

The reference package's states are JAX pytrees of immutable arrays, so
keeping a reference keeps a snapshot. The port's train step updates its
tensors in place (``opt.step()`` writes the parameters and ``opt.state``),
so every place the reference kept a reference — the guard's skip and
rollback, ``run_resumable``'s emergency checkpoint, the checkpoint's
save and restore of a train state — goes through this module:

* :func:`flatten_with_keys` — the leaves in JAX's order (dict keys
  sorted) named by their ``jax.tree_util.keystr``, so a dict/list/tuple
  tree gets the names the reference package gives it. An optimizer is
  the node ``{"state": {i: {"exp_avg": ..., "exp_avg_sq": ...,
  "step": ...}}}`` of its ``state_dict()`` (``i``: the parameter's index
  in its param groups); its hyperparameters are code, as an optax
  transform's are, and are not stored.
* :func:`snapshot` / :func:`assign` — a copy of a state on its devices,
  and that copy written back into the live tensors and the optimizer's
  own ``state`` dict in place, so the optimizer steps the tensors it
  holds, with the moments and step counts of the snapshot.
* :func:`leaves` — every leaf, an optimizer's state tensors included
  (the guard's finiteness check reads it, :func:`versions` too).
* :func:`holds_optimizer` / :func:`optimizer_state` — whether a tree
  carries an optimizer, and a checkpoint's flat entries of one
  optimizer node back in ``state_dict()["state"]``'s layout (the
  checkpoint's in-place restore).
* :func:`versions` — the tensors' in-place version counters, which say
  whether a step that raised had already written the state.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

__all__ = ["flatten_with_keys", "snapshot", "assign", "leaves", "holds_optimizer",
           "optimizer_state", "versions", "key_str"]

# one optimizer entry below its node's ``['state']``: ``[i]['exp_avg']``
_OPT_ENTRY_RE = re.compile(r"^\[(\d+)\]\['([^']+)'\]$")


def key_str(key) -> str:
    """One path entry as ``jax.tree_util.keystr`` writes it: ``['a']`` for
    a dict key, ``[0]`` for a sequence index (or an int dict key)."""
    return f"[{key!r}]"


def _sorted_items(d: dict):
    try:
        return sorted(d.items(), key=lambda kv: kv[0])
    except TypeError:  # keys that do not compare: JAX would refuse too
        return list(d.items())


def _optimizer_node(opt: torch.optim.Optimizer) -> dict:
    """An optimizer as a checkpoint names it: its per-parameter state,
    keyed by the parameter's index in its param groups."""
    return {"state": opt.state_dict()["state"]}


def flatten_with_keys(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """``[(keystr, leaf), ...]`` in JAX's flattening order. ``None`` is an
    empty subtree, as in JAX. A dict keyed by tensors (``opt.state``)
    raises: its entries have no names; put the optimizer itself in the
    state."""
    out: List[Tuple[str, Any]] = []

    def walk(node, path):
        if node is None:
            return
        if isinstance(node, torch.optim.Optimizer):
            walk(_optimizer_node(node), path)
        elif isinstance(node, dict):
            if any(torch.is_tensor(k) for k in node):
                raise TypeError(
                    f"state entry {path or 'root'} is a dict keyed by tensors (an "
                    "optimizer's .state?): put the torch.optim.Optimizer itself in the "
                    "state, so its entries are named by parameter index")
            for k, v in _sorted_items(node):
                walk(v, path + key_str(k))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + key_str(i))
        else:
            out.append((path, node))

    walk(tree, prefix)
    return out


class _OptimizerCopy:
    """A snapshot of an optimizer: the optimizer, and a copy of its
    ``state`` dict (keyed by the same parameter tensors)."""

    __slots__ = ("opt", "state")

    def __init__(self, opt: torch.optim.Optimizer, state: dict):
        self.opt = opt
        self.state = state


def _same_slot(dst, src) -> bool:
    return (torch.is_tensor(dst) and dst is not src and dst.shape == src.shape
            and dst.dtype == src.dtype and dst.device == src.device)


def _rebuild(seq, items):
    return type(seq)(*items) if hasattr(seq, "_fields") else type(seq)(items)


def _copy(dst, src, pairs: list):
    """``src``'s values in ``dst``'s objects where they fit (each tensor
    pair queued on ``pairs`` for one ``_foreach_copy_``, each dict
    mutated to hold ``src``'s keys), fresh copies where they do not."""
    if isinstance(src, torch.optim.Optimizer):  # taking a snapshot
        held = dst.state if isinstance(dst, _OptimizerCopy) and dst.opt is src else None
        return _OptimizerCopy(src, _copy(held, src.state, pairs))
    if isinstance(src, _OptimizerCopy):  # writing one back: into opt.state itself
        opt = dst if isinstance(dst, torch.optim.Optimizer) else src.opt
        _copy(opt.state, src.state, pairs)
        return opt
    if torch.is_tensor(src):
        if _same_slot(dst, src):
            pairs.append((dst, src))
            return dst
        return src.detach().clone()
    if isinstance(src, dict):
        if not isinstance(dst, dict):
            return {k: _copy(None, v, pairs) for k, v in src.items()}
        for k in [k for k in dst if k not in src]:
            del dst[k]
        for k, v in src.items():
            dst[k] = _copy(dst.get(k), v, pairs)
        return dst
    if isinstance(src, (list, tuple)):
        if isinstance(dst, (list, tuple)) and len(dst) == len(src):
            return _rebuild(src, [_copy(d, s, pairs) for d, s in zip(dst, src)])
        return _rebuild(src, [_copy(None, s, pairs) for s in src])
    if isinstance(src, np.ndarray):
        return src.copy()
    return src


def _run(pairs: list) -> None:
    """The queued copies, one ``_foreach_copy_`` per (device, dtype)."""
    groups: dict = {}
    for d, s in pairs:
        groups.setdefault((d.device, d.dtype), []).append((d, s))
    with torch.no_grad():
        for group in groups.values():
            torch._foreach_copy_([d for d, _ in group], [s for _, s in group])


def snapshot(state: Any, into: Any = None) -> Any:
    """A copy of ``state`` on its devices: every tensor (an optimizer's
    moments and step counts too) copied, numpy arrays copied, the rest
    kept. ``into``, an earlier snapshot of the same state, is refilled in
    place where the shapes still fit (no allocation)."""
    pairs: list = []
    out = _copy(into, state, pairs)
    _run(pairs)
    return out


def assign(live: Any, snap: Any) -> Any:
    """Write ``snap`` (from :func:`snapshot`) back into ``live`` in place:
    each tensor of ``live`` takes its snapshot's values, and each
    optimizer's ``state`` dict its snapshot's entries (an entry the
    snapshot lacks is dropped, so a step taken from an empty state starts
    again from empty). Returns ``live``'s structure; a leaf with no live
    tensor to take the values (a Python scalar, a changed shape) comes
    back as a copy of the snapshot's."""
    pairs: list = []
    out = _copy(live, snap, pairs)
    _run(pairs)
    return out


def leaves(tree: Any) -> List[Any]:
    """Every leaf of ``tree`` in its own order, an optimizer's state
    tensors (moments, step counts) included; ``None`` is an empty
    subtree."""
    out: List[Any] = []

    def walk(node):
        if isinstance(node, torch.optim.Optimizer):
            walk(node.state)
        elif isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)
        elif node is not None:
            out.append(node)

    walk(tree)
    return out


def holds_optimizer(tree: Any) -> bool:
    """Whether ``tree`` carries a ``torch.optim.Optimizer`` (a train state,
    restored in place)."""
    if isinstance(tree, torch.optim.Optimizer):
        return True
    if isinstance(tree, dict):
        return any(holds_optimizer(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(holds_optimizer(v) for v in tree)
    return False


def optimizer_state(saved: Dict[str, Any], path: str) -> Dict[int, Dict[str, Any]]:
    """Pop from ``saved`` (keystr → value) the entries of the optimizer
    node at ``path`` (as :func:`flatten_with_keys` named them) and return
    them as ``state_dict()["state"]``: ``{i: {"exp_avg": ..., ...}}``."""
    prefix = path + key_str("state")
    state: Dict[int, Dict[str, Any]] = {}
    for k in [k for k in saved if k.startswith(prefix)]:
        m = _OPT_ENTRY_RE.match(k[len(prefix):])
        if m is None:
            raise ValueError(f"checkpoint leaf {k!r} is no optimizer state entry")
        state.setdefault(int(m.group(1)), {})[m.group(2)] = saved.pop(k)
    return state


def versions(tree: Any) -> List[int]:
    """The identity and in-place version counter of every tensor in
    ``tree`` (an optimizer's state included). Two calls compare equal
    exactly when no tensor of the state was written, added or dropped in
    between."""
    out: List[int] = []
    for leaf in leaves(tree):
        if torch.is_tensor(leaf):
            out.append(id(leaf))
            try:
                out.append(leaf._version)
            except RuntimeError:  # an inference tensor keeps no counter
                out.append(-1)
    return out
