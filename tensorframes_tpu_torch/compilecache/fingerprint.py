"""Stable content fingerprints: a program's dispatch key, and the
input-partition digests a registered query's result cache keys on.

The reference package's ``compilecache/fingerprint.py``. Nothing here
depends on Python ``hash()``, object ids or memory addresses, so a key
survives a process restart. :func:`program_fingerprint` covers what
makes one dispatch of a program differ from another:

* the program's **graph**: its aten ops as ``make_fx`` captures them
  under ``FakeTensorMode`` (:func:`~tensorframes_tpu_torch.program.capture_graph`),
  printed, with ``0x…`` addresses scrubbed;
* the **constants** the program captured: shape and dtype always, the
  values too for host tensors (``value_policy="host_only"``, the lint's
  policy: a tensor on the GPU is never read back for a key) or for
  every tensor (``"all"``);
* the **feed-shape bucket**: sorted (name, shape, dtype) of the probe
  inputs, and the fetch order;
* the **environment**: the device's kind and CUDA capability, the torch
  version, the content hash of the hand-written kernel library
  (:func:`tensorframes_tpu_torch.kernels.sources_hash`), the verified-lift
  state (:func:`tensorframes_tpu_torch.plan.lift.fingerprint_token`), the
  entry kind (block/vmap) and the format version.

A numpy_udf host stage (``_tftpu_has_callback``) has no fingerprint: its
captured graph is the ``empty`` outputs it returns under fake tensors,
the same for every UDF of those shapes, while what it computes is the
numpy function's. Such a dispatch is counted
(``note_unfingerprintable``) and never records or hits a key.

``TFG108`` (analysis/rules.py) calls :func:`program_fingerprint` twice
with independent captures; :func:`fingerprint_components` names the
component that moved. The content digests (:func:`part_signature`,
:func:`content_digest`, :func:`frame_content_digest`) name what a plan
computed over: a (plan fingerprint, content digest) pair stays a valid
result-cache key across restarts. The same files give the same digests
in both packages.
"""

from __future__ import annotations

import functools
import hashlib
import json
import os
import re
from typing import Dict, Iterable, Optional, Sequence, Tuple

import numpy as np

#: Bumped whenever an entry's layout or the key's composition changes:
#: old entries then simply miss.
FORMAT_VERSION = 2

__all__ = [
    "FORMAT_VERSION",
    "content_digest",
    "dispatch_fingerprint",
    "fingerprint_components",
    "fingerprint_from_graph",
    "frame_content_digest",
    "part_signature",
    "program_fingerprint",
]

_ADDR_RE = re.compile(r"0x[0-9a-fA-F]+")


def part_signature(path: str) -> str:
    """Signature of one on-disk part file: sha256 over (basename, size,
    mtime_ns). A stat proxy, deliberately not a content hash: a growing
    directory is fingerprinted in O(#files) stat calls, and any ordinary
    rewrite moves mtime_ns. A rewrite that keeps the size and forges the
    nanosecond mtime would serve stale."""
    st = os.stat(path)
    h = hashlib.sha256()
    h.update(os.path.basename(path).encode())
    h.update(b"|%d|%d" % (int(st.st_size), int(st.st_mtime_ns)))
    return h.hexdigest()[:24]


def content_digest(signatures: Iterable[str]) -> str:
    """Fold per-part signatures into one input-partition digest. Order
    matters: the manifest order is the row order."""
    h = hashlib.sha256(b"parts|")
    for sig in signatures:
        h.update(str(sig).encode())
        h.update(b"|")
    return h.hexdigest()[:32]


def frame_content_digest(frame) -> str:
    """Content digest of an in-memory frame (a registered query's static
    source): the schema and every block's bytes. Dense columns hash their
    buffer, host and object columns their repr."""
    h = hashlib.sha256(b"frame|")
    h.update(json.dumps(
        [(c.name, c.dtype.name) for c in frame.schema]
    ).encode())
    for block in frame.blocks():
        for name in sorted(block):
            v = block[name]
            h.update(name.encode() + b"|")
            if isinstance(v, list):
                h.update(repr(v).encode())
                continue
            arr = np.asarray(v)
            if arr.dtype == object:
                h.update(repr(arr.tolist()).encode())
            else:
                h.update(str((arr.shape, str(arr.dtype))).encode())
                h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()[:32]


# ---------------------------------------------------------------------------
# program fingerprints
# ---------------------------------------------------------------------------

def _scrub(text: str) -> str:
    """Drop process-local memory addresses from graph text (reprs of
    Python objects in an op's arguments embed them)."""
    return _ADDR_RE.sub("0x", text)


def _const_digest(h, const, value_policy: str) -> None:
    """Feed one captured constant into the running hash: shape and dtype
    always; the values when ``value_policy`` is ``"all"``, or when it is
    ``"host_only"`` and the tensor lies in host memory (the lint never
    moves a GPU tensor to the host)."""
    import torch

    if not torch.is_tensor(const):
        # not a tensor: its repr is the best identity there is; if that
        # embeds process-local state, TFG108 is the rule that says so
        h.update(_scrub(repr(const)).encode())
        return
    h.update(str((tuple(const.shape), str(const.dtype))).encode())
    if value_policy == "all" or const.device.type == "cpu":
        h.update(const.detach().cpu().contiguous().view(-1).view(torch.uint8)
                 .numpy().tobytes())


def _device_parts(device) -> Dict[str, object]:
    import torch

    device = torch.device(device if device is not None else "cpu")
    if device.type == "cuda":
        index = device.index if device.index is not None else torch.cuda.current_device()
        kind, capability = _cuda_parts(index)
        return {"device_kind": kind, "capability": list(capability)}
    return {"device_kind": device.type, "capability": None}


@functools.lru_cache(maxsize=None)
def _cuda_parts(index: int) -> Tuple[str, Tuple[int, int]]:
    import torch

    return torch.cuda.get_device_name(index), tuple(torch.cuda.get_device_capability(index))


def _env_parts(kind: str, device) -> Dict[str, object]:
    import torch

    from .. import kernels as _kernels
    from ..plan import lift as _lift

    return {
        "format": FORMAT_VERSION,
        **_device_parts(device),
        "torch": torch.__version__,
        # a change to any kernel source or its flags is another library:
        # a key recorded against the old one must miss
        "kernels": _kernels.sources_hash(),
        # verified-lift state: enabled flag + synthesis-rule version — a
        # lifted stage and its host stage are different programs, so a
        # TFTPU_LIFT flip must miss cleanly
        "lift": _lift.fingerprint_token(),
        "kind": kind,
    }


def _is_host_stage(program) -> bool:
    """A numpy_udf host stage: no graph stands for what it computes."""
    return bool(getattr(program, "_tftpu_has_callback", False))


def _sharding_parts(avals, shardings, mesh=None) -> Dict[str, object]:
    """Per-input layout descriptors keyed by input name
    (:func:`..parallel.mesh.sharding_descriptor`: the trivial placement
    normalizes to None and is left out), and the mesh's descriptor under
    ``"__mesh__"`` when one is given. Empty for an unsharded program, whose
    key then carries no ``shardings`` slot at all."""
    from ..parallel.mesh import mesh_descriptor, sharding_descriptor

    out: Dict[str, object] = {}
    if mesh is not None:
        out["__mesh__"] = mesh_descriptor(mesh)
    if not shardings:
        return out
    for (name, _, _) in avals:
        desc = sharding_descriptor(shardings.get(name))
        if desc is not None:
            out[str(name)] = desc
    return out


def _key_slots(
    captured,
    avals: Sequence[Tuple[str, Tuple[int, ...], str]],
    out_names: Sequence[str],
    *,
    kind: str,
    device,
    value_policy: str,
    extra: Optional[Dict[str, object]],
    shardings: Optional[Dict[str, object]] = None,
    mesh=None,
) -> Dict[str, bytes]:
    """Every slot of the key, serialized once: the composed hash
    (:func:`fingerprint_from_graph`) and the per-component digests
    (:func:`fingerprint_components`) both derive from this dict, so a
    slot added to one cannot miss the other. A sharded program's layout
    (``shardings``, ``mesh``) adds the ``shardings`` slot."""
    ch = hashlib.sha256(b"consts:%d|" % len(captured.consts))
    for _, c in captured.consts:
        _const_digest(ch, c, value_policy)
    slots = {
        "graph": _scrub(str(captured.gm.graph)).encode(),
        "consts": ch.digest(),
        "avals": json.dumps(
            [(n, list(s), d) for (n, s, d) in avals], sort_keys=True
        ).encode(),
        "outs": json.dumps(list(out_names)).encode(),
        "env": json.dumps(_env_parts(kind, device), sort_keys=True).encode(),
        "extra": json.dumps(extra or {}, sort_keys=True).encode(),
    }
    layout = _sharding_parts(avals, shardings, mesh)
    if layout:
        slots["shardings"] = json.dumps(layout, sort_keys=True).encode()
    return slots


def _compose(slots: Dict[str, bytes]) -> str:
    h = hashlib.sha256()
    for name in sorted(slots):
        h.update(name.encode() + b":")
        h.update(slots[name])
        h.update(b"|")
    return h.hexdigest()[:40]


def fingerprint_components(
    captured,
    avals: Iterable[Tuple[str, Tuple[int, ...], str]],
    out_names: Sequence[str],
    *,
    kind: str = "block",
    device=None,
    value_policy: str = "all",
    extra: Optional[Dict[str, object]] = None,
    shardings: Optional[Dict[str, object]] = None,
    mesh=None,
) -> Dict[str, object]:
    """The key's per-component digests: ``graph``, ``consts``, ``avals``,
    ``outs``, ``env``, ``extra`` (16 hex digits each), and for a sharded
    program ``shardings``: one digest per laid-out input (and
    ``__mesh__``), so TFG108 can name the input whose layout moved. Two
    captures of a stable program agree on every one; TFG108 names the
    ones that moved."""
    avals = list(avals)
    slots = _key_slots(captured, avals, out_names, kind=kind, device=device,
                       value_policy=value_policy, extra=extra,
                       shardings=shardings, mesh=mesh)
    out: Dict[str, object] = {name: hashlib.sha256(payload).hexdigest()[:16]
                              for name, payload in slots.items() if name != "shardings"}
    if "shardings" in slots:
        out["shardings"] = {
            name: hashlib.sha256(json.dumps(desc, sort_keys=True).encode()).hexdigest()[:16]
            for name, desc in _sharding_parts(avals, shardings, mesh).items()
        }
    return out


def fingerprint_from_graph(
    captured,
    avals: Iterable[Tuple[str, Tuple[int, ...], str]],
    out_names: Sequence[str],
    *,
    kind: str = "block",
    device=None,
    value_policy: str = "all",
    extra: Optional[Dict[str, object]] = None,
    shardings: Optional[Dict[str, object]] = None,
    mesh=None,
) -> str:
    """Fingerprint an already-captured program (the counterpart of the
    reference's ``fingerprint_from_closed``): ``captured`` is a
    :class:`~tensorframes_tpu_torch.program.CapturedGraph`, ``avals`` the
    sorted (name, shape, dtype-str) triples of the feed, ``out_names`` the
    fetch order, ``extra`` a JSON-able dict folded into the key,
    ``shardings`` (input name → layout) and ``mesh`` a sharded program's
    layout."""
    return _compose(_key_slots(captured, list(avals), out_names, kind=kind,
                               device=device, value_policy=value_policy, extra=extra,
                               shardings=shardings, mesh=mesh))


def program_fingerprint(
    program,
    probe: int = 8,
    *,
    kind: str = "block",
    value_policy: str = "host_only",
    mesh=None,
    shardings: Optional[Dict[str, object]] = None,
    components: bool = False,
):
    """Capture ``program`` afresh and fingerprint it. Each call
    re-captures, so two calls on one program probe rebuild stability
    (TFG108). The capture runs under ``FakeTensorMode``: no data moves
    and no kernel runs. ``components=True`` returns the per-component
    digests (:func:`fingerprint_components`) instead of the composed
    hash. None when the program cannot be captured, or is a numpy_udf
    host stage (see the module docstring). ``shardings`` (input name →
    :class:`~tensorframes_tpu_torch.parallel.mesh.NamedSharding` or device)
    and ``mesh`` key a sharded program's layout: their descriptors fold
    into the ``shardings`` slot, so two meshes of different size key
    differently. (The reference's mesh scopes its trace; a PyTorch capture
    needs no mesh, so here it enters the key.)"""
    from ..program import capture_graph

    if _is_host_stage(program):
        return None
    try:
        captured = capture_graph(program, probe)
    except Exception:
        return None
    avals = sorted(
        (name, tuple(int(d) for d in shape), str(dtype).replace("torch.", ""))
        for name, shape, dtype in captured.inputs
    )
    outs = list(program.fetch_order or [o.name for o in program.outputs])
    fn = fingerprint_components if components else fingerprint_from_graph
    return fn(captured, avals, outs, kind=kind, device=program.device,
              value_policy=value_policy, shardings=shardings, mesh=mesh)


def dispatch_fingerprint(
    program, kind: str, inputs, device
) -> Optional[Tuple[str, Dict[str, str], Dict[str, object]]]:
    """The store key of one dispatch: the program's captured graph,
    constants (``"host_only"``: weights on the GPU enter by shape and
    dtype), fetch order and environment on ``device``, with the feeds'
    sorted (name, shape, dtype) ``inputs`` in the ``avals`` slot. The
    program-level slots are captured once per (program, kind, device)
    and memoized on the Program. Returns ``(fingerprint, components,
    environment)``, the last the ``env`` slot's parts as a dict, or None
    when the program cannot be captured or is a numpy_udf host stage."""
    from ..config import get_config
    from ..program import capture_graph

    if _is_host_stage(program):
        return None
    memo = program.__dict__.setdefault("_dispatch_slots", {})
    mkey = (kind, str(device), bool(get_config().udf_lifting))
    if mkey not in memo:
        try:
            captured = capture_graph(program, 8)
        except Exception:
            memo[mkey] = None
        else:
            outs = list(program.fetch_order or [o.name for o in program.outputs])
            memo[mkey] = _key_slots(captured, [], outs, kind=kind, device=device,
                                    value_policy="host_only", extra=None)
    base = memo[mkey]
    if base is None:
        return None
    slots = dict(base, avals=json.dumps(
        [(n, list(s), d) for (n, s, d) in sorted(inputs)], sort_keys=True
    ).encode())
    comps = {name: hashlib.sha256(p).hexdigest()[:16] for name, p in slots.items()}
    return _compose(slots), comps, json.loads(base["env"])
