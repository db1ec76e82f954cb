"""Checkpoint / resume with verified integrity.

The reference package's ``checkpoint.py`` with its npz backend: numbered
steps under a root directory (``step_N``), ``latest_step``, ``save``,
``restore(like=...)``, and the same on-disk format — one ``arrays.npz``
of raw bytes (``a0``, ``a1``, … in JAX's flattening order) beside a
``manifest.json`` whose entries carry each leaf's ``key`` (the
``jax.tree_util.keystr`` of its path), ``dtype``, ``shape``, ``nbytes``
and ``crc32``. A dict/list/tuple tree written by either package restores
bit for bit in the other. The members are stored, not deflated: zlib
over a model's f32 weights costs tens of seconds and saves little
(PERF.md), and ``np.load`` reads both. Orbax, the JAX package's other
format, is not read here (``backend="orbax"`` raises).

A **train state** — a tree that holds a ``torch.optim.Optimizer`` beside
the tensors it updates, e.g. ``(params, opt)`` — is saved with the
optimizer's per-parameter state (moments and step counts, named
``…['state'][i]['exp_avg']``; see :mod:`.utils.tree`) and restored **in
place**: every tensor of ``like`` takes the saved values under
``no_grad`` and the optimizer loads its state through
``load_state_dict``, so it steps the tensors it holds with the restored
moments and step counts. A plain tree of tensors restores as new
tensors on the devices of ``like``'s leaves and leaves ``like`` as it
was.

Durability and integrity, as in the reference:

* ``save`` writes a temp directory, fsyncs every file and the directory,
  publishes it with ``os.replace`` (moving an existing same-step
  directory aside first), then fsyncs the root — a crash leaves the old
  step or the new one, never a torn one.
* ``restore`` verifies each array's CRC32 and byte size; with
  ``step=None`` a corrupt newest step is logged and skipped, falling back
  to the previous intact step (an explicit ``step=`` raises instead).
* ``verify()`` audits steps without materializing state; temp dirs of
  crashed saves are collected and crashed swaps healed at init.
* ``retry=`` (a :class:`~.resilience.RetryPolicy`) absorbs transient IO
  faults; the ``checkpoint.save`` / ``checkpoint.restore`` fault sites
  sit inside the retry scope.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import time
import uuid
import zlib
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .observability import events as _events
from .observability import flight as _flight
from .observability.metrics import counter as _counter
from .observability.metrics import histogram as _histogram
from .resilience.faults import fault_point
from .resilience.retry import RetryError, RetryPolicy, retry_call
from .utils import get_logger
from .utils.npz import decode_array, encode_array
from .utils.tree import flatten_with_keys, holds_optimizer, key_str, optimizer_state

logger = get_logger(__name__)

_SAVE_SECONDS = _histogram("tftpu_checkpoint_save_seconds", "Checkpointer.save wall-clock")
_RESTORE_SECONDS = _histogram(
    "tftpu_checkpoint_restore_seconds",
    "Checkpointer restore wall-clock (per step dir attempted)",
)
_SAVE_BYTES = _counter(
    "tftpu_checkpoint_save_bytes_total", "Bytes published to checkpoint step directories")
_RESTORE_BYTES = _counter(
    "tftpu_checkpoint_restore_bytes_total", "Raw array bytes read back from checkpoint payloads")
_CRC_FAILURES = _counter(
    "tftpu_checkpoint_crc_failures_total", "Steps whose CRC/size verification found corruption")

_STEP_RE = re.compile(r"^step_(\d+)$")
_TMP_RE = re.compile(r"^step_\d+\.tmp(\d+)")

# temp dirs with a save in flight in this process: lets the init-time GC
# tell "our live save on another thread" from "a corpse left by an
# earlier incarnation with the same pid"
_live_tmps: set = set()  # lint: guarded (set add/discard are GIL-atomic; a stale view only delays GC)


class CheckpointCorruptionError(RuntimeError):
    """A checkpoint step failed integrity verification (truncated payload,
    CRC mismatch, unreadable manifest, …)."""


def _step_dir(root: str, step: int) -> str:
    return os.path.join(root, f"step_{step}")


def _fsync_path(path: str) -> None:
    """fsync a file or directory, best-effort (directories are not
    fsync-able on every filesystem; durability degrades to the OS default
    there rather than failing the save)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:  # pragma: no cover - platform-dependent
        pass
    finally:
        os.close(fd)


def _fsync_tree(path: str) -> None:
    """fsync every file under ``path``, then the directories bottom-up."""
    for dirpath, _dirnames, filenames in os.walk(path, topdown=False):
        for name in filenames:
            _fsync_path(os.path.join(dirpath, name))
        _fsync_path(dirpath)


def _host_value(t: torch.Tensor):
    """A restored leaf whose template leaf is not a tensor: a numpy array,
    as the reference returns, unless numpy has no such dtype."""
    try:
        return t.numpy()
    except TypeError:
        return t


def _unflatten(like: Any, saved: Dict[str, torch.Tensor]) -> Any:
    """``saved`` (keystr → CPU tensor) in ``like``'s structure. With an
    optimizer in ``like``, every tensor leaf is filled in place and each
    optimizer loads its entries; otherwise tensor leaves come back as new
    tensors on their template's device. Everything is checked before
    anything is written."""
    flatten_with_keys(like)  # refuses what a checkpoint cannot name
    copies, loads = [], []

    in_place = holds_optimizer(like)

    def build(node, p):
        if node is None:
            return None
        if isinstance(node, torch.optim.Optimizer):
            loads.append((node, optimizer_state(saved, p)))
            return node
        if isinstance(node, dict):
            return {k: build(v, p + key_str(k)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            items = [build(v, p + key_str(i)) for i, v in enumerate(node)]
            return type(node)(*items) if hasattr(node, "_fields") else type(node)(items)
        if p not in saved:
            raise ValueError(f"template leaf {p!r} is not in the checkpoint")
        value = saved.pop(p)
        if not torch.is_tensor(node):
            return _host_value(value)
        if not in_place:
            return value.to(node.device)
        if node.shape != value.shape or node.dtype != value.dtype:
            raise ValueError(
                f"checkpoint leaf {p!r} is {value.dtype} {tuple(value.shape)}, the template's "
                f"{node.dtype} {tuple(node.shape)}")
        copies.append((node, value))
        return node

    out = build(like, "")
    if saved:
        raise ValueError(f"checkpoint has {len(saved)} leaves the template lacks: "
                         f"{sorted(saved)[:3]}")
    with torch.no_grad():
        for dst, src in copies:
            dst.copy_(src)
    for opt, state in loads:
        sd = opt.state_dict()
        sd["state"] = state
        opt.load_state_dict(sd)
    return out


class Checkpointer:
    """Numbered-step checkpoint store for parameter/optimizer trees.

    >>> ckpt = Checkpointer("/tmp/run1")
    >>> ckpt.save(100, (params, opt))
    >>> state = ckpt.restore(like=(params, opt))   # in place: params, opt
    """

    def __init__(self, root: str, backend: Optional[str] = None, keep: int = 0,
                 retry: Optional[RetryPolicy] = None):
        """``backend``: ``None`` or ``"npz"`` (``"orbax"`` is the JAX
        package's format and raises). ``keep``: retain only the newest N
        step dirs (0 = keep all). ``retry``: optional RetryPolicy around
        save/restore (non-retryable errors propagate untouched)."""
        if backend == "orbax":
            raise ValueError(
                "Checkpointer(backend='orbax'): orbax is the JAX package's checkpoint "
                "format; this package writes and reads the npz format (backend=None or 'npz')")
        if backend not in (None, "npz"):
            raise ValueError(f"unknown checkpoint backend {backend!r}")
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)
        self.keep = keep
        self.retry = retry
        self.backend = "npz"
        self._heal_crashed_swaps()
        self._gc_orphaned_tmps()

    # -- step bookkeeping ---------------------------------------------------

    def all_steps(self) -> List[int]:
        steps = []
        for name in os.listdir(self.root):
            m = _STEP_RE.match(name)
            if m:
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def latest_intact_step(self) -> Optional[int]:
        """Newest step whose audit does not fail — a prediction of where
        ``restore_latest`` will land, for monitoring and drills (the
        training loops call ``restore_latest`` itself)."""
        for s in reversed(self.all_steps()):
            if self.verify(s)[s]["ok"] is not False:
                return s
        return None

    def _gc(self) -> None:
        if self.keep <= 0:
            return
        for s in self.all_steps()[: -self.keep]:
            shutil.rmtree(_step_dir(self.root, s), ignore_errors=True)

    def _heal_crashed_swaps(self) -> None:
        """Recover ``step_N.old`` aside-dirs left by a save killed inside
        its publish window: if ``step_N`` never appeared, the aside copy
        IS the step — rename it back; otherwise it is superseded refuse."""
        for name in os.listdir(self.root):
            if not name.endswith(".old"):
                continue
            base = name[: -len(".old")]
            if not _STEP_RE.match(base):
                continue
            old = os.path.join(self.root, name)
            final = os.path.join(self.root, base)
            if os.path.isdir(final):
                shutil.rmtree(old, ignore_errors=True)
            else:
                try:
                    os.rename(old, final)
                except OSError:
                    # a sibling process on the same root healed first
                    if not os.path.isdir(final):
                        raise
                    shutil.rmtree(old, ignore_errors=True)
                    continue
                logger.warning("Checkpointer: healed %s from a crashed publish", base)

    def _gc_orphaned_tmps(self) -> None:
        """Remove ``step_*.tmp<pid>_*`` directories of saves that crashed
        before their rename. Only corpses whose writer is dead are
        collected (this process's own temps by the in-flight registry,
        since a restarted container reuses the pid)."""
        for name in os.listdir(self.root):
            m = _TMP_RE.match(name)
            if not m:
                continue
            full = os.path.join(self.root, name)
            pid = int(m.group(1))
            if full in _live_tmps:
                continue  # this process's save, in flight on another thread
            if pid != os.getpid():
                try:
                    os.kill(pid, 0)
                    continue  # writer still alive: not a corpse
                except ProcessLookupError:
                    pass
                except OSError:  # pragma: no cover - EPERM: can't tell
                    continue
            shutil.rmtree(full, ignore_errors=True)
            logger.warning("Checkpointer: removed orphaned temp %s (crashed save)", name)

    def _io(self, fn, describe: str):
        """Run a save/restore closure under the configured retry policy."""
        return retry_call(fn, policy=self.retry, describe=describe)

    # -- save / restore -----------------------------------------------------

    def save(self, step: int, state: Any) -> str:
        """Write ``state`` (a tree of tensors/arrays, optionally holding
        optimizers) as step ``step``. Atomic and durable: payloads are
        fsynced before the rename publishes the step dir."""
        final = _step_dir(self.root, step)

        def write() -> None:
            fault_point("checkpoint.save")
            # attempt-unique temp name: a watchdog-abandoned attempt may
            # still be writing when the retry starts
            tmp = final + f".tmp{os.getpid()}_{uuid.uuid4().hex[:8]}"
            shutil.rmtree(tmp, ignore_errors=True)
            _live_tmps.add(tmp)
            try:
                self._save_npz(tmp, state)
                _fsync_tree(tmp)
                # publish by rename-aside: an existing same-step dir moves
                # aside, the new one swaps in, only then is the old one
                # deleted, so no instant leaves the step unpublished
                old = final + ".old"
                if os.path.isdir(old) and not os.path.isdir(final):
                    os.rename(old, final)  # heal a previous crashed swap
                shutil.rmtree(old, ignore_errors=True)
                if os.path.isdir(final):
                    os.rename(final, old)
                os.replace(tmp, final)
                shutil.rmtree(old, ignore_errors=True)
                _fsync_path(self.root)
            finally:
                shutil.rmtree(tmp, ignore_errors=True)
                _live_tmps.discard(tmp)

        t0 = time.perf_counter()
        self._io(write, f"checkpoint.save(step={step})")
        dt = time.perf_counter() - t0
        _SAVE_SECONDS.observe(dt)
        try:
            nbytes = sum(os.path.getsize(os.path.join(dirpath, f))
                         for dirpath, _dirs, files in os.walk(final) for f in files)
            _SAVE_BYTES.inc(nbytes)
        except OSError:  # pragma: no cover - racing GC on the step dir
            nbytes = -1
        if _events.TRACER.enabled:
            _events.TRACER.emit_complete("checkpoint.save", t0, dt,
                                         args={"step": step, "bytes": nbytes}, cat="checkpoint")
        _flight.record("checkpoint.save", step=step, seconds=round(dt, 6), bytes=nbytes)
        self._gc()
        return final

    def restore(self, step: Optional[int] = None, like: Any = None, verify: bool = True) -> Any:
        """Read step ``step`` (default: the latest **intact** one) into
        ``like``'s structure (see the module docstring for train states);
        ``like=None`` returns a flat ``{keystr: CPU tensor}`` dict.

        With ``step=None`` a corrupt newest step is logged and skipped,
        falling back to the previous step that verifies; an explicit
        ``step=`` raises :class:`CheckpointCorruptionError` instead.
        ``verify=False`` skips the CRC check (structural errors still
        raise)."""
        if step is not None:
            return self._restore_step(step, like, verify)
        return self.restore_latest(like=like, verify=verify)[1]

    def restore_latest(self, like: Any = None, verify: bool = True) -> tuple:
        """Restore the newest intact step, falling back past corrupt ones.
        Returns ``(step, state)``: a loop that replays data needs the step
        that actually came back."""
        steps = self.all_steps()
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {self.root}")
        last_err: Optional[BaseException] = None
        for s in reversed(steps):
            try:
                return s, self._restore_step(s, like, verify)
            except CheckpointCorruptionError as e:
                logger.error("checkpoint step %d failed integrity verification (%s); "
                             "falling back to the previous step", s, e)
                last_err = e
        raise CheckpointCorruptionError(
            f"no intact checkpoint under {self.root} "
            f"({len(steps)} step(s) all failed verification)") from last_err

    def _restore_step(self, step: int, like: Any, verify: bool) -> Any:
        path = _step_dir(self.root, step)
        if not os.path.isdir(path):
            raise FileNotFoundError(f"no checkpoint at {path}")

        def read() -> Any:
            fault_point("checkpoint.restore")
            return self._restore_npz(path, like, verify)

        # observe in finally: the interesting restores (fallback sweeps,
        # retry exhaustion) are the ones that raise
        t0 = time.perf_counter()
        ok = False
        try:
            out = self._io(read, f"checkpoint.restore(step={step})")
            ok = True
            return out
        finally:
            dt = time.perf_counter() - t0
            _RESTORE_SECONDS.observe(dt)
            if _events.TRACER.enabled:
                _events.TRACER.emit_complete("checkpoint.restore", t0, dt,
                                             args={"step": step, "ok": ok}, cat="checkpoint")
            _flight.record("checkpoint.restore", step=step, seconds=round(dt, 6), ok=ok)

    # -- integrity audit ----------------------------------------------------

    def verify(self, step: Optional[int] = None) -> Dict[int, Dict[str, Any]]:
        """Audit checkpoint integrity without materializing state.

        Returns ``{step: {"format", "ok", "errors"}}`` for the given step
        (or every step). ``ok`` is True/False for npz steps, None for
        legacy npz steps predating the CRC manifest and for steps whose
        read failed transiently. A step without ``manifest.json`` (an
        orbax step of the JAX package) is not readable here: ``ok``
        False."""
        steps = [step] if step is not None else self.all_steps()
        report: Dict[int, Dict[str, Any]] = {}
        for s in steps:
            path = _step_dir(self.root, s)
            entry: Dict[str, Any] = {"format": None, "ok": None, "errors": []}
            if not os.path.isdir(path):
                entry["ok"] = False
                entry["errors"].append(f"missing step directory {path}")
            elif not os.path.exists(os.path.join(path, "manifest.json")):
                entry["ok"] = False
                entry["errors"].append(
                    f"no manifest.json in {path} (not an npz step; orbax steps are the JAX "
                    "package's format)")
            else:
                entry["format"] = "npz"
                try:
                    manifest, raws = self._io(lambda p=path: self._read_npz_payload(p),
                                              f"checkpoint.verify(step={s})")
                    if bool(manifest) and isinstance(manifest[0], str):
                        entry["errors"].append("legacy manifest (no CRC records)")
                    else:
                        errs = self._crc_errors(manifest, raws)
                        if errs:
                            _CRC_FAILURES.inc()
                        entry["errors"].extend(errs)
                        entry["ok"] = not errs
                except CheckpointCorruptionError as e:
                    entry["ok"] = False
                    entry["errors"].append(str(e))
                except (OSError, RetryError) as e:
                    # transient read failure: unknown, not corrupt — the
                    # audit returns its report, it never raises
                    entry["errors"].append(f"transient read error: {e}")
            report[s] = entry
        return report

    # -- npz backend --------------------------------------------------------

    def _save_npz(self, path: str, state: Any) -> None:
        # leaves are stored as raw bytes + (dtype, shape) in the manifest
        # (utils/npz.py), each entry with the byte size and CRC32 of its
        # payload so restore can prove it read what was written
        os.makedirs(path, exist_ok=True)
        arrays = {}
        manifest = []
        for i, (key, leaf) in enumerate(flatten_with_keys(state)):
            arrays[f"a{i}"], entry = encode_array(leaf)
            entry["key"] = key
            entry["nbytes"] = int(arrays[f"a{i}"].nbytes)
            entry["crc32"] = zlib.crc32(arrays[f"a{i}"])
            manifest.append(entry)
        np.savez(os.path.join(path, "arrays.npz"), **arrays)
        with open(os.path.join(path, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())

    def _read_npz_payload(self, path: str):
        """Read (manifest, {name: raw array}). Structural failures (a
        missing file, unparseable JSON or zip) become
        :class:`CheckpointCorruptionError`; transient OSErrors propagate
        so a retry policy can retry them."""
        if not os.path.exists(os.path.join(path, "manifest.json")):
            _CRC_FAILURES.inc()
            raise CheckpointCorruptionError(
                f"no manifest.json in {path} (not an npz step; orbax steps are the JAX "
                "package's format)")
        try:
            with open(os.path.join(path, "manifest.json")) as f:
                manifest = json.load(f)
        except json.JSONDecodeError as e:
            _CRC_FAILURES.inc()
            raise CheckpointCorruptionError(f"unreadable manifest.json in {path}: {e}") from e
        try:
            # materialize every array inside the context: a truncated
            # member surfaces here, not lazily after we returned
            with np.load(os.path.join(path, "arrays.npz")) as data:
                raws = {k: data[k] for k in data.files}
        except FileNotFoundError as e:
            _CRC_FAILURES.inc()
            raise CheckpointCorruptionError(f"missing arrays.npz in {path}: {e}") from e
        except OSError:
            raise  # transient IO: retryable, not corruption
        except Exception as e:
            _CRC_FAILURES.inc()
            raise CheckpointCorruptionError(f"unreadable arrays.npz in {path}: {e}") from e
        return manifest, raws

    @staticmethod
    def _crc_errors(manifest, raws) -> List[str]:
        """Per-array integrity errors for a CRC manifest (entries without
        ``crc32`` are skipped: old checkpoints stay restorable)."""
        errors = []
        for i, entry in enumerate(manifest):
            name = f"a{i}"
            if name not in raws:
                errors.append(f"array {name} ({entry.get('key')}) missing")
                continue
            raw = raws[name]
            if "nbytes" in entry and int(raw.nbytes) != int(entry["nbytes"]):
                errors.append(f"array {name} ({entry.get('key')}): size {raw.nbytes} != "
                              f"manifest {entry['nbytes']} (truncated?)")
                continue
            if "crc32" in entry and zlib.crc32(np.ascontiguousarray(raw)) != entry["crc32"]:
                errors.append(f"array {name} ({entry.get('key')}): CRC32 mismatch")
        return errors

    def _restore_npz(self, path: str, like: Any, verify: bool = True) -> Any:
        manifest, raws = self._read_npz_payload(path)
        _RESTORE_BYTES.inc(sum(int(r.nbytes) for r in raws.values()))
        legacy = bool(manifest) and isinstance(manifest[0], str)
        if not legacy and verify:
            errors = self._crc_errors(manifest, raws)
            if errors:
                _CRC_FAILURES.inc()
                raise CheckpointCorruptionError(f"{path}: " + "; ".join(errors))
        leaves = []
        for i, entry in enumerate(manifest):
            try:
                raw = raws[f"a{i}"]
            except KeyError:
                _CRC_FAILURES.inc()
                raise CheckpointCorruptionError(
                    f"{path}: array a{i} missing from arrays.npz") from None
            # pre-byte-format checkpoints stored arrays directly
            leaves.append(torch.from_numpy(raw) if legacy else decode_array(raw, entry))
        keys = manifest if legacy else [e["key"] for e in manifest]
        saved = dict(zip(keys, leaves))
        if like is None:
            return saved
        return _unflatten(like, saved)
