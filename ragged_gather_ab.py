#!/usr/bin/env python3
"""Time the ragged row gather of several checkouts of this repo on one CUDA
card, each checkout in a process of its own, in the order given:

    python3 ragged_gather_ab.py DIR [DIR ...]

Each DIR is the root of a checkout: this repo's own root, or an earlier
commit unpacked with ``git archive`` into a git-ignored directory (e.g.
``build/``). Its ``tensorframes_tpu_torch`` builds its kernels under
``DIR/build/torch_kernels/`` and is timed with this repo's
``chip_smoke.time_ms`` (10 calls queued behind a spin kernel, between two
CUDA events) on the feeds of ``chip_smoke.ragged_feeds``: the main path's
200,000 f32 rows in 4 length groups (``main``) and 200,000 rows of lengths
1-256 in 256 groups, in f32 and in bf16 (``wide_f32``, ``wide_bf16``),
and 60,000 f32 rows of 1-4 KB (``long_f32``). A checkout with the grouped
API is timed over each call's launches with their tables uploaded
beforehand (``grouped_ms``, device time) and as one ``ragged_gather_groups``
call that uploads them (``call_host_ms``, host wall to the card's end); an
older checkout, which has only ``ragged_gather_rows``, one launch per group
over the groups' starts on the card (``per_group_ms``, its launches
captured into a CUDA graph and replayed, ``chip_smoke.graphed``, so that
ten calls of 256 launches queue behind the spin). Each time is taken REPS times in turn; to compare
two commits, give them as parent, change, change, parent. Prints one JSON
line per DIR with the lists of times and the gather's launches per call;
then the card's name and power limit. Exits nonzero without a GPU.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
REPS = 5


def _chip_smoke():
    """This repo's ``chip_smoke`` module, whatever DIR holds."""
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _import_package(root: Path):
    sys.path.insert(0, str(root))
    import tensorframes_tpu_torch as tft

    if Path(tft.__file__).resolve().parent != (root / "tensorframes_tpu_torch").resolve():
        raise SystemExit(f"imported {tft.__file__}, not {root}'s package")
    return tft


def one(root: Path) -> dict:
    import torch

    cs = _chip_smoke()
    tft = _import_package(root)
    from tensorframes_tpu_torch.kernels import ragged_gather as krg

    dev = torch.device("cuda", 0)
    tft.kernels.library()
    grouped = hasattr(krg, "ragged_gather_groups")
    counts = tft.kernels.LAUNCHES
    calls, per_call, host = {}, {}, {}
    for name, (flat, groups) in cs.ragged_feeds(dev).items():
        if grouped:
            launches = krg.plan_launches(flat, groups)
            calls[f"{name}_grouped_ms"] = (
                lambda flat=flat, ls=launches: [krg.gather_launch(flat, launch) for launch in ls])
            host[f"{name}_call_host_ms"] = (
                lambda flat=flat, g=groups: krg.ragged_gather_groups(flat, g))
        else:
            dev_groups = [(torch.from_numpy(st).to(dev), L) for st, L in groups]
            calls[f"{name}_per_group_ms"] = (
                lambda flat=flat, g=dev_groups: [krg.ragged_gather_rows(flat, st, L) for st, L in g])
    for key, fn in {**calls, **host}.items():
        counts.reset()
        fn()
        torch.cuda.synchronize()
        per_call[key.replace("_host_ms", "").replace("_ms", "")] = counts.snapshot()["ragged_gather"]
    # a call of one launch per group (256 on the wide feeds) is replayed from
    # a CUDA graph, so that ten of them queue behind the spin
    calls = {key: cs.graphed(fn) if key.endswith("_per_group_ms") else fn
             for key, fn in calls.items()}
    res = {"dir": str(root), **{key: [] for key in (*calls, *host)}}
    for _ in range(REPS):
        for key, fn in calls.items():
            res[key].append(cs.time_ms(fn, f"{key} {root}"))
        for key, fn in host.items():
            res[key].append(cs.host_ms(fn))
    res["launches_per_call"] = per_call
    log = tft.kernels.BUILD_LOG
    text = log.read_text() if log.exists() else ""
    res["ptxas"] = cs.ptxas_report(text, "ragged_gather")
    return res


def main() -> int:
    if len(sys.argv) >= 3 and sys.argv[1] == "--one":
        print(json.dumps(one(Path(sys.argv[2]).resolve())), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available() or len(sys.argv) < 2:
        print("ragged_gather_ab: needs a CUDA device and at least one checkout directory",
              file=sys.stderr)
        return 2
    for d in sys.argv[1:]:
        rc = subprocess.run([sys.executable, __file__, "--one", d], timeout=900).returncode
        if rc != 0:
            print(f"ragged_gather_ab: {d} failed (rc {rc})", file=sys.stderr)
            return 1
    print(_chip_smoke().gpu_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
