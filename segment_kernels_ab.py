#!/usr/bin/env python3
"""Time the keyed segment-reduction kernels of several checkouts of this repo
on one CUDA card, each checkout in a process of its own, in the order given:

    python3 segment_kernels_ab.py DIR [DIR ...]

Each DIR is the root of a checkout: this repo's own root, or an earlier
commit unpacked with ``git archive`` into a git-ignored directory (e.g.
``build/``). Its ``tensorframes_tpu_torch`` builds its kernels under
``DIR/build/torch_kernels/`` and is timed with this repo's
``chip_smoke.time_ms`` (10 calls queued behind a spin kernel, between two
CUDA events) on the feeds of ``chip_smoke``: ``segment_reduce`` over the
main path's four columns (f32 sum and mean, f32 [n, 8] max, int32 sum) and
``segment_sum`` over the f32 [n, 8] column, at 10M rows over 4,096 groups
(``main``), the same with one key holding half of the rows (``skew``),
both kernels over the logreg scores [262,144, 10] by 10 labels
(``ten_groups``), and ``segment_reduce`` over 16 f32 [100,000, 64] columns,
max and sum in turn, with ``segment_sum`` over the first, by 256 groups
(``wide``): ``chip_smoke.segment_feeds``. Beside them, ``index_add_`` of
the same sum in the same process. Each time is taken REPS times in turn. To compare two commits,
give them as parent, change, change, parent. Prints one JSON line per DIR
with the lists of times, the launches of both kernels during the timing
and the ptxas registers and spills of the segment kernels from its build
log; then the card's name and power limit. Exits nonzero without a GPU.
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


def _calls(cs, dev) -> dict:
    """``{key: fn}`` for every timed call, the library's included."""
    import torch
    from tensorframes_tpu_torch.kernels import segment_reduce as ksr
    from tensorframes_tpu_torch.ops import segment as seg

    calls = {}
    for key, (ids, cols, ops, groups) in cs.segment_feeds(dev).items():
        w = cs.widest_f32(cols, ops)
        idx = ids.long()
        calls[f"{key}_segment_reduce_ms"] = (
            lambda ids=ids, cols=cols, ops=ops, groups=groups:
            ksr.segment_reduce(ops, groups, cols, ids))
        calls[f"{key}_segment_sum_ms"] = (
            lambda ids=ids, w=w, groups=groups: seg.segment_sum_kernel(w, ids, groups))
        calls[f"{key}_index_add_ms"] = (
            lambda idx=idx, w=w, groups=groups:
            torch.zeros((groups, w.shape[1]), device=dev).index_add_(0, idx, w))
    return calls


def one(root: Path) -> dict:
    import torch

    cs = _chip_smoke()
    sys.path.insert(0, str(root))
    import tensorframes_tpu_torch as tft

    if Path(tft.__file__).resolve().parent != (root / "tensorframes_tpu_torch").resolve():
        raise SystemExit(f"imported {tft.__file__}, not {root}'s package")
    dev = torch.device("cuda", 0)
    tft.kernels.library()
    calls = _calls(cs, dev)
    res = {"dir": str(root), **{key: [] for key in calls}}
    counts = tft.kernels.LAUNCHES
    counts.reset()
    for _ in range(REPS):
        for key, fn in calls.items():
            res[key].append(cs.time_ms(fn, f"{key} {root}"))
    res["launches"] = {k: n for k, n in counts.snapshot().items()
                       if k in ("segment_reduce", "segment_sum")}
    log = tft.kernels.BUILD_LOG
    text = log.read_text() if log.exists() else ""
    res["ptxas"] = {**cs.ptxas_report(text, "seg_"), **cs.ptxas_report(text, "segment")}
    return res


def main() -> int:
    if len(sys.argv) >= 3 and sys.argv[1] == "--one":
        print(json.dumps(one(Path(sys.argv[2]).resolve())), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available() or len(sys.argv) < 2:
        print("segment_kernels_ab: needs a CUDA device and at least one checkout directory",
              file=sys.stderr)
        return 2
    for d in sys.argv[1:]:
        rc = subprocess.run([sys.executable, __file__, "--one", d], timeout=900).returncode
        if rc != 0:
            print(f"segment_kernels_ab: {d} failed (rc {rc})", file=sys.stderr)
            return 1
    print(_chip_smoke().gpu_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
