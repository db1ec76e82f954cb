#!/usr/bin/env python3
"""Time the flash-attention forward and backward kernels of several
checkouts of this repo on one CUDA card, each checkout in a process of its
own, in the order given:

    python3 flash_forward_ab.py DIR [DIR ...]

Each DIR is the root of a checkout: this repo's own root, or an earlier
commit unpacked with ``git archive`` into a git-ignored directory (e.g.
``build/``). Its ``tensorframes_tpu_torch`` builds its kernels under
``DIR/build/torch_kernels/`` and is timed with this repo's
``chip_smoke.time_ms`` (10 calls queued behind a spin kernel, between two
CUDA events) on ``chip_smoke.flash_inputs``' seeded q/k/v views of one qkv
tensor, as the models pass them: at BERT-base's [1024, 12, 128, 64] bf16
(the encoder's call) and at the training path's [8, 12, 1024, 64] bf16
causal, each without the softmax statistics, and the latter also with l
and m where the checkout writes them; then the backward pair at the
training path's shape, dK/dV and dQ each on their own
(``chip_smoke.bwd_inputs``' seeded dO and the checkout's own forward's l
and m); each time is taken REPS times in turn. To compare two commits,
give them as parent, change, change, parent (or more rounds). Prints one
JSON line per DIR with the lists of times, the launches of each flash
kernel during the timing (and, where the checkout counts them, how many
ran on its tensor-core builds), and each forward and backward build's
ptxas registers and spills from its build log; then the card's name and
power limit. Exits nonzero without a GPU.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
SHAPES = {"bert": ((1024, 12, 128, 64), False), "train": ((8, 12, 1024, 64), True)}
REPS = 5


def _chip_smoke():
    """This repo's ``chip_smoke`` module, whatever DIR holds."""
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def one(root: Path) -> dict:
    import torch

    cs = _chip_smoke()
    sys.path.insert(0, str(root))
    import tensorframes_tpu_torch as tft
    from tensorframes_tpu_torch.kernels import flash_attention as kfa

    if Path(tft.__file__).resolve().parent != (root / "tensorframes_tpu_torch").resolve():
        raise SystemExit(f"imported {tft.__file__}, not {root}'s package")
    dev = torch.device("cuda", 0)
    tft.kernels.library()
    calls = {}
    for name, (shape, causal) in SHAPES.items():
        q, k, v = cs.flash_inputs(dev, shape, "bfloat16", True)
        calls[f"{name}_ms"] = (lambda q=q, k=k, v=v, c=causal:
                               kfa.flash_attention(q, k, v, causal=c))
        if name == "train" and hasattr(kfa, "flash_attention_fwd"):
            scale = kfa.default_scale(shape[-1])
            calls[f"{name}_stats_ms"] = (lambda q=q, k=k, v=v, c=causal, s=scale:
                                         kfa.flash_attention_fwd(q, k, v, c, s))
    if hasattr(kfa, "flash_attention_bwd_dkv"):
        shape, causal = SHAPES["train"]
        q, k, v, do = cs.bwd_inputs(dev, shape, "bfloat16", True)
        scale = kfa.default_scale(shape[-1])
        with torch.no_grad():
            o, l, m = kfa.flash_attention_fwd(q, k, v, causal, scale)
        args = (q, k, v, l, m, do, kfa.flash_attention_di(o, do), causal, scale)
        calls["train_bwd_dkv_ms"] = lambda a=args: kfa.flash_attention_bwd_dkv(*a)
        calls["train_bwd_dq_ms"] = lambda a=args: kfa.flash_attention_bwd_dq(*a)
    res = {"dir": str(root), **{key: [] for key in calls}}
    counts = tft.kernels.LAUNCHES
    counts.reset()
    with torch.no_grad():
        for _ in range(REPS):
            for key, fn in calls.items():
                res[key].append(cs.time_ms(fn, f"{key} {root}"))
    res["launches"] = {k: n for k, n in counts.snapshot().items() if k.startswith("flash")}
    res["launches"].update(counts.builds() if hasattr(counts, "builds") else {})
    log = tft.kernels.BUILD_LOG
    text = log.read_text() if log.exists() else ""
    res["ptxas"] = cs.ptxas_report(text)
    res["ptxas_bwd"] = cs.ptxas_report(text, "flash_attention_bwd")
    return res


def main() -> int:
    if len(sys.argv) >= 3 and sys.argv[1] == "--one":
        print(json.dumps(one(Path(sys.argv[2]).resolve())), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available() or len(sys.argv) < 2:
        print("flash_forward_ab: needs a CUDA device and at least one checkout directory",
              file=sys.stderr)
        return 2
    for d in sys.argv[1:]:
        rc = subprocess.run([sys.executable, __file__, "--one", d], timeout=900).returncode
        if rc != 0:
            print(f"flash_forward_ab: {d} failed (rc {rc})", file=sys.stderr)
            return 1
    print(_chip_smoke().gpu_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
