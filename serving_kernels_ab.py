#!/usr/bin/env python3
"""Time the decode server's two kernels of several checkouts of this repo on
one CUDA card, each checkout in a process of its own, in the order given:

    python3 serving_kernels_ab.py DIR [DIR ...]

Each DIR is the root of a checkout: this repo's own root, or an earlier
commit unpacked with ``git archive`` into a git-ignored directory (e.g.
``build/``). Its ``tensorframes_tpu_torch`` builds its kernels under
``DIR/build/torch_kernels/`` and is timed with this repo's
``chip_smoke.time_ms`` (10 calls queued behind a spin kernel, between two
CUDA events): ``int8_matmul`` as one gpt_small layer's four weight
products (``chip_smoke.GEMM_SHAPES``, seeded int8 weights and bf16 x) at
m = 1, 16 and 128 rows, and ``decode_attention`` at 16 slots over
``chip_smoke.paged_inputs``' 193-page pool, layer 5; each time is taken
REPS times in turn, beside the library calls ``chip_smoke`` names for
them (``torch.matmul`` on the widened bf16 weight; SDPA on pre-gathered
K/V). To compare two commits, give them as parent, change, change, parent
(or more rounds). Prints one JSON line per DIR with the lists of times,
the launches of each kernel during the timing (and, where the checkout
counts it, how many ran on the int8 tensor-core build), and the ptxas
registers and spills of both kernels from its build log; then the card's
name and power limit. Exits nonzero without a GPU.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROWS = (1, 16, 128)
REPS = 5


def _chip_smoke():
    """This repo's ``chip_smoke`` module, whatever DIR holds."""
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _calls(cs, dev) -> dict:
    """``{key: fn}`` for every timed call, the library's included."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from tensorframes_tpu_torch.kernels import decode_attention as kda
    from tensorframes_tpu_torch.ops import quantize as tq

    rng = np.random.default_rng(cs.SEED)
    shapes = cs.GEMM_SHAPES
    weights = {kn: tq.quantize(torch.from_numpy(
        (rng.standard_normal(kn) * kn[0] ** -0.5).astype(np.float32)).to(dev)) for kn in shapes}
    wide = {kn: w.dequantize(torch.bfloat16) for kn, w in weights.items()}
    calls = {}
    for m in ROWS:
        x = {kn: torch.from_numpy(rng.standard_normal((m, kn[0])).astype(np.float32)).to(
            dev, torch.bfloat16) for kn in shapes}
        calls[f"int8_m{m}_ms"] = lambda x=x: [tq.matmul_int8(x[kn], weights[kn]) for kn in shapes]
        calls[f"int8_m{m}_library_ms"] = lambda x=x: [x[kn] @ wide[kn] for kn in shapes]
    q, kp, vp, ks, vs, tables, pos = cs.paged_inputs(dev, 16)
    args = (q, kp, vp, ks, vs, 5, tables, pos)
    calls["decode_attention_ms"] = lambda: kda.paged_decode_attention(*args)
    S, nh, hd = q.shape
    C = kp.shape[3] * tables.shape[1]
    t = tables.long()
    kd = (kp[t, 5].float() * ks[t, 5]).permute(0, 2, 1, 3, 4).reshape(S, nh, C, hd)
    vd = (vp[t, 5].float() * vs[t, 5]).permute(0, 2, 1, 3, 4).reshape(S, nh, C, hd)
    kd, vd, qd = kd.to(torch.bfloat16), vd.to(torch.bfloat16), q[:, :, None, :]
    mask = (torch.arange(C, device=dev)[None, :] <= pos.long()[:, None])[:, None, None, :]
    calls["decode_attention_library_ms"] = (
        lambda: F.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask))
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
    with torch.no_grad():
        for _ in range(REPS):
            for key, fn in calls.items():
                res[key].append(cs.time_ms(fn, f"{key} {root}"))
    res["launches"] = {k: n for k, n in counts.snapshot().items()
                       if k in ("int8_matmul", "decode_attention")}
    res["launches"]["int8_matmul_mma"] = counts.builds().get("int8_matmul_mma", 0)
    log = tft.kernels.BUILD_LOG
    text = log.read_text() if log.exists() else ""
    res["ptxas"] = {**cs.ptxas_report(text, "int8_matmul"),
                    **cs.ptxas_report(text, "paged_decode_attention")}
    return res


def main() -> int:
    if len(sys.argv) >= 3 and sys.argv[1] == "--one":
        print(json.dumps(one(Path(sys.argv[2]).resolve())), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available() or len(sys.argv) < 2:
        print("serving_kernels_ab: needs a CUDA device and at least one checkout directory",
              file=sys.stderr)
        return 2
    for d in sys.argv[1:]:
        rc = subprocess.run([sys.executable, __file__, "--one", d], timeout=900).returncode
        if rc != 0:
            print(f"serving_kernels_ab: {d} failed (rc {rc})", file=sys.stderr)
            return 1
    print(_chip_smoke().gpu_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
