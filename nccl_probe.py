#!/usr/bin/env python3
"""Which collectives run between ranks sharing one GPU?

    python3 nccl_probe.py

Runs three worlds of child processes, each rank on ``cuda:0``: two ranks
under NCCL, one rank under NCCL, two ranks under gloo. Every rank tries
``all_reduce``, ``all_gather_into_tensor``, ``all_gather``,
``all_to_all_single`` and ``broadcast`` on CUDA tensors and prints what
each returned or the error it raised (NCCL refuses two ranks on one
device: "Duplicate GPU detected"). Prints the Python, torch and CUDA
versions and the card's name and power limit first. Each phase has a
time limit; the script needs one CUDA GPU and no network.
"""

import json
import socket
import subprocess
import sys
import time

CHILD = r'''
import datetime, json, sys
import torch, torch.distributed as dist
rank, world, port, backend = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
torch.cuda.set_device(0)
out = {"rank": rank, "backend": backend}
try:
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}", world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=40))
    dev = torch.device("cuda", 0)
    for name in ("all_reduce", "all_gather_into_tensor", "all_gather", "all_to_all_single",
                 "broadcast"):
        try:
            t = torch.arange(4, dtype=torch.float32, device=dev) + rank
            if name == "all_reduce":
                dist.all_reduce(t)
                r = t.tolist()
            elif name == "all_gather_into_tensor":
                o = torch.empty(4 * world, device=dev)
                dist.all_gather_into_tensor(o, t)
                r = o.tolist()
            elif name == "all_gather":
                o = [torch.empty(4, device=dev) for _ in range(world)]
                dist.all_gather(o, t)
                r = [x.tolist() for x in o]
            elif name == "all_to_all_single":
                i = torch.arange(2 * world, dtype=torch.uint8, device=dev) + 10 * rank
                o = torch.empty_like(i)
                dist.all_to_all_single(o, i)
                r = o.tolist()
            else:
                dist.broadcast(t, 0)
                r = t.tolist()
            torch.cuda.synchronize()
            out[name] = r
        except Exception as e:
            out[name] = f"ERR {type(e).__name__}: {str(e)[:300]}"
    dist.destroy_process_group()
except Exception as e:
    out["init"] = f"ERR {type(e).__name__}: {str(e)[:400]}"
print("RESULT " + json.dumps(out), flush=True)
'''


def free_port() -> int:
    sock = socket.socket()
    sock.bind(("localhost", 0))
    port = sock.getsockname()[1]
    sock.close()
    return port


def phase(backend: str, world: int) -> list:
    port = str(free_port())
    procs = [subprocess.Popen([sys.executable, "-c", CHILD, str(r), str(world), port, backend],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(world)]
    res = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=90)
        except subprocess.TimeoutExpired:
            p.kill()
            out, err = p.communicate()
            res.append({"timeout": True, "stderr": err[-600:]})
            continue
        line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        res.append(json.loads(line[-1][7:]) if line else {"rc": p.returncode, "stderr": err[-600:]})
    return res


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("nccl_probe: no CUDA device", file=sys.stderr)
        return 2
    print(sys.version, torch.__version__, torch.version.cuda, torch.cuda.get_device_name(0))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    for backend, world in (("nccl", 2), ("nccl", 1), ("gloo", 2)):
        t0 = time.time()
        res = phase(backend, world)
        print(f"PHASE {backend} world={world} {time.time() - t0:.1f}s " + json.dumps(res),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
