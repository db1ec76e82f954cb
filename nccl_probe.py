#!/usr/bin/env python3
"""Which collectives run between ranks sharing one GPU?

    python3 nccl_probe.py

Runs three worlds of child processes, each rank on ``cuda:0``: two ranks
under NCCL, one rank under NCCL, two ranks under gloo. Every rank tries
``all_reduce``, ``all_gather_into_tensor``, ``all_gather``,
``all_to_all_single`` and ``broadcast`` on CUDA tensors and prints what
each returned or the error it raised (NCCL refuses two ranks on one
device: "Duplicate GPU detected"). A fourth world, four gloo ranks on
``cuda:0`` as a 2 x 2 mesh, tries what the model-parallel collectives
need on the groups of each axis, in f32 and bf16: ``all_reduce``,
``all_gather`` and ``broadcast`` on a group and a ring permute by
``all_to_all_single`` with a split for the neighbour alone on host
copies; then, after printing those, the same permute on the device's
tensors and ``send``/``recv`` (on torch 2.11 the first aborts the
rank: gloo's transport is handed the device pointer, "Bad address"). Prints the Python, torch and CUDA
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

# four gloo ranks as a 2 x 2 mesh (rank = 2 * i + j): the groups of each
# axis, made in one order on every rank, and the collectives on them
CHILD_GROUPS = r'''
import datetime, json, sys
import torch, torch.distributed as dist
rank, world, port, dev = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
dev = torch.device(dev)
if dev.type == "cuda":
    torch.cuda.set_device(dev)
out = {"rank": rank, "backend": "gloo"}
try:
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=40))
    groups = {}
    for axis, lines in (("row", ([0, 1], [2, 3])), ("col", ([0, 2], [1, 3]))):
        for ranks in lines:
            g = dist.new_group(ranks)
            if rank in ranks:
                groups[axis] = (g, ranks)
    def permute(t, g, me, n, host):
        w = t.cpu() if host else t
        o = torch.empty_like(w)
        ins = [w.numel() if d == (me + 1) % n else 0 for d in range(n)]
        outs = [w.numel() if s == (me - 1) % n else 0 for s in range(n)]
        dist.all_to_all_single(o, w, outs, ins, group=g)
        return o.float().tolist()

    # what may abort the process (gloo handing a device pointer to its
    # transport) runs last, after a first RESULT line
    for risky in (False, True):
        names = (("send_recv", "permute_device") if risky else
                 ("permute_host", "all_reduce", "all_gather", "broadcast"))
        for dtype in (torch.float32, torch.bfloat16):
            for axis, (g, ranks) in groups.items():
                me, n = ranks.index(rank), len(ranks)
                key = f"{axis}_{str(dtype)[6:]}"
                for name in names:
                    try:
                        t = (torch.arange(4, dtype=torch.float32, device=dev) + 10 * rank).to(dtype)
                        if name.startswith("permute"):
                            r = permute(t, g, me, n, host=name == "permute_host")
                        elif name == "send_recv":
                            o = torch.empty_like(t)
                            nxt, prv = ranks[(me + 1) % n], ranks[(me - 1) % n]
                            reqs = [dist.isend(t, nxt, group=g), dist.irecv(o, prv, group=g)]
                            for q in reqs:
                                q.wait()
                            r = o.float().tolist()
                        elif name == "all_reduce":
                            dist.all_reduce(t, group=g)
                            r = t.float().tolist()
                        elif name == "all_gather":
                            o = [torch.empty_like(t) for _ in range(n)]
                            dist.all_gather(o, t, group=g)
                            r = [x.float().tolist() for x in o]
                        else:
                            dist.broadcast(t, ranks[-1], group=g)
                            r = t.float().tolist()
                        if dev.type == "cuda":
                            torch.cuda.synchronize()
                        out[f"{key}_{name}"] = r
                    except Exception as e:
                        out[f"{key}_{name}"] = f"ERR {type(e).__name__}: {str(e)[:300]}"
        print("RESULT " + json.dumps(out), flush=True)
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


def phase(backend: str, world: int, child: str = CHILD) -> list:
    port = str(free_port())
    last = backend if child is CHILD else "cuda:0"
    procs = [subprocess.Popen([sys.executable, "-c", child, str(r), str(world), port, last],
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
        got = json.loads(line[-1][7:]) if line else {}
        if p.returncode != 0:
            got.update(rc=p.returncode, stderr=err[-600:])
        res.append(got)
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
    t0 = time.time()
    res = phase("gloo", 4, CHILD_GROUPS)
    print(f"PHASE gloo groups world=4 {time.time() - t0:.1f}s " + json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
