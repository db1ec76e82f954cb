"""The port's model parallelism across ranks against the JAX package:
ring and Ulysses attention, the Megatron tp/sp sharded train step,
expert-parallel MoE and the pp pipeline.

Each world size runs ONCE per module: gloo ranks on the CPU, each a
child process running this file as a script (``--rank``). World 8 takes
the reference tests' meshes (``{"dp": 2, "tp": 2, "sp": 2}``, ``{"sp":
4, "dp": 2}``, ``{"sp": 8}``, ``{"ep": 4, "dp": 2}``, ``{"pp": 4, "dp":
2}``, ``{"pp": 2, "dp": 4}`` and a pure-dp ``{"dp": 8}``); world 4 takes
``{"ep": 4}`` and ``{"pp": 4}``. Inputs are drawn from a seed with numpy,
the JAX package's parameters made by its own ``init_params`` and carried
as numpy; the test writes them, the ranks cut their shards, and rank 0
pickles what the ranks gathered. Every result is held against the JAX
package on the same whole arrays over its 8 virtual CPU devices.

Tolerances, written once:

* attention on f32 inputs within ``F32_RTOL`` of max|ref|; on bf16
  inputs within ``BF16_RTOL`` of max|ref| (both packages sum in f32 and
  round the context to bf16 last, so the outputs may land one bf16 step,
  2^-8 relative, apart; two steps at the largest value allowed);
* a sharded step's f32 loss within ``LOSS_F32_ATOL``; each gathered
  gradient leaf within ``GRAD_F32_RTOL`` of that leaf's max|ref grad|;
  an SGD step's updated leaves within ``GRAD_F32_RTOL`` of lr·max|ref
  grad| of theirs, plus one f32 step of the updated value (each side
  rounds the update once; a tp× or sp× error in a gradient lands far
  outside);
* mixed precision (layers cast to bf16): the loss within
  ``LOSS_BF16_ATOL`` and the gradients within ``GRAD_BF16_RTOL``: bf16
  activations rounded in another order by each package;
* each about 3-15x the gap of a run on the CPU: f32 losses
  equal, f32 gradients 1.0-1.6e-6 of their max, mixed precision 6.3e-5
  and 0.0189, attention 1.6-2.2e-7 of max|ref| (bf16: equal);
* MoE and the pipeline in f32 within ``F32_RTOL``·max|ref| + 1e-6.
"""

from __future__ import annotations

import functools
import os
import pickle
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
WORLDS = (8, 4)
CHILD_TIMEOUT_S = 300
F32_RTOL = 1e-5
BF16_RTOL = 2.0 ** -7
LOSS_F32_ATOL = 1e-5
GRAD_F32_RTOL = 2e-5
LOSS_BF16_ATOL = 5e-4
GRAD_BF16_RTOL = 5e-2
SGD_LR = 0.1

MESH_3D = {"dp": 2, "tp": 2, "sp": 2}
STEP_CASES = {  # case: (mesh, attention_impl, dtype, mixed_precision, batch, seq)
    "dense": (MESH_3D, "dense", "float32", False, 4, 16),
    "blockwise": (MESH_3D, "blockwise", "float32", False, 4, 16),
    "flash": (MESH_3D, "flash", "float32", False, 4, 16),
    "ring": (MESH_3D, "ring", "float32", False, 4, 16),
    "ulysses": (MESH_3D, "ulysses", "float32", False, 4, 16),
    "ring_mixed": (MESH_3D, "ring", "bfloat16", True, 4, 16),
    "pure_dp": ({"dp": 8}, "dense", "float32", False, 8, 8),
}
ATTN_CASES = {  # case: (mesh, inputs, impl, causal, head_axis)
    "ring": ({"sp": 8}, "qkv64", "ring", False, None),
    "ring_causal": ({"sp": 8}, "qkv64", "ring", True, None),
    "ring_dp_sp": ({"dp": 2, "sp": 4}, "qkv64", "ring", False, None),
    "ring_dp_tp_sp": (MESH_3D, "qkv64", "ring", True, "tp"),
    "ring_bf16": ({"sp": 8}, "qkv64_bf16", "ring", True, None),
    "ulysses": ({"sp": 4, "dp": 2}, "qkv16", "ulysses", False, None),
    "ulysses_causal": ({"sp": 4, "dp": 2}, "qkv32", "ulysses", True, None),
    "ulysses_bf16": ({"sp": 4, "dp": 2}, "qkv32_bf16", "ulysses", True, None),
}
PIPE_CASES = {  # case: (mesh, params seed, stages, x seed, batch, n_micro)
    "pp4_dp2": ({"pp": 4, "dp": 2}, 0, 4, 1, 16, None),
    "pp4_dp2_micro8": ({"pp": 4, "dp": 2}, 0, 4, 1, 16, 8),
    "pp2_dp4": ({"pp": 2, "dp": 4}, 2, 2, 2, 8, None),
    "pp4": ({"pp": 4}, 0, 4, 1, 16, None),
    "pp4_micro8": ({"pp": 4}, 0, 4, 1, 16, 8),
}
MOE_MESHES = {8: {"ep": 4, "dp": 2}, 4: {"ep": 4}}
PP_TRAIN_MESHES = {8: {"pp": 4, "dp": 2}, 4: {"pp": 4}}


def _qkv(b, h, s, d, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, h, s, d)).astype(np.float32) for _ in range(3))


def _stack(n_stages, width, seed):
    rng = np.random.default_rng(seed)
    return {
        "w": (rng.standard_normal((n_stages, width, width)) / np.sqrt(width)).astype(np.float32),
        "b": (rng.standard_normal((n_stages, width)) * 0.1).astype(np.float32),
    }


def make_inputs() -> dict:
    """Every array the ranks read, drawn from seeds with numpy; the
    models' weights from the JAX package's own initialisers."""
    import jax

    from tensorframes_tpu.models import moe as jmoe
    from tensorframes_tpu.models import transformer as jtr

    to_np = functools.partial(jax.tree_util.tree_map, np.asarray)
    d = {
        "qkv64": _qkv(2, 4, 64, 16, 0),
        "qkv60": _qkv(2, 4, 60, 16, 0),
        "qkv16": _qkv(2, 4, 16, 8, 5),
        "qkv32": _qkv(1, 4, 32, 8, 6),
        "tr_params": to_np(jtr.init_params(jtr.tiny(), seed=0)),
        "moe_params": to_np(jmoe.init_moe_params(_moe_cfg(jmoe), seed=2)),
        "moe_train_params": to_np(jmoe.init_moe_params(_moe_cfg(jmoe, train=True), seed=3)),
    }
    d["qkv64_bf16"] = d["qkv64"]
    d["qkv32_bf16"] = d["qkv32"]
    for case, (_, _, _, _, b, s) in STEP_CASES.items():
        d[f"batch_{case}"] = jtr.synthetic_batch(jtr.tiny(), b, s, seed=0)
    d["tokens_ulysses"] = jtr.synthetic_batch(jtr.tiny(), 2, 16, seed=0)[0]
    rng = np.random.default_rng(2)
    d["moe_x"] = rng.standard_normal((64, 16)).astype(np.float32)
    rng = np.random.default_rng(3)
    d["moe_train_x"] = rng.standard_normal((32, 16)).astype(np.float32)
    d["moe_train_y"] = rng.standard_normal((32, 16)).astype(np.float32)
    for case, (_, pseed, n, xseed, b, _) in PIPE_CASES.items():
        d[f"pipe_params_{case}"] = _stack(n, 8, pseed)
        d[f"pipe_x_{case}"] = np.random.default_rng(xseed).standard_normal((b, 8)).astype(
            np.float32)
    d["pipe_train_params"] = _stack(4, 8, 3)
    rng = np.random.default_rng(4)
    d["pipe_train_x"] = rng.standard_normal((16, 8)).astype(np.float32)
    d["pipe_train_t"] = rng.standard_normal((16, 8)).astype(np.float32)
    return d


def _moe_cfg(mod, train: bool = False, num_experts=None):
    e = num_experts or (4 if train else 8)
    # capacity == tokens: nothing drops, so one process and the ranks agree
    return mod.MoEConfig(hidden=16, mlp_hidden=32, num_experts=e, capacity_factor=float(e))


# ---------------------------------------------------------------------------
# the rank (run as a script)
# ---------------------------------------------------------------------------

def _text(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the text is the result
        return f"{type(e).__name__}: {e}"
    return None


def _attn_spec(mesh, shape, head_axis):
    """The reference's layout: batch over dp and heads over ``head_axis``
    where they divide (``_maybe_axis``), the sequence over sp."""
    from tensorframes_tpu_torch.parallel.mesh import PartitionSpec as P

    def maybe(name, size):
        return name if name and name in mesh.shape and size % mesh.shape[name] == 0 else None

    return P(maybe("dp", shape[0]), maybe(head_axis, shape[1]), "sp", None)


def _np(t):
    import torch

    return t.detach().float().numpy() if t.dtype == torch.bfloat16 else t.detach().numpy()


def attention_ops(data: dict) -> dict:
    import torch
    from tensorframes_tpu_torch.ops import attention as att
    from tensorframes_tpu_torch.parallel import make_mesh
    from tensorframes_tpu_torch.parallel.mesh import gather_tensor, shard_tensor

    out = {}
    for case, (axes, key, impl, causal, head_axis) in ATTN_CASES.items():
        mesh = make_mesh(axes)
        dtype = torch.bfloat16 if key.endswith("bf16") else torch.float32
        spec = _attn_spec(mesh, data[key][0].shape, head_axis)
        q, k, v = (shard_tensor(torch.from_numpy(a).to(dtype), spec, mesh) for a in data[key])
        fn = att.ring_attention if impl == "ring" else att.ulysses_attention
        got = fn(q, k, v, mesh, axis="sp", causal=causal)
        out[f"attn_{case}"] = _np(gather_tensor(got, spec, mesh))
    # the ring's gradients: of the sum of every rank's context
    mesh = make_mesh({"sp": 8})
    spec = _attn_spec(mesh, data["qkv64"][0].shape, None)
    leaves = [shard_tensor(torch.from_numpy(a), spec, mesh).requires_grad_(True)
              for a in data["qkv64"]]
    att.ring_attention(*leaves, mesh, axis="sp").sum().backward()
    out["attn_ring_grads"] = [_np(gather_tensor(t.grad, spec, mesh)) for t in leaves]
    out["err_ring_seq"] = _text(lambda: shard_tensor(
        torch.from_numpy(data["qkv60"][0]), spec, mesh, what="ring_attention q"))
    mesh = make_mesh({"sp": 4, "dp": 2})
    q3 = torch.zeros((1, 3, 16, 8))
    q3 = shard_tensor(q3, _attn_spec(mesh, q3.shape, None), mesh)
    out["err_ulysses_heads"] = _text(lambda: att.ulysses_attention(q3, q3, q3, mesh, axis="sp"))
    return out


def transformer_ops(data: dict) -> dict:
    import torch
    from tensorframes_tpu_torch.models import transformer as tr
    from tensorframes_tpu_torch.ops.quantize import _tree_map, tree_leaves
    from tensorframes_tpu_torch.parallel import make_mesh
    from tensorframes_tpu_torch.parallel.mesh import PartitionSpec as P, gather_tensor

    def sgd(p):
        return torch.optim.SGD(tree_leaves(p), lr=SGD_LR)

    params = data["tr_params"]
    out = {}
    for case, (axes, impl, dtype, mixed, _, _) in STEP_CASES.items():
        mesh = make_mesh(axes)
        cfg = tr.tiny(attention_impl=impl, dtype=getattr(torch, dtype))
        step, data_sh, shardings, init_opt = tr.make_sharded_train_step(
            cfg, mesh, sgd, mixed_precision=mixed)
        local = tr.shard_params(cfg, params, mesh)
        opt = init_opt(local)
        tokens, targets = tr.shard_batch(mesh, *data[f"batch_{case}"])
        _, _, loss = step(local, opt, tokens, targets)
        grads = tr.gather_params(cfg, _tree_map(lambda _, t: t.grad, local), mesh)
        new = tr.gather_params(cfg, local, mesh)
        out[f"step_{case}"] = {
            "loss": float(loss),
            "grads": _tree_map(lambda _, t: _np(t), grads),
            "new": _tree_map(lambda _, t: _np(t), new),
            "data_spec": tuple(data_sh.spec),
            "local_qkv": tuple(local["layers"][0]["attn"]["qkv"].shape),
        }
    # shard, then gather: bit for bit
    mesh = make_mesh(MESH_3D)
    cfg = tr.tiny()
    back = tr.gather_params(cfg, tr.shard_params(cfg, params, mesh), mesh)
    out["round_trip"] = _tree_map(lambda _, t: _np(t), back)
    # the optimizer factory over the shards: AdamW's state split like them
    cfg = tr.tiny(dtype=torch.float32)
    step, _, _, init_opt = tr.make_sharded_train_step(
        cfg, mesh, functools.partial(tr.adamw, learning_rate=1e-3))
    local = tr.shard_params(cfg, params, mesh)
    opt = init_opt(local)
    tokens, targets = tr.shard_batch(mesh, *data["batch_dense"])
    losses = [float(step(local, opt, tokens, targets)[2]) for _ in range(3)]
    out["adamw"] = {
        "losses": losses,
        "state_shapes_match": all(
            tuple(opt.state[leaf]["exp_avg"].shape) == tuple(leaf.shape)
            for leaf in tree_leaves(local)),
        "qkv_local": tuple(local["layers"][0]["attn"]["qkv"].shape),
    }
    # forward with the Ulysses impl on the reference test's mesh
    mesh = make_mesh({"sp": 4, "dp": 2})
    cfg = tr.tiny(attention_impl="ulysses")
    tok = data["tokens_ulysses"]
    local_tok = tr.shard_batch(mesh, tok, tok)[0]
    with torch.no_grad():
        hs = tr.forward(cfg, tr.shard_params(cfg, params, mesh), local_tok, mesh=mesh)
    out["forward_ulysses"] = _np(gather_tensor(hs, P("dp", "sp", None), mesh))
    return out


def moe_ops(data: dict, axes: dict) -> dict:
    import torch
    from tensorframes_tpu_torch.models import moe
    from tensorframes_tpu_torch.parallel import make_mesh
    from tensorframes_tpu_torch.parallel.mesh import gather_tensor, shard_tensor

    mesh = make_mesh(axes)
    out = {}
    cfg = _moe_cfg(moe)
    spec = moe._token_spec(mesh, "ep", "dp").spec
    local = moe.shard_moe_params(data["moe_params"], mesh)
    x = shard_tensor(data["moe_x"], spec, mesh)
    y, (frac, prob) = moe.moe_ffn_ep(cfg, local, x, mesh, return_stats=True)
    out["moe_ep"] = _np(gather_tensor(y, spec, mesh))
    out["moe_ep_stats"] = (_np(frac), _np(prob))
    out["err_moe_divisible"] = _text(lambda: moe.moe_ffn_ep(
        _moe_cfg(moe, num_experts=6), local, x, mesh))

    tcfg = _moe_cfg(moe, train=True)
    xs = shard_tensor(data["moe_train_x"], spec, mesh)
    ys = shard_tensor(data["moe_train_y"], spec, mesh)
    sgd_step, data_sh, shardings, init_opt = moe.make_ep_train_step(
        tcfg, mesh, lambda p: torch.optim.SGD(list(p.values()), lr=SGD_LR))
    local = moe.shard_moe_params(data["moe_train_params"], mesh)
    opt = init_opt(local)
    _, _, loss = sgd_step(local, opt, xs, ys)
    out["moe_sgd"] = {
        "loss": float(loss),
        "grads": {k: _np(gather_tensor(v.grad, shardings[k], mesh)) for k, v in local.items()},
        "new": {k: _np(gather_tensor(v, shardings[k], mesh)) for k, v in local.items()},
        "data_spec": tuple(data_sh.spec),
    }
    adam_step, _, _, init_opt = moe.make_ep_train_step(
        tcfg, mesh, lambda p: torch.optim.Adam(list(p.values()), lr=1e-2))
    local = moe.shard_moe_params(data["moe_train_params"], mesh)
    opt = init_opt(local)
    out["moe_adam_losses"] = [float(adam_step(local, opt, xs, ys)[2]) for _ in range(8)]
    return out


def _stage_fn(p, h):
    import torch

    return torch.tanh(h @ p["w"] + p["b"])


def pipeline_ops(data: dict, world: int) -> dict:
    import torch
    from tensorframes_tpu_torch.ops.quantize import tree_leaves
    from tensorframes_tpu_torch.parallel import make_mesh, make_pp_train_step, pipeline_apply
    from tensorframes_tpu_torch.parallel.mesh import PartitionSpec as P, gather_tensor, shard_tensor
    from tensorframes_tpu_torch.parallel.pipeline import gather_stage_params, shard_stage_params

    out = {}
    for case, (axes, _, _, _, _, n_micro) in PIPE_CASES.items():
        if ("dp" in axes) != (world == 8):
            continue
        mesh = make_mesh(axes)
        spec = P("dp" if "dp" in axes else None, None)
        local = shard_stage_params(data[f"pipe_params_{case}"], mesh)
        x = shard_tensor(data[f"pipe_x_{case}"], spec, mesh)
        y = pipeline_apply(_stage_fn, local, x, mesh, axis="pp", num_microbatches=n_micro)
        out[f"pipe_{case}"] = _np(gather_tensor(y, spec, mesh))
        # the whole stack, the reference's form: each stage takes its slice
        whole = {k: torch.from_numpy(v) for k, v in data[f"pipe_params_{case}"].items()}
        y2 = pipeline_apply(_stage_fn, whole, x, mesh, axis="pp", num_microbatches=n_micro)
        out[f"pipe_whole_{case}"] = _np(gather_tensor(y2, spec, mesh))

    axes = PP_TRAIN_MESHES[world]
    mesh = make_mesh(axes)
    spec = P("dp" if "dp" in axes else None, None)
    if world == 8:
        x10 = shard_tensor(np.zeros((10, 8), np.float32), spec, mesh)
        local = shard_stage_params(data["pipe_params_pp4_dp2"], mesh)
        out["err_pipe_batch"] = _text(lambda: pipeline_apply(
            _stage_fn, local, x10, mesh, num_microbatches=4))
        eight = {k: torch.from_numpy(v) for k, v in _stack(8, 8, 0).items()}
        x16 = shard_tensor(np.zeros((16, 8), np.float32), spec, mesh)
        out["err_pipe_stages"] = _text(lambda: pipeline_apply(_stage_fn, eight, x16, mesh))

    def loss_head(h, t):
        return torch.mean((h - t) ** 2)

    x = shard_tensor(data["pipe_train_x"], spec, mesh)
    t = shard_tensor(data["pipe_train_t"], spec, mesh)
    jit_for = make_pp_train_step(_stage_fn, loss_head, mesh,
                                 lambda p: torch.optim.SGD(tree_leaves(p), lr=SGD_LR))
    step, init_opt, sh = jit_for(data["pipe_train_params"])
    local = shard_stage_params(data["pipe_train_params"], mesh)
    opt = init_opt(local)
    _, _, loss = step(local, opt, x, t)
    out["pp_sgd"] = {
        "loss": float(loss),
        "grads": {k: _np(v) for k, v in gather_stage_params(
            {k: leaf.grad for k, leaf in local.items()}, mesh).items()},
        "new": {k: _np(v) for k, v in gather_stage_params(local, mesh).items()},
        "specs": {k: tuple(v.spec) for k, v in sh.items()},
    }
    jit_for = make_pp_train_step(_stage_fn, loss_head, mesh,
                                 lambda p: torch.optim.Adam(tree_leaves(p), lr=5e-3))
    step, init_opt, _ = jit_for(data["pipe_train_params"])
    local = shard_stage_params(data["pipe_train_params"], mesh)
    opt = init_opt(local)
    out["pp_adam_losses"] = [float(step(local, opt, x, t)[2]) for _ in range(10)]
    return out


def rank_ops(data: dict, world: int) -> dict:
    from tensorframes_tpu_torch.parallel import collectives

    out = {}
    if world == 8:
        out.update(attention_ops(data))
        out.update(transformer_ops(data))
    out.update(moe_ops(data, MOE_MESHES[world]))
    out.update(pipeline_ops(data, world))
    out["collective_bytes"] = collectives.collective_bytes()
    return out


def _rank_main(argv) -> int:
    rank, world, port, inp, work = int(argv[0]), int(argv[1]), argv[2], argv[3], argv[4]
    sys.path.insert(0, str(ROOT))
    import torch

    import tensorframes_tpu_torch as tft
    from tensorframes_tpu_torch.parallel import init_distributed

    torch.set_num_threads(1)
    tft.configure(device="cpu")
    init_distributed(f"localhost:{port}", world, rank, backend="gloo", device="cpu")
    with open(inp, "rb") as f:
        data = pickle.load(f)
    res = rank_ops(data, world)
    res["rank"] = rank
    with open(os.path.join(work, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
    return 0


# ---------------------------------------------------------------------------
# the test side
# ---------------------------------------------------------------------------

def _free_port() -> int:
    sock = socket.socket()
    sock.bind(("localhost", 0))
    port = sock.getsockname()[1]
    sock.close()
    return port


def run_world(world: int, work: Path, data: dict) -> list:
    """Launch ``world`` gloo ranks of this file once; each child has its own
    time limit. Returns every rank's pickled results, in rank order."""
    work.mkdir(parents=True, exist_ok=True)
    inp = work / "in.pkl"
    with open(inp, "wb") as f:
        pickle.dump(data, f)
    port = str(_free_port())
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--rank", str(r), str(world),
         port, str(inp), str(work)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=str(ROOT),
    ) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=CHILD_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    rcs = [p.returncode for p in procs]
    assert rcs == [0] * world, "\n".join(log[-3000:] for log in logs)
    out = []
    for r in range(world):
        with open(work / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


@pytest.fixture(scope="module")
def inputs():
    return make_inputs()


@pytest.fixture(scope="module")
def runs(tmp_path_factory, inputs):
    """``runs(world)``: that world's rank results, launched once."""
    done = {}

    def get(w):
        if w not in done:
            done[w] = run_world(w, tmp_path_factory.mktemp(f"ranks{w}"), inputs)
        return done[w]

    return get


@pytest.fixture(scope="module")
def world8(runs):
    return runs(8)


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"ranks{w}")
def world(request, runs):
    return request.param, runs(request.param)


def _jmesh(axes):
    """The JAX package's mesh over the first devices its axes need."""
    import math

    import jax

    from tensorframes_tpu.parallel import make_mesh

    return make_mesh(axes, devices=jax.devices()[:math.prod(axes.values())])


def _close(got, want, rtol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max()) if got.size else 0.0
    bound = rtol * max(float(np.abs(want).max()), 1e-30)
    assert err <= bound, f"{what}: max |diff| {err:.3g} > {bound:.3g}"


def _sgd_close(got, p0, g, rtol, what):
    """An SGD update ``p0 - lr·g`` within ``rtol`` of lr·max|g|, plus one
    f32 step of the updated value (each side rounds the update once)."""
    want = p0 - SGD_LR * g
    err = float(np.abs(got.astype(np.float64) - want).max())
    bound = rtol * SGD_LR * max(float(np.abs(g).max()), 1e-30)
    assert err <= bound + float(np.spacing(np.abs(want).astype(np.float32)).max()), (what, err)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in tree:
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


# --- attention --------------------------------------------------------------

def _jax_attention(case, inputs):
    import jax
    import jax.numpy as jnp

    from tensorframes_tpu.ops import attention as jatt

    axes, key, impl, causal, head_axis = ATTN_CASES[case]
    dtype = jnp.bfloat16 if key.endswith("bf16") else jnp.float32
    q, k, v = (jnp.asarray(a, dtype) for a in inputs[key])
    mesh = _jmesh(axes)
    if impl == "ring":
        fn = functools.partial(jatt.ring_attention, mesh=mesh, axis="sp", causal=causal,
                               head_axis=head_axis or "tp")
    else:
        fn = functools.partial(jatt.ulysses_attention, mesh=mesh, axis="sp", causal=causal)
    return np.asarray(jax.jit(fn)(q, k, v), np.float32)


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_sequence_parallel_attention_matches_the_reference(world8, inputs, case):
    got = world8[0][f"attn_{case}"]
    want = _jax_attention(case, inputs)
    rtol = BF16_RTOL if ATTN_CASES[case][1].endswith("bf16") else F32_RTOL
    _close(got, want, rtol, case)


@pytest.mark.parametrize("case", ["ring", "ring_causal", "ulysses", "ulysses_causal"])
def test_sequence_parallel_attention_matches_dense(world8, inputs, case):
    import jax.numpy as jnp

    from tensorframes_tpu.ops import attention as jatt

    _, key, _, causal, _ = ATTN_CASES[case]
    want = np.asarray(jatt.dense_attention(*(jnp.asarray(a) for a in inputs[key]),
                                           causal=causal))
    _close(world8[0][f"attn_{case}"], want, 1e-4, case)


def test_ring_gradients_match_the_reference(world8, inputs):
    import jax
    import jax.numpy as jnp

    from tensorframes_tpu.ops import attention as jatt

    mesh = _jmesh({"sp": 8})
    q, k, v = (jnp.asarray(a) for a in inputs["qkv64"])
    want = jax.jit(jax.grad(lambda q, k, v: jatt.ring_attention(q, k, v, mesh, axis="sp").sum(),
                            argnums=(0, 1, 2)))(q, k, v)
    for name, g, w in zip("qkv", world8[0]["attn_ring_grads"], want):
        _close(g, np.asarray(w), F32_RTOL, f"d{name}")


def test_ranks_hold_the_same_gathered_context(world8):
    for rank in world8[1:]:
        for case in ATTN_CASES:
            np.testing.assert_array_equal(rank[f"attn_{case}"], world8[0][f"attn_{case}"])


def test_error_texts_are_the_references(world8, inputs):
    import jax.numpy as jnp

    from tensorframes_tpu.ops import attention as jatt

    with pytest.raises(ValueError, match="divisible"):
        jatt.ring_attention(*(jnp.asarray(a) for a in inputs["qkv60"]), _jmesh({"sp": 8}),
                            axis="sp")
    assert "divisible" in world8[0]["err_ring_seq"]
    q = jnp.zeros((1, 3, 16, 8), jnp.float32)
    with pytest.raises(ValueError) as ref:
        jatt.ulysses_attention(q, q, q, _jmesh({"sp": 4, "dp": 2}), axis="sp")
    assert world8[0]["err_ulysses_heads"] == f"ValueError: {ref.value}"


def test_ring_requires_a_mesh_with_sp_like_the_reference():
    import jax.numpy as jnp

    from tensorframes_tpu.models import transformer as jtr
    from tensorframes_tpu_torch.models import transformer as tr
    from tensorframes_tpu_torch.parallel.mesh import Mesh

    tokens, _ = jtr.synthetic_batch(jtr.tiny(), 2, 8)
    for impl in ("ring", "ulysses"):
        with pytest.raises(ValueError) as ref:
            jtr.forward(jtr.tiny(attention_impl=impl), jtr.init_params(jtr.tiny()),
                        jnp.asarray(tokens))
        cfg = tr.tiny(attention_impl=impl)
        params = tr.init_params(cfg, device="cpu")
        for mesh in (None, Mesh([1], ["dp"], [0])):
            with pytest.raises(ValueError, match="'sp' axis") as got:
                tr.forward(cfg, params, tokens, mesh=mesh)
            if mesh is None:
                assert str(got.value) == str(ref.value)


def test_paged_decode_attention_is_the_kernels_public_face():
    import torch

    from tensorframes_tpu_torch.kernels import decode_attention as kda
    from tensorframes_tpu_torch.ops import attention as att

    rng = np.random.default_rng(0)
    P_, L, nh, page, hd, S = 6, 2, 3, 4, 8, 2
    kp = torch.from_numpy(rng.integers(-127, 128, (P_, L, nh, page, hd)).astype(np.int8))
    vp = torch.from_numpy(rng.integers(-127, 128, (P_, L, nh, page, hd)).astype(np.int8))
    ks = torch.from_numpy(rng.random((P_, L, nh, page, 1)).astype(np.float32))
    vs = torch.from_numpy(rng.random((P_, L, nh, page, 1)).astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((S, nh, hd)).astype(np.float32))
    tables = torch.tensor([[0, 1, 2], [3, 4, 5]], dtype=torch.int32)
    pos = torch.tensor([5, 9], dtype=torch.int32)
    got = att.paged_decode_attention(q, kp, vp, ks, vs, 1, tables, pos)
    want = kda.paged_attention_reference(q, kp, vp, ks, vs, 1, tables, pos)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="interpret"):
        att.paged_decode_attention(q, kp, vp, ks, vs, 1, tables, pos, interpret=True)


def test_blockwise_attention_keeps_its_bits_after_the_online_block_split():
    import jax.numpy as jnp
    import torch

    from tensorframes_tpu.ops import attention as jatt
    from tensorframes_tpu_torch.ops import attention as att

    q, k, v = _qkv(2, 4, 60, 16, 3)
    for causal in (False, True):
        got = att.blockwise_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                      causal=causal, block_size=16)
        want = jatt.blockwise_attention(*(jnp.asarray(a) for a in (q, k, v)), causal=causal,
                                        block_size=16)
        _close(got.numpy(), np.asarray(want), F32_RTOL, f"causal={causal}")


# --- the transformer across ranks -------------------------------------------

def _jax_step(case, inputs):
    """The JAX package's first sharded step (its loss) and its loss_fn
    gradient on the whole arrays, in the case's dtype and mode."""
    import jax
    import jax.numpy as jnp
    import optax

    from tensorframes_tpu.models import transformer as jtr
    from tensorframes_tpu.training import cast_float_leaves

    axes, impl, dtype, mixed, _, _ = STEP_CASES[case]
    impl_ref = "blockwise" if impl == "flash" else impl
    cfg = jtr.tiny(attention_impl=impl_ref, dtype=getattr(jnp, dtype))
    mesh = _jmesh(axes)
    params = jax.tree_util.tree_map(jnp.asarray, inputs["tr_params"])
    tokens, targets = inputs[f"batch_{case}"]
    step, data_sh, param_sh, init_opt = jtr.make_sharded_train_step(
        cfg, mesh, optax.sgd(SGD_LR), mixed_precision=mixed)
    p = jax.device_put(params, param_sh)
    _, _, loss = step(p, init_opt(p), jax.device_put(tokens, data_sh),
                      jax.device_put(targets, data_sh))

    def run(p):
        if mixed:
            p = {**p, "layers": cast_float_leaves(p["layers"], cfg.dtype),
                 "final_ln": cast_float_leaves(p["final_ln"], cfg.dtype)}
        return jtr.loss_fn(cfg, p, tokens, targets, mesh=mesh)

    ref_loss, grads = jax.jit(jax.value_and_grad(run))(params)
    # the step's loss is loss_fn's (XLA fuses the two programs apart)
    assert abs(float(ref_loss) - float(loss)) <= _tols(case)[0]
    return float(loss), jax.tree_util.tree_map(np.asarray, grads)


@pytest.fixture(scope="module")
def jax_steps(inputs):
    return {case: _jax_step(case, inputs) for case in STEP_CASES}


def _tols(case):
    mixed = STEP_CASES[case][3]
    return (LOSS_BF16_ATOL, GRAD_BF16_RTOL) if mixed else (LOSS_F32_ATOL, GRAD_F32_RTOL)


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_sharded_step_loss_matches_the_reference(world8, jax_steps, case):
    loss_tol, _ = _tols(case)
    want, _ = jax_steps[case]
    losses = [r[f"step_{case}"]["loss"] for r in world8]
    assert len(set(losses)) == 1, losses  # the global loss, equal on every rank
    assert abs(losses[0] - want) <= loss_tol, (losses[0], want)


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_sharded_step_gradients_match_the_reference(world8, jax_steps, case):
    _, rtol = _tols(case)
    _, want = jax_steps[case]
    got = world8[0][f"step_{case}"]["grads"]
    for path, w in _leaves(want):
        _close(_at(got, path), w, rtol, f"{case} grad {path}")


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_sgd_step_updates_every_leaf_like_the_reference(world8, inputs, jax_steps, case):
    _, rtol = _tols(case)
    _, grads = jax_steps[case]
    new = world8[0][f"step_{case}"]["new"]
    for path, g in _leaves(grads):
        p0 = _at(inputs["tr_params"], path)
        _sgd_close(_at(new, path), p0, g, rtol, (case, path))


def test_sgd_check_sees_a_tp_scaled_gradient(world8, inputs, jax_steps):
    """The control: an update from a gradient off by the tp degree on one
    sharded leaf lands outside the SGD check's bound."""
    _, grads = jax_steps["dense"]
    path = ("layers", 0, "attn", "qkv")
    g = _at(grads, path)
    wrong = _at(inputs["tr_params"], path) - SGD_LR * 2 * g
    want = _at(inputs["tr_params"], path) - SGD_LR * g
    assert float(np.abs(wrong - want).max()) > GRAD_F32_RTOL * SGD_LR * float(np.abs(g).max())
    got = _at(world8[0]["step_dense"]["new"], path)
    assert float(np.abs(got - want).max()) < float(np.abs(wrong - want).max()) / 100


def test_param_shardings_is_the_references_spec_tree():
    from tensorframes_tpu.models import transformer as jtr
    from tensorframes_tpu_torch.models import transformer as tr
    from tensorframes_tpu_torch.parallel.mesh import Mesh

    for axes in (MESH_3D, {"dp": 8}, {"dp": 2, "sp": 4}, {"tp": 8}):
        jsh = jtr.param_shardings(jtr.tiny(), _jmesh(axes))
        sh = tr.param_shardings(tr.tiny(), Mesh(list(axes.values()), list(axes), range(8)))
        for path, ns in _leaves(jsh):
            assert tuple(_at(sh, path).spec) == tuple(ns.spec), (axes, path)


def test_shard_then_gather_is_bit_exact(world8, inputs):
    for path, want in _leaves(inputs["tr_params"]):
        got = _at(world8[0]["round_trip"], path)
        assert got.dtype == want.dtype and np.array_equal(got, want), path


@pytest.mark.parametrize("case", ["dense", "ring", "pure_dp"])
def test_sharded_step_keeps_the_references_layouts(world8, case):
    import optax

    from tensorframes_tpu.models import transformer as jtr

    axes = STEP_CASES[case][0]
    step = world8[0][f"step_{case}"]
    want_data = jtr.make_sharded_train_step(jtr.tiny(), _jmesh(axes), optax.sgd(SGD_LR))[1].spec
    assert step["data_spec"] == tuple(want_data)
    tp = axes.get("tp", 1)
    assert step["local_qkv"] == (32, 96 // tp)  # qkv split over tp, per head


def test_adamw_factory_splits_the_optimizer_state_like_the_params(world8, inputs, jax_steps):
    got = world8[0]["adamw"]
    assert got["state_shapes_match"] and got["qkv_local"] == (32, 48)
    assert abs(got["losses"][0] - jax_steps["dense"][0]) <= LOSS_F32_ATOL
    assert got["losses"][-1] < got["losses"][0]
    assert all(r["adamw"]["losses"] == got["losses"] for r in world8)


def test_ulysses_forward_matches_the_reference(world8, inputs):
    import jax
    import jax.numpy as jnp

    from tensorframes_tpu.models import transformer as jtr

    params = inputs["tr_params"]
    tok = jnp.asarray(inputs["tokens_ulysses"])
    mesh = _jmesh({"sp": 4, "dp": 2})
    want = jax.jit(lambda p, t: jtr.forward(jtr.tiny(attention_impl="ulysses"), p, t,
                                            mesh=mesh))(params, tok)
    dense = jtr.forward(jtr.tiny(), params, tok)  # eager, as the reference's own test
    got = world8[0]["forward_ulysses"]
    _close(got, np.asarray(want, np.float32), BF16_RTOL * 4, "ulysses")
    np.testing.assert_allclose(got, np.asarray(dense, np.float32), rtol=3e-2, atol=3e-2)


# --- experts ------------------------------------------------------------------

def test_moe_ffn_matches_the_reference():
    import jax
    import jax.numpy as jnp
    import torch

    from tensorframes_tpu.models import moe as jmoe
    from tensorframes_tpu_torch.models import moe

    for seed, (t, e, cf) in enumerate(((32, 4, 4.0), (24, 4, 1.0), (40, 8, 1.25))):
        jcfg = jmoe.MoEConfig(hidden=16, mlp_hidden=32, num_experts=e, capacity_factor=cf)
        cfg = moe.MoEConfig(hidden=16, mlp_hidden=32, num_experts=e, capacity_factor=cf)
        jp = jmoe.init_moe_params(jcfg, seed=seed)
        p = moe.moe_params_from_jax({k: np.asarray(v) for k, v in jp.items()}, device="cpu")
        x = np.random.default_rng(seed).standard_normal((t, 16)).astype(np.float32)
        want, (wf, wp) = jax.jit(functools.partial(jmoe.moe_ffn, jcfg, return_stats=True))(
            jp, jnp.asarray(x))
        got, (gf, gp) = moe.moe_ffn(cfg, p, torch.from_numpy(x), return_stats=True)
        _close(got.numpy(), np.asarray(want), F32_RTOL, f"moe_ffn {t} {e} {cf}")
        _close(gf.numpy(), np.asarray(wf), F32_RTOL, "frac")
        _close(gp.numpy(), np.asarray(wp), F32_RTOL, "prob")


def test_routing_dispatch_invariants_and_the_references_route():
    import jax.numpy as jnp
    import torch

    from tensorframes_tpu.models import moe as jmoe
    from tensorframes_tpu_torch.models import moe

    jcfg = jmoe.MoEConfig(hidden=16, mlp_hidden=32, num_experts=4, capacity_factor=1.0)
    cfg = moe.MoEConfig(hidden=16, mlp_hidden=32, num_experts=4, capacity_factor=1.0)
    jp = jmoe.init_moe_params(jcfg, seed=0)
    router = torch.from_numpy(np.array(jp["router"]))
    x = np.random.default_rng(0).standard_normal((24, 16)).astype(np.float32)
    cap = cfg.capacity(24)
    dispatch, combine, (frac, prob) = moe._route(cfg, router, torch.from_numpy(x), cap)
    assert dispatch.shape == (24, 4, cap)
    assert float(dispatch.sum(dim=(1, 2)).max()) <= 1.0  # one slot a token at most
    assert float(dispatch.sum(dim=0).max()) <= 1.0  # no slot booked twice
    assert np.isclose(float(frac.sum()), 1.0, atol=1e-6)
    assert np.isclose(float(prob.sum()), 1.0, atol=1e-5)
    wd, wc, _ = jmoe._route(jcfg, jp["router"], jnp.asarray(x), cap)
    np.testing.assert_array_equal(dispatch.numpy(), np.asarray(wd))
    _close(combine.numpy(), np.asarray(wc), F32_RTOL, "combine")
    assert float(dispatch.sum()) < 24  # capacity 6 a expert drops some of 24 tokens
    _close(moe.load_balancing_loss(frac, prob).numpy(),
           np.asarray(jmoe.load_balancing_loss(jnp.asarray(frac.numpy()),
                                               jnp.asarray(prob.numpy()))), F32_RTOL, "aux")


def test_moe_ep_matches_the_reference_and_one_process(world, inputs):
    import jax
    import jax.numpy as jnp
    import torch

    from tensorframes_tpu.models import moe as jmoe
    from tensorframes_tpu_torch.models import moe

    w, ranks = world
    jp = {k: jnp.asarray(v) for k, v in inputs["moe_params"].items()}
    x = jnp.asarray(inputs["moe_x"])
    want = np.asarray(jax.jit(functools.partial(jmoe.moe_ffn, _moe_cfg(jmoe)))(jp, x))
    mesh = _jmesh(MOE_MESHES[w])
    ep = np.asarray(jax.jit(lambda p, x: jmoe.moe_ffn_ep(_moe_cfg(jmoe), p, x, mesh,
                                                          axis="ep"))(jp, x))
    _close(ranks[0]["moe_ep"], want, F32_RTOL, "vs moe_ffn")
    _close(ranks[0]["moe_ep"], ep, F32_RTOL, "vs moe_ffn_ep")
    mine = moe.moe_ffn(_moe_cfg(moe), moe.moe_params_from_jax(inputs["moe_params"],
                                                              device="cpu"),
                       torch.from_numpy(inputs["moe_x"]), return_stats=True)
    _close(ranks[0]["moe_ep"], mine[0].numpy(), F32_RTOL, "vs the port's moe_ffn")
    for got, ref in zip(ranks[0]["moe_ep_stats"], mine[1]):
        _close(got, ref.numpy(), F32_RTOL, "stats")


def test_num_experts_must_divide_ep_like_the_reference(world, inputs):
    from tensorframes_tpu.models import moe as jmoe

    w, ranks = world
    jp = jmoe.init_moe_params(_moe_cfg(jmoe, num_experts=6), seed=0)
    with pytest.raises(ValueError, match="not divisible") as ref:
        jmoe.moe_ffn_ep(_moe_cfg(jmoe, num_experts=6), jp,
                        np.zeros((8, 16), np.float32), _jmesh(MOE_MESHES[w]))
    assert ranks[0]["err_moe_divisible"] == f"ValueError: {ref.value}"


def _jax_moe_grads(inputs):
    import jax
    import jax.numpy as jnp

    from tensorframes_tpu.models import moe as jmoe

    p = {k: jnp.asarray(v) for k, v in inputs["moe_train_params"].items()}
    x, y = jnp.asarray(inputs["moe_train_x"]), jnp.asarray(inputs["moe_train_y"])
    return jax.jit(jax.value_and_grad(
        lambda p: jmoe.loss_fn(_moe_cfg(jmoe, train=True), p, x, y)))(p)


def test_ep_train_step_gradients_and_sgd_update_match_the_reference(world, inputs):
    w, ranks = world
    loss, grads = _jax_moe_grads(inputs)
    got = ranks[0]["moe_sgd"]
    assert all(r["moe_sgd"]["loss"] == got["loss"] for r in ranks)
    assert abs(got["loss"] - float(loss)) <= LOSS_F32_ATOL
    for k, g in grads.items():
        g = np.asarray(g)
        _close(got["grads"][k], g, GRAD_F32_RTOL, f"grad {k}")
        _sgd_close(got["new"][k], inputs["moe_train_params"][k], g, GRAD_F32_RTOL, k)


def test_ep_train_step_runs_and_learns(world, inputs):
    import optax

    from tensorframes_tpu.models import moe as jmoe

    w, ranks = world
    losses = ranks[0]["moe_adam_losses"]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    want = jmoe.make_ep_train_step(_moe_cfg(jmoe, train=True), _jmesh(MOE_MESHES[w]),
                                   optax.adam(1e-2))[1].spec
    assert ranks[0]["moe_sgd"]["data_spec"] == tuple(want)


def test_moe_scoring_via_map_blocks_like_the_reference():
    import torch

    import tensorframes_tpu as tfs
    import tensorframes_tpu_torch as tft
    from tensorframes_tpu.models import moe as jmoe
    from tensorframes_tpu_torch.models import moe

    jcfg = jmoe.MoEConfig(hidden=16, mlp_hidden=32, num_experts=4)
    cfg = moe.MoEConfig(hidden=16, mlp_hidden=32, num_experts=4)
    jp = jmoe.init_moe_params(jcfg, seed=0)
    p = moe.moe_params_from_jax({k: np.asarray(v) for k, v in jp.items()}, device="cpu")
    x = np.random.default_rng(0).standard_normal((12, 16)).astype(np.float32)
    ref = tfs.map_blocks(lambda features: jmoe.scoring_program(jcfg, jp)(features),
                         tfs.frame_from_arrays({"features": x}, num_blocks=2))
    got = tft.map_blocks(moe.scoring_program(cfg, p),
                         tft.frame_from_arrays({"features": x}, num_blocks=2), device="cpu")
    want = np.stack([r["moe_out"] for r in ref.collect()])
    mine = np.stack([r["moe_out"] for r in got.collect()])
    _close(mine, want, F32_RTOL, "scoring")
    # block semantics: each block routed alone
    direct = np.concatenate([moe.moe_ffn(cfg, p, torch.from_numpy(x[i:i + 6])).numpy()
                             for i in (0, 6)])
    np.testing.assert_array_equal(mine, direct)



def test_new_entry_points_need_a_gpu_or_the_cpu_asked_for(monkeypatch, inputs):
    """The MoE's constructors and the shard cutters default to the card
    and raise without one; ``device="cpu"`` runs them here."""
    import torch

    from tensorframes_tpu_torch.models import moe
    from tensorframes_tpu_torch.models import transformer as tr
    from tensorframes_tpu_torch.parallel.mesh import Mesh, PartitionSpec as P, shard_tensor
    from tensorframes_tpu_torch.parallel.pipeline import shard_stage_params

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    one = Mesh([1], ["dp"], [0])
    cfg = _moe_cfg(moe)
    for call in (lambda: moe.init_moe_params(cfg),
                 lambda: moe.moe_params_from_jax(inputs["moe_params"]),
                 lambda: shard_tensor(np.zeros((2, 2), np.float32), P("dp"), one),
                 lambda: tr.shard_params(tr.tiny(), inputs["tr_params"], one),
                 lambda: shard_stage_params(_stack(1, 8, 0), Mesh([1], ["pp"], [0]))):
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            call()
    assert moe.init_moe_params(cfg, device="cpu")["w_in"].device.type == "cpu"
    assert shard_tensor(np.zeros((2, 2), np.float32), P("dp"), one,
                        device="cpu").device.type == "cpu"

# --- the pipeline -------------------------------------------------------------

def _jax_stage(p, h):
    import jax.numpy as jnp

    return jnp.tanh(h @ p["w"] + p["b"])


def _jax_pipeline(case, inputs):
    import jax
    import jax.numpy as jnp

    from tensorframes_tpu.parallel import pipeline_apply as jpipe

    axes, _, _, _, _, n_micro = PIPE_CASES[case]
    params = {k: jnp.asarray(v) for k, v in inputs[f"pipe_params_{case}"].items()}
    mesh = _jmesh(axes)
    fn = jax.jit(lambda p, x: jpipe(_jax_stage, p, x, mesh, axis="pp",
                                    num_microbatches=n_micro))
    return np.asarray(fn(params, jnp.asarray(inputs[f"pipe_x_{case}"])))


def _sequential(params, x):
    h = x
    for s in range(params["w"].shape[0]):
        h = np.tanh(h @ params["w"][s] + params["b"][s])
    return h


@pytest.mark.parametrize("case", sorted(PIPE_CASES))
def test_pipeline_matches_the_reference_and_the_sequential_stages(runs, inputs, case):
    ranks = runs(8 if "dp" in PIPE_CASES[case][0] else 4)
    got = ranks[0][f"pipe_{case}"]
    _close(got, _jax_pipeline(case, inputs), F32_RTOL, case)
    _close(got, _sequential(inputs[f"pipe_params_{case}"], inputs[f"pipe_x_{case}"]), 1e-5,
           case)
    np.testing.assert_array_equal(ranks[0][f"pipe_whole_{case}"], got)
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[f"pipe_{case}"], got)


def test_pipeline_error_texts_are_the_references(world8, inputs):
    import jax.numpy as jnp

    from tensorframes_tpu.parallel import pipeline_apply as jpipe

    mesh = _jmesh({"pp": 4, "dp": 2})
    params = {k: jnp.asarray(v) for k, v in inputs["pipe_params_pp4_dp2"].items()}
    with pytest.raises(ValueError, match="not divisible"):
        jpipe(_jax_stage, params, jnp.zeros((10, 8)), mesh, num_microbatches=4)
    assert "not divisible by 4 microbatches" in world8[0]["err_pipe_batch"]
    eight = {k: jnp.asarray(v) for k, v in _stack(8, 8, 0).items()}
    with pytest.raises(ValueError, match="num_stages") as ref:
        jpipe(_jax_stage, eight, jnp.zeros((16, 8)), mesh)
    got = world8[0]["err_pipe_stages"]
    assert "num_stages=4" in got and "leading dim 8" in got
    assert str(ref.value).split("has leading")[1] == got.split("has leading")[1]


def _jax_pp_grads(inputs):
    import jax
    import jax.numpy as jnp

    p = {k: jnp.asarray(v) for k, v in inputs["pipe_train_params"].items()}
    x, t = jnp.asarray(inputs["pipe_train_x"]), jnp.asarray(inputs["pipe_train_t"])

    def loss(p):
        h = x
        for s in range(4):
            h = _jax_stage({k: v[s] for k, v in p.items()}, h)
        return jnp.mean((h - t) ** 2)

    return jax.jit(jax.value_and_grad(loss))(p)


def test_pp_train_step_gradients_and_sgd_update_match_the_reference(world, inputs):
    w, ranks = world
    loss, grads = _jax_pp_grads(inputs)
    got = ranks[0]["pp_sgd"]
    assert all(r["pp_sgd"]["loss"] == got["loss"] for r in ranks)
    assert abs(got["loss"] - float(loss)) <= LOSS_F32_ATOL
    for k, g in grads.items():
        g = np.asarray(g)
        _close(got["grads"][k], g, GRAD_F32_RTOL, f"grad {k}")
        _sgd_close(got["new"][k], inputs["pipe_train_params"][k], g, GRAD_F32_RTOL, k)
    assert got["specs"] == {"w": ("pp",), "b": ("pp",)}


def test_pp_train_step_learns(world):
    w, ranks = world
    losses = ranks[0]["pp_adam_losses"]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses


def test_collectives_counted_their_bytes(world):
    w, ranks = world
    kinds = ("permute", "all_to_all", "all_reduce") + (("all_gather",) if w == 8 else ())
    for r in ranks:
        assert all(r["collective_bytes"][k] > 0 for k in kinds), r["collective_bytes"]
    # the pipeline's output leaves its last stage alone: ranks 4-7 on the
    # meshes pp 4 x dp 2 and pp 2 x dp 4, rank 3 on pp 4
    assert sum(r["collective_bytes"]["broadcast"] > 0 for r in ranks) == {8: 4, 4: 1}[w]


if __name__ == "__main__" and sys.argv[1:2] == ["--rank"]:
    sys.exit(_rank_main(sys.argv[2:]))
