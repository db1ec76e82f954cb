"""The port's sharded frame across ranks, against the JAX package.

Each world size (2 and 4 ranks) runs ONCE per module: gloo ranks on the
CPU, each a child process running this file as a script (``--rank``),
its inputs drawn from a seed with numpy and written by the test, its
results pickled for the many small tests below. Every result is held
against the JAX package on the same whole data: a CPU mesh of its 8
virtual devices through ``to_device()`` for the keyed aggregates, its
single-process verbs for the rest. Integer sums, min/max, counts, keys, row placement,
schemas and error texts compare exactly; float sums and means within
the tolerances written once below.
"""

from __future__ import annotations

import os
import pickle
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
WORLDS = (2, 4)
CHILD_TIMEOUT_S = 180
N_ROWS = 1203        # not a multiple of 2 or 4: to_device keeps a host tail
N_KEYS = 37          # k spans -12..24
F32_SUM_RTOL = 1e-5  # a float32 keyed sum or mean: ranks add in another order
F32_SUM_ATOL = 1e-4
LSE_RTOL = 1e-5      # the generic logsumexp fetch


def make_data(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    n = N_ROWS
    lens = rng.integers(1, 9, n)
    return {
        "k": (rng.integers(0, N_KEYS, n) - 12).astype(np.int32),
        "v": rng.standard_normal((n, 3)).astype(np.float32),
        "w": rng.integers(-1000, 1000, n).astype(np.int32),
        "c": rng.integers(0, 5, n).astype(np.int64),
        "s": np.asarray([f"key{int(i)}" for i in rng.integers(0, 19, n)], dtype=object),
        "r": [rng.standard_normal(int(m)).astype(np.float32) for m in lens],
        "rk": np.arange(N_KEYS, dtype=np.int32) - 12,   # the right side of the joins
        "rv": rng.integers(0, 100, N_KEYS).astype(np.int64),
    }


def bounds(n: int, world: int) -> list:
    """Uneven row splits: rank r gets rows [b[r], b[r + 1])."""
    cuts = [0] + [int(n * (r + 1) // world + (r * 7) % 5) for r in range(world - 1)] + [n]
    return cuts


# ---------------------------------------------------------------------------
# the rank (run as a script)
# ---------------------------------------------------------------------------

def _text(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the text is the result
        return f"{type(e).__name__}: {e}"
    return None


def rank_ops(tft, data: dict, rank: int, world: int, work: str) -> dict:
    from tensorframes_tpu_torch import dsl, io
    from tensorframes_tpu_torch.ops import exchange
    from tensorframes_tpu_torch.parallel import frame_from_process_local, make_mesh

    b = bounds(N_ROWS, world)
    lo, hi = b[rank], b[rank + 1]
    local = {n: data[n][lo:hi] for n in ("k", "v", "w", "c", "s")}
    local["s"] = list(local["s"])
    fr = frame_from_process_local(local)
    out = {"num_rows": fr.num_rows, "local_rows": hi - lo, "_work": work,
           "mesh": (dict(fr.mesh.shape), fr.mesh.devices.reshape(-1).tolist())}

    def agg(frame, keys, fetches):
        res = frame.group_by(*keys).aggregate(fetches)
        return {n: np.asarray(res.column_values(n)) if n not in ("s",)
                else list(res.column_values(n)) for n in res.schema.names}

    with dsl.with_graph():
        vi = dsl.block(fr, "v", tf_name="v_input")
        wi = dsl.block(fr, "w", tf_name="w_input")
        fetch_sum = [dsl.reduce_sum(vi, axis=0, name="v"), dsl.reduce_sum(wi, axis=0, name="w")]
    with dsl.with_graph():
        vi = dsl.block(fr, "v", tf_name="v_input")
        fetch_mean = dsl.reduce_mean(vi, axis=0, name="v")
    with dsl.with_graph():
        vi = dsl.block(fr, "v", tf_name="v_input")
        wi = dsl.block(fr, "w", tf_name="w_input")
        fetch_minmax = [dsl.reduce_min(vi, axis=0, name="v"), dsl.reduce_max(wi, axis=0, name="w")]
    out["agg_sum"] = agg(fr, ["k"], fetch_sum)
    out["schema_sum"] = [(c.name, c.dtype.name) for c in
                         fr.group_by("k").aggregate(fetch_sum).schema]
    out["agg_mean"] = agg(fr, ["k"], fetch_mean)
    out["agg_minmax"] = agg(fr, ["k"], fetch_minmax)
    out["agg_two_keys"] = agg(fr, ["k", "c"], fetch_sum)
    out["agg_strings"] = agg(fr, ["s"], fetch_sum)
    out["agg_strings_mean"] = agg(fr, ["s"], fetch_mean)
    cnt = fr.group_by("k").count()
    out["count"] = {n: cnt.column_values(n) for n in ("k", "count")}

    def lse_fn(v_input, w_input):
        import torch

        return {"v": torch.logsumexp(v_input, dim=0), "w": w_input.sum(0, dtype=w_input.dtype)}

    out["agg_generic"] = agg(fr, ["k"], lse_fn)
    out["agg_generic_strings"] = agg(fr, ["s"], lse_fn)

    mapped = fr.map_blocks(lambda v, w: {"z": v * 2.0 + 1.0, "u": w * 3})
    with dsl.with_graph():
        zi = dsl.block(mapped, "z", tf_name="z_input")
        ui = dsl.block(mapped, "u", tf_name="u_input")
        fetch = [dsl.reduce_sum(zi, axis=0, name="z"), dsl.reduce_max(ui, axis=0, name="u")]
    out["map_then_agg"] = agg(mapped, ["k"], fetch)
    out["map_is_sharded"] = mapped.is_sharded
    # a projection of a pending sharded frame stays sharded
    pending = fr.map_blocks(lambda w: {"w2": w + 0}).select(["k", "w2"])
    out["select_pending_sharded"] = pending.is_sharded
    with dsl.with_graph():
        fetch = dsl.reduce_sum(dsl.block(pending, "w2", tf_name="w2_input"), axis=0, name="w2")
    out["select_pending_agg"] = agg(pending, ["k"], fetch)

    with dsl.with_graph():
        vi = dsl.block(fr, "v", tf_name="v_input")
        wi = dsl.block(fr, "w", tf_name="w_input")
        rb = [dsl.reduce_sum(vi, axis=0, name="v"), dsl.reduce_min(wi, axis=0, name="w")]
    out["reduce_blocks"] = fr.reduce_blocks(rb)
    with dsl.with_graph():
        w1 = dsl.placeholder(np.int32, (), name="w_1")
        w2 = dsl.placeholder(np.int32, (), name="w_2")
        rr = dsl.add(w1, w2, name="w")
    out["reduce_rows"] = fr.reduce_rows(rr)

    # repartition_by_key: this rank's rows afterwards
    rp = fr.repartition_by_key("k")
    out["repartition"] = {n: (list(rp.column_values(n)) if n == "s" else rp.column_values(n))
                          for n in ("k", "w", "s")}
    out["repartition_sharded"] = rp.is_sharded

    # joins: a process-local right side (this rank's slice of it)
    rb_ = bounds(N_KEYS, world)
    right = frame_from_process_local({"k": data["rk"][rb_[rank]:rb_[rank + 1]],
                                      "rv": data["rv"][rb_[rank]:rb_[rank + 1]]})
    for name, budget in (("join_broadcast", 64 << 20), ("join_exchange", 0)):
        tft.configure(relational_broadcast_bytes=budget)
        j = fr.select(["k", "w", "s"]).join(right, on="k")
        jb = j.blocks()[0]
        out[name] = {n: (list(jb[n]) if isinstance(jb[n], list) else np.asarray(jb[n]))
                     for n in j.schema.names}
        out[name + "_stats"] = dict(exchange.last_exchange_stats or {})
    tft.configure(relational_broadcast_bytes=0)
    j = fr.select(["k", "w"]).join(right, on="k", how="outer", fill_value=-1)
    out["join_outer"] = {n: np.asarray(j.column_values(n)) for n in j.schema.names}

    # sort_values: over the budget (the range exchange), then under it
    tft.configure(relational_broadcast_bytes=0)
    srt = fr.select(["k", "w", "c"]).sort_values(["k", "w"], ascending=[True, False])
    out["sort_exchange"] = {n: srt.column_values(n) for n in ("k", "w", "c")}
    tft.configure(relational_broadcast_bytes=64 << 20)
    srt = fr.select(["k", "w", "c"]).sort_values("c")
    out["sort_replicated"] = {n: srt.column_values(n) for n in ("k", "w", "c")}

    dd = fr.select(["k", "c", "s"]).drop_duplicates(["k", "c"])
    out["drop_duplicates"] = {n: (list(dd.column_values(n)) if n == "s" else dd.column_values(n))
                              for n in ("k", "c", "s")}

    # map_rows over process-local ragged cells
    rag = frame_from_process_local({"w": data["w"][lo:hi], "r": data["r"][lo:hi]})
    mr = rag.map_rows(lambda r: {"rs": r.sum() * 2.0})
    out["map_rows_ragged"] = np.asarray(mr.to_host().column_values("rs"))
    out["ragged_local"] = "r" in rag._process_local_cols

    # sharded save / load
    path = os.path.join(work, f"saved_w{world}")
    part = io.save_frame_sharded(fr.select(["k", "v", "w"]), path)
    back = io.load_frame_sharded(path)
    out["save_part"] = os.path.basename(part)
    out["loaded"] = {n: back.to_host().column_values(n) for n in ("k", "v", "w")}
    out["loaded_rows"] = back.num_rows
    out["save_strings_error"] = None
    path_s = os.path.join(work, f"saved_s_w{world}")
    io.save_frame_sharded(fr.select(["k", "s"]), path_s)
    out["load_strings_error"] = _text(lambda: io.load_frame_sharded(path_s))

    # to_device of the whole frame on every rank (a host tail remains)
    whole = tft.frame_from_arrays({n: data[n] for n in ("k", "v", "w")})
    td = whole.to_device()
    out["to_device_blocks"] = [len(bl["k"]) for bl in td.blocks()]
    out["to_device_agg"] = agg(td, ["k"], fetch_sum)
    out["to_device_mean"] = agg(td, ["k"], fetch_mean)
    out["to_device_reduce_blocks"] = td.reduce_blocks(rb)
    out["to_host"] = td.to_host().column_values("w")

    # the reference's error texts
    out["err_process_local"] = _text(lambda: fr.column_values("s"))
    out["err_spans"] = _text(lambda: fr.column_values("k"))
    out["err_collect"] = _text(lambda: fr.collect())
    out["err_limit"] = _text(lambda: fr.limit(3).blocks())
    out["err_sort_disabled"] = None
    tft.configure(relational_broadcast_bytes=0, relational_exchange=False)
    out["err_sort_disabled"] = _text(lambda: fr.select(["k"]).sort_values("k").blocks())
    tft.configure(relational_broadcast_bytes=64 << 20, relational_exchange=True)
    mesh_bad = _text(lambda: make_mesh({"dp": world + 1}))
    out["err_mesh"] = mesh_bad

    # the last rank holds no rows
    eb = [N_ROWS * r // (world - 1) for r in range(world)] + [N_ROWS]
    elo, ehi = eb[rank], eb[rank + 1]
    efr = frame_from_process_local({n: (list(data[n][elo:ehi]) if n == "s" else data[n][elo:ehi])
                                    for n in ("k", "v", "w", "c", "s")})
    out["empty_rank_rows"] = (ehi - elo, efr.num_rows)
    out["empty_rank_agg_sum"] = agg(efr, ["k"], fetch_sum)
    out["empty_rank_agg_mean"] = agg(efr, ["k"], fetch_mean)
    out["empty_rank_strings"] = agg(efr, ["s"], fetch_sum)
    out["empty_rank_generic"] = agg(efr, ["k"], lse_fn)
    out["empty_rank_reduce_blocks"] = efr.reduce_blocks(rb)
    tft.configure(relational_broadcast_bytes=0)
    srt = efr.select(["k", "w", "c"]).sort_values(["k", "w"], ascending=[True, False])
    out["empty_rank_sort"] = {n: srt.column_values(n) for n in ("k", "w", "c")}
    tft.configure(relational_broadcast_bytes=64 << 20)
    return out


# ---------------------------------------------------------------------------
# the test side
# ---------------------------------------------------------------------------

def _free_port() -> int:
    sock = socket.socket()
    sock.bind(("localhost", 0))
    port = sock.getsockname()[1]
    sock.close()
    return port


def run_world(world: int, work: Path) -> list:
    """Launch ``world`` gloo ranks of this file once; each child has its own
    time limit. Returns every rank's pickled results, in rank order."""
    work.mkdir(parents=True, exist_ok=True)
    inp = work / "in.pkl"
    with open(inp, "wb") as f:
        pickle.dump(make_data(), f)
    port = str(_free_port())
    env = dict(os.environ, PYTHONPATH=str(ROOT))
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


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"ranks{w}")
def world(request, tmp_path_factory):
    w = request.param
    return w, run_world(w, tmp_path_factory.mktemp(f"ranks{w}"))


@pytest.fixture(scope="module")
def ref():
    """The JAX package on the whole data: its CPU mesh through
    ``to_device()`` for the keyed aggregates and reduces, its
    single-process verbs for the rest."""
    import jax
    import jax.numpy as jnp
    import tensorframes_tpu as tfs

    assert len(jax.devices()) >= 8
    d = make_data()
    from tensorframes_tpu.parallel import make_mesh

    whole = tfs.frame_from_arrays({"k": d["k"], "v": d["v"], "w": d["w"], "c": d["c"],
                                   "s": list(d["s"])})
    # 3 of the 8 devices: 1,203 rows split with no host tail. The
    # reference's dense plan fails on a tail (its np.add.at writes into a
    # read-only view of a device table), so its legs run tail-free.
    sh = whole.to_device(make_mesh({"dp": 3}, devices=jax.devices()[:3]))
    out = {"mesh_devices": len(jax.devices())}

    def agg(frame, keys, fetches):
        res = frame.group_by(*keys).aggregate(fetches)
        return {n: (list(res.column_values(n)) if n == "s" else np.asarray(res.column_values(n)))
                for n in res.schema.names}

    with tfs.with_graph():
        vi = tfs.block(sh, "v", tf_name="v_input")
        wi = tfs.block(sh, "w", tf_name="w_input")
        fetch_sum = [tfs.reduce_sum(vi, axis=0, name="v"), tfs.reduce_sum(wi, axis=0, name="w")]
    with tfs.with_graph():
        vi = tfs.block(sh, "v", tf_name="v_input")
        fetch_mean = tfs.reduce_mean(vi, axis=0, name="v")
    with tfs.with_graph():
        vi = tfs.block(sh, "v", tf_name="v_input")
        wi = tfs.block(sh, "w", tf_name="w_input")
        fetch_minmax = [tfs.reduce_min(vi, axis=0, name="v"), tfs.reduce_max(wi, axis=0, name="w")]
    out["agg_sum"] = agg(sh, ["k"], fetch_sum)
    out["agg_mean"] = agg(sh, ["k"], fetch_mean)
    out["agg_minmax"] = agg(sh, ["k"], fetch_minmax)
    out["agg_two_keys"] = agg(sh, ["k", "c"], fetch_sum)
    out["agg_strings"] = agg(sh, ["s"], fetch_sum)
    out["agg_strings_mean"] = agg(sh, ["s"], fetch_mean)
    cnt = sh.group_by("k").count()
    out["count"] = {n: np.asarray(cnt.column_values(n)) for n in ("k", "count")}

    def lse_fn(v_input, w_input):
        return {"v": jax.nn.logsumexp(v_input, axis=0), "w": w_input.sum(0, dtype=w_input.dtype)}

    out["agg_generic"] = agg(sh, ["k"], lse_fn)
    out["agg_generic_strings"] = agg(sh, ["s"], lse_fn)
    mapped = sh.map_blocks(lambda v, w: {"z": v * 2.0 + 1.0, "u": w * 3})
    with tfs.with_graph():
        zi = tfs.block(mapped, "z", tf_name="z_input")
        ui = tfs.block(mapped, "u", tf_name="u_input")
        fetch = [tfs.reduce_sum(zi, axis=0, name="z"), tfs.reduce_max(ui, axis=0, name="u")]
    out["map_then_agg"] = agg(mapped, ["k"], fetch)
    with tfs.with_graph():
        vi = tfs.block(sh, "v", tf_name="v_input")
        wi = tfs.block(sh, "w", tf_name="w_input")
        rb = [tfs.reduce_sum(vi, axis=0, name="v"), tfs.reduce_min(wi, axis=0, name="w")]
    out["reduce_blocks"] = sh.reduce_blocks(rb)
    with tfs.with_graph():
        w1 = tfs.placeholder(np.int32, (), name="w_1")
        w2 = tfs.placeholder(np.int32, (), name="w_2")
        rr = tfs.add(w1, w2, name="w")
    out["reduce_rows"] = sh.reduce_rows(rr)
    right = tfs.frame_from_arrays({"k": d["rk"], "rv": d["rv"]})
    j = whole.select(["k", "w", "s"]).join(right, on="k")
    out["join"] = {n: (list(j.column_values(n)) if n == "s" else np.asarray(j.column_values(n)))
                   for n in j.schema.names}
    j = whole.select(["k", "w"]).join(right, on="k", how="outer", fill_value=-1)
    out["join_outer"] = {n: np.asarray(j.column_values(n)) for n in j.schema.names}
    srt = whole.select(["k", "w", "c"]).sort_values(["k", "w"], ascending=[True, False])
    out["sort_exchange"] = {n: np.asarray(srt.column_values(n)) for n in ("k", "w", "c")}
    srt = whole.select(["k", "w", "c"]).sort_values("c")
    out["sort_replicated"] = {n: np.asarray(srt.column_values(n)) for n in ("k", "w", "c")}
    dd = whole.select(["k", "c", "s"]).drop_duplicates(["k", "c"])
    out["drop_duplicates"] = {n: (list(dd.column_values(n)) if n == "s" else np.asarray(dd.column_values(n)))
                              for n in ("k", "c", "s")}
    rag = tfs.frame_from_arrays({"w": d["w"], "r": d["r"]})
    out["map_rows_ragged"] = np.asarray(
        rag.map_rows(lambda r: {"rs": r.sum() * 2.0}).column_values("rs"))
    out["schema_sum"] = [(c.name, c.dtype.name) for c in
                         sh.group_by("k").aggregate(fetch_sum).schema]
    return out


def _rows(table: dict, names) -> list:
    """A table's rows as sortable tuples (a multiset comparison)."""
    cols = [list(np.asarray(table[n], dtype=object).tolist()) if not isinstance(table[n], list)
            else list(table[n]) for n in names]
    return sorted(zip(*cols), key=repr)


def _union(ranks: list, key: str, names) -> dict:
    out = {}
    for n in names:
        parts = [r[key][n] for r in ranks]
        out[n] = (sum((list(p) for p in parts), []) if isinstance(parts[0], list)
                  else np.concatenate([np.asarray(p) for p in parts]))
    return out


def _same_keys_ints_floats(got: dict, want: dict, floats=(), ints=(), keys=()):
    for k in keys:
        if isinstance(want[k], list):
            assert list(got[k]) == list(want[k]), k
        else:
            np.testing.assert_array_equal(np.asarray(got[k]), want[k], err_msg=k)
            assert np.asarray(got[k]).dtype == want[k].dtype, k
    for x in ints:
        np.testing.assert_array_equal(np.asarray(got[x]), want[x], err_msg=x)
        assert np.asarray(got[x]).dtype == want[x].dtype, x
    for x in floats:
        np.testing.assert_allclose(np.asarray(got[x]), want[x], rtol=F32_SUM_RTOL,
                                   atol=F32_SUM_ATOL, err_msg=x)
        assert np.asarray(got[x]).dtype == want[x].dtype, x


def test_global_rows_and_mesh(world):
    w, ranks = world
    for r, res in enumerate(ranks):
        assert res["num_rows"] == N_ROWS
        assert res["mesh"] == ({"dp": w}, list(range(w)))
    assert sum(res["local_rows"] for res in ranks) == N_ROWS


@pytest.mark.parametrize("case,floats,ints,keys", [
    ("agg_sum", ("v",), ("w",), ("k",)),
    ("agg_mean", ("v",), (), ("k",)),
    ("agg_minmax", (), ("v", "w"), ("k",)),
    ("agg_two_keys", ("v",), ("w",), ("k", "c")),
    ("map_then_agg", ("z",), ("u",), ("k",)),
])
def test_dense_span_aggregate(world, ref, case, floats, ints, keys):
    _, ranks = world
    for res in ranks:  # replicated: every rank holds the whole result
        _same_keys_ints_floats(res[case], ref[case], floats, ints, keys)


@pytest.mark.parametrize("case,floats,ints", [
    ("agg_strings", ("v",), ("w",)),
    ("agg_strings_mean", ("v",), ()),
])
def test_dictionary_plan_aggregate(world, ref, case, floats, ints):
    _, ranks = world
    for res in ranks:
        _same_keys_ints_floats(res[case], ref[case], floats, ints, ("s",))


@pytest.mark.parametrize("case,key", [("agg_generic", "k"), ("agg_generic_strings", "s")])
def test_generic_aggregate(world, ref, case, key):
    _, ranks = world
    for res in ranks:
        got, want = res[case], ref[case]
        if key == "s":
            assert list(got["s"]) == list(want["s"])
        else:
            np.testing.assert_array_equal(got["k"], want["k"])
        np.testing.assert_array_equal(got["w"], want["w"])
        np.testing.assert_allclose(got["v"], want["v"], rtol=LSE_RTOL)


def test_count(world, ref):
    _, ranks = world
    for res in ranks:
        _same_keys_ints_floats(res["count"], ref["count"], (), ("count",), ("k",))


def test_ranks_agree_bit_for_bit(world):
    _, ranks = world
    for case in ("agg_sum", "agg_mean", "agg_strings", "agg_generic", "reduce_blocks"):
        first = pickle.dumps(ranks[0][case])
        assert all(pickle.dumps(r[case]) == first for r in ranks[1:]), case


@pytest.mark.parametrize("case,ref_case,floats,ints,keys", [
    ("empty_rank_agg_sum", "agg_sum", ("v",), ("w",), ("k",)),
    ("empty_rank_agg_mean", "agg_mean", ("v",), (), ("k",)),
    ("empty_rank_strings", "agg_strings", ("v",), ("w",), ("s",)),
])
def test_a_rank_without_rows_aggregates(world, ref, case, ref_case, floats, ints, keys):
    _, ranks = world
    assert ranks[-1]["empty_rank_rows"] == (0, N_ROWS)
    for res in ranks:
        _same_keys_ints_floats(res[case], ref[ref_case], floats, ints, keys)


def test_a_rank_without_rows_reduces_and_sorts(world, ref):
    _, ranks = world
    for res in ranks:
        got = res["empty_rank_generic"]
        np.testing.assert_array_equal(got["k"], ref["agg_generic"]["k"])
        np.testing.assert_array_equal(got["w"], ref["agg_generic"]["w"])
        np.testing.assert_allclose(got["v"], ref["agg_generic"]["v"], rtol=LSE_RTOL)
        v, w = res["empty_rank_reduce_blocks"]
        np.testing.assert_allclose(v, ref["reduce_blocks"][0], rtol=F32_SUM_RTOL, atol=F32_SUM_ATOL)
        assert w == ref["reduce_blocks"][1]
    got = _union(ranks, "empty_rank_sort", ("k", "w", "c"))
    for n in ("k", "w", "c"):
        np.testing.assert_array_equal(got[n], ref["sort_exchange"][n])


def test_pending_select_keeps_the_layout(world, ref):
    _, ranks = world
    for res in ranks:
        assert res["select_pending_sharded"]
        np.testing.assert_array_equal(res["select_pending_agg"]["k"], ref["agg_sum"]["k"])
        np.testing.assert_array_equal(res["select_pending_agg"]["w2"], ref["agg_sum"]["w"])


def test_reduce_blocks_and_rows(world, ref):
    _, ranks = world
    for res in ranks:
        v, w = res["reduce_blocks"]
        np.testing.assert_allclose(v, ref["reduce_blocks"][0], rtol=F32_SUM_RTOL, atol=F32_SUM_ATOL)
        assert w == ref["reduce_blocks"][1]
        assert res["reduce_rows"] == ref["reduce_rows"]
        assert res["map_is_sharded"]


def test_repartition_by_key_places_rows_by_the_references_hash(world):
    from tensorframes_tpu.ops.exchange import partition_by_hash

    w, ranks = world
    d = make_data()
    b = bounds(N_ROWS, w)
    parts = [partition_by_hash([d["k"][b[r]:b[r + 1]]], w) for r in range(w)]
    for p, res in enumerate(ranks):
        sel = [np.flatnonzero(parts[r] == p) + b[r] for r in range(w)]
        idx = np.concatenate(sel)  # (source rank, local order)
        got = res["repartition"]
        np.testing.assert_array_equal(got["k"], d["k"][idx])
        np.testing.assert_array_equal(got["w"], d["w"][idx])
        assert list(got["s"]) == list(d["s"][idx])
        assert not res["repartition_sharded"]


@pytest.mark.parametrize("case", ["join_broadcast", "join_exchange"])
def test_inner_join_union(world, ref, case):
    _, ranks = world
    names = list(ref["join"])
    assert list(ranks[0][case]) == names
    got = _union(ranks, case, names)
    assert _rows(got, names) == _rows(ref["join"], names)


def test_join_exchange_went_through_all_to_all(world):
    _, ranks = world
    for res in ranks:
        st = res["join_exchange_stats"]
        assert st["transport"] == "all_to_all_single"
        assert len(st["sent"]) == len(ranks) and st["rounds"] >= 1


def test_outer_join_union(world, ref):
    _, ranks = world
    names = list(ref["join_outer"])
    got = _union(ranks, "join_outer", names)
    assert _rows(got, names) == _rows(ref["join_outer"], names)


def test_sort_range_exchange_in_rank_order_is_the_global_sort(world, ref):
    _, ranks = world
    got = _union(ranks, "sort_exchange", ("k", "w", "c"))
    for n in ("k", "w", "c"):
        np.testing.assert_array_equal(got[n], ref["sort_exchange"][n], err_msg=n)


def test_sort_under_budget_is_replicated(world, ref):
    _, ranks = world
    for res in ranks:
        for n in ("k", "w", "c"):
            np.testing.assert_array_equal(res["sort_replicated"][n], ref["sort_replicated"][n])


def test_drop_duplicates_union(world, ref):
    _, ranks = world
    names = ("k", "c", "s")
    got = _union(ranks, "drop_duplicates", names)
    assert _rows(got, names) == _rows(ref["drop_duplicates"], names)


def test_map_rows_over_process_local_ragged_cells(world, ref):
    _, ranks = world
    got = np.concatenate([r["map_rows_ragged"] for r in ranks])
    np.testing.assert_allclose(got, ref["map_rows_ragged"], rtol=F32_SUM_RTOL, atol=1e-5)
    assert all(r["ragged_local"] for r in ranks)


def test_sharded_save_load_round_trip(world):
    w, ranks = world
    d = make_data()
    b = bounds(N_ROWS, w)
    for r, res in enumerate(ranks):
        assert res["save_part"] == f"part-{r}"
        assert res["loaded_rows"] == N_ROWS
        for n in ("k", "v", "w"):
            np.testing.assert_array_equal(res["loaded"][n], d[n][b[r]:b[r + 1]])


def test_sharded_parts_read_by_the_reference(world):
    """Each ``part-<rank>`` is a frame in the JAX package's format: its
    ``load_frame`` reads the rank's rows, and ``parts.json`` names the
    world."""
    import json

    from tensorframes_tpu import io as ref_io

    w, ranks = world
    d = make_data()
    b = bounds(N_ROWS, w)
    path = Path(ranks[0]["_work"]) / f"saved_w{w}"
    assert json.loads((path / "parts.json").read_text()) == {"num_parts": w}
    for r in range(w):
        part = ref_io.load_frame(str(path / f"part-{r}"), num_blocks=1)
        for n in ("k", "v", "w"):
            np.testing.assert_array_equal(part.column_values(n), d[n][b[r]:b[r + 1]])


def test_sharded_load_refuses_host_columns_with_the_references_text(world, monkeypatch):
    import jax

    from tensorframes_tpu import io as ref_io

    w, ranks = world
    # the reference reads the port's parts (one format) as rank 0 of w
    path = Path(ranks[0]["_work"]) / f"saved_s_w{w}"
    monkeypatch.setattr(jax, "process_count", lambda: w)
    monkeypatch.setattr(jax, "process_index", lambda: 0)
    want = _text(lambda: ref_io.load_frame_sharded(str(path)))
    assert want is not None and want.startswith("TypeError")
    assert all(r["load_strings_error"] == want for r in ranks)


def test_to_device_keeps_the_references_split_and_tail(world, ref):
    w, ranks = world
    n_main = (N_ROWS // w) * w
    for res in ranks:
        assert res["to_device_blocks"] == [n_main // w, N_ROWS - n_main]
        _same_keys_ints_floats(res["to_device_agg"], ref["agg_sum"], ("v",), ("w",), ("k",))
        _same_keys_ints_floats(res["to_device_mean"], ref["agg_mean"], ("v",), (), ("k",))
        v, wmin = res["to_device_reduce_blocks"]
        np.testing.assert_allclose(v, ref["reduce_blocks"][0], rtol=F32_SUM_RTOL, atol=F32_SUM_ATOL)
        assert wmin == ref["reduce_blocks"][1]


def test_to_host_union_is_the_frame(world):
    _, ranks = world
    got = np.concatenate([r["to_host"] for r in ranks])
    np.testing.assert_array_equal(np.sort(got), np.sort(make_data()["w"]))


def _ref_frame_texts():
    """The reference's own error texts, raised by its code."""
    import tensorframes_tpu as tfs
    from tensorframes_tpu.schema import Schema

    class Spanning:
        is_fully_addressable = False

        def __len__(self):
            return 4

    f = tfs.frame_from_arrays({"k": np.arange(4, dtype=np.int32), "s": ["a", "b", "c", "d"]})
    sch = f.schema
    spanning = tfs.TensorFrame([{"k": Spanning(), "s": ["a", "b", "c", "d"]}], Schema(list(sch)))
    return f, spanning


def test_error_texts_are_the_references(world, monkeypatch):
    import jax

    w, ranks = world
    f, spanning = _ref_frame_texts()
    monkeypatch.setattr(jax, "process_count", lambda: w)
    f._process_local_cols = frozenset({"s"})
    want_local = _text(lambda: f.column_values("s"))
    want_spans = _text(lambda: spanning.column_values("k"))
    want_limit = _text(lambda: spanning.limit(3).blocks())
    for res in ranks:
        assert res["err_process_local"] == want_local
        assert res["err_spans"] == want_spans
        assert res["err_collect"] == want_spans
        assert res["err_limit"] == want_limit


def test_disabled_exchange_error_is_the_references(world, monkeypatch):
    import jax
    import tensorframes_tpu as tfs

    from tensorframes_tpu.ops import device_agg as ref_agg
    from tensorframes_tpu.ops import exchange as ref_xch

    w, ranks = world
    d = make_data()
    sh = tfs.frame_from_arrays({"k": d["k"]}).to_device()
    # the reference's multi-process sort branch in one process: its vote
    # and its global byte count (the whole frame's, as across ranks) run
    # their single-process forms
    orig_bytes = ref_xch.global_frame_bytes

    def global_bytes(cols):
        with monkeypatch.context() as m:
            m.setattr(jax, "process_count", lambda: 1)
            return orig_bytes(cols)

    monkeypatch.setattr(ref_xch, "global_frame_bytes", global_bytes)
    monkeypatch.setattr(ref_agg, "uniform_ok", lambda ok: bool(ok))
    monkeypatch.setattr(jax, "process_count", lambda: w)
    tfs.configure(relational_broadcast_bytes=0, relational_exchange=False)
    try:
        want = _text(lambda: sh.sort_values("k").blocks())
    finally:
        tfs.configure(relational_broadcast_bytes=64 << 20, relational_exchange=True)
    assert want is not None and "exchange path is disabled" in want
    for res in ranks:
        assert res["err_sort_disabled"] == want


def test_mesh_size_error_is_the_references(world):
    import jax
    from tensorframes_tpu.parallel import make_mesh

    w, ranks = world
    want = _text(lambda: make_mesh({"dp": w + 1}, devices=jax.devices()[:w]))
    for res in ranks:
        assert res["err_mesh"] == want


def test_aggregate_schema_is_the_references(world, ref):
    _, ranks = world
    want = ref["schema_sum"]
    for res in ranks:
        assert res["schema_sum"] == want


# ---------------------------------------------------------------------------
# a world of one, in this process (no process group)
# ---------------------------------------------------------------------------

CPU = {"device": "cpu"}


@pytest.fixture(scope="module")
def one():
    """The port's world of one on the CPU: the whole data through
    ``to_device()`` with no process group (one rank, the caller's device)."""
    import tensorframes_tpu_torch as tft

    old = tft.get_config().device
    tft.configure(device="cpu")
    d = make_data()
    whole = tft.frame_from_arrays({"k": d["k"], "v": d["v"], "w": d["w"], "c": d["c"],
                                   "s": list(d["s"])})
    yield tft, d, whole, whole.to_device()
    tft.configure(device=old)


def _port_agg(tft, frame, keys, kind):
    from tensorframes_tpu_torch import dsl

    with dsl.with_graph():
        vi = dsl.block(frame, "v", tf_name="v_input")
        wi = dsl.block(frame, "w", tf_name="w_input")
        if kind == "sum":
            fetch = [dsl.reduce_sum(vi, axis=0, name="v"), dsl.reduce_sum(wi, axis=0, name="w")]
        elif kind == "mean":
            fetch = dsl.reduce_mean(vi, axis=0, name="v")
        else:
            fetch = [dsl.reduce_min(vi, axis=0, name="v"), dsl.reduce_max(wi, axis=0, name="w")]
    res = frame.group_by(*keys).aggregate(fetch)
    return {n: (list(res.column_values(n)) if n == "s" else np.asarray(res.column_values(n)))
            for n in res.schema.names}


@pytest.mark.parametrize("keys,kind,ref_key", [
    (("k",), "sum", "agg_sum"), (("k",), "mean", "agg_mean"), (("k",), "minmax", "agg_minmax"),
    (("k", "c"), "sum", "agg_two_keys"), (("s",), "sum", "agg_strings"),
    (("s",), "mean", "agg_strings_mean"),
])
def test_world_of_one_aggregate(one, ref, keys, kind, ref_key):
    tft, _, _, sh = one
    got = _port_agg(tft, sh, list(keys), kind)
    want = ref[ref_key]
    floats = [x for x in ("v",) if x in got]
    ints = [x for x in ("w",) if x in got] + (["v"] if kind == "minmax" else [])
    if kind == "minmax":
        floats = []
    _same_keys_ints_floats(got, want, floats, ints, keys)


def test_world_of_one_frame_is_sharded_on_its_device(one):
    import torch

    _, _, whole, sh = one
    assert sh.is_sharded and not whole.is_sharded and whole.mesh is None
    assert sh.mesh.shape == {"dp": 1} and sh.num_blocks == 1 and sh.num_rows == N_ROWS
    main = sh.blocks()[0]
    assert torch.is_tensor(main["k"]) and main["k"].device.type == "cpu"
    assert isinstance(main["s"], list)  # host columns ride along
    assert "sharded over {'dp': 1}" in tft_explain(sh)


def tft_explain(frame):
    from tensorframes_tpu_torch.frame import explain

    return explain(frame, detailed=True)


def test_world_of_one_map_keeps_outputs_on_the_device(one):
    import torch

    _, d, _, sh = one
    m = sh.map_blocks(lambda v: {"z": v * 2.0})
    assert m.is_sharded and torch.is_tensor(m.blocks()[0]["z"])
    np.testing.assert_array_equal(m.column_values("z"), d["v"] * 2.0)
    r = sh.map_rows(lambda w: {"q": w * 2})
    assert torch.is_tensor(r.blocks()[0]["q"])
    np.testing.assert_array_equal(r.column_values("q"), d["w"] * 2)


def test_world_of_one_reduces(one, ref):
    from tensorframes_tpu_torch import dsl

    _, d, _, sh = one
    with dsl.with_graph():
        vi = dsl.block(sh, "v", tf_name="v_input")
        wi = dsl.block(sh, "w", tf_name="w_input")
        rb = [dsl.reduce_sum(vi, axis=0, name="v"), dsl.reduce_min(wi, axis=0, name="w")]
    v, w = sh.reduce_blocks(rb)
    np.testing.assert_allclose(v, ref["reduce_blocks"][0], rtol=F32_SUM_RTOL, atol=F32_SUM_ATOL)
    assert w == ref["reduce_blocks"][1]
    with dsl.with_graph():
        w1 = dsl.placeholder(np.int32, (), name="w_1")
        w2 = dsl.placeholder(np.int32, (), name="w_2")
        assert sh.reduce_rows(dsl.add(w1, w2, name="w")) == ref["reduce_rows"]


def test_world_of_one_generic_aggregate(one, ref):
    import torch

    _, _, _, sh = one

    def lse_fn(v_input, w_input):
        return {"v": torch.logsumexp(v_input, dim=0), "w": w_input.sum(0, dtype=w_input.dtype)}

    res = sh.group_by("k").aggregate(lse_fn)
    np.testing.assert_array_equal(res.column_values("k"), ref["agg_generic"]["k"])
    np.testing.assert_array_equal(res.column_values("w"), ref["agg_generic"]["w"])
    np.testing.assert_allclose(res.column_values("v"), ref["agg_generic"]["v"], rtol=LSE_RTOL)


def test_world_of_one_describe_is_the_host_frames(one):
    from tensorframes_tpu_torch.frame import describe

    _, _, whole, sh = one
    got, want = describe(sh, ["w", "c"], device="cpu"), describe(whole, ["w", "c"], device="cpu")
    # one block against four: the block partials merge in another order
    assert got.keys() == want.keys()
    for c in got:
        assert got[c] == pytest.approx(want[c], rel=1e-12)


def test_world_of_one_count(one, ref):
    _, _, _, sh = one
    cnt = sh.group_by("k").count()
    _same_keys_ints_floats({n: cnt.column_values(n) for n in ("k", "count")}, ref["count"],
                           (), ("count",), ("k",))


def test_world_of_one_device_sort_is_the_references(one, ref):
    import torch

    _, _, _, sh = one
    srt = sh.select(["k", "w", "c"]).sort_values(["k", "w"], ascending=[True, False])
    assert srt.is_sharded and torch.is_tensor(srt.blocks()[0]["k"])
    for n in ("k", "w", "c"):
        np.testing.assert_array_equal(srt.column_values(n), ref["sort_exchange"][n])
    srt = sh.select(["k", "w", "c"]).sort_values("c")
    for n in ("k", "w", "c"):
        np.testing.assert_array_equal(srt.column_values(n), ref["sort_replicated"][n])


@pytest.mark.parametrize("asc", [True, False])
def test_device_sort_codes_order_floats_like_numpy(asc):
    import torch
    import tensorframes_tpu as tfs
    import tensorframes_tpu_torch as tft

    x = np.asarray([np.nan, -0.0, 0.0, -np.inf, np.inf, 1.5, -2.5, -np.nan, 3.0, -1e-30],
                   np.float32)
    i = np.arange(len(x), dtype=np.int32)
    want = tfs.frame_from_arrays({"x": x, "i": i}).sort_values("x", ascending=asc)
    sh = tft.frame_from_arrays({"x": x, "i": i}).to_device()
    got = sh.sort_values("x", ascending=asc)
    assert torch.is_tensor(got.blocks()[0]["i"])
    np.testing.assert_array_equal(got.column_values("i"), want.column_values("i"))


def test_world_of_one_join_and_dedup(one, ref):
    tft, d, _, sh = one
    right = tft.frame_from_arrays({"k": d["rk"], "rv": d["rv"]})
    j = sh.select(["k", "w", "s"]).join(right, on="k")
    names = list(ref["join"])
    assert j.schema.names == names
    got = {n: (list(j.column_values(n)) if n == "s" else j.column_values(n)) for n in names}
    assert _rows(got, names) == _rows(ref["join"], names)
    dd = sh.select(["k", "c", "s"]).drop_duplicates(["k", "c"])
    got = {n: (list(dd.column_values(n)) if n == "s" else dd.column_values(n))
           for n in ("k", "c", "s")}
    assert _rows(got, ("k", "c", "s")) == _rows(ref["drop_duplicates"], ("k", "c", "s"))


def test_world_of_one_filter_stays_on_the_device(one):
    import torch

    _, d, _, sh = one
    f = sh.filter(lambda w: {"m": w > 0})
    assert f.is_sharded and torch.is_tensor(f.blocks()[0]["w"])
    assert f.num_rows == int((d["w"] > 0).sum())
    np.testing.assert_array_equal(f.column_values("w"), d["w"][d["w"] > 0])
    assert list(f.column_values("s")) == list(d["s"][d["w"] > 0])


def test_world_of_one_to_host_and_collect(one):
    _, d, whole, sh = one
    host = sh.to_host()
    assert not host.is_sharded
    np.testing.assert_array_equal(host.column_values("v"), d["v"])
    def same(a, b):
        assert len(a) == len(b)
        for ra, rb in zip(a, b):
            assert ra.keys() == rb.keys()
            for n in ra:
                np.testing.assert_array_equal(ra[n], rb[n])

    same(sh.collect(), whole.collect())
    same(sh.limit(5).collect(), whole.limit(5).collect())
    same(sh.take(2), whole.take(2))
    same([sh.first()], [whole.first()])


def test_to_device_over_a_two_rank_mesh_in_one_process_refuses_a_foreign_rank(one):
    from tensorframes_tpu_torch.parallel import make_mesh

    _, _, whole, _ = one
    with pytest.raises(ValueError, match="is not in the mesh"):
        whole.to_device(make_mesh({"dp": 2}, devices=[1, 2]))


def test_world_of_one_save_frame_sharded_makes_one_part(one, tmp_path):
    from tensorframes_tpu_torch import io

    _, d, _, sh = one
    part = io.save_frame_sharded(sh.select(["k", "v"]), str(tmp_path))
    assert Path(part).name == "part-0"
    back = io.load_frame_sharded(str(tmp_path))
    assert back.is_sharded
    np.testing.assert_array_equal(back.column_values("k"), d["k"])


def test_analyze_frame_lints_a_sharded_frame_with_its_layout(one):
    from tensorframes_tpu_torch.analysis import analyze_frame, lint_program
    from tensorframes_tpu_torch.parallel.mesh import batch_sharding, make_mesh

    tft, _, whole, sh = one
    rep = analyze_frame(sh, lambda v: {"z": v + 1.0}, device="cpu")
    assert not [d for d in rep.diagnostics if d.severity == "error"]
    prog = tft.compile_program(lambda v: {"z": v + 1.0}, whole, device="cpu")
    m2 = make_mesh({"dp": 2}, devices=[0, 1])
    rep2 = lint_program(prog, mesh=m2, shardings={"v": batch_sharding(m2, 2)})
    assert [d.code for d in rep2.diagnostics if d.code == "TFG108"] == []


def _rank_main(argv) -> int:
    rank, world, port, inp, work = int(argv[0]), int(argv[1]), argv[2], argv[3], argv[4]
    sys.path.insert(0, str(ROOT))
    import tensorframes_tpu_torch as tft
    from tensorframes_tpu_torch.parallel import init_distributed

    tft.configure(device="cpu")
    init_distributed(f"localhost:{port}", world, rank, backend="gloo", device="cpu")
    with open(inp, "rb") as f:
        data = pickle.load(f)
    res = rank_ops(tft, data, rank, world, work)
    with open(os.path.join(work, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
    return 0


if __name__ == "__main__" and sys.argv[1:2] == ["--rank"]:
    sys.exit(_rank_main(sys.argv[2:]))
