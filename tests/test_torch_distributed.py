"""The port's multi-rank substrate against the JAX package: the content
hash and the partitioners (bit for bit, in-process), meshes and layout
descriptors, the fleet's deadline half, and — in gloo ranks on the CPU,
2 and 4 of them, each world launched ONCE per module — the collectives,
the row exchange, the file shuffle and its aggregate and join helpers.

The ranks are child processes running this file as a script
(``--rank``); inputs are drawn from a seed with numpy and pickled by the
test, results pickled back for the small tests below. Integer results,
keys, placements and texts compare exactly; float sums within
``F32_SUM_RTOL``/``F32_SUM_ATOL``.
"""

from __future__ import annotations

import os
import pickle
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
WORLDS = (2, 4)
CHILD_TIMEOUT_S = 180
N_ROWS = 811
F32_SUM_RTOL = 1e-5
F32_SUM_ATOL = 1e-4


def make_data(seed: int = 1) -> dict:
    rng = np.random.default_rng(seed)
    n = N_ROWS
    return {
        "k": rng.integers(0, 23, n).astype(np.int64),
        "x": rng.standard_normal((n, 2)).astype(np.float32),
        "w": rng.integers(-50, 50, n).astype(np.int32),
        "s": np.asarray([f"t{int(i)}" for i in rng.integers(0, 11, n)], dtype=object),
        "rk": np.arange(23, dtype=np.int64),
        "rv": rng.integers(0, 9, 23).astype(np.int32),
    }


def bounds(n: int, world: int) -> list:
    return [0] + [int(n * (r + 1) // world + (r * 3) % 4) for r in range(world - 1)] + [n]


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
    import torch

    from tensorframes_tpu_torch import dsl
    from tensorframes_tpu_torch.blockstore import shuffle
    from tensorframes_tpu_torch.observability import context
    from tensorframes_tpu_torch.ops import exchange
    from tensorframes_tpu_torch.parallel import collectives, distributed, fleet_barrier
    from tensorframes_tpu_torch.resilience import fleet

    b = bounds(N_ROWS, world)
    lo, hi = b[rank], b[rank + 1]
    out = {"rank": rank, "context_rank": context.process_index(),
           "context_world": context.num_processes(),
           "topology": distributed.process_topology(),
           "is_multiprocess": distributed.is_multiprocess()}

    t = torch.tensor([rank + 1, -rank, 10 * rank], dtype=torch.int64)
    out["all_reduce"] = {op: collectives.all_reduce(t, op).tolist() for op in ("sum", "min", "max")}
    out["all_reduce_bool"] = collectives.all_reduce(torch.tensor([rank == 0]), "max").tolist()
    out["allgather_bytes"] = collectives.allgather_bytes(b"r%d" % rank * (rank + 1))
    out["vote_all_true"] = collectives.uniform_ok(True)
    out["vote_one_false"] = collectives.uniform_ok(rank != world - 1)
    # past the 64 KiB slot: the exchange takes several rounds
    parts = [bytes([rank, dst]) * (40000 * (rank + 1) + 37 * dst) for dst in range(world)]
    recv, stats = collectives.all_to_all_bytes(parts, round_bytes=world * 64)
    out["all_to_all"] = recv
    out["all_to_all_stats"] = stats

    local = {"k": data["k"][lo:hi], "x": data["x"][lo:hi], "w": data["w"][lo:hi],
             "s": list(data["s"][lo:hi])}
    part = exchange.partition_by_hash([local["k"]], world)
    got = exchange.exchange_rows(local, part)
    out["exchange"] = got
    out["exchange_stats"] = dict(exchange.last_exchange_stats)
    out["wire_bytes"] = exchange.EXCHANGE_WIRE_BYTES.value
    out["global_bytes"] = exchange.global_frame_bytes(local)
    rpart = exchange.partition_by_range([local["k"], local["w"]], world, [True, False])
    out["range_part"] = rpart
    out["range_recv"] = exchange.exchange_rows({"k": local["k"], "w": local["w"]}, rpart)

    # the file shuffle, armed beside the process group
    shuffle_dir = os.path.join(work, "shuffle")
    os.environ["TFTPU_SHUFFLE_DIR"] = shuffle_dir
    shuffle._reset_for_tests()
    b0 = shuffle.SHUFFLE_BYTES.value
    got_f = exchange.exchange_rows(local, part)
    out["exchange_files"] = got_f
    out["exchange_files_transport"] = exchange.last_exchange_stats.get("transport")
    out["vote"] = shuffle.vote_all(rank != 0, name="v")
    shuffle.barrier(name="b")
    fr = tft.frame_from_arrays({"k": local["k"], "x": local["x"], "w": local["w"]})
    with dsl.with_graph():
        xi = dsl.block(fr, "x", tf_name="x_input")
        wi = dsl.block(fr, "w", tf_name="w_input")
        fetch = [dsl.reduce_sum(xi, axis=0, name="x"), dsl.reduce_max(wi, axis=0, name="w")]

    def agg_fn(f):
        return f.group_by("k").aggregate(fetch)

    da = shuffle.distributed_aggregate(fr, ["k"], agg_fn, name="agg")
    out["distributed_aggregate"] = {n: da.column_values(n) for n in ("k", "x", "w")}
    rb = bounds(len(data["rk"]), world)
    right = tft.frame_from_arrays({"k": data["rk"][rb[rank]:rb[rank + 1]],
                                   "rv": data["rv"][rb[rank]:rb[rank + 1]]})
    out["distributed_join"] = shuffle.distributed_join(
        tft.frame_from_arrays({"k": local["k"], "w": local["w"]}), right, "k", name="j")
    out["join_outer_error"] = _text(lambda: shuffle.distributed_join(fr, right, "k", how="outer"))

    # the generic aggregate's partial merge through the spill files
    from tensorframes_tpu_torch.parallel import frame_from_process_local

    sh = frame_from_process_local({"k": local["k"], "w": local["w"]})

    def sum_fn(w_input):
        return {"w": w_input.sum(0, dtype=w_input.dtype)}

    g = sh.group_by("k").aggregate(sum_fn)
    out["generic_shuffled"] = {n: g.column_values(n) for n in ("k", "w")}
    out["shuffle_bytes"] = shuffle.SHUFFLE_BYTES.value - b0
    del os.environ["TFTPU_SHUFFLE_DIR"]
    shuffle._reset_for_tests()

    # the fleet barrier over the rendezvous dir, then one rank missing
    fleet_dir = os.path.join(work, "fleet")
    os.environ["TFTPU_FLEET_DIR"] = fleet_dir
    fleet_barrier("start", timeout=30)
    out["barrier_ok"] = True
    if rank == 0:
        out["barrier_missing"] = _text(lambda: fleet_barrier("lonely", timeout=0.5))
    else:
        out["barrier_missing"] = None
    collectives.barrier()
    del os.environ["TFTPU_FLEET_DIR"]
    out["abort_record"] = fleet.abort_requested(fleet_dir) is not None
    return out


# ---------------------------------------------------------------------------
# in-process: pure functions against the reference, bit for bit
# ---------------------------------------------------------------------------

def _dtype_cases():
    rng = np.random.default_rng(7)
    special = np.asarray([np.nan, -0.0, 0.0, np.inf, -np.inf, 1.5, -2.25, 1e30])
    cases = {}
    for name in ("float64", "float32", "float16"):
        vals = np.concatenate([special, rng.standard_normal(40)]).astype(name)
        cases[name] = vals
    for name in ("int8", "int16", "int32", "int64", "uint8"):
        info = np.iinfo(name)
        vals = rng.integers(info.min, info.max, 48, dtype=name, endpoint=True)
        cases[name] = np.concatenate([vals, np.asarray([info.min, info.max, 0], name)])
    cases["bool"] = rng.integers(0, 2, 30).astype(bool)
    cases["bfloat16"] = np.concatenate([special, rng.standard_normal(20)]).astype("float32")
    strs = [f"s{i % 9}" for i in range(30)] + ["", "é", "\u2603"]
    cases["string"] = np.asarray(strs, dtype=object)
    cases["bytes"] = np.asarray([b"a", b"", b"\x00\xff"] * 5, dtype=object)
    cases["mixed_object"] = np.asarray([1, 1.0, "1", None, True, 2.5, b"x", np.int32(7)], dtype=object)
    return cases


DTYPE_CASES = _dtype_cases()


def _cast(name, vals):
    if name == "bfloat16":
        import ml_dtypes

        return vals.astype(ml_dtypes.bfloat16)
    return vals


@pytest.mark.parametrize("name", sorted(DTYPE_CASES))
def test_content_hash64_bit_equal(name):
    from tensorframes_tpu.ops import exchange as ref
    from tensorframes_tpu_torch.ops import exchange as port

    a = _cast(name, DTYPE_CASES[name])
    np.testing.assert_array_equal(port.content_hash64([a]), ref.content_hash64([a]))
    b = np.arange(len(a)) % 5
    got, want = port.content_hash64([a, b]), ref.content_hash64([a, b])
    assert got.dtype == want.dtype == np.uint64
    np.testing.assert_array_equal(got, want)


def test_content_hash64_canonical_nan_and_zero():
    from tensorframes_tpu_torch.ops.exchange import content_hash64

    h = content_hash64([np.asarray([np.nan, -np.nan, 0.0, -0.0, 5, 5.0], dtype=np.float64)])
    assert h[0] == h[1] and h[2] == h[3] and h[4] == h[5]
    # ints hash like the float they promote to: a cross-dtype join colocates
    h2 = content_hash64([np.asarray([5], np.int32)])
    assert h2[0] == h[4]
    assert content_hash64([["5"]])[0] != h[4]


@pytest.mark.parametrize("parts", [1, 2, 3, 4, 7])
@pytest.mark.parametrize("name", ["float32", "int64", "string", "bool", "mixed_object"])
def test_partition_by_hash_bit_equal(name, parts):
    from tensorframes_tpu.ops import exchange as ref
    from tensorframes_tpu_torch.ops import exchange as port

    a = _cast(name, DTYPE_CASES[name])
    got = port.partition_by_hash([a], parts)
    np.testing.assert_array_equal(got, ref.partition_by_hash([a], parts))
    assert got.dtype == np.int64 and (got >= 0).all() and (got < parts).all()


@pytest.mark.parametrize("asc", [(True,), (False,), (True, False), (False, True)])
@pytest.mark.parametrize("name", ["float64", "int32", "string", "uint8"])
@pytest.mark.parametrize("parts", [1, 3, 4])
def test_partition_by_range_bit_equal(name, asc, parts):
    from tensorframes_tpu.ops import exchange as ref
    from tensorframes_tpu_torch.ops import exchange as port

    a = DTYPE_CASES[name]
    keys = [a, np.arange(len(a))[::-1] % 4][:len(asc)]
    got = port.partition_by_range(keys, parts, list(asc), sample_per_process=16)
    want = ref.partition_by_range(keys, parts, list(asc), sample_per_process=16)
    np.testing.assert_array_equal(got, want)


def test_partition_by_range_orders_partitions():
    from tensorframes_tpu_torch.ops.exchange import partition_by_range

    k = np.random.default_rng(3).integers(0, 1000, 500)
    part = partition_by_range([k], 4, [True])
    for p in range(3):
        if (part == p).any() and (part == p + 1).any():
            assert k[part == p].max() <= k[part == p + 1].min()


@pytest.mark.parametrize("axes,n", [
    (None, 4), ({"dp": -1}, 4), ({"dp": 2, "tp": 2}, 4), ({"dp": -1, "tp": 2}, 8),
    ({"tp": 4, "dp": -1}, 8), ({"dp": 1}, 1),
])
def test_make_mesh_matches_the_reference(axes, n):
    import jax
    from tensorframes_tpu.parallel import mesh as ref
    from tensorframes_tpu_torch.parallel import mesh as port

    got = port.make_mesh(axes, devices=list(range(n)))
    want = ref.make_mesh(axes, devices=jax.devices()[:n])
    assert port.mesh_descriptor(got) == ref.mesh_descriptor(want)
    assert got.shape == dict(want.shape)
    assert got.axis_names == tuple(want.axis_names)


@pytest.mark.parametrize("axes,n", [
    ({"dp": -1, "tp": -1}, 4), ({"dp": -1, "tp": 3}, 4), ({"dp": 3}, 4), ({"dp": 2, "tp": 3}, 4),
])
def test_make_mesh_errors_are_the_references(axes, n):
    import jax
    from tensorframes_tpu.parallel import mesh as ref
    from tensorframes_tpu_torch.parallel import mesh as port

    with pytest.raises(ValueError) as want:
        ref.make_mesh(axes, devices=jax.devices()[:n])
    with pytest.raises(ValueError) as got:
        port.make_mesh(axes, devices=list(range(n)))
    assert str(got.value) == str(want.value)


def test_world_of_one_without_a_process_group():
    from tensorframes_tpu_torch.parallel import (
        device_count, is_multiprocess, make_mesh, process_index, process_topology)

    assert device_count() == 1 and not is_multiprocess() and process_index() == 0
    m = make_mesh({"dp": -1})
    assert m.shape == {"dp": 1} and m.devices.tolist() == [0]
    topo = process_topology()
    assert topo["n_processes"] == 1 and topo["devices"][0][0] == 0


@pytest.mark.parametrize("rank", [1, 2, 3])
def test_sharding_descriptors_match_the_references(rank):
    import jax
    from tensorframes_tpu.parallel import mesh as ref
    from tensorframes_tpu_torch.parallel import mesh as port

    pm = port.make_mesh({"dp": 2, "tp": 2}, devices=[0, 1, 2, 3])
    rm = ref.make_mesh({"dp": 2, "tp": 2}, devices=jax.devices()[:4])
    want = ref.sharding_descriptor(ref.batch_sharding(rm, rank))
    want.pop("memory_kind", None)
    assert port.sharding_descriptor(port.batch_sharding(pm, rank)) == want
    want_r = ref.sharding_descriptor(ref.replicated(rm))
    want_r.pop("memory_kind", None)
    assert port.sharding_descriptor(port.replicated(pm)) == want_r
    assert port.sharding_descriptor(None) is None is ref.sharding_descriptor(None)
    spec = port.PartitionSpec("dp", ("tp", "sp"), None)
    from jax.sharding import PartitionSpec

    assert port.spec_descriptor(spec) == ref.spec_descriptor(PartitionSpec("dp", ("tp", "sp"), None))
    assert port.BATCH_AXIS == ref.BATCH_AXIS


def test_sharding_descriptor_of_this_ranks_device_is_trivial():
    import torch

    from tensorframes_tpu_torch.parallel import mesh as port

    assert port.sharding_descriptor(port.default_device()) is None
    other = torch.device("cuda", 3) if port.default_device().type == "cpu" else torch.device("cpu")
    assert port.sharding_descriptor(other)["type"] == "single"


def test_parallel_all_is_the_references_but_pipeline():
    import tensorframes_tpu.parallel as ref
    import tensorframes_tpu_torch.parallel as port

    # the pipeline helpers are ported too now: the lists are equal
    assert sorted(port.__all__) == sorted(ref.__all__)


def test_run_with_deadline_text_is_the_references(tmp_path):
    from tensorframes_tpu.resilience import fleet as ref
    from tensorframes_tpu_torch.resilience import fleet as port

    texts = []
    for mod in (ref, port):
        with pytest.raises(mod.HungDispatchError) as e:
            mod.run_with_deadline(lambda: time.sleep(2), describe="probe.wait", deadline=0.05,
                                  directory=str(tmp_path / mod.__name__), signal=False)
        texts.append(str(e.value))
        assert isinstance(e.value, TimeoutError) and isinstance(e.value, mod.FleetError)
    assert texts[0] == texts[1]
    assert port.run_with_deadline(lambda: 7, deadline=0) == 7


def test_barrier_missing_rank_text_is_the_references(tmp_path):
    from tensorframes_tpu.resilience import fleet as ref
    from tensorframes_tpu_torch.resilience import fleet as port

    texts = []
    for mod in (ref, port):
        d = tmp_path / mod.__name__
        with pytest.raises(mod.HungDispatchError) as e:
            mod.barrier("epoch", directory=str(d), num_processes=3, rank=1, deadline=0.05)
        texts.append(str(e.value))
        assert mod.abort_requested(str(d)) is not None  # the coordinated abort
    assert texts[0] == texts[1] and "[0, 2]" in texts[1]
    port.barrier("alone", directory=str(tmp_path / "x"), num_processes=1)  # a no-op


def test_barrier_abort_signal_raises_coordinated_abort(tmp_path):
    from tensorframes_tpu_torch.resilience import fleet as port

    port.signal_abort(str(tmp_path), "peer died", dead_ranks=[2])
    with pytest.raises(port.CoordinatedAbortError, match="peer died"):
        port.barrier("x", directory=str(tmp_path), num_processes=2, rank=0, deadline=5)


def test_dispatch_deadline_reads_config():
    import tensorframes_tpu_torch as tft
    from tensorframes_tpu_torch.resilience import fleet as port

    old = tft.get_config().dispatch_deadline_s
    try:
        tft.configure(dispatch_deadline_s=2.5)
        assert port.dispatch_deadline_s() == 2.5
    finally:
        tft.configure(dispatch_deadline_s=old)


def test_shuffle_corrupt_payload_is_quarantined(tmp_path, monkeypatch):
    from tensorframes_tpu.blockstore import shuffle as ref
    from tensorframes_tpu_torch.blockstore import shuffle as port

    texts = []
    for mod in (ref, port):
        d = tmp_path / mod.__name__
        d.mkdir()
        path = d / "s00001-d00000.part"
        mod._publish(str(path), b"payload")
        raw = bytearray(path.read_bytes())
        raw[-1] ^= 0xFF
        path.write_bytes(bytes(raw))
        with pytest.raises(mod.ShuffleCorruptionError) as e:
            mod._read_framed(str(path), describe="t")
        texts.append(str(e.value).replace(str(d), "D"))
        assert not path.exists()  # renamed aside
    assert texts[0].split(":")[0] == texts[1].split(":")[0]


def test_shuffle_single_rank_round_trip(tmp_path, monkeypatch):
    from tensorframes_tpu_torch.blockstore import shuffle as port

    monkeypatch.setenv("TFTPU_SHUFFLE_DIR", str(tmp_path))
    monkeypatch.setenv("TFTPU_SHUFFLE_RANK", "0")
    monkeypatch.setenv("TFTPU_SHUFFLE_NPROCS", "1")
    port._reset_for_tests()
    try:
        assert port.enabled() and port.context().nprocs == 1
        assert port.exchange([b"me"], name="x") == [b"me"]
        assert port.allshare(b"all", name="y") == [b"all"]
        got = port.shuffle_rows({"a": np.arange(3), "s": ["x", "y", "z"]}, np.zeros(3, int))
        np.testing.assert_array_equal(got["a"], np.arange(3))
        assert got["s"] == ["x", "y", "z"]
        with pytest.raises(ValueError, match="one payload per rank"):
            port.exchange([b"a", b"b"])
    finally:
        port._reset_for_tests()


def test_shuffle_fault_site_is_registered():
    from tensorframes_tpu_torch.blockstore import shuffle  # noqa: F401
    from tensorframes_tpu_torch.resilience import faults

    assert "shuffle.exchange" in faults.list_sites()
    assert "fleet.barrier" in faults.list_sites()


# ---------------------------------------------------------------------------
# gloo ranks
# ---------------------------------------------------------------------------

def _free_port() -> int:
    sock = socket.socket()
    sock.bind(("localhost", 0))
    port = sock.getsockname()[1]
    sock.close()
    return port


def run_world(world: int, work: Path) -> list:
    work.mkdir(parents=True, exist_ok=True)
    inp = work / "in.pkl"
    with open(inp, "wb") as f:
        pickle.dump(make_data(), f)
    port = str(_free_port())
    # one run id for the fleet, as a launcher exports it
    env = dict(os.environ, PYTHONPATH=str(ROOT), TFTPU_RUN_ID=f"gloo{world}")
    env.pop("TFTPU_FLEET_DIR", None)
    env.pop("TFTPU_SHUFFLE_DIR", None)
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


def test_init_binds_rank_context_and_topology(world):
    w, ranks = world
    for r, res in enumerate(ranks):
        assert res["rank"] == res["context_rank"] == r
        assert res["context_world"] == w and res["is_multiprocess"]
        assert res["topology"] == {"n_processes": w,
                                   "devices": [[i, "cpu", "cpu", i] for i in range(w)]}


def test_all_reduce_sum_min_max(world):
    w, ranks = world
    vals = np.asarray([[r + 1, -r, 10 * r] for r in range(w)])
    for res in ranks:
        assert res["all_reduce"] == {"sum": vals.sum(0).tolist(), "min": vals.min(0).tolist(),
                                     "max": vals.max(0).tolist()}
        assert res["all_reduce_bool"] == [True]


def test_allgather_bytes_in_rank_order(world):
    w, ranks = world
    for res in ranks:
        assert res["allgather_bytes"] == [b"r%d" % r * (r + 1) for r in range(w)]


def test_uniform_vote(world):
    _, ranks = world
    assert all(r["vote_all_true"] for r in ranks)
    assert not any(r["vote_one_false"] for r in ranks)


def test_all_to_all_bytes_in_rounds(world):
    w, ranks = world
    for me, res in enumerate(ranks):
        want = [bytes([src, me]) * (40000 * (src + 1) + 37 * me) for src in range(w)]
        assert res["all_to_all"] == want
        st = res["all_to_all_stats"]
        assert st["chunk"] == 1 << 16 and st["rounds"] > 1
        assert st["wire_bytes"] == st["rounds"] * w * st["chunk"]


def _expected_exchange(w, dest):
    from tensorframes_tpu.ops.exchange import partition_by_hash

    d = make_data()
    b = bounds(N_ROWS, w)
    parts = [partition_by_hash([d["k"][b[r]:b[r + 1]]], w) for r in range(w)]
    idx = np.concatenate([np.flatnonzero(parts[r] == dest) + b[r] for r in range(w)])
    return d, idx


@pytest.mark.parametrize("key", ["exchange", "exchange_files"])
def test_exchange_rows_by_the_references_hash(world, key):
    w, ranks = world
    for me, res in enumerate(ranks):
        d, idx = _expected_exchange(w, me)
        got = res[key]
        for n in ("k", "x", "w"):
            np.testing.assert_array_equal(got[n], d[n][idx])
        assert got["s"] == list(d["s"][idx])
    assert all(r["exchange_files_transport"] == "files" for r in ranks)


def test_exchange_stats_and_wire_counter(world):
    w, ranks = world
    for res in ranks:
        st = res["exchange_stats"]
        assert st["transport"] == "all_to_all_single" and len(st["sent"]) == w
        assert res["wire_bytes"] >= st["wire_bytes"] > 0
    sent = np.asarray([r["exchange_stats"]["sent"] for r in ranks])
    recv = np.asarray([r["exchange_stats"]["received"] for r in ranks])
    np.testing.assert_array_equal(sent.T, recv)


def test_global_frame_bytes_is_the_sum(world):
    from tensorframes_tpu.ops.exchange import global_frame_bytes

    _, ranks = world
    d = make_data()
    whole = {"k": d["k"], "x": d["x"], "w": d["w"], "s": list(d["s"])}
    want = global_frame_bytes(whole)
    assert all(r["global_bytes"] == want for r in ranks)


def test_range_exchange_concatenates_to_the_global_sort(world):
    import tensorframes_tpu as tfs

    w, ranks = world
    d = make_data()
    got_k = np.concatenate([r["range_recv"]["k"] for r in ranks])
    got_w = np.concatenate([r["range_recv"]["w"] for r in ranks])
    # each rank sorts its range locally: the ranks' ranges in rank order
    # are the reference's global order
    order_k, order_w = [], []
    for r in ranks:
        k, wv = r["range_recv"]["k"], r["range_recv"]["w"]
        o = np.lexsort([-wv.astype(np.int64), k])
        order_k.append(k[o])
        order_w.append(wv[o])
    srt = tfs.frame_from_arrays({"k": d["k"], "w": d["w"]}).sort_values(
        ["k", "w"], ascending=[True, False])
    np.testing.assert_array_equal(np.concatenate(order_k), srt.column_values("k"))
    np.testing.assert_array_equal(np.concatenate(order_w), srt.column_values("w"))
    assert sorted(got_k.tolist()) == sorted(d["k"].tolist()) and len(got_w) == N_ROWS


def test_file_shuffle_vote_and_counter(world):
    _, ranks = world
    assert not any(r["vote"] for r in ranks)
    assert all(r["shuffle_bytes"] > 0 for r in ranks)


def _ref_frames():
    import tensorframes_tpu as tfs

    d = make_data()
    fr = tfs.frame_from_arrays({"k": d["k"], "x": d["x"], "w": d["w"]})
    return tfs, d, fr


def test_distributed_aggregate_is_the_references(world):
    tfs, d, fr = _ref_frames()
    with tfs.with_graph():
        xi = tfs.block(fr, "x", tf_name="x_input")
        wi = tfs.block(fr, "w", tf_name="w_input")
        fetch = [tfs.reduce_sum(xi, axis=0, name="x"), tfs.reduce_max(wi, axis=0, name="w")]
    want = fr.group_by("k").aggregate(fetch)
    _, ranks = world
    for res in ranks:
        got = res["distributed_aggregate"]
        np.testing.assert_array_equal(got["k"], want.column_values("k"))
        np.testing.assert_array_equal(got["w"], want.column_values("w"))
        np.testing.assert_allclose(got["x"], want.column_values("x"), rtol=F32_SUM_RTOL,
                                   atol=F32_SUM_ATOL)


def test_distributed_join_union_is_the_references(world):
    tfs, d, _ = _ref_frames()
    want = tfs.frame_from_arrays({"k": d["k"], "w": d["w"]}).join(
        tfs.frame_from_arrays({"k": d["rk"], "rv": d["rv"]}), on="k")
    rows_want = sorted(zip(*(want.column_values(n).tolist() for n in ("k", "w", "rv"))))
    _, ranks = world
    for res in ranks:  # replicated: every rank holds the union
        got = res["distributed_join"]
        rows = sorted(zip(*(np.asarray(got[n]).tolist() for n in ("k", "w", "rv"))))
        assert rows == rows_want
        assert "how='inner' only" in res["join_outer_error"]


def test_generic_aggregate_merged_through_the_shuffle(world):
    tfs, d, _ = _ref_frames()
    want = tfs.frame_from_arrays({"k": d["k"], "w": d["w"]}).group_by("k").aggregate(
        lambda w_input: {"w": w_input.sum(0, dtype=w_input.dtype)})
    _, ranks = world
    for res in ranks:
        np.testing.assert_array_equal(res["generic_shuffled"]["k"], want.column_values("k"))
        np.testing.assert_array_equal(res["generic_shuffled"]["w"], want.column_values("w"))


def test_fleet_barrier_across_ranks_and_a_missing_rank(world):
    w, ranks = world
    assert all(r["barrier_ok"] for r in ranks)
    missing = list(range(1, w))
    assert ranks[0]["barrier_missing"] == (
        f"HungDispatchError: barrier 'lonely': rank(s) {missing} missing after the "
        "0.5s deadline (arrived: [0]) — aborted by the hung-collective watchdog (see "
        "the flight-recorder postmortem)")
    assert all(r["abort_record"] for r in ranks)


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
