"""The port's compile cache: program fingerprints, the persistent
dispatch-key store, warmup and the CLI, held against the JAX package's
where both define the same thing (warmup's row targets and report keys,
the CLI's exit codes and JSON keys).

Every store lives under ``tmp_path``; no test leaves
``compilation_cache_dir`` set (xdist runs the files side by side).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import tensorframes_tpu as tfs
import tensorframes_tpu_torch as tft
from tensorframes_tpu_torch import kernels as tkernels
from tensorframes_tpu_torch.compilecache import (
    CompileCacheStore,
    active_store,
    partitioner_row_counts,
    program_fingerprint,
    store_for,
    warmup,
)
from tensorframes_tpu_torch.compilecache import store as tstore
from tensorframes_tpu_torch.compilecache.cli import main as cli_main
from tensorframes_tpu_torch.observability.metrics import REGISTRY
from tensorframes_tpu_torch.ops import executor as texec

ROOT = Path(__file__).resolve().parents[1]
CPU = {"device": "cpu"}


def _counter(name, **labels):
    for m in REGISTRY.collect():
        if m.name == name and dict(m.labels) == labels:
            return m.value
    return 0.0


@pytest.fixture
def store_dir(tmp_path):
    d = str(tmp_path / "cc")
    tft.configure(compilation_cache_dir=d)
    try:
        yield d
    finally:
        tft.configure(compilation_cache_dir="")


def _entries(store_dir):
    aot = os.path.join(store_dir, "aot")
    return sorted(f for f in os.listdir(aot) if f.endswith(".xc")) if os.path.isdir(aot) else []


# ---------------------------------------------------------------------------
# program fingerprints
# ---------------------------------------------------------------------------

PROGRAM_SRC = '''
import numpy as np
import torch
import tensorframes_tpu_torch as tft

C = torch.tensor([0.5, 1.5, 2.5])


def build(dtype=np.float32, c=C, device="cpu"):
    fr = tft.frame_from_arrays({"x": np.arange(12, dtype=dtype)}, num_blocks=2)
    return tft.compile_program(lambda x: {"y": x[:, None] * c.to(x.dtype) + 1.0}, fr,
                               device=device)
'''


@pytest.fixture
def prog_module(tmp_path, monkeypatch):
    (tmp_path / "fp_prog.py").write_text(PROGRAM_SRC)
    monkeypatch.syspath_prepend(str(tmp_path))
    import importlib

    import fp_prog

    return importlib.reload(fp_prog)


def test_fingerprint_stable_across_rebuilds_and_a_subprocess(prog_module, tmp_path):
    a = program_fingerprint(prog_module.build())
    assert a == program_fingerprint(prog_module.build())
    assert a == program_fingerprint(prog_module.build())  # a third capture
    code = ("import fp_prog\n"
            "from tensorframes_tpu_torch.compilecache import program_fingerprint\n"
            "print(program_fingerprint(fp_prog.build()))\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(tmp_path), str(ROOT)]))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == a


def test_fingerprint_moves_with_bucket_dtype_constant_and_device(prog_module):
    base = prog_module.build()
    comps = program_fingerprint(base, components=True)
    assert set(comps) == {"graph", "consts", "avals", "outs", "env", "extra"}

    def moved(other):
        c2 = other if isinstance(other, dict) else program_fingerprint(other, components=True)
        return sorted(k for k in comps if comps[k] != c2[k])

    assert moved(program_fingerprint(base, probe=16, components=True)) == ["avals"]
    assert "avals" in moved(prog_module.build(dtype=np.float64))
    assert moved(prog_module.build(c=torch.tensor([0.5, 1.5, 9.0]))) == ["consts"]
    fr = tft.frame_from_arrays({"x": np.arange(4, dtype=np.float32)})
    plain = tft.compile_program(lambda x: {"y": x * 2.0}, fr, **CPU)
    on_cpu = program_fingerprint(plain, components=True)
    plain.device = torch.device("meta")
    on_meta = program_fingerprint(plain, components=True)
    assert sorted(k for k in on_cpu if on_cpu[k] != on_meta[k]) == ["env"]
    assert program_fingerprint(base) != program_fingerprint(base, kind="vmap")
    # a sharded layout adds the shardings slot alone; meshes of two sizes
    # key differently
    from tensorframes_tpu_torch.parallel.mesh import batch_sharding, make_mesh

    inputs = [spec.name for spec in base.inputs]
    m1, m2 = make_mesh({"dp": 1}), make_mesh({"dp": 2}, devices=[0, 1])
    sh1 = program_fingerprint(base, mesh=m1, shardings={n: batch_sharding(m1, 1) for n in inputs},
                              components=True)
    sh2 = program_fingerprint(base, mesh=m2, shardings={n: batch_sharding(m2, 1) for n in inputs},
                              components=True)
    assert sorted(k for k in comps if comps[k] != sh1[k]) == []
    assert set(sh1["shardings"]) == {"__mesh__", *inputs}
    assert sh1["shardings"] != sh2["shardings"]
    assert program_fingerprint(base, mesh=m1) != program_fingerprint(base, mesh=m2)
    assert program_fingerprint(base, mesh=m1) != program_fingerprint(base)


def test_unfingerprintable_program_is_counted_and_dispatches(store_dir, monkeypatch):
    from tensorframes_tpu_torch import program as tprogram

    def refuse(program, probe=8):
        raise RuntimeError("cannot capture")

    monkeypatch.setattr(tprogram, "capture_graph", refuse)
    fr = tft.frame_from_arrays({"x": np.arange(6, dtype=np.float32)}, num_blocks=1)
    before = _counter("tftpu_compilecache_fallback_total", reason="unfingerprintable")
    out = tft.map_blocks(lambda x: {"y": x * 15.0}, fr, **CPU)
    np.testing.assert_array_equal(out.column_values("y"), np.arange(6.0) * 15.0)
    assert _counter("tftpu_compilecache_fallback_total",
                    reason="unfingerprintable") == before + 1
    assert _entries(store_dir) == []


# ---------------------------------------------------------------------------
# the store
# ---------------------------------------------------------------------------

def test_store_roundtrip_crc_and_quarantine(tmp_path):
    store = CompileCacheStore(str(tmp_path / "aot"))
    meta = {"kind": "block", "inputs": [["x", [8], "float32"]]}
    assert store.put("abc123", meta)
    assert store.get("abc123") == meta
    path = tmp_path / "aot" / "abc123.xc"
    blob = bytearray(path.read_bytes())
    blob[-1] ^= 0xFF
    path.write_bytes(bytes(blob))
    assert store.verify()["bad"][0]["error"] == "payload CRC mismatch"
    before = _counter("tftpu_compilecache_fallback_total", reason="corrupt")
    assert store.get("abc123") is None
    assert _counter("tftpu_compilecache_fallback_total", reason="corrupt") == before + 1
    assert not path.exists()  # quarantined
    assert store.put("abc123", meta) and store.get("abc123") == meta
    path.write_bytes(path.read_bytes()[:-3])  # truncated
    assert store.verify(delete_bad=True)["deleted"] == 1 and not path.exists()
    with pytest.raises(ValueError):
        store._path("../escape")


def test_store_lru_eviction_by_bytes(tmp_path):
    store = CompileCacheStore(str(tmp_path / "aot"))
    store.put("a", {"pad": "x" * 200})
    size = os.path.getsize(tmp_path / "aot" / "a.xc")
    store.max_bytes = 2 * size + size // 2
    t = 1_000_000_000
    for i, fp in enumerate(("a",)):
        os.utime(tmp_path / "aot" / f"{fp}.xc", (t + i, t + i))
    store.put("b", {"pad": "y" * 200})
    os.utime(tmp_path / "aot" / "b.xc", (t + 10, t + 10))
    store.get("a")  # a hit refreshes a's mtime: b is now the oldest
    before = _counter("tftpu_compilecache_evictions_total")
    store.put("c", {"pad": "z" * 200})
    assert sorted(os.listdir(tmp_path / "aot")) == ["a.xc", "c.xc"]
    assert _counter("tftpu_compilecache_evictions_total") == before + 1
    assert store.prune(max_bytes=0)["entries"] == 0


def test_two_concurrent_writers(tmp_path):
    root = str(tmp_path / "aot")
    code = ("import sys\n"
            "from tensorframes_tpu_torch.compilecache.store import CompileCacheStore\n"
            "s = CompileCacheStore(sys.argv[1])\n"
            "ok = all(s.put('shared', {'i': n, 'pad': 'x' * 4096}) for n in range(200))\n"
            "print(ok)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen([sys.executable, "-c", code, root], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [o[0].strip() for o in outs] == ["True", "True"], outs
    store = CompileCacheStore(root)
    assert store.get("shared")["i"] == 199
    assert store.verify()["ok"]
    assert [f for f in os.listdir(root) if ".tmp." in f] == []


def test_store_records_keys_and_a_fresh_program_hits(store_dir):
    frame = tft.frame_from_arrays({"x": np.arange(12, dtype=np.float32)}, num_blocks=2)

    def fn(x):
        return {"y": x + 100.0}

    h0, m0 = _counter("tftpu_compilecache_hits_total"), _counter("tftpu_compilecache_misses_total")
    first = tft.map_blocks(tft.compile_program(fn, frame, **CPU), frame, **CPU).collect()
    assert len(_entries(store_dir)) == 1  # one block size: one key
    assert _counter("tftpu_compilecache_misses_total") == m0 + 1
    again = tft.map_blocks(tft.compile_program(fn, frame, **CPU), frame, **CPU).collect()
    assert _counter("tftpu_compilecache_hits_total") == h0 + 1
    assert repr(first) == repr(again)
    store = active_store()
    assert store.root == os.path.join(os.path.abspath(store_dir), "aot")
    # the store keeps to <dir>/aot; the plan-stats sidecar has its own
    assert set(os.listdir(store_dir)) <= {"aot", "planstats"}
    assert all(f.endswith(".json") for f in os.listdir(os.path.join(store_dir, "planstats")))
    assert sorted(os.listdir(store.root)) == _entries(store_dir) + ["manifest.jsonl"]
    [row] = store.read_manifest()
    assert row == {"kind": "block", "inputs": [["x", [6], "float32"]]}


def test_no_cache_dir_leaves_dispatch_unchanged(monkeypatch):
    assert tft.get_config().compilation_cache_dir == ""
    calls = []
    monkeypatch.setattr(tstore, "store_for", lambda *a, **k: calls.append(a))
    frame = tft.frame_from_arrays({"x": np.arange(8, dtype=np.float32)}, num_blocks=2)
    before = [_counter(n) for n in ("tftpu_compilecache_hits_total",
                                    "tftpu_compilecache_misses_total")]
    m0 = texec._JIT_MISSES.value
    out = tft.map_rows(lambda x: {"y": x * 3.0}, frame, **CPU).column_values("y")
    np.testing.assert_array_equal(out, np.arange(8, dtype=np.float32) * 3.0)
    assert texec._JIT_MISSES.value == m0 + 1
    assert calls == [] and active_store() is None
    assert [_counter(n) for n in ("tftpu_compilecache_hits_total",
                                  "tftpu_compilecache_misses_total")] == before


# ---------------------------------------------------------------------------
# warmup
# ---------------------------------------------------------------------------

def _warm_both(build_frame, fn, **kw):
    """The same warmup through both packages; the reference's store stays
    off, and its leg must succeed for the comparison to stand."""
    jf, tf_ = build_frame(tfs), build_frame(tft)
    jr = tfs.warmup(jf, tfs.compile_program(fn, jf, block=kw.get("block", True)), **kw)
    tr = tft.warmup(tf_, tft.compile_program(fn, tf_, block=kw.get("block", True), **CPU),
                    device="cpu", **kw)
    return jr, tr


@pytest.mark.parametrize("case", ["partitioner", "rows_mode", "explicit_rows", "materialized"])
def test_warmup_targets_and_report_keys_equal_reference(case):
    if case == "partitioner":
        jr, tr = _warm_both(lambda P: P.frame_from_arrays({"x": np.arange(21.0)}, num_blocks=4),
                            lambda x: {"y": x * x})
    elif case == "rows_mode":
        jr, tr = _warm_both(lambda P: P.frame_from_arrays({"x": np.arange(10.0)}, num_blocks=1),
                            lambda x: {"s": x * 2.0}, block=False)
    elif case == "explicit_rows":
        jr, tr = _warm_both(lambda P: P.frame_from_arrays({"x": np.arange(10.0)}),
                            lambda x: {"s": x * 2.0}, block=False, rows=[3, 17, 64])
    else:
        def build(P):
            fr = P.frame_from_arrays({"x": np.arange(23.0)}, num_blocks=3)
            fr.blocks()
            return fr

        jr, tr = _warm_both(build, lambda x: {"y": x + 1.0})
    assert not jr.counts().get("failed"), jr.pretty()  # the reference leg ran
    assert [(e["kind"], e["rows"]) for e in tr.entries] == \
        [(e["kind"], e["rows"]) for e in jr.entries]
    assert tr.counts() == jr.counts() == {"compiled": len(jr.entries)}


def test_warmed_keys_make_the_first_dispatch_a_hit():
    frame = tft.frame_from_arrays({"x": np.arange(21.0)}, num_blocks=4)
    program = tft.compile_program(lambda x: {"y": x * x}, frame, **CPU)
    report = warmup(frame, program, device="cpu")
    assert report.compiled == 2 and {e["rows"] for e in report.entries} == {5, 6}
    m0, h0 = texec._JIT_MISSES.value, texec._JIT_HITS.value
    out = tft.map_blocks(program, frame, **CPU).column_values("y")
    np.testing.assert_array_equal(out, np.arange(21.0) ** 2)
    assert texec._JIT_MISSES.value == m0 and texec._JIT_HITS.value == h0 + 4
    assert warmup(frame, program, device="cpu").counts() == {"cached": 2}


def test_warmup_manifest_replay_in_a_new_process(store_dir, tmp_path):
    code = ("import sys, json, numpy as np\n"
            "import tensorframes_tpu_torch as tft\n"
            "tft.configure(compilation_cache_dir=sys.argv[1])\n"
            "fr = tft.frame_from_arrays({'x': np.arange(10, dtype=np.float32)}, num_blocks=1)\n"
            "p = tft.compile_program(lambda x: {'s': x * 2.0}, fr, block=False, device='cpu')\n"
            "kw = dict(manifest=True) if sys.argv[2] == 'replay' else dict(rows=[3, 10])\n"
            "r = tft.warmup(None if kw.get('manifest') else fr, p, block=False,"
            " device='cpu', **kw)\n"
            "print(json.dumps(r.counts()))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    runs = []
    for mode in ("cold", "replay"):
        out = subprocess.run([sys.executable, "-c", code, store_dir, mode], env=env,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stderr
        runs.append(json.loads(out.stdout.strip().splitlines()[-1]))
    # rows 3 and 10 and their buckets 8 and 16: four keys, then four disk hits
    assert runs == [{"compiled": 4}, {"disk": 4}]
    assert len(_entries(store_dir)) == 4


def test_warmup_manifest_requires_matching_dtype_and_errors(store_dir, tmp_path):
    with pytest.raises(ValueError, match="does not exist"):
        warmup(None, tft.compile_program(lambda x: {"y": x}, tft.frame_from_arrays(
            {"x": np.arange(3.0)}), **CPU), manifest=str(tmp_path / "nope.jsonl"), device="cpu")
    fr64 = tft.frame_from_arrays({"x": np.arange(6.0)})
    tft.map_blocks(tft.compile_program(lambda x: {"y": x + 1}, fr64, **CPU), fr64, **CPU).collect()
    fr32 = tft.frame_from_arrays({"x": np.arange(6, dtype=np.float32)})
    p32 = tft.compile_program(lambda x: {"y": x + 1}, fr32, **CPU)
    assert warmup(None, p32, manifest=True, device="cpu").entries == []
    tft.configure(compilation_cache_dir="")
    with pytest.raises(ValueError, match="needs an active persistent store"):
        warmup(None, p32, manifest=True, device="cpu")
    with pytest.raises(ValueError, match="needs rows"):
        warmup(None, p32, device="cpu")


def test_partitioner_row_counts_equal_reference():
    from tensorframes_tpu.compilecache import partitioner_row_counts as jcounts

    for total, k in ((21, 4), (20, 4), (3, 8), (0, 2), (1000, 7)):
        assert partitioner_row_counts(total, k) == jcounts(total, k)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def _json_keys_of_reference_cli(tmp_path, capsys):
    from tensorframes_tpu.compilecache import store_for as jstore_for
    from tensorframes_tpu.compilecache.cli import main as jmain

    root = str(tmp_path / "jcc")
    jstore_for(os.path.join(root, "aot"))
    keys = {}
    for cmd in (["stats", "--json"], ["verify", "--json"], ["prune"]):
        assert jmain(["--store", root] + cmd) == 0
        keys[cmd[0]] = set(json.loads(capsys.readouterr().out))
    assert jmain(["--store", str(tmp_path / "none"), "stats"]) == 1
    capsys.readouterr()
    return keys


def test_cli_exit_codes_json_keys_and_stale_libraries(store_dir, tmp_path, capsys,
                                                      monkeypatch):
    ref_keys = _json_keys_of_reference_cli(tmp_path, capsys)
    lib_dir = tmp_path / "libs"
    lib_dir.mkdir()
    monkeypatch.setattr(tkernels, "BUILD_DIR", lib_dir)
    current = tkernels.library_path()
    current.write_bytes(b"current")
    (lib_dir / "libtftorch_kernels-0123456789abcdef.so").write_bytes(b"stale")

    frame = tft.frame_from_arrays({"x": np.arange(8.0)})
    tft.map_blocks(tft.compile_program(lambda x: {"y": x * 9.0}, frame, **CPU), frame,
                   **CPU).collect()
    assert main_json(["--store", store_dir, "stats", "--json"], capsys, 0).keys() == \
        ref_keys["stats"] | {"libraries"}
    stats = main_json(["--store", store_dir, "stats", "--json"], capsys, 0)
    assert stats["entries"] == 1 and stats["libraries"]["current"]["file"] == current.name
    assert [r["file"] for r in stats["libraries"]["stale"]] == [
        "libtftorch_kernels-0123456789abcdef.so"]
    report = main_json(["--store", store_dir, "verify", "--json"], capsys, 0)
    assert report.keys() == ref_keys["verify"] | {"libraries"} and report["good"] == 1

    path = os.path.join(store_dir, "aot", _entries(store_dir)[0])
    with open(path, "r+b") as f:
        f.seek(-1, os.SEEK_END)
        last = f.read(1)
        f.seek(-1, os.SEEK_END)
        f.write(bytes([last[0] ^ 0xFF]))
    main_json(["--store", store_dir, "verify", "--json"], capsys, 1)
    main_json(["--store", store_dir, "verify", "--json", "--delete-bad"], capsys, 1)
    main_json(["--store", store_dir, "verify", "--json"], capsys, 0)
    out = main_json(["--store", store_dir, "prune", "--clear"], capsys, 0)
    assert out.keys() == ref_keys["prune"] | {"libraries_removed"}
    assert out["libraries_removed"] == ["libtftorch_kernels-0123456789abcdef.so"]
    assert sorted(p.name for p in lib_dir.iterdir()) == [current.name]
    assert cli_main(["--store", str(tmp_path / "none"), "stats"]) == 1
    assert cli_main(["--store", store_dir, "stats"]) == 0
    assert "kernel library" in capsys.readouterr().out


def main_json(argv, capsys, rc):
    assert cli_main(argv) == rc
    return json.loads(capsys.readouterr().out)


def test_cli_warm_saved_program(store_dir, tmp_path, capsys):
    frame = tft.frame_from_arrays({"x": np.arange(8.0)})
    program = tft.compile_program(lambda x: {"y": x + 2.5}, frame, **CPU)
    bundle = str(tmp_path / "prog.pt2")
    tft.save_program(program, bundle, **CPU)
    assert cli_main(["--store", store_dir, "warm", bundle, "--rows", "8,9",
                     "--device", "cpu"]) == 0
    assert "compiled=2" in capsys.readouterr().out
    assert len(_entries(store_dir)) == 2


def test_exports_are_the_references():
    import tensorframes_tpu.analysis as janalysis
    import tensorframes_tpu.compilecache as jcc
    import tensorframes_tpu_torch.analysis as tanalysis
    import tensorframes_tpu_torch.compilecache as tcc

    assert sorted(tcc.__all__) == sorted(jcc.__all__)
    assert sorted(tanalysis.__all__) == sorted(janalysis.__all__)
    for name in ("analyze_frame", "lint_plan", "lint_program", "StaticAnalysisError",
                 "WarmupReport", "warmup", "analysis", "compilecache"):
        assert hasattr(tfs, name) and hasattr(tft, name), name


def test_store_for_is_memoized_per_root(tmp_path):
    a = store_for(str(tmp_path / "s"))
    assert a is store_for(str(tmp_path / "s")) and isinstance(a, CompileCacheStore)
