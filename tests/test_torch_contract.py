"""Contracts of the PyTorch port that are not numbers:

* it stands alone — importing ``tensorframes_tpu_torch`` (every module)
  and ``chip_smoke`` loads neither JAX nor ``tensorframes_tpu``;
* its schema, shape, dtype and validation error messages equal the JAX
  package's, word for word;
* a verb with no GPU and no ``device="cpu"`` raises instead of running on
  the CPU, and ``chip_smoke.py`` exits nonzero with no result;
* the kernel registry names real sources and the Pallas kernels they
  replace. The kernel-on-card checks live in ``test_torch_on_card.py``
  (marker ``cuda``), which imports no JAX so that it runs on a GPU
  machine without it; here they skip.
"""

import ast
import importlib
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import tensorframes_tpu as tfs
from tensorframes_tpu import dtypes as jdt
from tensorframes_tpu import program as jprog
from tensorframes_tpu import shape as jshape
from tensorframes_tpu import validation as jval

import tensorframes_tpu_torch as tft
from tensorframes_tpu_torch import dtypes as tdt
from tensorframes_tpu_torch import program as tprog
from tensorframes_tpu_torch import shape as tshape
from tensorframes_tpu_torch import validation as tval

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "tensorframes_tpu_torch"


# ---------------------------------------------------------------------------
# standing alone
# ---------------------------------------------------------------------------

def _port_modules():
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_port_and_chip_smoke_import_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {_port_modules()!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'tensorframes_tpu' or m.startswith('tensorframes_tpu.'))\n"
        "print(bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_port_imports_and_runs_without_pandas():
    """The card's machine has no pandas: with ``import pandas`` made to
    fail, every module of the port imports, and the verbs and the
    relational frame ops run (the pandas forms import it only when
    called)."""
    code = (
        "import importlib, sys\n"
        "sys.modules['pandas'] = None\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "import numpy as np\n"
        "import tensorframes_tpu_torch as t\n"
        "f = t.frame_from_arrays({'k': np.arange(6) % 2, 'x': np.arange(6.0)}, num_blocks=2)\n"
        "f = f.filter(lambda x: {'m': x > 0.5}, device='cpu').sort_values('x', ascending=False)\n"
        "c = t.map_blocks(lambda x: {'z': x + 1}, f, device='cpu')\n"
        "print(c.column_values('z').tolist(), f.group_by('k').count(device='cpu').column_values('count').tolist())\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[6.0, 5.0, 4.0, 3.0, 2.0] [2, 3]", out.stdout


def test_importer_modules_import_neither_tensorflow_nor_jax():
    """The GraphDef/SavedModel importer, its bundle reader and VGG-16 are
    among the modules checked above, and importing them (with the
    package's entry points ``load_graphdef`` … ``load_program``) loads no
    TensorFlow: it is imported only by ``load_saved_model``'s fallback."""
    mods = ["tensorframes_tpu_torch.graphdef", "tensorframes_tpu_torch.bundle",
            "tensorframes_tpu_torch.models.vgg"]
    assert set(mods) <= set(_port_modules())
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "import tensorframes_tpu_torch as t\n"
        "for name in ('load_graphdef', 'program_from_graphdef', 'parse_graphdef',\n"
        "             'load_saved_model', 'save_program', 'load_program'):\n"
        "    assert callable(getattr(t, name)), name\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'tensorflow', 'keras', 'tensorframes_tpu'))\n"
        "print(bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(ROOT)) for p in PORT.rglob("*.py")]
    + ["chip_smoke.py", "flash_forward_ab.py", "serving_kernels_ab.py",
       "segment_kernels_ab.py", "ragged_gather_ab.py", "tests/test_torch_on_card.py"]
))
def test_no_source_imports_jax_or_the_reference(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        for n in names:
            top = n.split(".")[0]
            assert top not in ("jax", "jaxlib", "tensorframes_tpu"), (path, n)


# ---------------------------------------------------------------------------
# error messages equal the reference's
# ---------------------------------------------------------------------------

def _message(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the message is the assertion
        return type(e).__name__, str(e)
    raise AssertionError("expected an exception")


def _both(fn):
    return _message(lambda: fn(jshape, jdt, tfs)), _message(lambda: fn(tshape, tdt, tft))


_SHAPE_DTYPE_ERRORS = {
    "negative_dim": lambda sh, dt, pkg: sh.Shape([-2]),
    "two_unknowns": lambda sh, dt, pkg: sh.infer_physical_shape(6, sh.Shape([-1, -1])),
    "not_divisible": lambda sh, dt, pkg: sh.infer_physical_shape(7, sh.Shape([-1, 2])),
    "count_mismatch": lambda sh, dt, pkg: sh.infer_physical_shape(7, sh.Shape([3, 2])),
    "scalar_tail": lambda sh, dt, pkg: sh.Shape([]).tail,
    "unknown_name": lambda sh, dt, pkg: dt.by_name("complex64"),
    "unsupported_dtype": lambda sh, dt, pkg: dt.from_numpy(np.complex64),
    "unsupported_cell": lambda sh, dt, pkg: dt.from_python_value(object()),
    "missing_column": lambda sh, dt, pkg: pkg.frame_from_arrays(
        {"x": np.zeros(3)}).schema["nope"],
    "ragged_rows": lambda sh, dt, pkg: pkg.frame_from_arrays(
        {"x": np.zeros(3), "y": np.zeros(4)}),
    "group_by_missing": lambda sh, dt, pkg: pkg.frame_from_arrays(
        {"x": np.zeros(3)}).group_by("k"),
}


@pytest.mark.parametrize("case", sorted(_SHAPE_DTYPE_ERRORS))
def test_shape_schema_dtype_errors_match(case):
    ref, port = _both(_SHAPE_DTYPE_ERRORS[case])
    assert port == ref


def _schema(pkg, **cols):
    return pkg.frame_from_arrays(cols).schema


def _prog(mod, dt, specs, outs=()):
    return mod.Program(
        lambda feeds: feeds,
        [mod.TensorSpec(n, dt.by_name(t), (jshape if mod is jprog else tshape).Shape(s))
         for n, t, s in specs],
        [mod.TensorSpec(n, dt.by_name(t), (jshape if mod is jprog else tshape).Shape(s))
         for n, t, s in outs],
    )


_F32 = np.arange(6, dtype=np.float32)
_VEC = np.zeros((6, 2), dtype=np.float32)

_VALIDATION = {
    "map_unmatched": ("validate_map", [("zz", "float32", [-1])], [], {"x": _F32},
                      {"block": True}),
    "map_dtype": ("validate_map", [("x", "float64", [-1])], [], {"x": _F32}, {"block": True}),
    "map_rank": ("validate_map", [("y", "float32", [-1])], [], {"y": _VEC}, {"block": True}),
    "map_incompatible": ("validate_map", [("y", "float32", [-1, 3])], [], {"y": _VEC},
                         {"block": True}),
    "map_collision": ("validate_map", [("x", "float32", [-1])], [("x", "float32", [-1])],
                      {"x": _F32}, {"block": True}),
    "map_scalar_out": ("validate_map", [("x", "float32", [-1])], [("s", "float32", [])],
                       {"x": _F32}, {"block": True}),
    "rb_missing_col": ("validate_reduce_blocks", [("q_input", "float32", [-1])],
                       [("q", "float32", [])], {"x": _F32}, {}),
    "rb_inputs": ("validate_reduce_blocks", [("z_input", "float32", [-1])],
                  [("x", "float32", [])], {"x": _F32}, {}),
    "rb_dtype": ("validate_reduce_blocks", [("x_input", "float32", [-1])],
                 [("x", "float64", [])], {"x": _F32}, {}),
    "rb_rank": ("validate_reduce_blocks", [("x_input", "float32", [-1])],
                [("x", "float32", [2])], {"x": _F32}, {}),
    "rr_missing_col": ("validate_reduce_rows", [("q_1", "float32", []), ("q_2", "float32", [])],
                       [("q", "float32", [])], {"x": _F32}, {}),
    "rr_inputs": ("validate_reduce_rows", [("x_1", "float32", [])], [("x", "float32", [])],
                  {"x": _F32}, {}),
    "rr_rank": ("validate_reduce_rows", [("y_1", "float32", []), ("y_2", "float32", [])],
                [("y", "float32", [2])], {"y": _VEC}, {}),
    "rr_incompatible": ("validate_reduce_rows",
                        [("y_1", "float32", [3]), ("y_2", "float32", [3])],
                        [("y", "float32", [3])], {"y": _VEC}, {}),
}


@pytest.mark.parametrize("case", sorted(_VALIDATION))
def test_validation_errors_match(case):
    fn, ins, outs, cols, kw = _VALIDATION[case]
    ref = _message(lambda: getattr(jval, fn)(
        _prog(jprog, jdt, ins, outs), _schema(tfs, **cols), **kw))
    port = _message(lambda: getattr(tval, fn)(
        _prog(tprog, tdt, ins, outs), _schema(tft, **cols), **kw))
    assert ref[0] == "ValidationError"
    assert port == ref


def test_verb_runtime_errors_match():
    def ragged_block(pkg, dev):
        df = pkg.frame_from_rows([{"r": [1.0, 2.0]}, {"r": [3.0]}], num_blocks=1)
        with pkg.with_graph():
            r = pkg.placeholder(np.float64, (None, None), name="r")
            return pkg.map_blocks(pkg.identity(r, name="o"), df, **dev).blocks()

    def feed_dict(pkg, dev):
        df = pkg.frame_from_arrays({"x": np.zeros(3)})
        with pkg.with_graph():
            p = pkg.placeholder(np.float64, (None,), name="p")
            return pkg.map_blocks(pkg.identity(p, name="o"), df, feed_dict={"zz": "x"}, **dev)

    for case in (ragged_block, feed_dict):
        assert _message(lambda: case(tft, {"device": "cpu"})) == _message(lambda: case(tfs, {}))


# ---------------------------------------------------------------------------
# no silent CPU
# ---------------------------------------------------------------------------

def test_verb_without_gpu_or_cpu_request_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tft.get_config().device == "cuda"
    df = tft.frame_from_arrays({"x": np.arange(4.0)})
    with tft.with_graph():
        x = tft.block(df, "x")
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            tft.map_blocks(tft.add(x, 1, name="z"), df)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tft.reduce_blocks(lambda x_input: {"x": x_input.sum(0)}, df)
    z = tft.map_blocks(lambda x: {"z": x + 1}, df, device="cpu")
    np.testing.assert_array_equal(z.column_values("z"), np.arange(4.0) + 1)


def test_configured_cpu_device_runs_without_a_device_argument():
    cfg = tft.get_config()
    was = cfg.device
    tft.configure(device="cpu")
    try:
        df = tft.frame_from_arrays({"x": np.arange(4.0)})
        assert tft.reduce_blocks(lambda x_input: {"x": x_input.sum(0)}, df) == 6.0
    finally:
        tft.configure(device=was)


def test_chip_smoke_refuses_without_gpu_and_alone(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: chip_smoke runs for real there")
    env = dict(os.environ)
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""


# ---------------------------------------------------------------------------
# the kernel registry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(tft.kernels.KERNELS))
def test_kernel_registry_points_at_real_sources(name):
    info = tft.kernels.KERNELS[name]
    assert (ROOT / info.source).is_file()
    path, line = info.replaces.rsplit(":", 1)
    # the JAX package's kernels by repo path; upstream JAX's (the flash
    # backward) by their path inside the installed jax
    base = Path(importlib.import_module("jax").__file__).parents[1] if path.startswith(
        "jax/") else ROOT
    text = (base / path).read_text().splitlines()[int(line) - 1]
    assert re.match(r"def \w+\(", text), text
    module, fn = info.wrapper.rsplit(".", 1)
    assert callable(getattr(importlib.import_module(module), fn))
    assert tft.kernels.LAUNCHES.snapshot()[name] >= 0


def test_cpu_tensors_do_not_count_launches():
    tft.kernels.LAUNCHES.reset()
    df = tft.frame_from_arrays({"k": np.arange(8) % 3, "v": np.arange(8, dtype=np.float32)})
    with tft.with_graph():
        tft.aggregate(tft.reduce_sum(tft.block(df, "v", tf_name="v_input"), name="v"),
                      df.group_by("k"), device="cpu")
    assert tft.kernels.LAUNCHES.snapshot() == {k: 0 for k in tft.kernels.KERNELS}


# ---------------------------------------------------------------------------
# the metrics registry
# ---------------------------------------------------------------------------

def test_metric_names_are_the_reference_packages():
    from tensorframes_tpu.observability.metrics import REGISTRY as JREG
    from tensorframes_tpu_torch.observability.metrics import REGISTRY as TREG

    import tensorframes_tpu.kernels  # noqa: F401  (registers the JAX side's kernel counters)

    ref = {d["name"] for d in JREG.snapshot()}
    port = {d["name"] for d in TREG.snapshot()}
    assert "tftpu_kernels_dispatch_total" in port
    assert port <= ref, sorted(port - ref)
    kernels = {d["labels"]["kernel"] for d in TREG.snapshot()
               if d["name"] == "tftpu_kernels_dispatch_total"}
    assert kernels == set(tft.kernels.KERNELS)


def test_counter_and_histogram_registry_semantics():
    from tensorframes_tpu_torch.observability.metrics import MetricsRegistry

    reg = MetricsRegistry()
    c = reg.counter("t_total", labels={"k": "a"})
    assert reg.counter("t_total", labels={"k": "a"}) is c
    c.inc()
    c.inc(2)
    with pytest.raises(ValueError, match="cannot decrease"):
        c.inc(-1)
    h = reg.histogram("t_seconds", buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 5.0):
        h.observe(v)
    with pytest.raises(ValueError, match="is counter"):
        reg.histogram("t_total", labels={"k": "b"})
    snap = {d["name"]: d for d in reg.snapshot()}
    assert snap["t_total"]["value"] == 3.0 and snap["t_total"]["labels"] == {"k": "a"}
    assert snap["t_seconds"]["count"] == 3 and snap["t_seconds"]["sum"] == 5.55
    assert list(snap["t_seconds"]["buckets"].values()) == [1, 2, 3]
    reg.reset()
    assert c.value == 0.0 and h.count == 0 and reg.counter("t_total", labels={"k": "a"}) is c
