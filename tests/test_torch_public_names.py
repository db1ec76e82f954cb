"""Each ported module's public names against the JAX package's.

For every module of ``tensorframes_tpu_torch`` with a counterpart in
``tensorframes_tpu``, the counterpart's public names must all be names
of the port's module, but for the written exceptions below. A
counterpart's public names are its ``__all__`` where it has one, else
every name not starting with ``_`` that it defines itself: its own
functions and classes and its constants (modules, and functions and
classes imported from elsewhere such as typing's, are left out). Each
exception must still be missing from the port, so a name leaves the list
when it is ported.
"""

from __future__ import annotations

import importlib
import inspect
import types
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "tensorframes_tpu_torch"
REF = ROOT / "tensorframes_tpu"

# names the JAX package has only because it runs on JAX: Pallas
# interpret-mode switches and dispatch bookkeeping, the Pallas kernels'
# own entry points and emulations (the port's kernels and plain versions
# take other names), XLA's jit, donation and closed-jaxpr machinery, the
# TPU's 64-bit demotion, ml_dtypes' dtype names
JAX_ONLY = {
    "kernels": {"build_timer", "enabled", "fingerprint_token", "force_active",
                "interpret_mode", "note_dispatch"},
    "kernels.ragged_gather": {"gather_reference"},
    "kernels.segment_reduce": {"segment_reduce_pallas", "segment_reduce_reference"},
    "ops.quantize": {"matmul_pallas_int8", "reset_pallas_int8"},
    "ops.executor": {"pair_fold_body", "aot_jit", "donation_supported"},
    "ops.segment": {"disable_pallas", "pallas_enabled", "segment_sum_pallas",
                    "host_segment_eligible", "segment_reduce_host"},
    "program": {"HoistedProgram"},
    "compilecache.fingerprint": {"fingerprint_from_closed"},
    "analysis.selfcheck": {"ALLOW_JAX_JIT"},
    "dtypes": {"demote", "demotion_active"},
    "utils.npz": {"np_dtype_from_name"},
}
# a recorded difference (ROADMAP.md): the port's kernels take the segment
# count as an argument, so it is never bucketed
RECORDED = {
    "plan": {"decide_segment_bucket"},
    "plan.rules": {"decide_segment_bucket", "warm_segment_bucket"},
}
# logger objects
LOGGERS = {
    "frame": {"logger"},
    "ops.attention": {"logger"},
    "parallel.pipeline": {"logger"},
}
# fleet supervision, the next slice
FLEET_SUPERVISION = {
    "": {"supervise"},
    "resilience": {"supervise", "RankFailure", "SuperviseResult", "SuperviseError",
                   "FleetMonitor", "enroll", "ABORT_EXIT_CODE"},
    "resilience.fleet": {"FleetMonitor", "FleetMember", "current_member", "enroll",
                         "ABORT_EXIT_CODE"},
}
EXCEPTIONS = {}
for table in (JAX_ONLY, RECORDED, LOGGERS, FLEET_SUPERVISION):
    for mod, names in table.items():
        EXCEPTIONS.setdefault(mod, set()).update(names)


def _module_names():
    out = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(PORT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__main__":
            continue
        if parts[-1] == "__init__":
            parts = parts[:-1]
        ref = REF.joinpath(*parts).with_suffix(".py") if parts else REF / "__init__.py"
        if not (ref.exists() or (REF.joinpath(*parts) / "__init__.py").exists()):
            continue
        out.append(".".join(parts))
    return out


MODULES = _module_names()


def reference_public(mod) -> set:
    if hasattr(mod, "__all__"):
        return set(mod.__all__)
    out = set()
    for name, value in vars(mod).items():
        if name.startswith("_") or isinstance(value, types.ModuleType):
            continue
        origin = getattr(value, "__module__", None)
        if (inspect.isfunction(value) or inspect.isclass(value)) and origin != mod.__name__:
            continue
        if origin == "typing":
            continue
        out.add(name)
    return out


def _pair(rel: str):
    suffix = f".{rel}" if rel else ""
    return (importlib.import_module(f"tensorframes_tpu{suffix}"),
            importlib.import_module(f"tensorframes_tpu_torch{suffix}"))


def test_every_ported_module_with_a_counterpart_is_checked():
    assert len(MODULES) > 80
    for rel in ("observability", "models.generation", "ops.attention", "models.transformer",
                "models.moe", "parallel", "parallel.pipeline"):
        assert rel in MODULES


def _id(rel):
    return rel or "<package>"


@pytest.mark.parametrize("rel", MODULES, ids=_id)
def test_public_names_are_the_references(rel):
    ref, port = _pair(rel)
    have = set(dir(port))
    missing = sorted(reference_public(ref) - have - EXCEPTIONS.get(rel, set()))
    assert not missing, f"tensorframes_tpu_torch.{rel} lacks {missing}"


@pytest.mark.parametrize("rel", sorted(EXCEPTIONS), ids=_id)
def test_each_exception_is_still_missing(rel):
    """A name ported leaves the list: an exception the port now has is
    stale."""
    ref, port = _pair(rel)
    assert EXCEPTIONS[rel] <= reference_public(ref), sorted(EXCEPTIONS[rel] - reference_public(ref))
    present = sorted(n for n in EXCEPTIONS[rel] if hasattr(port, n))
    assert not present, f"tensorframes_tpu_torch.{rel} now has {present}: drop them from the list"


def test_this_slices_names_are_ported():
    import tensorframes_tpu_torch.models.generation as gen
    import tensorframes_tpu_torch.models.moe as moe
    import tensorframes_tpu_torch.models.transformer as tr
    import tensorframes_tpu_torch.observability as obs
    import tensorframes_tpu_torch.ops.attention as att
    import tensorframes_tpu_torch.parallel as par

    for mod, names in ((obs, ("Counter", "Gauge", "Histogram", "MetricsRegistry", "gauge",
                              "TRACER", "Tracer", "merge_traces")),
                       (gen, ("kv_cache_nbytes",)),
                       (att, ("ring_attention", "ulysses_attention", "paged_decode_attention")),
                       (tr, ("param_shardings", "make_sharded_train_step")),
                       (moe, ("moe_ffn", "moe_ffn_ep", "make_ep_train_step", "scoring_program")),
                       (par, ("pipeline_apply", "make_pp_train_step"))):
        for name in names:
            assert callable(getattr(mod, name)) or name == "TRACER", (mod.__name__, name)
    assert set(obs.__all__) == set(importlib.import_module("tensorframes_tpu.observability").__all__)


def test_kv_cache_nbytes_measures_the_ports_cache_like_the_references():
    import tensorframes_tpu.models.generation as jgen
    import tensorframes_tpu_torch.models.generation as gen

    for quant in (False, True):
        jcfg, cfg = jgen.gpt_tiny(), gen.gpt_tiny()
        want = jgen.kv_cache_nbytes(jgen.init_kv_cache(jcfg, 2, 16, quant=quant))
        got = gen.kv_cache_nbytes(gen.init_kv_cache(cfg, 2, 16, quant=quant, device="cpu"))
        assert got == want, (quant, got, want)


def test_logreg_loss_and_train_step_match_the_reference():
    import jax.numpy as jnp
    import numpy as np
    import optax
    import torch

    import tensorframes_tpu.models.logreg as jlr
    import tensorframes_tpu_torch.models.logreg as lr

    x, y = jlr.make_synthetic_mnist(64, seed=0)
    jp = jlr.init_params(seed=0)
    p = lr.params_from_jax({k: np.asarray(v) for k, v in jp.items()}, device="cpu")
    want = jlr.loss_fn(jp, jnp.asarray(x), jnp.asarray(y))
    got = lr.loss_fn(p, torch.from_numpy(x), torch.from_numpy(y))
    assert abs(float(got) - float(want)) <= 1e-6
    tx = optax.sgd(0.5)
    jp2, _, jl = jlr.train_step(jp, tx.init(jp), jnp.asarray(x), jnp.asarray(y), tx)
    opt = torch.optim.SGD(list(p.values()), lr=0.5)
    for t in p.values():
        t.requires_grad_(True)
    p2, _, loss = lr.train_step(p, opt.state, torch.from_numpy(x), torch.from_numpy(y), opt)
    assert abs(float(loss) - float(jl)) <= 1e-6
    for k in ("w", "b"):
        np.testing.assert_allclose(p2[k].detach().numpy(), np.asarray(jp2[k]), rtol=0,
                                   atol=1e-6)


def test_annotate_names_a_profiler_range_and_a_span():
    from tensorframes_tpu_torch.utils import profiling

    profiling.reset_metrics()
    with profiling.annotate("region"):
        pass
    assert profiling.metrics()["region"].calls == 1
