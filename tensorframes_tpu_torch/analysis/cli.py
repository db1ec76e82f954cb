"""``python -m tensorframes_tpu_torch.analysis`` — lint serialized programs.

Positional arguments are ``save_program`` artifacts (``torch.export``
files, :func:`tensorframes_tpu_torch.program.save_program`); each is
loaded, analyzed for ``--device`` (default ``config.device``: the
artifact's weights live there) and linted without running it (the
capture runs under ``FakeTensorMode``).

``selfcheck`` as the first argument dispatches to the package's
self-lint instead (:mod:`.selfcheck`, the TFL rules):
``python -m tensorframes_tpu_torch.analysis selfcheck [paths]``.

``--demo`` builds the stock example programs (the README add-3 map, the
logreg scoring program, the geom-mean log transform), lints them,
round-trips one through a temporary artifact, and lints that too.

``--lift-report`` prints this process's verified-lift decisions
(:func:`tensorframes_tpu_torch.plan.lift.lift_report`) and exits 0.

Exit status, as the reference's: 0 on success; with ``--strict``, 1 when
any error-severity diagnostic was found; 2 on unreadable inputs.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from .analyzer import lint_program

__all__ = ["main"]


def _lint_path(path: str, args) -> "tuple[int, int]":
    """Lint one artifact; returns (n_errors, exit_hint)."""
    from ..config import resolve_device
    from ..program import analyze_program, load_program

    try:
        program = analyze_program(load_program(path),
                                  device=resolve_device(args.device or None))
    except Exception as e:
        print(f"{path}: cannot load program bundle ({type(e).__name__}: {e})",
              file=sys.stderr)
        return 0, 2
    report = lint_program(
        program,
        probe=args.probe,
        hbm_budget_bytes=args.hbm_budget,
        subject=path,
    )
    _emit(report, args)
    return len(report.errors), 0


def _emit(report, args) -> None:
    if args.json:
        payload = {
            "subject": report.subject,
            "counts": report.counts_by_severity(),
            "diagnostics": [d.to_dict() for d in report.diagnostics],
        }
        print(json.dumps(payload, sort_keys=True))
    else:
        print(report.pretty(explain=args.explain))


def _demo_reports(args) -> List:
    """The built-in example programs (the README add-3 quickstart, the
    logreg scoring program, the geom-mean log transform), each
    normalized through compile_program — captures only, nothing runs."""
    import os
    import tempfile

    import numpy as np
    import torch

    import tensorframes_tpu_torch as tft
    from tensorframes_tpu_torch.config import resolve_device
    from tensorframes_tpu_torch.models import logreg

    device = resolve_device(args.device or None)
    reports = []

    frame = tft.frame_from_arrays(
        {"x": np.arange(16, dtype=np.float32)}, num_blocks=2
    )
    add3 = tft.compile_program(lambda x: {"z": x + 3.0}, frame, device=device)
    reports.append(lint_program(add3, subject="examples: README add-3",
                                hbm_budget_bytes=args.hbm_budget))

    feats, _ = logreg.make_synthetic_mnist(8)
    lr_frame = tft.frame_from_arrays({"features": feats})
    scoring = logreg.scoring_program(logreg.init_params(device=device))
    lr_prog = tft.compile_program(
        lambda features: scoring(features), lr_frame, device=device
    )
    reports.append(lint_program(lr_prog, subject="examples: logreg scoring",
                                hbm_budget_bytes=args.hbm_budget))

    gm_frame = tft.frame_from_arrays(
        {"v": np.asarray([1.0, 2.0, 4.0], np.float64)}
    )
    with tft.with_graph():
        v = tft.block(gm_frame, "v")
        fetch = tft.apply_fn(torch.log, v, name="t")
        gm_prog = tft.compile_program(fetch, gm_frame, device=device)
    reports.append(lint_program(
        gm_prog, subject="examples: geom-mean log transform",
        hbm_budget_bytes=args.hbm_budget,
    ))

    # round-trip: export the add-3 program and lint the *file*, the path
    # the positional arguments take
    tmp = tempfile.mkdtemp(prefix="tfguard_demo.")
    bundle = os.path.join(tmp, "add3.pt2")
    try:
        tft.save_program(add3, bundle, device=device)
        from ..program import analyze_program

        loaded = analyze_program(tft.load_program(bundle), device=device)
        reports.append(lint_program(
            loaded, subject=f"examples: reloaded bundle {bundle}",
            hbm_budget_bytes=args.hbm_budget,
        ))
    finally:
        try:
            os.remove(bundle)
            os.rmdir(tmp)
        except OSError:
            pass
    return reports


def main(argv: Optional[List[str]] = None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] == "selfcheck":
        from .selfcheck import main as selfcheck_main

        return selfcheck_main(argv[1:])
    parser = argparse.ArgumentParser(
        prog="python -m tensorframes_tpu_torch.analysis",
        description="Statically lint save_program artifacts (nothing runs).",
    )
    parser.add_argument("paths", nargs="*",
                        help="program artifacts written by save_program")
    parser.add_argument("--demo", action="store_true",
                        help="lint the built-in example programs (CI mode)")
    parser.add_argument("--json", action="store_true",
                        help="one JSON object per linted subject")
    parser.add_argument("--explain", action="store_true",
                        help="include fix suggestions and rule pointers")
    parser.add_argument("--strict", action="store_true",
                        help="exit 1 when any error-severity diagnostic fires")
    parser.add_argument("--probe", type=int, default=8,
                        help="rows substituted for Unknown dims (default 8)")
    parser.add_argument("--hbm-budget", type=int, default=None,
                        help="device memory budget in bytes for TFG106 "
                             "(default: the GPU's total memory)")
    parser.add_argument("--device", default="",
                        help="device the programs run on (default: "
                             "config.device)")
    parser.add_argument("--lift-report", action="store_true",
                        help="print this process's verified-lift decisions "
                             "(lifted / declined + reason) and exit")
    args = parser.parse_args(argv)
    if args.lift_report:
        from ..plan import lift as plan_lift

        print(plan_lift.lift_report())
        return 0
    if not args.paths and not args.demo:
        parser.error("nothing to lint: pass bundle paths or --demo")

    n_errors = 0
    rc = 0
    if args.demo:
        for report in _demo_reports(args):
            _emit(report, args)
            n_errors += len(report.errors)
    for path in args.paths:
        errs, hint = _lint_path(path, args)
        n_errors += errs
        rc = max(rc, hint)
    if rc:
        return rc
    if args.strict and n_errors:
        return 1
    return 0
