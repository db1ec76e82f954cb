"""``python -m tensorframes_tpu_torch.observability`` — report / merge / diff.

The operational face of the observability layer:

* ``report <artifact>`` — human-readable summary of any telemetry
  artifact this repo produces (bench snapshot, ``BENCH_r*.json`` round,
  bench stdout, or a metrics-registry JSONL export), with latency
  quantiles derived where histograms are present.
  ``report --profile <sidecar-dir>`` instead renders the plan-profile
  sidecars (``plan/stats.py``): top-N slowest recorded plan stages
  across all fingerprints + the per-strategy observed-wall tables
  feeding the latency-driven ``decide_*`` flips.
* ``merge -o merged.json <shards...>`` — combine per-process trace
  shards (``events.save_shard``) from a multi-process run into one
  JSON-valid Chrome/Perfetto trace with per-process tracks. ``--dir``
  globs a shard directory instead of listing files.
* ``diff <old> <new>`` — per-metric perf comparison; exits **1** when
  any metric moved against its direction past its threshold (``--
  warn-only`` downgrades to exit 0 for noisy CPU CI runners).

All subcommands run offline on files — no card, no CUDA init, usable on
a laptop against CI artifacts.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from . import merge as _merge
from . import snapshot as _snapshot

__all__ = ["main"]


def _cmd_report(args) -> int:
    if args.profile:
        from . import profile as _profile

        print(_profile.render_report(args.profile, top=args.top))
        return 0
    if not args.path:
        print("report: pass an artifact path or --profile <sidecar-dir>",
              file=sys.stderr)
        return 2
    metrics, meta = _snapshot.load_metrics(args.path)
    print(f"# source: {meta.get('source')} ({args.path})")
    if not metrics:
        print("no metrics found")
        return 1
    latency = {k: v for k, v in metrics.items() if k.startswith("latency.")}
    plain = {k: v for k, v in metrics.items() if not k.startswith("latency.")}
    width = max(len(k) for k in metrics)
    for k in sorted(plain):
        print(f"{k:<{width}}  {plain[k]:g}")
    if latency:
        print("\n# latency quantiles (seconds)")
        for k in sorted(latency):
            print(f"{k:<{width}}  {latency[k]:.6f}")
    return 0


def _cmd_merge(args) -> int:
    paths: List[str] = list(args.shards)
    if args.dir:
        paths.extend(_merge.find_shards(args.dir, run_id=args.run_id))
    if not paths:
        print("merge: no shards given (pass files or --dir)", file=sys.stderr)
        return 2
    try:
        merged = _merge.merge_traces(paths, force=args.force)
    except ValueError as e:
        print(f"merge: {e}", file=sys.stderr)
        return 2
    with open(args.output, "w") as f:
        json.dump(merged, f)
    other = merged["otherData"]
    print(
        f"merged {other['num_shards']} shard(s), "
        f"{len(merged['traceEvents'])} events, run_id={other['run_id']} "
        f"→ {args.output} (open in https://ui.perfetto.dev)"
    )
    return 0


def _parse_per_metric(pairs: List[str]) -> dict:
    out = {}
    for p in pairs:
        name, _, val = p.partition("=")
        try:
            out[name] = float(val)
        except ValueError:
            val = ""
        if not name or not val:
            raise SystemExit(
                f"--metric expects NAME=THRESHOLD (numeric), got {p!r}"
            )
    return out


def _cmd_diff(args) -> int:
    old, old_meta = _snapshot.load_metrics(args.old)
    new, new_meta = _snapshot.load_metrics(args.new)
    result = _snapshot.diff_metrics(
        old, new, threshold=args.threshold,
        per_metric=_parse_per_metric(args.metric),
    )
    if args.json:
        json.dump(result, sys.stdout, indent=1)
        print()
    else:
        print(
            f"# old: {old_meta.get('source')} ({args.old}) — "
            f"{len(old)} metrics"
        )
        print(
            f"# new: {new_meta.get('source')} ({args.new}) — "
            f"{len(new)} metrics"
        )
        interesting = [
            r for r in result["rows"]
            if r["status"] in ("regression", "improvement")
            or args.all
        ]
        if interesting:
            w = max(len(r["metric"]) for r in interesting)
            for r in interesting:
                ratio = (
                    f"{r['ratio']:.3f}x" if r["ratio"] is not None else "-"
                )
                print(
                    f"{r['status']:<12} {r['metric']:<{w}} "
                    f"old={r['old']:g} new={r['new']:g} {ratio} "
                    f"({r['direction']} is better, thr ±{r['threshold']:g})"
                )
        for name in result["only_old"]:
            print(f"removed      {name}")
        for name in result["only_new"]:
            print(f"added        {name}")
        n_reg = len(result["regressions"])
        n_imp = len(result["improvements"])
        compared = len(result["rows"])
        print(
            f"# compared {compared} common metric(s): "
            f"{n_reg} regression(s), {n_imp} improvement(s)"
        )
    if result["regressions"]:
        if args.warn_only:
            print("# warn-only: regressions reported, exit 0")
            return 0
        return 1
    if not result["rows"]:
        # zero overlap usually means a broken/errored bench run or a
        # metric-name drift — a usage error worth failing on, EXCEPT
        # under --warn-only, whose contract is "never block the build"
        print("diff: no common metrics between the two inputs",
              file=sys.stderr)
        return 0 if args.warn_only else 2
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m tensorframes_tpu_torch.observability",
        description=__doc__.split("\n\n")[0],
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    rp = sub.add_parser(
        "report", help="summarize a telemetry artifact (metrics + quantiles)"
    )
    rp.add_argument("path", nargs="?",
                    help="snapshot / BENCH_r*.json / bench stdout "
                         "/ metrics JSONL")
    rp.add_argument("--profile", metavar="SIDECAR_DIR",
                    help="render plan-profile sidecars instead: top-N "
                         "slowest recorded stages + per-strategy "
                         "observed-wall tables")
    rp.add_argument("--top", type=int, default=10,
                    help="with --profile: how many stages (default "
                         "%(default)s)")
    rp.set_defaults(fn=_cmd_report)

    mp = sub.add_parser(
        "merge", help="merge per-process trace shards into one Chrome trace"
    )
    mp.add_argument("shards", nargs="*", help="shard files "
                                              "(events.save_shard layout)")
    mp.add_argument("--dir", help="directory to glob trace_*_p*.json from")
    mp.add_argument("--run-id", help="with --dir: only this run's shards")
    mp.add_argument("-o", "--output", required=True, help="merged trace path")
    mp.add_argument("--force", action="store_true",
                    help="merge despite run_id mismatches / duplicate ranks")
    mp.set_defaults(fn=_cmd_merge)

    dp = sub.add_parser(
        "diff", help="compare two bench artifacts; exit 1 on regression"
    )
    dp.add_argument("old", help="baseline artifact")
    dp.add_argument("new", help="candidate artifact")
    dp.add_argument("--threshold", type=float,
                    default=_snapshot.DEFAULT_THRESHOLD,
                    help="relative move that counts as a regression "
                         "(default %(default)s)")
    dp.add_argument("--metric", action="append", default=[],
                    metavar="NAME=THR",
                    help="per-metric threshold override (repeatable)")
    dp.add_argument("--warn-only", action="store_true",
                    help="report regressions but exit 0 (noisy CI runners)")
    dp.add_argument("--all", action="store_true",
                    help="print every compared metric, not just movers")
    dp.add_argument("--json", action="store_true",
                    help="machine-readable result on stdout")
    dp.set_defaults(fn=_cmd_diff)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":  # pragma: no cover - exercised via __main__
    sys.exit(main())
