"""``python -m tensorframes_tpu_torch.compilecache`` — the ops surface of
the persistent dispatch-key store and the kernel libraries beside it.

Subcommands, with the reference package's flags and exit codes:

* ``stats``  — entry count / bytes / per-entry metadata, and the kernel
  libraries (the current one, the stale ones);
* ``warm``   — dispatch ``save_program`` artifacts at given row counts,
  recording their keys in the store;
* ``prune``  — LRU-evict to a byte bound, or ``--clear`` everything; and
  remove kernel libraries built from older sources;
* ``verify`` — CRC + header check of every entry (``--delete-bad``
  quarantines the defective ones); exit 1 when any is bad.

The store directory comes from ``--store`` or ``TFTPU_COMPILE_CACHE``
(the entries live under ``<dir>/aot``). ``warm`` dispatches on
``--device`` (default: the configured device, the GPU).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional


def _resolve_store(args, create: bool = False):
    from ..config import get_config
    from .store import store_for

    root = args.store or get_config().compilation_cache_dir
    if not root:
        print("no store: pass --store DIR or set TFTPU_COMPILE_CACHE",
              file=sys.stderr)
        return None
    aot = os.path.join(root, "aot")
    if not create and not os.path.isdir(aot):
        print(f"no store at {aot} (empty cache is a valid state: "
              "stats would be all zeros)", file=sys.stderr)
        return None
    return store_for(aot)


def _cmd_stats(args) -> int:
    store = _resolve_store(args)
    if store is None:
        return 1
    s = store.stats()
    if args.json:
        print(json.dumps(s, sort_keys=True))
        return 0
    print(f"store: {s['root']}")
    print(f"entries: {s['entries']}  bytes: {s['bytes']:,}  "
          f"bound: {s['max_bytes']:,}  manifest rows: {s['manifest_rows']}")
    for e in s["entry_list"]:
        if e.get("unreadable"):
            print(f"  {e['fingerprint'][:16]}…  {e['bytes']:>10,}B  "
                  "UNREADABLE (run verify)")
            continue
        ins = ",".join(
            f"{n}:{'x'.join(str(d) for d in shp)}:{dt}"
            for (n, shp, dt) in e.get("inputs", [])
        )
        print(f"  {e['fingerprint'][:16]}…  {e['bytes']:>10,}B  "
              f"{e.get('kind', '?'):5} {e.get('device_kind', '?')} {ins}")
    libs = s["libraries"]
    cur = libs["current"]
    print(f"kernel library ({libs['dir']}): "
          + (f"{cur['file']} {cur['bytes']:,}B" if cur else "not built")
          + f"; stale: {len(libs['stale'])}")
    for row in libs["stale"]:
        print(f"  STALE {row['file']} {row['bytes']:,}B (run prune)")
    return 0


def _cmd_warm(args) -> int:
    store = _resolve_store(args, create=True)
    if store is None:
        return 1
    # route the runtime at this store for the duration of the warm
    from ..config import configure

    configure(compilation_cache_dir=args.store
              or os.environ.get("TFTPU_COMPILE_CACHE", ""))
    from ..config import resolve_device
    from ..program import analyze_program, load_program
    from .warmup import WarmupReport, warm_program

    device = resolve_device(args.device or None)
    rows = [int(r) for r in args.rows.split(",") if r.strip()]
    report = WarmupReport()
    for path in args.bundles:
        program = analyze_program(load_program(path), device=device)
        warm_program(program, rows, block=(args.mode == "block"),
                     report=report, device=device)
    print(report.pretty())
    return 0 if not report.counts().get("failed") else 1


def _cmd_prune(args) -> int:
    store = _resolve_store(args)
    if store is None:
        return 1
    max_bytes = None if args.max_mb is None else args.max_mb * (1 << 20)
    out = store.prune(max_bytes=max_bytes, clear=args.clear)
    print(json.dumps(out, sort_keys=True))
    return 0


def _cmd_verify(args) -> int:
    store = _resolve_store(args)
    if store is None:
        return 1
    out = store.verify(delete_bad=args.delete_bad)
    if args.json:
        print(json.dumps(out, sort_keys=True))
    else:
        print(f"good: {out['good']}  bad: {len(out['bad'])}  "
              f"deleted: {out['deleted']}")
        for b in out["bad"]:
            print(f"  BAD {b['entry']}: {b['error']}")
        libs = out["libraries"]
        print(f"kernel library: "
              + (libs["current"]["file"] if libs["current"] else "not built")
              + f" (sources {libs['sources_hash']}); stale: "
              + (", ".join(r["file"] for r in libs["stale"]) or "none"))
    return 0 if out["ok"] else 1


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m tensorframes_tpu_torch.compilecache",
        description="Inspect and manage the persistent dispatch-key store "
                    "and the kernel libraries",
    )
    p.add_argument("--store", default="",
                   help="cache root (default: $TFTPU_COMPILE_CACHE)")
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("stats", help="entry count/bytes/metadata")
    sp.add_argument("--json", action="store_true")
    sp.set_defaults(fn=_cmd_stats)

    wp = sub.add_parser(
        "warm", help="dispatch Program artifacts, recording their keys"
    )
    wp.add_argument("bundles", nargs="+",
                    help="save_program() artifact paths")
    wp.add_argument("--rows", required=True,
                    help="comma-separated lead-dim row counts, e.g. 64,65")
    wp.add_argument("--mode", choices=("block", "rows"), default="block")
    wp.add_argument("--device", default="",
                    help="device to dispatch on (default: config.device)")
    wp.set_defaults(fn=_cmd_warm)

    pp = sub.add_parser("prune", help="LRU-evict to a byte bound")
    pp.add_argument("--max-mb", type=int, default=None)
    pp.add_argument("--clear", action="store_true",
                    help="drop every entry and the manifest")
    pp.set_defaults(fn=_cmd_prune)

    vp = sub.add_parser("verify", help="CRC-check every entry")
    vp.add_argument("--delete-bad", action="store_true")
    vp.add_argument("--json", action="store_true")
    vp.set_defaults(fn=_cmd_verify)

    args = p.parse_args(argv)
    return args.fn(args)
