"""CLI for the invariant analyzer: ``python -m repro_torch.analysis [opts] [paths]``.

Source of truth: the exit-code contract CI relies on — 0 iff the scanned
tree is violation-free (and, under ``--strict``, the registries are not
stale); 1 on any violation; 2 on usage errors.
"""
from __future__ import annotations

import argparse
import sys
import time

from repro_torch.analysis.checks import CHECK_NAMES, run_checks
from repro_torch.analysis.registry import ALLOWLIST


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="AST invariant analyzer for the CoServe repro "
                    "(determinism, epoch discipline, tracer guards, "
                    "frozen specs, source-of-truth docstrings).")
    ap.add_argument("paths", nargs="*", default=["src"],
                    help="files or directories to scan (default: src)")
    ap.add_argument("--strict", action="store_true",
                    help="treat stale registry entries as errors")
    ap.add_argument("--check", action="append", choices=CHECK_NAMES,
                    help="run only this check (repeatable; default: all)")
    ap.add_argument("--explain", action="store_true",
                    help="print the declared exemption registry and exit")
    args = ap.parse_args(argv)

    if args.explain:
        for e in ALLOWLIST:
            print(f"[{e.check}] {e.module}:{e.qualname or '*'} — {e.reason}")
        return 0

    checks = tuple(args.check) if args.check else CHECK_NAMES
    t0 = time.perf_counter()
    report = run_checks(args.paths or ["src"], checks)
    wall_s = time.perf_counter() - t0

    for v in report.violations:
        print(v.render())
    for w in report.warnings:
        print(w.render(), file=sys.stderr)
    status = "clean" if report.ok(args.strict) else "FAILED"
    print(f"repro_torch.analysis: {report.files} files, "
          f"{len(report.violations)} violation(s), "
          f"{len(report.warnings)} warning(s), "
          f"{wall_s:.2f}s — {status}")
    return 0 if report.ok(args.strict) else 1


if __name__ == "__main__":
    sys.exit(main())
