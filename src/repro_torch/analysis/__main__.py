"""Command line: ``python -m repro_torch.analysis [paths] [--fix] [--select
...] [--trace-gate] [--device DEVICE]``.

The default paths are the port's package and ``chip_smoke.py`` (never all
of ``src/``: the reference package's ``resilient:pallas-*`` names are not
the port's engines).  Exit status 0 iff no findings (and, with
``--trace-gate``, every case passed); 1 otherwise.  The gate runs on the
card unless ``--device`` names another device, and raises without one.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

from repro_torch.analysis.core import (analyze_paths, apply_fixes,
                                       format_findings)

DEFAULT_PATHS = ("src/repro_torch", "chip_smoke.py")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Static analysis of the PyTorch/CUDA port: "
                    "determinism lint (DET3xx), engine contracts (CON4xx), "
                    "CUDA-kernel lint (CUD2xx).")
    ap.add_argument("paths", nargs="*", default=list(DEFAULT_PATHS),
                    help="files or directories to lint (default: "
                         f"{' '.join(DEFAULT_PATHS)})")
    ap.add_argument("--select", action="append", default=None,
                    metavar="RULE",
                    help="only report these rules / rule families "
                         "(e.g. DET305 or CUD); repeatable")
    ap.add_argument("--fix", action="store_true",
                    help="rewrite mechanically-safe findings in place")
    ap.add_argument("--trace-gate", action="store_true",
                    help="also run the trace gate over every registered "
                         "engine and kernel")
    ap.add_argument("--device", default=None,
                    help="with --trace-gate: the device it runs on "
                         "(default: the card; 'cpu' for fake tensors and "
                         "the plain versions)")
    ap.add_argument("-v", "--verbose", action="store_true",
                    help="with --trace-gate: print passing cases too")
    args = ap.parse_args(argv)

    paths = [Path(p) for p in args.paths]
    select = set(args.select) if args.select else None

    findings, n_files = analyze_paths(paths, select=select)
    if args.fix and findings:
        applied = apply_fixes(findings)
        print(f"applied {applied} fix(es); re-checking", file=sys.stderr)
        findings, n_files = analyze_paths(paths, select=select)

    if findings:
        print(format_findings(findings))
    print(f"lint: {n_files} files, {len(findings)} finding(s)",
          file=sys.stderr)
    status = 1 if findings else 0

    if args.trace_gate:
        from repro_torch.analysis import trace_gate
        t0 = time.monotonic()
        results = trace_gate.run_gate(device=args.device)
        dt = time.monotonic() - t0
        print(trace_gate.format_results(results, verbose=args.verbose))
        print(f"trace gate completed in {dt:.1f}s", file=sys.stderr)
        if any(not r.ok for r in results):
            status = 1
    return status


if __name__ == "__main__":
    sys.exit(main())
