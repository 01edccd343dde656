"""The replint CLI:
``python -m repro_torch.analysis [--strict] [paths...]``.

Prints one ``path:line:col RULE-ID message`` line per finding (sorted),
a one-line summary on stderr, and exits 0 (clean), 1 (findings), or 2
(usage error). ``--json FILE`` additionally writes the machine-readable
report (``-`` for stdout) — the artifact the CI lint job uploads.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Optional, Sequence

from repro_torch.analysis.registry import all_rules, known
from repro_torch.analysis.runner import lint_paths

_DEFAULT_PATHS = ("src",)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="replint: AST-based repo-invariant checker "
                    "(DESIGN.md §13)")
    ap.add_argument("paths", nargs="*", default=list(_DEFAULT_PATHS),
                    help="files or directories to lint "
                         f"(default: {' '.join(_DEFAULT_PATHS)})")
    ap.add_argument("--strict", action="store_true",
                    help="escalate warnings (unused suppressions) to "
                         "errors — the CI gate mode")
    ap.add_argument("--json", metavar="FILE", default=None,
                    help="write the machine-readable report to FILE "
                         "('-' for stdout)")
    ap.add_argument("--rules", metavar="ID[,ID...]", default=None,
                    help="run only these rule ids")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog and exit")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.list_rules:
        for r in all_rules():
            print(f"{r.id:12s} [{r.kind}] {r.contract}")
        return 0
    only = None
    if args.rules is not None:
        only = [s.strip() for s in args.rules.split(",") if s.strip()]
        unknown = sorted(set(only) - set(known()))
        if unknown:
            print(f"unknown rule id(s) {unknown}; registered: "
                  f"{list(known())}", file=sys.stderr)
            return 2
    try:
        report = lint_paths(args.paths, strict=args.strict, only=only)
    except FileNotFoundError as e:
        print(f"replint: {e}", file=sys.stderr)
        return 2
    for d in report.diagnostics:
        print(d.format())
    if args.json is not None:
        doc = report.to_dict()
        if args.json == "-":
            json.dump(doc, sys.stdout, indent=2, allow_nan=False)
            print()
        else:
            with open(args.json, "w") as f:
                json.dump(doc, f, indent=2, allow_nan=False)
    print(f"replint: {len(report.errors)} error(s), "
          f"{len(report.warnings)} warning(s) in "
          f"{len(report.files)} file(s)"
          + (" [strict]" if report.strict else ""),
          file=sys.stderr)
    return report.exit_code
