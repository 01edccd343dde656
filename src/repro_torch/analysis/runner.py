"""File collection and the lint driver: paths -> parsed contexts ->
file rules + project rules -> suppression filtering -> Report.

`lint_paths` is the one entry point the CLI and the tests share. Paths
may be files or directories (recursed for ``*.py``, skipping
``__pycache__`` and hidden directories); diagnostics are reported
repo-relative to `root` (default: the current working directory), so
CI output and local output agree.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence

from repro_torch.analysis import parity  # noqa: F401  (OBS-PARITY)
from repro_torch.analysis import rules as _rules  # noqa: F401
from repro_torch.analysis.diagnostics import (ERROR, WARNING, Diagnostic,
                                              apply_suppressions,
                                              parse_suppressions)
from repro_torch.analysis.registry import all_rules
from repro_torch.analysis.rules import FileContext

REPORT_VERSION = 1


@dataclasses.dataclass
class _DesignDoc:
    rel: str
    text: str


@dataclasses.dataclass
class ProjectContext:
    """What project rules see: every parsed FileContext plus the
    project-root DESIGN.md (None when absent)."""
    root: str
    contexts: List[FileContext]
    design_md: Optional[_DesignDoc] = None


@dataclasses.dataclass
class Report:
    diagnostics: List[Diagnostic]
    files: List[str]
    strict: bool
    rule_ids: List[str]

    @property
    def errors(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == ERROR]

    @property
    def warnings(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == WARNING]

    @property
    def exit_code(self) -> int:
        return 1 if self.errors else 0

    def to_dict(self) -> dict:
        by_rule: Dict[str, int] = {}
        for d in self.diagnostics:
            by_rule[d.rule_id] = by_rule.get(d.rule_id, 0) + 1
        return {
            "version": REPORT_VERSION,
            "strict": self.strict,
            "rules": self.rule_ids,
            "files_checked": len(self.files),
            "diagnostics": [d.to_dict() for d in self.diagnostics],
            "summary": {"errors": len(self.errors),
                        "warnings": len(self.warnings),
                        "by_rule": dict(sorted(by_rule.items()))},
        }


def collect_files(paths: Sequence[str]) -> List[str]:
    """Expand files/directories into a sorted, deduplicated list of
    .py files. Unknown paths raise — a typo'd CI path must fail loudly,
    not lint nothing."""
    out: List[str] = []
    for p in paths:
        if os.path.isfile(p):
            out.append(p)
        elif os.path.isdir(p):
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = sorted(
                    d for d in dirnames
                    if not d.startswith(".") and d != "__pycache__")
                out.extend(os.path.join(dirpath, f)
                           for f in sorted(filenames)
                           if f.endswith(".py"))
        else:
            raise FileNotFoundError(f"no such file or directory: {p!r}")
    seen, uniq = set(), []
    for f in out:
        if f not in seen:
            seen.add(f)
            uniq.append(f)
    return sorted(uniq)


def _relpath(path: str, root: str) -> str:
    rel = os.path.relpath(os.path.abspath(path), root)
    return rel.replace(os.sep, "/")


def lint_paths(paths: Sequence[str], root: Optional[str] = None,
               strict: bool = False,
               only: Optional[Sequence[str]] = None) -> Report:
    """Lint `paths` with every registered rule (or the `only` subset).
    Returns the full Report; `Report.exit_code` is what the CLI exits
    with."""
    root = os.path.abspath(root or os.getcwd())
    files = collect_files(paths)
    active = all_rules(only)
    contexts: List[FileContext] = []
    diags: List[Diagnostic] = []
    supps: Dict[str, list] = {}
    rels: List[str] = []
    for f in files:
        rel = _relpath(f, root)
        rels.append(rel)
        with open(f, encoding="utf-8") as fh:
            source = fh.read()
        try:
            ctx = FileContext(f, rel, source)
        except SyntaxError as e:
            diags.append(Diagnostic(rel, e.lineno or 1, 0, "PARSE",
                                    f"syntax error: {e.msg}"))
            continue
        contexts.append(ctx)
        supps[rel] = parse_suppressions(source, rel)
        for r in active:
            if r.kind == "file":
                diags.extend(r.check_file(ctx))
    design = os.path.join(root, "DESIGN.md")
    pctx = ProjectContext(root=root, contexts=contexts)
    if os.path.isfile(design):
        with open(design, encoding="utf-8") as fh:
            pctx.design_md = _DesignDoc(_relpath(design, root),
                                        fh.read())
    for r in active:
        if r.kind == "project":
            diags.extend(r.check_project(pctx))
    # a jitted function can sit inside another jitted function's walk —
    # identical findings collapse to one
    diags = sorted(set(diags))
    final = apply_suppressions(diags, supps, strict=strict)
    return Report(diagnostics=final, files=rels, strict=strict,
                  rule_ids=[r.id for r in active])
