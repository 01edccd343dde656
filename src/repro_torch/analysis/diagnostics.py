"""Diagnostics and inline-suppression semantics for replint.

One finding = one `Diagnostic`: a repo-relative path, 1-based line,
0-based column, the rule id, and a message — formatted as the canonical
``path:line:col RULE-ID message`` line the CLI prints and the `--json`
report serializes.

Suppressions are inline comments::

    heap.push(evt)  # replint: ok[SET-ITER] drained through sorted()

A suppression matches the diagnostic's rule id on the SAME physical
line, or — when it is a standalone comment — on the NEXT code line, so
long statements can carry the annotation above themselves. Several ids
may share one comment (``ok[RNG-DET,WALLCLOCK]``). Two meta-rules keep
the mechanism honest (no bare suppressions):

  SUPPRESS-BARE    a suppression with no reason text — it still
                   suppresses its target (so triage isn't undone), but
                   is itself an error until a reason is written;
  SUPPRESS-UNUSED  a suppression no diagnostic consumed — reported as a
                   warning, escalated to an error under ``--strict`` so
                   stale annotations cannot rot in place.

Comments are located with `tokenize`, never by regex over raw source, so
a ``# replint:`` inside a string literal is not a suppression.
"""
from __future__ import annotations

import dataclasses
import io
import re
import tokenize
from typing import Dict, Iterable, List, Optional, Tuple

ERROR = "error"
WARNING = "warning"

_SUPPRESS_RE = re.compile(
    r"#\s*replint:\s*ok\[([A-Za-z0-9_,\s-]+)\]\s*(.*)\s*$")


@dataclasses.dataclass(frozen=True, order=True)
class Diagnostic:
    """One finding at one source location."""
    path: str          # repo-relative posix path
    line: int          # 1-based
    col: int           # 0-based (ast convention)
    rule_id: str
    message: str
    severity: str = ERROR

    def format(self) -> str:
        return f"{self.path}:{self.line}:{self.col} {self.rule_id} " \
               f"{self.message}"

    def to_dict(self) -> dict:
        return {"path": self.path, "line": self.line, "col": self.col,
                "rule": self.rule_id, "message": self.message,
                "severity": self.severity}


@dataclasses.dataclass
class Suppression:
    """One parsed ``# replint: ok[...]`` comment."""
    line: int                  # line the comment sits on
    target_line: int           # line whose diagnostics it suppresses
    rule_ids: Tuple[str, ...]
    reason: str
    used: bool = False


def parse_suppressions(source: str, path: str) -> List[Suppression]:
    """Extract every suppression comment from `source`. A comment that
    is the only content on its line targets the next line; a trailing
    comment targets its own line."""
    out: List[Suppression] = []
    try:
        tokens = list(tokenize.generate_tokens(
            io.StringIO(source).readline))
    except (tokenize.TokenError, SyntaxError, IndentationError):
        return out
    for tok in tokens:
        if tok.type != tokenize.COMMENT:
            continue
        m = _SUPPRESS_RE.search(tok.string)
        if m is None:
            continue
        line = tok.start[0]
        # standalone comment (nothing but whitespace before it) targets
        # the next line; a trailing comment targets its own
        standalone = tok.line[: tok.start[1]].strip() == ""
        ids = tuple(s.strip() for s in m.group(1).split(",") if s.strip())
        out.append(Suppression(
            line=line,
            target_line=line + 1 if standalone else line,
            rule_ids=ids,
            reason=m.group(2).strip()))
    return out


def apply_suppressions(
        diags: Iterable[Diagnostic],
        supps_by_path: Dict[str, List[Suppression]],
        strict: bool = False) -> List[Diagnostic]:
    """Filter suppressed diagnostics and append the meta-diagnostics
    (SUPPRESS-BARE always an error; SUPPRESS-UNUSED a warning, an error
    under strict)."""
    index: Dict[Tuple[str, int, str], Suppression] = {}
    for path, supps in supps_by_path.items():
        for s in supps:
            for rid in s.rule_ids:
                index[(path, s.target_line, rid)] = s

    kept: List[Diagnostic] = []
    for d in diags:
        s = index.get((d.path, d.line, d.rule_id))
        if s is None:
            kept.append(d)
        else:
            s.used = True
    for path, supps in sorted(supps_by_path.items()):
        for s in supps:
            if not s.reason:
                kept.append(Diagnostic(
                    path, s.line, 0, "SUPPRESS-BARE",
                    f"suppression ok[{','.join(s.rule_ids)}] has no "
                    "reason — every suppression must say why"))
            if not s.used:
                kept.append(Diagnostic(
                    path, s.line, 0, "SUPPRESS-UNUSED",
                    f"suppression ok[{','.join(s.rule_ids)}] matched no "
                    "diagnostic — stale annotation",
                    severity=ERROR if strict else WARNING))
    return sorted(kept)


def find_suppressible(supps: List[Suppression], line: int,
                      rule_id: str) -> Optional[Suppression]:
    """Lookup helper for tests: the suppression covering (line, rule)."""
    for s in supps:
        if s.target_line == line and rule_id in s.rule_ids:
            return s
    return None
