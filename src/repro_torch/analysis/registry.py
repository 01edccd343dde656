"""Rule registry: replint rules register by id, mirroring the sim
component registry (`repro_torch.sim.registry`) — decorated
registration from anywhere, loud unknown-name errors listing what IS
registered, last registration wins so tests can swap a rule
implementation in place.

Two rule kinds:

  file     an AST pass over one Python file — `check_file(ctx)` yields
           diagnostics for that file alone (RNG-DET, WALLCLOCK, ...);
  project  a cross-artifact pass over the whole scanned file set plus
           non-Python artifacts — `check_project(pctx)` (OBS-PARITY,
           which diffs code-emitted metric names against the DESIGN.md
           §11 namespace table).

A rule is a class with `id`, `kind`, a one-line `contract` (the docs /
`--list-rules` surface), and the matching check method; instances are
constructed once per lint run.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple, Type

KINDS = ("file", "project")

_RULES: Dict[str, Type] = {}


class Rule:
    """Base class: subclasses set `id`, `kind`, `contract` and override
    the check method for their kind. Yielded diagnostics carry the
    rule's id — the registry asserts that at collection time so a rule
    cannot emit under another rule's name."""
    id: str = ""
    kind: str = "file"
    contract: str = ""

    def check_file(self, ctx):
        """File rules: yield Diagnostic for one FileContext."""
        return iter(())

    def check_project(self, pctx):
        """Project rules: yield Diagnostic across the file set."""
        return iter(())


def rule(rule_id: str, kind: str = "file") -> Callable:
    """Decorator: register a Rule subclass under `rule_id`."""
    if kind not in KINDS:
        raise ValueError(f"unknown rule kind {kind!r}; choose from "
                         f"{KINDS}")

    def deco(cls: Type) -> Type:
        cls.id = rule_id
        cls.kind = kind
        _RULES[rule_id] = cls
        return cls
    return deco


def known() -> Tuple[str, ...]:
    return tuple(sorted(_RULES))


def resolve(rule_id: str) -> Type:
    try:
        return _RULES[rule_id]
    except KeyError:
        raise ValueError(f"unknown rule {rule_id!r}; registered: "
                         f"{list(known())}") from None


def all_rules(only=None) -> Tuple[Rule, ...]:
    """Fresh instances of every registered rule (or the `only` subset),
    in id order."""
    ids = known() if only is None else tuple(only)
    return tuple(resolve(rid)() for rid in ids)
