"""Shared registry-hook helper for the p2p component classes (port of
`repro/p2p/params.py`).

Dependency-neutral home for `config_from_params` so every p2p module
(transport, gossip, churn, repair) can import it at module level without
creating edges between them."""
from __future__ import annotations

import dataclasses


def check_params(params: dict, allowed, what: str) -> None:
    """Reject unknown component params with a ValueError listing the
    accepted ones — a typo in a serialized sweep spec must fail loudly,
    not become a default. The one copy of this check: config dataclass
    hooks (`config_from_params`) and the sim layer's plain-function
    builders both route through it."""
    unknown = sorted(set(params) - set(allowed))
    if unknown:
        raise ValueError(f"unknown {what} param(s) {unknown}; "
                         f"allowed: {sorted(allowed)}")


def config_from_params(cfg_cls, params: dict, what: str):
    """Build a frozen config dataclass from a tagged-component params
    dict (the sim registry's hooks), rejecting unknown keys."""
    check_params(params, {f.name for f in dataclasses.fields(cfg_cls)},
                 what)
    return cfg_cls(**params)
