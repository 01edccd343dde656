"""Component registry: tagged spec configs resolve to builders by name
(port of `repro/sim/registry.py`).

A spec names components (``{"name": "push_pull", "params": {...}}``);
this registry maps ``(kind, name)`` to a builder callable
``builder(params: dict, ctx: dict) -> object``. `ctx` carries the
already-built collaborators a component may need (client count,
neighbors, the churn schedule, the gossip protocol, world dimensions) —
the build ORDER in `repro_torch.sim.build` guarantees each ctx entry
exists by the time its consumers are constructed.

New components register by name from anywhere:

    from repro_torch.sim.registry import register

    @register("transport", "starlink")
    def _build(params, ctx):
        return StarlinkTransport(n=ctx["n_clients"], **params)

and become addressable from any serialized spec without touching the
driver. Unknown names fail loudly, listing what IS registered.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

KINDS = ("transport", "gossip", "churn", "repair", "train_cost", "sizer",
         "backend", "sink", "fault", "admission", "traffic", "drift")

_REGISTRY: Dict[str, Dict[str, Callable]] = {k: {} for k in KINDS}


def register(kind: str, name: str) -> Callable:
    """Decorator: register `fn(params, ctx) -> component` under
    (kind, name). Re-registering a name overrides it (last wins), so
    downstream code can swap stock components in tests."""
    if kind not in _REGISTRY:
        raise ValueError(f"unknown component kind {kind!r}; "
                         f"choose from {KINDS}")

    def deco(fn: Callable) -> Callable:
        _REGISTRY[kind][name] = fn
        return fn
    return deco


def known(kind: str) -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY.get(kind, {})))


def resolve(kind: str, name: str) -> Callable:
    if kind not in _REGISTRY:
        raise ValueError(f"unknown component kind {kind!r}; "
                         f"choose from {KINDS}")
    try:
        return _REGISTRY[kind][name]
    except KeyError:
        raise ValueError(
            f"unknown {kind} component {name!r}; registered: "
            f"{list(known(kind))}") from None


def build(kind: str, cspec, ctx: dict):
    """Resolve `cspec.name` and invoke its builder with a COPY of the
    params (builders may pop keys) and the shared build context."""
    if cspec is None:
        return None
    return resolve(kind, cspec.name)(dict(cspec.params), ctx)
