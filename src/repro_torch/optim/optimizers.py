"""Optimizers of the synchronous path (port of the `sgd` and `momentum`
entries of `repro/optim/optimizers.py`).

API: opt = make_optimizer(name); state = opt.init(params);
opt.update(grads, state, params, lr) updates `params` and `state` IN
PLACE (lists of tensors; the reference returns new pytrees).
`momentum` equals `torch.optim.SGD(momentum=beta, dampening=0,
nesterov=False)`: m = beta m + g; p = p - lr m.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch


@dataclasses.dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable[[Any], Any]
    update: Callable[..., Any]


def sgd() -> Optimizer:
    def init(params):
        return {"step": 0}

    @torch.no_grad()
    def update(grads, state, params, lr):
        torch._foreach_add_(list(params), list(grads), alpha=-lr)
        state["step"] += 1

    return Optimizer("sgd", init, update)


def momentum(beta: float = 0.9) -> Optimizer:
    def init(params):
        return {"m": [torch.zeros_like(p, dtype=torch.float32)
                      for p in params], "step": 0}

    @torch.no_grad()
    def update(grads, state, params, lr):
        m = state["m"]
        torch._foreach_mul_(m, beta)
        torch._foreach_add_(m, list(grads))
        torch._foreach_add_(list(params), m, alpha=-lr)
        state["step"] += 1

    return Optimizer("momentum", init, update)


_OPTIMIZERS = {"sgd": sgd, "momentum": momentum}


def make_optimizer(name: str, **hp) -> Optimizer:
    if name not in _OPTIMIZERS:
        raise ValueError(f"unknown optimizer {name!r}; this port has "
                         f"{sorted(_OPTIMIZERS)}")
    return _OPTIMIZERS[name](**hp)
