"""Optimizers (port of `repro/optim/optimizers.py`): SGD, momentum, AdamW
and Adafactor.

API: opt = make_optimizer(name, **hp); state = opt.init(params);
opt.update(grads, state, params, lr) updates `params` and `state` IN
PLACE (the reference returns new pytrees). `params` and `grads` are two
lists of tensors in the same order, or two dicts of the same names (a
model's `named_parameters()`); `state["step"]` is a Python int.
`momentum` equals `torch.optim.SGD(momentum=beta, dampening=0,
nesterov=False)`: m = beta m + g; p = p - lr m.

AdamW keeps fp32 moments and is elementwise, so it updates one tensor at
a time (the fp32 temporaries stay the size of one tensor).

Adafactor is not elementwise: it factors the second moment over a
leaf's last two dims and clips by the RMS of the whole leaf. The
reference stacks the blocks' leaves on leading axes (`layers.wq` is (L,
d, H hd); a per-layer RMS scale (d,) is an (L, d) leaf there, factored
over d and L; hybrid `m_main` leaves are (n_super, every, ...)). The
port holds one tensor a block, so Adafactor groups named tensors the way
the reference stacks them (`layers.3.attn.wq` joins `layers.*.attn.wq`
at index 3) and updates each stack as the reference updates the leaf,
layer by layer (`_maybe_layerwise`) above `_LAYERWISE_BYTES`. Unnamed
lists are updated tensor by tensor.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch


@dataclasses.dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable[[Any], Any]
    update: Callable[..., Any]


# As the reference: stacked leaves of at least 3 dims above this many
# bytes of fp32 are updated one leading index at a time, which for
# Adafactor makes the clip per layer.
_LAYERWISE_BYTES = 64 * 1024 * 1024


def _tensors(tree) -> list:
    return list(tree.values()) if isinstance(tree, dict) else list(tree)


def sgd() -> Optimizer:
    def init(params):
        return {"step": 0}

    @torch.no_grad()
    def update(grads, state, params, lr):
        torch._foreach_add_(_tensors(params), _tensors(grads), alpha=-lr)
        state["step"] += 1

    return Optimizer("sgd", init, update)


def momentum(beta: float = 0.9) -> Optimizer:
    def init(params):
        return {"m": [torch.zeros_like(p, dtype=torch.float32)
                      for p in _tensors(params)], "step": 0}

    @torch.no_grad()
    def update(grads, state, params, lr):
        m = state["m"]
        torch._foreach_mul_(m, beta)
        torch._foreach_add_(m, _tensors(grads))
        torch._foreach_add_(_tensors(params), m, alpha=-lr)
        state["step"] += 1

    return Optimizer("momentum", init, update)


def _f32(x: float) -> float:
    """x rounded to float32, as the reference's weakly typed constants."""
    return float(torch.tensor(x, dtype=torch.float32))


def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        z = [torch.zeros_like(p, dtype=torch.float32)
             for p in _tensors(params)]
        return {"m": z, "v": [torch.zeros_like(t) for t in z], "step": 0}

    @torch.no_grad()
    def update(grads, state, params, lr):
        t = state["step"] + 1
        one = torch.tensor(1.0, dtype=torch.float32)
        c1 = float(one - torch.tensor(b1, dtype=torch.float32) ** t)
        c2 = float(one - torch.tensor(b2, dtype=torch.float32) ** t)
        for p, g, m, v in zip(_tensors(params), _tensors(grads), state["m"],
                              state["v"]):
            g32 = g.float()
            m.mul_(b1).add_(g32, alpha=_f32(1 - b1))
            v.mul_(b2).addcmul_(g32, g32, value=_f32(1 - b2))
            step = (m / c1).div_((v / c2).sqrt_().add_(eps))
            p32 = p.float()
            step.add_(p32, alpha=weight_decay)
            p.copy_(p32.sub_(step, alpha=lr))
        state["step"] = t

    return Optimizer("adamw", init, update)


def _groups(params) -> dict:
    """name of the stack -> (the stack's leading shape, [(index, name)]).
    Each run of digits in a dotted name is a block index of a stack."""
    if not isinstance(params, dict):
        return {str(i): ((), [((), i)]) for i in range(len(params))}
    groups: dict = {}
    for name in params:
        parts = name.split(".")
        idx = tuple(int(q) for q in parts if q.isdigit())
        key = ".".join("*" if q.isdigit() else q for q in parts)
        groups.setdefault(key, []).append((idx, name))
    out = {}
    for key, members in groups.items():
        lead = tuple(max(i[a] for i, _ in members) + 1
                     for a in range(len(members[0][0])))
        if len(members) != math.prod(lead):
            raise ValueError(f"adafactor: the blocks of {key} do not fill "
                             f"a {lead} stack")
        out[key] = (lead, sorted(members))
    return out


def _stack(tree, members, lead) -> torch.Tensor:
    """The members' tensors of `tree` (a dict or list) as one fp32 stack
    of leading shape `lead`."""
    ts = [tree[n].float() for _, n in members]
    return torch.stack(ts).reshape(lead + ts[0].shape)


def adafactor(decay: float = 0.99, eps: float = 1e-30,
              clip: float = 1.0) -> Optimizer:
    """Factored second moment over the last two dims for rank >= 2
    stacks; `state["f"]` maps each stack's name to its factors."""

    def zfac(shape):
        f32 = dict(dtype=torch.float32)
        if len(shape) >= 2:
            return {"r": torch.zeros(shape[:-1], **f32),
                    "c": torch.zeros(shape[:-2] + shape[-1:], **f32)}
        return {"v": torch.zeros(shape, **f32)}

    def init(params):
        f = {}
        for key, (lead, members) in _groups(params).items():
            p = params[members[0][1]]
            fac = zfac(lead + tuple(p.shape))
            f[key] = {k: t.to(p.device) for k, t in fac.items()}
        return {"f": f, "step": 0}

    def upd(g, f):
        """One stack's gradient (or one leading index of it): returns the
        clipped step and writes the factors of `f` in place."""
        g2 = torch.square(g) + eps
        if g.dim() >= 2:
            f["r"].mul_(decay).add_(g2.mean(-1), alpha=_f32(1 - decay))
            f["c"].mul_(decay).add_(g2.mean(-2), alpha=_f32(1 - decay))
            r, c = f["r"], f["c"]
            denom = torch.sqrt(r[..., None] * c[..., None, :]
                               / (r.mean(-1, keepdim=True)[..., None] + eps))
        else:
            f["v"].mul_(decay).add_(g2, alpha=_f32(1 - decay))
            denom = torch.sqrt(f["v"])
        step = g / (denom + eps)
        norm = torch.sqrt(torch.mean(torch.square(step)))
        return step / torch.clamp(norm / clip, min=1.0)

    @torch.no_grad()
    def update(grads, state, params, lr):
        for key, (lead, members) in _groups(params).items():
            P = _stack(params, members, lead)
            G = _stack(grads, members, lead)
            f = state["f"][key]
            if P.dim() >= 3 and P.numel() * 4 > _LAYERWISE_BYTES:
                step = torch.stack([
                    upd(G[i], {k: t[i] for k, t in f.items()})
                    for i in range(P.shape[0])])
            else:
                step = upd(G, f)
            new = (P - lr * step).reshape((-1,) + P.shape[len(lead):])
            for j, (_, name) in enumerate(members):
                params[name].copy_(new[j])
        state["step"] += 1

    return Optimizer("adafactor", init, update)


_OPTIMIZERS = {"sgd": sgd, "momentum": momentum, "adamw": adamw,
               "adafactor": adafactor}


def make_optimizer(name: str, **hp) -> Optimizer:
    if name not in _OPTIMIZERS:
        raise ValueError(f"unknown optimizer {name!r}; this port has "
                         f"{sorted(_OPTIMIZERS)}")
    return _OPTIMIZERS[name](**hp)
