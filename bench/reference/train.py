"""The reference's training steps: the configuration's equations in
float32 (`models.py`, each block under a checkpoint so that it fits),
mean token cross-entropy, the batch split into strided microbatches whose
gradients are averaged, and AdamW with the warmup-cosine schedule,
written from their formulas:

    lr_t = lr * min(t / warmup, 1) * (f + (1 - f) (1 + cos(pi s)) / 2),
           s = min(max(t - warmup, 0) / (total - warmup), 1)
    m = b1 m + (1 - b1) g;  v = b2 v + (1 - b2) g^2
    p -= lr_t ((m / (1 - b1^k)) / (sqrt(v / (1 - b2^k)) + eps) + wd p)

(t the steps taken before this one, k = t + 1). A leaf that the
benchmark hands over in bfloat16 is stored in bfloat16, as the
configuration states: each update is worked out in float32 and its
result rounded to the nearest bfloat16.
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from . import fp8_round, layers, models


def lr_at(s: dict, t: int) -> float:
    warm = min(t / max(1, s["warmup"]), 1.0)
    span = max(1, s["total_steps"] - s["warmup"])
    frac = min(max(t - s["warmup"], 0) / span, 1.0)
    cos = 0.5 * (1.0 + math.cos(math.pi * frac))
    return s["lr"] * warm * (s["final_frac"] + (1 - s["final_frac"]) * cos)


def _ckpt(fn, w, p, a, x):
    return checkpoint(lambda h: fn(w, p, a, h), x, use_reentrant=False)


def train(arch: dict, flat: dict, batches: list, mix: dict,
          control: bool = False, rows=None) -> dict:
    """Run len(batches) steps from the weights `flat` (any dtype, read
    exactly as float32). `control` runs the forward and backward through
    float8 copies of the bf16 matrices (the gradient passes straight to
    the float32 weight). `rows` keeps only those rows of every batch (a
    planted fault: part of the batch left out). Returns the losses, each
    leaf's first gradient norm and each leaf's change norm after the
    steps, by name."""
    names = list(flat)
    params = {n: flat[n].to(torch.float32, copy=True).requires_grad_()
              for n in names}
    low = {n for n in names if flat[n].dtype == torch.bfloat16
           and flat[n].dim() >= 2}
    opt, sch = mix["optimizer"], mix["schedule"]
    mb = mix["microbatches"]

    def w(name):
        p = params[name]
        if control and name in low:
            return p + (fp8_round(p) - p).detach()
        return p
    m = {n: torch.zeros_like(params[n]) for n in names}
    v = {n: torch.zeros_like(params[n]) for n in names}
    losses, g1 = [], None
    with layers.fp32_exact():
        for t, (tok, lab) in enumerate(batches):
            if rows is not None:
                tok, lab = tok[rows], lab[rows]
            for p in params.values():
                p.grad = None
            loss_sum = 0.0
            for i in range(mb):
                h = models.hidden(w, arch, tok[i::mb], block_fn=_ckpt)
                logits = h @ w("embed.head")
                loss = torch.nn.functional.cross_entropy(
                    logits.reshape(-1, logits.shape[-1]),
                    lab[i::mb].reshape(-1).long())
                (loss / mb).backward()
                loss_sum += float(loss.detach())
                del h, logits, loss
            losses.append(loss_sum / mb)
            if g1 is None:
                g1 = {n: float(params[n].grad.norm()) for n in names}
            k = t + 1
            c1, c2 = 1 - opt["b1"] ** k, 1 - opt["b2"] ** k
            lr = lr_at(sch, t)
            with torch.no_grad():
                for n in names:
                    p, g = params[n], params[n].grad
                    m[n].mul_(opt["b1"]).add_(g, alpha=1 - opt["b1"])
                    v[n].mul_(opt["b2"]).addcmul_(g, g, value=1 - opt["b2"])
                    step = (m[n] / c1) / ((v[n] / c2).sqrt() + opt["eps"])
                    p.sub_(lr * (step + opt["weight_decay"] * p))
                    if flat[n].dtype == torch.bfloat16:
                        p.copy_(p.to(torch.bfloat16))
    with torch.no_grad():
        change = {n: float((params[n] - flat[n].float()).norm())
                  for n in names}
    return {"losses": losses, "grad_norm": g1, "change_norm": change}
