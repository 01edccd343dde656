"""Step functions (train / prefill / serve) shared by the trainer and the
server (port of `repro/launch/steps.py`, without the mesh arguments).

A train step updates the parameters and the optimizer state in place
and returns the loss. Microbatches are the reference's strided split of
the batch (row i goes to microbatch i % microbatches), with fp32
gradient accumulation; with one microbatch the gradients keep the
parameters' dtype, as `jax.value_and_grad` gives them. Every family
trains: the ssm (rwkv6) and hybrid (zamba2) ones on the card through the
scans' CUDA backward kernels (wkv_scan_bwd, ssd_scan_bwd), the moe
family with 0.01 x the router's load-balance aux loss added, the vlm
family with the batch's `img_emb`.
"""
from __future__ import annotations

import torch

from repro_torch.models import transformer as tf
from repro_torch.models.common import ModelConfig, cross_entropy
from repro_torch.optim import make_optimizer


def count_params(params) -> int:
    return sum(p.numel() for p in params.parameters())


def choose_optimizer(cfg: ModelConfig, n_params: int):
    """AdamW below 50B params; Adafactor above (as the reference: fp32
    moments of a 480B model would not fit)."""
    if n_params > 5e10:
        return make_optimizer("adafactor")
    return make_optimizer("adamw", weight_decay=0.1)


def make_train_step(cfg: ModelConfig, opt, lr_fn, microbatches: int = 1):
    """Returns train_step(params, opt_state, batch) -> loss (a 0-d fp32
    tensor). `batch` holds `tokens` and `labels`, (B, S) tensors ((B, S,
    ncb) for audio) on the parameters' device, B a multiple of
    `microbatches`, and for vlm `img_emb`. `lr_fn` gets the optimizer's
    step count before the update."""

    def loss_fn(params, b):
        logits, extra = tf.forward(params, cfg, b["tokens"], mode="train",
                                   img_emb=b.get("img_emb"))
        loss = cross_entropy(logits, b["labels"], cfg.final_logit_softcap)
        if cfg.n_experts and extra is not None:
            loss = loss + 0.01 * extra  # router load-balance aux
        return loss

    def grads_of(loss, leaves):
        gs = torch.autograd.grad(loss, leaves, allow_unused=True)
        return [torch.zeros_like(p) if g is None else g
                for p, g in zip(leaves, gs)]

    def train_step(params, opt_state, batch):
        named = dict(params.named_parameters())
        leaves = list(named.values())
        if microbatches > 1:
            loss = torch.zeros((), dtype=torch.float32,
                               device=leaves[0].device)
            grads = [torch.zeros_like(p, dtype=torch.float32)
                     for p in leaves]
            for i in range(microbatches):
                b = {k: v[i::microbatches] for k, v in batch.items()}
                mb_loss = loss_fn(params, b)
                for acc, g in zip(grads, grads_of(mb_loss, leaves)):
                    acc.add_(g)
                loss += mb_loss.detach()
            loss /= microbatches
            torch._foreach_div_(grads, float(microbatches))
        else:
            loss = loss_fn(params, batch)
            grads = grads_of(loss, leaves)
            loss = loss.detach()
        lr = lr_fn(opt_state["step"])
        opt.update(dict(zip(named, grads)), opt_state, named, lr)
        return loss

    return train_step


def make_prefill_step(cfg: ModelConfig, cache_len: int = 0,
                      last_only: bool = True):
    def prefill_step(params, batch):
        logits, cache = tf.forward(params, cfg, batch["tokens"],
                                   mode="prefill", img_emb=batch.get(
                                       "img_emb"),
                                   cache_len=cache_len, last_only=last_only)
        return logits[:, -1], cache

    return prefill_step


def make_serve_step(cfg: ModelConfig):
    def serve_step(params, batch):
        logits, new_cache = tf.forward(params, cfg, batch["tokens"],
                                       mode="decode", cache=batch["cache"],
                                       t=batch["t"])
        return logits[:, -1], new_cache

    return serve_step
