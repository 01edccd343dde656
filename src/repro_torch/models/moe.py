"""Mixture-of-Experts layer: top-k routing and capacity-based dispatch
(port of `repro/models/moe.py`, its single-device branch: `moe_ffn`
with `mesh=None`; the expert-parallel `shard_map` branch belongs to the
multi-device launch, which the port does not have yet).

Each token picks its top-k experts from fp32 router logits (ties to the
lower expert index, as `jax.lax.top_k`), the k kept logits softmaxed
into gate weights. Each expert takes at most C tokens (`_capacity`); a
token's place within its expert is its rank in a stable sort of the
flattened (T*k) choices, so the choices dropped over capacity are the
reference's: later flattened positions drop first. The expert products
are batched matmuls over (E, C, d), as the reference's einsums.

The reference scatter-adds the experts' outputs into a zero (T+1, d)
buffer. The port gathers each token's k contributions through the
inverse map and adds them in ascending slot order (the reference's
order) in the activation dtype: no atomics, so the sum is bitwise
repeatable on the card.
"""
from __future__ import annotations

import math

import torch

from .common import (ModelConfig, Params, activation, dense_init, init_mlp,
                     mlp_apply)


def _experts(gen: torch.Generator, cfg: ModelConfig, din: int, dout: int):
    """(E, din, dout) expert weights, fan-in din. Each expert is drawn on
    its own, so the fp32 draw is one expert's, not all E's (arctic-480b's
    (128, 7168, 4864) would be 18 GB in fp32)."""
    w = torch.empty((cfg.n_experts, din, dout), dtype=cfg.cdtype,
                    device=gen.device)
    for e in range(cfg.n_experts):
        w[e] = dense_init(gen, (din, dout), 0, cfg.cdtype)
    return w


def init_moe(cfg: ModelConfig, gen: torch.Generator) -> Params:
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {
        "router": dense_init(gen, (d, E), 0, torch.float32),
        "wg": _experts(gen, cfg, d, ff),
        "wu": _experts(gen, cfg, d, ff),
        "wd": _experts(gen, cfg, ff, d),
    }
    if cfg.moe_dense_residual:  # arctic-style parallel dense FFN
        p["dense"] = init_mlp(cfg, gen)
    return Params(p)


def _capacity(n_tokens: int, cfg: ModelConfig) -> int:
    cap = int(math.ceil(n_tokens * cfg.top_k * cfg.capacity_factor
                        / cfg.n_experts))
    return max(8, -(-cap // 8) * 8)  # round up to 8


def _route(xf, router, k: int):
    """(T, d) tokens -> (gate weights (T, k) fp32, expert ids (T, k)): the
    top k of the fp32 logits, ties to the lower expert index (a stable
    descending sort), softmaxed over the k kept."""
    logits = xf.float() @ router  # (T, E)
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return torch.softmax(vals[:, :k], dim=-1), idx[:, :k]


def _dispatch_compute(x_flat, p, cfg: ModelConfig, gate_w, gate_idx):
    """Capacity-gather the tokens for every expert, run them, combine.

    x_flat: (T, d); gate_w / gate_idx: (T, k). Returns (T, d)."""
    T, d = x_flat.shape
    k, E = cfg.top_k, cfg.n_experts
    C = _capacity(T, cfg)
    dev = x_flat.device
    flat_e = gate_idx.reshape(-1)  # (T*k,) expert ids
    flat_w = gate_w.reshape(-1)
    n = T * k
    # a choice's place within its expert: its rank in a stable sort
    order = torch.sort(flat_e, stable=True).indices
    sorted_e = flat_e[order]
    first = torch.searchsorted(sorted_e, torch.arange(E + 1, device=dev),
                               side="left")
    ranks_sorted = torch.arange(n, device=dev) - first[sorted_e]
    pos = torch.empty_like(ranks_sorted).index_put_((order,), ranks_sorted)
    keep = pos < C
    # overflowing choices all go to one extra slot, which is dropped
    slot = torch.where(keep, flat_e * C + pos, E * C)
    choice = torch.arange(n, device=dev)
    token_of = torch.full((E * C + 1,), T, dtype=torch.int64, device=dev)
    token_of = token_of.index_put((slot,), torch.where(keep, choice // k, T))
    w_of = torch.zeros((E * C + 1,), dtype=x_flat.dtype, device=dev)
    w_of = w_of.index_put((slot,), torch.where(
        keep, flat_w, 0.0).to(x_flat.dtype))
    token_of, w_of = token_of[:-1], w_of[:-1]
    x_pad = torch.cat([x_flat, x_flat.new_zeros((1, d))], dim=0)
    xe = x_pad[token_of].reshape(E, C, d)

    act = activation(cfg.act)
    h = act(torch.bmm(xe, p["wg"])) * torch.bmm(xe, p["wu"])
    ye = torch.bmm(h, p["wd"]).reshape(E * C, d) * w_of[:, None]
    # combine: each token's kept slots in ascending order (dropped
    # choices point at a zero row, last), summed one by one
    ye = torch.cat([ye, ye.new_zeros((1, d))], dim=0)
    slots = torch.sort(slot.reshape(T, k), dim=-1).values
    out = torch.zeros((T, d), dtype=x_flat.dtype, device=dev)
    for j in range(k):
        out = out + ye[slots[:, j]]
    return out


def load_balance_aux(x, router, cfg: ModelConfig):
    """Switch-Transformer aux loss: E * sum_e f_e * P_e over the batch
    (f: the fraction of tokens whose top-1 is e, the first index on a
    tie; P: the mean router probability of e)."""
    logits = x.float() @ router  # (B, S, E)
    probs = torch.softmax(logits, dim=-1)
    top1 = torch.argmax(logits, dim=-1)
    f = torch.mean(torch.nn.functional.one_hot(
        top1, cfg.n_experts).float(), dim=(0, 1))  # (E,) dispatch fraction
    P = torch.mean(probs, dim=(0, 1))  # (E,) router mass
    return cfg.n_experts * torch.sum(f * P)


def moe_ffn(p, cfg: ModelConfig, x, with_aux: bool = False):
    """x: (B, S, d) -> (B, S, d), or (out, aux) when `with_aux`."""
    B, S, d = x.shape
    xf = x.reshape(B * S, d)
    gw, gi = _route(xf, p["router"], cfg.top_k)
    out = _dispatch_compute(xf, p, cfg, gw, gi).reshape(B, S, d)
    if "dense" in p:
        out = out + mlp_apply(p["dense"], cfg, x)
    if with_aux:
        return out, load_balance_aux(x, p["router"], cfg)
    return out
