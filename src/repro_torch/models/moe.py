"""Mixture-of-Experts layer: top-k routing, capacity-based dispatch and
expert parallelism over the `model` mesh axis (port of
`repro/models/moe.py`).

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

Under a mesh (`moe_ffn(..., mesh=...)`, the reference's `shard_map`
branch) the input is this rank's shard of the batch over `batch_axes`,
whole over `model`; model rank r holds experts [r E/n, (r+1) E/n)
(`local_experts`) and dispatches only the choices that land on them,
with the capacity of its own b_local * S tokens, as the reference inside
`shard_map`. One all_reduce over `model` combines. The gradients are
`shard_map`'s transposes: the router and the input enter the expert
region through an identity whose backward all-reduces over `model`
(`launch.mesh.enter`: each rank sees only its experts' paths), and the
combine's backward is the identity (`launch.mesh.reduce`). The router's aux loss is computed outside the region from
batch means taken over `batch_axes`. Under the sharded step's sequence-
split training residual (`lay.seq`, `sharding/layout.py`) the region
takes the reference's `seq_sharded` form (moe.py:118-144): an all-gather
of the sequence over `model` in and a reduce-scatter out, in place of
the one all-reduce; their transposes are each other. The expert leaves
are also split over `data` there (FSDP, gathered by the block).
"""
from __future__ import annotations

import math
import re

import torch

from repro_torch.launch.mesh import (all_gather_over, all_reduce_over,
                                     batch_shard, enter, gather, mesh_shape,
                                     reduce, scatter)
from repro_torch.sharding.rules import param_shardings, shard_params

from .common import (ModelConfig, Params, activation, dense_init, init_mlp,
                     mlp_apply)

# the expert leaves (E leading) that expert parallelism splits over `model`
_EXPERT = re.compile(r"(^|\.)ffn\.w[gud]$")


def _experts(gen: torch.Generator, cfg: ModelConfig, din: int, dout: int):
    """(E, din, dout) expert weights, fan-in din. Each expert is drawn on
    its own, so the fp32 draw is one expert's, not all E's (arctic-480b's
    (128, 7168, 4864) would be 18 GB in fp32)."""
    w = torch.empty((cfg.n_experts, din, dout), dtype=cfg.cdtype,
                    device=gen.device)
    if w.device.type == "meta":     # shapes only (the dry run)
        return w
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


def _dispatch_compute(x_flat, p, cfg: ModelConfig, gate_w, gate_idx,
                      e_offset: int = 0, n_local: int = 0):
    """Capacity-gather the tokens for the n_local experts [e_offset,
    e_offset + n_local) (all E by default) that `p` holds, run them,
    combine.

    x_flat: (T, d); gate_w / gate_idx: (T, k). Returns (T, d): the
    contributions of these experts (the rest of a token's choices add
    zero)."""
    T, d = x_flat.shape
    k = cfg.top_k
    n_local = n_local or cfg.n_experts
    C = _capacity(T, cfg)
    dev = x_flat.device
    local_e = gate_idx.reshape(-1) - e_offset  # (T*k,) expert ids here
    flat_w = gate_w.reshape(-1)
    valid = (local_e >= 0) & (local_e < n_local)
    key_e = torch.where(valid, local_e, n_local)  # others sort last
    n = T * k
    # a choice's place within its expert: its rank in a stable sort
    order = torch.sort(key_e, stable=True).indices
    sorted_e = key_e[order]
    first = torch.searchsorted(sorted_e, torch.arange(n_local + 1,
                                                      device=dev),
                               side="left")
    ranks_sorted = torch.arange(n, device=dev) - first[sorted_e]
    pos = torch.empty_like(ranks_sorted).index_put_((order,), ranks_sorted)
    keep = valid & (pos < C)
    # overflowing and other experts' choices all go to one extra slot,
    # which is dropped
    slot = torch.where(keep, local_e * C + pos, n_local * C)
    choice = torch.arange(n, device=dev)
    token_of = torch.full((n_local * C + 1,), T, dtype=torch.int64,
                          device=dev)
    token_of = token_of.index_put((slot,), torch.where(keep, choice // k, T))
    w_of = torch.zeros((n_local * C + 1,), dtype=x_flat.dtype, device=dev)
    w_of = w_of.index_put((slot,), torch.where(
        keep, flat_w, 0.0).to(x_flat.dtype))
    token_of, w_of = token_of[:-1], w_of[:-1]
    x_pad = torch.cat([x_flat, x_flat.new_zeros((1, d))], dim=0)
    xe = x_pad[token_of].reshape(n_local, C, d)

    act = activation(cfg.act)
    h = act(torch.bmm(xe, p["wg"])) * torch.bmm(xe, p["wu"])
    ye = torch.bmm(h, p["wd"]).reshape(n_local * C, d) * w_of[:, None]
    # combine: each token's kept slots in ascending order (dropped
    # choices point at a zero row, last), summed one by one
    ye = torch.cat([ye, ye.new_zeros((1, d))], dim=0)
    slots = torch.sort(slot.reshape(T, k), dim=-1).values
    out = torch.zeros((T, d), dtype=x_flat.dtype, device=dev)
    for j in range(k):
        out = out + ye[slots[:, j]]
    return out


def expert_names(params) -> list:
    """The names of the expert leaves ((E, ...) stacks) of a model or an
    MoE layer's parameters."""
    return [n for n, _ in params.named_parameters() if _EXPERT.search(n)]


def _expert_dims(params, cfg: ModelConfig, mesh) -> dict:
    """name -> the dim the sharding rules split over `model`, for each
    expert leaf."""
    specs = param_shardings(mesh, params, cfg)
    return {n: specs[n].index("model") for n in expert_names(params)}


def local_experts(params, cfg: ModelConfig, mesh):
    """A copy of `params` (a model's, or any module whose expert leaves
    are named `...ffn.wg`, `...ffn.wu`, `...ffn.wd`) that holds
    only this model rank's experts: `rules.shard_params` cutting only the
    expert leaves, only over `model` ([r E/n, (r+1) E/n) on the dim the
    rules shard over it); the other leaves are shared with `params`."""
    n = mesh_shape(mesh)["model"]
    if cfg.n_experts % n:
        raise ValueError(f"{cfg.n_experts} experts do not split over a "
                         f"{n}-way model axis")
    return shard_params(params, mesh, cfg, names=set(expert_names(params)),
                        axes=("model",))


def gather_experts(params, cfg: ModelConfig, mesh) -> dict:
    """The inverse of `local_experts` for the expert leaves: {name: the
    whole (E, ...) tensor}, gathered over `model` on every rank."""
    leaves = dict(params.named_parameters())
    return {name: all_gather_over(leaves[name].detach(), mesh, "model", dim)
            for name, dim in _expert_dims(params, cfg, mesh).items()}


def _mesh_experts(p, cfg: ModelConfig, x, mesh, seq: bool = False):
    """The expert region under a mesh: this rank's experts on its batch
    shard, combined over `model`; with `seq`, x is this rank's part of
    the sequence and so is the output."""
    n = mesh_shape(mesh)["model"]
    n_local = cfg.n_experts // n
    if cfg.n_experts % n or p["wg"].shape[0] != n_local:
        raise ValueError(f"a {n}-way model axis holds {n_local} of "
                         f"{cfg.n_experts} experts a rank; the layer has "
                         f"{p['wg'].shape[0]} (see local_experts)")
    x = gather(x, mesh, "model", 1) if seq else enter(x, mesh, "model")
    router = enter(p["router"], mesh, "model")
    B, S, d = x.shape
    xf = x.reshape(B * S, d)
    gw, gi = _route(xf, router, cfg.top_k)
    out = _dispatch_compute(xf, p, cfg, gw, gi,
                            mesh.get_local_rank("model") * n_local, n_local)
    out = out.reshape(B, S, d)
    return scatter(out, mesh, "model", 1) if seq else \
        reduce(out, mesh, "model")


def load_balance_aux(x, router, cfg: ModelConfig, mesh=None,
                     batch_axes=(), seq: bool = False):
    """Switch-Transformer aux loss: E * sum_e f_e * P_e over the batch
    (f: the fraction of tokens whose top-1 is e, the first index on a
    tie; P: the mean router probability of e). Under a mesh both are
    means over the whole batch, summed over `batch_axes`; the gradient
    reaches this rank's P as the train step's mean over those ranks
    expects. With `seq`, x is this rank's part of the sequence: the
    means also run over `model`, whose ranks each give 1/n of P's
    gradient (the router enters replicated, its gradient summed)."""
    n_seq = mesh_shape(mesh).get("model", 1) if seq else 1
    if n_seq > 1:
        router = enter(router, mesh, "model")
    logits = x.float() @ router  # (B, S, E)
    probs = torch.softmax(logits, dim=-1)
    top1 = torch.argmax(logits, dim=-1)
    f = torch.mean(torch.nn.functional.one_hot(
        top1, cfg.n_experts).float(), dim=(0, 1))  # (E,) dispatch fraction
    P = torch.mean(probs, dim=(0, 1))  # (E,) router mass
    axes = tuple(batch_axes or ()) + (("model",) if n_seq > 1 else ())
    if mesh is not None and axes:
        n = batch_shard(mesh, batch_axes or ())[1] * n_seq
        f = all_reduce_over(f.clone(), mesh, axes) / n
        whole = all_reduce_over(P.detach().clone(), mesh, axes) / n
        P = P / n_seq
        P = P + (whole - P.detach())
    return cfg.n_experts * torch.sum(f * P)


def moe_ffn(p, cfg: ModelConfig, x, mesh=None, batch_axes=("data",),
            with_aux: bool = False, lay=None):
    """x: (B, S, d) -> (B, S, d), or (out, aux) when `with_aux`. With a
    `mesh`, expert-parallel over its `model` axis: x is this rank's batch
    shard over `batch_axes` and `p` holds this rank's experts. Under a
    layout (`lay`, the sharded step) x is the residual as the rank holds
    it (its part of the sequence when `lay.seq`)."""
    B, S, d = x.shape
    seq = lay is not None and lay.seq
    if mesh is None:
        xf = x.reshape(B * S, d)
        gw, gi = _route(xf, p["router"], cfg.top_k)
        out = _dispatch_compute(xf, p, cfg, gw, gi).reshape(B, S, d)
    else:
        out = _mesh_experts(p, cfg, x, mesh, seq=seq)
    if "dense" in p:
        out = out + mlp_apply(p["dense"], cfg, x, lay=lay)
    if with_aux:
        return out, load_balance_aux(x, p["router"], cfg, mesh, batch_axes,
                                     seq=seq)
    return out
