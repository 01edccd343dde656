"""Model assembly for the dense transformer family (port of the dense part
of `repro/models/transformer.py`), with three execution modes:

  train   — full-sequence forward, logits for the loss
  prefill — full-sequence forward, logits + populated decode caches
  decode  — one new token against the cache (serve step)

The reference stacks the layers on a leading axis and runs a `lax.scan`;
the port holds them in an `nn.ModuleList` and loops. The other families
(moe, ssm, hybrid, vlm, audio) are not ported and raise.
`params_from_jax` loads the reference's parameter tree.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from . import attention as attn
from .common import (ModelConfig, Params, dense_init, init_mlp, init_rms,
                     mlp_apply, rms_norm)


def _dense_only(cfg: ModelConfig):
    if cfg.family != "dense":
        raise NotImplementedError(
            f"model family {cfg.family!r} ({cfg.name}) is not ported; only "
            "'dense' is (see ROADMAP.md queue 1)")


# ---------------------------------------------------------------------------
# block init / apply (attention + FFN)
# ---------------------------------------------------------------------------

def init_attn_mlp_block(cfg: ModelConfig, gen: torch.Generator) -> Params:
    p = {
        "ln1": init_rms(cfg.d_model, gen.device),
        "ln2": init_rms(cfg.d_model, gen.device),
        "attn": attn.init_attn(cfg, gen),
        "ffn": init_mlp(cfg, gen),
    }
    if cfg.post_block_norms:
        p["ln1_post"] = init_rms(cfg.d_model, gen.device)
        p["ln2_post"] = init_rms(cfg.d_model, gen.device)
    return Params(p)


def attn_mlp_block(p, cfg: ModelConfig, x, ctx, cache):
    """ctx: dict(mode, positions, t, window, cache_len). Returns (x,
    new_cache)."""
    mode = ctx["mode"]
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    window = ctx.get("window", 0)
    if mode == "decode":
        a, new_cache = attn.attn_decode(p["attn"], cfg, h, ctx["t"], cache,
                                        window=window)
    else:
        a, (k, v) = attn.attn_forward(p["attn"], cfg, h, ctx["positions"],
                                      window=window)
        new_cache = None
        if mode == "prefill":
            clen = ctx["cache_len"]
            S_full = k.shape[1]
            new_cache = attn.fill_kv_cache(
                attn.init_kv_cache(cfg, x.shape[0], clen, device=x.device),
                k[:, -min(clen, S_full):], v[:, -min(clen, S_full):],
                first_pos=max(0, S_full - clen))
    if "ln1_post" in p:
        a = rms_norm(a, p["ln1_post"], cfg.norm_eps)
    x = x + a
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    f = mlp_apply(p["ffn"], cfg, h2)
    if "ln2_post" in p:
        f = rms_norm(f, p["ln2_post"], cfg.norm_eps)
    return x + f, new_cache


# ---------------------------------------------------------------------------
# embedding / head
# ---------------------------------------------------------------------------

def init_embed(cfg: ModelConfig, gen: torch.Generator) -> Params:
    p = {"embed": dense_init(gen, (cfg.vocab, cfg.d_model), 1, cfg.cdtype)}
    if not cfg.tie_embeddings:
        p["head"] = dense_init(gen, (cfg.d_model, cfg.vocab), 0, cfg.cdtype)
    return Params(p)


def embed_tokens(p, cfg: ModelConfig, tokens):
    return p["embed"][tokens.long()]


def logits_head(p, cfg: ModelConfig, x):
    if cfg.tie_embeddings:
        return x @ p["embed"].T
    return x @ p["head"]


# ---------------------------------------------------------------------------
# parameters and caches
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, gen: torch.Generator) -> Params:
    """Random parameters drawn from `gen`, on the generator's device: a
    module holding `embed` (embed [+ head]), `layers` (one `Params` per
    block) and `final_norm`, named as the reference's tree."""
    _dense_only(cfg)
    return Params({
        "embed": init_embed(cfg, gen),
        "final_norm": init_rms(cfg.d_model, gen.device),
        "layers": nn.ModuleList([init_attn_mlp_block(cfg, gen)
                                 for _ in range(cfg.n_layers)]),
    })


def _leaf(a) -> torch.Tensor:
    """A reference array (numpy, or bf16 through ml_dtypes) -> a CPU
    tensor of the same dtype; bf16 goes through fp32, which is exact."""
    a = np.asarray(a)
    dtype = torch.bfloat16 if a.dtype.name == "bfloat16" else \
        getattr(torch, a.dtype.name)
    return torch.tensor(np.asarray(a, np.float32)).to(dtype)


def _tree(tree) -> dict:
    return {k: _tree(v) if isinstance(v, dict) else _leaf(v)
            for k, v in tree.items()}


def _layer(tree, i) -> dict:
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def params_from_jax(cfg: ModelConfig, params_np: dict) -> Params:
    """The reference's nested parameter dict (numpy arrays, the layer axis
    stacked first in `params["layers"]`) -> a port module on the CPU with
    the same weights and dtypes."""
    _dense_only(cfg)
    layers = params_np["layers"]
    n = int(np.shape(layers["ln1"])[0])
    if n != cfg.n_layers:
        raise ValueError(f"{n} stacked layers, config has {cfg.n_layers}")
    return Params({
        "embed": _tree(params_np["embed"]),
        "final_norm": _leaf(params_np["final_norm"]),
        "layers": nn.ModuleList([Params(_tree(_layer(layers, i)))
                                 for i in range(n)]),
    })


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, device=None):
    """Decode cache (zeros): one KV cache per layer."""
    _dense_only(cfg)
    return {"kv": [attn.init_kv_cache(cfg, batch, cache_len, device=device)
                   for _ in range(cfg.n_layers)]}


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _layer_windows(cfg: ModelConfig, device=None):
    """Per-layer attention window (0 = unlimited), gemma2-style
    alternation, as an int32 tensor like the reference's."""
    if cfg.attn_pattern == "local_global" and cfg.local_window:
        local = torch.arange(cfg.n_layers, device=device) % 2 == 0
        return torch.where(local, cfg.local_window, 0).to(torch.int32)
    if cfg.decode_window:
        return torch.full((cfg.n_layers,), cfg.decode_window,
                          dtype=torch.int32, device=device)
    return torch.zeros((cfg.n_layers,), dtype=torch.int32, device=device)


def forward(params, cfg: ModelConfig, tokens, *, mode: str = "train",
            cache=None, t=None, cache_len: int = 0, last_only: bool = False):
    """Returns (logits, new_cache).

    tokens: (B, S) integer tensor. For decode, S == 1 and `t` is the
    absolute position; `cache` is the decode cache, written in place.
    """
    _dense_only(cfg)
    B, S = tokens.shape[:2]
    x = embed_tokens(params["embed"], cfg, tokens)
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    ctx = {"mode": mode, "positions": positions, "t": t,
           "cache_len": cache_len or (cfg.decode_window or S)}
    windows = _layer_windows(cfg, x.device)
    kv_out = []
    for i, p_l in enumerate(params["layers"]):
        cache_l = cache["kv"][i] if cache is not None else None
        x, kv = attn_mlp_block(p_l, cfg, x, dict(ctx, window=windows[i]),
                               cache_l)
        kv_out.append(kv)
    new_cache = {"kv": kv_out} if mode in ("prefill", "decode") else None
    if last_only:
        # serving only needs the final position's logits
        x = x[:, -1:]
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return logits_head(params["embed"], cfg, x), new_cache
