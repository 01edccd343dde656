"""Model assembly (port of `repro/models/transformer.py`) for the dense,
ssm (RWKV6) and hybrid (Zamba2: Mamba2 blocks with shared attention)
families, with three execution modes:

  train   — full-sequence forward, logits for the loss
  prefill — full-sequence forward, logits + populated decode caches
  decode  — one new token against the cache (serve step)

The reference stacks the layers on a leading axis and runs a `lax.scan`;
the port holds them in `nn.ModuleList`s and loops. The other families
(moe, vlm, audio) are not ported and raise.
`params_from_jax` loads the reference's parameter tree.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from . import attention as attn
from . import rwkv as rwkv_mod
from . import ssm as ssm_mod
from .common import (ModelConfig, Params, dense_init, init_mlp, init_rms,
                     mlp_apply, rms_norm)


FAMILIES = ("dense", "ssm", "hybrid")


def _ported_only(cfg: ModelConfig):
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"model family {cfg.family!r} ({cfg.name}) is not ported; "
            f"{FAMILIES} are (see ROADMAP.md queue 1)")


def _hybrid_dims(cfg: ModelConfig):
    """(n_super, shared_attn_every, n_tail): `n_super` super-blocks of
    `shared_attn_every` SSM blocks, each followed by a shared attention
    block, then `n_tail` SSM blocks."""
    every = cfg.shared_attn_every
    n_super = cfg.n_layers // every
    return n_super, every, cfg.n_layers - n_super * every


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


def ssm_block(p, cfg: ModelConfig, x, ctx, cache):
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    if ctx["mode"] == "decode":
        a, new_state = ssm_mod.ssm_decode(p["ssm"], cfg, h, cache)
    else:
        a, state = ssm_mod.ssm_forward(p["ssm"], cfg, h)
        new_state = None
        if ctx["mode"] == "prefill":
            new_state = {"h": state["h"].to(cfg.cdtype),
                         "conv": state["conv"]}
    return x + a, new_state


def init_ssm_block(cfg: ModelConfig, gen: torch.Generator) -> Params:
    return Params({"ln": init_rms(cfg.d_model, gen.device),
                   "ssm": ssm_mod.init_ssm(cfg, gen)})


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
    module holding `embed` (embed [+ head]), `final_norm` and the
    family's blocks, named as the reference's tree: `layers` (dense: one
    attention block each; ssm: {"rwkv": ...} each) or, for hybrid,
    `m_main` (n_super lists of SSM blocks), `m_tail` and `shared_attn`."""
    _ported_only(cfg)
    p = {"embed": init_embed(cfg, gen),
         "final_norm": init_rms(cfg.d_model, gen.device)}

    def stack(init, n):
        return nn.ModuleList([init() for _ in range(n)])
    if cfg.family == "dense":
        p["layers"] = stack(lambda: init_attn_mlp_block(cfg, gen),
                            cfg.n_layers)
    elif cfg.family == "ssm":
        p["layers"] = stack(
            lambda: Params({"rwkv": rwkv_mod.init_rwkv(cfg, gen)}),
            cfg.n_layers)
    else:
        n_super, every, n_tail = _hybrid_dims(cfg)
        p["m_main"] = stack(
            lambda: stack(lambda: init_ssm_block(cfg, gen), every), n_super)
        if n_tail:
            p["m_tail"] = stack(lambda: init_ssm_block(cfg, gen), n_tail)
        p["shared_attn"] = stack(lambda: init_attn_mlp_block(cfg, gen),
                                 cfg.n_shared_attn)
    return Params(p)


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


def _split(tree, n: int, what: str) -> list:
    """A reference subtree whose leaves carry a leading axis of n blocks
    -> the n blocks' subtrees."""
    leaf = tree
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    if int(np.shape(leaf)[0]) != n:
        raise ValueError(f"{what}: {np.shape(leaf)[0]} stacked blocks, the "
                         f"config has {n}")
    return [_layer(tree, i) for i in range(n)]


def _blocks(tree, n: int, what: str) -> nn.ModuleList:
    return nn.ModuleList([Params(_tree(t)) for t in _split(tree, n, what)])


def params_from_jax(cfg: ModelConfig, params_np: dict) -> Params:
    """The reference's nested parameter dict (numpy arrays, the block
    axes stacked first: `layers` (n_layers), or for hybrid `m_main`
    (n_super, shared_attn_every), `m_tail` (n_tail) and `shared_attn`
    (n_shared_attn)) -> a port module on the CPU with the same weights
    and dtypes."""
    _ported_only(cfg)
    p = {"embed": _tree(params_np["embed"]),
         "final_norm": _leaf(params_np["final_norm"])}
    if cfg.family in ("dense", "ssm"):
        p["layers"] = _blocks(params_np["layers"], cfg.n_layers, "layers")
    else:
        n_super, every, n_tail = _hybrid_dims(cfg)
        p["m_main"] = nn.ModuleList([
            _blocks(t, every, f"m_main[{i}]") for i, t in
            enumerate(_split(params_np["m_main"], n_super, "m_main"))])
        if n_tail:
            p["m_tail"] = _blocks(params_np["m_tail"], n_tail, "m_tail")
        p["shared_attn"] = _blocks(params_np["shared_attn"],
                                   cfg.n_shared_attn, "shared_attn")
    return Params(p)


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, device=None):
    """Decode cache (zeros): dense {"kv": one KV cache a layer}; ssm
    {"state": one RWKV state a layer}; hybrid {"m_main": n_super lists of
    SSM states, "attn_kv": one KV cache a super-block, "m_tail": ...}."""
    _ported_only(cfg)
    kv = lambda: attn.init_kv_cache(cfg, batch, cache_len,  # noqa: E731
                                    device=device)
    if cfg.family == "dense":
        return {"kv": [kv() for _ in range(cfg.n_layers)]}
    if cfg.family == "ssm":
        return {"state": [rwkv_mod.init_rwkv_state(cfg, batch, device)
                          for _ in range(cfg.n_layers)]}
    n_super, every, n_tail = _hybrid_dims(cfg)
    ssm_state = lambda: ssm_mod.init_ssm_state(cfg, batch,  # noqa: E731
                                               device)
    c = {"m_main": [[ssm_state() for _ in range(every)]
                    for _ in range(n_super)],
         "attn_kv": [kv() for _ in range(n_super)]}
    if n_tail:
        c["m_tail"] = [ssm_state() for _ in range(n_tail)]
    return c


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
    _ported_only(cfg)
    B, S = tokens.shape[:2]
    x = embed_tokens(params["embed"], cfg, tokens)
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    ctx = {"mode": mode, "positions": positions, "t": t,
           "cache_len": cache_len or (cfg.decode_window or S)}
    keep = mode in ("prefill", "decode")
    new_cache = None
    if cfg.family == "dense":
        windows = _layer_windows(cfg, x.device)
        kv_out = []
        for i, p_l in enumerate(params["layers"]):
            cache_l = cache["kv"][i] if cache is not None else None
            x, kv = attn_mlp_block(p_l, cfg, x,
                                   dict(ctx, window=windows[i]), cache_l)
            kv_out.append(kv)
        if keep:
            new_cache = {"kv": kv_out}
    elif cfg.family == "ssm":
        st_out = []
        for i, p_l in enumerate(params["layers"]):
            cache_l = cache["state"][i] if cache is not None else None
            if mode == "decode":
                x, st = rwkv_mod.rwkv_decode(p_l["rwkv"], cfg, x, cache_l)
            else:
                x, st = rwkv_mod.rwkv_forward(p_l["rwkv"], cfg, x, cache_l)
            st_out.append(st)
        if keep:
            new_cache = {"state": st_out}
    else:
        # as the reference, the shared blocks see the window as an array
        # (so attn_impl="pallas" applies none in train and prefill)
        window = torch.tensor(cfg.decode_window, dtype=torch.int32,
                              device=x.device)
        m_out, kv_out = [], []
        for i, p_s in enumerate(params["m_main"]):
            states = cache["m_main"][i] if cache is not None \
                else [None] * len(p_s)
            outs = []
            for p_l, st in zip(p_s, states):
                x, st = ssm_block(p_l, cfg, x, ctx, st)
                outs.append(st)
            m_out.append(outs)
            kv_l = cache["attn_kv"][i] if cache is not None else None
            x, kv = attn_mlp_block(
                params["shared_attn"][i % cfg.n_shared_attn], cfg, x,
                dict(ctx, window=window), kv_l)
            kv_out.append(kv)
        tail_out = []
        for i, p_l in enumerate(params["m_tail"]
                                if "m_tail" in params else []):
            st = cache["m_tail"][i] if cache is not None else None
            x, st = ssm_block(p_l, cfg, x, ctx, st)
            tail_out.append(st)
        if keep:
            new_cache = {"m_main": m_out, "attn_kv": kv_out}
            if "m_tail" in params:
                new_cache["m_tail"] = tail_out
    if last_only:
        # serving only needs the final position's logits
        x = x[:, -1:]
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return logits_head(params["embed"], cfg, x), new_cache
