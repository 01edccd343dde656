"""Model assembly (port of `repro/models/transformer.py`) for the dense,
moe, ssm (RWKV6), hybrid (Zamba2: Mamba2 blocks with shared attention),
vlm (cross-attention to image embeddings every `cross_attn_every`-th
layer) and audio (parallel codebooks) families, with three execution
modes:

  train   — full-sequence forward, logits for the loss
  prefill — full-sequence forward, logits + populated decode caches
  decode  — one new token against the cache (serve step)

The reference stacks the layers on a leading axis and runs a `lax.scan`;
the port holds them in `nn.ModuleList`s and loops. As the reference
rematerialises every block in train mode (`jax.checkpoint` in
`_scan_stack`), the port wraps each block in train mode, with grad on,
in `torch.utils.checkpoint` (non-reentrant): the backward keeps a
block's input and recomputes the rest. `params_from_jax` loads the
reference's parameter tree and `params_to_jax` gives it back.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.launch.mesh import mesh_shape
from repro_torch.sharding.layout import Layout

from . import attention as attn
from . import moe as moe_mod
from . import rwkv as rwkv_mod
from . import ssm as ssm_mod
from .common import (ModelConfig, Params, dense_init, init_mlp, init_rms,
                     mlp_apply, rms_norm)


FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")
# Families whose blocks form one `layers` stack: attention + MLP blocks
# (ATTN_STACKED), or RWKV6 blocks (ssm).
ATTN_STACKED = ("dense", "moe", "audio")
STACKED = ATTN_STACKED + ("ssm",)


def _known(cfg: ModelConfig):
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown model family {cfg.family!r} "
                         f"({cfg.name}); choose from {FAMILIES}")


def _vlm_dims(cfg: ModelConfig):
    """(n_super, period): `n_super` super-blocks of period - 1 self-
    attention blocks, each followed by a cross-attention block (the
    layers past n_super * period are not built, as in the reference)."""
    period = cfg.cross_attn_every
    return cfg.n_layers // period, period


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

def init_attn_mlp_block(cfg: ModelConfig, gen: torch.Generator,
                        cross: bool = False,
                        use_moe: bool = False) -> Params:
    p = {
        "ln1": init_rms(cfg.d_model, gen.device),
        "ln2": init_rms(cfg.d_model, gen.device),
        "attn": attn.init_attn(cfg, gen, cross=cross),
        "ffn": moe_mod.init_moe(cfg, gen) if use_moe else init_mlp(cfg, gen),
    }
    if cfg.post_block_norms:
        p["ln1_post"] = init_rms(cfg.d_model, gen.device)
        p["ln2_post"] = init_rms(cfg.d_model, gen.device)
    return Params(p)


def attn_mlp_block(p, cfg: ModelConfig, x, ctx, cache, *, cross=False,
                   use_moe=False):
    """ctx: dict(mode, positions, t, window, img_emb, cache_len, mesh,
    batch_axes). Returns (x, new_cache); in train mode the MoE block
    returns its router aux loss in the cache's place. A cross block
    attends to ctx["img_emb"] (to its own input when that is None, as the
    reference's text-only serving does) and keeps the projected keys and
    values as its static decode cache."""
    mode = ctx["mode"]
    lay = ctx.get("lay")
    if lay is not None:
        p = lay.fsdp(p)
    norm = _norm(lay)
    h = norm(x, p["ln1"], cfg)
    window = ctx.get("window", 0)
    if mode == "decode":
        if cross:
            a, _ = attn.attn_decode(p["attn"], cfg, h, ctx["t"],
                                    dict(cache, static=True), lay=lay)
            new_cache = cache
        else:
            a, new_cache = attn.attn_decode(p["attn"], cfg, h, ctx["t"],
                                            cache, window=window, lay=lay)
    else:
        kv_emb = ctx.get("img_emb") if cross else None
        a, (k, v) = attn.attn_forward(p["attn"], cfg, h, ctx["positions"],
                                      window=window, kv_emb=kv_emb, lay=lay)
        new_cache = None
        if mode == "prefill" and cross:
            new_cache = {n: attn.cache_layout(t, lay, cfg.n_kv_heads)
                         for n, t in (("k", k), ("v", v))}
        elif mode == "prefill":
            clen = ctx["cache_len"]
            S_full = k.shape[1]
            new_cache = attn.fill_kv_cache(
                attn.init_kv_cache(cfg.replace(n_kv_heads=k.shape[2]),
                                   x.shape[0], clen, device=x.device),
                k[:, -min(clen, S_full):], v[:, -min(clen, S_full):],
                first_pos=max(0, S_full - clen))
            for n in ("k", "v"):
                new_cache[n] = attn.cache_layout(new_cache[n], lay,
                                                 cfg.n_kv_heads)
    if "ln1_post" in p:
        a = norm(a, p["ln1_post"], cfg)
    x = x + a
    h2 = norm(x, p["ln2"], cfg)
    if use_moe:
        f = moe_mod.moe_ffn(p["ffn"], cfg, h2, mesh=ctx["mesh"],
                            batch_axes=ctx["batch_axes"],
                            with_aux=mode == "train", lay=lay)
        if mode == "train":
            f, new_cache = f
    else:
        f = mlp_apply(p["ffn"], cfg, h2, lay=lay)
    if "ln2_post" in p:
        f = norm(f, p["ln2_post"], cfg)
    return x + f, new_cache


def _norm(lay):
    """rms_norm of the residual: under a sequence-split residual its
    scale enters as a replicated leaf of each rank's own tokens."""
    if lay is None:
        return lambda x, scale, cfg: rms_norm(x, scale, cfg.norm_eps)
    return lambda x, scale, cfg: rms_norm(x, lay.resid.rep(scale),
                                          cfg.norm_eps)


def ssm_block(p, cfg: ModelConfig, x, ctx, cache):
    lay = ctx.get("lay")
    if lay is not None:
        p = lay.fsdp(p)
    h = _norm(lay)(x, p["ln"], cfg)
    if ctx["mode"] == "decode":
        a, new_state = ssm_mod.ssm_decode(p["ssm"], cfg, h, cache, lay=lay)
    else:
        a, state = ssm_mod.ssm_forward(p["ssm"], cfg, h, lay=lay,
                                       keep_state=ctx["mode"] == "prefill")
        new_state = None
        if ctx["mode"] == "prefill":
            new_state = {"h": state["h"].to(cfg.cdtype),
                         "conv": state["conv"]}
    return x + a, new_state


def rwkv_block(p, cfg: ModelConfig, x, ctx, state):
    lay = ctx.get("lay")
    if lay is not None:
        p = lay.fsdp(p)
    if ctx["mode"] == "decode":
        return rwkv_mod.rwkv_decode(p["rwkv"], cfg, x, state, lay=lay)
    return rwkv_mod.rwkv_forward(p["rwkv"], cfg, x, state, lay=lay)


def init_ssm_block(cfg: ModelConfig, gen: torch.Generator) -> Params:
    return Params({"ln": init_rms(cfg.d_model, gen.device),
                   "ssm": ssm_mod.init_ssm(cfg, gen)})


# ---------------------------------------------------------------------------
# embedding / head
# ---------------------------------------------------------------------------

def init_embed(cfg: ModelConfig, gen: torch.Generator) -> Params:
    """embed (V, d) [+ head (d, V)]; audio: a (V, d) embedding a codebook,
    stacked (ncb, V, d), and a head (ncb, d, V); vlm adds `img_proj`
    (d_vision, d_model). Fan-ins as the reference's."""
    V, d = cfg.vocab, cfg.d_model
    if cfg.n_codebooks:
        p = {"embed": torch.stack([dense_init(gen, (V, d), 0, cfg.cdtype)
                                   for _ in range(cfg.n_codebooks)]),
             "head": dense_init(gen, (cfg.n_codebooks, d, V), 1,
                                cfg.cdtype)}
    else:
        p = {"embed": dense_init(gen, (V, d), 1, cfg.cdtype)}
        if not cfg.tie_embeddings:
            p["head"] = dense_init(gen, (d, V), 0, cfg.cdtype)
    if cfg.d_vision:
        p["img_proj"] = dense_init(gen, (cfg.d_vision, d), 0, cfg.cdtype)
    return Params(p)


def embed_tokens(p, cfg: ModelConfig, tokens, lay=None):
    """Under a layout whose embedding is split over `model` by vocabulary
    rows: each rank looks up the tokens in its rows (zeros elsewhere) and
    one all-reduce over `model` sums (a reduce-scatter into the
    sequence-split training residual)."""
    E = p["embed"] if lay is None else lay.leaf(p["embed"])
    V = E.shape[-2]
    if lay is None or V == cfg.vocab:
        if cfg.n_codebooks:  # tokens (B, S, ncb): the codebooks' sum
            return sum(E[n][tokens[..., n].long()]
                       for n in range(cfg.n_codebooks))
        return E[tokens.long()]
    lo = lay.r_model * V

    def look(e, tok):
        t = tok.long() - lo
        ok = (t >= 0) & (t < V)
        return e[t.clamp(0, V - 1)] * ok[..., None].to(e.dtype)
    if cfg.n_codebooks:
        x = sum(look(E[n], tokens[..., n]) for n in range(cfg.n_codebooks))
    else:
        x = look(E, tokens)
    return lay.region(True).out(x)


def logits_head(p, cfg: ModelConfig, x, lay=None):
    """Under a layout whose head (or tied embedding) is split over
    `model` by vocabulary columns, the logits stay split: (..., V / n)
    on each rank, as the reference's `_logits_sharding`."""
    if lay is None:
        if cfg.n_codebooks:  # (B, S, ncb, V)
            return torch.einsum("bsd,ndv->bsnv", x, p["head"])
        if cfg.tie_embeddings:
            return x @ p["embed"].T
        return x @ p["head"]
    W = lay.leaf(p["embed"] if cfg.tie_embeddings else p["head"])
    region = lay.region((W.shape[-2] if cfg.tie_embeddings
                         else W.shape[-1]) < cfg.vocab)
    if not region.split:
        W = region.rep(W)
    x = region.into(x)
    if cfg.n_codebooks:
        return torch.einsum("bsd,ndv->bsnv", x, W)
    return x @ W.T if cfg.tie_embeddings else x @ W


# ---------------------------------------------------------------------------
# parameters and caches
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, gen: torch.Generator) -> Params:
    """Random parameters drawn from `gen`, on the generator's device: a
    module holding `embed` (embed [+ head] [+ img_proj]), `final_norm`
    and the family's blocks, named as the reference's tree: `layers`
    (dense and audio: one attention block each; moe: the same with an
    MoE ffn; ssm: {"rwkv": ...} each); for hybrid `m_main` (n_super
    lists of SSM blocks), `m_tail` and `shared_attn`; for vlm
    `self_layers` (n_super lists of period - 1 blocks) and
    `cross_layers` (n_super blocks)."""
    _known(cfg)
    p = {"embed": init_embed(cfg, gen),
         "final_norm": init_rms(cfg.d_model, gen.device)}

    def stack(init, n):
        return nn.ModuleList([init() for _ in range(n)])
    if cfg.family in ATTN_STACKED:
        use_moe = cfg.family == "moe"
        p["layers"] = stack(lambda: init_attn_mlp_block(
            cfg, gen, use_moe=use_moe), cfg.n_layers)
    elif cfg.family == "vlm":
        n_super, period = _vlm_dims(cfg)
        p["self_layers"] = stack(lambda: stack(
            lambda: init_attn_mlp_block(cfg, gen), period - 1), n_super)
        p["cross_layers"] = stack(
            lambda: init_attn_mlp_block(cfg, gen, cross=True), n_super)
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
    """A reference array (numpy, or bf16 through ml_dtypes), or a tensor
    as `params_to_jax` and `checkpoint.load_pytree` give them -> a CPU
    tensor of the same dtype; bf16 goes through fp32, which is exact."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().clone()
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
    axes stacked first: `layers` (n_layers); for hybrid `m_main`
    (n_super, shared_attn_every), `m_tail` (n_tail) and `shared_attn`
    (n_shared_attn); for vlm `self_layers` (n_super, period - 1) and
    `cross_layers` (n_super)) -> a port module on the CPU with the same
    weights and dtypes."""
    _known(cfg)
    p = {"embed": _tree(params_np["embed"]),
         "final_norm": _leaf(params_np["final_norm"])}
    if cfg.family in STACKED:
        p["layers"] = _blocks(params_np["layers"], cfg.n_layers, "layers")
    elif cfg.family == "vlm":
        n_super, period = _vlm_dims(cfg)
        p["self_layers"] = nn.ModuleList([
            _blocks(t, period - 1, f"self_layers[{i}]") for i, t in
            enumerate(_split(params_np["self_layers"], n_super,
                             "self_layers"))])
        p["cross_layers"] = _blocks(params_np["cross_layers"], n_super,
                                    "cross_layers")
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


def _module_tree(m) -> dict:
    return {name: _module_tree(c) for name, c in m.named_children()} | {
        name: t.detach().cpu() for name, t in m.named_parameters(
            recurse=False)}


def _stacked(trees: list) -> dict:
    """Same-structured trees -> one tree whose leaves are stacked on a
    new leading axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stacked([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def params_to_jax(cfg: ModelConfig, params) -> dict:
    """The inverse of `params_from_jax`: a port module -> the reference's
    nested parameter dict with the block axes stacked first (`layers`
    (n_layers, ...); hybrid `m_main` (n_super, shared_attn_every, ...),
    `m_tail`, `shared_attn`; vlm `self_layers` (n_super, period - 1,
    ...), `cross_layers`). Leaves are CPU tensors in the parameters'
    dtypes (numpy has no bf16 of its own); `checkpoint.save_pytree`
    writes them as the reference writes its arrays."""
    _known(cfg)
    out = {"embed": _module_tree(params["embed"]),
           "final_norm": params["final_norm"].detach().cpu()}
    blocks = lambda ms: _stacked([_module_tree(m) for m in ms])  # noqa: E731
    if cfg.family in STACKED:
        out["layers"] = blocks(params["layers"])
    elif cfg.family == "vlm":
        out["self_layers"] = _stacked([blocks(s)
                                       for s in params["self_layers"]])
        out["cross_layers"] = blocks(params["cross_layers"])
    else:
        out["m_main"] = _stacked([blocks(s) for s in params["m_main"]])
        if "m_tail" in params:
            out["m_tail"] = blocks(params["m_tail"])
        out["shared_attn"] = blocks(params["shared_attn"])
    return out


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, device=None):
    """Decode cache (zeros; `device="meta"` gives shapes only): dense, moe
    and audio {"kv": one KV cache a layer}; ssm {"state": one RWKV state
    a layer}; hybrid {"m_main": n_super lists of SSM states, "attn_kv":
    one KV cache a super-block, "m_tail": ...}; vlm {"self_kv": n_super
    lists of period - 1 KV caches, "cross_kv": one {"k", "v"} of
    n_img_tokens a super-block}."""
    _known(cfg)
    kv = lambda: attn.init_kv_cache(cfg, batch, cache_len,  # noqa: E731
                                    device=device)
    if cfg.family in ATTN_STACKED:
        return {"kv": [kv() for _ in range(cfg.n_layers)]}
    if cfg.family == "vlm":
        n_super, period = _vlm_dims(cfg)
        img = (batch, cfg.n_img_tokens, cfg.n_kv_heads, cfg.hd)
        return {"self_kv": [[kv() for _ in range(period - 1)]
                            for _ in range(n_super)],
                "cross_kv": [{n: torch.zeros(img, dtype=cfg.cdtype,
                                             device=device)
                              for n in ("k", "v")}
                             for _ in range(n_super)]}
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
            cache=None, t=None, img_emb=None, mesh=None,
            batch_axes=("data",), cache_len: int = 0,
            last_only: bool = False):
    """Returns (logits, new_cache); in train mode the moe family returns
    the layers' mean router aux loss in the cache's place.

    tokens: (B, S) integer tensor ((B, S, ncb) for audio). For decode,
    S == 1 and `t` is the absolute position; `cache` is the decode cache,
    written in place. img_emb: (B, n_img_tokens, d_vision) image
    embeddings for the vlm family's cross layers (projected through
    `img_proj`); without them a cross layer attends to its own input.

    With a `mesh` (`launch/mesh.py`), tokens (and cache, img_emb) are
    this rank's shard of the batch over `batch_axes`, and `params` hold
    this rank's pieces (`rules.shard_params`; `moe.local_experts` cuts
    only the experts): each layer runs sharded where its leaves are
    split (`sharding/layout.py`) and whole where they are not. In train
    mode with the vocabulary split over `model`, `S % n_model == 0` and
    `S > n_model`, the residual is split along the sequence over `model`
    (the reference's `_constrain`). The logits come out split over
    `model` where the head is.
    """
    _known(cfg)
    B, S = tokens.shape[:2]
    lay = None
    if mesh is not None:
        n = mesh_shape(mesh).get("model", 1)
        seq = (mode == "train" and n > 1 and S % n == 0 and S > n
               and params["embed"]["embed"].shape[-2] < cfg.vocab)
        lay = Layout(mesh, seq=seq)
    x = embed_tokens(params["embed"], cfg, tokens, lay)
    if img_emb is not None and "img_proj" in params["embed"]:
        proj = params["embed"]["img_proj"]
        img_emb = img_emb.to(cfg.cdtype) @ (proj if lay is None
                                            else lay.leaf(proj))
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    ctx = {"mode": mode, "positions": positions, "t": t, "img_emb": img_emb,
           "mesh": mesh, "batch_axes": batch_axes, "lay": lay,
           "cache_len": cache_len or (cfg.decode_window or S)}
    keep = mode in ("prefill", "decode")
    new_cache = None
    remat = mode == "train" and torch.is_grad_enabled()

    def run(block, p, x, c, state, aux=False):
        """block(p, cfg, x, c, state) -> (x, new state). In train mode
        with grad on, under a non-reentrant checkpoint (the reference's
        remat); the state it returns is not kept, unless `aux` (the MoE
        block's router aux loss)."""
        if not remat:
            return block(p, cfg, x, c, state)
        if aux:
            return checkpoint(lambda h: block(p, cfg, h, c, state), x,
                              use_reentrant=False)
        return checkpoint(lambda h: block(p, cfg, h, c, state)[0], x,
                          use_reentrant=False), None
    if cfg.family in ATTN_STACKED:
        windows = _layer_windows(cfg, x.device)
        use_moe = cfg.family == "moe"
        block = functools.partial(attn_mlp_block, use_moe=use_moe)
        kv_out = []
        for i, p_l in enumerate(params["layers"]):
            cache_l = cache["kv"][i] if cache is not None else None
            x, kv = run(block, p_l, x, dict(ctx, window=windows[i]),
                        cache_l, aux=use_moe)
            kv_out.append(kv)
        if keep:
            new_cache = {"kv": kv_out}
        elif use_moe:
            new_cache = torch.mean(torch.stack(kv_out))  # router aux loss
    elif cfg.family == "vlm":
        cross = functools.partial(attn_mlp_block, cross=True)
        self_out, cross_out = [], []
        for i, (p_s, p_c) in enumerate(zip(params["self_layers"],
                                           params["cross_layers"])):
            kvs = cache["self_kv"][i] if cache is not None \
                else [None] * len(p_s)
            outs = []
            for p_l, kv_l in zip(p_s, kvs):
                x, kv = run(attn_mlp_block, p_l, x, ctx, kv_l)
                outs.append(kv)
            self_out.append(outs)
            x, kv = run(cross, p_c, x, ctx,
                        cache["cross_kv"][i] if cache is not None else None)
            cross_out.append(kv)
        if keep:
            new_cache = {"self_kv": self_out, "cross_kv": cross_out}
    elif cfg.family == "ssm":
        st_out = []
        for i, p_l in enumerate(params["layers"]):
            cache_l = cache["state"][i] if cache is not None else None
            x, st = run(rwkv_block, p_l, x, ctx, cache_l)
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
                x, st = run(ssm_block, p_l, x, ctx, st)
                outs.append(st)
            m_out.append(outs)
            kv_l = cache["attn_kv"][i] if cache is not None else None
            x, kv = run(attn_mlp_block,
                        params["shared_attn"][i % cfg.n_shared_attn], x,
                        dict(ctx, window=window), kv_l)
            kv_out.append(kv)
        tail_out = []
        for i, p_l in enumerate(params["m_tail"]
                                if "m_tail" in params else []):
            st = cache["m_tail"][i] if cache is not None else None
            x, st = run(ssm_block, p_l, x, ctx, st)
            tail_out.append(st)
        if keep:
            new_cache = {"m_main": m_out, "attn_kv": kv_out}
            if "m_tail" in params:
                new_cache["m_tail"] = tail_out
    if last_only:
        # serving only needs the final position's logits
        x = x[:, -1:]
    x = _norm(lay)(x, params["final_norm"], cfg)
    return logits_head(params["embed"], cfg, x, lay), new_cache
