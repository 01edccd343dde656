"""Grouped-query attention with RoPE, softcap, sliding window, the
query-chunked long-sequence path and full/ring KV caches (port of
`repro/models/attention.py`).

Layouts: activations (B, S, d); q (B, S, H, hd); k/v (B, T, KV, hd).
KV caches: {"k": (B, S_cache, KV, hd), "v": ..., "pos": (S_cache,) int32}
where pos[slot] is the absolute position stored in that slot (-1 = empty).
A ring buffer (sliding-window decode) is just `slot = t % S_cache`.

Unlike the reference, `fill_kv_cache` and `attn_decode` write the cache
IN PLACE and return the same dict: a decode step then writes one slot
instead of copying a cache that is a gigabyte at full width.
Cross-attention (`kv_emb`, the vlm family's image layers) projects keys
and values from the image embeddings, with no RoPE and no causal mask,
and always takes the plain core; its decode cache is "static": read,
never written.
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.flash_attention.ops import flash_attention

from .common import (ModelConfig, Params, apply_rope, dense_init, init_rms,
                     rms_norm, softcap)

NEG_INF = -2.0 ** 30


def init_attn(cfg: ModelConfig, gen: torch.Generator,
              cross: bool = False) -> Params:
    """`cross` makes the same shapes: cross-attention consumes image
    embeddings already projected to d_model."""
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    p = {
        "wq": dense_init(gen, (d, H * hd), 0, cfg.cdtype),
        "wk": dense_init(gen, (d, KV * hd), 0, cfg.cdtype),
        "wv": dense_init(gen, (d, KV * hd), 0, cfg.cdtype),
        "wo": dense_init(gen, (H * hd, d), 0, cfg.cdtype),
    }
    if cfg.qkv_bias:
        for name, n in (("bq", H), ("bk", KV), ("bv", KV)):
            p[name] = torch.zeros((n * hd,), dtype=cfg.cdtype,
                                  device=gen.device)
    if cfg.qk_norm:
        p["q_norm"] = init_rms(hd, gen.device)
        p["k_norm"] = init_rms(hd, gen.device)
    return Params(p)


def _project_q(p, cfg, x):
    B, S, _ = x.shape
    q = x @ p["wq"]
    if "bq" in p:
        q = q + p["bq"]
    q = q.reshape(B, S, cfg.n_heads, cfg.hd)
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
    return q


def _project_kv(p, cfg, x):
    B, S, _ = x.shape
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bk" in p:
        k, v = k + p["bk"], v + p["bv"]
    k = k.reshape(B, S, cfg.n_kv_heads, cfg.hd)
    v = v.reshape(B, S, cfg.n_kv_heads, cfg.hd)
    if "k_norm" in p:
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return k, v


def attn_core(q, k, v, q_pos, k_pos, window, attn_softcap, causal=True,
              g_major=False):
    """Dense-score attention core (fp32 scores and softmax).

    q: (B, Sq, H, hd); k, v: (B, T, KV, hd); q_pos (B, Sq) or (Sq,);
    k_pos (T,) absolute positions (-1 => invalid slot); window: int or
    0-d tensor (0 => unlimited). `g_major` selects the GQA head layout
    (ModelConfig.gqa_layout).
    """
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = hd ** -0.5
    qp = q_pos.reshape(1, Sq) if q_pos.dim() == 1 else q_pos  # (B?, Sq)
    qp = qp[:, None, None, :, None]  # (b1, 1, 1, Sq, 1)
    kp = k_pos[None, None, None, None, :]  # (1, 1, 1, 1, T)
    ok = kp >= 0
    if causal:
        ok = ok & (kp <= qp)
    w = torch.as_tensor(window, dtype=torch.int32, device=q.device)
    ok = ok & ((w <= 0) | ((qp - kp) < w))
    if g_major:  # h = g*KV + kv
        qg = q.reshape(B, Sq, G, KV, hd)
        scores = torch.einsum("bqgkd,btkd->bgkqt", qg.float(),
                              k.float()) * scale
        scores = torch.where(ok, softcap(scores, attn_softcap), NEG_INF)
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("bgkqt,btkd->bqgkd", probs.to(v.dtype), v)
    else:  # h = kv*G + g
        qg = q.reshape(B, Sq, KV, G, hd)
        scores = torch.einsum("bqkgd,btkd->bkgqt", qg.float(),
                              k.float()) * scale
        scores = torch.where(ok, softcap(scores, attn_softcap), NEG_INF)
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("bkgqt,btkd->bqkgd", probs.to(v.dtype), v)
    return out.reshape(B, Sq, H, hd)


def attn_forward(p, cfg: ModelConfig, x, positions, window=0, kv_emb=None):
    """Full-sequence attention (train / prefill). Returns (out, (k, v)).

    kv_emb: if given, the cross-attention source (B, T_img, d_model):
    not causal, no RoPE, always the plain core (as the reference, whose
    kernel branch needs kv_emb None)."""
    B, S, _ = x.shape
    q = _project_q(p, cfg, x)
    if kv_emb is None:
        k, v = _project_kv(p, cfg, x)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        k_pos = positions if positions.dim() == 1 else positions[0]
        causal = True
    else:
        k, v = _project_kv(p, cfg, kv_emb)
        k_pos = torch.arange(k.shape[1], dtype=torch.int32, device=x.device)
        causal = False

    g_major = cfg.gqa_layout == "g_major"
    if cfg.attn_impl == "pallas" and causal and cfg.gqa_layout == "kv_major":
        # As the reference (attention.py:128): only a static int window
        # reaches the kernel. Inside `transformer.forward` the window is
        # always a tensor, so that path applies no per-layer window.
        w = 0 if isinstance(window, torch.Tensor) else int(window)
        out = flash_attention(q, k, v, causal=True, window=w,
                              softcap=float(cfg.attn_logit_softcap))
        return out.reshape(B, S, -1) @ p["wo"], (k, v)
    chunk = cfg.attn_chunk
    if chunk and S > chunk and S % chunk == 0 and causal:
        # As the reference (attention.py:140-146), each query chunk is
        # checkpointed when a gradient may be taken: the backward then
        # holds one chunk's fp32 scores instead of all of them.
        def core(qc, pc):
            return attn_core(qc, k, v, pc, k_pos, window,
                             cfg.attn_logit_softcap, True, g_major=g_major)
        if torch.is_grad_enabled():
            core = functools.partial(checkpoint, core, use_reentrant=False)
        out = torch.cat([core(q[:, i:i + chunk], positions[..., i:i + chunk])
                         for i in range(0, S, chunk)], dim=1)
    else:
        out = attn_core(q, k, v, positions, k_pos, window,
                        cfg.attn_logit_softcap, causal, g_major=g_major)
    return out.reshape(B, S, -1) @ p["wo"], (k, v)


def init_kv_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype=None,
                  device=None):
    dtype = dtype or cfg.cdtype
    shape = (batch, cache_len, cfg.n_kv_heads, cfg.hd)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": torch.full((cache_len,), -1, dtype=torch.int32, device=device),
    }


def fill_kv_cache(cache, k, v, first_pos: int = 0):
    """Write prefilled (B, S, KV, hd) k/v for absolute positions
    [first_pos, first_pos+S) into the cache (in place) with ring-buffer
    slot = pos % len."""
    S = k.shape[1]
    S_cache = cache["k"].shape[1]
    pos = torch.arange(first_pos, first_pos + S, dtype=torch.int32,
                       device=k.device)
    slots = torch.remainder(pos, S_cache).long()
    cache["k"][:, slots] = k.to(cache["k"].dtype)
    cache["v"][:, slots] = v.to(cache["v"].dtype)
    cache["pos"][slots] = pos
    return cache


def attn_decode(p, cfg: ModelConfig, x, t, cache, window=0, kv_emb=None):
    """One-token decode. x: (B, 1, d); t: absolute position (int).

    Returns (out (B, 1, d), cache), the cache written in place. Ring-
    buffer semantics when the cache is shorter than t (sliding window).
    A cache marked "static" (cross-attention) holds the image keys and
    values: read with no RoPE and no mask, never written.
    """
    B = x.shape[0]
    if kv_emb is not None or "static" in cache:
        k, v = cache["k"], cache["v"]
        q = _project_q(p, cfg, x)
        k_pos = torch.arange(k.shape[1], dtype=torch.int32, device=x.device)
        out = attn_core(q, k, v, torch.zeros((1,), dtype=torch.int32,
                                             device=x.device),
                        k_pos, 0, cfg.attn_logit_softcap, causal=False)
        return out.reshape(B, 1, -1) @ p["wo"], cache
    t = int(t)
    q = _project_q(p, cfg, x)
    k_new, v_new = _project_kv(p, cfg, x)
    pos = torch.full((B, 1), t, dtype=torch.int32, device=x.device)
    q = apply_rope(q, pos, cfg.rope_theta)
    k_new = apply_rope(k_new, pos, cfg.rope_theta)
    slot = t % cache["k"].shape[1]
    cache["k"][:, slot] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][:, slot] = v_new[:, 0].to(cache["v"].dtype)
    cache["pos"][slot] = t
    out = attn_core(q, cache["k"], cache["v"], pos, cache["pos"], window,
                    cfg.attn_logit_softcap, causal=True,
                    g_major=cfg.gqa_layout == "g_major")
    return out.reshape(B, 1, -1) @ p["wo"], cache
