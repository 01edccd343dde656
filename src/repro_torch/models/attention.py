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

Under a layout (`lay=`, `sharding/layout.py`) the projections are head-
parallel where the rules split them over `model` (`q_ok`, `kv_ok`):
each rank runs its q heads against the kv heads they read, and `wo`
(split by rows) leaves through one all-reduce (a reduce-scatter into a
sequence-split residual). Where the kv heads are whole (`kv_ok` fails)
each rank projects them all and takes those its q heads read; where its
q heads read kv heads another rank holds (the g_major layout) the
projected k/v are gathered over `model`. Where the q heads are whole
(`q_ok` fails) attention is a duplicated region. A decode cache whose
sequence is split over `model` (`rules.cache_shardings`: long caches
spread over the model axis) is read where it lies: each rank attends
over its part of the cache for every head, and the parts combine over
`model` by their log-sum-exp. That layout needs two small gathers a
step, both of one token: the new token's q heads (every rank reads its
cache part for all of them) and its k/v heads (the cache holds every kv
head; the rank that holds position t writes them).
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.flash_attention.kernel import HEAD_DIMS
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.launch.mesh import (all_gather_over, all_reduce_over,
                                     all_to_all_over, gather)
from repro_torch.sharding.layout import heads_of, take
from repro_torch.sharding.rules import leaf_split

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
    q = q.reshape(B, S, -1, cfg.hd)
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
    return q


def _project_kv(p, cfg, x):
    B, S, _ = x.shape
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bk" in p:
        k, v = k + p["bk"], v + p["bv"]
    k = k.reshape(B, S, -1, cfg.hd)
    v = v.reshape(B, S, -1, cfg.hd)
    if "k_norm" in p:
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return k, v


def attn_core(q, k, v, q_pos, k_pos, window, attn_softcap, causal=True,
              g_major=False, with_lse=False):
    """Dense-score attention core (fp32 scores and softmax).

    q: (B, Sq, H, hd); k, v: (B, T, KV, hd); q_pos (B, Sq) or (Sq,);
    k_pos (T,) absolute positions (-1 => invalid slot); window: int or
    0-d tensor (0 => unlimited). `g_major` selects the GQA head layout
    (ModelConfig.gqa_layout). `with_lse` also returns each row's log-sum-
    exp of its scores, (B, Sq, H) fp32.
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
        order = (0, 3, 1, 2)
    else:  # h = kv*G + g
        qg = q.reshape(B, Sq, KV, G, hd)
        scores = torch.einsum("bqkgd,btkd->bkgqt", qg.float(),
                              k.float()) * scale
        scores = torch.where(ok, softcap(scores, attn_softcap), NEG_INF)
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("bkgqt,btkd->bqkgd", probs.to(v.dtype), v)
        order = (0, 3, 1, 2)
    out = out.reshape(B, Sq, H, hd)
    if with_lse:
        lse = torch.logsumexp(scores, dim=-1).permute(*order)
        return out, lse.reshape(B, Sq, H)
    return out


def kernel_computes(cfg: ModelConfig) -> bool:
    """True where `attn_impl="pallas"` computes the same full-sequence
    causal prefill as the config's plain core: the kv_major head layout
    (g_major takes the plain core either way), no per-layer window (the
    kernel branch below drops the windows `transformer.forward` hands it
    as tensors, as the reference's does, so a windowed config would serve
    another function), and a head dim the kernel is built for."""
    windowed = cfg.attn_pattern == "local_global" and cfg.local_window
    return (cfg.gqa_layout == "kv_major" and not windowed
            and cfg.decode_window == 0 and cfg.hd in HEAD_DIMS)


def _attend(cfg, q, k, v, positions, k_pos, window, causal):
    """The core the config asks for: the flash kernel, query chunks, or
    the plain core. q (B, S, H, hd) and k/v (B, T, KV, hd) in cfg's head
    layout."""
    B, S = q.shape[:2]
    g_major = cfg.gqa_layout == "g_major"
    if cfg.attn_impl == "pallas" and causal and cfg.gqa_layout == "kv_major":
        # As the reference (attention.py:128): only a static int window
        # reaches the kernel. Inside `transformer.forward` the window is
        # always a tensor, so that path applies no per-layer window.
        w = 0 if isinstance(window, torch.Tensor) else int(window)
        return flash_attention(q, k, v, causal=True, window=w,
                               softcap=float(cfg.attn_logit_softcap))
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
        return torch.cat([core(q[:, i:i + chunk],
                               positions[..., i:i + chunk])
                          for i in range(0, S, chunk)], dim=1)
    return attn_core(q, k, v, positions, k_pos, window,
                     cfg.attn_logit_softcap, causal, g_major=g_major)


def attn_forward(p, cfg: ModelConfig, x, positions, window=0, kv_emb=None,
                 lay=None):
    """Full-sequence attention (train / prefill). Returns (out, (k, v)).

    kv_emb: if given, the cross-attention source (B, T_img, d_model):
    not causal, no RoPE, always the plain core (as the reference, whose
    kernel branch needs kv_emb None). Under a layout `x` is the residual
    as this rank holds it and (k, v) are the kv heads it projected (its
    piece of them where `wk` is split over `model`, else all)."""
    if lay is not None:
        return _sharded_forward(p, cfg, x, positions, window, kv_emb, lay)
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
    out = _attend(cfg, q, k, v, positions, k_pos, window, causal)
    return out.reshape(B, S, -1) @ p["wo"], (k, v)


def _split_leaves(p, cfg):
    """{leaf name: split over `model`} of an attention block's piece."""
    whole = {"wq": cfg.n_heads, "bq": cfg.n_heads, "wo": cfg.n_heads,
             "wk": cfg.n_kv_heads, "wv": cfg.n_kv_heads,
             "bk": cfg.n_kv_heads, "bv": cfg.n_kv_heads}
    dim = {"wq": 1, "bq": 0, "wo": 0, "wk": 1, "wv": 1, "bk": 0, "bv": 0}
    return {n: n in whole and p[n].shape[dim[n]] < whole[n] * cfg.hd
            for n, _ in p.named_parameters(recurse=False)}


def _local_kv(lay, cfg, n_q, k, v, kv_split: bool, grad: bool):
    """This rank's `n_q` q heads' kv heads: (k, v, the local config).
    k/v (B, T, KVh, hd) are this rank's piece of the kv heads
    (`kv_split`) or all of them. The local config's head counts and GQA
    layout map local q head i to local kv head as the global layout does
    (or, where no layout does, k/v are expanded to one head a q head)."""
    KV = cfg.n_kv_heads
    G = cfg.n_heads // KV
    hs = heads_of(lay, n_q)
    kv_of = [h % KV if cfg.gqa_layout == "g_major" else h // G for h in hs]
    need = sorted(set(kv_of))
    if kv_split:
        lo, n_kv = lay.r_model * k.shape[2], k.shape[2]
        if all(lo <= j < lo + n_kv for j in need):
            need = [j - lo for j in need]
            kv_of = [j - lo for j in kv_of]
        else:   # the g_major layout: its q heads read every rank's kv heads
            ag = (lambda t: gather(t, lay.mesh, "model", 2)) if grad else \
                (lambda t: all_gather_over(t, lay.mesh, "model", 2))
            k, v = ag(k), ag(v)
    k, v = take(k, need, 2), take(v, need, 2)
    local = [need.index(j) for j in kv_of]
    n_kv = len(need)
    if n_q % n_kv == 0 and local == [i // (n_q // n_kv)
                                     for i in range(n_q)]:
        layout = "kv_major"
    elif local == [i % n_kv for i in range(n_q)]:
        layout = "g_major"
    else:
        k, v = take(k, local, 2), take(v, local, 2)
        layout, n_kv = "kv_major", n_q
    return k, v, cfg.replace(n_heads=n_q, n_kv_heads=n_kv,
                             gqa_layout=layout)


def _sharded_forward(p, cfg, x, positions, window, kv_emb, lay):
    split = _split_leaves(p, cfg)
    region = lay.region(split["wq"])
    pp = {n: p[n] if s else region.rep(p[n]) for n, s in split.items()}
    h = region.into(x)
    B, S, _ = h.shape
    q = _project_q(pp, cfg, h)
    if kv_emb is None:
        k, v = _project_kv(pp, cfg, h)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        k_pos = positions if positions.dim() == 1 else positions[0]
        causal = True
    else:
        k, v = _project_kv(pp, cfg, region.rep(kv_emb))
        k_pos = torch.arange(k.shape[1], dtype=torch.int32, device=x.device)
        causal = False
    kq, vq, lcfg = k, v, cfg
    if split["wq"]:
        kq, vq, lcfg = _local_kv(lay, cfg, q.shape[2], k, v, split["wk"],
                                 grad=True)
    out = _attend(lcfg, q, kq, vq, positions, k_pos, window, causal)
    return region.out(out.reshape(B, S, -1) @ pp["wo"]), (k, v)


def cache_layout(t, lay, n_kv: int):
    """Prefilled k or v (B, T, KVh, hd) as this rank projected it (its
    piece of the kv heads or all of them) -> the cache's layout under
    `rules.cache_shardings`: every kv head, the sequence split over
    `model` where T divides it and is at least twice it (an all-to-all
    from the head split), else whole. Marks the split on the tensor."""
    if lay is None or lay.n_model == 1:
        return t
    n = lay.n_model
    T = t.shape[1]
    heads_split = t.shape[2] < n_kv
    if T % n == 0 and T >= 2 * n:
        if heads_split:
            t = all_to_all_over(t, lay.mesh, "model", 1, 2)
        else:
            lo, m = lay.local_seq(T)
            t = t.narrow(1, lo, m).clone()
        t.mesh_split = {1: "model"}
    elif heads_split:
        t = all_gather_over(t, lay.mesh, "model", 2)
    return t


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


def attn_decode(p, cfg: ModelConfig, x, t, cache, window=0, kv_emb=None,
                lay=None):
    """One-token decode. x: (B, 1, d); t: absolute position (int).

    Returns (out (B, 1, d), cache), the cache written in place. Ring-
    buffer semantics when the cache is shorter than t (sliding window).
    A cache marked "static" (cross-attention) holds the image keys and
    values: read with no RoPE and no mask, never written.
    """
    if lay is not None and lay.n_model > 1:
        return _sharded_decode(p, cfg, x, t, cache, window, kv_emb, lay)
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


def _sharded_decode(p, cfg, x, t, cache, window, kv_emb, lay):
    split = _split_leaves(p, cfg)
    region = lay.region(split["wq"])
    B = x.shape[0]
    mesh = lay.mesh
    static = kv_emb is not None or "static" in cache
    seq_split = leaf_split(cache["k"]).get(1) == "model"
    q = _project_q(p, cfg, x)
    n_q = q.shape[2]
    g_major = cfg.gqa_layout == "g_major"
    if static:
        pos = torch.zeros((1,), dtype=torch.int32, device=x.device)
        causal = False
    else:
        t = int(t)
        k_new, v_new = _project_kv(p, cfg, x)
        pos = torch.full((B, 1), t, dtype=torch.int32, device=x.device)
        q = apply_rope(q, pos, cfg.rope_theta)
        k_new = apply_rope(k_new, pos, cfg.rope_theta)
        if split["wk"]:    # the cache holds every kv head
            k_new = all_gather_over(k_new, mesh, "model", 2)
            v_new = all_gather_over(v_new, mesh, "model", 2)
        causal = True
    ck, cv = cache["k"], cache["v"]
    T = ck.shape[1]
    if seq_split:
        lo = lay.r_model * T
        if static:
            k_pos = torch.arange(lo, lo + T, dtype=torch.int32,
                                 device=x.device)
        else:
            slot = t % cache["pos"].shape[0]
            if lo <= slot < lo + T:     # this rank holds position t
                ck[:, slot - lo] = k_new[:, 0].to(ck.dtype)
                cv[:, slot - lo] = v_new[:, 0].to(cv.dtype)
            cache["pos"][slot] = t
            k_pos = cache["pos"][lo:lo + T]
        if split["wq"]:     # every rank reads its part for all heads
            q = all_gather_over(q, mesh, "model", 2)
        out, lse = attn_core(q, ck, cv, pos, k_pos, window,
                             cfg.attn_logit_softcap, causal=causal,
                             g_major=g_major, with_lse=True)
        m = all_reduce_over(lse.clone(), mesh, ("model",), op="max")
        w = torch.exp(lse - m)
        num = all_reduce_over((out.float() * w[..., None]).contiguous(),
                              mesh, ("model",))
        den = all_reduce_over(w.contiguous(), mesh, ("model",))
        out = (num / den[..., None]).to(out.dtype)
        if split["wq"]:
            out = take(out, heads_of(lay, n_q), 2)
    else:
        if static:
            k_pos = torch.arange(T, dtype=torch.int32, device=x.device)
        else:
            slot = t % T
            ck[:, slot] = k_new[:, 0].to(ck.dtype)
            cv[:, slot] = v_new[:, 0].to(cv.dtype)
            cache["pos"][slot] = t
            k_pos = cache["pos"]
        lcfg = cfg
        if split["wq"]:
            ck, cv, lcfg = _local_kv(lay, cfg, n_q, ck, cv, False,
                                     grad=False)
        out = attn_core(q, ck, cv, pos, k_pos, window,
                        cfg.attn_logit_softcap, causal=causal,
                        g_major=lcfg.gqa_layout == "g_major")
    return region.out(out.reshape(B, 1, -1) @ p["wo"]), cache
