"""Zamba2: `n_layers // shared_attn_every` groups of `shared_attn_every`
Mamba2 blocks (x += mamba2(rms(x, ln))), each group followed by shared
attention block `group % n_shared_attn` (x += attn(rms(x, ln1)); x +=
swiglu(rms(x, ln2))), then the remaining Mamba2 blocks, then rms(x,
final_norm) @ head. Mamba2 runs the SSD recurrence
(`reference/layers.py::ssd`, the ssd_scan kernel) with one B/C group;
the shared attention is causal with RoPE (the flash_attention kernel in
the port's prefill)."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from bench import costs, weights
from bench.reference import layers as L

NORMALS = {
    "a_log": (0.0, 0.25),    # A = -exp(A_log)
    "skip": (1.0, 0.1),      # D
    "dt_bias": (-0.5, 0.25),
}


def _mamba2_layout(p: str, a: dict):
    d = a["d_model"]
    di = a["ssm_expand"] * d
    nh, ds, K = di // a["ssm_head_dim"], a["ssm_state"], a["ssm_conv"]
    return [(p + "ln", (d,), "norm"),
            (p + "ssm.in_z", (d, di), "w"), (p + "ssm.in_x", (d, di), "w"),
            (p + "ssm.in_bc", (d, 2 * ds), "w"),
            (p + "ssm.in_dt", (d, nh), "w"),
            (p + "ssm.conv_x", (K, di), "c"),
            (p + "ssm.conv_bc", (K, 2 * ds), "c"),
            (p + "ssm.conv_xb", (di,), "bias"),
            (p + "ssm.conv_bcb", (2 * ds,), "bias"),
            (p + "ssm.A_log", (nh,), "a_log"), (p + "ssm.D", (nh,), "skip"),
            (p + "ssm.dt_bias", (nh,), "dt_bias"),
            (p + "ssm.norm", (di,), "norm"),
            (p + "ssm.out_proj", (di, d), "w")]


def layout(a: dict):
    d, ff, V = a["d_model"], a["d_ff"], a["vocab"]
    H, KV, hd = a["n_heads"], a["n_kv_heads"], a["head_dim"]
    every = a["shared_attn_every"]
    n_super = a["n_layers"] // every
    out = [("embed.embed", (V, d), "e"), ("embed.head", (d, V), "w"),
           ("final_norm", (d,), "norm")]
    for i in range(n_super):
        for j in range(every):
            out += _mamba2_layout(f"m_main.{i}.{j}.", a)
    for i in range(a["n_layers"] - n_super * every):
        out += _mamba2_layout(f"m_tail.{i}.", a)
    for i in range(a["n_shared_attn"]):
        p = f"shared_attn.{i}."
        out += [(p + "ln1", (d,), "norm"), (p + "ln2", (d,), "norm"),
                (p + "attn.wq", (d, H * hd), "w"),
                (p + "attn.wk", (d, KV * hd), "w"),
                (p + "attn.wv", (d, KV * hd), "w"),
                (p + "attn.wo", (H * hd, d), "w"),
                (p + "ffn.w_gate", (d, ff), "w"),
                (p + "ffn.w_up", (d, ff), "w"),
                (p + "ffn.w_down", (ff, d), "w")]
    return out


def mamba2_block(w, p, a, x):
    d_inner = a["ssm_expand"] * a["d_model"]
    hd, ds = a["ssm_head_dim"], a["ssm_state"]
    nh, eps = d_inner // hd, a["norm_eps"]
    B, S, _ = x.shape
    h = L.rms_norm(x, w(p + "ln"), eps)
    q = p + "ssm."
    z = h @ w(q + "in_z")
    xs = L.causal_conv(h @ w(q + "in_x"), w(q + "conv_x"), w(q + "conv_xb"))
    bc = L.causal_conv(h @ w(q + "in_bc"), w(q + "conv_bc"),
                       w(q + "conv_bcb"))
    dt = F.softplus(h @ w(q + "in_dt") + w(q + "dt_bias"))
    y = L.ssd(xs.reshape(B, S, nh, hd), dt, w(q + "A_log"), bc[..., :ds],
              bc[..., ds:], w(q + "D"))
    y = y.reshape(B, S, d_inner) * F.silu(z)
    yh = y.reshape(B, S, nh, hd)
    yh = yh * torch.rsqrt(torch.mean(yh * yh, -1, keepdim=True) + eps)
    y = (yh * (1.0 + w(q + "norm").reshape(nh, hd))).reshape(B, S, d_inner)
    return x + y @ w(q + "out_proj")


def shared_attn_block(w, p, a, x):
    H, KV, hd, eps = a["n_heads"], a["n_kv_heads"], a["head_dim"], \
        a["norm_eps"]
    if KV != H:
        raise ValueError("the reference's shared attention has one kv "
                         "head a query head")
    B, S, _ = x.shape
    h = L.rms_norm(x, w(p + "ln1"), eps)
    q = L.rope((h @ w(p + "attn.wq")).reshape(B, S, H, hd), a["rope_theta"])
    k = L.rope((h @ w(p + "attn.wk")).reshape(B, S, KV, hd), a["rope_theta"])
    v = (h @ w(p + "attn.wv")).reshape(B, S, KV, hd)
    o = L.causal_attention(q, k, v).reshape(B, S, H * hd)
    x = x + o @ w(p + "attn.wo")
    h = L.rms_norm(x, w(p + "ln2"), eps)
    return x + L.swiglu(h, w(p + "ffn.w_gate"), w(p + "ffn.w_up"),
                        w(p + "ffn.w_down"))


def blocks(a: dict):
    every = a["shared_attn_every"]
    n_super = a["n_layers"] // every
    out = []
    for i in range(n_super):
        out += [(mamba2_block, f"m_main.{i}.{j}.") for j in range(every)]
        out.append((shared_attn_block,
                    f"shared_attn.{i % a['n_shared_attn']}."))
    out += [(mamba2_block, f"m_tail.{i}.")
            for i in range(a["n_layers"] - n_super * every)]
    return out


def applied(a: dict) -> int:
    """`weights.count`, with each shared block counted once per
    application: the `n_shared_attn` blocks are applied in turn after
    every `shared_attn_every` Mamba2 layers."""
    uses = a["n_layers"] // a["shared_attn_every"]
    shared = sum(math.prod(s) for name, s, _ in layout(a)
                 if name.startswith("shared_attn."))
    return weights.count(a) - shared + shared * uses // a["n_shared_attn"]


def ssd(a: dict):
    hd = a["ssm_head_dim"]
    return a["ssm_expand"] * a["d_model"] // hd, hd, a["ssm_state"], 1


def wkv(a: dict):
    return None


def attention(a: dict):
    return (a["n_layers"] // a["shared_attn_every"], a["n_heads"],
            a["n_kv_heads"], a["head_dim"])


def scan_flops(a: dict, B: int, S: int) -> float:
    nh, hd, ds, groups = ssd(a)
    _, f32, cb = costs.ssd_cost(B, S, nh, hd, ds, 2, groups)[False]
    return a["n_layers"] * (f32 + cb)
