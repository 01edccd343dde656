"""The reference forward of each configuration's equations, in float32,
layer by layer, from the benchmark's weights by name (`weights.py`):
`w(name)` returns the leaf as float32 (the bf16 leaf upcast exactly, or
the control's lower-precision copy of it).

rwkv6: each of `n_layers` blocks is x += time_mix(rms(x, n1)); x +=
channel_mix(rms(x, n2)).
zamba2: `n_layers // shared_attn_every` groups of `shared_attn_every`
Mamba2 blocks (x += mamba2(rms(x, ln))), each group followed by shared
attention block `group % n_shared_attn` (x += attn(rms(x, ln1)); x +=
swiglu(rms(x, ln2))), then the remaining Mamba2 blocks.
Both end in rms(x, final_norm) @ head.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import layers as L


def rwkv6_block(w, p, a, x):
    d, hd = a["d_model"], a["rwkv_head_dim"]
    nh, eps = d // hd, a["norm_eps"]
    B, S, _ = x.shape
    h = L.rms_norm(x, w(p + "n1"), eps)
    prev = L.token_shift(h)

    def mix(name):
        return h + (prev - h) * w(p + name)
    r = (mix("mix_r") @ w(p + "wr")).reshape(B, S, nh, hd)
    k = (mix("mix_k") @ w(p + "wk")).reshape(B, S, nh, hd)
    v = (mix("mix_v") @ w(p + "wv")).reshape(B, S, nh, hd)
    g = F.silu(mix("mix_g") @ w(p + "wg"))
    logw = -torch.exp(w(p + "w0") + torch.tanh(mix("mix_w") @ w(p + "w_a"))
                      @ w(p + "w_b")).reshape(B, S, nh, hd)
    y = L.wkv(r, k, v, logw, w(p + "u").reshape(nh, hd))
    y = L.rms_norm(y.reshape(B, S, d), w(p + "ln"), eps) * g
    x = x + y @ w(p + "wo")
    h = L.rms_norm(x, w(p + "n2"), eps)
    xk = h + (L.token_shift(h) - h) * w(p + "cm_mix")
    return x + torch.square(F.relu(xk @ w(p + "cm_k"))) @ w(p + "cm_v")


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


def blocks(a):
    """[(block function, name prefix)] in the order the equations apply
    them."""
    if a["equations"] == "rwkv6":
        return [(rwkv6_block, f"layers.{i}.rwkv.")
                for i in range(a["n_layers"])]
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


def hidden(w, a, tokens, block_fn=None):
    """The final normed hidden state (B, S, d) of tokens (B, S).
    `block_fn(fn, w, prefix, a, x)` may wrap each block (a checkpoint)."""
    x = w("embed.embed")[tokens.long()]
    for fn, p in blocks(a):
        x = fn(w, p, a, x) if block_fn is None else block_fn(fn, w, p, a, x)
    return L.rms_norm(x, w("final_norm"), a["norm_eps"])


def last_logits(w, a, tokens):
    """Logits (B, V) at each row's last position."""
    with torch.no_grad():
        return hidden(w, a, tokens)[:, -1] @ w("embed.head")
