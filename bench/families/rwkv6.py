"""RWKV-6 (Finch): each of `n_layers` blocks is x += time_mix(rms(x,
n1)); x += channel_mix(rms(x, n2)), then rms(x, final_norm) @ head. The
time mix runs the WKV recurrence (`reference/layers.py::wkv`, the
wkv_scan kernel) over `d_model // rwkv_head_dim` heads."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from bench import costs, weights
from bench.reference import layers as L

NORMALS = {
    "w0": (-1.0, 0.25),      # decay base: logw = -exp(w0 + ...)
    "u": (0.0, 0.5),         # bonus
}


def layout(a: dict):
    d, ff, V = a["d_model"], a["d_ff"], a["vocab"]
    lora = a["rwkv_lora"]
    out = [("embed.embed", (V, d), "e"), ("embed.head", (d, V), "w"),
           ("final_norm", (d,), "norm")]
    for i in range(a["n_layers"]):
        p = f"layers.{i}.rwkv."
        out += [(p + n, (d,), "mix") for n in
                ("mix_r", "mix_k", "mix_v", "mix_w", "mix_g")]
        out += [(p + n, (d, d), "w") for n in ("wr", "wk", "wv", "wg", "wo")]
        out += [(p + "w0", (d,), "w0"), (p + "w_a", (d, lora), "lora_a"),
                (p + "w_b", (lora, d), "lora_b"), (p + "u", (d,), "u"),
                (p + "ln", (d,), "norm"), (p + "n1", (d,), "norm"),
                (p + "n2", (d,), "norm"), (p + "cm_mix", (d,), "mix"),
                (p + "cm_k", (d, ff), "w"), (p + "cm_v", (ff, d), "w")]
    return out


def block(w, p, a, x):
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


def blocks(a: dict):
    return [(block, f"layers.{i}.rwkv.") for i in range(a["n_layers"])]


def applied(a: dict) -> int:
    return weights.count(a)


def wkv(a: dict):
    hd = a["rwkv_head_dim"]
    return a["d_model"] // hd, hd


def ssd(a: dict):
    return None


def attention(a: dict):
    return None


def scan_flops(a: dict, B: int, S: int) -> float:
    nh, hd = wkv(a)
    return a["n_layers"] * costs.wkv_cost(B, S, nh, hd, 2, True)[False][1]
