"""RWKV6 (Finch) block, port of `repro/models/rwkv.py`: time-mix with
data-dependent per-channel decay, then channel-mix.

Per head (K = V = head_dim): state S in R^{K x V}
    S_t = diag(w_t) S_{t-1} + k_t v_t^T
    y_t = S_{t-1}^T r_t + (r_t . (u*k_t)) v_t         (u = per-channel bonus)
w_t in (0,1) is data-dependent: w_t = exp(-exp(w0 + tanh(x W_a) W_b)).

The train/prefill scan goes through `kernels/wkv_scan/ops.py` (with the
carried state as `s0`) where the reference calls its chunked jnp scan
`wkv_chunk_scan` (rwkv.py:124): the CUDA kernel for CUDA tensors, the
naive recurrence for CPU tensors. `wkv_chunk_scan` is kept as a torch
copy, held against the reference's; on `meta` tensors (the dry run) the
model takes it, as the reference's own scan. Decode is plain PyTorch, as
in the reference.

Under a layout (`lay=`, `sharding/layout.py`) the time-mix is FSDP only
(`rwkv/w[rkvgo]` split over `data`, whole over `model`): a duplicated
region. The channel-mix is tensor-parallel: `cm_k` split by columns,
`cm_v` by rows, one all-reduce over `model` (a reduce-scatter into the
sequence-split training residual).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.wkv_scan.ops import wkv_scan

from .common import ModelConfig, Params, dense_init, init_rms, rms_norm

CHUNK = 128
LORA = 32


def rwkv_dims(cfg: ModelConfig):
    nh = cfg.d_model // cfg.rwkv_head_dim
    return nh, cfg.rwkv_head_dim


def init_rwkv(cfg: ModelConfig, gen: torch.Generator) -> Params:
    d = cfg.d_model
    dev = gen.device
    f32 = dict(dtype=torch.float32, device=dev)
    half = lambda: torch.full((d,), 0.5, **f32)  # noqa: E731
    return Params({
        "mix_r": half(), "mix_k": half(), "mix_v": half(), "mix_w": half(),
        "mix_g": half(),
        "wr": dense_init(gen, (d, d), 0, cfg.cdtype),
        "wk": dense_init(gen, (d, d), 0, cfg.cdtype),
        "wv": dense_init(gen, (d, d), 0, cfg.cdtype),
        "wg": dense_init(gen, (d, d), 0, cfg.cdtype),
        "wo": dense_init(gen, (d, d), 0, cfg.cdtype),
        "w0": torch.full((d,), -1.0, **f32),  # decay base
        "w_a": dense_init(gen, (d, LORA), 0, torch.float32),
        "w_b": dense_init(gen, (LORA, d), 0, torch.float32) * 0.1,
        "u": torch.zeros((d,), **f32),  # bonus
        "ln": init_rms(d, dev),
        "n1": init_rms(d, dev),
        "n2": init_rms(d, dev),
        # channel-mix
        "cm_mix": half(),
        "cm_k": dense_init(gen, (d, cfg.d_ff), 0, cfg.cdtype),
        "cm_v": dense_init(gen, (cfg.d_ff, d), 0, cfg.cdtype),
    })


def _token_shift(x, last):
    """x: (B, S, d); last: (B, d) previous token (zeros at t=0)."""
    return torch.cat([last[:, None, :], x[:, :-1, :]], dim=1)


def _mix(x, prev, mu):
    return x + (prev - x) * mu.to(x.dtype)


def wkv_chunk_scan(r, k, v, logw, u, s0):
    """Chunked WKV, a torch copy of the reference's (not on the model
    path). r,k,v: (B, S, nh, hd); logw: (B, S, nh, hd) (<0); u: (nh,
    hd); s0: (B, nh, hd, hd) initial state. Returns (y, sT)."""
    B, S, nh, hd = r.shape
    Q = min(CHUNK, S)
    nc = S // Q
    rs = r.reshape(B, nc, Q, nh, hd).float()
    ks_ = k.reshape(B, nc, Q, nh, hd).float()
    vs = v.reshape(B, nc, Q, nh, hd).float()
    lw = logw.reshape(B, nc, Q, nh, hd).float()
    cum = torch.cumsum(lw, dim=2)  # (B,nc,Q,nh,hd) <= 0, decreasing
    # intra-chunk: A[i,j] = sum_c r_i[c] e^{cum_{i-1}[c] - cum_j[c]} k_j[c], j < i
    cum_prev = cum - lw  # cumulative decay up to and including step i-1
    r_dec = rs * torch.exp(cum_prev)
    k_dec = ks_ * torch.exp(-cum)
    A = torch.einsum("bnqhc,bnthc->bnhqt", r_dec, k_dec)  # (B,nc,nh,Q,Q)
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=r.device),
                      diagonal=-1)[None, None, None]
    A = torch.where(mask, A, 0.0)
    diag = torch.einsum("bnqhc,bnqhc->bnqh", rs,
                        ks_ * u[None, None, None].float())
    y_intra = torch.einsum("bnhqt,bnthd->bnqhd", A, vs)
    y_intra = y_intra + diag[..., None] * vs
    # state update: S_new = diag(e^{cum_Q}) S_prev + sum_j e^{cum_Q - cum_j} k_j v_j^T
    kw = ks_ * torch.exp(cum[:, :, -1:, :, :] - cum)
    S_chunk = torch.einsum("bnqhc,bnqhd->bnhcd", kw, vs)
    decay_chunk = torch.exp(cum[:, :, -1])  # (B, nc, nh, hd)

    s = s0.float()
    s_prevs = []  # the state at the START of each chunk
    for n in range(nc):
        s_prevs.append(s)
        s = s * decay_chunk[:, n, ..., None] + S_chunk[:, n]
    s_prevs = torch.stack(s_prevs)  # (nc, B, nh, hd, hd)
    y_inter = torch.einsum("bnqhc,nbhcd->bnqhd", r_dec, s_prevs)
    y = (y_intra + y_inter).reshape(B, S, nh, hd)
    return y.to(r.dtype), s


def _scan(r, k, v, logw, u, s0):
    if r.device.type == "meta":     # the dry run counts the chunked scan
        return wkv_chunk_scan(r, k, v, logw, u, s0)
    return wkv_scan(r, k, v, logw, u, s0=s0)


def _time_mix(p, cfg, x, last_x, s0):
    B, S, d = x.shape
    nh, hd = rwkv_dims(cfg)
    prev = _token_shift(x, last_x)
    xr = _mix(x, prev, p["mix_r"])
    xk = _mix(x, prev, p["mix_k"])
    xv = _mix(x, prev, p["mix_v"])
    xw = _mix(x, prev, p["mix_w"])
    xg = _mix(x, prev, p["mix_g"])
    r = (xr @ p["wr"]).reshape(B, S, nh, hd)
    k = (xk @ p["wk"]).reshape(B, S, nh, hd)
    v = (xv @ p["wv"]).reshape(B, S, nh, hd)
    g = F.silu(xg @ p["wg"])
    logw = -torch.exp(p["w0"] + torch.tanh(xw.float() @ p["w_a"]) @ p["w_b"])
    logw = logw.reshape(B, S, nh, hd)
    u = p["u"].reshape(nh, hd)
    y, sT = _scan(r, k, v, logw, u, s0)
    y = rms_norm(y.reshape(B, S, d), p["ln"], cfg.norm_eps) * g
    return y @ p["wo"], sT, x[:, -1, :]


def _channel_mix(p, cfg, xn, last_x):
    prev = _token_shift(xn, last_x)
    xk = _mix(xn, prev, p["cm_mix"])
    h = torch.square(F.relu(xk @ p["cm_k"]))
    return h @ p["cm_v"], xn[:, -1, :]


def _regions(p, cfg, lay):
    """(time-mix leaves, channel-mix leaves, the two regions) under a
    layout: each leaf replicated over `model` enters its region."""
    tm = lay.region(False)
    cm = lay.region(p["cm_k"].shape[1] < cfg.d_ff)
    names = [n for n, _ in p.named_parameters(recurse=False)]
    cm_names = ("cm_mix", "cm_k", "cm_v")
    ptm = {n: tm.rep(p[n]) for n in names if n not in cm_names + ("n2",)}
    pcm = {n: p[n] if cm.split and n != "cm_mix" else cm.rep(p[n])
           for n in cm_names}
    return ptm, pcm, tm, cm


def rwkv_forward(p, cfg: ModelConfig, x, state=None, lay=None):
    """Full RWKV6 block (time-mix + channel-mix). x: (B, S, d)."""
    B, S, d = x.shape
    if state is None:
        state = init_rwkv_state(cfg, B, device=x.device)
    if lay is not None:
        ptm, pcm, tm, cm = _regions(p, cfg, lay)
        n1, n2 = lay.resid.rep(p["n1"]), lay.resid.rep(p["n2"])
        a, sT, last_tm = _time_mix(ptm, cfg, tm.into(rms_norm(
            x, n1, cfg.norm_eps)), state["last_tm"], state["s"])
        x = x + tm.out(a)
        b, last_cm = _channel_mix(pcm, cfg, cm.into(rms_norm(
            x, n2, cfg.norm_eps)), state["last_cm"])
        x = x + cm.out(b)
        return x, {"s": sT.to(cfg.cdtype), "last_tm": last_tm,
                   "last_cm": last_cm}
    a, sT, last_tm = _time_mix(p, cfg, rms_norm(x, p["n1"], cfg.norm_eps),
                               state["last_tm"], state["s"])
    x = x + a
    b, last_cm = _channel_mix(p, cfg, rms_norm(x, p["n2"], cfg.norm_eps),
                              state["last_cm"])
    x = x + b
    return x, {"s": sT.to(cfg.cdtype), "last_tm": last_tm,
               "last_cm": last_cm}


def init_rwkv_state(cfg: ModelConfig, batch: int, device=None):
    nh, hd = rwkv_dims(cfg)
    return {
        "s": torch.zeros((batch, nh, hd, hd), dtype=cfg.cdtype,
                         device=device),
        "last_tm": torch.zeros((batch, cfg.d_model), dtype=cfg.cdtype,
                               device=device),
        "last_cm": torch.zeros((batch, cfg.d_model), dtype=cfg.cdtype,
                               device=device),
    }


def rwkv_decode(p, cfg: ModelConfig, x, state, lay=None):
    """One-token decode. x: (B, 1, d). O(1) state update. Under a layout
    the channel-mix's product leaves through its region (one all-reduce
    where `cm_k` / `cm_v` are split)."""
    B = x.shape[0]
    nh, hd = rwkv_dims(cfg)
    x_raw = x[:, 0]
    xt = rms_norm(x_raw, p["n1"], cfg.norm_eps)
    prev = state["last_tm"]

    def mix(mu):
        return xt + (prev - xt) * mu.to(x.dtype)
    r = (mix(p["mix_r"]) @ p["wr"]).reshape(B, nh, hd).float()
    k = (mix(p["mix_k"]) @ p["wk"]).reshape(B, nh, hd).float()
    v = (mix(p["mix_v"]) @ p["wv"]).reshape(B, nh, hd).float()
    g = F.silu(mix(p["mix_g"]) @ p["wg"])
    logw = -torch.exp(p["w0"] + torch.tanh(mix(p["mix_w"]).float()
                                           @ p["w_a"]) @ p["w_b"])
    w = torch.exp(logw).reshape(B, nh, hd)
    u = p["u"].reshape(nh, hd)
    s = state["s"].float()  # (B, nh, K, V)
    y = torch.einsum("bhk,bhkv->bhv", r, s) \
        + torch.einsum("bhk,bhk,bhv->bhv", r, u[None] * k, v)
    s_new = s * w[..., None] + k[..., None] * v[:, :, None, :]
    y = rms_norm(y.reshape(B, 1, cfg.d_model).to(x.dtype), p["ln"],
                 cfg.norm_eps) * g[:, None, :]
    a = y[:, 0] @ p["wo"]
    x1 = x_raw + a
    x1n = rms_norm(x1, p["n2"], cfg.norm_eps)
    prev_cm = state["last_cm"]
    xk = x1n + (prev_cm - x1n) * p["cm_mix"].to(x.dtype)
    h = torch.square(F.relu(xk @ p["cm_k"]))
    y2 = h @ p["cm_v"]
    if lay is not None:
        y2 = lay.region(p["cm_k"].shape[1] < cfg.d_ff).out(y2[:, None])[:, 0]
    x2 = x1 + y2
    new_state = {"s": s_new.to(cfg.cdtype), "last_tm": xt, "last_cm": x1n}
    return x2[:, None, :], new_state
