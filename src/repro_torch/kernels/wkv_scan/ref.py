"""Plain PyTorch version of the wkv_scan kernel: the naive sequential
RWKV6 recurrence, a copy of `repro/kernels/wkv_scan/ref.py`.

    y_t = S_t^T r_t + (r_t . (u*k_t)) v_t
    S_{t+1} = diag(w_t) S_t + k_t v_t^T      (per-channel decay w_t)

S_t is the state BEFORE absorbing token t (as in models/rwkv.py).
`wkv_scan_bwd_ref` is the plain version of the backward kernel
(`csrc/wkv_scan_bwd.cu`): the reverse recurrence written out.
"""
from __future__ import annotations

import torch


def wkv_scan_ref(r, k, v, logw, u, s0=None):
    """r, k, v, logw: (B, S, nh, hd); u: (nh, hd); s0: (B, nh, hd, hd) or
    None (zeros). Returns (y (B, S, nh, hd) of r's dtype, sT (B, nh, hd,
    hd) fp32)."""
    B, S, nh, hd = r.shape
    if s0 is None:
        s = torch.zeros((B, nh, hd, hd), dtype=torch.float32,
                        device=r.device)
    else:
        s = s0.float()
    rf, kf, vf, wf = (a.float() for a in (r, k, v, logw))
    uf = u.float()[None]
    ys = []
    for t in range(S):
        rt, kt, vt = rf[:, t], kf[:, t], vf[:, t]        # (B, nh, hd)
        y = torch.einsum("bhk,bhkv->bhv", rt, s) \
            + torch.einsum("bhk,bhk,bhv->bhv", rt, uf * kt, vt)
        s = s * torch.exp(wf[:, t])[..., None] + kt[..., None] * vt[:, :, None, :]
        ys.append(y)
    return torch.stack(ys, dim=1).to(r.dtype), s


def wkv_scan_bwd_ref(r, k, v, logw, u, s0, dy, dsT=None):
    """Gradients of (y, s_T) = wkv_scan_ref(r, k, v, logw, u, s0) given
    dy (B, S, nh, hd) and d s_T (B, nh, hd, hd) or None (zeros). Returns
    (dr, dk, dv of r's dtype, dlogw (B, S, nh, hd), du (nh, hd), ds0 (B,
    nh, hd, hd), all three fp32). With w_t = e^{logw_t}, from dS_S = d s_T
    down:
        dr_t = S_t dy_t + (u k_t)(v_t . dy_t)
        dk_t = dS_{t+1} v_t + (u r_t)(v_t . dy_t)
        dv_t = dS_{t+1}^T k_t + (r_t . (u k_t)) dy_t
        du  += r_t k_t (v_t . dy_t)          (summed over batch and time)
        dlogw_t = w_t rowsum(dS_{t+1} * S_t)
        dS_t = diag(w_t) dS_{t+1} + r_t dy_t^T,   ds0 = dS_0."""
    B, S, nh, hd = r.shape
    rf, kf, vf, dyf = (a.float() for a in (r, k, v, dy))
    w = torch.exp(logw.float())
    uf = u.float()[None]
    s = torch.zeros((B, nh, hd, hd), dtype=torch.float32, device=r.device) \
        if s0 is None else s0.float()
    states = []
    for t in range(S):
        states.append(s)
        s = s * w[:, t][..., None] + kf[:, t][..., None] * vf[:, t][:, :, None]
    dS = torch.zeros_like(s) if dsT is None else dsT.float().clone()
    vdy = (vf * dyf).sum(-1)                       # (B, S, nh)
    dr, dk, dv, dlogw = (torch.empty_like(rf) for _ in range(4))
    du = torch.zeros_like(uf[0])
    for t in reversed(range(S)):
        st = states[t]
        rt, kt, vt, dyt = rf[:, t], kf[:, t], vf[:, t], dyf[:, t]
        vd = vdy[:, t][..., None]                  # (B, nh, 1)
        dr[:, t] = torch.einsum("bhij,bhj->bhi", st, dyt) + uf * kt * vd
        dk[:, t] = torch.einsum("bhij,bhj->bhi", dS, vt) + uf * rt * vd
        dv[:, t] = torch.einsum("bhij,bhi->bhj", dS, kt) \
            + (rt * uf * kt).sum(-1, keepdim=True) * dyt
        dlogw[:, t] = w[:, t] * (dS * st).sum(-1)
        du += (rt * kt * vd).sum(0)
        dS = dS * w[:, t][..., None] + rt[..., None] * dyt[:, :, None]
    return (dr.to(r.dtype), dk.to(r.dtype), dv.to(r.dtype), dlogw, du, dS)
