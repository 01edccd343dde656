"""Plain PyTorch version of the wkv_scan kernel: the naive sequential
RWKV6 recurrence, a copy of `repro/kernels/wkv_scan/ref.py`.

    y_t = S_t^T r_t + (r_t . (u*k_t)) v_t
    S_{t+1} = diag(w_t) S_t + k_t v_t^T      (per-channel decay w_t)

S_t is the state BEFORE absorbing token t (as in models/rwkv.py).
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
