"""Plain PyTorch version of the ssd_scan kernel: the naive sequential
Mamba2 recurrence, a copy of `repro/kernels/ssd_scan/ref.py`
(deliberately another algorithm than the chunked scans, so agreement is
meaningful).

    h_t = exp(A dt_t) h_{t-1} + dt_t * (B_t outer x_t)
    y_t = C_t . h_t + D * x_t
"""
from __future__ import annotations

import torch


def ssd_scan_ref(x, dt, A_log, B, C, D):
    """x: (Bb, S, nh, hd); dt: (Bb, S, nh); B, C: (Bb, S, ds);
    A_log, D: (nh,). Returns (y of x's dtype, h_final (Bb, nh, hd, ds)
    fp32)."""
    Bb, S, nh, hd = x.shape
    ds = B.shape[-1]
    A = -torch.exp(A_log.float())
    xf, dtf, Bf, Cf = x.float(), dt.float(), B.float(), C.float()
    h = torch.zeros((Bb, nh, hd, ds), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        dec = torch.exp(dtf[:, t] * A[None, :])                 # (Bb, nh)
        h = h * dec[:, :, None, None] + \
            (dtf[:, t, :, None] * xf[:, t])[..., None] * Bf[:, t, None, None, :]
        ys.append(torch.einsum("bhds,bs->bhd", h, Cf[:, t]))
    y = torch.stack(ys, dim=1) + xf * D.float()[None, None, :, None]
    return y.to(x.dtype), h
