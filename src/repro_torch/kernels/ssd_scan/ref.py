"""Plain PyTorch version of the ssd_scan kernel: the naive sequential
Mamba2 recurrence, a copy of `repro/kernels/ssd_scan/ref.py`
(deliberately another algorithm than the chunked scans, so agreement is
meaningful).

    h_t = exp(A dt_t) h_{t-1} + dt_t * (B_t outer x_t)
    y_t = C_t . h_t + D * x_t

`ssd_scan_bwd_ref` is the plain version of the backward kernel
(`csrc/ssd_scan_bwd.cu`): the reverse recurrence written out.
"""
from __future__ import annotations

import torch

SEGMENT = 64   # steps whose states the plain backward keeps at a time


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


def ssd_scan_bwd_ref(x, dt, A_log, B, C, D, dy, dhT=None):
    """Gradients of (y, h_T) = ssd_scan_ref(x, dt, A_log, B, C, D) given
    dy (Bb, S, nh, hd) and d h_T (Bb, nh, hd, ds) or None (zeros).
    Returns (dx (Bb, S, nh, hd) of x's dtype, ddt (Bb, S, nh) fp32,
    dA_log (nh,) fp32, dB, dC (Bb, S, ds) of B's dtype, dD (nh,) fp32).
    With a_t = A dt_t, A = -exp(A_log) and G_t the gradient of h_t, from
    G_{S-1} = dy_{S-1} C_{S-1}^T + d h_T down:
        G_t  = e^{a_{t+1}} G_{t+1} + dy_t C_t^T
        dx_t = dt_t G_t B_t + D dy_t
        dB_t = sum over heads of dt_t G_t^T x_t
        dC_t = sum over heads of h_t^T dy_t
        da_t = e^{a_t} <G_t, h_{t-1}>
        ddt_t = x_t . G_t B_t + A da_t
        dA_log = A sum over batch and time of dt_t da_t
        dD = sum over batch, time and hd of dy x.
    The states are kept SEGMENT steps at a time: the forward keeps the
    state entering each segment, and each segment's states are computed
    again on the way down."""
    Bb, S, nh, hd = x.shape
    ds = B.shape[-1]
    A = -torch.exp(A_log.float())
    xf, dtf, Bf, Cf, dyf = (a.float() for a in (x, dt, B, C, dy))
    dec = torch.exp(dtf * A)                                   # (Bb, S, nh)

    def step(h, t):
        return h * dec[:, t, :, None, None] + \
            (dtf[:, t, :, None] * xf[:, t])[..., None] * Bf[:, t, None, None, :]

    h = torch.zeros((Bb, nh, hd, ds), dtype=torch.float32, device=x.device)
    starts = []
    for t in range(S):
        if t % SEGMENT == 0:
            starts.append(h)
        h = step(h, t)
    G = torch.zeros_like(h) if dhT is None else dhT.float().clone()
    dx, ddt = torch.empty_like(xf), torch.empty_like(dtf)
    dB, dC = torch.empty_like(Bf), torch.empty_like(Cf)
    dA = torch.zeros_like(A)
    for s0 in reversed(range(0, S, SEGMENT)):
        hs = [starts[s0 // SEGMENT]]            # hs[k] = h_{s0 + k - 1}
        for t in range(s0, min(s0 + SEGMENT, S)):
            hs.append(step(hs[-1], t))
        for t in reversed(range(s0, min(s0 + SEGMENT, S))):
            h_prev, h_t = hs[t - s0], hs[t - s0 + 1]
            G = G + dyf[:, t, :, :, None] * Cf[:, t, None, None, :]
            GB = torch.einsum("bhds,bs->bhd", G, Bf[:, t])
            dx[:, t] = dtf[:, t, :, None] * GB + D.float()[None, :, None] * dyf[:, t]
            dB[:, t] = torch.einsum("bhds,bhd,bh->bs", G, xf[:, t], dtf[:, t])
            dC[:, t] = torch.einsum("bhds,bhd->bs", h_t, dyf[:, t])
            da = dec[:, t] * (G * h_prev).sum((-1, -2))         # (Bb, nh)
            ddt[:, t] = (xf[:, t] * GB).sum(-1) + A * da
            dA += (dtf[:, t] * da).sum(0)
            G = G * dec[:, t, :, None, None]
    dD = (dyf * xf).sum((0, 1, 3))
    return (dx.to(x.dtype), ddt, A * dA, dB.to(B.dtype), dC.to(C.dtype), dD)
