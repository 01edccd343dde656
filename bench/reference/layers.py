"""Plain PyTorch layer equations of the benchmark's reference, in
float32 and imported from nothing but torch: RMSNorm, RoPE, causal
attention, the SwiGLU MLP, the RWKV-6 WKV recurrence and Mamba2's SSD
recurrence, each written in a chunked matrix form whose exponents never
grow (see each function). Callers set TF32 off (`fp32_exact`)."""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def fp32_exact():
    """Full float32 products inside: TF32 off for cuBLAS and cuDNN."""
    mm, cd = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd


def rms_norm(x, scale, eps):
    """x * rsqrt(mean(x^2) + eps) * (1 + scale), over the last dim."""
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) \
        * (1.0 + scale)


def rope(x, theta):
    """x (B, S, H, hd) at positions 0..S-1: the two halves of each head
    rotated by position / theta**(2i / hd)."""
    S, hd = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                       device=x.device) / hd)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q, k, v, q_block=1024):
    """softmax(q k^T / sqrt(hd)) v over keys at or before each query, one
    block of queries at a time. q, k, v: (B, S, H, hd)."""
    B, S, H, hd = q.shape
    kt, vt = k.permute(0, 2, 3, 1), v.transpose(1, 2)   # (B,H,hd,S) (B,H,S,hd)
    out = []
    for lo in range(0, S, q_block):
        qb = q[:, lo:lo + q_block].transpose(1, 2)        # (B, H, Sq, hd)
        s = qb @ kt * hd ** -0.5                          # (B, H, Sq, S)
        qi = torch.arange(lo, lo + qb.shape[2], device=q.device)[:, None]
        kj = torch.arange(S, device=q.device)[None, :]
        s = s.masked_fill(kj > qi, float("-inf"))
        out.append((torch.softmax(s, dim=-1) @ vt).transpose(1, 2))
    return torch.cat(out, dim=1)


def swiglu(x, w_gate, w_up, w_down):
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def token_shift(x):
    """x (B, S, d) -> the previous token's x (zeros before the first)."""
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


WKV_CHUNK = 32
MAX_LOG_RANGE = 80.0   # e**80 is far inside float32's range


def wkv(r, k, v, logw, u):
    """RWKV-6's recurrence from a zero state, per head (K = V = hd):
        y_t = S_{t-1}^T r_t + (r_t . (u * k_t)) v_t
        S_t = diag(exp(logw_t)) S_{t-1} + k_t v_t^T
    r, k, v, logw: (B, S, nh, hd), logw < 0; u: (nh, hd). In chunks of
    WKV_CHUNK steps: inside a chunk the pair (i, j < i) weighs r_i k_j by
    exp(cum_{i-1} - cum_j), split into r_i exp(cum_{i-1}) and k_j
    exp(-cum_j); the chunk's cumulative log-decay is checked to stay
    within MAX_LOG_RANGE so neither factor leaves float32's range.
    Returns y (B, S, nh, hd)."""
    B, S, nh, hd = r.shape
    Q = min(WKV_CHUNK, S)
    if S % Q:
        raise ValueError(f"wkv: S = {S} is not a multiple of {Q}")
    nc = S // Q
    rs, ks, vs, lw = (t.reshape(B, nc, Q, nh, hd) for t in (r, k, v, logw))
    cum = torch.cumsum(lw, dim=2)
    if float(-cum.detach().min()) > MAX_LOG_RANGE:
        raise ValueError("wkv: a chunk's decay leaves float32's range")
    r_dec = rs * torch.exp(cum - lw)           # exp(cum_{i-1}) <= 1
    k_dec = ks * torch.exp(-cum)               # exp(-cum_j) >= 1
    A = torch.einsum("bnqhc,bnthc->bnhqt", r_dec, k_dec)
    A = A * torch.tril(torch.ones(Q, Q, device=r.device), diagonal=-1)
    y = torch.einsum("bnhqt,bnthd->bnqhd", A, vs)
    y = y + torch.einsum("bnqhc,bnqhc->bnqh", rs, ks * u)[..., None] * vs
    k_end = ks * torch.exp(cum[:, :, -1:] - cum)           # <= 1
    s_chunk = torch.einsum("bnqhc,bnqhd->bnhcd", k_end, vs)
    decay = torch.exp(cum[:, :, -1])                        # (B, nc, nh, hd)
    s = torch.zeros(B, nh, hd, hd, device=r.device)
    for n in range(nc):
        y[:, n] += torch.einsum("bqhc,bhcd->bqhd", r_dec[:, n], s)
        s = s * decay[:, n, :, :, None] + s_chunk[:, n]
    return y.reshape(B, S, nh, hd)


SSD_CHUNK = 64


def ssd(x, dt, a_log, Bm, Cm, D):
    """Mamba2's recurrence from a zero state (one B/C group shared by
    the heads):
        h_t = exp(dt_t a) h_{t-1} + dt_t x_t B_t^T,   a = -exp(a_log)
        y_t = h_t C_t + D x_t
    x: (B, S, nh, hd); dt: (B, S, nh) > 0; Bm, Cm: (B, S, ds). In chunks
    of SSD_CHUNK steps, each pair (i, j <= i) weighed by exp(cum_i -
    cum_j) taken as one exponent (never positive). Returns y (B, S, nh,
    hd)."""
    Bb, S, nh, hd = x.shape
    ds = Bm.shape[-1]
    Q = min(SSD_CHUNK, S)
    if S % Q:
        raise ValueError(f"ssd: S = {S} is not a multiple of {Q}")
    nc = S // Q
    la = dt * -torch.exp(a_log)                      # (B, S, nh) <= 0
    xc = x.reshape(Bb, nc, Q, nh, hd)
    dtc = dt.reshape(Bb, nc, Q, nh)
    Bc, Cc = Bm.reshape(Bb, nc, Q, ds), Cm.reshape(Bb, nc, Q, ds)
    cum = torch.cumsum(la.reshape(Bb, nc, Q, nh), dim=2)
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]     # (B,nc,Q,Q,nh)
    causal = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=x.device))
    L = torch.exp(diff.masked_fill(~causal[None, None, :, :, None],
                                   float("-inf")))
    scores = torch.einsum("bnqs,bnts->bnqt", Cc, Bc)[..., None] * L \
        * dtc[:, :, None, :, :]
    y = torch.einsum("bnqth,bnthd->bnqhd", scores, xc)
    w_end = torch.exp(cum[:, :, -1:, :] - cum) * dtc           # <= dt
    h_chunk = torch.einsum("bnqh,bnqs,bnqhd->bnhds", w_end, Bc, xc)
    decay = torch.exp(cum[:, :, -1, :])                          # (B, nc, nh)
    c_in = torch.exp(cum)                                        # (B,nc,Q,nh)
    h = torch.zeros(Bb, nh, hd, ds, device=x.device)
    for n in range(nc):
        y[:, n] += torch.einsum("bqs,bqh,bhds->bqhd", Cc[:, n], c_in[:, n], h)
        h = h * decay[:, n, :, None, None] + h_chunk[:, n]
    return (y + xc * D[:, None]).reshape(Bb, S, nh, hd)


def causal_conv(u, w, b):
    """silu of the depthwise causal conv over the sequence: out_t =
    sum_i u_{t-K+1+i} w_i + b. u: (B, S, C); w: (K, C)."""
    K = w.shape[0]
    pad = F.pad(u, (0, 0, K - 1, 0))
    out = sum(pad[:, i:i + u.shape[1]] * w[i] for i in range(K))
    return F.silu(out + b)
