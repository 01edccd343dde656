"""Plain PyTorch version of the flash_attention kernel: the naive-softmax
oracle, a copy of `repro/kernels/flash_attention/ref.py`."""
from __future__ import annotations

import torch

NEG_INF = -2.0 ** 30


def flash_attention_ref(q, k, v, *, causal=True, window=0, softcap=0.0):
    """q: (B, H, Sq, hd); k, v: (B, KV, Sk, hd); GQA via H % KV == 0.
    Returns (B, H, Sq, hd). Scores in fp32; the probabilities are cast
    to v's dtype before the PV product."""
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    G = H // KV
    kk = k.repeat_interleave(G, dim=1)
    vv = v.repeat_interleave(G, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk.float())
    s = s * hd ** -0.5
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    qp = torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq)
    kp = torch.arange(Sk, device=q.device)[None, :]
    ok = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        ok &= kp <= qp
    if window:
        ok &= (qp - kp) < window
    s = torch.where(ok, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype), vv)
