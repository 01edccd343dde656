"""Public wrapper of flash attention in the model layout: q (B, Sq, H,
hd), k/v (B, Sk, KV, hd) in and (B, Sq, H, hd) out. The kernel reads
these tensors in place through (B, H, S, hd) views and writes a
contiguous (B, Sq, H, hd) output through its transposed view, so no
transpose is ever copied. CPU tensors take the plain version; CUDA
tensors take the CUDA kernel, which launches or raises. The kernel is
forward-only, as the TPU kernel is: on CUDA tensors that require grad,
with grad mode on, it raises."""
from __future__ import annotations

import torch

from repro_torch.kernels._build import refuse_grad

from . import kernel, ref


def flash_attention(q, k, v, *, causal=True, window=0, softcap=0.0):
    """q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd) -> (B, Sq, H, hd)."""
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    if q.device.type == "cpu":
        return ref.flash_attention_ref(qt, kt, vt, causal=causal,
                                       window=window,
                                       softcap=softcap).transpose(1, 2)
    refuse_grad("flash_attention", q=q, k=k, v=v)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    kernel.flash_attention(qt, kt, vt, causal=causal, window=window,
                           softcap=softcap, out=out.transpose(1, 2))
    return out
