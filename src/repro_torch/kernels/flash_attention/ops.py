"""Public wrapper of flash attention in the model layout: q (B, Sq, H,
hd), k/v (B, Sk, KV, hd) in and (B, Sq, H, hd) out, swapped to the
kernel's (B, H, S, hd). CPU tensors take the plain version; CUDA tensors
take the CUDA kernel, which launches or raises."""
from __future__ import annotations

from . import kernel, ref


def flash_attention(q, k, v, *, causal=True, window=0, softcap=0.0):
    """q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd) -> (B, Sq, H, hd)."""
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    if q.device.type == "cpu":
        out = ref.flash_attention_ref(qt, kt, vt, causal=causal,
                                      window=window, softcap=softcap)
    else:
        out = kernel.flash_attention(qt.contiguous(), kt.contiguous(),
                                     vt.contiguous(), causal=causal,
                                     window=window, softcap=softcap)
    return out.transpose(1, 2)
