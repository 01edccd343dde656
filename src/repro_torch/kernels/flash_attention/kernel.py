"""CUDA build, binding and launch wrapper of `csrc/flash_attention.cu`.

Replaces `flash_attention` of `repro/kernels/flash_attention/kernel.py`.
The source is built with nvcc for sm_90a at first launch through
`kernels/_build.py`; nothing is built or loaded at import. Every launch
adds one to `KERNEL.launches`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import CudaLibrary, check_cuda, check_dtypes

KERNEL = CudaLibrary("flash_attention.cu", "flash_attention", {
    "flash_attention_launch": ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
                               + [ctypes.c_float] * 2 + [ctypes.c_void_p],
                               ctypes.c_int)})
HEAD_DIMS = (32, 64, 128)


def _check(q, k, v):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 4:
            raise ValueError(f"flash_attention: {name} must be 4-d, got "
                             f"shape {tuple(t.shape)}")
    code = check_dtypes("flash_attention", q=q, k=k, v=v)
    B, H, _, hd = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not fit q {tuple(q.shape)}")
    if k.shape[1] == 0 or H % k.shape[1]:
        raise ValueError(f"flash_attention: H = {H} is not a multiple of "
                         f"KV = {k.shape[1]}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {hd} not in "
                         f"{HEAD_DIMS}")
    if k.shape[2] == 0:
        raise ValueError("flash_attention: no keys (Sk = 0)")
    check_cuda("flash_attention", q=q, k=k, v=v)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must be 16-byte "
                             "aligned")
    return code


def flash_attention(q, k, v, *, causal=True, window=0, softcap=0.0):
    """q: (B, H, Sq, hd); k, v: (B, KV, Sk, hd), contiguous, on one CUDA
    device, float32 or bfloat16 alike -> (B, H, Sq, hd) of q's dtype."""
    code = _check(q, k, v)
    if window < 0 or softcap < 0:
        raise ValueError(f"flash_attention: window {window} and softcap "
                         f"{softcap} must be >= 0")
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if out.numel():
        KERNEL.launch(
            "flash_attention_launch", q.device, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), out.data_ptr(), code, B, H, KV, Sq, Sk, hd,
            int(bool(causal)), int(window), float(hd ** -0.5),
            float(softcap),
            at=f"(B, H, KV, Sq, Sk, hd) = {(B, H, KV, Sq, Sk, hd)}, "
               f"{q.dtype}")
    return out
