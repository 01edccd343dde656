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
    "flash_attention_launch": ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                               + [ctypes.c_longlong] * 12
                               + [ctypes.c_int] * 2 + [ctypes.c_float] * 2
                               + [ctypes.c_void_p] * 2, ctypes.c_int)})
HEAD_DIMS = (32, 64, 112, 128)


def _strides(t):
    """(b, head, s) strides of a 4-d tensor, in elements. A dimension of
    size 1 is never stepped, so it gets the tensor's element count, which
    keeps every stride a multiple of 16 bytes for the kernel's maps."""
    return [st if n > 1 else t.numel()
            for n, st in zip(t.shape[:3], t.stride()[:3])]


def _check_layout(**tensors):
    """Head-dim stride 1, other strides multiples of 16 bytes, 16-byte
    aligned: what the kernel's TMA maps and stores take."""
    for name, t in tensors.items():
        if t.stride(3) != 1 or any(st * t.element_size() % 16
                                   for st in _strides(t)):
            raise ValueError(f"flash_attention: {name} must have head-dim "
                             "stride 1 and other strides that are multiples "
                             f"of 16 bytes, got strides {t.stride()}")
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must be 16-byte "
                             "aligned")


def _check(q, k, v, out):
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
    if out.shape != q.shape or out.dtype != q.dtype:
        raise ValueError(f"flash_attention: out {tuple(out.shape)} "
                         f"{out.dtype} does not fit q {tuple(q.shape)} "
                         f"{q.dtype}")
    _check_layout(q=q, k=k, v=v, out=out)
    check_cuda("flash_attention", ("q", "k", "v", "out"), q=q, k=k, v=v,
               out=out)
    return code


def flash_attention(q, k, v, *, causal=True, window=0, softcap=0.0,
                    out=None):
    """q: (B, H, Sq, hd); k, v: (B, KV, Sk, hd), on one CUDA device,
    float32 or bfloat16 alike, head-dim stride 1 and other strides that
    are multiples of 16 bytes: contiguous, or the model layout (B, S,
    heads, hd) transposed, read in place. Returns (B, H, Sq, hd) of q's
    dtype, written into `out` (the same shape and dtype as q, any such
    strides: ops.py passes a transposed (B, Sq, H, hd) tensor) or into a
    new tensor laid out as q is."""
    if out is None and q.dim() == 4:
        out = torch.empty_like(q)
    code = _check(q, k, v, out)
    if window < 0 or softcap < 0:
        raise ValueError(f"flash_attention: window {window} and softcap "
                         f"{softcap} must be >= 0")
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    if out.numel():
        counter = torch.empty(1, dtype=torch.int32, device=q.device)
        KERNEL.launch(
            "flash_attention_launch", q.device, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), out.data_ptr(), code, B, H, KV, Sq, Sk, hd,
            *_strides(q), *_strides(k), *_strides(v), *_strides(out),
            int(bool(causal)), int(window), float(hd ** -0.5),
            float(softcap), counter.data_ptr(),
            at=f"(B, H, KV, Sq, Sk, hd) = {(B, H, KV, Sq, Sk, hd)}, "
               f"{q.dtype}")
    return out
