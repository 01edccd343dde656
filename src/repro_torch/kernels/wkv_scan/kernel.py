"""CUDA build, binding and launch wrapper of `csrc/wkv_scan.cu`.

Replaces `wkv_scan` of `repro/kernels/wkv_scan/kernel.py`, and takes the
initial state `s0` that the reference's plain version takes. The source
is built with nvcc for sm_90a at first launch through
`kernels/_build.py`; nothing is built or loaded at import. Every call
adds one to `KERNEL.launches`, however many of the source's kernels it
runs (three: chunk states, the state pass, chunk outputs).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import (CudaLibrary, check_cuda,
                                        check_dtypes, check_fp32)

KERNEL = CudaLibrary("wkv_scan.cu", "wkv_scan", {
    "wkv_scan_launch": ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
                        + [ctypes.c_void_p], ctypes.c_int)})
CHUNK = 64           # the TPU kernel's chunk; also the largest supported
MAX_HD = 64


def _check(r, k, v, logw, u, s0, chunk):
    if r.dim() != 4:
        raise ValueError(f"wkv_scan: r must be 4-d, got {tuple(r.shape)}")
    B, S, nh, hd = r.shape
    if (k.shape != r.shape or v.shape != r.shape or logw.shape != r.shape
            or tuple(u.shape) != (nh, hd)
            or (s0 is not None and tuple(s0.shape) != (B, nh, hd, hd))):
        raise ValueError(
            f"wkv_scan: shapes do not fit r {tuple(r.shape)}: k "
            f"{tuple(k.shape)}, v {tuple(v.shape)}, logw "
            f"{tuple(logw.shape)}, u {tuple(u.shape)}, s0 "
            f"{None if s0 is None else tuple(s0.shape)}")
    state = {} if s0 is None else {"s0": s0}
    code = check_dtypes("wkv_scan", r=r, k=k, v=v)
    check_fp32("wkv_scan", logw=logw, u=u, **state)
    if hd > MAX_HD or not 1 <= chunk <= CHUNK:
        raise ValueError(f"wkv_scan: supports hd <= {MAX_HD} and chunk <= "
                         f"{CHUNK}, got hd {hd}, chunk {chunk}")
    Q = min(chunk, S)
    if S == 0 or S % Q:
        raise ValueError(f"wkv_scan: S = {S} is not a multiple of the "
                         f"chunk {Q}; pad it (ops.wkv_scan does)")
    check_cuda("wkv_scan", r=r, k=k, v=v, logw=logw, u=u, **state)
    return Q, code


def wkv_scan(r, k, v, logw, u, s0=None, *, chunk=CHUNK):
    """r, k, v: (B, S, nh, hd) contiguous, one dtype; logw: (B, S, nh,
    hd) fp32; u: (nh, hd) fp32; s0: (B, nh, hd, hd) fp32 or None (zeros);
    S a multiple of min(chunk, S). Returns (y (B, S, nh, hd) of r's
    dtype, sT (B, nh, hd, hd) fp32). One launch (one count) runs the
    source's three kernels on the fp32 scratch allocated here: the chunk
    states (B nh S / Q hd^2 floats) and the chunks' decays."""
    Q, code = _check(r, k, v, logw, u, s0, chunk)
    B, S, nh, hd = r.shape
    y = torch.empty_like(r)
    f32 = dict(dtype=torch.float32, device=r.device)
    sT = torch.empty((B, nh, hd, hd), **f32)
    states = torch.empty((B, nh, S // Q, hd, hd), **f32)
    decay = torch.empty((B, nh, S // Q, hd), **f32)
    if B * nh:
        KERNEL.launch(
            "wkv_scan_launch", r.device, r.data_ptr(), k.data_ptr(),
            v.data_ptr(), logw.data_ptr(), u.data_ptr(),
            None if s0 is None else s0.data_ptr(), y.data_ptr(),
            sT.data_ptr(), states.data_ptr(), decay.data_ptr(), code, B, S,
            nh, hd, Q,
            at=f"(B, S, nh, hd, Q) = {(B, S, nh, hd, Q)}, {r.dtype}")
    return y, sT
