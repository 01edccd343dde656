"""CUDA build, binding and launch wrappers of `csrc/wkv_scan.cu` and of
its backward, `csrc/wkv_scan_bwd.cu`.

Replaces `wkv_scan` of `repro/kernels/wkv_scan/kernel.py`, and takes the
initial state `s0` that the reference's plain version takes. The source
is built with nvcc for sm_90a at first launch through
`kernels/_build.py`; nothing is built or loaded at import. Every call
adds one to `KERNEL.launches`, however many of the source's kernels it
runs (three: chunk states, the state pass, chunk outputs). The backward
has no TPU counterpart (the reference takes jax.grad of its jnp scan); it
is its own library with its own count, `KERNEL_BWD.launches`, one a call
of its four kernels (the r side and the gradient's chunk states, the
reverse state pass, the k and v sides and dlogw, du's fixed-order sum).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import (CudaLibrary, check_cuda,
                                        check_dtypes, check_fp32)

KERNEL = CudaLibrary("wkv_scan.cu", "wkv_scan", {
    "wkv_scan_launch": ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
                        + [ctypes.c_void_p], ctypes.c_int)})
KERNEL_BWD = CudaLibrary("wkv_scan_bwd.cu", "wkv_scan_bwd", {
    "wkv_scan_bwd_launch": ([ctypes.c_void_p] * 17 + [ctypes.c_int] * 6
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
    dtype, sT (B, nh, hd, hd) fp32). One launch (one count)."""
    return wkv_scan_fwd(r, k, v, logw, u, s0, chunk=chunk)[:2]


def wkv_scan_fwd(r, k, v, logw, u, s0=None, *, chunk=CHUNK):
    """`wkv_scan` that also returns the chunk states, the backward's
    input: (y, sT, states (B, nh, S / Q, hd, hd) fp32). One launch (one
    count) runs the source's three kernels on the fp32 scratch allocated
    here: the chunk states and the chunks' decays. The state pass leaves
    the chunk states holding the state entering each chunk."""
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
    return y, sT, states


def wkv_scan_bwd(r, k, v, logw, u, states, dy, dsT=None, *, chunk=CHUNK,
                 want_ds0=True):
    """Gradients of `wkv_scan` (the plain version is
    `ref.wkv_scan_bwd_ref`). r, k, v, dy: (B, S, nh, hd) contiguous, one
    dtype; logw (B, S, nh, hd), u (nh, hd) fp32; states: the chunk states
    `wkv_scan_fwd` returned for the same inputs and chunk; dsT (B, nh,
    hd, hd) fp32 or None (zeros). Returns (dr, dk, dv of r's dtype, dlogw
    fp32, du (nh, hd) fp32, ds0 fp32 or None unless `want_ds0`). One
    launch (one count of `KERNEL_BWD`) runs the source's four kernels on
    the fp32 scratch allocated here: the gradient's chunk states, the
    chunks' decays and du's partials; the same inputs give the same bits."""
    Q, code = _check(r, k, v, logw, u, dsT, chunk)
    B, S, nh, hd = r.shape
    if dy.shape != r.shape or dy.dtype != r.dtype:
        raise ValueError(f"wkv_scan_bwd: dy must be {tuple(r.shape)} "
                         f"{r.dtype}, got {tuple(dy.shape)} {dy.dtype}")
    if tuple(states.shape) != (B, nh, S // Q, hd, hd):
        raise ValueError(f"wkv_scan_bwd: states must be "
                         f"{(B, nh, S // Q, hd, hd)}, got "
                         f"{tuple(states.shape)}")
    check_fp32("wkv_scan_bwd", states=states)
    check_cuda("wkv_scan_bwd", r=r, dy=dy, states=states)
    f32 = dict(dtype=torch.float32, device=r.device)
    dr, dk, dv = (torch.empty_like(r) for _ in range(3))
    dlogw = torch.empty(r.shape, **f32)
    du = torch.zeros((nh, hd), **f32)
    ds0 = torch.empty((B, nh, hd, hd), **f32) if want_ds0 else None
    if B * nh:
        nc = S // Q
        dstate = torch.empty((B, nh, nc, hd, hd), **f32)
        decay = torch.empty((B, nh, nc, hd), **f32)
        dupart = torch.empty((B, nc, nh, hd), **f32)
        KERNEL_BWD.launch(
            "wkv_scan_bwd_launch", r.device, r.data_ptr(), k.data_ptr(),
            v.data_ptr(), dy.data_ptr(), logw.data_ptr(), u.data_ptr(),
            states.data_ptr(), None if dsT is None else dsT.data_ptr(),
            dr.data_ptr(), dk.data_ptr(), dv.data_ptr(), dlogw.data_ptr(),
            du.data_ptr(), None if ds0 is None else ds0.data_ptr(),
            dstate.data_ptr(), decay.data_ptr(), dupart.data_ptr(), code, B,
            S, nh, hd, Q,
            at=f"(B, S, nh, hd, Q) = {(B, S, nh, hd, Q)}, {r.dtype}")
    elif ds0 is not None:
        ds0 = torch.zeros_like(ds0) if dsT is None else dsT.clone()
    return dr, dk, dv, dlogw, du, ds0
