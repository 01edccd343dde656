"""CUDA build, binding and launch wrappers of `csrc/ssd_scan.cu` and of
its backward, `csrc/ssd_scan_bwd.cu`.

Replaces `ssd_scan` of `repro/kernels/ssd_scan/kernel.py`. The sources
are built with nvcc for sm_90a at first launch through
`kernels/_build.py`; nothing is built or loaded at import. Every launch
adds one to `KERNEL.launches`. The backward has no TPU counterpart (the
reference takes jax.grad of its jnp scan); it is its own library with
its own count, `KERNEL_BWD.launches`, one a call of its four kernels.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import (CudaLibrary, check_cuda,
                                        check_dtypes, check_fp32)

KERNEL = CudaLibrary("ssd_scan.cu", "ssd_scan", {
    "ssd_scan_launch": ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 7
                        + [ctypes.c_longlong] * 2 + [ctypes.c_void_p],
                        ctypes.c_int)})
KERNEL_BWD = CudaLibrary("ssd_scan_bwd.cu", "ssd_scan_bwd", {
    "ssd_scan_bwd_launch": ([ctypes.c_void_p] * 21 + [ctypes.c_int] * 8
                            + [ctypes.c_longlong] * 2 + [ctypes.c_void_p],
                            ctypes.c_int)})
CHUNK = 128          # the TPU kernel's chunk; also the largest supported
                     # and the edge of the kernel's C B^T tiles
MAX_HD = MAX_DS = 64
MAX_HEADS_PER_BLOCK = 8   # the backward's chunk kernel: heads a block
MIN_HEADS_PER_BLOCK = 4


def _check(x, dt, A_log, B, C, D, chunk):
    if x.dim() != 4 or dt.dim() != 3 or B.dim() != 3 or C.dim() != 3:
        raise ValueError(f"ssd_scan: x must be 4-d and dt, B, C 3-d, got "
                         f"{tuple(x.shape)}, {tuple(dt.shape)}, "
                         f"{tuple(B.shape)}, {tuple(C.shape)}")
    Bb, S, nh, hd = x.shape
    ds = B.shape[-1]
    if (tuple(dt.shape) != (Bb, S, nh) or tuple(B.shape) != (Bb, S, ds)
            or C.shape != B.shape or tuple(A_log.shape) != (nh,)
            or tuple(D.shape) != (nh,)):
        raise ValueError(f"ssd_scan: shapes do not fit x {tuple(x.shape)}: "
                         f"dt {tuple(dt.shape)}, B {tuple(B.shape)}, C "
                         f"{tuple(C.shape)}, A_log {tuple(A_log.shape)}, D "
                         f"{tuple(D.shape)}")
    code = check_dtypes("ssd_scan", x=x, B=B, C=C)
    check_fp32("ssd_scan", dt=dt, A_log=A_log, D=D)
    if hd > MAX_HD or ds > MAX_DS or not 1 <= chunk <= CHUNK:
        raise ValueError(f"ssd_scan: supports hd <= {MAX_HD}, ds <= "
                         f"{MAX_DS} and chunk <= {CHUNK}, got hd {hd}, ds "
                         f"{ds}, chunk {chunk}")
    Q = min(chunk, S)
    if S == 0 or S % Q:
        raise ValueError(f"ssd_scan: S = {S} is not a multiple of the "
                         f"chunk {Q}; pad it (ops.ssd_scan does)")
    check_cuda("ssd_scan", ("B", "C"), x=x, dt=dt, A_log=A_log, B=B, C=C,
               D=D)
    if B.stride() != C.stride() or B.stride(-1) != 1:
        raise ValueError(f"ssd_scan: B and C must share strides with unit "
                         f"channel stride, got {B.stride()}, {C.stride()}")
    return Q, code


def ssd_scan(x, dt, A_log, B, C, D, *, chunk=CHUNK):
    """x: (Bb, S, nh, hd) contiguous; dt: (Bb, S, nh) fp32; B, C: (Bb, S,
    ds), unit channel stride (views of one tensor are fine); A_log, D:
    (nh,) fp32; S a multiple of min(chunk, S). Returns (y (Bb, S, nh, hd)
    of x's dtype, h_final (Bb, nh, hd, ds) fp32). One launch (one count)."""
    return ssd_scan_fwd(x, dt, A_log, B, C, D, chunk=chunk)[:2]


def ssd_scan_fwd(x, dt, A_log, B, C, D, *, chunk=CHUNK):
    """`ssd_scan` that also returns the chunk states, the backward's
    input: (y, h_final, states (Bb, nh, S / Q, hd, ds) fp32). One launch
    (one count) runs the source's four kernels on the fp32 scratch
    allocated here: C B^T tiles, the chunk states and the chunks' decays.
    The state pass leaves the chunk states holding the state entering
    each chunk."""
    Q, code = _check(x, dt, A_log, B, C, D, chunk)
    Bb, S, nh, hd = x.shape
    ds = B.shape[-1]
    y = torch.empty_like(x)
    hT = torch.empty((Bb, nh, hd, ds), dtype=torch.float32, device=x.device)
    nc = S // Q
    f32 = dict(dtype=torch.float32, device=x.device)
    cb = torch.empty((Bb, nc, CHUNK, CHUNK), **f32)
    states = torch.empty((Bb, nh, nc, hd, ds), **f32)
    decay = torch.empty((Bb, nh, nc), **f32)
    if Bb * nh:
        KERNEL.launch(
            "ssd_scan_launch", x.device, x.data_ptr(), dt.data_ptr(),
            A_log.data_ptr(), B.data_ptr(), C.data_ptr(), D.data_ptr(),
            y.data_ptr(), hT.data_ptr(), cb.data_ptr(), states.data_ptr(),
            decay.data_ptr(), code, Bb, S, nh, hd, ds, Q,
            B.stride(0), B.stride(1),
            at=f"(Bb, S, nh, hd, ds, Q) = {(Bb, S, nh, hd, ds, Q)}, "
               f"{x.dtype}")
    return y, hT, states


def heads_per_block(Bb, nh, nc, sms):
    """The heads G that one block of the backward's chunk kernel takes,
    for (Bb, nh, nc) = (batch, heads, chunks) on a card of `sms` SMs. The
    kernel runs one block an SM, and a block's time grows with its heads,
    so the call's time goes as the block waves, ceil(Bb nc ceil(nh / G) /
    sms), times G: the G from 8 down to 4 (at most nh) with the least of
    that, the largest on a tie (fewer group parts of dB and dC to sum)."""
    best = None
    for G in range(min(MAX_HEADS_PER_BLOCK, nh),
                   min(MIN_HEADS_PER_BLOCK, nh) - 1, -1):
        waves = -(-Bb * nc * -(-nh // G) // sms)
        if best is None or waves * G < best[0]:
            best = (waves * G, G)
    return best[1]


def ssd_scan_bwd(x, dt, A_log, B, C, D, states, dy, dhT=None, *,
                 chunk=CHUNK):
    """Gradients of `ssd_scan` (the plain version is
    `ref.ssd_scan_bwd_ref`). x, dt, A_log, B, C, D as `ssd_scan` takes
    them; states: the chunk states `ssd_scan_fwd` returned for the same
    inputs and chunk; dy (Bb, S, nh, hd) contiguous of x's dtype; dhT
    (Bb, nh, hd, ds) fp32 or None (zeros). Returns (dx of x's dtype, ddt
    (Bb, S, nh) fp32, dA_log (nh,) fp32, dB, dC (Bb, S, ds) contiguous of
    x's dtype, dD (nh,) fp32). One launch (one count of `KERNEL_BWD`)
    runs the source's four kernels on the fp32 scratch allocated here:
    the gradient's chunk states and the chunks' decays, the head groups'
    parts of dB and dC (a block of the chunk kernel takes
    `heads_per_block` heads) and the per-chunk parts of dA_log and dD; the
    same inputs give the same bits."""
    if x.dim() != 4 or B.dim() != 3:
        _check(x, dt, A_log, B, C, D, chunk)     # raises
    Bb, S, nh, hd = x.shape
    ds = B.shape[-1]
    nc = S // max(min(chunk, S), 1)
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"ssd_scan_bwd: dy must be {tuple(x.shape)} "
                         f"{x.dtype}, got {tuple(dy.shape)} {dy.dtype}")
    if tuple(states.shape) != (Bb, nh, nc, hd, ds):
        raise ValueError(f"ssd_scan_bwd: states must be "
                         f"{(Bb, nh, nc, hd, ds)}, got "
                         f"{tuple(states.shape)}")
    if dhT is not None and tuple(dhT.shape) != (Bb, nh, hd, ds):
        raise ValueError(f"ssd_scan_bwd: dhT must be {(Bb, nh, hd, ds)}, "
                         f"got {tuple(dhT.shape)}")
    grads = {} if dhT is None else {"dhT": dhT}
    check_fp32("ssd_scan_bwd", states=states, **grads)
    Q, code = _check(x, dt, A_log, B, C, D, chunk)
    check_cuda("ssd_scan_bwd", x=x, dy=dy, states=states, **grads)
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    ddt = torch.empty((Bb, S, nh), **f32)
    dA_log = torch.zeros((nh,), **f32)
    dB = torch.empty((Bb, S, ds), dtype=x.dtype, device=x.device)
    dC = torch.empty_like(dB)
    dD = torch.zeros((nh,), **f32)
    if Bb * nh:
        G = heads_per_block(
            Bb, nh, nc,
            torch.cuda.get_device_properties(x.device).multi_processor_count)
        dstate = torch.empty((Bb, nh, nc, hd, ds), **f32)
        decay = torch.empty((Bb, nh, nc), **f32)
        dBpart = torch.empty((Bb, -(-nh // G), S, ds), **f32)
        dCpart = torch.empty_like(dBpart)
        dApart = torch.empty((Bb, nc, nh), **f32)
        dDpart = torch.empty_like(dApart)
        KERNEL_BWD.launch(
            "ssd_scan_bwd_launch", x.device, x.data_ptr(), dt.data_ptr(),
            A_log.data_ptr(), B.data_ptr(), C.data_ptr(), D.data_ptr(),
            states.data_ptr(), dy.data_ptr(),
            None if dhT is None else dhT.data_ptr(), dx.data_ptr(),
            ddt.data_ptr(), dA_log.data_ptr(), dB.data_ptr(), dC.data_ptr(),
            dD.data_ptr(), dstate.data_ptr(), decay.data_ptr(),
            dBpart.data_ptr(), dCpart.data_ptr(), dApart.data_ptr(),
            dDpart.data_ptr(), code, Bb, S, nh, hd, ds, Q, G,
            B.stride(0), B.stride(1),
            at=f"(Bb, S, nh, hd, ds, Q, G) = "
               f"{(Bb, S, nh, hd, ds, Q, G)}, {x.dtype}")
    else:
        dB.zero_()
        dC.zero_()
    return dx, ddt, dA_log, dB, dC, dD
