"""Public wrapper of the ssd_scan kernel (mirrors
`repro/kernels/ssd_scan/ops.py`): pads the sequence to a chunk multiple
with dt = 0 steps (decay 1, no input, so h_T stays exact), then runs the
plain version for CPU tensors, which autograd differentiates, and the
CUDA kernel for CUDA tensors, which launches or raises. On CUDA tensors
the kernel runs inside `_SsdScan`, whose backward is the CUDA kernel
`csrc/ssd_scan_bwd.cu`; the padding goes through `F.pad`, so the padded
steps take no gradient."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels._build import PLAIN_DEVICES

from . import kernel, ref
from .kernel import CHUNK


class _SsdScan(torch.autograd.Function):
    """(y, h_T) = ssd_scan(x, dt, A_log, B, C, D) on the card: the forward
    kernel keeps its chunk states for the backward kernel. B and C may be
    views of one tensor; their gradients come back apart, and autograd
    adds them into the tensor they view."""

    @staticmethod
    def forward(ctx, x, dt, A_log, B, C, D, chunk):
        y, hT, states = kernel.ssd_scan_fwd(x, dt, A_log, B, C, D,
                                            chunk=chunk)
        ctx.save_for_backward(x, dt, A_log, B, C, D, states)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return y, hT

    @staticmethod
    def backward(ctx, dy, dhT):
        x, dt, A_log, B, C, D, states = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy.to(x.dtype).contiguous()
        dhT = None if dhT is None else dhT.float().contiguous()
        dx, ddt, dA_log, dB, dC, dD = kernel.ssd_scan_bwd(
            x, dt, A_log, B, C, D, states, dy, dhT, chunk=ctx.chunk)
        return dx, ddt, dA_log, dB, dC, dD, None


def ssd_scan(x, dt, A_log, B, C, D, chunk: int = CHUNK):
    """x: (Bb, S, nh, hd); dt: (Bb, S, nh); B, C: (Bb, S, ds); A_log, D:
    (nh,). Returns (y (Bb, S, nh, hd), h_final (Bb, nh, hd, ds) fp32)."""
    S = x.shape[1]
    pad = (-S) % min(chunk, max(S, 1))
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt, B, C = (F.pad(a, (0, 0, 0, pad)) for a in (dt, B, C))
    if x.device.type in PLAIN_DEVICES:
        y, hT = ref.ssd_scan_ref(x, dt, A_log, B, C, D)
    else:
        y, hT = _SsdScan.apply(x.contiguous(), dt.float().contiguous(),
                               A_log.float().contiguous(), B, C,
                               D.float().contiguous(), chunk)
    return y[:, :S], hT
