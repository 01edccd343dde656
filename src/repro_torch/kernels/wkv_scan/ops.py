"""Public wrapper of the wkv_scan kernel (mirrors
`repro/kernels/wkv_scan/ops.py`, plus the initial state `s0` of the
plain version): pads the sequence to a chunk multiple with r = k = v =
logw = 0 steps (no output, no update, decay 1, so s_T stays exact), then
runs the plain version for CPU tensors, which autograd differentiates,
and the CUDA kernel for CUDA tensors, which launches or raises. On CUDA
tensors the kernel runs inside `_WkvScan`, whose backward is the CUDA
kernel `csrc/wkv_scan_bwd.cu`; the padding goes through `F.pad`, so the
padded steps take no gradient."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import kernel, ref
from .kernel import CHUNK


class _WkvScan(torch.autograd.Function):
    """(y, s_T) = wkv_scan(r, k, v, logw, u, s0) on the card: the forward
    kernel keeps its chunk states for the backward kernel."""

    @staticmethod
    def forward(ctx, r, k, v, logw, u, s0, chunk):
        y, sT, states = kernel.wkv_scan_fwd(r, k, v, logw, u, s0,
                                            chunk=chunk)
        ctx.save_for_backward(r, k, v, logw, u, states)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return y, sT

    @staticmethod
    def backward(ctx, dy, dsT):
        r, k, v, logw, u, states = ctx.saved_tensors
        dy = torch.zeros_like(r) if dy is None else dy.to(r.dtype).contiguous()
        dsT = None if dsT is None else dsT.float().contiguous()
        dr, dk, dv, dlogw, du, ds0 = kernel.wkv_scan_bwd(
            r, k, v, logw, u, states, dy, dsT, chunk=ctx.chunk,
            want_ds0=ctx.needs_input_grad[5])
        return dr, dk, dv, dlogw, du, ds0, None


def wkv_scan(r, k, v, logw, u, s0=None, chunk: int = CHUNK):
    """r/k/v/logw: (B, S, nh, hd); u: (nh, hd); s0: (B, nh, hd, hd) or
    None (zeros). Returns (y (B, S, nh, hd), sT (B, nh, hd, hd) fp32)."""
    S = r.shape[1]
    pad = (-S) % min(chunk, max(S, 1))
    if pad:
        r, k, v, logw = (F.pad(a, (0, 0, 0, 0, 0, pad))
                         for a in (r, k, v, logw))
    if r.device.type == "cpu":
        y, sT = ref.wkv_scan_ref(r, k, v, logw, u, s0)
    else:
        y, sT = _WkvScan.apply(
            r.contiguous(), k.contiguous(), v.contiguous(),
            logw.float().contiguous(), u.float().contiguous(),
            None if s0 is None else s0.float().contiguous(), chunk)
    return y[:, :S], sT
