"""Public wrapper of the wkv_scan kernel (mirrors
`repro/kernels/wkv_scan/ops.py`, plus the initial state `s0` of the
plain version): pads the sequence to a chunk multiple with r = k = v =
logw = 0 steps (no output, no update, decay 1, so s_T stays exact), then
runs the plain version for CPU tensors and the CUDA kernel for CUDA
tensors, which launches or raises."""
from __future__ import annotations

import torch.nn.functional as F

from . import kernel, ref
from .kernel import CHUNK


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
        y, sT = kernel.wkv_scan(
            r.contiguous(), k.contiguous(), v.contiguous(),
            logw.float().contiguous(), u.float().contiguous(),
            None if s0 is None else s0.float().contiguous(), chunk=chunk)
    return y[:, :S], sT
