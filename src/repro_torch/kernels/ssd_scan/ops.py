"""Public wrapper of the ssd_scan kernel (mirrors
`repro/kernels/ssd_scan/ops.py`): pads the sequence to a chunk multiple
with dt = 0 steps (decay 1, no input, so h_T stays exact), then runs the
plain version for CPU tensors and the CUDA kernel for CUDA tensors, which
launches or raises. The kernel has no backward yet: on CUDA tensors that
require grad, with grad mode on, it raises."""
from __future__ import annotations

import torch.nn.functional as F

from repro_torch.kernels._build import refuse_grad

from . import kernel, ref
from .kernel import CHUNK


def ssd_scan(x, dt, A_log, B, C, D, chunk: int = CHUNK):
    """x: (Bb, S, nh, hd); dt: (Bb, S, nh); B, C: (Bb, S, ds); A_log, D:
    (nh,). Returns (y (Bb, S, nh, hd), h_final (Bb, nh, hd, ds) fp32)."""
    S = x.shape[1]
    pad = (-S) % min(chunk, max(S, 1))
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt, B, C = (F.pad(a, (0, 0, 0, pad)) for a in (dt, B, C))
    if x.device.type == "cpu":
        y, hT = ref.ssd_scan_ref(x, dt, A_log, B, C, D)
    else:
        refuse_grad("ssd_scan", x=x, dt=dt, A_log=A_log, B=B, C=C, D=D)
        y, hT = kernel.ssd_scan(x.contiguous(), dt.float().contiguous(),
                                A_log.float().contiguous(), B, C,
                                D.float().contiguous(), chunk=chunk)
    return y[:, :S], hT
