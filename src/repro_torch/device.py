"""Device resolution for the port's entry points.

Entry points run on the CUDA device unless the caller asks for the CPU.
A CUDA request on a machine without CUDA raises: the port never falls
back to the CPU behind the caller's back.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """None means "cuda". Returns a `torch.device`; raises RuntimeError
    when a CUDA device is asked for and none is available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}: the port runs "
                         "on 'cuda' or 'cpu'")
    return dev
