"""Mamba2 SSD chunked scan: `ref.py` (plain PyTorch: the naive
recurrence and its reverse, the backward), `kernel.py` (CUDA C++ for
sm_90a, `csrc/ssd_scan.cu` and its backward `csrc/ssd_scan_bwd.cu`),
`ops.py` (pads S to a chunk multiple; plain version for CPU tensors,
kernels for CUDA tensors, through an autograd Function)."""
