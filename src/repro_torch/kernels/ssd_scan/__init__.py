"""Mamba2 SSD chunked scan: `ref.py` (plain PyTorch, the naive
recurrence), `kernel.py` (CUDA C++ for sm_90a, `csrc/ssd_scan.cu`),
`ops.py` (pads S to a chunk multiple; plain version for CPU tensors,
kernel for CUDA tensors)."""
