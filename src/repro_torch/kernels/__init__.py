"""Hand-written Hopper kernels. Each kernel package holds `ref.py` (the
plain PyTorch version), `kernel.py` (the CUDA build, binding and launch
wrapper) and `ops.py` (plain version for CPU tensors, kernel for CUDA
tensors). CUDA sources live in `repro_torch/csrc/`."""
