"""Forward flash attention: `ref.py` (plain PyTorch), `kernel.py` (CUDA
C++ for sm_90a, `csrc/flash_attention.cu`), `ops.py` (model layout;
plain version for CPU tensors, kernel for CUDA tensors)."""
