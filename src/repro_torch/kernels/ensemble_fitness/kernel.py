"""CUDA build, binding and launch wrappers of `csrc/ensemble_fitness.cu`.

The source is compiled with nvcc for sm_90a into a shared library with a
plain C interface the first time a wrapper launches it, into
`build/repro_torch/<hash of the source>/` at the root of the checkout,
and loaded with ctypes (`kernels/_build.py`). Nothing is built or loaded
at import.

Two entry points, one kernel (replacing `ensemble_fitness` and
`ensemble_fitness_batched` of `repro/kernels/ensemble_fitness/kernel.py`):

  ensemble_fitness          — one client: pop (P, M), acc (M,), S (M, M).
  ensemble_fitness_batched  — N clients in ONE launch: pop (N, P, M),
                              acc (N, M), S (N, M, M).

Both count their launches in `KERNEL.launches`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import CudaLibrary, check_cuda, check_fp32

KERNEL = CudaLibrary("ensemble_fitness.cu", "ensemble_fitness", {
    "ensemble_fitness_launch": ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
                                + [ctypes.c_void_p], ctypes.c_int)})


def _check_shape(name, t, shape):
    if tuple(t.shape) != shape:
        raise ValueError(f"ensemble_fitness: {name} has shape "
                         f"{tuple(t.shape)}, expected {shape}")


def ensemble_fitness_batched(pop, acc, S):
    """pop (N, P, M) f32; acc (N, M); S (N, M, M), all contiguous on one
    CUDA device -> (strength (N, P), diversity (N, P))."""
    if pop.dim() != 3:
        raise ValueError(f"ensemble_fitness_batched: pop must be (N, P, M), "
                         f"got shape {tuple(pop.shape)}")
    N, P, M = pop.shape
    _check_shape("acc", acc, (N, M))
    _check_shape("S", S, (N, M, M))
    check_fp32("ensemble_fitness", pop=pop, acc=acc, S=S)
    check_cuda("ensemble_fitness", pop=pop, acc=acc, S=S)
    strength = torch.empty((N, P), dtype=torch.float32, device=pop.device)
    diversity = torch.empty((N, P), dtype=torch.float32, device=pop.device)
    if N == 0 or P == 0:
        return strength, diversity
    diag = torch.diagonal(S, dim1=1, dim2=2).contiguous()
    KERNEL.launch("ensemble_fitness_launch", pop.device, pop.data_ptr(),
                  acc.data_ptr(), S.data_ptr(), diag.data_ptr(),
                  strength.data_ptr(), diversity.data_ptr(), N, P, M,
                  at=f"(N, P, M) = {(N, P, M)}")
    return strength, diversity


def ensemble_fitness(pop, acc, S):
    """pop (P, M) f32; acc (M,); S (M, M) -> (strength (P,),
    diversity (P,)): the batched launch at N = 1."""
    if pop.dim() != 2:
        raise ValueError(f"ensemble_fitness: pop must be (P, M), got shape "
                         f"{tuple(pop.shape)}")
    st, dv = ensemble_fitness_batched(pop.unsqueeze(0), acc.unsqueeze(0),
                                      S.unsqueeze(0))
    return st[0], dv[0]
