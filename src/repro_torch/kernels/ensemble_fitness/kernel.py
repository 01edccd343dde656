"""CUDA build, binding and launch wrappers of `csrc/ensemble_fitness.cu`.

The source is compiled with nvcc for sm_90a into a shared library with a
plain C interface the first time a wrapper launches it, into
`build/repro_torch/<hash of the source>/` at the root of the checkout,
and loaded with ctypes (`kernels/_build.py`). Nothing is built or loaded
at import.

One kernel (replacing `ensemble_fitness` and `ensemble_fitness_batched`
of `repro/kernels/ensemble_fitness/kernel.py`) writes both objectives of
every row into one (N, P, 2) buffer:

  Objectives(acc, S)        — acc (N, M) and S (N, M, M) checked once;
                              each call on pop (N, P, M) is one launch
                              and returns the (N, P, 2) objectives.
  ensemble_fitness_batched  — pop (N, P, M), acc (N, M), S (N, M, M) ->
                              the (strength, diversity) views.
  ensemble_fitness          — one client: pop (P, M), acc (M,), S (M, M).

Every launch adds one to `KERNEL.launches`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import CudaLibrary, check_cuda, check_fp32

KERNEL = CudaLibrary("ensemble_fitness.cu", "ensemble_fitness", {
    "ensemble_fitness_launch": ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                                + [ctypes.c_void_p], ctypes.c_int)})
MAX_M = 29056        # M (index, value) pairs of one warp in shared memory


def _check_shape(name, t, shape):
    if tuple(t.shape) != shape:
        raise ValueError(f"ensemble_fitness: {name} has shape "
                         f"{tuple(t.shape)}, expected {shape}")


class Objectives:
    """The fitness of populations against one batch of statistics: acc
    (N, M) and S (N, M, M), fp32, contiguous on one CUDA device, checked
    here once. Calling it on pop (N, P, M) (fp32, contiguous, on the same
    device) launches the kernel once and returns the objectives (N, P, 2),
    strength and diversity."""

    def __init__(self, acc, S):
        if acc.dim() != 2:
            raise ValueError(f"ensemble_fitness: acc must be (N, M), got "
                             f"shape {tuple(acc.shape)}")
        self.N, self.M = acc.shape
        _check_shape("S", S, (self.N, self.M, self.M))
        check_fp32("ensemble_fitness", acc=acc, S=S)
        check_cuda("ensemble_fitness", acc=acc, S=S)
        if self.M > MAX_M:
            raise ValueError(f"ensemble_fitness: supports M <= {MAX_M}, "
                             f"got {self.M}")
        self.acc, self.S = acc, S

    def __call__(self, pop):
        if pop.dim() != 3 or pop.shape[0] != self.N \
                or pop.shape[2] != self.M:
            raise ValueError(f"ensemble_fitness: pop has shape "
                             f"{tuple(pop.shape)}, expected ({self.N}, P, "
                             f"{self.M})")
        check_fp32("ensemble_fitness", pop=pop)
        check_cuda("ensemble_fitness", pop=pop, acc=self.acc)
        N, P, M = pop.shape
        out = torch.empty((N, P, 2), dtype=torch.float32, device=pop.device)
        if N * P:
            KERNEL.launch("ensemble_fitness_launch", pop.device,
                          pop.data_ptr(), self.acc.data_ptr(),
                          self.S.data_ptr(), out.data_ptr(), N, P, M,
                          at=f"(N, P, M) = {(N, P, M)}")
        return out


def ensemble_fitness_batched(pop, acc, S):
    """pop (N, P, M) f32; acc (N, M); S (N, M, M), all contiguous on one
    CUDA device -> (strength (N, P), diversity (N, P)), the two views of
    one (N, P, 2) buffer."""
    if pop.dim() != 3:
        raise ValueError(f"ensemble_fitness_batched: pop must be (N, P, M), "
                         f"got shape {tuple(pop.shape)}")
    _check_shape("acc", acc, (pop.shape[0], pop.shape[2]))
    out = Objectives(acc, S)(pop)
    return out[..., 0], out[..., 1]


def ensemble_fitness(pop, acc, S):
    """pop (P, M) f32; acc (M,); S (M, M) -> (strength (P,),
    diversity (P,)): the batched launch at N = 1."""
    if pop.dim() != 2:
        raise ValueError(f"ensemble_fitness: pop must be (P, M), got shape "
                         f"{tuple(pop.shape)}")
    st, dv = ensemble_fitness_batched(pop.unsqueeze(0), acc.unsqueeze(0),
                                      S.unsqueeze(0))
    return st[0], dv[0]
