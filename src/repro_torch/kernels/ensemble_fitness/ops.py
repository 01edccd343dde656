"""Public wrappers of ensemble_fitness: the plain PyTorch version for CPU
tensors, the CUDA kernel for CUDA tensors (which launches or raises).

`ensemble_fitness` dispatches on rank: a (P, M) population uses the
single-client entry point, an (N, P, M) population the batched one.
`objectives_fn` binds the statistics once for a whole genetic run.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._build import PLAIN_DEVICES

from . import kernel, ref


def ensemble_fitness(pop, acc, S):
    if pop.dim() == 3:
        return ensemble_fitness_batched(pop, acc, S)
    if pop.device.type in PLAIN_DEVICES:
        return ref.ensemble_fitness_ref(pop, acc, S)
    return kernel.ensemble_fitness(pop, acc, S)


def ensemble_fitness_batched(pop, acc, S):
    if pop.device.type in PLAIN_DEVICES:
        return ref.ensemble_fitness_batched_ref(pop, acc, S)
    return kernel.ensemble_fitness_batched(pop, acc, S)


def objectives_fn(acc, S):
    """pop (..., P, M) -> objectives (..., P, 2) (strength, diversity)
    against fixed statistics acc (..., M) and S (..., M, M), with at most
    one leading client axis. CUDA statistics are checked here once and
    every call is one kernel launch into one buffer; CPU statistics take
    the plain version."""
    if acc.device.type in PLAIN_DEVICES:
        def plain(pop):
            return torch.stack(ref.ensemble_fitness_batched_ref(pop, acc, S),
                               dim=-1)
        return plain
    if acc.dim() == 1:
        batched = kernel.Objectives(acc.unsqueeze(0), S.unsqueeze(0))
        return lambda pop: batched(pop.contiguous().unsqueeze(0))[0]
    batched = kernel.Objectives(acc, S)
    return lambda pop: batched(pop.contiguous())
