"""Public wrappers of ensemble_fitness: the plain PyTorch version for CPU
tensors, the CUDA kernel for CUDA tensors (which launches or raises).

`ensemble_fitness` dispatches on rank: a (P, M) population uses the
single-client entry point, an (N, P, M) population the batched one.
"""
from __future__ import annotations

from . import kernel, ref


def ensemble_fitness(pop, acc, S):
    if pop.dim() == 3:
        return ensemble_fitness_batched(pop, acc, S)
    if pop.device.type == "cpu":
        return ref.ensemble_fitness_ref(pop, acc, S)
    return kernel.ensemble_fitness(pop, acc, S)


def ensemble_fitness_batched(pop, acc, S):
    if pop.device.type == "cpu":
        return ref.ensemble_fitness_batched_ref(pop, acc, S)
    return kernel.ensemble_fitness_batched(pop, acc, S)
