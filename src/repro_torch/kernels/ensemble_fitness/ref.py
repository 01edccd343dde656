"""Plain PyTorch version of the ensemble_fitness kernel (port of
`repro/kernels/ensemble_fitness/ref.py`). The CPU path of `ops.py` and
the yardstick the CUDA kernel is held against on the card. Both entry
points are `core.objectives.population_objectives`, the port's one plain
version of the objectives."""
from __future__ import annotations

from repro_torch.core.objectives import population_objectives


def ensemble_fitness_ref(pop, acc, S):
    """pop: (P, M) 0/1 float32; acc: (M,); S: (M, M).
    Returns (strength (P,), diversity (P,))."""
    return population_objectives(pop, acc, S)


def ensemble_fitness_batched_ref(pop, acc, S):
    """pop (N, P, M); acc (N, M); S (N, M, M) ->
    (strength (N, P), diversity (N, P))."""
    return population_objectives(pop, acc, S)
