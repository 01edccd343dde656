"""FedPAE ensemble objectives: strength and diversity (port of
`repro/core/objectives.py`).

From the bench's prediction tensor `probs` (M models x V validation
samples x C classes) we precompute
  acc  in R^M      — per-model validation accuracy            (strength)
  S    in R^{MxM}  — pairwise prediction-similarity Gram matrix (diversity)
after which scoring a whole NSGA-II population C in {0,1}^{PxM} is two
matrix products (kernels/ensemble_fitness holds the CUDA version):
  strength(c)  = (C @ acc) / k
  diversity(c) = 1 - (c^T S c - sum_i c_i S_ii) / (k (k-1))

Every function also takes leading batch dimensions (the reference vmaps
them over clients); `torch.argmax` resolves ties to the first index, as
`jnp.argmax` does, which the empty-slot accuracy seed relies on.
"""
from __future__ import annotations

import torch


def member_accuracy(probs, labels):
    """probs: (..., M, V, C); labels: (..., V) with -1 = padding ->
    (..., M) accuracy."""
    valid = labels >= 0
    nv = valid.sum(-1).clamp(min=1).to(torch.float32)
    pred = probs.argmax(-1)
    hit = (pred == labels.unsqueeze(-2)) & valid.unsqueeze(-2)
    return hit.to(torch.float32).sum(-1) / nv.unsqueeze(-1)


def similarity_matrix(probs, labels=None):
    """probs: (..., M, V, C) -> (..., M, M) mean pairwise normalized inner
    product over valid (non-padding) samples."""
    p = probs.to(torch.float32)
    p = p / (torch.linalg.vector_norm(p, dim=-1, keepdim=True) + 1e-12)
    if labels is not None:
        valid = (labels >= 0).to(torch.float32)
        p = p * valid.unsqueeze(-2).unsqueeze(-1)
        nv = valid.sum(-1).clamp(min=1.0)[..., None, None]
    else:
        nv = float(probs.shape[-2])
    pf = p.flatten(-2)                      # (..., M, V·C)
    return (pf @ pf.transpose(-1, -2)) / nv


def population_objectives(pop, acc, S):
    """pop: (..., P, M) 0/1 float; acc: (..., M); S: (..., M, M).
    Returns (strength (..., P), diversity (..., P))."""
    pop = pop.to(torch.float32)
    k = pop.sum(-1)
    strength = (pop @ acc.unsqueeze(-1)).squeeze(-1) / k.clamp(min=1.0)
    quad = ((pop @ S) * pop).sum(-1)
    diag = torch.diagonal(S, dim1=-2, dim2=-1)
    self_sim = (pop @ diag.unsqueeze(-1)).squeeze(-1)
    pairs = (k * (k - 1.0)).clamp(min=1.0)
    return strength, 1.0 - (quad - self_sim) / pairs


def ensemble_accuracy(pop, probs, labels):
    """Overall accuracy of each candidate ensemble (mean-prob vote).
    pop: (..., P, M); probs: (..., M, V, C); labels: (..., V) -1=pad ->
    (..., P)."""
    pop = pop.to(torch.float32)
    valid = labels >= 0
    nv = valid.sum(-1).clamp(min=1).to(torch.float32)
    p = probs.to(torch.float32)
    V, C = p.shape[-2], p.shape[-1]
    votes = (pop @ p.flatten(-2)).unflatten(-1, (V, C))   # (..., P, V, C)
    pred = votes.argmax(-1)
    hit = (pred == labels.unsqueeze(-2)) & valid.unsqueeze(-2)
    return hit.to(torch.float32).sum(-1) / nv.unsqueeze(-1)
