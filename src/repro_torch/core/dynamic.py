"""Dynamic (per-sample) ensemble selection — the paper's §VII future-work
direction, implemented as a KNORA-style DES on top of the model bench
(port of `repro/core/dynamic.py`, plain torch on the caller's device):

for each test sample, find its K nearest validation samples (input space),
score every bench model by its accuracy on that neighbourhood, and vote
with the top-k locally-competent models. One (T, V) distance matrix and
one gather-mean of the neighbourhood's correct bits.

The reference ranks with `jax.lax.top_k`, which puts the lower index
first among equal values. `torch.topk` promises no order on ties, so both
rankings here are stable sorts: equal distances (or competences) keep
the lower index first, as in the reference. The squared distances are
the reference's fp32 expansion |x|^2 - 2 x.v + |v|^2; where two of them
differ only in the last bits the matrix products of torch and XLA may
order them differently.
"""
from __future__ import annotations

import torch


def knn_competence(x_test, x_val, correct, K: int = 15):
    """x_test: (T, ...), x_val: (V, ...), correct: (M, V) 0/1.
    Returns (T, M) per-sample model competence (neighbourhood accuracy)."""
    xt = x_test.reshape(x_test.shape[0], -1).to(torch.float32)
    xv = x_val.reshape(x_val.shape[0], -1).to(torch.float32)
    d2 = ((xt * xt).sum(1)[:, None] - 2 * xt @ xv.T
          + (xv * xv).sum(1)[None, :])                     # (T, V)
    idx = torch.sort(d2, dim=1, stable=True).indices[:, :K]  # (T, K)
    # competence[t, m] = mean_k correct[m, idx[t, k]], as the sum times
    # the fp32 reciprocal of K: the reference's mean rounds that way
    recip = torch.tensor(1.0 / K, dtype=torch.float32, device=idx.device)
    comp = correct.to(torch.float32)[:, idx].sum(-1) * recip  # (M, T)
    return comp.T


def dynamic_ensemble_predict(probs_test, competence, k: int = 5):
    """probs_test: (M, T, C); competence: (T, M). Per-sample top-k vote."""
    M = probs_test.shape[0]
    topm = torch.sort(competence, dim=1, descending=True,
                      stable=True).indices[:, :k]          # (T, k)
    onehot = torch.nn.functional.one_hot(topm, M).to(torch.float32).sum(1)
    votes = torch.einsum("tm,mtc->tc", onehot,
                         probs_test.to(torch.float32)) / k
    return votes.argmax(-1)


def des_accuracy(x_test, y_test, x_val, y_val, probs_val, probs_test,
                 K: int = 15, k: int = 5):
    """End-to-end dynamic selection accuracy for one client."""
    correct = (probs_val.argmax(-1) == y_val[None, :]).to(torch.float32)
    comp = knn_competence(x_test, x_val, correct, K)
    pred = dynamic_ensemble_predict(probs_test, comp, k)
    return (pred == y_test).to(torch.float32).mean()
