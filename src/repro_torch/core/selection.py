"""Peer-adaptive ensemble selection (FedPAE §III-A), port of
`repro/core/selection.py`: NSGA-II over (strength, diversity), then the
Pareto-front member with the best OVERALL validation accuracy
(mean-prob vote) wins.

`select_ensemble` scores ONE client; `select_ensembles` a whole client
batch, the genetic loop running in lockstep with a distinct random
stream per client. Every evaluation scores the population of EVERY
client with one call of the ensemble_fitness objectives (one kernel
launch into one (N, P, 2) buffer on CUDA tensors, the plain version on
CPU tensors).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ensemble_fitness import ops as ef_ops

from .nsga2 import NSGAConfig, client_keys, run_nsga2, run_nsga2_batched
from .objectives import ensemble_accuracy, member_accuracy, similarity_matrix


def _pick_winner(pop, objs, ranks, probs_val, labels_val, acc):
    """Shared post-GA step: best overall-accuracy member of the front.
    Works on one client or a leading client axis."""
    pareto = ranks == 0
    overall = ensemble_accuracy(pop, probs_val, labels_val)
    score = torch.where(pareto, overall, -1.0)
    best = score.argmax(-1, keepdim=True)
    return {
        "chromosome": pop.gather(
            -2, best.unsqueeze(-1).expand(*best.shape, pop.shape[-1])
        ).squeeze(-2),
        "val_accuracy": overall.gather(-1, best).squeeze(-1),
        "member_acc": acc,
        "pareto_mask": pareto,
        "pop": pop,
        "objs": objs,
    }


def _eval_fn(acc, S):
    """pop (..., P, M) -> objectives (..., P, 2), straight from the
    kernel's buffer; acc and S are checked once for the whole run."""
    return ef_ops.objectives_fn(acc, S)


def select_ensemble(probs_val, labels_val, nsga: NSGAConfig, key=None,
                    model_mask=None):
    """probs_val: (M, V, C) bench predictions on the local validation set;
    `key` this client's generator seed; `model_mask` optional (M,) 0/1
    valid-slot mask. Returns the winner dict (chromosome, val_accuracy,
    member_acc, pareto_mask, pop, objs)."""
    M = probs_val.shape[0]
    acc = member_accuracy(probs_val, labels_val)
    S = similarity_matrix(probs_val, labels_val).contiguous()
    out = run_nsga2(_eval_fn(acc, S), M, nsga, key=key,
                    valid_mask=model_mask, device=probs_val.device)
    return _pick_winner(out["pop"], out["objs"], out["ranks"], probs_val,
                        labels_val, acc)


def selection_stats(probs_val, labels_val):
    """The stats stage: (N, M, V, C) + (N, V) -> (acc (N, M),
    S (N, M, M)). The device-resident store batch (core/device_store.py)
    maintains these incrementally instead of recomputing them."""
    return (member_accuracy(probs_val, labels_val),
            similarity_matrix(probs_val, labels_val))


def _ga_stage(acc, S, probs_val, labels_val, nsga: NSGAConfig, keys,
              model_mask):
    """NSGA-II over cached (acc, S); `probs_val`/`labels_val` are only
    touched by the winner-picking overall-accuracy vote."""
    N, M = acc.shape
    if keys is None:
        keys = client_keys(nsga.seed, range(N))
    out = run_nsga2_batched(_eval_fn(acc.contiguous(), S.contiguous()),
                            M, nsga, keys, valid_mask=model_mask,
                            device=acc.device)
    return _pick_winner(out["pop"], out["objs"], out["ranks"], probs_val,
                        labels_val, acc)


def select_ensembles(probs_val, labels_val, nsga: NSGAConfig, keys=None,
                     model_mask=None):
    """Batched multi-client selection: probs_val (N, M, V, C), labels_val
    (N, V) with -1 padding, keys N generator seeds (default
    client_keys(nsga.seed, range(N))), model_mask (N, M) 0/1. Returns the
    `select_ensemble` dict with a leading client axis on every value."""
    acc, S = selection_stats(probs_val, labels_val)
    return _ga_stage(acc, S, probs_val, labels_val, nsga, keys, model_mask)


def select_ensembles_from_stats(acc, S, probs_val, labels_val,
                                nsga: NSGAConfig, keys=None, model_mask=None):
    """GA stage only, on CACHED per-client statistics (the
    device-resident incremental path)."""
    return _ga_stage(acc, S, probs_val, labels_val, nsga, keys, model_mask)


def local_only_chromosome(is_local, k: int):
    """The all-local fallback ensemble (negative-transfer safety valve):
    up to k LOCAL members and nothing else."""
    idx = torch.argsort((~is_local).to(torch.int8), stable=True)
    chrom = torch.zeros(is_local.shape, dtype=torch.float32,
                        device=is_local.device)
    chrom[idx[:k]] = 1.0
    return chrom * is_local.to(torch.float32)
