"""Clustered gossip (port of `repro/fl/clustering.py`, the paper's §VI
proposal): clients use HISTORICAL SELECTION FREQUENCIES to prune who
they exchange models with, forming soft sub-networks, while periodically
re-evaluating outsiders so new collaborators can still establish
themselves.

Protocol:
  round 0: full exchange + ensemble selection everywhere (as FedPAE).
  later rounds: client c gossips only with peers whose models were
  selected at least once (plus `explore` random outsiders per round).
Communication accounting returns the saved exchange volume.

Host bookkeeping in numpy, draw for draw the reference's: the outsiders
come from `default_rng(seed + state.rounds)` in the same shuffle order.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class ClusterState:
    n_clients: int
    select_counts: np.ndarray  # (N, N) how often c selected a model of peer p
    rounds: int = 0

    @classmethod
    def init(cls, n_clients: int):
        return cls(n_clients, np.zeros((n_clients, n_clients), np.int64))

    def update(self, client: int, owners_selected):
        for o in owners_selected:
            self.select_counts[client, o] += 1
        self.rounds += 1

    def preferred_peers(self, client: int):
        c = self.select_counts[client].copy()
        c[client] = 0
        return np.where(c > 0)[0]


def pruned_topology(state: ClusterState, explore: int = 1, seed: int = 0):
    """Per-client peer list: historically-selected peers + `explore`
    random outsiders (paper §VI: periodic outsider re-evaluation)."""
    rng = np.random.default_rng(seed + state.rounds)
    n = state.n_clients
    topo = []
    for c in range(n):
        keep = set(state.preferred_peers(c).tolist())
        outsiders = [p for p in range(n) if p != c and p not in keep]
        rng.shuffle(outsiders)
        keep.update(outsiders[:explore])
        topo.append(sorted(keep))
    return topo


def communication_volume(topo, models_per_client: int, bytes_per_model: float):
    """Total exchange bytes for one gossip round on `topo`."""
    edges = sum(len(nb) for nb in topo)
    return edges * models_per_client * bytes_per_model


def clustering_savings(state: ClusterState, models_per_client: int = 5,
                       bytes_per_model: float = 1.0, explore: int = 1):
    """Fraction of full-graph exchange volume saved by the pruned graph."""
    n = state.n_clients
    full = communication_volume([[p for p in range(n) if p != c]
                                 for c in range(n)],
                                models_per_client, bytes_per_model)
    pruned = communication_volume(pruned_topology(state, explore),
                                  models_per_client, bytes_per_model)
    return 1.0 - pruned / full
