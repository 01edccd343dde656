"""Peer-to-peer network topologies for the decentralized exchange."""
from __future__ import annotations

import numpy as np


def full(n: int):
    return [[j for j in range(n) if j != i] for i in range(n)]


def ring(n: int, k: int = 1):
    return [sorted({(i + d) % n for d in range(-k, k + 1)} - {i}) for i in range(n)]


def random_regular(n: int, k: int, seed: int = 0):
    """k-regular-ish random graph (symmetric, connected via ring backbone)."""
    if k >= n:
        raise ValueError(
            f"random_regular needs k < n: a node cannot have {k} distinct "
            f"neighbors among {n - 1} other nodes")
    rng = np.random.default_rng(seed)
    adj = {i: set() for i in range(n)}
    for i in range(n):  # ring backbone guarantees connectivity
        adj[i].add((i + 1) % n)
        adj[(i + 1) % n].add(i)
    while min(len(v) for v in adj.values()) < k:
        i = min(adj, key=lambda x: len(adj[x]))
        j = int(rng.integers(0, n))
        if j != i:
            adj[i].add(j)
            adj[j].add(i)
    return [sorted(adj[i]) for i in range(n)]


def small_world(n: int, k: int = 4, beta: float = 0.1, seed: int = 0):
    """Watts–Strogatz small-world graph: a ring lattice with k//2
    neighbors per side whose long-range edges are rewired with
    probability `beta`. Nearest-neighbor ring edges are kept unrewired so
    the graph stays connected (the property every gossip test relies on);
    rewiring only the d >= 2 lattice edges still produces the
    short-average-path / high-clustering regime."""
    if k >= n:
        raise ValueError(
            f"small_world needs k < n: a node cannot have {k} distinct "
            f"neighbors among {n - 1} other nodes")
    half = max(1, k // 2)
    rng = np.random.default_rng(seed)
    adj = {i: set() for i in range(n)}
    for i in range(n):
        for d in range(1, half + 1):
            adj[i].add((i + d) % n)
            adj[(i + d) % n].add(i)
    for i in range(n):
        for d in range(2, half + 1):  # keep d == 1 as the connected core
            j = (i + d) % n
            if j in adj[i] and rng.random() < beta:
                choices = [x for x in range(n)
                           if x != i and x not in adj[i]]
                if not choices:
                    continue
                j2 = int(rng.choice(choices))
                adj[i].discard(j)
                adj[j].discard(i)
                adj[i].add(j2)
                adj[j2].add(i)
    return [sorted(adj[i]) for i in range(n)]


TOPOLOGIES = ("full", "ring", "random", "small_world")


def make_topology(name: str, n: int, k: int = 3, seed: int = 0,
                  beta: float = 0.1):
    if name == "full":
        return full(n)
    if name == "ring":
        return ring(n, k=1)
    if name == "random":
        return random_regular(n, k, seed)
    if name == "small_world":
        return small_world(n, k=k, beta=beta, seed=seed)
    raise ValueError(f"unknown topology {name!r}; choose from {TOPOLOGIES}")
