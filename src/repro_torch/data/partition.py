"""Non-IID client partitioning: Dirichlet label skew (Hsu et al. 2019),
exactly the paper's protocol: per-class proportions ~ Dir(alpha) across
clients; 70/15/15 train/val/test split per client."""
from __future__ import annotations

import numpy as np


def dirichlet_partition(labels: np.ndarray, n_clients: int, alpha: float,
                        seed: int = 0, min_size: int = 12):
    """Returns list of index arrays, one per client."""
    rng = np.random.default_rng(seed)
    n_classes = int(labels.max()) + 1
    while True:
        idx_by_client = [[] for _ in range(n_clients)]
        for c in range(n_classes):
            idx_c = np.where(labels == c)[0]
            rng.shuffle(idx_c)
            props = rng.dirichlet([alpha] * n_clients)
            cuts = (np.cumsum(props) * len(idx_c)).astype(int)[:-1]
            for client, part in enumerate(np.split(idx_c, cuts)):
                idx_by_client[client].extend(part.tolist())
        sizes = [len(ix) for ix in idx_by_client]
        if min(sizes) >= min_size:
            break
        seed += 1
        rng = np.random.default_rng(seed)
    return [np.array(sorted(ix), dtype=np.int64) for ix in idx_by_client]


def split_train_val_test(idx: np.ndarray, seed: int = 0,
                         fracs=(0.7, 0.15, 0.15)):
    rng = np.random.default_rng(seed)
    idx = idx.copy()
    rng.shuffle(idx)
    n = len(idx)
    n_tr = int(fracs[0] * n)
    n_va = int(fracs[1] * n)
    return idx[:n_tr], idx[n_tr:n_tr + n_va], idx[n_tr + n_va:]


def partition_stats(labels: np.ndarray, parts) -> dict:
    """Client x class count matrix (paper Fig. 4)."""
    n_classes = int(labels.max()) + 1
    mat = np.zeros((len(parts), n_classes), np.int64)
    for i, ix in enumerate(parts):
        for c, n in zip(*np.unique(labels[ix], return_counts=True)):
            mat[i, c] = n
    return {"counts": mat, "sizes": mat.sum(1)}
