"""Shared helpers of the port's table scripts (port of
`benchmarks/common.py::make_clients`)."""
from __future__ import annotations

from repro_torch.data import (dirichlet_partition, make_synthetic_images,
                              split_train_val_test)
from repro_torch.fl.client import ClientData

# the table scripts' outputs, apart from the reference's `results/`
RESULTS = "results/torch"


def make_clients(n_clients, alpha, n_samples, n_classes, size=10, seed=0):
    ds = make_synthetic_images(n_samples, n_classes, size=size, seed=seed)
    parts = dirichlet_partition(ds.y, n_clients, alpha, seed=seed)
    datasets = []
    for ix in parts:
        tr, va, te = split_train_val_test(ix, seed=seed + 1)
        datasets.append(ClientData(ds.x[tr], ds.y[tr], ds.x[va], ds.y[va],
                                   ds.x[te], ds.y[te]))
    return datasets, ds
