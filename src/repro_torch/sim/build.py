"""Spec -> concrete objects (port of the world builders of
`repro/sim/build.py`). This slice builds the synthetic-image world; the
registry components of the asynchronous path are ROADMAP.md queue 1."""
from __future__ import annotations

from repro_torch.data import (dirichlet_partition, make_synthetic_images,
                              split_train_val_test)
from repro_torch.fl.client import ClientData
from repro_torch.sim.spec import DataSpec


def build_client_datasets(data: DataSpec, default_seed: int):
    """kind="synthetic_images": non-IID image clients, the paper's
    protocol (class-conditional synthetic images, Dirichlet(alpha) label
    skew, 70/15/15 per-client splits). Equal, array for array, to the
    reference's datasets for the same spec."""
    seed = data.seed if data.seed is not None else default_seed
    split_seed = data.split_seed if data.split_seed is not None \
        else seed + 1
    ds = make_synthetic_images(data.n_samples, data.n_classes,
                               size=data.image_size,
                               channels=data.channels, seed=seed)
    parts = dirichlet_partition(ds.y, data.n_clients, data.alpha,
                                seed=seed)
    datasets = []
    for ix in parts:
        tr, va, te = split_train_val_test(ix, seed=split_seed)
        datasets.append(ClientData(ds.x[tr], ds.y[tr], ds.x[va], ds.y[va],
                                   ds.x[te], ds.y[te]))
    return datasets
