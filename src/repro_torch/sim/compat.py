"""Bridge from the spec layer to the `core.fedpae` helpers (port of
`repro/sim/compat.py`): `fedpae_config` reconstructs the FedPAEConfig
that `train_all_clients` and `build_stores` expect from a spec."""
from __future__ import annotations

from repro_torch.sim.spec import ExperimentSpec


def fedpae_config(spec: ExperimentSpec):
    from repro_torch.core.fedpae import FedPAEConfig
    sel, tr = spec.selection, spec.train
    return FedPAEConfig(
        families=tuple(tr.families),
        ensemble_k=sel.ensemble_k if sel.ensemble_k is not None else sel.k,
        nsga=sel.nsga(spec.seed),
        topology=spec.network.topology,
        lr=tr.lr, batch=tr.batch, max_epochs=tr.max_epochs,
        patience=tr.patience, width=tr.width,
        store_capacity=sel.store_capacity,
        seed=spec.seed)
