"""Bridges between the `FedPAEConfig` drivers and the spec layer (port of
`repro/sim/compat.py`).

The shims `repro_torch.core.fedpae.run_fedpae` / `run_fedpae_async`
lift their loose kwargs into an `ExperimentSpec` with `spec_from_fedpae`
and hand the caller-constructed collaborators to `Experiment` as
injected overrides. The reverse bridge `fedpae_config` reconstructs the
FedPAEConfig that `train_all_clients` and `build_stores` expect, so the
shim and spec paths run the same code.
"""
from __future__ import annotations

from repro_torch.sim.spec import (DataSpec, ExperimentSpec, NetworkSpec,
                                  ScheduleSpec, SelectionSpec, TrainSpec)


def spec_from_fedpae(cfg, *, n_clients: int, n_classes: int,
                     mode: str = "sync", acfg=None) -> ExperimentSpec:
    """Lift a FedPAEConfig (+ optional AsyncConfig) into an
    ExperimentSpec. Data is kind="external": the shim injects the
    caller's datasets, so the spec describes everything EXCEPT the data
    generation."""
    sched = ScheduleSpec(mode=mode)
    if acfg is not None:
        sched = ScheduleSpec(
            mode=mode, speed_lognorm_sigma=acfg.speed_lognorm_sigma,
            link_latency=acfg.link_latency,
            select_debounce=acfg.select_debounce, seed=acfg.seed)
    nsga = cfg.nsga
    return ExperimentSpec(
        data=DataSpec(kind="external", n_clients=n_clients,
                      n_classes=n_classes),
        train=TrainSpec(families=tuple(cfg.families), lr=cfg.lr,
                        batch=cfg.batch, max_epochs=cfg.max_epochs,
                        patience=cfg.patience, width=cfg.width),
        selection=SelectionSpec(
            pop_size=nsga.pop_size, generations=nsga.generations,
            k=nsga.k, p_mut=nsga.p_mut, p_cross=nsga.p_cross,
            ensemble_k=cfg.ensemble_k,
            device_resident=cfg.device_resident,
            store_capacity=cfg.store_capacity),
        network=NetworkSpec(topology=cfg.topology),
        schedule=sched,
        seed=cfg.seed)


def fedpae_config(spec: ExperimentSpec):
    """The reverse bridge: reconstruct the FedPAEConfig the core helpers
    expect from a spec."""
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
        device_resident=sel.device_resident,
        seed=spec.seed)
