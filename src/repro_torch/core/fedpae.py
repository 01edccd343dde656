"""FedPAE drivers (port of `repro/core/fedpae.py`, paper Algorithm §III):

1. every client trains its local models (heterogeneous families),
2. the exchange builds each client's prediction store with one batched
   multi-model forward per (client, family),
3. one batched NSGA-II selection covers every client (core/engine.py),
4. the selected ensemble serves the client's test data.

`repro_torch.sim.Experiment` drives these. `run_fedpae` (synchronous)
and `run_fedpae_async` (the virtual-clock event loop, fl/scheduler.py)
are the reference's compatibility shims over the spec layer: they lift
their kwargs into an `ExperimentSpec` and inject the caller's
collaborators, so a shim run and a spec run of the same scenario give
the same trace.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, Optional

import numpy as np

from repro_torch.core.bench import (BenchEntry, PredictionStore,
                                    StreamingPredictionStore)
from repro_torch.core.engine import SelectionEngine
from repro_torch.core.nsga2 import NSGAConfig
from repro_torch.fl.client import (accuracy, predict_probs,
                                   predict_probs_batched, train_local_model)
from repro_torch.fl.scheduler import AsyncConfig, AsyncTrace
from repro_torch.fl.topology import make_topology
from repro_torch.models.cnn import CNNConfig, n_params

DEFAULT_FAMILIES = ("cnn4", "vgg", "resnet", "densenet", "inception")


@dataclasses.dataclass
class FedPAEConfig:
    families: tuple = DEFAULT_FAMILIES
    ensemble_k: int = 5
    nsga: NSGAConfig = dataclasses.field(
        default_factory=lambda: NSGAConfig(pop_size=100, generations=100,
                                           k=5))
    topology: str = "full"
    lr: float = 0.05
    batch: int = 32
    max_epochs: int = 40
    patience: int = 6
    width: int = 16
    store_capacity: Optional[int] = None  # bounded streaming stores (§6);
                                          # None = one slot per global model
    device_resident: bool = True   # incremental DeviceStoreBatch path (§7);
                                   # False = legacy host restack per select
    seed: int = 0


@dataclasses.dataclass
class FedPAEResult:
    test_acc: np.ndarray           # (N_clients,)
    local_frac: np.ndarray         # fraction of selected members that are local
    chromosomes: list
    member_val_acc: list
    benches: list                  # per-client PredictionStore
    models: dict


@dataclasses.dataclass
class AsyncFedPAEResult:
    trace: AsyncTrace              # selections[c] = [(t, val_acc)] curves
    test_acc: np.ndarray           # (N_clients,) final-ensemble test accuracy
    stores: list
    engine: SelectionEngine


def train_all_clients(datasets, cfg: FedPAEConfig, n_classes: int,
                      device=None):
    """Step 1: local training. Returns ({(client, family): (model,
    val_acc)}, ccfg)."""
    models = {}
    ccfg = CNNConfig(n_classes=n_classes, width=cfg.width,
                     in_channels=datasets[0].x_tr.shape[-1])
    for c, data in enumerate(datasets):
        for fi, fam in enumerate(cfg.families):
            seed = cfg.seed * 10007 + c * 101 + fi
            model, va, _ = train_local_model(
                fam, ccfg, seed, data, lr=cfg.lr, batch=cfg.batch,
                max_epochs=cfg.max_epochs, patience=cfg.patience,
                device=device)
            models[(c, fam)] = (model, va)
    return models, ccfg


def _make_entry(owner: int, fam: str, fam_idx: int, models, ccfg,
                n_families: int) -> BenchEntry:
    model, _ = models[(owner, fam)]
    # carrying (params, ccfg) lets the store serve same-family members
    # through one batched multi-model forward (bench.predictions)
    return BenchEntry(
        model_id=owner * n_families + fam_idx, owner=owner, family=fam,
        predict=(lambda x, f=fam, p=model: predict_probs(f, ccfg, p, x)),
        n_params=n_params(model), params=model, ccfg=ccfg)


def _empty_stores(datasets, cfg: FedPAEConfig, n_classes: int):
    """Slot-aligned stores: slot owner*F+fam_idx on every client, padded
    to one common validation width so all stacks share one shape. With
    `store_capacity` set (and smaller than the global model count) each
    client gets a bounded streaming store with contribution-aware
    eviction instead (DESIGN.md §6)."""
    F = len(cfg.families)
    full_capacity = len(datasets) * F
    v_max = max(len(d.y_va) for d in datasets)
    if cfg.store_capacity is not None and cfg.store_capacity < full_capacity:
        return [StreamingPredictionStore(c, cfg.store_capacity, d.x_va,
                                         d.y_va, n_classes, v_pad=v_max)
                for c, d in enumerate(datasets)]
    return [PredictionStore(c, full_capacity, d.x_va, d.y_va, n_classes,
                            v_pad=v_max)
            for c, d in enumerate(datasets)]


def build_stores(datasets, models, ccfg, cfg: FedPAEConfig):
    """Step 2: exchange over the topology (full graph = paper setup).
    Each reachable family is materialized with ONE batched multi-model
    forward per (family, client)."""
    n = len(datasets)
    neighbors = make_topology(cfg.topology, n, seed=cfg.seed)
    F = len(cfg.families)
    stores = _empty_stores(datasets, cfg, ccfg.n_classes)
    for c in range(n):
        reachable = sorted(set([c] + list(neighbors[c]))) \
            if cfg.topology != "full" else list(range(n))
        for fi, fam in enumerate(cfg.families):
            params_seq = [models[(o, fam)][0] for o in reachable]
            fam_preds = predict_probs_batched(fam, ccfg, params_seq,
                                              datasets[c].x_va)
            for o, pv in zip(reachable, fam_preds):
                stores[c].add(_make_entry(o, fam, fi, models, ccfg, F),
                              preds=pv)
    return stores


def build_benches(*args, **kwargs):
    """Deprecated pre-store name for `build_stores`."""
    warnings.warn(
        "repro_torch.core.fedpae.build_benches is deprecated; "
        "call build_stores instead", DeprecationWarning, stacklevel=2)
    return build_stores(*args, **kwargs)


def run_fedpae(datasets, n_classes: int, cfg: FedPAEConfig,
               models=None, ccfg=None, device=None) -> FedPAEResult:
    """Synchronous driver — compatibility shim over the spec layer:
    lifts `cfg` into a spec, injects the caller's datasets/models and
    runs `Experiment` on `device` (default "cuda")."""
    from repro_torch.sim import Experiment, spec_from_fedpae
    spec = spec_from_fedpae(cfg, n_clients=len(datasets),
                            n_classes=n_classes, mode="sync")
    r = Experiment(spec, datasets=datasets, models=models, ccfg=ccfg,
                   device=device).run()
    return FedPAEResult(
        test_acc=r.test_acc, local_frac=r.local_frac,
        chromosomes=r.chromosomes, member_val_acc=r.member_val_acc,
        benches=r.stores, models=r.models)


def run_fedpae_async(datasets, n_classes: int, cfg: FedPAEConfig,
                     acfg: Optional[AsyncConfig] = None,
                     models=None, ccfg=None,
                     train_cost: Optional[Callable] = None,
                     transport=None, gossip=None, churn=None,
                     repair=None, device=None) -> AsyncFedPAEResult:
    """The async driver — compatibility shim over the spec layer.

    Virtual-clock simulation where arrivals incrementally materialize the
    stores and debounced select events run batched re-selection through
    the shared engine (the ensemble_fitness kernel on the card). The
    optional `transport`/`gossip`/`churn`/`repair` p2p layers
    (repro_torch.p2p) are injected as built; everything else comes from
    the spec `spec_from_fedpae` lifts out of the kwargs, so the trace
    equals the pure-spec path's."""
    from repro_torch.sim import Experiment, spec_from_fedpae
    n, F = len(datasets), len(cfg.families)
    if acfg is not None and (acfg.n_clients != n
                             or acfg.models_per_client != F):
        raise ValueError(
            f"async config must match the client/model grid: acfg has "
            f"(n_clients={acfg.n_clients}, models_per_client="
            f"{acfg.models_per_client}) but the datasets/config imply "
            f"(n_clients={n}, models_per_client={F})")
    spec = spec_from_fedpae(cfg, n_clients=n, n_classes=n_classes,
                            mode="async", acfg=acfg)
    r = Experiment(spec, datasets=datasets, models=models, ccfg=ccfg,
                   transport=transport, gossip=gossip, churn=churn,
                   repair=repair, train_cost=train_cost,
                   device=device).run()
    return AsyncFedPAEResult(trace=r.trace, test_acc=r.test_acc,
                             stores=r.stores, engine=r.engine)


def run_local_ensemble(datasets, n_classes: int, cfg: FedPAEConfig,
                       models=None, ccfg=None, device=None):
    """The paper's 'local' baseline: each client ensembles only its own
    locally-trained models (mean-prob vote over all of them)."""
    if models is None:
        models, ccfg = train_all_clients(datasets, cfg, n_classes,
                                         device=device)
    accs = []
    for c, data in enumerate(datasets):
        probs = np.stack([predict_probs(f, ccfg, models[(c, f)][0],
                                        data.x_te)
                          for f in cfg.families])
        accs.append(accuracy(probs.mean(0), data.y_te))
    return np.array(accs), models, ccfg
