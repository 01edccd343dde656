"""`Experiment`: the entry point of a FedPAE run (port of
`repro/sim/experiment.py`, synchronous branch).

`Experiment.from_spec(spec).run()` builds the world, trains the local
models, fills the slot-aligned prediction stores, runs ONE batched
selection over every client and serves each client's test set with its
selected ensemble. It runs on the CUDA device unless `device="cpu"` is
passed. Everything outside the synchronous image path (async mode, the
prediction world, network components, faults, serving, observability,
bounded stores, the restack selection path) raises NotImplementedError:
ROADMAP.md queue 1 lists those modules as still to port. Selection
always scores through the ensemble_fitness wrapper (the CUDA kernel on
the card), so `selection.use_kernel` is parsed and has no effect.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core.engine import SelectionEngine
from repro_torch.device import resolve_device
from repro_torch.fl.client import accuracy
from repro_torch.obs.metrics import Stopwatch, json_ready
from repro_torch.sim.build import build_client_datasets
from repro_torch.sim.compat import fedpae_config
from repro_torch.sim.spec import ExperimentSpec

_IMAGE_KINDS = ("synthetic_images", "external")


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP.md queue 1); "
        "this slice runs schedule.mode='sync' on an image world")


@dataclasses.dataclass
class RunResult:
    """Structured outcome of one synchronous run, plus handles to the
    live objects for post-hoc analysis. `perf` holds the wall seconds of
    each phase (train_s, exchange_s, select_s, serve_s)."""
    spec: ExperimentSpec
    mode: str
    test_acc: Optional[np.ndarray] = None     # (N,) final-ensemble test acc
    local_frac: Optional[np.ndarray] = None   # local-member fraction
    chromosomes: Optional[list] = None        # per-client ensembles
    member_val_acc: Optional[list] = None     # per-member val acc
    perf: Optional[dict] = None
    stores: Optional[list] = None
    engine: Optional[SelectionEngine] = None
    models: Optional[dict] = None

    def summary(self) -> dict:
        """Compact strict-JSON report (the `repro_torch.sim.run` output)."""
        d: dict = {"mode": self.mode, "seed": self.spec.seed,
                   "data_kind": self.spec.data.kind,
                   "n_clients": self.spec.data.n_clients}
        if self.test_acc is not None:
            d["test_acc_mean"] = round(float(np.mean(self.test_acc)), 4)
            d["test_acc"] = [round(float(a), 4) for a in self.test_acc]
        if self.local_frac is not None:
            d["local_frac_mean"] = round(float(np.mean(self.local_frac)), 4)
        if self.perf is not None:
            d["perf"] = self.perf
        return json_ready(d)


class Experiment:
    """Builds and runs the scenario an `ExperimentSpec` describes.
    `datasets`, `models` (with `ccfg`) may be injected instead of built."""

    def __init__(self, spec: ExperimentSpec, *, datasets=None,
                 models=None, ccfg=None, device=None):
        self.spec = spec
        self.device = resolve_device(device)
        self.datasets = datasets
        self.models = models
        self.ccfg = ccfg
        self.stores: Optional[list] = None
        self.engine: Optional[SelectionEngine] = None
        self.perf: dict = {}
        self._built = False
        self._ran = False
        if datasets is not None and len(datasets) != spec.data.n_clients:
            raise ValueError(
                f"injected datasets ({len(datasets)} clients) do not match "
                f"spec.data.n_clients={spec.data.n_clients}")

    @classmethod
    def from_spec(cls, spec: ExperimentSpec, device=None) -> "Experiment":
        return cls(spec, device=device)

    @property
    def n_classes(self) -> int:
        return self.spec.data.n_classes

    def _check_ported(self) -> None:
        spec = self.spec
        if spec.schedule.mode != "sync":
            raise _not_ported(f"schedule.mode={spec.schedule.mode!r}")
        if spec.data.kind not in _IMAGE_KINDS:
            raise _not_ported(f"data.kind={spec.data.kind!r}")
        declared = [s for s in ("transport", "gossip", "churn", "repair")
                    if getattr(spec.network, s) is not None]
        if declared:
            raise _not_ported(f"network component(s) {declared}")
        if spec.faults.enabled:
            raise _not_ported("the faults section")
        if spec.serve.enabled:
            raise _not_ported("the serve section")
        if spec.obs.enabled or spec.obs.sinks:
            raise _not_ported("observability (obs.enabled / obs.sinks)")
        if not spec.selection.device_resident:
            raise _not_ported("the restack selection path "
                              "(selection.device_resident=False)")
        if spec.schedule.backend.name != "event":
            raise ValueError(
                f'schedule.mode="sync" runs no simulation loop — '
                f"schedule.backend={spec.schedule.backend.name!r} only "
                'applies to schedule.mode="async"')

    def _ensure_world(self) -> None:
        data = self.spec.data
        if data.kind == "synthetic_images" and self.datasets is None:
            self.datasets = build_client_datasets(data, self.spec.seed)
        elif data.kind == "external" and self.datasets is None:
            raise ValueError('data.kind="external" requires datasets to be '
                             "injected (Experiment(spec, datasets=...))")

    def _ensure_models(self) -> None:
        from repro_torch.core.fedpae import train_all_clients
        if self.models is not None:
            return
        self._ensure_world()
        sw = Stopwatch().start()
        self.models, self.ccfg = train_all_clients(
            self.datasets, fedpae_config(self.spec), self.n_classes,
            device=self.device)
        self.perf["train_s"] = sw.stop()

    def build(self) -> "Experiment":
        """Materialize the world, trained models, filled stores and the
        engine. Idempotent."""
        from repro_torch.core.fedpae import build_stores
        if self._built:
            return self
        self._check_ported()
        spec, sel = self.spec, self.spec.selection
        self._ensure_world()
        self._ensure_models()
        sw = Stopwatch().start()
        self.stores = build_stores(self.datasets, self.models, self.ccfg,
                                   fedpae_config(spec))
        self.perf["exchange_s"] = sw.stop()
        if sel.enabled:
            self.engine = SelectionEngine(
                self.stores, sel.nsga(spec.seed),
                seed=sel.seed if sel.seed is not None else spec.seed,
                ensemble_k=(sel.ensemble_k if sel.ensemble_k is not None
                            else sel.k),
                device=self.device)
        self._built = True
        return self

    def run(self) -> RunResult:
        """Single-shot: the stores' dirty logs and selection state are
        consumed, so re-running needs a fresh Experiment."""
        if self._ran:
            raise RuntimeError(
                "this Experiment already ran — build a fresh one with "
                "Experiment.from_spec(spec) to re-run")
        self.build()
        self._ran = True
        return self._run_sync()

    def _run_sync(self) -> RunResult:
        """The paper's synchronous protocol: stores complete, ONE batched
        selection over every client, then masked lazy serving."""
        engine, stores = self.engine, self.stores
        if engine is None:
            raise ValueError('schedule.mode="sync" requires '
                             "selection.enabled=True")
        sw = Stopwatch().start()
        engine.select()
        self.perf["select_s"] = sw.stop()
        sw = Stopwatch().start()
        accs, local_fracs, chroms, member_accs = [], [], [], []
        for c, data in enumerate(self.datasets):
            vote, chrom = engine.serve(c, data.x_te)
            mask = chrom > 0.5
            accs.append(accuracy(vote, data.y_te))
            local_fracs.append(float((mask & stores[c].is_local()).sum()
                                     / max(1, mask.sum())))
            chroms.append(chrom)
            res = engine.results.get(c)  # absent when the store can't fill
            member_accs.append(np.asarray(res["member_acc"])
                               if res is not None
                               else np.full(stores[c].capacity, np.nan))
        self.perf["serve_s"] = sw.stop()
        return RunResult(
            spec=self.spec, mode="sync", test_acc=np.array(accs),
            local_frac=np.array(local_fracs), chromosomes=chroms,
            member_val_acc=member_accs, perf=dict(self.perf),
            stores=stores, engine=engine, models=self.models)

    def local_ensemble(self) -> np.ndarray:
        """The paper's 'local' baseline on this experiment's world and
        models: each client mean-prob votes over only its own models."""
        from repro_torch.core.fedpae import run_local_ensemble
        self._ensure_world()
        self._ensure_models()
        accs, self.models, self.ccfg = run_local_ensemble(
            self.datasets, self.n_classes, fedpae_config(self.spec),
            models=self.models, ccfg=self.ccfg, device=self.device)
        return accs
