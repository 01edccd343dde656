"""`Experiment`: the entry point of a FedPAE run (port of
`repro/sim/experiment.py`).

`Experiment.from_spec(spec).run()` builds the world, stores, engine and
p2p stack an `ExperimentSpec` describes and dispatches on
`schedule.mode`:

  sync   — train the local models, fill the slot-aligned stores, run ONE
           batched selection over every client and serve each client's
           test set with its selected ensemble (image worlds);
  async  — the virtual-clock event loop (`fl/scheduler.py`, backend
           "event") or the tick-stepped array world (`sim/compiled.py`,
           backend "compiled": dissemination only, on the device, its
           admits filling a prediction world's stores after the run).
           On the event loop, arrivals incrementally materialize the
           stores (one forward per arrival in an image world, a shipped
           matrix in a prediction world), and every debounced select
           tick runs one batched re-selection of the ready clients over
           whatever p2p stack (transport, gossip, churn, repair) the
           spec declares;
           bounded streaming stores and observability (metrics, trace,
           sinks) included. Data kinds: synthetic_images, external,
           prediction_world, none. The faults section adds crash,
           restart, partition and corruption events, byzantine payloads
           and the validation gate on the arrival path; the serve
           section adds query and drift events answered from the
           selected ensembles, with monitor-triggered re-selection.

It runs on the CUDA device unless `device="cpu"` is passed. Selection
always scores through the ensemble_fitness wrapper (the CUDA kernel on
the card), so `selection.use_kernel` is parsed and has no effect.
`build()` raises the reference's errors for the reference's
misconfigurations, and the compiled backend's run the reference's
refusals (image worlds, in-loop selection, faults, admission, serving).

Keyword overrides inject pre-built collaborators (the compatibility
shims' path): anything injected is used as-is, anything absent is built
from the spec through the component registry.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.core.bench import BenchEntry
from repro_torch.core.engine import SelectionEngine
from repro_torch.device import resolve_device
from repro_torch.faults import AdmissionController
from repro_torch.fl.client import accuracy
from repro_torch.fl.scheduler import AsyncConfig, AsyncTrace, simulate_async
from repro_torch.obs.metrics import Stopwatch, json_ready
from repro_torch.obs.probes import attach_metrics, finalize_run, make_obs
from repro_torch.sim.build import (_seeded, build_client_datasets,
                                   build_faults, build_network,
                                   build_prediction_world, build_serving,
                                   build_world_stores)
from repro_torch.sim.compat import fedpae_config
from repro_torch.sim.registry import build as build_component
from repro_torch.sim.spec import ExperimentSpec

_IMAGE_KINDS = ("synthetic_images", "external")


@dataclasses.dataclass
class RunResult:
    """Structured outcome of one experiment, plus handles to the live
    objects for post-hoc analysis. Sync `perf` holds the wall seconds of
    each phase (train_s, exchange_s, select_s, serve_s); async `perf` is
    the event loop's (wall_s, n_events, events_per_s, phases net_s and
    select_s), with train_s when the run trained its models."""
    spec: ExperimentSpec
    mode: str
    test_acc: Optional[np.ndarray] = None     # (N,) final-ensemble test acc
    local_frac: Optional[np.ndarray] = None   # sync: local-member fraction
    chromosomes: Optional[list] = None        # sync: per-client ensembles
    member_val_acc: Optional[list] = None     # sync: per-member val acc
    selections: Optional[dict] = None         # async: c -> [(t, val_acc)]
    select_batches: Optional[list] = None     # async: (t, batch_size)
    curve: Optional[list] = None              # async: (bytes_sent, mean acc)
    coverage: Optional[float] = None          # async: dissemination fraction
    t_full: Optional[float] = None            # async: time to coverage 1.0
    net: Optional[dict] = None                # transport/gossip/repair stats
    perf: Optional[dict] = None
    trace: Optional[AsyncTrace] = None
    metrics: Optional[object] = None          # obs: collected MetricsFrame
    stores: Optional[list] = None
    engine: Optional[SelectionEngine] = None
    models: Optional[dict] = None
    transport: Optional[object] = None
    gossip: Optional[object] = None
    churn: Optional[object] = None
    repair: Optional[object] = None

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
        if self.selections is not None:
            d["n_selections"] = int(sum(len(v)
                                        for v in self.selections.values()))
        if self.coverage is not None:
            d["coverage"] = round(float(self.coverage), 4)
            d["t_full"] = (None if self.t_full is None
                           or math.isnan(self.t_full)
                           else round(float(self.t_full), 3))
        if self.trace is not None:
            d["n_events"] = len(self.trace.events)
        if self.net is not None:
            d["net"] = self.net
        if self.perf is not None:
            d["perf"] = self.perf
        if self.metrics is not None:
            d["obs"] = {"n_scalars": len(self.metrics.scalars),
                        "n_series": len(self.metrics.series)}
        return json_ready(d)


class Experiment:
    """Builds and runs the scenario an `ExperimentSpec` describes.
    `datasets`, `models` (with `ccfg`), the p2p layers and `train_cost`
    may be injected instead of built."""

    def __init__(self, spec: ExperimentSpec, *, datasets=None,
                 models=None, ccfg=None, transport=None, gossip=None,
                 churn=None, repair=None,
                 train_cost: Optional[Callable] = None, device=None):
        self.spec = spec
        self.device = resolve_device(device)
        self.datasets = datasets
        self.models = models
        self.ccfg = ccfg
        self.world = None            # prediction_world: (labels, mats)
        self.stores: Optional[list] = None
        self.engine: Optional[SelectionEngine] = None
        self.neighbors = None
        self.transport = transport
        self.gossip = gossip
        self.churn = churn
        self.repair = repair
        self.train_cost = train_cost
        self.faults = None           # faults.FaultController (or None)
        self.admission = None        # faults.AdmissionController
        self.serving = None          # serve.ServingEngine (or None)
        self.obs = None              # repro_torch.obs.probes.Obs once built
        self.perf: dict = {}
        self._runner = None          # the async backend's run(exp)
        self._sinks: list = []
        self._injected = {"transport": transport, "gossip": gossip,
                          "churn": churn, "repair": repair,
                          "train_cost": train_cost}
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

    @property
    def models_per_client(self) -> int:
        if self.spec.data.kind in _IMAGE_KINDS:
            return len(self.spec.train.families)
        return self.spec.data.models_per_client

    # ---- staged construction ------------------------------------------
    def _check_spec(self) -> None:
        """The reference's configuration errors (same words), then the
        async backend's build."""
        spec = self.spec
        data = spec.data
        sync = spec.schedule.mode == "sync"
        if spec.obs.sinks and not spec.obs.enabled:
            raise ValueError(
                "obs.sinks declared but obs.enabled is false — a sink "
                "with nothing to write is a misconfigured run, not a "
                "default one")
        if spec.obs.enabled and spec.obs.trace and (
                sync or spec.schedule.backend.name != "event"):
            raise ValueError(
                "obs.trace=true requires schedule.mode='async' with "
                "schedule.backend='event': the Perfetto trace records "
                "per-event slices, which the "
                f"{'sync driver' if sync else 'compiled array world'} "
                "does not produce")
        if sync and spec.faults.enabled:
            raise ValueError(
                'schedule.mode="sync" cannot honor the faults section: '
                "fault injection (and validation-gated admission) drives "
                "the asynchronous event loop — switch to "
                'schedule.mode="async" or drop spec.faults')
        if sync and spec.serve.enabled:
            raise ValueError(
                'schedule.mode="sync" cannot honor the serve section: '
                "query traffic interleaves with the asynchronous event "
                'loop — switch to schedule.mode="async" or drop '
                "spec.serve")
        if sync and data.kind not in _IMAGE_KINDS:
            raise ValueError(
                f'schedule.mode="sync" needs image datasets '
                f'(data.kind in {_IMAGE_KINDS}), got {data.kind!r}')
        if sync and spec.schedule.backend.name != "event":
            raise ValueError(
                f'schedule.mode="sync" runs no simulation loop — '
                f"schedule.backend={spec.schedule.backend.name!r} only "
                'applies to schedule.mode="async"')
        if sync:
            declared = [s for s in ("transport", "gossip", "churn",
                                    "repair")
                        if getattr(spec.network, s) is not None]
            injected = [s for s, v in self._injected.items()
                        if v is not None]
            if declared or injected:
                what = (f"spec component(s) {declared}" if declared
                        else "") + (" and " if declared and injected
                                    else "") + \
                       (f"injected collaborator(s) {injected}"
                        if injected else "")
                raise ValueError(
                    f'schedule.mode="sync" cannot honor {what}: the '
                    "synchronous protocol has no exchange simulation — "
                    'switch to schedule.mode="async" or drop them '
                    "(silently ignoring them would report a lossless "
                    "run as if the declared network had been simulated)")
        if not sync:
            self._runner = build_component(
                "backend", spec.schedule.backend,
                {"spec": spec, "seed": spec.seed,
                 "n_clients": data.n_clients})

    def _ensure_world(self) -> None:
        data = self.spec.data
        if data.kind == "synthetic_images" and self.datasets is None:
            self.datasets = build_client_datasets(data, self.spec.seed)
        elif data.kind == "external" and self.datasets is None:
            raise ValueError('data.kind="external" requires datasets to be '
                             "injected (Experiment(spec, datasets=...))")
        elif data.kind == "prediction_world" and self.world is None:
            self.world = build_prediction_world(data, self.spec.seed)

    def _ensure_models(self) -> None:
        """Local training (image worlds only)."""
        from repro_torch.core.fedpae import train_all_clients
        if self.spec.data.kind not in _IMAGE_KINDS or \
                self.models is not None:
            return
        self._ensure_world()
        sw = Stopwatch().start()
        self.models, self.ccfg = train_all_clients(
            self.datasets, fedpae_config(self.spec), self.n_classes,
            device=self.device)
        self.perf["train_s"] = sw.stop()

    def build(self) -> "Experiment":
        """Materialize everything the run needs: world, trained models,
        stores (filled for sync, empty for async), engine, and — async —
        the registry-built p2p stack. Idempotent."""
        from repro_torch.core.fedpae import _empty_stores, build_stores
        if self._built:
            return self
        spec = self.spec
        data, sel = spec.data, spec.selection
        self._ensure_world()
        self._check_spec()
        sync = spec.schedule.mode == "sync"
        self.obs = make_obs(spec.obs)
        if data.kind in _IMAGE_KINDS:
            self._ensure_models()
            cfg = fedpae_config(spec)
            if sync:
                sw = Stopwatch().start()
                self.stores = build_stores(self.datasets, self.models,
                                           self.ccfg, cfg)
                self.perf["exchange_s"] = sw.stop()
            else:
                self.stores = _empty_stores(self.datasets, cfg,
                                            self.n_classes)
        elif data.kind == "prediction_world":
            labels, _ = self.world
            self.stores = build_world_stores(data, labels,
                                             sel.store_capacity)
        if self.stores is not None and sel.enabled:
            self.engine = SelectionEngine(
                self.stores, sel.nsga(spec.seed),
                seed=sel.seed if sel.seed is not None else spec.seed,
                ensemble_k=(sel.ensemble_k if sel.ensemble_k is not None
                            else sel.k),
                device_resident=sel.device_resident,
                metrics=self.obs.metrics if self.obs is not None
                else None, device=self.device)
        if not sync:
            n_val = (max(len(d.y_va) for d in self.datasets)
                     if self.datasets else None)
            # injected collaborators participate in the build context,
            # so spec-built dependents (repair around gossip, gossip
            # around churn) wire against the instances that actually run
            net = build_network(spec, data.n_clients, n_val=n_val,
                                injected=self._injected)
            self.neighbors = net["neighbors"]
            for slot in ("transport", "gossip", "churn", "repair",
                         "train_cost"):
                setattr(self, slot, net[slot])
            self._build_faults_and_serving()
        if self.obs is not None:
            attach_metrics(self.obs.metrics, self.transport, self.gossip,
                           self.repair, self.serving)
        if spec.obs.sinks:
            ctx = {"obs": self.obs, "spec": spec,
                   "n_clients": data.n_clients}
            self._sinks = [build_component("sink", s, ctx)
                           for s in spec.obs.sinks]
        self._built = True
        return self

    def _build_faults_and_serving(self) -> None:
        """The async run's faults and serve sections, with the
        reference's errors for what a world cannot honor."""
        spec = self.spec
        data = spec.data
        if spec.faults.injectors:
            self.faults = build_faults(spec, data.n_clients)
        if self.faults is not None and self.faults.byzantine is not None \
                and self.stores is None:
            raise ValueError(
                "the byzantine injector poisons prediction matrices, "
                f"but data.kind={data.kind!r} builds no stores — "
                "silently injecting nothing would report a clean run "
                "as an attacked one")
        if spec.faults.admission is not None:
            if self.stores is None:
                raise ValueError(
                    "the admission gate screens against local "
                    "validation labels, but data.kind="
                    f"{data.kind!r} builds no stores")
            fseed = (spec.faults.seed if spec.faults.seed is not None
                     else spec.seed)
            adm_cfg = build_component(
                "admission", _seeded(spec.faults.admission, fseed),
                {"n_clients": data.n_clients, "seed": fseed, "spec": spec})
            self.admission = AdmissionController(adm_cfg, self.stores)
        if not spec.serve.enabled:
            return
        if self.stores is None:
            raise ValueError(
                "the serve section answers queries from "
                f"prediction stores, but data.kind={data.kind!r} "
                'builds none — use "prediction_world" or an '
                "image world")
        if self.engine is None:
            raise ValueError(
                "the serve section needs selection.enabled=True: "
                "queries are answered from selected ensembles "
                "and the monitor triggers re-selection")
        if spec.serve.monitor and not spec.schedule.select_during_run:
            raise ValueError(
                "serve.monitor=True triggers re-selection "
                "through the in-run select grid, but "
                "schedule.select_during_run=False disables it — "
                "enable in-run selection or set "
                "serve.monitor=False")
        if data.kind not in _IMAGE_KINDS and any(
                cs.name == "covariate_shift" for cs in spec.serve.drift):
            raise ValueError(
                "drift[covariate_shift] transforms real query "
                f"inputs, but data.kind={data.kind!r} has none "
                "— use label_shift or an image world")
        pools = ([(d.x_te, d.y_te) for d in self.datasets]
                 if data.kind in _IMAGE_KINDS else None)
        self.serving = build_serving(spec, data.n_clients, self.stores,
                                     self.engine, query_pools=pools)

    # ---- drivers -------------------------------------------------------
    def run(self) -> RunResult:
        """Single-shot: stores, gossip version vectors and transport
        counters are consumed by the drive, so re-running needs a fresh
        Experiment."""
        if self._ran:
            raise RuntimeError(
                "this Experiment already ran; its stores and p2p state "
                "are consumed — build a fresh one with "
                "Experiment.from_spec(spec) to re-run")
        self.build()
        self._ran = True
        res = (self._run_sync() if self.spec.schedule.mode == "sync"
               else self._runner(self))
        if self.obs is not None:
            finalize_run(self.obs, res)
        for sink in self._sinks:
            sink(res)
        return res

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

    def _base_entry(self) -> Optional[Callable]:
        """(c, model_key) -> (entry, preds or None): what an arrival
        materializes — the owner's model, whose forward on the client's
        validation set fills the slot (image worlds; preds None), or the
        world's shipped matrix (prediction world)."""
        data = self.spec.data
        mpc = self.models_per_client
        if data.kind in _IMAGE_KINDS:
            from repro_torch.core.fedpae import _make_entry
            families = self.spec.train.families
            models, ccfg, F = self.models, self.ccfg, len(families)

            def base_entry(c, model_key):
                owner, m = model_key
                return _make_entry(owner, families[m], m, models, ccfg,
                                   F), None
            return base_entry
        if data.kind == "prediction_world":
            _, mats = self.world
            C = data.n_classes

            def base_entry(c, model_key):
                owner, m = model_key
                gid = owner * mpc + m
                return BenchEntry(
                    model_id=gid, owner=owner, family=f"f{m}",
                    predict=lambda x: np.full((len(x), C), 1.0 / C,
                                              np.float32)), mats[(c, gid)]
            return base_entry
        return None

    def _on_add(self) -> Optional[Callable]:
        """The arrival hook that materializes a model into a client's
        store. With faults or a gate, the fault-aware path: byzantine
        payloads are poisoned (and so are their later test-time
        forwards), corrupt-admitted deliveries decode as garbage, and
        remote arrivals pass the validation gate first."""
        base_entry = self._base_entry()
        if base_entry is None:
            return None
        stores, faults, adm = self.stores, self.faults, self.admission
        if faults is None and adm is None:
            def on_add(c, model_key, t):
                entry, preds = base_entry(c, model_key)
                stores[c].add(entry, preds=preds, t=t)
            return on_add

        def on_add(c, model_key, t):
            entry, preds = base_entry(c, model_key)
            if preds is None:   # the forward runs where the model lives
                preds = entry.predict(stores[c].x_val)
            owner, gid = entry.owner, entry.model_id
            if faults is not None and owner != c:
                if faults.is_byzantine(owner):
                    preds = faults.poison_payload(preds, c, gid)
                    # serving this entry must yield the poisoned outputs
                    # too: wrap the forward and strip the raw params so
                    # the batched family path — which would serve TRUE
                    # outputs — never picks it up
                    entry = dataclasses.replace(
                        entry, params=None, ccfg=None,
                        predict=lambda x, f=entry.predict, cc=c,
                        g=gid: faults.poison_matrix(f(x), cc, g))
                if faults.take_corrupt(c, model_key):
                    preds = faults.corrupt_matrix(preds, c, gid)
            if adm is not None and owner != c:
                if adm.screen(c, gid, preds, stores[c]) != "admitted":
                    return
            stores[c].add(entry, preds=preds, t=t)
        return on_add

    def _on_crash(self) -> Optional[Callable]:
        """The crash hook: the scheduler wiped the client's bench; the
        driver wipes its volatile state too (store slots, quarantine
        pen)."""
        if self.faults is None:
            return None
        stores, adm = self.stores, self.admission

        def on_crash(c, t):
            if stores is not None:
                stores[c].wipe()
            if adm is not None:
                adm.on_crash(c)
        return on_crash

    def _run_async_event(self) -> RunResult:
        """The event-granular asynchronous driver: virtual-clock
        simulation where arrivals incrementally materialize the stores
        and debounced select events run batched re-selection through the
        shared engine, over whatever p2p stack the spec declares."""
        spec = self.spec
        data, sched = spec.data, spec.schedule
        n, mpc = data.n_clients, self.models_per_client
        stores, engine = self.stores, self.engine
        acfg = AsyncConfig(
            n_clients=n, models_per_client=mpc,
            speed_lognorm_sigma=sched.speed_lognorm_sigma,
            link_latency=sched.link_latency,
            select_debounce=sched.select_debounce,
            seed=sched.seed if sched.seed is not None else spec.seed)

        curve: List[tuple] = []
        latest: Dict[int, float] = {}
        on_select_batch = None
        if engine is not None and sched.select_during_run:
            def on_select_batch(clients, bench_ids, t):
                fresh = engine.select(clients, t=t)
                out = {c: float(r["val_accuracy"])
                       for c, r in fresh.items()}
                latest.update(out)
                if self.transport is not None and latest:
                    curve.append((self.transport.stats.bytes_sent,
                                  float(np.mean(list(latest.values())))))
                return out

        trace = simulate_async(
            acfg, self.neighbors, train_cost=self.train_cost,
            on_add=self._on_add(), on_select_batch=on_select_batch,
            transport=self.transport, gossip=self.gossip,
            churn=self.churn, repair=self.repair, faults=self.faults,
            on_crash=self._on_crash(), serving=self.serving, obs=self.obs)
        if self.admission is not None:
            trace.net = dict(trace.net or {})
            trace.net["admission"] = self.admission.as_dict()
        if self.serving is not None:
            trace.net = dict(trace.net or {})
            trace.net["serve"] = self.serving.stats_dict()

        finals = [s[-1][1] if s else 0
                  for s in trace.bench_sizes.values()]
        coverage = sum(finals) / (n * n * mpc)
        t_full = (max(s[-1][0] for s in trace.bench_sizes.values())
                  if coverage == 1.0 else float("nan"))
        test_acc = None
        if data.kind in _IMAGE_KINDS and engine is not None:
            test_acc = np.array([accuracy(engine.serve(c, d.x_te)[0],
                                          d.y_te)
                                 for c, d in enumerate(self.datasets)])
        return RunResult(
            spec=spec, mode="async", test_acc=test_acc,
            selections=trace.selections,
            select_batches=trace.select_batches, curve=curve or None,
            coverage=coverage, t_full=t_full, net=trace.net,
            perf={**self.perf, **trace.perf}, trace=trace,
            stores=stores, engine=engine, models=self.models,
            transport=self.transport, gossip=self.gossip,
            churn=self.churn, repair=self.repair)

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
