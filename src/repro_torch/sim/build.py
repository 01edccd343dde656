"""Spec -> concrete objects: stock component builders and world builders
(port of `repro/sim/build.py`).

Importing this module registers the stock components:

  transport:  "gossip"                    (p2p.GossipTransport)
  gossip:     "push", "push_pull"         (p2p.GossipProtocol)
  churn:      "lognormal"                 (p2p.ChurnSchedule, FLGo-style)
  repair:     "anti_entropy"              (p2p.AntiEntropyRepair)
  train_cost: "affine", "constant"        (virtual training durations)
  sizer:      "prediction_matrix", "checkpoint"  (transport pricing)
  backend:    "event"                     (fl.scheduler.simulate_async),
              "compiled"                  (sim.compiled.run_compiled)
  sink:       "metrics_json", "perfetto"  (obs.probes)
  fault:      "byzantine", "corruption", "crash_restart", "partition"
                                          (faults.injectors)
  admission:  "validation_gate"           (faults.admission)
  traffic:    "poisson", "bursty"         (serve.traffic)
  drift:      "label_shift", "covariate_shift"  (serve.drift)

Each builder receives `(params, ctx)`; `build_network` assembles the
whole p2p stack in dependency order (topology -> churn -> gossip ->
transport -> repair) and injects the experiment seed into any component
whose params omit one — the spec's seed-completeness contract;
`build_faults` and `build_serving` assemble the faults and serve
sections the same way.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.data import (dirichlet_partition, make_synthetic_images,
                              split_train_val_test)
from repro_torch.faults import (AdmissionConfig, ByzantineFault,
                                CorruptionFault, CrashRestartFault,
                                FaultController, PartitionFault)
from repro_torch.fl.client import ClientData
from repro_torch.fl.topology import make_topology
from repro_torch.obs import probes as _obs_probes
from repro_torch.p2p.churn import ChurnSchedule
from repro_torch.p2p.gossip import GossipProtocol
from repro_torch.p2p.params import check_params, config_from_params
from repro_torch.p2p.repair import AntiEntropyRepair
from repro_torch.p2p.transport import (GossipTransport, checkpoint_bytes,
                                       prediction_matrix_bytes)
from repro_torch.serve import (BurstyTraffic, CovariateShiftDrift,
                               LabelShiftDrift, PoissonTraffic, ServeConfig,
                               ServingEngine)
from repro_torch.sim.registry import build as build_component
from repro_torch.sim.registry import register
from repro_torch.sim.spec import ComponentSpec, DataSpec, ExperimentSpec

# ---- stock train-cost models ------------------------------------------


@register("train_cost", "affine")
def _affine_cost(params: dict, ctx: dict):
    """duration(c, m) = base + slope * m — the legacy drivers' default."""
    check_params(params, ("base", "slope"), "train_cost[affine]")
    base = float(params.get("base", 1.0))
    slope = float(params.get("slope", 0.3))
    return lambda c, m: base + slope * m


@register("train_cost", "constant")
def _constant_cost(params: dict, ctx: dict):
    check_params(params, ("base",), "train_cost[constant]")
    base = float(params.get("base", 1.0))
    return lambda c, m: base


# ---- stock message sizers ---------------------------------------------


@register("sizer", "prediction_matrix")
def _sizer_prediction(params: dict, ctx: dict):
    """The paper's §III-A low-storage exchange unit. Dimensions default
    to the world's (n_val, n_classes) from the build context."""
    check_params(params, ("n_val", "n_classes", "bytes_per_value"),
                 "sizer[prediction_matrix]")
    nb = prediction_matrix_bytes(
        int(params.get("n_val", ctx["n_val"])),
        int(params.get("n_classes", ctx["n_classes"])),
        int(params.get("bytes_per_value", 4)))
    return lambda src, dst, key: nb


@register("sizer", "checkpoint")
def _sizer_checkpoint(params: dict, ctx: dict):
    """The naive full-parameter-vector exchange (the cost baseline)."""
    check_params(params, ("n_params", "bytes_per_value"),
                 "sizer[checkpoint]")
    nb = checkpoint_bytes(int(params.get("n_params", 250_000)),
                          int(params.get("bytes_per_value", 4)))
    return lambda src, dst, key: nb


# ---- stock p2p components ---------------------------------------------


@register("transport", "gossip")
def _transport_gossip(params: dict, ctx: dict):
    sizer = ComponentSpec.of(params.pop("sizer", "prediction_matrix"),
                             "transport.sizer")
    size_fn = build_component("sizer", sizer, ctx)
    return GossipTransport.from_params(params, ctx["n_clients"], size_fn)


@register("gossip", "push")
def _gossip_push(params: dict, ctx: dict):
    return GossipProtocol.from_params("push", params, ctx["neighbors"],
                                      churn=ctx.get("churn"))


@register("gossip", "push_pull")
def _gossip_push_pull(params: dict, ctx: dict):
    return GossipProtocol.from_params("push_pull", params,
                                      ctx["neighbors"],
                                      churn=ctx.get("churn"))


@register("churn", "lognormal")
def _churn_lognormal(params: dict, ctx: dict):
    return ChurnSchedule.from_params(params, ctx["n_clients"])


@register("repair", "anti_entropy")
def _repair_anti_entropy(params: dict, ctx: dict):
    gossip = ctx.get("gossip")
    if gossip is None:
        raise ValueError("the anti_entropy repair component requires a "
                         "gossip component in network.gossip")
    return AntiEntropyRepair.from_params(params, gossip,
                                         churn=ctx.get("churn"))


# ---- simulator backends -----------------------------------------------


@register("backend", "event")
def _backend_event(params: dict, ctx: dict):
    """The event-granular heap loop (fl.scheduler.simulate_async)."""
    check_params(params, (), "backend[event]")
    return lambda exp: exp._run_async_event()


@register("backend", "compiled")
def _backend_compiled(params: dict, ctx: dict):
    """The tick-stepped array world (sim.compiled) for 10k-100k-client
    dissemination studies, on the experiment's device; `tick` defaults
    to the transport base latency (1-tick hops)."""
    check_params(params, ("tick", "chunk_ticks", "max_ticks",
                          "key_block"), "backend[compiled]")
    kw = {k: params[k] for k in params}

    def run(exp):
        from repro_torch.sim.compiled import run_compiled
        return run_compiled(exp, **kw)
    return run


# ---- fault injectors + admission (DESIGN.md §12) ----------------------


@register("fault", "byzantine")
def _fault_byzantine(params: dict, ctx: dict):
    return ByzantineFault.from_params(params, ctx["n_clients"])


@register("fault", "corruption")
def _fault_corruption(params: dict, ctx: dict):
    return CorruptionFault.from_params(params, ctx["n_clients"])


@register("fault", "crash_restart")
def _fault_crash_restart(params: dict, ctx: dict):
    return CrashRestartFault.from_params(params, ctx["n_clients"])


@register("fault", "partition")
def _fault_partition(params: dict, ctx: dict):
    return PartitionFault.from_params(params, ctx["n_clients"])


@register("admission", "validation_gate")
def _admission_validation_gate(params: dict, ctx: dict):
    """Returns the CONFIG, not the controller: the gates need the built
    stores (labels, class counts), which only the experiment driver
    holds — it wraps this in an AdmissionController."""
    return config_from_params(AdmissionConfig, params,
                              "admission[validation_gate]")


def build_faults(spec: ExperimentSpec, n_clients: int):
    """Aggregate the spec's fault injectors into one FaultController
    (None when no injectors are declared). `FaultSpec.seed` overrides the
    experiment seed for every injector whose params omit one."""
    fa = spec.faults
    if not fa.injectors:
        return None
    base = fa.seed if fa.seed is not None else spec.seed
    ctx = {"n_clients": n_clients, "seed": base, "spec": spec}
    injectors = [build_component("fault", _seeded(cs, base), ctx)
                 for cs in fa.injectors]
    return FaultController(injectors, n_clients)


# ---- serving: traffic + drift (DESIGN.md §14) -------------------------


@register("traffic", "poisson")
def _traffic_poisson(params: dict, ctx: dict):
    return PoissonTraffic.from_params(params, ctx["n_clients"])


@register("traffic", "bursty")
def _traffic_bursty(params: dict, ctx: dict):
    return BurstyTraffic.from_params(params, ctx["n_clients"])


@register("drift", "label_shift")
def _drift_label_shift(params: dict, ctx: dict):
    return LabelShiftDrift.from_params(params, ctx["n_clients"])


@register("drift", "covariate_shift")
def _drift_covariate_shift(params: dict, ctx: dict):
    return CovariateShiftDrift.from_params(params, ctx["n_clients"])


def build_serving(spec: ExperimentSpec, n_clients: int, stores, engine,
                  query_pools=None):
    """Assemble the spec's serve section into one ServingEngine (None
    when no traffic component is declared). `ServeSpec.seed` overrides
    the experiment seed for the traffic/drift components whose params
    omit one — the same seed-completeness contract as build_faults."""
    sv = spec.serve
    if sv.traffic is None:
        return None
    base = sv.seed if sv.seed is not None else spec.seed
    ctx = {"n_clients": n_clients, "seed": base, "spec": spec}
    traffic = build_component("traffic", _seeded(sv.traffic, base), ctx)
    drifts = [build_component("drift", _seeded(cs, base), ctx)
              for cs in sv.drift]
    cfg = ServeConfig(
        policy=sv.policy, monitor=sv.monitor, window=sv.window,
        threshold=sv.threshold, debounce=sv.debounce,
        service_time=sv.service_time, des_k=sv.des_k,
        des_neighbors=sv.des_neighbors, seed=base)
    return ServingEngine(cfg, traffic, drifts, n_clients=n_clients,
                         n_classes=spec.data.n_classes, stores=stores,
                         engine=engine, query_pools=query_pools)


# ---- observability sinks ------------------------------------------------
register("sink", "metrics_json")(_obs_probes.sink_metrics_json)
register("sink", "perfetto")(_obs_probes.sink_perfetto)


# ---- network stack assembly -------------------------------------------


def _seeded(cspec: Optional[ComponentSpec],
            seed: int) -> Optional[ComponentSpec]:
    """Inject the experiment seed into a component whose params omit one
    (without mutating the spec)."""
    if cspec is None or "seed" in cspec.params:
        return cspec
    return ComponentSpec(cspec.name, {**cspec.params, "seed": seed})


def build_network(spec: ExperimentSpec, n_clients: int,
                  n_val: Optional[int] = None,
                  injected: Optional[Dict[str, object]] = None
                  ) -> Dict[str, object]:
    """Assemble the p2p stack a spec describes. Returns a dict with
    `neighbors`, `transport`, `gossip`, `churn`, `repair`, `train_cost`
    (absent layers are None); the scheduler consumes them directly.

    `injected` maps slot names to caller-built collaborators (the
    compatibility shims' path). An injected instance takes its slot AND
    participates in the build context, so spec-built dependents wire
    against the object that will actually run."""
    net = spec.network
    injected = injected or {}
    ctx: Dict[str, object] = {
        "n_clients": n_clients,
        "n_val": spec.data.n_val if n_val is None else n_val,
        "n_classes": spec.data.n_classes,
        "seed": spec.seed,
        "spec": spec,
    }
    ctx["neighbors"] = make_topology(net.topology, n_clients,
                                     k=net.topology_k, seed=spec.seed,
                                     beta=net.topology_beta)

    def slot(kind, name, cspec, seeded=True):
        if injected.get(name) is not None:
            ctx[name] = injected[name]
        else:
            ctx[name] = build_component(
                kind, _seeded(cspec, spec.seed) if seeded else cspec, ctx)

    slot("churn", "churn", net.churn)
    slot("gossip", "gossip", net.gossip)
    slot("transport", "transport", net.transport)
    slot("repair", "repair", net.repair)
    # train-cost models are deterministic functions — no seed to inject
    slot("train_cost", "train_cost", spec.schedule.train_cost,
         seeded=False)
    return ctx


# ---- worlds -----------------------------------------------------------


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


def build_prediction_world(data: DataSpec, default_seed: int
                           ) -> Tuple[dict, dict]:
    """kind="prediction_world": per-client labels and quality-
    parameterized prediction matrices — local models better than remote
    on average, no CNN training needed. Returns (labels, mats) with
    labels[c] = (V,) int labels and mats[(c, global_model_id)] = (V, C)
    row-normalized probabilities; draw for draw the reference's."""
    n, mpc = data.n_clients, data.models_per_client
    V, C = data.n_val, data.n_classes
    seed = data.seed if data.seed is not None else default_seed
    rng = np.random.default_rng(seed)
    labels = {c: rng.integers(0, C, V) for c in range(n)}
    mats = {}
    for c in range(n):
        for owner in range(n):
            for m in range(mpc):
                q = rng.uniform(*data.quality_local) if owner == c \
                    else rng.uniform(*data.quality_remote)
                correct = rng.random(V) < q
                pred = np.where(correct, labels[c],
                                (labels[c] + 1 +
                                 rng.integers(0, C - 1, V)) % C)
                out = np.full((V, C), 0.05, np.float32)
                out[np.arange(V), pred] = 0.8
                mats[(c, owner * mpc + m)] = out / out.sum(1, keepdims=True)
    return labels, mats


def build_world_stores(data: DataSpec, labels: dict,
                       store_capacity: Optional[int]):
    """Empty (streaming) stores for a prediction world: bounded iff the
    capacity is below the global model count (mirrors
    core.fedpae._empty_stores for the trainingless world)."""
    from repro_torch.core.bench import (PredictionStore,
                                        StreamingPredictionStore)
    n, mpc = data.n_clients, data.models_per_client
    V, C = data.n_val, data.n_classes
    full = n * mpc
    cap = full if store_capacity is None else store_capacity
    if cap >= full:  # slot-aligned unbounded store, one slot per model
        return [PredictionStore(c, full, np.zeros((V, 2), np.float32),
                                labels[c], C) for c in range(n)]
    return [StreamingPredictionStore(c, cap, np.zeros((V, 2), np.float32),
                                     labels[c], C) for c in range(n)]
