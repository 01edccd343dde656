"""Declarative experiment specs: one serializable description per run
(port of `repro/sim/spec.py`).

Every section parses and round-trips exactly as in the reference, so one
spec file drives either package.

`ExperimentSpec` is the single entry point's input (DESIGN.md §9): a
nested, dict/JSON-round-trippable, seed-complete description of a FedPAE
scenario. Five sections mirror the five things a run needs:

  DataSpec       — what world the fleet lives in: real non-IID image
                   clients ("synthetic_images"), a quality-parameterized
                   prediction-matrix world with no CNN training
                   ("prediction_world"), a pure dissemination run with no
                   stores at all ("none"), or caller-provided datasets
                   ("external", the compatibility-shim path).
  TrainSpec      — local training: model families, lr, epochs, width.
  SelectionSpec  — NSGA-II shape, ensemble size, kernel/device-resident
                   switches, bounded store capacity.
  NetworkSpec    — topology plus four TAGGED component slots (transport,
                   gossip, churn, repair), each a `ComponentSpec` resolved
                   by name through `repro_torch.sim.registry` so new
                   transports and protocols plug in without touching
                   the driver.
  ScheduleSpec   — sync vs async, debounce, speeds, and the train-cost
                   model (itself a tagged component).
  ObsSpec        — observability (DESIGN.md §11): the metrics registry,
                   optional Perfetto trace collection, and tagged output
                   sinks; disabled by default with a true no-op path.
  FaultSpec      — fault injection (DESIGN.md §12): tagged injector
                   components (kind "fault") plus an optional
                   validation-gated admission layer (kind "admission");
                   empty by default with a byte-identical no-fault path.
  ServeSpec      — online serving (DESIGN.md §14): a tagged query-traffic
                   component (kind "traffic") interleaving per-client
                   query micro-batches with train/gossip/repair events,
                   tagged drift components (kind "drift") shifting the
                   query stream at scheduled virtual times, and an
                   accuracy monitor whose window-threshold breach
                   triggers debounced re-selection; empty by default
                   with a byte-identical no-serving path.

Seed-completeness: `ExperimentSpec.seed` is the ONE knob; every section
and component whose params omit a `seed` inherits it at build time, so
`to_dict()` plus the seed reproduces the trace bit-for-bit.

`from_dict` is STRICT — unknown keys raise `ValueError` naming the
allowed fields — because a silently-ignored typo in a sweep config is a
wrong experiment, not a default one.
"""
from __future__ import annotations

import dataclasses
import json
from typing import ClassVar, Optional, Tuple

from repro_torch.core.nsga2 import NSGAConfig


def _check_keys(cls, d: dict, path: str) -> None:
    allowed = {f.name for f in dataclasses.fields(cls)}
    unknown = sorted(set(d) - allowed)
    if unknown:
        raise ValueError(
            f"unknown {path} field(s) {unknown}; allowed: {sorted(allowed)}")


def _jsonify(v):
    """Recursively map spec values onto pure-JSON types (tuples->lists)."""
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return {f.name: _jsonify(getattr(v, f.name))
                for f in dataclasses.fields(v)}
    if isinstance(v, (list, tuple)):
        return [_jsonify(x) for x in v]
    if isinstance(v, dict):
        return {k: _jsonify(x) for k, x in v.items()}
    return v


@dataclasses.dataclass
class ComponentSpec:
    """A tagged component config: `name` picks the builder out of
    `repro_torch.sim.registry`, `params` is its keyword payload. Accepts
    the shorthand forms ``"push"`` (bare name) and ``{"name": ..,
    "params": ..}`` wherever a spec field expects a component."""
    name: str
    params: dict = dataclasses.field(default_factory=dict)

    @classmethod
    def of(cls, v, path: str = "component") -> Optional["ComponentSpec"]:
        if v is None or isinstance(v, ComponentSpec):
            return v
        if isinstance(v, str):
            return cls(v)
        if isinstance(v, dict):
            _check_keys(cls, v, path)
            if "name" not in v:
                raise ValueError(f"{path}: component spec needs a 'name'")
            return cls(v["name"], dict(v.get("params") or {}))
        raise ValueError(f"{path}: cannot interpret {v!r} as a component "
                         "spec (want a name, a ComponentSpec, or a "
                         "{'name', 'params'} dict)")


@dataclasses.dataclass
class DataSpec:
    KINDS: ClassVar[Tuple[str, ...]] = (
        "synthetic_images", "prediction_world", "none", "external")

    kind: str = "synthetic_images"
    n_clients: int = 8
    n_classes: int = 8
    # synthetic_images: class-conditional generative images, Dirichlet
    # label skew, 70/15/15 split per client
    n_samples: int = 2400
    image_size: int = 10
    channels: int = 3
    alpha: float = 0.1
    # prediction_world / none: validation width and per-client model
    # count of the trainingless world
    n_val: int = 128
    models_per_client: int = 2
    quality_local: tuple = (0.55, 0.9)    # U[lo, hi) accuracy of own models
    quality_remote: tuple = (0.2, 0.85)   # ... of peers' models
    seed: Optional[int] = None            # None -> ExperimentSpec.seed
    split_seed: Optional[int] = None      # None -> data seed + 1

    def __post_init__(self):
        if self.kind not in self.KINDS:
            raise ValueError(f"unknown data kind {self.kind!r}; "
                             f"choose from {self.KINDS}")
        self.quality_local = tuple(self.quality_local)
        self.quality_remote = tuple(self.quality_remote)


@dataclasses.dataclass
class TrainSpec:
    families: tuple = ("cnn4", "vgg", "resnet", "densenet", "inception")
    lr: float = 0.05
    batch: int = 32
    max_epochs: int = 40
    patience: int = 6
    width: int = 16

    def __post_init__(self):
        self.families = tuple(self.families)


@dataclasses.dataclass
class SelectionSpec:
    enabled: bool = True
    pop_size: int = 100
    generations: int = 100
    k: int = 5
    p_mut: float = 0.02
    p_cross: float = 0.9
    ensemble_k: Optional[int] = None      # None -> k
    use_kernel: bool = False     # parsed for round-trips; no effect here
    device_resident: bool = True  # False = legacy host restack per select
    store_capacity: Optional[int] = None  # bounded streaming stores (§6)
    seed: Optional[int] = None            # None -> ExperimentSpec.seed

    def nsga(self, default_seed: int) -> NSGAConfig:
        return NSGAConfig(pop_size=self.pop_size,
                          generations=self.generations, k=self.k,
                          p_mut=self.p_mut, p_cross=self.p_cross,
                          seed=self.seed if self.seed is not None
                          else default_seed)


@dataclasses.dataclass
class NetworkSpec:
    topology: str = "full"
    topology_k: int = 3
    topology_beta: float = 0.1
    transport: Optional[ComponentSpec] = None
    gossip: Optional[ComponentSpec] = None
    churn: Optional[ComponentSpec] = None
    repair: Optional[ComponentSpec] = None

    def __post_init__(self):
        for slot in ("transport", "gossip", "churn", "repair"):
            setattr(self, slot,
                    ComponentSpec.of(getattr(self, slot), f"network.{slot}"))


@dataclasses.dataclass
class ScheduleSpec:
    MODES: ClassVar[Tuple[str, ...]] = ("sync", "async")

    mode: str = "sync"
    # async knobs (mirror fl.scheduler.AsyncConfig defaults)
    speed_lognorm_sigma: float = 0.6
    link_latency: float = 0.05
    select_debounce: float = 0.1
    train_cost: ComponentSpec = dataclasses.field(
        default_factory=lambda: ComponentSpec("affine",
                                              {"base": 1.0, "slope": 0.3}))
    select_during_run: bool = True  # False: arrivals fill stores but no
                                    # select events fire (dissemination /
                                    # offline-selection benchmarks)
    # which async simulator executes the run: the event-granular Python
    # loop ("event", the golden reference) or the jitted tick-stepped
    # array world ("compiled", `repro/sim/compiled.py` — params: tick,
    # chunk_ticks, max_ticks, key_block). Registry kind "backend".
    backend: ComponentSpec = dataclasses.field(
        default_factory=lambda: ComponentSpec("event"))
    seed: Optional[int] = None      # None -> ExperimentSpec.seed

    def __post_init__(self):
        if self.mode not in self.MODES:
            raise ValueError(f"unknown schedule mode {self.mode!r}; "
                             f"choose from {self.MODES}")
        self.train_cost = ComponentSpec.of(self.train_cost,
                                           "schedule.train_cost")
        self.backend = ComponentSpec.of(self.backend, "schedule.backend")


@dataclasses.dataclass
class ObsSpec:
    """Observability (DESIGN.md §11). Disabled by default — the probes
    threaded through the scheduler, p2p stack, engine, and compiled
    backend all take a true no-op path, so an obs-less run is
    bit-identical to (and as fast as) the pre-observability code.

    `enabled` turns on the metrics registry (and attaches the collected
    `MetricsFrame` to `RunResult.metrics`); `trace` additionally records
    the event backend's per-event Chrome/Perfetto trace (event backend
    only — the compiled array world has no per-message events);
    `resolution` is the virtual-time bucket width for time-series sample
    decimation; `sinks` are tagged output components (registry kind
    "sink": "metrics_json", "perfetto") invoked with the finished
    RunResult."""
    enabled: bool = False
    trace: bool = False
    resolution: float = 0.05
    sinks: tuple = ()

    def __post_init__(self):
        self.sinks = tuple(ComponentSpec.of(s, "obs.sinks")
                           for s in self.sinks)


@dataclasses.dataclass
class FaultSpec:
    """Fault injection + graceful degradation (DESIGN.md §12). Empty by
    default — a spec without (or with an empty) `faults` section takes
    the scheduler's fault-free paths byte-identically.

    `injectors` are tagged components of registry kind "fault"
    ("byzantine", "corruption", "crash_restart", "partition" — at most
    one of each); `admission` optionally names a kind-"admission"
    component ("validation_gate") screening remote payloads before they
    enter the selection pool. `seed` defaults to the experiment seed
    (seed-completeness: fault schedules are pure functions of it).
    Faults drive the asynchronous event loop: sync runs and the compiled
    backend reject them loudly."""
    injectors: tuple = ()
    admission: Optional[ComponentSpec] = None
    seed: Optional[int] = None            # None -> ExperimentSpec.seed

    def __post_init__(self):
        self.injectors = tuple(ComponentSpec.of(i, "faults.injectors")
                               for i in self.injectors)
        self.admission = ComponentSpec.of(self.admission,
                                          "faults.admission")

    @property
    def enabled(self) -> bool:
        return bool(self.injectors) or self.admission is not None


@dataclasses.dataclass
class ServeSpec:
    """Online serving (DESIGN.md §14). Empty by default — a spec without
    (or with an empty) `serve` section takes the scheduler's
    no-serving paths byte-identically.

    `traffic` names a kind-"traffic" component ("poisson", "bursty")
    generating per-client query micro-batch events the scheduler
    interleaves with train/gossip/repair; `drift` are kind-"drift"
    components ("label_shift", "covariate_shift" — at most one of each)
    shifting the query stream and the serving ground truth at scheduled
    virtual times. `policy` picks how a batch is answered: "ensemble"
    serves the client's currently-selected chromosome via the mean-prob
    vote, "dynamic" routes through the KNORA-style DES in
    `core.dynamic` (competence-weighted per-query model choice).
    When `monitor` is true, a sliding window of `window` per-query
    correct bits is kept per client; once warm, dropping more than
    `threshold` below the window's own peak schedules a re-selection,
    debounced to at most one per `debounce` virtual seconds per client.
    `service_time` prices one query's compute for the virtual-time
    latency model. `seed` defaults to the experiment seed (traffic and
    drift schedules are pure functions of it). Serving drives the
    asynchronous event loop: sync runs and the compiled backend reject
    it loudly."""
    POLICIES: ClassVar[Tuple[str, ...]] = ("ensemble", "dynamic")

    traffic: Optional[ComponentSpec] = None
    drift: tuple = ()
    policy: str = "ensemble"
    monitor: bool = True
    window: int = 64
    threshold: float = 0.1
    debounce: float = 1.0
    service_time: float = 1e-4
    des_k: Optional[int] = None           # None -> selection.k
    des_neighbors: int = 7                # KNORA competence region size
    seed: Optional[int] = None            # None -> ExperimentSpec.seed

    def __post_init__(self):
        if self.policy not in self.POLICIES:
            raise ValueError(f"unknown serve policy {self.policy!r}; "
                             f"choose from {self.POLICIES}")
        self.traffic = ComponentSpec.of(self.traffic, "serve.traffic")
        self.drift = tuple(ComponentSpec.of(d, "serve.drift")
                           for d in self.drift)
        if self.drift and self.traffic is None:
            raise ValueError("serve.drift without serve.traffic: drift "
                             "shifts the query stream, so a traffic "
                             "component must be configured")

    @property
    def enabled(self) -> bool:
        return self.traffic is not None


@dataclasses.dataclass
class ExperimentSpec:
    """The one declarative description of a run. Build and execute it
    with `repro_torch.sim.Experiment.from_spec(spec).run()`."""
    data: DataSpec = dataclasses.field(default_factory=DataSpec)
    train: TrainSpec = dataclasses.field(default_factory=TrainSpec)
    selection: SelectionSpec = dataclasses.field(
        default_factory=SelectionSpec)
    network: NetworkSpec = dataclasses.field(default_factory=NetworkSpec)
    schedule: ScheduleSpec = dataclasses.field(default_factory=ScheduleSpec)
    obs: ObsSpec = dataclasses.field(default_factory=ObsSpec)
    faults: FaultSpec = dataclasses.field(default_factory=FaultSpec)
    serve: ServeSpec = dataclasses.field(default_factory=ServeSpec)
    seed: int = 0

    # ---- serialization ------------------------------------------------
    def to_dict(self) -> dict:
        return _jsonify(self)

    def to_json(self, **kw) -> str:
        kw.setdefault("indent", 2)
        return json.dumps(self.to_dict(),
                          allow_nan=kw.pop("allow_nan", False), **kw)

    @classmethod
    def from_dict(cls, d: dict) -> "ExperimentSpec":
        _check_keys(cls, d, "spec")
        sections = {"data": DataSpec, "train": TrainSpec,
                    "selection": SelectionSpec, "network": NetworkSpec,
                    "schedule": ScheduleSpec, "obs": ObsSpec,
                    "faults": FaultSpec, "serve": ServeSpec}
        kw = {}
        for name, scls in sections.items():
            sub = d.get(name)
            if sub is None:
                continue
            if isinstance(sub, scls):
                kw[name] = sub
                continue
            _check_keys(scls, sub, name)
            kw[name] = scls(**sub)
        if "seed" in d:
            kw["seed"] = int(d["seed"])
        return cls(**kw)

    @classmethod
    def from_json(cls, s: str) -> "ExperimentSpec":
        return cls.from_dict(json.loads(s))
