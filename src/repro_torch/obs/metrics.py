"""Typed, virtual-time-stamped metrics registry (DESIGN.md §11); the
part of `repro/obs/metrics.py` the port's engine and experiment use.

One `Metrics` instance observes one run. Three instrument kinds, all
addressed by a metric NAME plus an optional LABEL SET
(``net.bytes_sent{kind=digest}``):

  counter     monotone accumulator (`inc`) — messages, bytes, accepts;
  gauge       last-write-wins level (`set`) — coverage fraction, t_full;
  series      pure time-series samples (`observe`) — flush wall time,
              GA batch width, select-batch width.

Every mutation may carry the VIRTUAL time `t` of the simulated event it
describes; when it does, the instrument also records a `(t, value)`
sample into its time series, decimated to one sample per `resolution`
bucket of virtual time (last write in a bucket wins). Scalar values are
never decimated — `MetricsFrame.scalars` is exact.

The disabled path is a TRUE no-op: every mutator starts with a single
`enabled` check and returns, and the module-level `NULL_METRICS`
singleton lets the engine hold a metrics attribute unconditionally.

`Stopwatch` is the one wall-clock bracketing helper (start/stop or
context manager): the experiment's `perf` phases and the engine's flush
timing both derive from it, so there is exactly one
`time.perf_counter()` idiom in the port. A stopwatch bound to a
registry also records each lap as a series observation.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, Optional, Tuple

_KINDS = ("counter", "gauge", "series")


def metric_key(name: str, labels: Optional[dict] = None) -> str:
    """Canonical instrument identity: ``name{k=v,...}`` with labels
    sorted by key — the string form used in frames, parity diffs, and
    DESIGN.md §11's namespace table."""
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


def json_ready(v):
    """Recursively map a result payload onto STRICT-JSON types: non-
    finite floats (NaN, ±Inf) become None, numpy scalars/arrays become
    Python numbers/lists, tuples become lists. `json.dump(...,
    allow_nan=False)` of the output never raises — bare ``NaN`` tokens
    in dumped summaries reject under strict parsers (the
    experiment.t_full regression, tests/test_obs.py)."""
    if isinstance(v, float):
        return v if math.isfinite(v) else None
    if isinstance(v, dict):
        return {k: json_ready(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [json_ready(x) for x in v]
    if hasattr(v, "item") and not hasattr(v, "ndim"):  # numpy scalar
        return json_ready(v.item())
    if hasattr(v, "tolist"):                           # numpy array
        return json_ready(v.tolist())
    return v


@dataclasses.dataclass
class _Instrument:
    kind: str
    value: float = 0.0
    samples: List[Tuple[float, float]] = dataclasses.field(
        default_factory=list)


@dataclasses.dataclass
class MetricsFrame:
    """The collected snapshot of one run: exact final scalar values per
    instrument plus the decimated time series."""
    scalars: Dict[str, Optional[float]] = dataclasses.field(
        default_factory=dict)
    series: Dict[str, List[List[float]]] = dataclasses.field(
        default_factory=dict)
    meta: dict = dataclasses.field(default_factory=dict)

    def names(self) -> set:
        """Every metric name (label-qualified) the run emitted."""
        return set(self.scalars) | set(self.series)

    def to_dict(self) -> dict:
        return {"scalars": json_ready(self.scalars),
                "series": json_ready(self.series),
                "meta": json_ready(self.meta)}

    @classmethod
    def from_dict(cls, d: dict) -> "MetricsFrame":
        return cls(scalars=dict(d.get("scalars") or {}),
                   series={k: [list(p) for p in v]
                           for k, v in (d.get("series") or {}).items()},
                   meta=dict(d.get("meta") or {}))


class Metrics:
    """One run's metrics registry. `enabled=False` instances are inert
    (every mutator returns immediately) — the no-op path instrumented
    subsystems call through when observability is off."""

    def __init__(self, enabled: bool = True, resolution: float = 0.05):
        self.enabled = enabled
        self.resolution = float(resolution)
        self._instruments: Dict[str, _Instrument] = {}

    # ---- internals ----------------------------------------------------
    def _get(self, kind: str, name: str, labels: dict) -> _Instrument:
        key = metric_key(name, labels)
        inst = self._instruments.get(key)
        if inst is None:
            inst = self._instruments[key] = _Instrument(kind)
        elif inst.kind != kind:
            raise ValueError(
                f"metric {key!r} already registered as {inst.kind}, "
                f"cannot re-use it as a {kind}")
        return inst

    def _sample(self, inst: _Instrument, t: float, value: float) -> None:
        s = inst.samples
        if s and t - s[-1][0] < self.resolution:
            s[-1] = (s[-1][0], value)  # last write in the bucket wins
        else:
            s.append((float(t), float(value)))

    # ---- mutators (each starts with the true-no-op gate) --------------
    def inc(self, name: str, value: float = 1, t: Optional[float] = None,
            **labels) -> None:
        """Counter: accumulate `value`; with `t`, sample the cumulative
        total onto the instrument's virtual-time series."""
        if not self.enabled:
            return
        inst = self._get("counter", name, labels)
        inst.value += value
        if t is not None:
            self._sample(inst, t, inst.value)

    def set(self, name: str, value: float, t: Optional[float] = None,
            **labels) -> None:
        """Gauge: last write wins; with `t`, also sampled."""
        if not self.enabled:
            return
        inst = self._get("gauge", name, labels)
        inst.value = value
        if t is not None:
            self._sample(inst, t, value)

    def observe(self, name: str, value: float, t: Optional[float] = None,
                **labels) -> None:
        """Series: record one sample (scalar = last observation)."""
        if not self.enabled:
            return
        inst = self._get("series", name, labels)
        inst.value = value
        self._sample(inst, 0.0 if t is None else t, value)

    def stopwatch(self, name: Optional[str] = None, **labels
                  ) -> "Stopwatch":
        """A wall-clock bracketing helper; when this registry is enabled
        and a name is given, each lap is recorded as a series
        observation (seconds)."""
        return Stopwatch(metrics=self if self.enabled else None,
                         name=name, **labels)

    # ---- collection ---------------------------------------------------
    def frame(self, meta: Optional[dict] = None) -> MetricsFrame:
        scalars = {k: i.value for k, i in sorted(self._instruments.items())}
        series = {k: [[t, v] for t, v in i.samples]
                  for k, i in sorted(self._instruments.items())
                  if i.samples}
        return MetricsFrame(scalars=scalars, series=series,
                            meta=dict(meta or {}))


class Stopwatch:
    """The one `time.perf_counter()` bracketing idiom: accumulate wall
    seconds across laps via ``with sw(t=virtual_t): ...`` or explicit
    `start()`/`stop()`. Works standalone (pure timing — the scheduler's
    `perf` phases) and, when bound to an enabled registry, records each
    lap as a virtual-time-stamped series observation."""

    def __init__(self, metrics: Optional[Metrics] = None,
                 name: Optional[str] = None, **labels):
        self.total = 0.0
        self.laps = 0
        self._mx = metrics
        self._name = name
        self._labels = labels
        self._vt: Optional[float] = None
        self._t0: Optional[float] = None

    def __call__(self, t: Optional[float] = None) -> "Stopwatch":
        self._vt = t
        return self

    def start(self) -> "Stopwatch":
        self._t0 = time.perf_counter()
        return self

    def peek(self) -> float:
        """Elapsed seconds of the running lap, read without stopping
        (0.0 when no lap is running)."""
        return 0.0 if self._t0 is None else time.perf_counter() - self._t0

    def stop(self) -> float:
        dt = time.perf_counter() - self._t0
        self._t0 = None
        self.total += dt
        self.laps += 1
        if self._mx is not None and self._name is not None:
            self._mx.observe(self._name, dt, t=self._vt, **self._labels)
        return dt

    def __enter__(self) -> "Stopwatch":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


# The shared inert registry: subsystems default their `metrics`
# attribute to this so instrumentation sites never null-check.
NULL_METRICS = Metrics(enabled=False)
