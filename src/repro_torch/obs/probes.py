"""Observability wiring (port of `repro/obs/probes.py`): the run-scoped
`Obs` context, the canonical run counters, and the stock output sinks
(registry kind "sink").

The final labeled counters — `net.msgs_sent{kind=model|digest}`,
`net.bytes_sent{...}`, `gossip.msgs{outcome=...}`, `repair.*`,
`coverage.*` — are derived ONCE, here, from the run's final `net` dict,
with the reference's names and values (DESIGN.md §11). Live time series
(`net.msgs_on_wire`, `net.bytes_on_wire`, `gossip.accepted`,
`repair.digests_on_wire`, `coverage.fraction`) are emitted by the event
loop and the p2p layers at their probe sites.

The fault, admission and serving layers' counters (`faults.*`,
`admission.*`, `serve.*`, `transport.corrupt`) come from the same dict's
`faults`, `admission` and `serve` sections. The compiled backend emits
the same live series host-side, once a chunk (`CompiledProbe`).

Stock sinks (registered by `repro_torch.sim.build` under kind "sink"):

  metrics_json  — write `RunResult.metrics` (a MetricsFrame) as strict
                  JSON (params: path);
  perfetto      — write the event backend's trace as Chrome/Perfetto
                  trace-event JSON (params: path).
"""
from __future__ import annotations

import json
from typing import Optional

from repro_torch.obs.metrics import Metrics
from repro_torch.obs.trace_export import TraceCollector, export_chrome_trace
from repro_torch.p2p.params import check_params


class Obs:
    """One run's observability context: the metrics registry plus (when
    the spec opts in) the event-trace collector. Built by `make_obs`
    from an `ObsSpec`; `None` means every probe site takes its no-op
    path."""

    def __init__(self, resolution: float = 0.05, trace: bool = False):
        self.enabled = True
        self.metrics = Metrics(enabled=True, resolution=resolution)
        self.trace: Optional[TraceCollector] = (
            TraceCollector(resolution=resolution) if trace else None)


def make_obs(obs_spec) -> Optional[Obs]:
    """ObsSpec -> Obs context, or None when observability is off."""
    if obs_spec is None or not obs_spec.enabled:
        return None
    return Obs(resolution=obs_spec.resolution, trace=obs_spec.trace)


def attach_metrics(metrics: Metrics, *objs) -> None:
    """Point each instrumented subsystem's `metrics` attribute (default
    NULL_METRICS) at the run's live registry. None entries are skipped,
    so the caller can pass optional p2p layers directly."""
    for obj in objs:
        if obj is not None:
            obj.metrics = metrics


def emit_run_counters(mx: Metrics, net: Optional[dict],
                      coverage: Optional[float] = None,
                      t_full: Optional[float] = None) -> None:
    """Emit the final labeled counters/gauges from a run's `net` dict."""
    if net:
        tr = net.get("transport")
        go = net.get("gossip")
        rp = net.get("repair")
        dig_sent = rp["n_digests_sent"] if rp else 0
        dig_recv = rp["n_digests_recv"] if rp else 0
        dig_bytes = rp["bytes_digests"] if rp else 0
        if tr is not None:
            mx.inc("net.msgs_sent", tr["n_sent"] - dig_sent, kind="model")
            mx.inc("net.msgs_sent", dig_sent, kind="digest")
            mx.inc("net.msgs_delivered", tr["n_delivered"] - dig_recv,
                   kind="model")
            mx.inc("net.msgs_delivered", dig_recv, kind="digest")
            mx.inc("net.msgs_dropped", tr["n_dropped_link"], cause="link")
            mx.inc("net.msgs_dropped", tr["n_dropped_inbox"],
                   cause="inbox")
            mx.inc("net.bytes_sent", tr["bytes_sent"] - dig_bytes,
                   kind="model")
            mx.inc("net.bytes_sent", dig_bytes, kind="digest")
            mx.inc("net.bytes_delivered", tr["bytes_delivered"])
            mx.inc("net.bytes_rejected", tr["bytes_rejected"])
            # corruption outcomes are emitted only when nonzero, as in the
            # reference: a run without a corruption injector has no
            # transport.corrupt series
            if tr.get("n_corrupt_detected") or tr.get("n_corrupt_admitted"):
                mx.inc("transport.corrupt", tr["n_corrupt_detected"],
                       outcome="detected")
                mx.inc("transport.corrupt", tr["n_corrupt_admitted"],
                       outcome="admitted")
        mx.inc("net.msgs_lost", net.get("lost_offline", 0),
               cause="offline")
        if go is not None:
            mx.inc("gossip.msgs", go["n_accepted"], outcome="accepted")
            mx.inc("gossip.msgs", go["n_dedup"], outcome="dedup")
            mx.inc("gossip.msgs", go["n_suppressed"], outcome="suppressed")
            mx.inc("gossip.msgs", go["n_pull"], outcome="pull")
        if rp is not None:
            mx.inc("repair.digests", rp["n_digests_sent"], outcome="sent")
            mx.inc("repair.digests", rp["n_digests_recv"], outcome="recv")
            mx.inc("repair.digests", rp["n_digests_lost"], outcome="lost")
            mx.inc("repair.gaps_found", rp["n_gaps_found"])
            mx.inc("repair.resends", rp["n_resends"])
            mx.inc("repair.budget_deferred", rp["n_budget_deferred"])
            mx.inc("repair.inflight_skipped", rp["n_inflight_skipped"])
            mx.inc("repair.attempts_exhausted",
                   rp["n_attempts_exhausted"])
            mx.inc("repair.quiesced", rp["n_quiesced"])
            mx.inc("repair.bytes_digests", rp["bytes_digests"])
        fa = net.get("faults")
        if fa is not None:
            mx.inc("faults.injected", fa["n_byzantine_poisoned"],
                   kind="byzantine")
            mx.inc("faults.injected", fa["n_corrupt_detected"]
                   + fa["n_corrupt_admitted"], kind="corruption")
            mx.inc("faults.injected", fa["n_crashes"], kind="crash")
            mx.inc("faults.injected", fa["n_partition_blocked"],
                   kind="partition")
            mx.inc("faults.restarts", fa["n_restarts"])
        ad = net.get("admission")
        if ad is not None:
            mx.inc("admission.models", ad["n_admitted"],
                   outcome="admitted")
            mx.inc("admission.models", ad["n_quarantined"],
                   outcome="quarantined")
            mx.inc("admission.models", ad["n_rejected"],
                   outcome="rejected")
            mx.inc("admission.invalidated", ad["n_invalidated"])
        sv = net.get("serve")
        if sv is not None:
            mx.inc("serve.queries", sv["n_queries"], outcome="served")
            mx.inc("serve.queries", sv["n_dropped"], outcome="dropped")
            mx.inc("serve.reselections", sv["n_reselections"])
            mx.inc("serve.drift_events", sv["n_drift_events"])
            mx.set("serve.regret", sv["regret"])
            if sv["latency_p50"] is not None:
                mx.set("serve.latency_s", sv["latency_p50"], q="p50")
                mx.set("serve.latency_s", sv["latency_p99"], q="p99")
    if coverage is not None:
        mx.set("coverage.fraction", float(coverage))
        # NaN (never reached full coverage) stays NaN in the frame and
        # serializes as null (metrics.json_ready)
        mx.set("coverage.t_full",
               float("nan") if t_full is None else float(t_full))


def finalize_run(obs: Obs, result) -> None:
    """Close out a run: emit the canonical counters from the result's
    final state, and attach the collected `MetricsFrame` to
    `result.metrics`."""
    mx = obs.metrics
    emit_run_counters(mx, result.net, coverage=result.coverage,
                      t_full=result.t_full)
    if result.test_acc is not None:
        acc = [float(a) for a in result.test_acc]
        mx.set("run.test_acc_mean",
               sum(acc) / len(acc) if acc else float("nan"))
    backend = (result.spec.schedule.backend.name
               if result.spec.schedule.mode == "async" else "sync")
    result.metrics = mx.frame(meta={
        "seed": result.spec.seed, "mode": result.mode,
        "backend": backend,
        "n_clients": result.spec.data.n_clients})


# ---- compiled-backend chunk sampling -----------------------------------


class CompiledProbe:
    """Per-chunk series emission for the array-world backend: the host
    loop hands over the (tiny) counter dicts it pulled off the device at
    each chunk boundary; deltas against the previous snapshot become
    cumulative-series samples with the SAME names the event loop's live
    probes use. The tick loop itself is untouched.

    Multi-key-block caveat: blocks run sequentially over restarting time
    axes, so series samples are recorded for the FIRST block only (the
    single-block case covers every repair run and the whole parity
    tier); scalar totals accumulate across all blocks and stay exact.
    """

    def __init__(self, mx: Metrics, nbytes: int):
        self.mx = mx
        self.nb = int(nbytes)
        self._prev = {}
        self._block = 0

    def start_block(self, block_idx: int, init_sent: int,
                    init_bytes: int) -> None:
        self._block = block_idx
        self._prev = {}
        t0 = 0.0 if block_idx == 0 else None
        if init_sent:
            self.mx.inc("net.msgs_on_wire", init_sent, t=t0)
            self.mx.inc("net.bytes_on_wire", init_bytes, t=t0)

    def sample(self, t: float, cnt: dict, rc: Optional[dict],
               covered: int, total: int) -> None:
        """One chunk boundary: `cnt`/`rc` are this block's cumulative
        on-device counters (host ints), `covered`/`total` the block's
        admitted and possible (client, key) pairs."""
        t_s = t if self._block == 0 else None
        sent = int(cnt["sent"]) + (int(rc["dig_sent"]) if rc else 0)
        nbytes = int(cnt["sent"]) * self.nb \
            + (int(rc["dig_bytes"]) if rc else 0)
        acc = int(cnt["acc"])
        for name, cum in (("net.msgs_on_wire", sent),
                          ("net.bytes_on_wire", nbytes),
                          ("gossip.accepted", acc)):
            d = cum - self._prev.get(name, 0)
            if d:
                self.mx.inc(name, d, t=t_s)
            self._prev[name] = cum
        if rc is not None:
            d = int(rc["dig_sent"]) - self._prev.get("dig", 0)
            if d:
                self.mx.inc("repair.digests_on_wire", d, t=t_s)
            self._prev["dig"] = int(rc["dig_sent"])
        if self._block == 0 and total:
            self.mx.set("coverage.fraction", covered / total, t=t_s)


# ---- stock sinks (registered by repro_torch.sim.build, kind "sink") ----


def sink_metrics_json(params: dict, ctx: dict):
    """Write the run's MetricsFrame as strict JSON (NaN -> null)."""
    check_params(params, ("path",), "sink[metrics_json]")
    path = str(params.get("path", "metrics.json"))

    def sink(result):
        if result.metrics is None:
            raise ValueError(
                "metrics_json sink: the run produced no MetricsFrame "
                "(obs disabled?) — nothing to write")
        with open(path, "w") as f:
            json.dump(result.metrics.to_dict(), f, indent=2,
                      allow_nan=False)
        return path
    return sink


def sink_perfetto(params: dict, ctx: dict):
    """Write the collected event trace as Chrome/Perfetto trace-event
    JSON (open it at https://ui.perfetto.dev)."""
    check_params(params, ("path",), "sink[perfetto]")
    path = str(params.get("path", "trace.json"))
    obs = ctx.get("obs")

    def sink(result):
        if obs is None or obs.trace is None:
            raise ValueError(
                "perfetto sink: no trace was collected — set "
                "obs.trace=true (and schedule.backend='event'; the "
                "compiled backend has no per-message events)")
        doc = export_chrome_trace(
            obs.trace, n_clients=result.spec.data.n_clients,
            meta={"seed": result.spec.seed, "mode": result.mode})
        with open(path, "w") as f:
            json.dump(doc, f, allow_nan=False)
        return path
    return sink
