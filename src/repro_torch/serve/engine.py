"""The serving engine: answer query micro-batches from the currently-
selected ensemble, monitor serving accuracy, trigger re-selection
(DESIGN.md §14; port of `repro/serve/engine.py`). The bookkeeping —
query draws, votes over stored rows, the monitor window, regret and
latency percentiles — stays in numpy on the host as in the reference, so
its sums and percentiles are the reference's bit for bit; model forwards
run where the models live (the card), and the dynamic policy's
competence runs in torch on the selection engine's device.

The scheduler owns the clock and hands over "query" / "drift" events;
this engine owns everything else about serving:

  answering — policy "ensemble" serves the client's current chromosome
    (`SelectionEngine.chromosome`, including the local-only negative-
    transfer fallback) through the store's masked batched-forward path
    (`PredictionStore.predictions`, one batched multi-model forward per
    family); policy "dynamic" routes through the KNORA-style DES in
    `core.dynamic` — per-query competence over the K nearest validation
    samples picks each query's top-k models.
  the monitor — a sliding window of per-query correct bits per client.
    Once warm, a window accuracy more than `threshold` below the
    window's own running PEAK requests a re-selection (returned to the
    scheduler, which routes it through the standard debounced select
    machinery), at most once per `debounce` virtual seconds per client.
    Re-selection resets the window and its peak: the new ensemble is
    scored on its own serving record, not its predecessor's.
  drift — label shift recomposes the client's query class weights and
    RESAMPLES its validation rows to the shifted distribution (so the
    next selection optimizes for the world being served); covariate
    shift transforms query and validation inputs and re-runs the
    forwards. Both refresh through `SelectionEngine.refresh_validation`,
    which keeps the device-resident statistics coherent.
  regret — from the first monitor trigger per client, the pre-drift
    chromosome is frozen as a shadow arm and every later batch scores
    both; `regret` integrates (live - frozen) accuracy over virtual
    time — the area between the monitored and stale-ensemble curves.
  latency — a per-client single-server queue in virtual time:
    `service_time` per query, batches queue behind unfinished work;
    p50/p99 are per-query percentiles.

Determinism: every query draw comes from a salted
`default_rng((SALT, seed, domain, client, batch))` stream keyed by the
batch identity, never from a shared rng consumed in event order —
serving traces are pure functions of the serve seed, like fault
schedules (§12). The compiled backend rejects serving loudly
(`array_params`), matching the fault controller's contract.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List, Optional

import numpy as np

from repro_torch.obs.metrics import NULL_METRICS
from repro_torch.serve.traffic import _SERVE_SALT

POLICIES = ("ensemble", "dynamic")


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    policy: str = "ensemble"
    monitor: bool = True
    window: int = 64            # per-query correct bits per client
    threshold: float = 0.1      # breach: window acc < peak - threshold
    debounce: float = 1.0       # min virtual seconds between triggers
    service_time: float = 1e-4  # virtual seconds of compute per query
    des_k: Optional[int] = None       # dynamic policy vote size
    des_neighbors: int = 7            # KNORA competence region size
    seed: int = 0


@dataclasses.dataclass
class ServeStats:
    n_queries: int = 0          # answered
    n_dropped: int = 0          # arrived while the client was offline
    n_batches: int = 0
    n_reselections: int = 0     # monitor-triggered re-selections
    n_drift_events: int = 0
    regret: float = 0.0         # integral of (live - frozen) accuracy

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class ServingEngine:
    """Per-fleet serving state machine driven by scheduler events."""

    def __init__(self, cfg: ServeConfig, traffic, drifts, n_clients: int,
                 n_classes: int, stores, engine, query_pools=None,
                 metrics=None):
        if cfg.policy not in POLICIES:
            raise ValueError(f"unknown serve policy {cfg.policy!r}; "
                             f"choose from {POLICIES}")
        if cfg.window < 1:
            raise ValueError(f"serve.window must be >= 1, got {cfg.window}")
        if stores is None:
            raise ValueError("serving needs prediction stores — "
                             'data.kind="none" builds none')
        if engine is None:
            raise ValueError("serving needs the selection engine "
                             "(selection.enabled=True): queries are "
                             "answered from selected ensembles")
        if cfg.policy == "dynamic" and query_pools is None:
            raise ValueError(
                'serve.policy="dynamic" needs real query inputs for the '
                "KNORA competence region; the prediction_world has none "
                '— use policy="ensemble" or an image world')
        self.cfg = cfg
        self.traffic = traffic
        self.drifts = list(drifts)
        self.n_clients = n_clients
        self.n_classes = n_classes
        self.stores = stores
        self.engine = engine
        # image worlds: per-client (x_pool, y_pool) to draw queries from;
        # None = prediction_world, where queries index validation rows
        self.query_pools = query_pools
        self.metrics = metrics if metrics is not None else NULL_METRICS
        self.stats = ServeStats()
        self._weights: Dict[int, np.ndarray] = {}   # post-drift class w
        self._transforms: Dict[int, list] = {}      # covariate pipeline
        self._window: Dict[int, deque] = {}
        self._peak: Dict[int, float] = {}
        self._last_trigger: Dict[int, float] = {}
        self._busy_until: Dict[int, float] = {}
        self._frozen: Dict[int, np.ndarray] = {}    # shadow chromosomes
        self._shadow_t: Dict[int, float] = {}       # last regret sample t
        self._latency: List[tuple] = []             # (latency_s, n_queries)
        self._final_window: Dict[int, float] = {}   # last warm window acc

    # ---- event generation ---------------------------------------------
    def initial_events(self) -> list:
        """Everything serving pushes onto the heap up front: query
        micro-batches (per-client batch indices key the rng streams) and
        one drift event per component."""
        ev = []
        counts: Dict[int, int] = {}
        for t, c, nq in self.traffic.events(self.n_clients):
            b = counts.get(c, 0)
            counts[c] = b + 1
            ev.append((t, "query", c, (b, nq)))
        for di, d in enumerate(self.drifts):
            ev.append((d.at, "drift", -1, di))
        return ev

    # ---- query path ---------------------------------------------------
    def _draw_queries(self, c: int, batch_idx: int, n: int):
        """(x_q or None, row_idx or None, y_q): the micro-batch, drawn
        from the client's (possibly drifted) query distribution."""
        rng = np.random.default_rng(
            (_SERVE_SALT, self.cfg.seed, 9, c, batch_idx))
        w = self._weights.get(c)
        if self.query_pools is None:
            store = self.stores[c]
            y_pool = np.asarray(store.labels[:store.n_val])
        else:
            _, y_pool = self.query_pools[c]
        if w is None:
            idx = rng.integers(0, len(y_pool), size=n)
        else:
            p = w[y_pool]
            total = p.sum()
            # a drift can put zero mass on every pooled label; fall back
            # to uniform rather than serving an empty batch
            p = p / total if total > 0 else np.full(len(y_pool),
                                                    1.0 / len(y_pool))
            idx = rng.choice(len(y_pool), size=n, p=p)
        idx = np.asarray(idx, np.int64)
        y_q = np.asarray(y_pool)[idx]
        if self.query_pools is None:
            return None, idx, y_q
        x_pool, _ = self.query_pools[c]
        x_q = np.asarray(x_pool)[idx]
        for tf in self._transforms.get(c, ()):
            x_q = tf(x_q)
        return x_q, None, y_q

    def _vote_labels(self, c: int, chrom: np.ndarray,
                     x_q: Optional[np.ndarray],
                     row_idx: Optional[np.ndarray]) -> np.ndarray:
        """Mean-prob vote of the chromosome's members on the batch —
        `SelectionEngine.serve`'s decode, but reusable for the frozen
        shadow arm and for validation-row queries (prediction worlds
        gather stored rows instead of running forwards)."""
        store = self.stores[c]
        mask = (chrom > 0.5) & store.mask
        sel = chrom * mask
        if row_idx is not None:
            probs = store.preds[:, row_idx]          # (cap, n, C) gather
            probs = probs * mask[:, None, None]
        else:
            probs = store.predictions(x_q, mask=mask)
        vote = (sel[:, None, None] * probs).sum(0) / max(1, int(mask.sum()))
        return np.asarray(vote).argmax(-1)

    def _dynamic_labels(self, c: int, x_q: np.ndarray) -> np.ndarray:
        """KNORA-style DES decode (core.dynamic): competence of every
        present model over the query's nearest validation samples, then a
        per-query top-k vote."""
        import torch

        from repro_torch.core.dynamic import (dynamic_ensemble_predict,
                                              knn_competence)
        store = self.stores[c]
        nv = store.n_val
        labels = store.labels[:nv]
        mask = store.mask
        correct = ((store.preds[:, :nv].argmax(-1) == labels[None, :])
                   & mask[:, None]).astype(np.float32)
        K = max(1, min(self.cfg.des_neighbors, nv))
        dev = self.engine.device
        comp = knn_competence(torch.as_tensor(x_q, device=dev),
                              torch.as_tensor(store.x_val, device=dev),
                              torch.as_tensor(correct, device=dev), K=K)
        # absent slots lose
        comp = torch.where(torch.as_tensor(mask, device=dev)[None, :],
                           comp, -1.0)
        k_vote = self.cfg.des_k if self.cfg.des_k is not None \
            else self.engine.ensemble_k
        k_vote = max(1, min(int(k_vote), max(1, store.n_present)))
        probs = store.predictions(x_q, mask=mask)
        return dynamic_ensemble_predict(
            torch.as_tensor(probs, device=dev), comp,
            k=k_vote).cpu().numpy()

    def on_query(self, c: int, t: float, batch_idx: int, n: int) -> bool:
        """Answer one micro-batch. Returns True when the accuracy monitor
        requests a re-selection for this client (the scheduler routes it
        through the standard debounced select grid)."""
        cfg = self.cfg
        x_q, row_idx, y_q = self._draw_queries(c, batch_idx, n)
        if cfg.policy == "dynamic":
            pred = self._dynamic_labels(c, x_q)
            chrom = None
        else:
            chrom = self.engine.chromosome(c)
            pred = self._vote_labels(c, chrom, x_q, row_idx)
        correct = (pred == y_q)
        acc_live = float(correct.mean())
        self.stats.n_queries += n
        self.stats.n_batches += 1

        # virtual-time latency: one server per client, batches queue
        start = max(t, self._busy_until.get(c, 0.0))
        fin = start + cfg.service_time * n
        self._busy_until[c] = fin
        self._latency.append((fin - t, n))

        # stale-ensemble regret: once a shadow chromosome is frozen,
        # integrate the accuracy gap over the inter-batch interval
        frozen = self._frozen.get(c)
        if frozen is not None and chrom is not None:
            acc_frozen = float(
                (self._vote_labels(c, frozen, x_q, row_idx) == y_q).mean())
            dt = t - self._shadow_t[c]
            self.stats.regret += (acc_live - acc_frozen) * dt
            self._shadow_t[c] = t

        # sliding-window monitor
        win = self._window.get(c)
        if win is None:
            win = self._window[c] = deque(maxlen=cfg.window)
        win.extend(correct.tolist())
        if len(win) < cfg.window:
            return False
        win_acc = float(sum(win)) / len(win)
        self._final_window[c] = win_acc
        mx = self.metrics
        if mx.enabled:
            mx.set("serve.window_acc", win_acc, t=t)
        peak = self._peak.get(c, 0.0)
        if win_acc > peak:
            self._peak[c] = win_acc
            return False
        if not cfg.monitor or win_acc >= peak - cfg.threshold:
            return False
        if t - self._last_trigger.get(c, -np.inf) < cfg.debounce:
            return False
        self._last_trigger[c] = t
        self.stats.n_reselections += 1
        if chrom is not None and c not in self._frozen:
            self._frozen[c] = chrom.copy()
            self._shadow_t[c] = t
        return True

    def note_dropped(self, c: int, n: int) -> None:
        """The batch arrived while the client was offline (crash/churn)."""
        self.stats.n_dropped += n

    def note_selected(self, clients, t: float) -> None:
        """A re-selection landed for these clients: the window (and its
        peak) restart so the fresh ensemble is scored on its own record,
        never breached by its predecessor's slump."""
        for c in clients:
            win = self._window.get(c)
            if win is not None:
                win.clear()
            self._peak.pop(c, None)

    # ---- drift path ---------------------------------------------------
    def on_drift(self, di: int, t: float) -> None:
        """Apply drift component `di`: shift the query distribution of
        its affected clients and refresh their validation state so the
        next selection optimizes for the shifted world."""
        drift = self.drifts[di]
        self.stats.n_drift_events += 1
        C = self.n_classes
        for c in drift.clients_affected(self.n_clients):
            store = self.stores[c]
            nv = store.n_val
            if drift.kind == "label_shift":
                base = self._weights.get(c)
                w = drift.weights(C) if base is None \
                    else base * drift.weights(C)
                self._weights[c] = w / w.sum()
                rng = np.random.default_rng(
                    (_SERVE_SALT, self.cfg.seed, 10, di, c))
                y = np.asarray(store.labels[:nv])
                p = self._weights[c][y]
                total = p.sum()
                if total <= 0:
                    continue  # no validation mass under the new weights
                ridx = rng.choice(nv, size=nv, p=p / total)
                self.engine.refresh_validation(
                    c, store.x_val[ridx], y[ridx], store.preds[:, ridx])
            else:  # covariate shift: transform inputs, re-run forwards
                self._transforms.setdefault(c, []).append(drift.transform)
                x_new = drift.transform(store.x_val)
                preds = store.predictions(x_new, mask=store.mask)
                self.engine.refresh_validation(
                    c, x_new, np.asarray(store.labels[:nv]), preds)

    # ---- reporting -----------------------------------------------------
    def latency_percentiles(self) -> tuple:
        """(p50, p99) per-QUERY virtual-time latency, or (None, None)
        before any batch was served."""
        if not self._latency:
            return None, None
        lats = np.repeat([l for l, _ in self._latency],
                         [n for _, n in self._latency])
        return (float(np.percentile(lats, 50)),
                float(np.percentile(lats, 99)))

    def stats_dict(self) -> dict:
        """The `net["serve"]` section: scalar counters both backends'
        finalize derivation (`obs.probes.emit_run_counters`) reads."""
        p50, p99 = self.latency_percentiles()
        wins = sorted(self._final_window)
        d = self.stats.as_dict()
        d["regret"] = round(d["regret"], 6)
        d["latency_p50"] = p50
        d["latency_p99"] = p99
        d["window_acc"] = (round(float(np.mean(
            [self._final_window[c] for c in wins])), 6) if wins else None)
        return d

    def array_params(self):
        """The compiled backend cannot serve: queries run real forwards
        (or stored-row gathers) per event and the monitor drives
        event-granular re-selection. Always raises, mirroring
        `FaultController.array_params` (DESIGN.md §12)."""
        raise ValueError(
            "the compiled backend does not support the serve section "
            f"(traffic={type(self.traffic).kind!r}, "
            f"policy={self.cfg.policy!r}): query answering and the "
            "accuracy monitor are event-granular; use "
            "schedule.backend='event'")
