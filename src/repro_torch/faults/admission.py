"""Validation-gated admission: the defense half of the fault subsystem
(port of `repro/faults/admission.py`; numpy on the host, whose argmax
picks the first maximal class as the reference's does).

FedPAE's exchange unit is the prediction matrix on the RECEIVER's
validation set (§III-A) — which means every arriving model can be
screened before it ever enters the selection pool, at the cost of one
argmax over a held-out slice. The gate sits in the gossip -> store path
(the driver's on_add): remote payloads are scored on a deterministic
holdout subset of the local validation labels and triaged into

  admitted     — enters the store (and therefore the NSGA-II pool);
  quarantined  — borderline: kept OUT of the store (side pen), re-scored
                 if a fresh copy ever arrives; conservative by design —
                 a borderline model the gossip never refreshes stays out;
  rejected     — discarded; if an earlier copy already occupies a store
                 slot (a rejoined owner's re-announcement turned bad, a
                 corrupt-admitted refresh), that slot is invalidated —
                 masked off and generation-bumped, so the engine's cached
                 chromosome detects the stale member and falls back
                 (core/engine.py `_stale`).

The holdout slice is disjoint-by-sampling from nothing — it IS part of
the validation set the selection objectives use; what matters is that
the gate's decision is a cheap threshold, not that it is held out from
selection. Thresholds default to chance multiples (reject below 1.5/C,
admit above 2.5/C), so the gate transfers across worlds without
re-tuning; both are absolute-overridable per spec.

Local models bypass the gate: a client trusts its own training, and the
negative-transfer fallback (local-only serving) must never be gated off.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

_GATE_SALT = 0x51AF3D29


@dataclasses.dataclass(frozen=True)
class AdmissionConfig:
    holdout_frac: float = 0.25
    reject_below: Optional[float] = None  # None -> 1.5 / n_classes
    admit_above: Optional[float] = None   # None -> 2.5 / n_classes
    seed: int = 0


@dataclasses.dataclass
class AdmissionStats:
    n_screened: int = 0
    n_admitted: int = 0
    n_quarantined: int = 0
    n_rejected: int = 0
    n_invalidated: int = 0   # rejected while resident: slot masked off

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class ValidationGate:
    """One client's screen: a deterministic holdout slice of its local
    validation labels plus the resolved thresholds."""

    def __init__(self, cfg: AdmissionConfig, client: int,
                 labels: np.ndarray, n_classes: int):
        if not 0.0 < cfg.holdout_frac <= 1.0:
            raise ValueError("admission holdout_frac must lie in (0, 1]")
        y = np.asarray(labels)
        valid = np.flatnonzero(y >= 0)  # labels are -1-padded past n_val
        if len(valid) == 0:
            raise ValueError(
                f"admission gate for client {client}: no validation "
                "labels to screen against")
        rng = np.random.default_rng((_GATE_SALT, cfg.seed, client))
        k = max(1, int(round(cfg.holdout_frac * len(valid))))
        self.holdout = np.sort(rng.permutation(valid)[:k])
        self.y = y[self.holdout]
        chance = 1.0 / max(1, n_classes)
        self.reject_below = (cfg.reject_below
                             if cfg.reject_below is not None
                             else 1.5 * chance)
        self.admit_above = (cfg.admit_above
                            if cfg.admit_above is not None
                            else 2.5 * chance)
        if self.reject_below > self.admit_above:
            raise ValueError(
                f"admission thresholds inverted: reject_below="
                f"{self.reject_below} > admit_above={self.admit_above}")
        self.pen: dict = {}  # gid -> last screening acc (quarantined)

    def screen_acc(self, preds: np.ndarray) -> float:
        p = np.asarray(preds)[self.holdout]
        return float((p.argmax(1) == self.y).mean())

    def screen(self, gid: int, preds: np.ndarray):
        acc = self.screen_acc(preds)
        if acc < self.reject_below:
            return "rejected", acc
        if acc < self.admit_above:
            return "quarantined", acc
        return "admitted", acc


class AdmissionController:
    """Fleet-wide admission state: one gate per client, one shared stats
    block (surfaced as `net["admission"]` and the
    `admission.models{outcome=...}` metrics)."""

    def __init__(self, cfg: AdmissionConfig, stores):
        self.cfg = cfg
        self.gates = {s.client: ValidationGate(cfg, s.client, s.labels,
                                               s.n_classes)
                      for s in stores}
        self.stats = AdmissionStats()

    def screen(self, c: int, gid: int, preds, store) -> str:
        """Triage one arriving remote payload for client c. The caller
        stores the payload only on "admitted"; rejection of a gid that
        already occupies a slot (a refresh turned bad) invalidates it."""
        gate = self.gates[c]
        outcome, acc = gate.screen(gid, preds)
        self.stats.n_screened += 1
        if outcome == "admitted":
            self.stats.n_admitted += 1
            gate.pen.pop(gid, None)
        elif outcome == "quarantined":
            self.stats.n_quarantined += 1
            gate.pen[gid] = acc
        else:
            self.stats.n_rejected += 1
            gate.pen.pop(gid, None)
            if store.invalidate(gid):
                self.stats.n_invalidated += 1
        return outcome

    def on_crash(self, c: int) -> None:
        """The crashed client's quarantine pen is volatile state too."""
        self.gates[c].pen.clear()

    def as_dict(self) -> dict:
        return self.stats.as_dict()
