"""Distribution-drift components (registry kind "drift", DESIGN.md §14;
port of `repro/serve/drift.py`).

A drift component fires once at a scheduled virtual time and reshapes
the query stream of a deterministic client subset — and, crucially, the
GROUND TRUTH the serving accuracy monitor scores against, which is what
lets a threshold breach trigger re-selection. Following the
fault-injector idiom (§12): frozen configs validated through
`config_from_params`, and every random decision drawn from a salted
identity-keyed `default_rng` stream, never a shared event-order rng.

Stock components:

  label_shift     — the post-drift query label distribution interpolates
                    between uniform and a point mass spread over
                    `classes`: w = (1 - skew) * uniform
                    + skew * onehot(classes) / len(classes). Affects
                    which samples are queried AND the client's
                    validation distribution (the serving engine
                    resamples the validation rows accordingly, so
                    re-selection optimizes for the shifted world).
  covariate_shift — a pure deterministic input transform applied to
                    queries and to the validation inputs:
                    x' = (1 - severity) * x + severity * (1 - x)
                    (contrast-inverting blend; shape-agnostic, composes
                    cumulatively). Image worlds only — the
                    prediction_world has no real inputs to transform.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from repro_torch.p2p.params import config_from_params
from repro_torch.serve.traffic import _pick_clients


@dataclasses.dataclass(frozen=True)
class LabelShiftConfig:
    at: float = 5.0             # virtual time the shift lands
    classes: tuple = (0,)       # classes the post-drift mass favors
    skew: float = 1.0           # 0 = no shift, 1 = all mass on `classes`
    fraction: float = 1.0       # of the fleet (rounded); or explicit ids
    clients: tuple = ()
    seed: int = 0


class LabelShiftDrift:
    """Query label distribution shifts toward a class subset at `at`."""

    kind = "label_shift"

    @classmethod
    def from_params(cls, params: dict, n_clients: int = 0
                    ) -> "LabelShiftDrift":
        return cls(config_from_params(LabelShiftConfig, params,
                                      "drift[label_shift]"))

    def __init__(self, cfg: LabelShiftConfig):
        if not cfg.classes:
            raise ValueError("drift[label_shift]: classes must be a "
                             "non-empty class-id list")
        if not 0.0 <= cfg.skew <= 1.0:
            raise ValueError(f"drift[label_shift]: skew must lie in "
                             f"[0, 1], got {cfg.skew}")
        if cfg.at < 0:
            raise ValueError(f"drift[label_shift]: at must be >= 0, "
                             f"got {cfg.at}")
        self.cfg = cfg

    @property
    def at(self) -> float:
        return float(self.cfg.at)

    def clients_affected(self, n_clients: int) -> Tuple[int, ...]:
        return _pick_clients(self.cfg.fraction, self.cfg.clients,
                             n_clients, self.cfg.seed, 7,
                             "drift[label_shift]")

    def weights(self, n_classes: int) -> np.ndarray:
        """(C,) post-drift class sampling weights, summing to 1."""
        cls_ids = sorted(int(k) for k in self.cfg.classes)
        bad = [k for k in cls_ids if not 0 <= k < n_classes]
        if bad:
            raise ValueError(f"drift[label_shift]: class id(s) {bad} out "
                             f"of range [0, {n_classes})")
        w = np.full((n_classes,), (1.0 - self.cfg.skew) / n_classes,
                    np.float64)
        w[cls_ids] += self.cfg.skew / len(cls_ids)
        return w / w.sum()


@dataclasses.dataclass(frozen=True)
class CovariateShiftConfig:
    at: float = 5.0
    severity: float = 0.5       # blend weight toward the inverted input
    fraction: float = 1.0
    clients: tuple = ()
    seed: int = 0


class CovariateShiftDrift:
    """Query inputs (and validation inputs) transform at `at`."""

    kind = "covariate_shift"

    @classmethod
    def from_params(cls, params: dict, n_clients: int = 0
                    ) -> "CovariateShiftDrift":
        return cls(config_from_params(CovariateShiftConfig, params,
                                      "drift[covariate_shift]"))

    def __init__(self, cfg: CovariateShiftConfig):
        if not 0.0 < cfg.severity <= 1.0:
            raise ValueError(f"drift[covariate_shift]: severity must lie "
                             f"in (0, 1], got {cfg.severity}")
        if cfg.at < 0:
            raise ValueError(f"drift[covariate_shift]: at must be >= 0, "
                             f"got {cfg.at}")
        self.cfg = cfg

    @property
    def at(self) -> float:
        return float(self.cfg.at)

    def clients_affected(self, n_clients: int) -> Tuple[int, ...]:
        return _pick_clients(self.cfg.fraction, self.cfg.clients,
                             n_clients, self.cfg.seed, 8,
                             "drift[covariate_shift]")

    def transform(self, x: np.ndarray) -> np.ndarray:
        """Pure deterministic input shift (no rng: the SAME sample always
        maps to the same shifted sample, so validation refreshes and
        query-time transforms agree exactly)."""
        s = self.cfg.severity
        x = np.asarray(x, np.float32)
        return ((1.0 - s) * x + s * (1.0 - x)).astype(np.float32)
