"""Query-traffic components (registry kind "traffic", DESIGN.md §14;
port of `repro/serve/traffic.py`, draw for draw the reference's).

A traffic component turns the serve seed into the full per-client query
schedule up front: `events(n_clients)` returns every
``(t, client, n_queries)`` micro-batch the scheduler will interleave
with train/gossip/repair events. Like the fault injectors (§12), every
random draw comes from a salted identity-keyed `default_rng` stream —
one stream per client, never a shared rng consumed in event order — so
the arrival process is a pure function of the seed and traces stay
bit-identical across reruns.

Stock components:

  poisson — homogeneous Poisson arrivals: per-client exponential
            inter-batch gaps at `rate / batch` batches per virtual
            second over [start, start + duration).
  bursty  — inhomogeneous (diurnal) arrivals by thinning: candidate
            arrivals at the peak rate `rate * (1 + amp)` are accepted
            with probability lam(t) / peak, where
            lam(t) = rate * (1 + amp * sin(2*pi*(t - start) / period)).
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from repro_torch.p2p.params import config_from_params

_SERVE_SALT = 0x5E21D0C7  # domain-separates serving streams from faults


def _pick_clients(fraction: float, clients, n_clients: int, seed: int,
                  domain: int, what: str) -> Tuple[int, ...]:
    """The affected-client set, mirroring the fault-injector convention:
    explicit ids win; otherwise a deterministic seed-indexed sample of
    round(fraction * n)."""
    if clients:
        out = tuple(sorted(int(c) for c in clients))
        bad = [c for c in out if not 0 <= c < n_clients]
        if bad:
            raise ValueError(f"{what}: client id(s) {bad} out of range "
                             f"[0, {n_clients})")
        return out
    k = min(int(round(float(fraction) * n_clients)), n_clients)
    if k <= 0:
        return ()
    rng = np.random.default_rng((_SERVE_SALT, seed, domain))
    return tuple(sorted(rng.choice(n_clients, size=k,
                                   replace=False).tolist()))


def _check_window(cfg, what: str) -> None:
    if cfg.rate <= 0:
        raise ValueError(f"{what}: rate must be > 0 (queries per virtual "
                         f"second), got {cfg.rate}")
    if cfg.batch < 1:
        raise ValueError(f"{what}: batch must be >= 1, got {cfg.batch}")
    if cfg.duration <= 0 or not np.isfinite(cfg.duration):
        raise ValueError(f"{what}: duration must be finite and > 0 "
                         f"(got {cfg.duration}) — an open-ended query "
                         "stream would never let the event loop drain")


@dataclasses.dataclass(frozen=True)
class PoissonTrafficConfig:
    rate: float = 20.0          # queries per virtual second per client
    batch: int = 8              # queries per micro-batch event
    start: float = 0.0
    duration: float = 10.0
    fraction: float = 1.0       # of the fleet (rounded); or explicit ids
    clients: tuple = ()
    seed: int = 0


class PoissonTraffic:
    """Homogeneous Poisson query arrivals per serving client."""

    kind = "poisson"

    @classmethod
    def from_params(cls, params: dict, n_clients: int = 0
                    ) -> "PoissonTraffic":
        return cls(config_from_params(PoissonTrafficConfig, params,
                                      "traffic[poisson]"))

    def __init__(self, cfg: PoissonTrafficConfig):
        _check_window(cfg, "traffic[poisson]")
        self.cfg = cfg

    def serving_clients(self, n_clients: int) -> Tuple[int, ...]:
        return _pick_clients(self.cfg.fraction, self.cfg.clients,
                             n_clients, self.cfg.seed, 3,
                             "traffic[poisson]")

    def events(self, n_clients: int) -> List[tuple]:
        """All (t, client, n_queries) micro-batches, sorted by time."""
        cfg = self.cfg
        end = cfg.start + cfg.duration
        mean_gap = cfg.batch / cfg.rate
        out = []
        for c in self.serving_clients(n_clients):
            rng = np.random.default_rng((_SERVE_SALT, cfg.seed, 4, c))
            t = cfg.start + float(rng.exponential(mean_gap))
            while t < end:
                out.append((t, c, cfg.batch))
                t += float(rng.exponential(mean_gap))
        out.sort()
        return out


@dataclasses.dataclass(frozen=True)
class BurstyTrafficConfig:
    rate: float = 20.0          # MEAN queries per virtual second
    batch: int = 8
    start: float = 0.0
    duration: float = 10.0
    amp: float = 0.8            # modulation depth in [0, 1]
    period: float = 4.0         # virtual seconds per diurnal cycle
    fraction: float = 1.0
    clients: tuple = ()
    seed: int = 0


class BurstyTraffic:
    """Sinusoidally modulated (diurnal) arrivals via Lewis-Shedler
    thinning of a peak-rate Poisson stream."""

    kind = "bursty"

    @classmethod
    def from_params(cls, params: dict, n_clients: int = 0
                    ) -> "BurstyTraffic":
        return cls(config_from_params(BurstyTrafficConfig, params,
                                      "traffic[bursty]"))

    def __init__(self, cfg: BurstyTrafficConfig):
        _check_window(cfg, "traffic[bursty]")
        if not 0.0 <= cfg.amp <= 1.0:
            raise ValueError(f"traffic[bursty]: amp must lie in [0, 1], "
                             f"got {cfg.amp}")
        if cfg.period <= 0:
            raise ValueError(f"traffic[bursty]: period must be > 0, "
                             f"got {cfg.period}")
        self.cfg = cfg

    def serving_clients(self, n_clients: int) -> Tuple[int, ...]:
        return _pick_clients(self.cfg.fraction, self.cfg.clients,
                             n_clients, self.cfg.seed, 5,
                             "traffic[bursty]")

    def events(self, n_clients: int) -> List[tuple]:
        cfg = self.cfg
        end = cfg.start + cfg.duration
        peak = cfg.rate * (1.0 + cfg.amp)
        mean_gap = cfg.batch / peak
        out = []
        for c in self.serving_clients(n_clients):
            rng = np.random.default_rng((_SERVE_SALT, cfg.seed, 6, c))
            t = cfg.start + float(rng.exponential(mean_gap))
            while t < end:
                lam = cfg.rate * (1.0 + cfg.amp * np.sin(
                    2.0 * np.pi * (t - cfg.start) / cfg.period))
                if rng.random() < lam / peak:
                    out.append((t, c, cfg.batch))
                t += float(rng.exponential(mean_gap))
        out.sort()
        return out
