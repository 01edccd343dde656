"""Client churn: who is reachable when (port of `repro/p2p/churn.py`).

FLGo's system simulator (WwZzz/FLGo, `system_simulator/default_simulator`)
models availability as a per-client rate drawn from a lognormal —
`T_c ~ LogNormal(0, -ln(1 - beta))`, `p_c = T_c / max T` — with
independent per-round coin flips. We reproduce that shape on the async
simulator's continuous virtual clock by discretizing time into
`window`-sized slots and flipping a deterministic per-(client, slot) coin
with probability `p_c`, plus two lifecycle edges the round-based
simulators don't need:

  - staggered JOIN times (a client trains and gossips nothing before it
    joins);
  - permanent DEPARTURE (dropout): a departed client never sends or
    receives again, and the gossip layer stops re-broadcasting its models
    (`departed`) so stale ownership does not keep flooding the network.

All draws come from seed-indexed streams (never from call order), so a
schedule is a pure function of (config, n_clients).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.p2p.params import config_from_params

_CHURN_SALT = 0x5DEECE66


@dataclasses.dataclass(frozen=True)
class ChurnConfig:
    availability_beta: float = 0.1  # FLGo LN intensity; 0 = always on
    window: float = 1.0             # availability slot width (virtual time)
    join_spread: float = 0.0        # join times ~ U[0, join_spread)
    leave_prob: float = 0.0         # P(client departs permanently)
    leave_scale: float = 4.0        # departure time ~ join + U[1, 2)*scale
    seed: int = 0


class ChurnSchedule:
    """Deterministic availability/join/leave schedule for one fleet."""

    @classmethod
    def from_params(cls, params: dict, n_clients: int) -> "ChurnSchedule":
        """Registry hook (the sim registry): build from a tagged component's
        params dict."""
        return cls(config_from_params(ChurnConfig, params, "churn"),
                   n_clients)

    def __init__(self, cfg: ChurnConfig, n_clients: int):
        self.cfg = cfg
        self.n_clients = n_clients
        rng = np.random.default_rng((_CHURN_SALT, cfg.seed, n_clients))
        eps = 1e-6
        beta = min(max(cfg.availability_beta, 0.0), 1.0 - 2 * eps)
        if beta > 0:
            tks = rng.lognormal(0.0, -np.log(1.0 - beta - eps), n_clients)
            self.p_online = tks / tks.max()
        else:
            self.p_online = np.ones(n_clients)
        self.join = (rng.uniform(0.0, cfg.join_spread, n_clients)
                     if cfg.join_spread > 0 else np.zeros(n_clients))
        leaves = rng.random(n_clients) < cfg.leave_prob
        leave_t = self.join + cfg.leave_scale * rng.uniform(1.0, 2.0,
                                                            n_clients)
        self.leave = np.where(leaves, leave_t, np.inf)

    def is_online(self, c: int, t: float) -> bool:
        """Joined, not departed, and this availability window's coin came
        up heads (per-(client, window) stream — order-independent)."""
        if t < self.join[c] or t >= self.leave[c]:
            return False
        if self.p_online[c] >= 1.0:
            return True
        w = int(np.floor(t / self.cfg.window))
        coin = np.random.default_rng(
            (_CHURN_SALT, self.cfg.seed, 1, c, w)).random()
        return coin < self.p_online[c]

    def departed(self, c: int, t: float) -> bool:
        """Has client c permanently left the network by time t?"""
        return t >= self.leave[c]

    # ---- array-world constructors (sim/compiled.py) -------------------
    def leave_ticks(self, tick: float) -> np.ndarray:
        """(N,) int32 first tick index at which each client counts as
        departed (`t >= leave` on the tick grid); INT32_MAX for never."""
        out = np.full(self.n_clients, np.iinfo(np.int32).max, np.int64)
        finite = np.isfinite(self.leave)
        out[finite] = np.ceil(self.leave[finite] / tick - 1e-9).astype(
            np.int64)
        return np.minimum(out, np.iinfo(np.int32).max).astype(np.int32)

    def online_matrix(self, t0_tick: int, n_ticks: int,
                      tick: float) -> np.ndarray:
        """(n_ticks, N) bool: `is_online(c, t)` evaluated at every tick
        time in [t0_tick, t0_tick + n_ticks) — the SAME join/leave edges
        and the SAME per-(client, window) coin streams as the scalar
        method, so the compiled backend's availability is the event
        loop's availability sampled on the tick grid."""
        ts = (np.arange(t0_tick, t0_tick + n_ticks) * tick)
        out = (ts[:, None] >= self.join[None, :]) & \
              (ts[:, None] < self.leave[None, :])
        flappy = np.flatnonzero(self.p_online < 1.0)
        if flappy.size:
            wins = np.floor(ts / self.cfg.window).astype(np.int64)
            uniq = np.unique(wins)
            coins = np.empty((uniq.size, flappy.size))
            for i, w in enumerate(uniq):
                for j, c in enumerate(flappy):
                    coins[i, j] = np.random.default_rng(
                        (_CHURN_SALT, self.cfg.seed, 1, int(c),
                         int(w))).random()
            on = coins < self.p_online[flappy][None, :]
            out[:, flappy] &= on[np.searchsorted(uniq, wins), :]
        return out
