"""Push / push-pull gossip with per-model version vectors (port of
`repro/p2p/gossip.py`).

The seed scheduler broadcast a trained model one hop to its neighbors and
stopped — fine on a full graph, silent partitions on anything sparse.
This layer makes model dissemination an epidemic: every accepted model is
re-forwarded, and per-model VERSION VECTORS keep the epidemic from
flooding forever:

  - `have[c]`: {model_key: version} — what client c holds;
  - `peer_has[c][dst]`: what c believes dst already holds (updated on
    every send AND every receive — receiving key from src proves src has
    it), so re-broadcasts dedupe instead of ping-ponging;
  - a stale arrival (version <= held version) is counted and dropped.

`push_pull` additionally anti-entropies in reverse: when c accepts a
model from src, c pushes back everything it holds that (it believes) src
lacks — one round of pairwise reconciliation per new arrival.

Churn integration: models owned by a permanently departed client are no
longer re-forwarded (`n_suppressed`), so a churned-out client's models
stop propagating while remaining usable wherever they already landed.

The protocol only *decides* targets; the scheduler performs the sends
through the transport and reports them back via `note_sent`.

The `note_sent` CONTRACT (the lossy-link fix): the scheduler calls
`note_sent(c, dst, key)` only AFTER `transport.send` returned an arrival
time — i.e. the message is actually in flight. A link-dropped or
inbox-rejected send must NOT touch `peer_has`, otherwise the key is
never re-targetable and dissemination under loss is permanently
incomplete (not merely delayed). A message that was in flight but died
at arrival (receiver offline) is reported back via `note_lost`, which
invalidates the sender's belief so the push layer — and the anti-entropy
repair subsystem (p2p.repair) — can re-deliver it later.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from repro_torch.obs.metrics import NULL_METRICS
from repro_torch.p2p.churn import ChurnSchedule
from repro_torch.p2p.params import config_from_params
from repro_torch.p2p.transport import ModelKey

_GOSSIP_SALT = 0x41C64E6D


@dataclasses.dataclass(frozen=True)
class GossipConfig:
    mode: str = "push"          # "push" | "push_pull"
    fanout: int = 0             # forward to at most this many peers; 0 = all
    seed: int = 0


@dataclasses.dataclass
class GossipStats:
    n_accepted: int = 0
    n_dedup: int = 0            # stale version arrivals dropped
    n_suppressed: int = 0       # forwards of departed owners' models
    n_pull: int = 0             # reverse-push messages (push_pull mode)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class GossipProtocol:
    """One fleet's gossip state machine (decides who forwards what)."""

    @classmethod
    def from_params(cls, mode: str, params: dict, neighbors,
                    churn: Optional[ChurnSchedule] = None
                    ) -> "GossipProtocol":
        """Registry hook (the sim registry): the spec layer registers one name
        per gossip mode ("push", "push_pull"), so `mode` arrives as the
        component name and `params` carries the rest of GossipConfig. A
        `mode` key inside params is rejected — it would let the params
        silently contradict the component name the spec advertises."""
        if "mode" in params:
            raise ValueError(
                f"gossip params must not carry 'mode' (got "
                f"{params['mode']!r}): the mode IS the component name "
                f"({mode!r})")
        return cls(config_from_params(GossipConfig, {"mode": mode, **params},
                                      f"gossip[{mode}]"), neighbors,
                   churn=churn)

    def __init__(self, cfg: GossipConfig, neighbors,
                 churn: Optional[ChurnSchedule] = None):
        if cfg.mode not in ("push", "push_pull"):
            raise ValueError(f"unknown gossip mode {cfg.mode!r}")
        self.cfg = cfg
        self.neighbors = [list(nb) for nb in neighbors]
        self.churn = churn
        n = len(self.neighbors)
        self.have: List[Dict[ModelKey, int]] = [dict() for _ in range(n)]
        self.peer_has: List[Dict[int, Set[ModelKey]]] = [
            {dst: set() for dst in self.neighbors[c]} for c in range(n)]
        self.stats = GossipStats()
        self.metrics = NULL_METRICS  # live series (DESIGN.md §11)
        # crash-restart support (repro_torch.faults): a rejoining client
        # bumps its incarnation so its re-announcements outrank every held
        # version, and `rejoined_at` lets owner-gone checks distinguish
        # "departed for good" from "was down, came back".
        self.incarnation: List[int] = [0] * n
        self.rejoined_at: Dict[int, float] = {}

    # ---- helpers ------------------------------------------------------
    def owner_gone(self, owner: int, t: float,
                   churn: Optional[ChurnSchedule] = None) -> bool:
        """Should owner's models stop propagating as of time t? A
        departure counts unless a crash-restart rejoin at r <= t was
        recorded after it."""
        ch = self.churn if churn is None else churn
        if ch is None or not ch.departed(owner, t):
            return False
        r = self.rejoined_at.get(owner)
        return r is None or r > t

    def note_crash(self, c: int) -> None:
        """Client c lost its volatile state: it no longer holds anything,
        and its beliefs about what peers hold are gone with it."""
        self.have[c].clear()
        for known in self.peer_has[c].values():
            known.clear()

    def note_rejoin(self, c: int, t: float) -> None:
        """Client c is back after a crash: bump its incarnation (so its
        re-announced models outrank any version peers still hold), and
        drop every OTHER client's belief that c holds anything — those
        beliefs describe the pre-crash incarnation and would otherwise
        dedupe the re-dissemination c now needs."""
        self.incarnation[c] += 1
        self.rejoined_at[c] = t
        self.note_crash(c)
        for x in range(len(self.neighbors)):
            known = self.peer_has[x].get(c)
            if known:
                known.clear()

    def _targets(self, c: int, key: ModelKey, version: int, t: float,
                 exclude: int = -1) -> List[int]:
        """Neighbors that (as far as c knows) still need (key, version).

        `n_suppressed` counts individual suppressed FORWARDS (one per
        would-be target of a departed owner's model) — the same unit the
        push_pull reverse path uses, so the counter is comparable across
        modes."""
        out = [dst for dst in self.neighbors[c]
               if dst != exclude and key not in self.peer_has[c].get(dst,
                                                                     ())]
        if self.owner_gone(key[0], t):
            self.stats.n_suppressed += len(out)
            return []
        if self.cfg.fanout and len(out) > self.cfg.fanout:
            # deterministic per-(client, model, version) subsample
            rng = np.random.default_rng(
                (_GOSSIP_SALT, self.cfg.seed, c, key[0], key[1], version))
            out = sorted(rng.choice(out, self.cfg.fanout, replace=False)
                         .tolist())
        return out

    def note_sent(self, c: int, dst: int, key: ModelKey) -> None:
        """The message (c -> dst, key) is IN FLIGHT: `transport.send`
        accepted it and returned an arrival time. Push has no e2e acks,
        so c assumes in-flight implies delivered; a failed send (link
        drop / inbox rejection) must never reach this call, and an
        arrival that dies receiver-side is undone via `note_lost`."""
        self.peer_has[c].setdefault(dst, set()).add(key)

    def note_lost(self, src: int, dst: int, key: ModelKey) -> None:
        """The in-flight (src -> dst, key) never reached dst's protocol
        state (receiver offline at arrival): invalidate src's belief so
        the key stays re-targetable by later pushes and by anti-entropy
        repair."""
        self.peer_has[src].setdefault(dst, set()).discard(key)

    # ---- array-world constructors (sim/compiled.py) -------------------
    def array_state(self) -> dict:
        """Dense overlay arrays for the compiled backend: a (N, deg_max)
        int32 adjacency padded with -1. Only the stateless push epidemic
        is expressible as whole-fleet array transitions — push_pull's
        reverse reconciliation and fanout subsampling keep per-pair set
        state the array world does not carry, so they fail loudly here
        instead of silently simulating a different protocol."""
        if self.cfg.mode != "push":
            raise ValueError(
                f"the compiled backend supports gossip mode 'push' only "
                f"(got {self.cfg.mode!r}); use backend='event' for "
                f"push_pull")
        if self.cfg.fanout:
            raise ValueError(
                "the compiled backend does not support gossip fanout "
                f"subsampling (got fanout={self.cfg.fanout}); use "
                "backend='event'")
        n = len(self.neighbors)
        deg_max = max((len(nb) for nb in self.neighbors), default=0)
        adj = np.full((n, deg_max), -1, np.int32)
        for c, nb in enumerate(self.neighbors):
            adj[c, :len(nb)] = nb
        return {"adj": adj, "deg_max": deg_max}

    # ---- protocol events ---------------------------------------------
    def on_local(self, c: int, key: ModelKey, t: float,
                 version: Optional[int] = None
                 ) -> List[Tuple[int, ModelKey]]:
        """Client c produced (trained, or re-admitted after a restart) a
        model: record and push. The version defaults to c's current
        incarnation — 0 for the fault-free lifetime, bumped past every
        previously-shipped copy after each rejoin."""
        if version is None:
            version = self.incarnation[c]
        self.have[c][key] = version
        return [(dst, key) for dst in self._targets(c, key, version, t)]

    def on_receive(self, c: int, src: int, key: ModelKey, t: float,
                   version: int = 0):
        """Returns (accepted, forwards). `forwards` are (dst, key) sends
        originating at c — the epidemic push plus, in push_pull mode, the
        reverse reconciliation toward src."""
        self.peer_has[c].setdefault(src, set()).add(key)
        held = self.have[c].get(key)
        if held is not None and held >= version:
            self.stats.n_dedup += 1
            return False, []
        self.have[c][key] = version
        self.stats.n_accepted += 1
        if self.metrics.enabled:
            self.metrics.inc("gossip.accepted", 1, t=t)
        forwards = [(dst, key)
                    for dst in self._targets(c, key, version, t, exclude=src)]
        if self.cfg.mode == "push_pull":
            known_at_src = self.peer_has[c].setdefault(src, set())
            for other in sorted(self.have[c]):
                if other != key and other not in known_at_src:
                    if self.owner_gone(other[0], t):
                        self.stats.n_suppressed += 1
                        continue
                    forwards.append((src, other))
                    self.stats.n_pull += 1
        return True, forwards
