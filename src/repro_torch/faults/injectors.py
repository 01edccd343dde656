"""Deterministic fault injectors (DESIGN.md §12; port of
`repro/faults/injectors.py`, draw for draw the reference's).

Each injector is a tagged component (registry kind "fault") with a
frozen config validated through `config_from_params` — an unknown param
in a serialized spec fails loudly, never becomes a default. Every random
decision comes from a salted fold_in-style `default_rng` stream keyed by
the injector seed plus the decision's identity (client, edge, payload,
delivery attempt), NEVER from a shared rng consumed in event order — so
a fault schedule is a pure function of the seed, and traces stay
bit-identical across reruns regardless of heap tie-breaking.

The four stock injectors:

  byzantine     — a deterministic subset of clients gossips poisoned
                  prediction matrices. Modes: "label_flip" (class
                  permutation of the true matrix — model-poisoning
                  flavor), "uniform_noise" (row-normalized noise), and
                  "confident_wrong" (colluding high-confidence votes on
                  a row-indexed wrong class — the strongest attack on an
                  ungated mean-vote ensemble).
  corruption    — per-delivery bit-flip probability on the wire; a cheap
                  checksum catches a `detect_prob` fraction (counted as
                  corrupt-detected and discarded), the rest are admitted
                  corrupted (counted as corrupt-admitted).
  crash_restart — a client loses its volatile state (prediction store,
                  gossip version vectors) at a deterministic crash time
                  and rejoins after a downtime window — distinct from
                  churn's permanent departures and windowed offline
                  flaps, which never lose state.
  partition     — cut an edge set (or the halves bisection) for a time
                  window; after healing, anti-entropy repair closes the
                  accumulated gaps.

The `FaultController` (controller.py) aggregates at most one injector of
each kind into the single object the scheduler consults.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from repro_torch.p2p.params import config_from_params

_FAULT_SALT = 0x6B43A9B5  # domain-separates fault streams from other rngs

BYZANTINE_MODES = ("label_flip", "uniform_noise", "confident_wrong")
PARTITION_MODES = ("halves", "edges")


def _pick_clients(fraction: float, clients, n_clients: int, seed: int,
                  domain: int, what: str) -> Tuple[int, ...]:
    """The affected-client set: explicit ids win; otherwise a
    deterministic seed-indexed sample of round(fraction * n)."""
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
    rng = np.random.default_rng((_FAULT_SALT, seed, domain))
    return tuple(sorted(rng.choice(n_clients, size=k,
                                   replace=False).tolist()))


# ---- byzantine ---------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ByzantineConfig:
    fraction: float = 0.0       # of the fleet (rounded); or explicit ids
    clients: tuple = ()
    mode: str = "confident_wrong"
    confidence: float = 0.9     # confident_wrong one-hot mass
    seed: int = 0


class ByzantineFault:
    """Adversarial owners: every prediction matrix they ship (and every
    test-set forward a receiver runs through their entry) is poisoned."""

    kind = "byzantine"

    @classmethod
    def from_params(cls, params: dict, n_clients: int) -> "ByzantineFault":
        return cls(config_from_params(ByzantineConfig, params,
                                      "fault[byzantine]"), n_clients)

    def __init__(self, cfg: ByzantineConfig, n_clients: int):
        if cfg.mode not in BYZANTINE_MODES:
            raise ValueError(f"unknown byzantine mode {cfg.mode!r}; "
                             f"choose from {BYZANTINE_MODES}")
        self.cfg = cfg
        self.clients = frozenset(_pick_clients(
            cfg.fraction, cfg.clients, n_clients, cfg.seed, 1,
            "fault[byzantine]"))
        # colluding target-class offset shared by every byzantine owner
        # (confident_wrong): the standard worst case for mean-vote
        # ensembles is coordinated attackers, not independent ones
        self._collusion = int(np.random.default_rng(
            (_FAULT_SALT, cfg.seed, 11)).integers(1 << 30))

    def poison(self, preds: np.ndarray, receiver: int,
               gid: int) -> np.ndarray:
        """(V, C) true probabilities -> (V, C) poisoned. Deterministic
        per (seed, receiver, gid, row count); shape-agnostic so the same
        transform applies to validation matrices and test-set serving."""
        p = np.asarray(preds, np.float32)
        V, C = p.shape
        if self.cfg.mode == "label_flip":
            r = 1 + int(np.random.default_rng(
                (_FAULT_SALT, self.cfg.seed, 12, gid))
                .integers(max(1, C - 1)))
            return np.roll(p, r, axis=1)
        if self.cfg.mode == "uniform_noise":
            rng = np.random.default_rng(
                (_FAULT_SALT, self.cfg.seed, 13, receiver, gid, V))
            q = rng.random((V, C), dtype=np.float32) + 1e-3
            return (q / q.sum(1, keepdims=True)).astype(np.float32)
        # confident_wrong: all byzantine owners vote the SAME row-indexed
        # class with high confidence — wrong for (C-1)/C of the rows
        conf = float(self.cfg.confidence)
        r = 1 + self._collusion % max(1, C - 1)
        out = np.full((V, C), (1.0 - conf) / max(1, C - 1), np.float32)
        out[np.arange(V), (np.arange(V) + r) % C] = conf
        return out


# ---- wire corruption ---------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CorruptionConfig:
    flip_prob: float = 0.0      # per-delivery corruption probability
    detect_prob: float = 1.0    # checksum coverage of corrupted payloads
    seed: int = 0


class CorruptionFault:
    """Payload corruption on the wire. `check` is consulted once per
    model-message DELIVERY (a per-(edge, key, version) counter folds the
    delivery index into the stream, so retries draw fresh coins but stay
    order-independent)."""

    kind = "corruption"

    @classmethod
    def from_params(cls, params: dict, n_clients: int = 0
                    ) -> "CorruptionFault":
        return cls(config_from_params(CorruptionConfig, params,
                                      "fault[corruption]"))

    def __init__(self, cfg: CorruptionConfig):
        if not 0.0 <= cfg.flip_prob <= 1.0 or \
                not 0.0 <= cfg.detect_prob <= 1.0:
            raise ValueError("fault[corruption]: flip_prob and "
                             "detect_prob must lie in [0, 1]")
        self.cfg = cfg
        self._deliveries: dict = {}

    def check(self, src: int, dst: int, key, version: int
              ) -> Optional[str]:
        """None (intact) | "detected" (checksum caught it; discard) |
        "admitted" (corrupted payload slipped through)."""
        owner, idx = key
        dk = (src, dst, owner, idx, version)
        n = self._deliveries.get(dk, 0)
        self._deliveries[dk] = n + 1
        rng = np.random.default_rng(
            (_FAULT_SALT, self.cfg.seed, 21, src, dst, owner, idx,
             version, n))
        if rng.random() >= self.cfg.flip_prob:
            return None
        return "detected" if rng.random() < self.cfg.detect_prob \
            else "admitted"

    def corrupt(self, preds: np.ndarray, receiver: int,
                gid: int) -> np.ndarray:
        """What an admitted-corrupt (V, C) payload decodes to: rows
        scrambled and mixed with noise, still row-normalized (bit flips
        in a probability matrix, not NaN bombs)."""
        p = np.asarray(preds, np.float32)
        V, C = p.shape
        rng = np.random.default_rng(
            (_FAULT_SALT, self.cfg.seed, 22, receiver, gid, V))
        q = p[rng.permutation(V)]
        garble = rng.random((V, C), dtype=np.float32) + 1e-3
        out = 0.5 * q + 0.5 * garble
        return (out / out.sum(1, keepdims=True)).astype(np.float32)


# ---- crash-restart -----------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CrashRestartConfig:
    fraction: float = 0.0
    clients: tuple = ()
    at: float = 2.0             # earliest crash time (virtual)
    spread: float = 1.0         # crash_t = at + U[0, spread)
    downtime: float = 2.0       # restart_t = crash_t + downtime*(1+U[0,1))
    seed: int = 0


class CrashRestartFault:
    """One crash-and-rejoin cycle per affected client: volatile state
    (store, version vectors) is lost at `crash_t`; the client is offline
    until `restart_t`, then re-admits its (durable) trained models and
    re-disseminates under a fresh gossip incarnation."""

    kind = "crash_restart"

    @classmethod
    def from_params(cls, params: dict, n_clients: int
                    ) -> "CrashRestartFault":
        return cls(config_from_params(CrashRestartConfig, params,
                                      "fault[crash_restart]"), n_clients)

    def __init__(self, cfg: CrashRestartConfig, n_clients: int):
        self.cfg = cfg
        self.clients = _pick_clients(cfg.fraction, cfg.clients, n_clients,
                                     cfg.seed, 2, "fault[crash_restart]")
        self.crash_t: dict = {}
        self.restart_t: dict = {}
        for c in self.clients:
            rng = np.random.default_rng((_FAULT_SALT, cfg.seed, 31, c))
            t0 = float(cfg.at + cfg.spread * rng.random())
            self.crash_t[c] = t0
            self.restart_t[c] = t0 + float(cfg.downtime
                                           * (1.0 + rng.random()))

    def events(self):
        ev = []
        for c in self.clients:
            ev.append((self.crash_t[c], "crash", c, None))
            ev.append((self.restart_t[c], "restart", c, None))
        return ev

    def is_online(self, c: int, t: float) -> bool:
        t0 = self.crash_t.get(c)
        return t0 is None or not (t0 <= t < self.restart_t[c])


# ---- network partition (with healing) ----------------------------------


@dataclasses.dataclass(frozen=True)
class PartitionConfig:
    mode: str = "halves"        # "halves" | "edges"
    edges: tuple = ()           # ((a, b), ...) undirected, mode="edges"
    start: float = 2.0
    duration: float = 4.0
    seed: int = 0


class PartitionFault:
    """Cut an edge set for [start, start + duration): nothing crosses a
    cut edge (no bytes, no transport attempt — the link is physically
    down, counted as partition-blocked). A "heal" event at window end
    lets the scheduler re-arm quiesced repair streams across the cut."""

    kind = "partition"

    @classmethod
    def from_params(cls, params: dict, n_clients: int) -> "PartitionFault":
        return cls(config_from_params(PartitionConfig, params,
                                      "fault[partition]"), n_clients)

    def __init__(self, cfg: PartitionConfig, n_clients: int):
        if cfg.mode not in PARTITION_MODES:
            raise ValueError(f"unknown partition mode {cfg.mode!r}; "
                             f"choose from {PARTITION_MODES}")
        if cfg.mode == "edges" and not cfg.edges:
            raise ValueError('fault[partition]: mode="edges" needs a '
                             "non-empty edges list")
        self.cfg = cfg
        self.n = n_clients
        self._edges = frozenset(frozenset((int(a), int(b)))
                                for a, b in cfg.edges)

    def crosses(self, a: int, b: int) -> bool:
        if self.cfg.mode == "halves":
            h = self.n // 2
            return (a < h) != (b < h)
        return frozenset((a, b)) in self._edges

    def active(self, t: float) -> bool:
        return self.cfg.start <= t < self.cfg.start + self.cfg.duration

    def cut(self, a: int, b: int, t: float) -> bool:
        return self.active(t) and self.crosses(a, b)

    def events(self):
        ev = [(float(self.cfg.start), "partition", -1, None)]
        end = self.cfg.start + self.cfg.duration
        if np.isfinite(end):
            ev.append((float(end), "heal", -1, None))
        return ev
