"""Simulated gossip transport: the link layer under the async simulator
(port of `repro/p2p/transport.py`; numpy on the host, draw for draw the
reference's).

Every peer-to-peer message (a model's prediction matrix, or — for the
cost comparison — a full checkpoint) crosses a per-edge link with

  - propagation latency drawn from a deterministic per-(src, dst, model)
    stream (`edge_rng`, the numpy analogue of `jax.random.fold_in`), so a
    trace is a pure function of the seed regardless of event pop order;
  - a serialization term `nbytes / bandwidth` — transfer time scales with
    message size, which is what makes the paper's §III-A low-storage
    exchange (a (V, C) prediction matrix) quantifiably cheaper than
    shipping `n_params` checkpoint floats (DESIGN.md §6);
  - an i.i.d. drop probability per message attempt;
  - a bounded per-destination inbox: messages in flight beyond
    `inbox_capacity` are rejected at send time (backpressure, counted).

The transport never touches the event queue — `send` returns the arrival
time (or None when the message is lost) and the scheduler owns the heap.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from repro_torch.obs.metrics import NULL_METRICS
from repro_torch.p2p.params import config_from_params

ModelKey = Tuple[int, int]  # (owner client, local model index)

_EDGE_SALT = 0x9E3779B9  # domain-separates edge streams from other rngs

# Sentinel "owner" for anti-entropy digest messages (p2p.repair): digests
# share the link model — latency, drops, inboxes, byte accounting — but
# must never collide with a real client id in the edge streams or log.
DIGEST_OWNER = (1 << 31) - 1


def edge_rng(seed: int, src: int, dst: int, key: ModelKey,
             attempt: int = 0, version: int = 0) -> np.random.Generator:
    """Deterministic per-(src, dst, model, attempt, version) stream —
    fold_in style.

    The draw depends only on the edge identity and the seed, never on how
    many other events the simulator happened to process first, so traces
    are reproducible under any heap tie-breaking. Folding the ATTEMPT and
    the VERSION in keeps anti-entropy re-sends order-independent too: the
    i-th retry of (key, version) over an edge draws the same (drop,
    jitter) pair no matter when repair got around to scheduling it."""
    owner, idx = key
    return np.random.default_rng((_EDGE_SALT, seed, src, dst, owner, idx,
                                  attempt, version))


def prediction_matrix_bytes(n_val: int, n_classes: int,
                            bytes_per_value: int = 4) -> int:
    """Wire size of the paper's low-storage exchange unit: the (V, C)
    prediction matrix on the receiver's validation set."""
    return n_val * n_classes * bytes_per_value


def checkpoint_bytes(n_params: int, bytes_per_value: int = 4) -> int:
    """Wire size of the naive exchange unit: the full parameter vector."""
    return n_params * bytes_per_value


@dataclasses.dataclass(frozen=True)
class TransportConfig:
    base_latency: float = 0.05      # propagation delay (virtual time)
    jitter: float = 1.0             # latency *= (1 + jitter * U[0,1))
    bandwidth: float = float("inf")  # bytes per virtual-time unit per link
    drop_prob: float = 0.0          # i.i.d. loss per message attempt
    inbox_capacity: int = 0         # max in-flight msgs per dst; 0 = unbounded
    seed: int = 0


@dataclasses.dataclass
class TransportStats:
    n_sent: int = 0                 # messages handed to the link layer
    n_delivered: int = 0
    n_dropped_link: int = 0         # lost to drop_prob
    n_dropped_inbox: int = 0        # rejected by the bounded inbox
    bytes_sent: int = 0             # bytes that actually crossed the wire
    bytes_delivered: int = 0
    bytes_rejected: int = 0         # inbox-rejected bytes: never on the wire
    # wire-corruption outcomes (repro_torch.faults): booked by the
    # scheduler at delivery when a corruption injector is active, zero
    # otherwise
    n_corrupt_detected: int = 0     # checksum caught it; delivery discarded
    n_corrupt_admitted: int = 0     # corrupted payload reached the receiver

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class GossipTransport:
    """Per-edge link model shared by the scheduler and the benchmarks.

    `size_fn(src, dst, key) -> int` prices each message; the driver plugs
    in prediction-matrix bytes (default) or checkpoint bytes (the cost
    baseline). A message log (t_send, src, dst, key, outcome) supports
    the churn tests and the bytes-on-wire curves."""

    @classmethod
    def from_params(cls, params: dict, n_clients: int,
                    size_fn: Callable[[int, int, ModelKey], int]
                    ) -> "GossipTransport":
        """Registry hook (the sim registry): build from a tagged component's
        params dict — the name-addressable constructor the declarative
        spec layer resolves."""
        return cls(config_from_params(TransportConfig, params, "transport"),
                   n_clients, size_fn)

    def __init__(self, cfg: TransportConfig, n_clients: int,
                 size_fn: Callable[[int, int, ModelKey], int]):
        self.cfg = cfg
        self.size_fn = size_fn
        self.inflight = np.zeros(n_clients, np.int64)
        self._attempts: Dict[Tuple[int, int, ModelKey, int], int] = {}
        self.stats = TransportStats()
        self.metrics = NULL_METRICS  # live series (DESIGN.md §11);
        #   repointed at the run's registry when the spec enables obs
        self.log: list = []  # (t_send, src, dst, key, "ok"|"drop"|"inbox")
        self.last_outcome: str = ""  # outcome of the most recent send()
        # ^ the sim is single-threaded, so callers that need to react to
        #   the outcome (repair: refund inbox-rejected attempts, book
        #   digest wire bytes) read this instead of diffing the stats

    def send(self, src: int, dst: int, key: ModelKey, t: float,
             nbytes: Optional[int] = None,
             version: int = 0) -> Optional[float]:
        """Price, maybe drop, maybe reject, else return the arrival time.

        `nbytes` overrides the `size_fn` pricing — anti-entropy digests
        (variable-width version-vector summaries) pass their own size but
        otherwise ride the same link model. A link-dropped message books
        `bytes_sent` (it crossed the wire and was lost in flight); an
        inbox-rejected one books `bytes_rejected` instead — backpressure
        rejects at send time, so those bytes never touch the link."""
        nbytes = int(self.size_fn(src, dst, key)) if nbytes is None \
            else int(nbytes)
        self.stats.n_sent += 1
        mx = self.metrics
        if mx.enabled:
            mx.inc("net.msgs_on_wire", 1, t=t)
        edge = (src, dst, key, version)
        attempt = self._attempts.get(edge, 0)
        self._attempts[edge] = attempt + 1
        rng = edge_rng(self.cfg.seed, src, dst, key, attempt, version)
        # one stream decides (drop, jitter) so re-sends get fresh draws
        # but the trace stays independent of global event order
        dropped = rng.random() < self.cfg.drop_prob
        jitter = rng.random()
        if dropped:
            self.stats.n_dropped_link += 1
            self.stats.bytes_sent += nbytes
            if mx.enabled:  # dropped in flight: the bytes crossed the wire
                mx.inc("net.bytes_on_wire", nbytes, t=t)
            self.log.append((t, src, dst, key, "drop"))
            self.last_outcome = "drop"
            return None
        if self.cfg.inbox_capacity and \
                self.inflight[dst] >= self.cfg.inbox_capacity:
            self.stats.n_dropped_inbox += 1
            self.stats.bytes_rejected += nbytes
            self.log.append((t, src, dst, key, "inbox"))
            self.last_outcome = "inbox"
            return None
        self.stats.bytes_sent += nbytes
        self.inflight[dst] += 1
        if mx.enabled:
            mx.inc("net.bytes_on_wire", nbytes, t=t)
            if self.cfg.inbox_capacity:  # bounded-inbox configs only
                mx.set("net.inbox_depth", int(self.inflight[dst]), t=t)
        lat = self.cfg.base_latency * (1.0 + self.cfg.jitter * jitter)
        if np.isfinite(self.cfg.bandwidth):
            lat += nbytes / self.cfg.bandwidth
        self.log.append((t, src, dst, key, "ok"))
        self.last_outcome = "ok"
        return t + lat

    # ---- array-world constructors (sim/compiled.py) -------------------
    def array_params(self) -> dict:
        """Scalar link parameters for the compiled backend, with the two
        features the array world cannot honor rejected loudly: bounded
        inboxes (rejection depends on within-tick send order) and
        per-(src, dst, key) message sizes (the dense step prices every
        model message with ONE constant, which both stock sizers
        satisfy)."""
        if self.cfg.inbox_capacity:
            raise ValueError(
                "the compiled backend does not support bounded inboxes "
                f"(got inbox_capacity={self.cfg.inbox_capacity}): "
                "within-tick rejection order is event-granular; use "
                "backend='event'")
        probes = {int(self.size_fn(s, d, (o, m)))
                  for s, d, o, m in ((0, 0, 0, 0), (1, 0, 2, 1),
                                     (0, 1, 1, 0))}
        if len(probes) != 1:
            raise ValueError(
                "the compiled backend needs a constant-size message "
                f"sizer (probed sizes: {sorted(probes)}); use "
                "backend='event' for per-edge pricing")
        return {"base_latency": float(self.cfg.base_latency),
                "jitter": float(self.cfg.jitter),
                "bandwidth": float(self.cfg.bandwidth),
                "drop_prob": float(self.cfg.drop_prob),
                "nbytes": probes.pop(), "seed": int(self.cfg.seed)}

    def deliver(self, src: int, dst: int, key: ModelKey,
                lost: bool = False, nbytes: Optional[int] = None,
                t: Optional[float] = None) -> None:
        """Called by the scheduler when the recv event fires: frees the
        inbox slot always, and books the delivered bytes unless the
        receiver lost the message (e.g. it was offline at arrival).
        `nbytes` mirrors `send`'s override for digest messages; `t` (the
        arrival's virtual time) stamps the inbox-depth gauge sample."""
        self.inflight[dst] -= 1
        if self.metrics.enabled and self.cfg.inbox_capacity \
                and t is not None:
            self.metrics.set("net.inbox_depth", int(self.inflight[dst]),
                             t=t)
        if not lost:
            self.stats.n_delivered += 1
            self.stats.bytes_delivered += (
                int(self.size_fn(src, dst, key)) if nbytes is None
                else int(nbytes))
