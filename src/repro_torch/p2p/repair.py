"""Anti-entropy repair: periodic digest exchange + bounded re-sends (port
of `repro/p2p/repair.py`).

The push/push-pull gossip layer (p2p.gossip) is an epidemic over LOSSY
links: with the `note_sent` contract fixed, a dropped forward leaves the
receiver re-targetable — but nothing ever re-targets it, because pushes
only fire on `trained`/`recv` events and version vectors dedupe every
later copy. Under `drop_prob > 0` dissemination therefore stalls
*incomplete*, not late. This module adds the reconciliation loop that
makes the substrate eventually consistent (Demers et al.'s anti-entropy,
the mechanism the decentralized-pFL surveys call the prerequisite for
gossip under realistic loss):

  - Each directed edge (a -> b) periodically ships a DIGEST: a compact
    version-vector summary ``sorted(have[a].items())`` priced through
    the transport like any other message (`bytes_per_entry` per (key,
    version) pair — digests cost real bytes-on-wire, occupy inbox slots,
    and can themselves be dropped).
  - On digest receipt, b (1) marks every digest key into
    ``peer_has[b][a]`` (a provably holds them), and (2) computes the
    GAPS: keys b holds at a version a lacks. For each gap b schedules a
    bounded re-send b -> a with deterministic per-attempt backoff.
  - Determinism: the backoff jitter comes from a salted per-(src, dst,
    key, attempt, version) stream (`repair_rng`, the repair analogue of
    `transport.edge_rng`), and the transport folds (attempt, version)
    into its own drop/jitter draws — so the i-th retry of a given
    message draws the same numbers no matter when repair scheduled it,
    and a trace stays a pure function of the seed.
  - Budgets: at most `max_resends_per_digest` gaps are repaired per
    digest receipt (the rest are deferred to the next round) and at most
    `max_attempts` re-sends are ever scheduled per (edge, key, version)
    pair, so a partitioned peer cannot make repair flood.
  - Termination: an edge QUIESCES after `quiesce_after` consecutive
    gap-free digest receipts and is hard-capped at `max_rounds` digest
    rounds; `wake(c)` re-arms c's quiesced edges when c admits a new
    model, so late arrivals restart reconciliation. Digest streams to
    permanently departed peers stop immediately.

The class only *decides*; the scheduler (fl/scheduler.py) owns the event
heap, performs digest/re-send transmissions through the transport, and
reports arrivals back — the same division of labor as GossipProtocol.
`RepairStats` (digests, gaps, re-sends, bytes) lands in `trace.net`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from repro_torch.obs.metrics import NULL_METRICS
from repro_torch.p2p.churn import ChurnSchedule
from repro_torch.p2p.gossip import GossipProtocol
from repro_torch.p2p.params import config_from_params
from repro_torch.p2p.transport import ModelKey

_REPAIR_SALT = 0x2545F491

DigestEntry = Tuple[ModelKey, int]  # ((owner, idx), version)


def repair_rng(seed: int, src: int, dst: int, key: ModelKey,
               attempt: int, version: int = 0) -> np.random.Generator:
    """Deterministic backoff-jitter stream per (edge, key, attempt,
    version) — order-independent, domain-separated from edge_rng."""
    owner, idx = key
    return np.random.default_rng((_REPAIR_SALT, seed, src, dst, owner,
                                  idx, attempt, version))


def digest_nbytes(n_entries: int, bytes_per_entry: int) -> int:
    """Wire size of a version-vector digest: a fixed-width (owner, idx,
    version) triple per entry; an empty digest still costs one entry
    (the header that says 'I have nothing')."""
    return bytes_per_entry * max(1, n_entries)


@dataclasses.dataclass(frozen=True)
class RepairConfig:
    interval: float = 1.0        # digest period per directed edge
    start: float = 1.0           # first digest tick (virtual time)
    max_rounds: int = 20         # hard cap on digest rounds per edge
    quiesce_after: int = 2       # stop after this many gap-free receipts
    max_attempts: int = 4        # re-sends per (edge, key, version) pair
    max_resends_per_digest: int = 8   # repair-rate budget per receipt
    backoff_base: float = 0.1    # delay = base * factor**attempt * (1+U)
    backoff_factor: float = 2.0
    bytes_per_entry: int = 12    # digest pricing: (owner, idx, version)
    seed: int = 0


@dataclasses.dataclass
class RepairStats:
    n_digests_sent: int = 0      # digests handed to the transport
    n_digests_recv: int = 0      # digests processed by an online receiver
    n_digests_lost: int = 0      # arrived while the receiver was offline
    n_gaps_found: int = 0        # (key, version) pairs a peer was missing
    n_resends: int = 0           # repair re-sends scheduled
    n_budget_deferred: int = 0   # gaps pushed past max_resends_per_digest
    n_inflight_skipped: int = 0  # apparent gaps with a copy already in flight
    n_attempts_exhausted: int = 0  # (edge, key, version) pairs given up on
    n_quiesced: int = 0          # edges that reached gap-free quiescence
    bytes_digests: int = 0       # digest bytes that reached the wire
    # ^ booked by the scheduler AFTER the transport's inbox decision, so
    #   it matches TransportStats.bytes_sent semantics (rejected digest
    #   bytes never touched the link and are not repair wire cost)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class AntiEntropyRepair:
    """One fleet's repair state machine (decides digests and re-sends)."""

    @classmethod
    def from_params(cls, params: dict, gossip: GossipProtocol,
                    churn: Optional[ChurnSchedule] = None
                    ) -> "AntiEntropyRepair":
        """Registry hook (the sim registry): build from a tagged component's
        params dict."""
        return cls(config_from_params(RepairConfig, params, "repair"),
                   gossip, churn=churn)

    def __init__(self, cfg: RepairConfig, gossip: GossipProtocol,
                 churn: Optional[ChurnSchedule] = None):
        self.cfg = cfg
        self.gossip = gossip
        self.churn = churn if churn is not None else gossip.churn
        self.edges: List[Tuple[int, int]] = [
            (c, dst) for c in range(len(gossip.neighbors))
            for dst in gossip.neighbors[c]]
        self.rounds: Dict[Tuple[int, int], int] = {e: 0 for e in self.edges}
        self.calm: Dict[Tuple[int, int], int] = {e: 0 for e in self.edges}
        self.active: Set[Tuple[int, int]] = set(self.edges)
        # re-sends already scheduled per (src, dst, key, version)
        self.attempts: Dict[Tuple[int, int, ModelKey, int], int] = {}
        self.stats = RepairStats()
        self.metrics = NULL_METRICS  # live series (DESIGN.md §11)

    # ---- digest emission (sender side) --------------------------------
    def poll(self, src: int, dst: int, t: float,
             sender_online: Optional[bool] = None):
        """The (src -> dst) digest tick fired. Returns (entries, rnd,
        nbytes, reschedule): `entries` is None when no digest goes out
        this tick — a merely-offline sender keeps the stream alive
        (reschedule=True), while a quiesced / round-capped stream or a
        departed destination ends it (reschedule=False; `wake` re-arms
        quiesced edges).

        `sender_online` lets the scheduler compose extra availability
        gates (crash downtime, a partitioned edge) with churn: when
        given, it REPLACES the churn online check — an unavailable tick
        still consumes a round, so even an infinite partition cannot
        keep a stream alive forever."""
        edge = (src, dst)
        ended = (self.rounds[edge] >= self.cfg.max_rounds
                 or self.calm[edge] >= self.cfg.quiesce_after
                 or self.gossip.owner_gone(dst, t, churn=self.churn)
                 or self.gossip.owner_gone(src, t, churn=self.churn))
        if ended:
            self.active.discard(edge)
            return None, 0, 0, False
        rnd = self.rounds[edge]
        self.rounds[edge] = rnd + 1
        online = (self.churn is None or self.churn.is_online(src, t)) \
            if sender_online is None else sender_online
        if not online:
            # an unavailable tick still consumes a round: max_rounds
            # bounds TICKS, not successful sends, otherwise a
            # churn-flapping sender would keep its stream alive forever
            # (the event loop only terminates because every stream is
            # tick-bounded)
            return None, 0, 0, True
        entries = tuple(sorted(self.gossip.have[src].items()))
        nb = digest_nbytes(len(entries), self.cfg.bytes_per_entry)
        self.stats.n_digests_sent += 1
        if self.metrics.enabled:
            self.metrics.inc("repair.digests_on_wire", 1, t=t)
        return entries, rnd, nb, True

    # ---- digest receipt (receiver side) -------------------------------
    def on_digest(self, c: int, src: int, entries, t: float):
        """An ONLINE client c processed src's digest: update peer
        knowledge, find what src lacks, and return (sends, rearm) —
        `sends` is the bounded re-send schedule as (dst, key, version,
        t_send) tuples; `rearm` is True when the digest shows src holds
        keys c LACKS and c's own (ended) digest stream toward src must
        restart, so src learns of the gap and pushes. Without this
        reverse re-arm a model delivered to a peer AFTER the local
        stream quiesced would never be advertised again (push-only
        repair has no fetch)."""
        self.stats.n_digests_recv += 1
        remote = dict(entries)
        ph = self.gossip.peer_has[c].setdefault(src, set())
        ph.update(remote)
        wants = any(ver > self.gossip.have[c].get(key, -1)
                    and not self.gossip.owner_gone(key[0], t,
                                                   churn=self.churn)
                    for key, ver in remote.items())
        # ^ departed owners' keys are unrepairable by design (the gap
        #   loop below skips them too) — they must not hold edges open
        rearm = False
        back = (c, src)
        # on an asymmetric overlay the reverse edge may not exist — then
        # c cannot digest back to src and the gap stays src's to close
        if wants and back in self.rounds:
            self.calm[back] = 0
            if back not in self.active \
                    and self.rounds[back] < self.cfg.max_rounds:
                self.active.add(back)
                rearm = True
        gaps = []
        for key in sorted(self.gossip.have[c]):
            ver = self.gossip.have[c][key]
            if remote.get(key, -1) >= ver:
                continue
            if key in ph and key not in remote:
                # peer_has is truthful post-fix (note_sent only on
                # accepted sends, note_lost undoes dead arrivals): the
                # digest just predates an in-flight copy — don't resend.
                # A receiver-offline loss re-arms this edge via `wake`.
                self.stats.n_inflight_skipped += 1
                continue
            if self.gossip.owner_gone(key[0], t, churn=self.churn):
                continue  # stale owner: gossip suppresses, so does repair
            gaps.append((key, ver))
        edge = (src, c)  # the digest stream that produced this receipt
        if not gaps:
            self.calm[edge] = self.calm.get(edge, 0) + 1
            if self.calm[edge] == self.cfg.quiesce_after:
                self.stats.n_quiesced += 1
            return [], rearm
        self.calm[edge] = 0
        self.stats.n_gaps_found += len(gaps)
        sends, deferred = [], 0
        for key, ver in gaps:
            akey = (c, src, key, ver)
            attempt = self.attempts.get(akey, 0)
            if attempt > self.cfg.max_attempts:
                continue  # already gave up on this pair
            if attempt == self.cfg.max_attempts:
                self.stats.n_attempts_exhausted += 1
                self.attempts[akey] = attempt + 1
                continue
            if len(sends) >= self.cfg.max_resends_per_digest:
                deferred += 1  # budget cap: the next round retries it
                continue
            self.attempts[akey] = attempt + 1
            jitter = repair_rng(self.cfg.seed, c, src, key, attempt,
                                ver).random()
            delay = self.cfg.backoff_base \
                * self.cfg.backoff_factor ** attempt * (1.0 + jitter)
            sends.append((src, key, ver, t + delay))
        self.stats.n_budget_deferred += deferred
        self.stats.n_resends += len(sends)
        return sends, rearm

    def refund_attempt(self, src: int, dst: int, key: ModelKey,
                       version: int) -> None:
        """A scheduled re-send never became a transmission — the holder
        was offline at fire time, or the transport rejected it at the
        inbox (backpressure, never on the wire). Give the attempt back,
        so `max_attempts` bounds actual transmissions — otherwise a
        client whose offline windows (or whose peer's inbox pressure)
        cover the backoff-delayed fire times could exhaust every attempt
        without ever sending. Still bounded: retries only re-schedule
        from digest receipts, and digest streams are tick-capped."""
        akey = (src, dst, key, version)
        self.attempts[akey] = max(0, self.attempts.get(akey, 1) - 1)

    # ---- array-world constructors (sim/compiled.py) -------------------
    def array_state(self, tick: float) -> dict:
        """Per-directed-edge arrays for the compiled backend: edge
        endpoint vectors, the reverse-edge index map (for the wants ->
        re-arm path), and the config quantized onto the tick grid.
        Interval and start are rounded to whole ticks (>= 1), which is
        part of the tick-quantization contract (DESIGN.md §10)."""
        e_src = np.array([a for a, _ in self.edges], np.int32)
        e_dst = np.array([b for _, b in self.edges], np.int32)
        idx = {e: i for i, e in enumerate(self.edges)}
        rev = np.array([idx.get((b, a), -1) for a, b in self.edges],
                       np.int32)
        return {
            "e_src": e_src, "e_dst": e_dst, "rev": rev,
            "n_edges": len(self.edges),
            "interval_ticks": max(1, round(self.cfg.interval / tick)),
            "start_tick": max(1, round(self.cfg.start / tick)),
            "max_rounds": int(self.cfg.max_rounds),
            "quiesce_after": int(self.cfg.quiesce_after),
            "max_attempts": int(self.cfg.max_attempts),
            "budget": int(self.cfg.max_resends_per_digest),
            "backoff_base": float(self.cfg.backoff_base),
            "backoff_factor": float(self.cfg.backoff_factor),
            "bytes_per_entry": int(self.cfg.bytes_per_entry),
            "seed": int(self.cfg.seed),
        }

    def wake(self, c: int, t: float) -> List[int]:
        """Client c admitted a new model: reset its outgoing edges' calm
        counters and return the destinations whose (ended) digest streams
        should be re-scheduled by the caller."""
        out = []
        for dst in self.gossip.neighbors[c]:
            edge = (c, dst)
            self.calm[edge] = 0
            if edge in self.active:
                continue
            if self.rounds[edge] >= self.cfg.max_rounds:
                continue
            if self.gossip.owner_gone(dst, t, churn=self.churn):
                continue
            self.active.add(edge)
            out.append(dst)
        return out

    # ---- re-arming ----------------------------------------------------
    def rearm(self, a: int, b: int) -> bool:
        """Force the (a -> b) digest stream back to life — the heal
        handler's sweep over previously-partitioned edges. Returns True
        when the caller must schedule a fresh digest_send tick (the
        stream had ended); resetting calm alone is not enough, because a
        stream that quiesced DURING the cut has no future tick on the
        heap."""
        edge = (a, b)
        if edge not in self.rounds:
            return False
        self.calm[edge] = 0
        if edge in self.active or self.rounds[edge] >= self.cfg.max_rounds:
            return False
        self.active.add(edge)
        return True
