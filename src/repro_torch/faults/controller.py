"""`FaultController`: the one fault object the event scheduler consults
(port of `repro/faults/controller.py`).

Aggregates at most one injector of each kind (byzantine / corruption /
crash_restart / partition — duplicates are a config error, compose the
parameters instead) behind the small API the scheduler's hot paths gate
on `faults is not None`, so a fault-free run executes byte-identically
to the pre-fault code:

  initial_events()     — crash/restart/partition/heal events to seed the
                         heap with (deterministic times from the injector
                         seeds);
  is_online(c, t)      — crash-downtime gate, composed with churn by the
                         scheduler;
  edge_cut(a, b, t)    — partition gate on sends (models, digests,
                         repair re-sends); in-flight messages at cut
                         time still arrive (the link dropped, the
                         photons didn't);
  corrupt_check(...)   — per-delivery corruption verdict
                         (None | "detected" | "admitted"), stats-counted;
  poison_payload(...)  — byzantine matrix transform (stats-counted; the
                         pure `poison_matrix` serves test-time forwards
                         without inflating the injection counter);
  mark/take/clear_corrupt — the handoff that lets the driver's on_add
                         corrupt exactly the payloads the wire corrupted.

`array_params()` always raises: no injector is expressible as the
compiled backend's dense whole-fleet transitions (crash wipes, partition
windows, and per-delivery corruption verdicts are event-granular), so an
array-world backend must reject fault specs loudly instead of silently
simulating a different failure model — the reference's contract.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

INJECTOR_KINDS = ("byzantine", "corruption", "crash_restart", "partition")


@dataclasses.dataclass
class FaultStats:
    n_byzantine_poisoned: int = 0   # poisoned payloads admitted to stores
    n_corrupt_detected: int = 0     # checksum-caught corrupted deliveries
    n_corrupt_admitted: int = 0     # corrupted deliveries that slipped by
    n_crashes: int = 0
    n_restarts: int = 0
    n_partition_blocked: int = 0    # sends swallowed by a cut edge

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class FaultController:
    """One run's aggregated fault state (decides; the scheduler acts)."""

    def __init__(self, injectors, n_clients: int):
        self.n_clients = n_clients
        self.injectors = list(injectors)
        by_kind: dict = {}
        for inj in self.injectors:
            k = getattr(inj, "kind", None)
            if k not in INJECTOR_KINDS:
                raise ValueError(
                    f"not a fault injector: {inj!r} (kind={k!r}); "
                    f"expected one of {INJECTOR_KINDS}")
            if k in by_kind:
                raise ValueError(
                    f"duplicate fault injector kind {k!r}: compose the "
                    "parameters into one injector instead")
            by_kind[k] = inj
        self.byzantine = by_kind.get("byzantine")
        self.corruption = by_kind.get("corruption")
        self.crash = by_kind.get("crash_restart")
        self.partition = by_kind.get("partition")
        self.stats = FaultStats()
        self._corrupt_pending: set = set()  # (receiver, key) handoffs

    @property
    def kinds(self) -> tuple:
        return tuple(k for k in INJECTOR_KINDS
                     if getattr(self, "crash" if k == "crash_restart"
                                else k) is not None)

    # ---- scheduler-facing gates ---------------------------------------
    def initial_events(self):
        """(t, kind, client, payload) tuples to push at loop start —
        sorted, but the heap would order them anyway."""
        ev = []
        if self.crash is not None:
            ev.extend(self.crash.events())
        if self.partition is not None:
            ev.extend(self.partition.events())
        return sorted(ev, key=lambda e: e[0])

    def is_online(self, c: int, t: float) -> bool:
        return self.crash is None or self.crash.is_online(c, t)

    def edge_cut(self, a: int, b: int, t: float) -> bool:
        return self.partition is not None and self.partition.cut(a, b, t)

    def crosses_cut(self, a: int, b: int) -> bool:
        """Time-independent cut membership — the heal handler's re-arm
        sweep over repair edges."""
        return self.partition is not None and self.partition.crosses(a, b)

    def note_crash(self, c: int, t: float) -> None:
        self.stats.n_crashes += 1

    def note_restart(self, c: int, t: float) -> None:
        self.stats.n_restarts += 1

    # ---- corruption ----------------------------------------------------
    def corrupt_check(self, src: int, dst: int, key,
                      version: int) -> Optional[str]:
        if self.corruption is None:
            return None
        verdict = self.corruption.check(src, dst, key, version)
        if verdict == "detected":
            self.stats.n_corrupt_detected += 1
        elif verdict == "admitted":
            self.stats.n_corrupt_admitted += 1
        return verdict

    def corrupt_matrix(self, preds, receiver: int, gid: int):
        return self.corruption.corrupt(preds, receiver, gid)

    def mark_corrupt(self, receiver: int, key) -> None:
        self._corrupt_pending.add((receiver, key))

    def take_corrupt(self, receiver: int, key) -> bool:
        """Consume the mark (the on_add that materializes this payload
        must corrupt it)."""
        try:
            self._corrupt_pending.remove((receiver, key))
            return True
        except KeyError:
            return False

    def clear_corrupt(self, receiver: int, key) -> None:
        """A marked delivery that never reached an on_add (version
        dedupe, gate short-circuit) must not corrupt a later one."""
        self._corrupt_pending.discard((receiver, key))

    # ---- byzantine -----------------------------------------------------
    def is_byzantine(self, owner: int) -> bool:
        return self.byzantine is not None \
            and owner in self.byzantine.clients

    def poison_matrix(self, preds, receiver: int, gid: int):
        return self.byzantine.poison(preds, receiver, gid)

    def poison_payload(self, preds, receiver: int, gid: int):
        self.stats.n_byzantine_poisoned += 1
        return self.byzantine.poison(preds, receiver, gid)

    # ---- reporting / backend contract ----------------------------------
    def as_dict(self) -> dict:
        return self.stats.as_dict()

    def array_params(self) -> dict:
        raise ValueError(
            "the compiled backend does not support fault injection "
            f"(active injectors: {list(self.kinds)}): crash wipes, "
            "partition windows, and per-delivery corruption verdicts "
            "are event-granular; use schedule.backend='event'")
