"""The prediction store: every client's view of the network's models
(port of `repro/core/bench.py`; plain numpy on the host, as there).

Default exchange unit is the PREDICTION MATRIX on the receiving client's
validation set (the paper's low-storage variant — §III-A), with lazy
checkpoint fetch for selected members only. At LLM scale this is what
moves over pod-to-pod DCN instead of multi-GB checkpoints (DESIGN.md §5).

`PredictionStore` materializes one client's bench as a single padded
tensor `preds[(capacity, V_pad, C)]` plus a slot-validity mask: slot i is
reserved for global model id i, so stores of different clients (and of
the same client at different points of an asynchronous run) stay
slot-aligned and can be stacked into the `(N, M, V, C)` batch that the
vmapped selection engine consumes (`stack_stores`). Validation rows past
the client's own V are label-padded with -1 and zero predictions, which
the objectives treat as no-ops (objectives.py).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np

V_ALIGN = 128  # validation-axis padding multiple (one jit/kernel shape)


@dataclasses.dataclass
class BenchEntry:
    model_id: int          # GLOBAL model id == store slot index
    owner: int
    family: str
    predict: Callable      # x -> (N, C) probabilities
    n_params: int = 0
    # optional raw parameters + model config: entries that carry them can
    # be served through the batched multi-model forward
    # (fl.client.predict_probs_batched) instead of per-entry dispatches
    params: Optional[object] = None
    ccfg: Optional[object] = None


class PredictionStore:
    """Per-client repository of bench prediction tensors.

    Slots are keyed by global model id; `add` materializes the entry's
    predictions on the client's validation set into the padded device
    tensor (the stored 'compact representation'); `predictions` is the
    masked LAZY fetch for test-set serving — only selected members are
    evaluated, everything else stays zero.
    """

    def __init__(self, client: int, capacity: int, x_val: np.ndarray,
                 y_val: np.ndarray, n_classes: int, v_pad: Optional[int] = None):
        self.client = client
        self.capacity = capacity
        self.x_val = x_val
        self.n_val = len(y_val)
        v = self.n_val if v_pad is None else v_pad
        self.v_pad = v + ((-v) % V_ALIGN)
        self.n_classes = n_classes
        self.preds = np.zeros((capacity, self.v_pad, n_classes), np.float32)
        self.labels = np.full((self.v_pad,), -1, np.int32)
        self.labels[:self.n_val] = y_val
        self.mask = np.zeros((capacity,), bool)
        self.entries: List[Optional[BenchEntry]] = [None] * capacity
        # contribution stats + slot generations (streaming-store eviction
        # and the engine's cached-chromosome invalidation — DESIGN.md §6;
        # for the unbounded store generations simply never change)
        self.hits = np.zeros((capacity,), np.int64)
        self.last_used = np.zeros((capacity,), np.float64)
        self.slot_gen = np.zeros((capacity,), np.int64)
        self.evictions = 0
        # dirty-slot event log: slot -> id of its latest change. Device
        # mirrors (core/device_store.py) drain it with their OWN cursors,
        # so several consumers can track the same store independently
        # (nothing is destructively cleared); bounded by capacity.
        self.dirty_seq: dict = {}
        self._dirty_clock = 0

    def _mark_dirty(self, slot: int):
        self._dirty_clock += 1
        self.dirty_seq[slot] = self._dirty_clock

    def _materialize(self, slot: int, entry: BenchEntry,
                     preds: Optional[np.ndarray], t: float):
        if preds is None:
            preds = entry.predict(self.x_val)
        self.preds[slot, :self.n_val] = np.asarray(preds, np.float32)[:self.n_val]
        self.mask[slot] = True
        self.entries[slot] = entry
        self.last_used[slot] = t
        self._mark_dirty(slot)

    def add(self, entry: BenchEntry, preds: Optional[np.ndarray] = None,
            t: float = 0.0):
        """Materialize `entry` into its slot. `preds` short-circuits the
        forward pass when the (V, C) matrix is already known (batched
        multi-model predict in the driver, or a peer shipped the matrix).
        `t` is the virtual arrival time (recency input to eviction)."""
        self._materialize(entry.model_id, entry, preds, t)
        return entry.model_id

    def _slot_for(self, model_id: int) -> Optional[int]:
        """Physical slot of a global model id, None when absent. The
        unbounded store is identity-mapped; the streaming store overrides
        with its remap table."""
        return model_id if 0 <= model_id < self.capacity else None

    def _clear_slot(self, slot: int) -> None:
        """Empty one slot: zero the row, mask it off, and bump its
        generation so the engine's cached chromosome detects the stale
        member and falls back (core/engine.py `_stale`). The dirty mark
        makes device mirrors zero and mask the resident row too."""
        self.entries[slot] = None
        self.mask[slot] = False
        self.preds[slot] = 0.0
        self.hits[slot] = 0
        self.last_used[slot] = 0.0
        self.slot_gen[slot] += 1
        self._mark_dirty(slot)

    def invalidate(self, model_id: int) -> bool:
        """Expel a resident model (admission-gate rejection of a refresh
        that turned bad — repro_torch.faults). True iff something was
        expelled."""
        slot = self._slot_for(model_id)
        if slot is None or not self.mask[slot]:
            return False
        self._clear_slot(slot)
        return True

    def wipe(self) -> int:
        """Drop EVERY resident model (a crash losing the volatile store).
        Returns the number of slots cleared; generations bump so nothing
        cached survives the reboot."""
        occupied = np.flatnonzero(self.mask)
        for slot in occupied:
            self._clear_slot(int(slot))
        return len(occupied)

    def refresh_validation(self, x_val: np.ndarray, y_val: np.ndarray,
                           preds: np.ndarray) -> None:
        """Replace the validation set in place (serving-time distribution
        drift — DESIGN.md §14): same width, new inputs/labels, and the
        matching (capacity, n_val, C) prediction rows for EVERY slot.
        Slot membership, generations, and contribution stats survive —
        the resident models did not change, the world they are scored
        against did — but every slot goes dirty so device mirrors
        rebuild their cached statistics against the new labels."""
        if len(y_val) != self.n_val:
            raise ValueError(
                f"refresh_validation keeps the store width: got "
                f"{len(y_val)} labels for n_val={self.n_val}")
        preds = np.asarray(preds, np.float32)
        if preds.shape != (self.capacity, self.n_val, self.n_classes):
            raise ValueError(
                f"refresh_validation wants preds of shape "
                f"{(self.capacity, self.n_val, self.n_classes)}, got "
                f"{preds.shape}")
        self.x_val = x_val
        self.labels[:self.n_val] = np.asarray(y_val, np.int32)
        self.preds[:, :self.n_val] = np.where(self.mask[:, None, None],
                                              preds, 0.0)
        for slot in range(self.capacity):
            self._mark_dirty(slot)

    def note_selection(self, selected: np.ndarray, t: float = 0.0):
        """The engine selected these slots at time t — the contribution
        signal the streaming store's eviction policy ranks by."""
        sel = np.asarray(selected, bool)
        self.hits[sel] += 1
        self.last_used[sel] = t

    @property
    def n_present(self) -> int:
        return int(self.mask.sum())

    @property
    def owners(self) -> np.ndarray:
        """(capacity,) owner per slot, -1 where nothing has arrived."""
        return np.array([-1 if e is None else e.owner for e in self.entries])

    def is_local(self) -> np.ndarray:
        return self.owners == self.client

    def val_predictions(self, x_val: Optional[np.ndarray] = None
                        ) -> np.ndarray:
        """(capacity, V, C) — the stored validation-set matrices (empty
        slots are zero). `x_val` is accepted for API compatibility but
        must BE the validation set; use `predictions` for other data."""
        if x_val is not None and len(x_val) != self.n_val:
            raise ValueError(
                "val_predictions serves the stored validation set; "
                "use predictions(x) for other data")
        return self.preds[:, :self.n_val]

    def padded(self):
        """(preds (capacity, V_pad, C), labels (V_pad,), mask (capacity,))
        — the view the selection engine stacks."""
        return self.preds, self.labels, self.mask

    def predictions(self, x: np.ndarray, mask: Optional[np.ndarray] = None) -> np.ndarray:
        """(capacity, N, C) on arbitrary data; with `mask`, only selected
        PRESENT members are evaluated (the 'download only what you need'
        path) and other rows are zero. Always returns an array — an
        all-False mask yields zeros, never None.

        Members of the same family that carry raw parameters are evaluated
        with ONE batched multi-model forward per family
        (fl.client.predict_probs_batched); only paramless entries (shipped
        closures) and singleton family groups fall back to the per-entry
        loop."""
        out = np.zeros((self.capacity, len(x), self.n_classes), np.float32)
        groups = {}                       # (family, ccfg) -> [slot, ...]
        loop_slots = []
        for i, e in enumerate(self.entries):
            if e is None or (mask is not None and not mask[i]):
                continue
            if e.params is not None and e.ccfg is not None:
                groups.setdefault((e.family, e.ccfg), []).append(i)
            else:
                loop_slots.append(i)
        for (fam, ccfg), slots in groups.items():
            if len(slots) < 2:
                loop_slots.extend(slots)
                continue
            from repro_torch.fl.client import predict_probs_batched
            probs = predict_probs_batched(
                fam, ccfg, [self.entries[s].params for s in slots], x)
            for s, p in zip(slots, probs):
                out[s] = p
        for i in loop_slots:
            out[i] = self.entries[i].predict(x)
        return out


class StreamingPredictionStore(PredictionStore):
    """Bounded store for unbounded model churn (DESIGN.md §6).

    Physical capacity is FIXED; global model ids are remapped onto
    physical slots (`slot_of`), and when the store is full an incoming
    model evicts the occupant with the lowest contribution score —
    ranked by (selection hits, last-used time, slot index), i.e. evict
    the least-selected, then stalest, slot. Local models are pinned
    (`protect_local`): the negative-transfer fallback must always be
    servable from the store.

    Slot remapping is what keeps `stack_stores` alignment intact:
    surviving slots never move, an evicted slot's row is zeroed and
    masked off (so it drops out of the next stacked batch), and each
    remap bumps `slot_gen[slot]` so the engine can detect that a cached
    chromosome points at a slot whose occupant changed underneath it.
    """

    def __init__(self, client: int, capacity: int, x_val: np.ndarray,
                 y_val: np.ndarray, n_classes: int,
                 v_pad: Optional[int] = None, protect_local: bool = True):
        super().__init__(client, capacity, x_val, y_val, n_classes,
                         v_pad=v_pad)
        self.protect_local = protect_local
        self.slot_of = {}               # global model id -> physical slot
        self.n_rejected = 0             # adds refused (everything pinned)

    def _slot_for(self, model_id: int) -> Optional[int]:
        return self.slot_of.get(model_id)

    def _clear_slot(self, slot: int) -> None:
        gone = self.entries[slot]
        if gone is not None:
            self.slot_of.pop(gone.model_id, None)
        super()._clear_slot(slot)

    def _evictable(self) -> np.ndarray:
        occ = self.mask.copy()
        if self.protect_local:
            occ &= ~self.is_local()
        return occ

    def _evict_one(self) -> Optional[int]:
        cand = np.flatnonzero(self._evictable())
        if len(cand) == 0:
            return None
        order = np.lexsort((cand, self.last_used[cand], self.hits[cand]))
        slot = int(cand[order[0]])
        self._clear_slot(slot)          # bumps slot_gen: cached
        self.evictions += 1             # chromosomes invalidate; device
        return slot                     # mirrors zero the row too

    def add(self, entry: BenchEntry, preds: Optional[np.ndarray] = None,
            t: float = 0.0):
        """Admit (or refresh) a model; evicts when full. Returns the
        physical slot, or None when the add was refused (store full of
        pinned local models)."""
        gid = entry.model_id
        slot = self.slot_of.get(gid)
        if slot is None:
            free = np.flatnonzero(~self.mask)
            if len(free):
                slot = int(free[0])
            else:
                slot = self._evict_one()  # bumps slot_gen
                if slot is None:
                    self.n_rejected += 1
                    return None
            self.slot_of[gid] = slot
        self._materialize(slot, entry, preds, t)
        return slot


def stack_stores(stores, clients=None, v_to: Optional[int] = None):
    """Stack per-client stores into the engine's batch:
    (preds (N, cap, V_max, C), labels (N, V_max), masks (N, cap)).
    All stores must share `capacity` and `n_classes`; shorter validation
    sets are -1/zero padded up to the widest store (or `v_to`, which the
    engine pins globally so every batch compiles to one shape)."""
    if clients is None:
        clients = range(len(stores))
    sel = [stores[c] for c in clients]
    cap = sel[0].capacity
    v_max = v_to if v_to is not None else max(s.v_pad for s in sel)
    C = sel[0].n_classes
    preds = np.zeros((len(sel), cap, v_max, C), np.float32)
    labels = np.full((len(sel), v_max), -1, np.int32)
    masks = np.zeros((len(sel), cap), np.float32)
    for i, s in enumerate(sel):
        assert s.capacity == cap and s.n_classes == C
        preds[i, :, :s.v_pad] = s.preds
        labels[i, :s.v_pad] = s.labels
        masks[i] = s.mask.astype(np.float32)
    return preds, labels, masks
