"""Device-resident fleet batch with incremental selection statistics
(port of `repro/core/device_store.py`).

The selection loop only ever consumes per-model accuracy and the
pairwise similarity Gram matrix. `DeviceStoreBatch` keeps the fleet's
stacked preds/labels/mask tensors ON THE DEVICE together with
persistent per-client statistics — `acc (N, M)` and `S (N, M, M)` — and
updates them incrementally:

- host stores log dirty slots on add (`PredictionStore.dirty_seq`),
  drained through this batch's own cursors;
- `flush()` scatters only the changed `(V, C)` rows into the resident
  buffers IN PLACE (`index_put_`, where the reference donates its jit
  buffers) and recomputes only the affected `acc[c, slot]` entries and
  `S[c, slot, :]` / `S[c, :, slot]` row/column pairs.

Every pairwise similarity is computed by the same row contraction (a
normalized-row matrix product over the flattened `V·C` axis against the
final occupant rows) whatever order the slots became dirty in, so the
incremental state equals a from-scratch flush of the same stores bit
for bit (tests/test_torch_device_store.py holds this on the CPU;
chip_smoke.py reports it on the card).

Dirty slots are grouped per client; the group count and the per-client
slot width are each padded to the next power of two by repeating
(scatter and recompute are idempotent). The width has a floor of
`_GRAM_ROWS`, and the Gram rows are computed `_GRAM_ROWS` at a time:
torch's CPU `bmm` sums in another order for another row count (2 rows
and 16 rows of the same product differ in the last bits), where the
reference's floor of 2 sufficed for XLA:CPU.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch


_GRAM_ROWS = 8   # rows of every Gram product (a power of two)


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _zero_row_acc(label_row: np.ndarray) -> np.float32:
    """member_accuracy of an all-zero prediction row: argmax ties resolve
    to class 0, so empty slots score the label-0 fraction. Seeding the
    cached acc with this keeps never-materialized slots bit-identical to
    a from-scratch full-stats rebuild (they are masked out of selection
    either way)."""
    valid = label_row >= 0
    nv = max(int(valid.sum()), 1)
    return np.float32(int(((label_row == 0) & valid).sum())) / np.float32(nv)


@torch.no_grad()
def _flush(preds, pnorm, masks, acc, S, labels, nv, rows, row_mask, cu,
           slots, all_clients: bool = False):
    """Scatter the dirty rows and recompute only their statistics, in
    place on preds (N, M, V, C), its normalized mirror pnorm, masks
    (N, M), acc (N, M) and S (N, M, M); labels (N, V) and nv (N,) are
    read-only. cu (K,) are the dirty clients, slots (K, R) their dirty
    slots, rows (K·R, V, C) the raw rows and row_mask (K·R,) their
    presence bits. `all_clients=True` asserts cu == arange(N) and skips
    the (K, M, V, C) client-block gather."""
    K, R = slots.shape
    ci = cu.repeat_interleave(R)                 # (K·R,) flat client ids
    si = slots.reshape(-1)                       # (K·R,) flat slot ids
    lab = labels[ci]                             # (K·R, V)
    valid = lab >= 0
    rn = rows / (torch.linalg.vector_norm(rows, dim=-1, keepdim=True)
                 + 1e-12)
    rn = rn * valid.unsqueeze(-1).to(torch.float32)
    preds[ci, si] = rows
    pnorm[ci, si] = rn
    masks[ci, si] = row_mask
    hit = (rows.argmax(-1) == lab) & valid
    acc[ci, si] = hit.to(torch.float32).sum(-1) / nv[ci]
    block = pnorm if all_clients else pnorm[cu]  # (K, M, V, C)
    # contract over the flattened (V·C) axis against each dirty client's
    # normalized block, _GRAM_ROWS rows per product: every product has
    # the same row count, so its summation order never depends on how
    # many slots were dirty
    rg, bt = rn.reshape(K, R, -1), block.flatten(2).transpose(1, 2)
    srows = (torch.cat([torch.bmm(rg[:, r:r + _GRAM_ROWS], bt)
                        for r in range(0, R, _GRAM_ROWS)], dim=1)
             / nv[cu][:, None, None])
    S[cu[:, None], slots] = srows                # dirty rows ...
    S[cu[:, None], :, slots] = srows             # ... + symmetric columns


class DeviceStoreBatch:
    """Device mirror of a fleet of `PredictionStore`s + cached (acc, S)."""

    def __init__(self, stores, device, v_max: Optional[int] = None):
        stores = list(stores)
        if not stores:
            raise ValueError("DeviceStoreBatch needs at least one store")
        cap = stores[0].capacity
        C = stores[0].n_classes
        self.device = torch.device(device)
        self.v_max = max(s.v_pad for s in stores) if v_max is None else v_max
        self.capacity, self.n_classes = cap, C
        self.stores: List = []
        self._dirty: List[set] = []        # per-client pending slot events
        self._cursor: List[int] = []       # per-client dirty-log position
        self.n_flushes = 0
        labels = np.full((len(stores), self.v_max), -1, np.int32)
        f32 = dict(dtype=torch.float32, device=self.device)
        self.preds = torch.zeros((len(stores), cap, self.v_max, C), **f32)
        self.pnorm = torch.zeros_like(self.preds)  # normalized mirror
        self.masks = torch.zeros((len(stores), cap), **f32)
        self.S = torch.zeros((len(stores), cap, cap), **f32)
        for i, s in enumerate(stores):
            self._attach(s, labels[i])
        self.labels = torch.as_tensor(labels, device=self.device)
        # fp32 valid-sample counts, the shared denominator of acc and S
        self.nv = torch.as_tensor(
            np.maximum((labels >= 0).sum(1), 1).astype(np.float32),
            device=self.device)
        acc0 = np.stack([np.full((cap,), _zero_row_acc(labels[i]), np.float32)
                         for i in range(len(stores))])
        self.acc = torch.as_tensor(acc0, device=self.device)

    def _attach(self, store, label_row: np.ndarray):
        if store.capacity != self.capacity or \
                store.n_classes != self.n_classes:
            raise ValueError(
                f"store (capacity={store.capacity}, n_classes="
                f"{store.n_classes}) does not match the batch "
                f"({self.capacity}, {self.n_classes})")
        if store.v_pad > self.v_max:
            raise ValueError(
                f"store v_pad={store.v_pad} exceeds the device batch pad "
                f"v_max={self.v_max}; provision the batch (engine v_max=...) "
                "for the widest validation set that can ever join")
        label_row[:store.v_pad] = store.labels
        self.stores.append(store)
        # everything already materialized (plus anything the store logged
        # before attach) is pending until the first flush; the cursor is
        # OURS, so other mirrors of the same store drain independently
        self._dirty.append(set(np.flatnonzero(store.mask).tolist())
                           | set(store.dirty_seq))
        self._cursor.append(store._dirty_clock)

    def append_store(self, store) -> None:
        """Grow the fleet by one client (churn join). The device buffers
        are reallocated with one extra row; the newcomer's slots flush on
        the next `flush()`."""
        row = np.full((self.v_max,), -1, np.int32)
        self._attach(store, row)
        dev = self.device
        self.labels = torch.cat([self.labels,
                                 torch.as_tensor(row, device=dev)[None]])
        self.nv = torch.cat([self.nv, torch.tensor(
            [float(max(int((row >= 0).sum()), 1))], device=dev)])

        def grow(a):
            return torch.cat([a, a.new_zeros((1,) + a.shape[1:])])
        self.preds, self.pnorm = grow(self.preds), grow(self.pnorm)
        self.masks, self.S = grow(self.masks), grow(self.S)
        self.acc = torch.cat([self.acc, torch.full(
            (1, self.capacity), float(_zero_row_acc(row)), device=dev)])

    def refresh_labels(self, client: int) -> None:
        """A store's validation set was replaced in place
        (`PredictionStore.refresh_validation`): re-upload its label row
        and mark EVERY slot dirty — including empty ones, whose cached
        acc seeds (`_zero_row_acc`) depend on the label-0 fraction — so
        the next flush rebuilds this client's statistics bit for bit as a
        from-scratch mirror of the refreshed store would."""
        store = self.stores[client]
        row = np.full((self.v_max,), -1, np.int32)
        row[:store.v_pad] = store.labels
        self.labels[client] = torch.as_tensor(row, device=self.device)
        self.nv[client] = float(max(int((row >= 0).sum()), 1))
        self.acc[client] = float(_zero_row_acc(row))
        self._dirty[client].update(range(self.capacity))

    def _drain(self):
        """Per-client sorted dirty-slot groups (advancing OUR cursor over
        each store's dirty log). Returns (groups [(client, slots)],
        n_distinct_dirty_slots)."""
        groups, n_dirty = [], 0
        for i, s in enumerate(self.stores):
            if s._dirty_clock > self._cursor[i]:
                self._dirty[i].update(
                    slot for slot, seq in s.dirty_seq.items()
                    if seq > self._cursor[i])
                self._cursor[i] = s._dirty_clock
            slots = sorted(self._dirty[i])
            self._dirty[i].clear()
            if slots:
                groups.append((i, slots))
                n_dirty += len(slots)
        return groups, n_dirty

    def _flush_bucket(self, groups, R: int):
        """One in-place scatter+recompute for all groups padded to R."""
        K = _pow2(len(groups))
        groups = groups + [groups[0]] * (K - len(groups))
        all_clients = (K == len(self.stores)
                       and all(g[0] == i for i, g in enumerate(groups)))
        rows = np.zeros((K * R, self.v_max, self.n_classes), np.float32)
        rmask = np.zeros((K * R,), np.float32)
        cu = np.zeros((K,), np.int64)
        slots = np.zeros((K, R), np.int64)
        for k, (c, blk) in enumerate(groups):
            s = self.stores[c]
            cu[k] = c
            slots[k] = blk + [blk[-1]] * (R - len(blk))
            rows[k * R:(k + 1) * R, :s.v_pad] = s.preds[slots[k]]
            rmask[k * R:(k + 1) * R] = s.mask[slots[k]]
        dev = self.device
        _flush(self.preds, self.pnorm, self.masks, self.acc, self.S,
               self.labels, self.nv, torch.as_tensor(rows, device=dev),
               torch.as_tensor(rmask, device=dev),
               torch.as_tensor(cu, device=dev),
               torch.as_tensor(slots, device=dev), all_clients=all_clients)
        self.n_flushes += 1

    def flush(self) -> int:
        """Drain the dirty queues into in-place scatters + stats updates.
        No launch when nothing changed since the last flush. Returns the
        number of distinct dirty slots drained. Groups are bucketed by
        their own power-of-two slot width, one scatter per bucket."""
        groups, n_dirty = self._drain()
        if not groups:
            return 0
        buckets = {}
        for g in groups:
            buckets.setdefault(max(_GRAM_ROWS, _pow2(len(g[1]))),
                               []).append(g)
        for R in sorted(buckets):
            self._flush_bucket(buckets[R], R)
        return n_dirty

    def gather(self, clients):
        """(preds, labels, masks, acc, S) for a client batch — one device
        `index_select` per buffer, no host restack. Call `flush()` first."""
        idx = torch.as_tensor(np.asarray(clients, np.int64),
                              device=self.device)
        return tuple(a.index_select(0, idx) for a in
                     (self.preds, self.labels, self.masks, self.acc, self.S))
