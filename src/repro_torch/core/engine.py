"""The selection engine (port of `repro/core/engine.py`): ONE batched
selection path over a fleet of `PredictionStore`s.

By default the engine owns a device-resident mirror of the whole fleet
(`DeviceStoreBatch`): stacked preds/labels/mask tensors live on the
device next to persistent per-client statistics `acc (N, M)` /
`S (N, M, M)`. A select drains the stores' dirty queues into in-place
scatters that touch only the changed rows, gathers the requested client
batch on the device, and answers with one batched NSGA-II run over the
CACHED statistics: per-client random streams, per-client model-slot
masks and one call of the batched ensemble_fitness wrapper per
objective evaluation (the CUDA kernel on the card). With
`device_resident=False` the reference's legacy restack path is kept for
benchmarking: every select re-stacks the requested stores on the host
(`stack_stores`) and re-derives the statistics from scratch
(`select_ensembles`); `store_batch` is then None.

Client batches are padded to the next power of two by repeating the
first client, as in the reference, so every batch of a run has one of
O(log N) shapes.

`replay` feeds selection outcomes from outside, as `run_nsga2_batched`'s
`draws=` feeds a GA's draws: when set, each select() still flushes the
device statistics, then takes its per-client results from
`replay(ready, t)` instead of running the GA. Parity tests replay the
reference engine's recorded selections through it, so that runs whose
events depend on what was selected (a serving monitor) can be held to
the reference exactly.
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional

import numpy as np
import torch

from repro_torch.core.bench import stack_stores
from repro_torch.core.device_store import DeviceStoreBatch
from repro_torch.core.device_store import _pow2 as _pow2_pad
from repro_torch.core.nsga2 import NSGAConfig, client_keys
from repro_torch.core.selection import (local_only_chromosome,
                                        select_ensembles,
                                        select_ensembles_from_stats)
from repro_torch.device import resolve_device
from repro_torch.obs.metrics import NULL_METRICS


class SelectionEngine:
    """Batched, incremental ensemble selection over a fleet of stores.
    `device` defaults to "cuda" (see `repro_torch.device`)."""

    def __init__(self, stores, nsga: NSGAConfig, seed: int = 0,
                 ensemble_k: Optional[int] = None,
                 device_resident: bool = True,
                 v_max: Optional[int] = None, metrics=None, device=None):
        self.stores = list(stores)
        self.nsga = nsga
        self.seed = seed
        self.device = resolve_device(device)
        self.ensemble_k = ensemble_k if ensemble_k is not None else max(nsga.k, 1)
        # pin the validation pad width globally: every batch, whatever its
        # membership, has the same (B, M, V, C) shape family. `v_max`
        # provisions for clients that JOIN LATER with a wider validation
        # set — without it, a wider late joiner is rejected (never
        # silently truncated) by `add_store`/`select`.
        widest = max(s.v_pad for s in self.stores)
        if v_max is not None and v_max < widest:
            raise ValueError(
                f"engine v_max={v_max} narrower than an attached store's "
                f"v_pad={widest}")
        self._v_max = widest if v_max is None else v_max
        self.store_batch = (DeviceStoreBatch(self.stores, self.device,
                                             v_max=self._v_max)
                            if device_resident else None)
        self.metrics = metrics if metrics is not None else NULL_METRICS
        self.results: Dict[int, dict] = {}   # client -> last selection dict
        self._keys_cache: Dict[tuple, list] = {}  # batch -> stream seeds
        self.replay = None   # (ready, t) -> {client: result}, see above

    def _check_width(self, store):
        if store.v_pad > self._v_max:
            raise ValueError(
                f"store v_pad={store.v_pad} exceeds the engine-wide pad "
                f"v_max={self._v_max}; construct the engine with "
                "v_max=<widest validation pad that can ever join> "
                "(a wider batch would silently truncate this client's "
                "validation set)")

    def add_store(self, store) -> int:
        """A client joining mid-run (churn): validate against the pinned
        engine-wide pad and mirror it into the device batch. Returns the
        new client index."""
        self._check_width(store)
        self.stores.append(store)
        if self.store_batch is not None:
            self.store_batch.append_store(store)
        return len(self.stores) - 1

    def min_models(self) -> int:
        """A client is selectable once it can fill an ensemble."""
        return max(1, self.nsga.k)

    def select(self, clients: Optional[Iterable[int]] = None,
               t: float = 0.0) -> Dict[int, dict]:
        """Run ONE batched NSGA-II over `clients` (default: all) and cache
        per-client results as numpy arrays. Clients whose stores cannot
        fill an ensemble yet are skipped. Returns {client: result}."""
        if clients is None:
            clients = range(len(self.stores))
        ready = [c for c in clients
                 if self.stores[c].n_present >= self.min_models()]
        if not ready:
            return {}
        for c in ready:
            self._check_width(self.stores[c])
        B = _pow2_pad(len(ready))
        mx = self.metrics
        if mx.enabled:
            mx.observe("engine.ga_batch_width", B, t=t)
        batch = ready + [ready[0]] * (B - len(ready))
        keys = self._keys_cache.get(tuple(batch))
        if keys is None:
            if len(self._keys_cache) >= 128:   # keep the cache bounded
                self._keys_cache.clear()
            keys = client_keys(self.seed, batch)
            self._keys_cache[tuple(batch)] = keys
        sb = self.store_batch
        if sb is not None:
            # scatter only the dirty rows, then gather the batch and its
            # cached stats on the device; a whole-fleet batch in natural
            # order reads the resident buffers directly
            if len(sb.stores) != len(self.stores):
                raise RuntimeError(
                    "engine.stores grew without the device mirror — "
                    "admit late joiners through engine.add_store()")
            if mx.enabled:
                with mx.stopwatch("engine.flush_wall_s")(t=t):
                    n_dirty = sb.flush()
                mx.observe("engine.flush_dirty_slots", n_dirty, t=t)
            else:
                sb.flush()
        if self.replay is not None:
            picked = self.replay(ready, t)
            rows = [{k: np.asarray(v) for k, v in picked[c].items()}
                    for c in ready]
        else:
            if sb is None:
                # legacy restack path: re-stack + re-derive everything
                preds, labels, masks = stack_stores(self.stores, batch,
                                                    v_to=self._v_max)
                dev = self.device
                out = select_ensembles(
                    torch.as_tensor(preds, device=dev),
                    torch.as_tensor(labels, device=dev), self.nsga,
                    keys=keys, model_mask=torch.as_tensor(masks,
                                                          device=dev))
            else:
                if batch == list(range(len(self.stores))):
                    preds, labels, masks, acc, S = (sb.preds, sb.labels,
                                                    sb.masks, sb.acc, sb.S)
                else:
                    preds, labels, masks, acc, S = sb.gather(batch)
                out = select_ensembles_from_stats(acc, S, preds, labels,
                                                  self.nsga, keys=keys,
                                                  model_mask=masks)
            # ONE device->host transfer per result key
            host = {k: v.cpu().numpy() for k, v in out.items()}
            rows = [{k: v[i] for k, v in host.items()}
                    for i in range(len(ready))]
        fresh = {}
        for c, res in zip(ready, rows):
            res["slot_gen"] = self.stores[c].slot_gen.copy()
            self.stores[c].note_selection(res["chromosome"] > 0.5, t)
            self.results[c] = res
            fresh[c] = res
        return fresh

    def refresh_validation(self, c: int, x_val, y_val, preds) -> None:
        """Serving-time drift refresh (DESIGN.md §14): swap client c's
        validation set in place and keep the device mirror coherent —
        the label row re-uploads and every slot goes dirty, so the next
        flush rebuilds the cached acc/S statistics against the shifted
        world. The client's cached selection result is KEPT: the
        resident ensemble keeps serving (the staleness the serving
        monitor measures) until a re-selection replaces it."""
        store = self.stores[c]
        self._check_width(store)
        store.refresh_validation(x_val, y_val, preds)
        if self.store_batch is not None:
            self.store_batch.refresh_labels(c)

    @staticmethod
    def _stale(store, res, chrom: np.ndarray) -> bool:
        """Does this cached chromosome reference a slot that was emptied
        (mask dropped) or remapped (generation bumped) since selection?"""
        sel = chrom > 0.5
        if not store.mask[sel].all():
            return True
        gen = res.get("slot_gen")
        return gen is not None and bool(
            (store.slot_gen[sel] != gen[sel]).any())

    def chromosome(self, c: int) -> np.ndarray:
        """The client's current ensemble, falling back to the local-only
        chromosome (negative-transfer safety valve) when no selection has
        run yet, the selected mask is empty, or a selected slot changed
        since the selection ran."""
        store = self.stores[c]
        res = self.results.get(c)
        chrom = None if res is None else np.asarray(res["chromosome"])
        if chrom is not None and self._stale(store, res, chrom):
            chrom = None
        if chrom is None or (chrom > 0.5).sum() == 0:
            present = store.mask.astype(np.float32)
            chrom = local_only_chromosome(
                torch.as_tensor(store.is_local() & store.mask),
                self.ensemble_k).numpy()
            chrom = chrom * present
        return chrom

    def serve(self, c: int, x: np.ndarray):
        """Masked lazy test-set serving: fetch only the selected members'
        predictions, mean-prob vote. Returns (vote (N, C), chromosome)."""
        store = self.stores[c]
        chrom = self.chromosome(c)
        mask = chrom > 0.5
        probs = store.predictions(x, mask=mask)  # zeros where masked off
        vote = (chrom[:, None, None] * probs).sum(0) / max(1, int(mask.sum()))
        return vote, chrom
