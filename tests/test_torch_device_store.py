"""The port's device-resident statistics: incremental flushes equal a
from-scratch flush bit for bit (on the CPU), and the cached acc/S match
the reference's `selection_stats` on the same numpy predictions (fp32,
atol 1e-6). The engine over them reports its metrics."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.core.selection import selection_stats  # noqa: E402
from repro_torch.core.bench import BenchEntry, PredictionStore, stack_stores  # noqa: E402
from repro_torch.core.device_store import DeviceStoreBatch  # noqa: E402
from repro_torch.core.engine import SelectionEngine  # noqa: E402
from repro_torch.core.nsga2 import NSGAConfig  # noqa: E402
from repro_torch.obs.metrics import Metrics  # noqa: E402

N, M, C = 3, 10, 4
V = (37, 50, 20)


def _stores(seed):
    rng = np.random.default_rng(seed)
    stores = []
    for c in range(N):
        y = rng.integers(0, C, V[c]).astype(np.int32)
        stores.append(PredictionStore(c, M, np.zeros((V[c], 1), np.float32),
                                      y, C, v_pad=max(V)))
    return stores, rng


def _add(store, slot, rng):
    p = rng.random((store.n_val, C)).astype(np.float32)
    p /= p.sum(-1, keepdims=True)
    store.add(BenchEntry(model_id=slot, owner=slot % N, family="f",
                         predict=None), preds=p)


def _waves(seed):
    """The same final store contents reached in four dirty waves (slots
    re-added with new predictions), and the device batch that flushed
    after each wave."""
    stores, rng = _stores(seed)
    batch = DeviceStoreBatch(stores, "cpu")
    # a wide first flush (16 rows), then narrow ones (8 rows): client 1
    # keeps two never-filled slots
    waves = [[(c, s) for c in (0, 2) for s in range(M)]
             + [(1, s) for s in range(M - 2)],
             [(0, 3)], [(1, 0), (1, 1), (1, 2), (2, 5)],
             [(0, 3), (0, 7), (2, 1), (2, 2), (2, 9)]]
    for wave in waves:
        for c, slot in wave:
            _add(stores[c], slot, rng)
        assert batch.flush() == len(set(wave))
    return stores, batch


def test_incremental_flush_bitwise_equals_rebuild():
    stores, inc = _waves(0)
    fresh = DeviceStoreBatch(stores, "cpu")
    fresh.flush()
    assert inc.n_flushes > fresh.n_flushes
    for name in ("preds", "pnorm", "masks", "acc", "S"):
        a, b = getattr(inc, name), getattr(fresh, name)
        assert torch.equal(a, b), name
    assert torch.equal(inc.S, inc.S.transpose(1, 2))
    assert inc.flush() == 0           # nothing dirty: no launch


def test_cached_stats_match_reference_selection_stats():
    stores, batch = _waves(1)
    preds, labels, masks = stack_stores(stores, v_to=batch.v_max)
    acc, S = selection_stats(preds, labels)
    np.testing.assert_array_equal(batch.acc.numpy(), np.asarray(acc))
    np.testing.assert_allclose(batch.S.numpy(), np.asarray(S), atol=1e-6,
                               rtol=1e-5)
    np.testing.assert_array_equal(batch.masks.numpy(), masks)
    got = batch.gather([2, 0, 2])
    for t, full in zip(got, (batch.preds, batch.labels, batch.masks,
                             batch.acc, batch.S)):
        assert torch.equal(t, full[[2, 0, 2]])


def test_engine_records_its_metrics():
    """An enabled registry sees the engine's batch width, flush size and
    flush time; a select over three clients pads the batch to four."""
    stores, _ = _stores(2)
    rng = np.random.default_rng(3)
    for c, store in enumerate(stores):
        for slot in range(M - c):
            _add(store, slot, rng)
    mx = Metrics()
    engine = SelectionEngine(stores, NSGAConfig(pop_size=8, generations=2,
                                                k=2),
                             metrics=mx, device="cpu")
    assert sorted(engine.select(t=1.0)) == [0, 1, 2]
    engine.select([1], t=2.0)                    # nothing dirty any more
    frame = mx.frame()
    assert frame.scalars["engine.ga_batch_width"] == 1
    assert frame.series["engine.ga_batch_width"] == [[1.0, 4.0], [2.0, 1.0]]
    assert frame.series["engine.flush_dirty_slots"] == [
        [1.0, float(3 * M - 3)], [2.0, 0.0]]
    assert [t for t, _ in frame.series["engine.flush_wall_s"]] == [1.0, 2.0]
