"""The port's device-resident statistics: incremental flushes equal a
from-scratch flush bit for bit (on the CPU), and the cached acc/S match
the reference's `selection_stats` on the same numpy predictions (fp32,
atol 1e-6). The engine over them reports its metrics; the restack path
(`device_resident=False`) picks what the resident path picks; late
joiners are admitted through `add_store` (or refused, never truncated);
`PredictionStore.padded` / `val_predictions` are the reference's views."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.core.selection import selection_stats  # noqa: E402
from repro_torch.core.bench import (BenchEntry, PredictionStore,  # noqa: E402
                                    StreamingPredictionStore, stack_stores)
from repro_torch.core.device_store import DeviceStoreBatch  # noqa: E402
from repro_torch.core.engine import SelectionEngine  # noqa: E402
from repro_torch.core.nsga2 import NSGAConfig  # noqa: E402
from repro_torch.core.selection import (  # noqa: E402
    selection_stats as tselection_stats)
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


# ---- the restack path and late joiners (tests/test_device_store.py) ------

CAP, VR, CR = 8, 96, 5
CFG = NSGAConfig(pop_size=16, generations=6, k=3, seed=3)


def _entry(mid, owner=None):
    return BenchEntry(model_id=mid, owner=mid if owner is None else owner,
                      family="f", predict=lambda x: np.full(
                          (len(x), CR), 1.0 / CR, np.float32))


def _rand_preds(rng, v=VR):
    p = rng.random((v, CR)).astype(np.float32)
    return p / p.sum(1, keepdims=True)


def _fleet(seed, n=4):
    rng = np.random.default_rng(seed)
    return [StreamingPredictionStore(c, CAP, np.zeros((VR, 2), np.float32),
                                     rng.integers(0, CR, VR), CR)
            for c in range(n)], rng


def _churn(stores, rng, n_ops=60):
    """Randomized adds with eviction pressure (3x more global ids than
    physical slots)."""
    for op in range(n_ops):
        c = int(rng.integers(0, len(stores)))
        gid = int(rng.integers(0, 3 * CAP))
        stores[c].add(_entry(gid, owner=gid % len(stores)),
                      preds=_rand_preds(rng), t=float(op))


def test_engine_incremental_matches_restack_engine():
    """The resident path and the restack path pick identical ensembles
    for the same store state and seeds: at these shapes the incremental
    statistics equal `selection_stats` bit for bit on the CPU."""
    stores_a, rng_a = _fleet(4)
    stores_b, rng_b = _fleet(4)
    eng_inc = SelectionEngine(stores_a, CFG, ensemble_k=CFG.k, device="cpu")
    eng_re = SelectionEngine(stores_b, CFG, ensemble_k=CFG.k,
                             device_resident=False, device="cpu")
    assert eng_inc.store_batch is not None and eng_re.store_batch is None
    _churn(stores_a, rng_a)
    _churn(stores_b, rng_b)
    for _ in range(2):
        ra = eng_inc.select(t=1.0)
        rb = eng_re.select(t=1.0)
        assert sorted(ra) == sorted(rb)
        for c in ra:
            np.testing.assert_array_equal(ra[c]["chromosome"],
                                          rb[c]["chromosome"])
        _churn(stores_a, rng_a, n_ops=10)
        _churn(stores_b, rng_b, n_ops=10)
    eng_inc.select(t=2.0)
    eng_re.select(t=2.0)
    for c in range(len(stores_a)):
        np.testing.assert_array_equal(eng_inc.results[c]["chromosome"],
                                      eng_re.results[c]["chromosome"])
        np.testing.assert_array_equal(eng_inc.results[c]["member_acc"],
                                      eng_re.results[c]["member_acc"])
    preds, labels, _ = stack_stores(stores_a, v_to=eng_inc.store_batch.v_max)
    acc, S = tselection_stats(torch.as_tensor(preds), torch.as_tensor(labels))
    assert torch.equal(acc, eng_inc.store_batch.acc)
    assert torch.equal(S, eng_inc.store_batch.S)


def test_restack_matches_resident_by_outcome_on_a_prediction_world():
    """At a prediction world's shapes (32 slots, V = 128, C = 8) the
    incremental S differs from `selection_stats` in the last bits, so the
    two paths' GAs may part ways: held by outcome (k members everywhere,
    fleet-mean validation accuracy within 0.02) and by statistics (acc
    equal, S within 1e-5)."""
    from repro_torch.sim.build import (build_prediction_world,
                                       build_world_stores)
    from repro_torch.sim.spec import DataSpec
    data = DataSpec(kind="prediction_world", n_clients=16, n_classes=8,
                    n_val=128, models_per_client=2, seed=17)
    labels, mats = build_prediction_world(data, 0)
    fleets = []
    for resident in (True, False):
        stores = build_world_stores(data, labels, None)
        for c, s in enumerate(stores):
            for gid in range(32):
                s.add(BenchEntry(model_id=gid, owner=gid // 2, family="f",
                                 predict=None), preds=mats[(c, gid)])
        eng = SelectionEngine(stores, NSGAConfig(pop_size=24, generations=8,
                                                 k=5),
                              device_resident=resident, device="cpu")
        fleets.append((eng, eng.select()))
    (inc, ra), (_, rb) = fleets
    for r in (ra, rb):
        assert sorted(r) == list(range(16))
        assert {int(v["chromosome"].sum()) for v in r.values()} == {5}
    gap = abs(np.mean([float(v["val_accuracy"]) for v in ra.values()])
              - np.mean([float(v["val_accuracy"]) for v in rb.values()]))
    assert gap <= 0.02
    preds, lab, _ = stack_stores(inc.stores, v_to=inc.store_batch.v_max)
    acc, S = tselection_stats(torch.as_tensor(preds), torch.as_tensor(lab))
    assert torch.equal(acc, inc.store_batch.acc)
    np.testing.assert_allclose(S.numpy(), inc.store_batch.S.numpy(),
                               atol=1e-5)


def test_late_wider_client_is_rejected_not_truncated():
    stores, rng = _fleet(8)
    engine = SelectionEngine(stores, CFG, ensemble_k=CFG.k, device="cpu")
    wide = PredictionStore(4, CAP, np.zeros((VR, 2), np.float32),
                           rng.integers(0, CR, 4 * VR), CR)
    assert wide.v_pad > engine._v_max
    with pytest.raises(ValueError, match="v_pad"):
        engine.add_store(wide)
    # the restack path refuses too (no silent truncation)
    eng_re = SelectionEngine(stores, CFG, ensemble_k=CFG.k,
                             device_resident=False, device="cpu")
    eng_re.stores.append(wide)
    for gid in range(CFG.k):
        wide.add(_entry(gid, owner=4), preds=np.full(
            (4 * VR, CR), 1.0 / CR, np.float32))
    with pytest.raises(ValueError, match="v_pad"):
        eng_re.select()
    # a store appended behind the resident engine's back is refused
    stores.append(StreamingPredictionStore(
        4, CAP, np.zeros((VR, 2), np.float32), rng.integers(0, CR, VR), CR))
    engine.stores.append(stores[-1])
    _churn(stores, rng, n_ops=40)
    with pytest.raises(RuntimeError, match="add_store"):
        engine.select()


def test_provisioned_v_max_admits_wider_late_joiner():
    stores, rng = _fleet(9)
    with pytest.raises(ValueError, match="narrower"):
        SelectionEngine(stores, CFG, v_max=32, device="cpu")
    v_max = 4 * VR + ((-4 * VR) % 128)
    engine = SelectionEngine(stores, CFG, ensemble_k=CFG.k, v_max=v_max,
                             device="cpu")
    _churn(stores, rng, n_ops=30)
    wide = PredictionStore(4, CAP, np.zeros((4 * VR, 2), np.float32),
                           rng.integers(0, CR, 4 * VR), CR)
    idx = engine.add_store(wide)
    assert idx == 4 and engine.store_batch.preds.shape[0] == 5
    for gid in range(CAP):
        wide.add(_entry(gid, owner=4), preds=_rand_preds(rng, 4 * VR))
    res = engine.select()
    assert idx in res                            # the late joiner selects
    assert res[idx]["chromosome"].sum() == CFG.k
    # its statistics equal a from-scratch mirror of the grown fleet
    fresh = DeviceStoreBatch(engine.stores, "cpu", v_max=v_max)
    fresh.flush()
    for name in ("preds", "labels", "masks", "acc", "S", "nv"):
        assert torch.equal(getattr(engine.store_batch, name),
                           getattr(fresh, name)), name


def test_padded_and_val_predictions():
    rng = np.random.default_rng(5)
    y = rng.integers(0, CR, 37).astype(np.int32)
    store = PredictionStore(0, 4, np.zeros((37, 2), np.float32), y, CR)
    p = _rand_preds(rng, 37)
    store.add(_entry(2, owner=0), preds=p)
    preds, labels, mask = store.padded()
    assert preds.shape == (4, store.v_pad, CR) and store.v_pad == 128
    np.testing.assert_array_equal(labels[:37], y)
    assert (labels[37:] == -1).all()
    np.testing.assert_array_equal(mask, [False, False, True, False])
    val = store.val_predictions()
    assert val.shape == (4, 37, CR)
    np.testing.assert_array_equal(val[2], p)
    assert not val[[0, 1, 3]].any()
    np.testing.assert_array_equal(store.val_predictions(store.x_val), val)
    with pytest.raises(ValueError, match="validation set"):
        store.val_predictions(np.zeros((5, 2), np.float32))
