"""The port's online serving layer against the JAX package's, on the CPU.

(tests/test_torch_serve.py holds the LLM ensemble serving path.)

- Traffic (poisson, bursty) and drift (label shift, covariate shift)
  give the reference's schedules, client sets, weights and transforms.
- After a validation refresh, an incremental device flush equals a
  fresh rebuild bit for bit (as tests/test_serve.py holds of the
  reference), and the engine's refresh leaves the reference's store.
- `core.dynamic`: `knn_competence`, `dynamic_ensemble_predict` and
  `des_accuracy` equal the reference's exactly on inputs whose distances
  are separated, tied distances and tied competences included (the
  lower index first, as `jax.lax.top_k`); where two distances differ in
  the last bits only, the two packages' fp32 products may order them
  differently, so random inputs are held to the reference's competence
  within 1 / K of a neighbour swap on at most 2% of the rows.
- The monitor's trigger, debounce and reset, regret and latency, and
  the dynamic decode, driven directly, give the reference's answers.
- examples/specs/serve_drift.json: with the monitor off, the events and
  the net dict equal the reference's (the window accuracy, the one
  figure that depends on what was selected, within a band); with the
  monitor on and the reference's selections replayed through the
  engine's `replay` hook, everything equals the reference's, window
  accuracy and regret included; with the monitor on and free, by
  outcome.
- On the card (`cuda` marker): a tiny image world served with the
  `dynamic` policy.
"""
import copy
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.bench import BenchEntry, PredictionStore  # noqa: E402
from repro_torch.core.device_store import DeviceStoreBatch  # noqa: E402
from repro_torch.core.dynamic import (des_accuracy,  # noqa: E402
                                      dynamic_ensemble_predict,
                                      knn_competence)
from repro_torch.serve import (BurstyTraffic,  # noqa: E402
                               BurstyTrafficConfig, CovariateShiftConfig,
                               CovariateShiftDrift, LabelShiftConfig,
                               LabelShiftDrift, PoissonTraffic,
                               PoissonTrafficConfig)
from repro_torch.serve import traffic as ttraffic  # noqa: E402
from repro_torch.sim import Experiment, ExperimentSpec  # noqa: E402

REPO = os.path.join(os.path.dirname(__file__), "..")
SERVE_DRIFT = os.path.join(REPO, "examples", "specs", "serve_drift.json")
V, C = 64, 8
WINDOW_ACC_BAND = 0.1    # free GA runs: the answers depend on the winners


from _torch_threads import one_thread as _one_thread  # noqa: E402,F401


@pytest.fixture(scope="module")
def js():
    """The reference's serving package (numpy only)."""
    import repro.serve as serve
    from repro.serve import traffic
    return serve, traffic


@pytest.fixture(scope="module")
def jsim():
    """The reference's Experiment layer (needs JAX)."""
    pytest.importorskip("jax")
    from repro.sim import Experiment as JExperiment
    from repro.sim import ExperimentSpec as JSpec

    def make(d):
        return JExperiment.from_spec(JSpec.from_dict(copy.deepcopy(d)))
    return make


@pytest.fixture(scope="module")
def jdyn():
    pytest.importorskip("jax")
    from repro.core import dynamic
    return dynamic


def _port(d, device="cpu"):
    return Experiment.from_spec(ExperimentSpec.from_dict(copy.deepcopy(d)),
                                device=device)


def _spec_dict(monitor=True):
    with open(SERVE_DRIFT) as f:
        d = json.load(f)
    d.pop("smoke_overrides", None)
    d["serve"]["monitor"] = monitor
    return d


# ---- traffic and drift ------------------------------------------------------

@pytest.mark.parametrize("kind,params", [
    ("poisson", dict(rate=60.0, batch=8, start=2.5, duration=12.0)),
    ("poisson", dict(rate=20.0, batch=4, start=0.0, duration=3.0,
                     fraction=0.5, seed=4)),
    ("poisson", dict(rate=5.0, batch=1, duration=4.0, clients=(3, 0))),
    ("bursty", dict(rate=30.0, batch=6, duration=6.0, amp=0.8,
                    period=2.0, seed=2)),
    ("bursty", dict(rate=10.0, amp=0.0, fraction=0.3, duration=5.0))])
def test_traffic_matches_reference(js, kind, params):
    jserve, jtraffic = js
    assert ttraffic._SERVE_SALT == jtraffic._SERVE_SALT == 0x5E21D0C7
    if kind == "poisson":
        ours = PoissonTraffic(PoissonTrafficConfig(**params))
        theirs = jserve.PoissonTraffic(jserve.PoissonTrafficConfig(**params))
    else:
        ours = BurstyTraffic(BurstyTrafficConfig(**params))
        theirs = jserve.BurstyTraffic(jserve.BurstyTrafficConfig(**params))
    assert ours.serving_clients(10) == theirs.serving_clients(10)
    events = ours.events(10)
    assert events and events == theirs.events(10)


@pytest.mark.parametrize("params", [dict(rate=0.0), dict(batch=0),
                                    dict(duration=float("inf"))])
def test_traffic_refusals_match_reference(js, params):
    jserve, _ = js
    with pytest.raises(ValueError) as a:
        PoissonTraffic(PoissonTrafficConfig(**params))
    with pytest.raises(ValueError) as b:
        jserve.PoissonTraffic(jserve.PoissonTrafficConfig(**params))
    assert str(a.value) == str(b.value)


def test_drift_matches_reference(js):
    jserve, _ = js
    for p in (dict(at=9.5, classes=(7,), skew=1.0),
              dict(at=1.0, classes=(2, 0), skew=0.4, fraction=0.5, seed=3)):
        ours = LabelShiftDrift(LabelShiftConfig(**p))
        theirs = jserve.LabelShiftDrift(jserve.LabelShiftConfig(**p))
        assert ours.clients_affected(10) == theirs.clients_affected(10)
        np.testing.assert_array_equal(ours.weights(C), theirs.weights(C))
    p = dict(at=4.0, severity=0.3, fraction=0.5, seed=1)
    ours = CovariateShiftDrift(CovariateShiftConfig(**p))
    theirs = jserve.CovariateShiftDrift(jserve.CovariateShiftConfig(**p))
    assert ours.clients_affected(10) == theirs.clients_affected(10)
    x = np.random.default_rng(0).random((5, 4, 4, 3)).astype(np.float32)
    np.testing.assert_array_equal(ours.transform(x), theirs.transform(x))
    with pytest.raises(ValueError) as a:
        LabelShiftDrift(LabelShiftConfig(classes=(9,))).weights(C)
    with pytest.raises(ValueError) as b:
        jserve.LabelShiftDrift(jserve.LabelShiftConfig(classes=(9,))
                               ).weights(C)
    assert str(a.value) == str(b.value)


# ---- validation refresh -------------------------------------------------------

def _stores(rng, n=3, cap=4, cls=PredictionStore):
    stores = []
    for c in range(n):
        s = cls(c, cap, np.zeros((V, 2), np.float32),
                rng.integers(0, C, V), C)
        for m in range(3):
            p = rng.random((V, C)).astype(np.float32)
            s.add(BenchEntry(model_id=m, owner=c, family="f",
                             predict=lambda x: None),
                  preds=p / p.sum(1, keepdims=True))
        stores.append(s)
    return stores


def test_device_refresh_labels_matches_fresh_rebuild():
    """The port's copy of tests/test_serve.py's check: after a drift
    resample of one client's validation rows, flushing the marked mirror
    equals rebuilding a fresh one over the mutated stores, bit for bit."""
    rng = np.random.default_rng(7)
    stores = _stores(rng)
    dev = DeviceStoreBatch(stores, "cpu")
    dev.flush()
    s = stores[1]
    ridx = rng.permutation(V)
    s.refresh_validation(s.x_val, np.asarray(s.labels[:V])[ridx],
                         np.asarray(s.preds[:, :V])[:, ridx])
    dev.refresh_labels(1)
    dev.flush()
    fresh = DeviceStoreBatch(stores, "cpu")
    fresh.flush()
    for name in ("preds", "pnorm", "masks", "labels", "nv", "acc", "S"):
        assert torch.equal(getattr(dev, name), getattr(fresh, name)), name


def test_engine_refresh_validation_matches_reference_store():
    from repro.core.bench import PredictionStore as JStore
    from repro_torch.core.engine import SelectionEngine
    from repro_torch.core.nsga2 import NSGAConfig
    ours = _stores(np.random.default_rng(8))
    theirs = _stores(np.random.default_rng(8), cls=JStore)
    eng = SelectionEngine(ours, NSGAConfig(pop_size=8, generations=2, k=2),
                          device="cpu")
    eng.select(t=1.0)
    before = copy.deepcopy(eng.results)
    ridx = np.random.default_rng(9).choice(V, V)
    for s in (ours[2], theirs[2]):
        y = np.asarray(s.labels[:V])
        args = (s.x_val[ridx], y[ridx], s.preds[:, ridx])
        if s is ours[2]:
            eng.refresh_validation(2, *args)
        else:
            s.refresh_validation(*args)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a.preds, b.preds)
        np.testing.assert_array_equal(a.labels, b.labels)
        assert a.dirty_seq == b.dirty_seq
    # the resident ensemble keeps serving until a re-selection
    np.testing.assert_array_equal(eng.chromosome(2),
                                  before[2]["chromosome"])
    eng.select([2], t=2.0)
    sb = eng.store_batch
    fresh = DeviceStoreBatch(ours, "cpu")
    fresh.flush()
    assert torch.equal(sb.acc, fresh.acc) and torch.equal(sb.S, fresh.S)


# ---- dynamic selection ----------------------------------------------------------

def _des_inputs(seed, T=24, Vv=40, M=6, dup=False):
    rng = np.random.default_rng(seed)
    # a coarse grid keeps every distance an exact multiple of 1/64, so
    # fp32 orders them the same way in every summation order
    xv = rng.integers(0, 8, (Vv, 3, 2)).astype(np.float32) / 8
    xt = rng.integers(0, 8, (T, 3, 2)).astype(np.float32) / 8
    if dup:            # duplicated validation rows: tied distances
        xv[Vv // 2:] = xv[:Vv // 2]
    correct = (rng.random((M, Vv)) < 0.6).astype(np.float32)
    probs = rng.random((M, T, C)).astype(np.float32)
    return xt, xv, correct, probs / probs.sum(-1, keepdims=True)


@pytest.mark.parametrize("dup", [False, True])
@pytest.mark.parametrize("K", [1, 5, 15])
def test_knn_competence_matches_reference(jdyn, dup, K):
    xt, xv, correct, _ = _des_inputs(K, dup=dup)
    ours = knn_competence(torch.as_tensor(xt), torch.as_tensor(xv),
                          torch.as_tensor(correct), K=K).numpy()
    theirs = np.asarray(jdyn.knn_competence(xt, xv, correct, K=K))
    np.testing.assert_array_equal(ours, theirs)


def test_knn_competence_breaks_distance_ties_by_lower_index(jdyn):
    """Two validation rows at the same distance, only one of them taken
    (K = 1): the lower index wins, and it is the one whose bit counts."""
    xv = np.array([[1.0], [0.0], [-1.0]], np.float32)
    xt = np.array([[0.0], [0.5]], np.float32)
    correct = np.array([[0.0, 1.0, 1.0], [1.0, 0.0, 0.0]], np.float32)
    xv2 = np.array([[1.0], [3.0], [-1.0]], np.float32)   # 1 and -1 tie
    xt2 = np.array([[0.0]], np.float32)
    for a, b in ((xt, xv), (xt2, xv2)):
        ours = knn_competence(torch.as_tensor(a), torch.as_tensor(b),
                              torch.as_tensor(correct), K=1).numpy()
        np.testing.assert_array_equal(
            ours, np.asarray(jdyn.knn_competence(a, b, correct, K=1)))
    np.testing.assert_array_equal(ours, [[0.0, 1.0]])   # row 0, not row 2


def test_knn_competence_on_continuous_inputs_within_a_swap(jdyn):
    rng = np.random.default_rng(11)
    xt = rng.random((64, 3, 4, 4)).astype(np.float32)
    xv = rng.random((96, 3, 4, 4)).astype(np.float32)
    correct = (rng.random((7, 96)) < 0.5).astype(np.float32)
    K = 7
    ours = knn_competence(torch.as_tensor(xt), torch.as_tensor(xv),
                          torch.as_tensor(correct), K=K).numpy()
    theirs = np.asarray(jdyn.knn_competence(xt, xv, correct, K=K))
    rows = np.flatnonzero((ours != theirs).any(1))
    assert len(rows) <= 0.02 * len(xt)
    assert np.abs(ours - theirs).max(initial=0.0) <= 1.0 / K + 1e-7


@pytest.mark.parametrize("k", [1, 3, 6])
def test_dynamic_predict_matches_reference_with_ties(jdyn, k):
    _, _, _, probs = _des_inputs(k)
    T, M = probs.shape[1], probs.shape[0]
    rng = np.random.default_rng(k)
    # competences on a grid of quarters: many ties among the top k
    comp = rng.integers(0, 4, (T, M)).astype(np.float32) / 4
    ours = dynamic_ensemble_predict(torch.as_tensor(probs),
                                    torch.as_tensor(comp), k=k).numpy()
    theirs = np.asarray(jdyn.dynamic_ensemble_predict(probs, comp, k=k))
    np.testing.assert_array_equal(ours, theirs)


def test_des_accuracy_matches_reference(jdyn):
    xt, xv, _, probs = _des_inputs(3)
    rng = np.random.default_rng(3)
    yv = rng.integers(0, C, xv.shape[0])
    yt = rng.integers(0, C, xt.shape[0])
    pv = rng.random((probs.shape[0], xv.shape[0], C)).astype(np.float32)
    args = (xt, yt, xv, yv, pv, probs)
    ours = des_accuracy(*(torch.as_tensor(a) for a in args), K=5, k=3)
    theirs = jdyn.des_accuracy(*args, K=5, k=3)
    assert float(ours) == float(theirs)


# ---- the serving engine, driven directly ---------------------------------------

class _Store:
    """What the serving engine reads of a store: a fixed bench of
    closures (no params, so every forward is the per-entry loop)."""

    def __init__(self, client, preds, labels, x_val, owners):
        self.client, self.preds = client, preds
        self.labels, self.n_val, self.x_val = labels, len(labels), x_val
        self.mask = np.ones(len(preds), bool)
        self.capacity = len(preds)
        self.owners = owners

    @property
    def n_present(self):
        return int(self.mask.sum())

    def predictions(self, x, mask=None):
        out = np.zeros((self.capacity, len(x), self.preds.shape[-1]),
                       np.float32)
        for i in range(self.capacity):
            if mask is None or mask[i]:
                out[i] = np.roll(self.preds[i, :len(x)], i, axis=0)
        return out


class _Engine:
    """A fixed chromosome a client, replaced on `select`."""

    def __init__(self, chroms, k=2, device="cpu"):
        self.chroms, self.ensemble_k = chroms, k
        self.device = torch.device(device)
        self.refreshed = []

    def chromosome(self, c):
        return self.chroms[c]

    def refresh_validation(self, c, x, y, p):
        self.refreshed.append((c, np.asarray(x).copy(), np.asarray(y).copy(),
                               np.asarray(p).copy()))


class _Traffic:
    kind = "scripted"

    def __init__(self, events):
        self._events = events

    def events(self, n):
        return list(self._events)


def _serving(pkg, policy="ensemble", monitor=True, drifts=()):
    rng = np.random.default_rng(21)
    n, M = 2, 4
    labels = [rng.integers(0, C, V) for _ in range(n)]
    stores = []
    for c in range(n):
        p = rng.random((M, V, C)).astype(np.float32)
        # member 0 knows every label but class 1's, the rest guess: a
        # shift towards class 1 breaches the monitor
        known = np.where(labels[c] == 1, 2, labels[c])
        p[0, np.arange(V), known] += 3.0
        p /= p.sum(-1, keepdims=True)
        stores.append(_Store(c, p, labels[c],
                             rng.random((V, 2, 2)).astype(np.float32),
                             np.array([c, c, 1 - c, 1 - c])))
    chroms = {c: np.array([1, 1, 0, 0], np.float32) for c in range(n)}
    engine = _Engine(chroms)
    events = [(0.1 * i, i % n, 8) for i in range(60)]
    pools = ([(s.x_val, s.labels) for s in stores]
             if policy == "dynamic" else None)
    cfg = pkg.ServeConfig(policy=policy, monitor=monitor, window=16,
                          threshold=0.05, debounce=0.3, seed=5)
    return pkg.ServingEngine(cfg, _Traffic(events), list(drifts), n, C,
                             stores, engine, query_pools=pools), engine


def _drive(sv, engine, new_chrom):
    """Queries, a drift half way, a re-selection after every breach."""
    out = []
    for t, kind, c, pay in sorted(sv.initial_events(),
                                  key=lambda e: (e[0], e[1])):
        if kind == "drift":
            sv.on_drift(pay, t)
            continue
        hit = sv.on_query(c, t, *pay)
        out.append(hit)
        if hit:
            engine.chroms[c] = new_chrom
            sv.note_selected([c], t)
    return out


@pytest.mark.parametrize("policy,monitor", [("ensemble", True),
                                            ("ensemble", False),
                                            ("dynamic", True)])
def test_serving_engine_matches_reference(js, policy, monitor):
    jserve, _ = js
    import repro_torch.serve as tserve
    runs = []
    for pkg in (tserve, jserve):
        drifts = [pkg.LabelShiftDrift(pkg.LabelShiftConfig(
            at=3.0, classes=(1,), skew=0.9)),
            pkg.CovariateShiftDrift(pkg.CovariateShiftConfig(
                at=4.0, severity=0.5))]
        if policy == "ensemble":
            drifts = drifts[:1]
        sv, engine = _serving(pkg, policy, monitor, drifts)
        triggers = _drive(sv, engine, np.array([0, 1, 1, 0], np.float32))
        runs.append((triggers, sv.stats_dict(), sv.latency_percentiles(),
                     engine.refreshed))
    ours, theirs = runs
    assert ours[:3] == theirs[:3]
    for a, b in zip(ours[3], theirs[3]):
        assert a[0] == b[0]
        for x, y in zip(a[1:], b[1:]):
            np.testing.assert_array_equal(x, y)
    if monitor and policy == "ensemble":
        assert sum(ours[0]) >= 1 and ours[1]["regret"] != 0.0
    if not monitor:
        assert not any(ours[0]) and ours[1]["n_reselections"] == 0


def test_monitor_debounce_and_reset():
    """A breach re-selects at most once per debounce; a re-selection
    clears the window and its peak, so the next breach needs a warm
    window again."""
    import repro_torch.serve as tserve
    sv, engine = _serving(tserve, drifts=[tserve.LabelShiftDrift(
        tserve.LabelShiftConfig(at=3.0, classes=(1,), skew=0.9))])
    hits = []
    for t, kind, c, pay in sorted(sv.initial_events(),
                                  key=lambda e: (e[0], e[1])):
        if kind == "drift":
            sv.on_drift(pay, t)
        elif sv.on_query(c, t, *pay):
            hits.append((c, t))
    per_client = {}
    for c, t in hits:
        per_client.setdefault(c, []).append(t)
    for ts in per_client.values():
        assert all(b - a >= sv.cfg.debounce for a, b in zip(ts, ts[1:]))
    assert hits
    c = hits[0][0]
    sv.note_selected([c], 9.0)
    assert len(sv._window[c]) == 0 and c not in sv._peak
    assert not sv.on_query(c, 9.1, 99, 8)    # cold window: no breach


# ---- serve_drift.json -------------------------------------------------------

@pytest.fixture(scope="module")
def monitor_off(jsim):
    d = _spec_dict(monitor=False)
    return _port(d).run(), jsim(d).run()


@pytest.mark.parametrize("field", ["events", "bench_sizes",
                                   "select_batches"])
def test_serve_drift_monitor_off_matches_reference(monitor_off, field):
    ours, theirs = monitor_off
    assert getattr(ours.trace, field) == getattr(theirs.trace, field)


def test_serve_drift_monitor_off_net_matches_reference(monitor_off):
    ours, theirs = monitor_off
    a, b = copy.deepcopy(ours.net), copy.deepcopy(theirs.net)
    wa, wb = a["serve"].pop("window_acc"), b["serve"].pop("window_acc")
    assert a == b
    assert a["serve"]["n_reselections"] == 0 and a["serve"]["regret"] == 0
    assert abs(wa - wb) <= WINDOW_ACC_BAND


def _recording(exp):
    """Wrap the reference engine's select: every batch's results, in
    order, with the clients and time they answered."""
    exp.build()
    log, select = [], exp.engine.select

    def recorded(clients=None, t=0.0):
        fresh = select(clients, t=t)
        log.append((sorted(fresh), t, {
            c: {k: np.asarray(v) for k, v in r.items()}
            for c, r in fresh.items()}))
        return fresh
    exp.engine.select = recorded
    return log


def _replaying(exp, log):
    exp.build()
    # a select with no client able to fill an ensemble returns before the
    # GA (and before the hook) in both engines
    batches = iter([entry for entry in log if entry[0]])

    def replay(ready, t):
        clients, t_rec, results = next(batches)
        assert clients == sorted(ready) and t_rec == t
        return results
    exp.engine.replay = replay


def test_serve_drift_monitor_on_replayed_matches_reference(jsim):
    d = _spec_dict(monitor=True)
    theirs_exp = jsim(d)
    log = _recording(theirs_exp)
    theirs = theirs_exp.run()
    ours_exp = _port(d)
    _replaying(ours_exp, log)
    ours = ours_exp.run()
    for field in ("events", "net", "bench_sizes", "select_batches"):
        assert getattr(ours.trace, field) == getattr(theirs.trace, field)
    assert ours.selections == theirs.selections
    assert ours.net["serve"]["n_reselections"] >= 1


def test_serve_drift_monitor_on_free_by_outcome(monitor_off):
    ours = _port(_spec_dict(monitor=True)).run()
    sv, off = ours.net["serve"], monitor_off[0].net["serve"]
    assert sv["n_queries"] == off["n_queries"] > 0
    assert sv["n_drift_events"] == 1 and sv["n_reselections"] >= 1
    assert sv["window_acc"] is not None and 0.0 <= sv["window_acc"] <= 1.0
    assert len(ours.select_batches) > len(monitor_off[0].select_batches)


def test_serve_metrics_match_reference_names(jsim):
    d = _spec_dict(monitor=False)
    d["obs"] = {"enabled": True}
    ours, theirs = _port(d).run(), jsim(d).run()
    assert ours.metrics.names() == theirs.metrics.names()
    served = [n for n in ours.metrics.names()
              if n.startswith("serve.queries") and "served" in n]
    assert ours.metrics.scalars[served[0]] == ours.net["serve"]["n_queries"]


WORLD = {"data": {"kind": "prediction_world", "n_clients": 4,
                  "n_val": 16, "models_per_client": 2},
         "selection": {"pop_size": 8, "generations": 2, "k": 2},
         "schedule": {"mode": "async"}, "seed": 0}
TRAFFIC = {"traffic": {"name": "poisson", "params": {"duration": 2.0}}}
REFUSED = {
    "covariate_on_prediction_world": {**WORLD, "serve": {
        **TRAFFIC, "drift": [{"name": "covariate_shift", "params": {}}]}},
    "serve_without_stores": {**WORLD, "data": {"kind": "none",
                                               "n_clients": 4},
                             "selection": {"enabled": False},
                             "serve": TRAFFIC},
    "serve_without_selection": {**WORLD, "selection": {"enabled": False},
                                "serve": TRAFFIC},
    "monitor_without_in_run_selection": {
        **WORLD, "schedule": {"mode": "async", "select_during_run": False},
        "serve": TRAFFIC},
    "dynamic_on_prediction_world": {**WORLD, "serve": {
        **TRAFFIC, "policy": "dynamic"}},
    "unknown_traffic": {**WORLD, "serve": {"traffic": "tidal"}},
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_serve_refusals_match_reference(jsim, name):
    d = REFUSED[name]
    with pytest.raises(ValueError) as theirs:
        jsim(d).build()
    with pytest.raises(ValueError) as ours:
        _port(d).build()
    assert str(ours.value) == str(theirs.value)


# ---- image worlds -------------------------------------------------------------

IMAGES = {
    "data": {"kind": "synthetic_images", "n_clients": 3, "n_classes": 4,
             "n_samples": 360, "image_size": 8},
    "train": {"families": ["cnn4", "vgg"], "max_epochs": 1, "width": 4},
    "selection": {"pop_size": 8, "generations": 2, "k": 2},
    "schedule": {"mode": "async", "select_debounce": 0.5},
    "serve": {"traffic": {"name": "poisson", "params": {
        "rate": 20.0, "batch": 4, "start": 1.0, "duration": 3.0}},
        "drift": [{"name": "label_shift", "params": {"at": 2.0,
                                                     "classes": [1]}},
                  {"name": "covariate_shift", "params": {"at": 2.5}}],
        "policy": "dynamic", "window": 8, "debounce": 0.5},
    "seed": 0,
}


def _image_run(device):
    res = _port(IMAGES, device=device).run()
    sv = res.net["serve"]
    assert sv["n_queries"] > 0 and sv["n_drift_events"] == 2
    assert res.test_acc.shape == (3,)
    return res


def test_image_world_dynamic_policy_serves():
    cpu = _image_run("cpu")
    policy = copy.deepcopy(IMAGES)
    policy["serve"]["policy"] = "ensemble"
    ens = _port(policy).run()
    assert ens.net["serve"]["n_queries"] == cpu.net["serve"]["n_queries"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no CPU mode")


@pytest.mark.cuda
def test_cuda_image_world_dynamic_policy(cuda):
    from repro_torch.kernels.ensemble_fitness import kernel
    cpu = _image_run("cpu")
    kernel.KERNEL.launches = 0
    card = _image_run("cuda")
    # the query schedule is the spec's; what is answered is the card's
    assert card.net["serve"]["n_queries"] == cpu.net["serve"]["n_queries"]
    ran = {t for v in card.selections.values() for t, _ in v}
    assert ran and kernel.KERNEL.launches == (2 * 2 + 1) * len(ran)
