"""The port's fault layer against the JAX package's, on the CPU.

- The injectors (`_pick_clients`, byzantine in its three modes, wire
  corruption, crash-restart, partition), the controller and the
  validation gate give the reference's sets, matrices, verdicts, times
  and counters on seeded numpy inputs, bit for bit; the gate's argmax
  takes the first maximal class on tied rows, as numpy's does.
- The store hooks `invalidate` and `wipe` leave the reference's state;
  an incremental device flush after them equals a fresh rebuild bit for
  bit; the engine's `_stale` check drops an invalidated member.
- The crash -> rejoin -> repair re-arm path of gossip and repair gives
  the reference's state.
- examples/specs/byzantine_ring.json gives the reference's events, net
  (faults and admission included), bench sizes and select batches, in
  process and through both CLIs; no honest store holds a byzantine
  owner's payload; the faults' metrics carry the reference's names.
- On the card (`cuda` marker): a small faults spec gives the CPU's
  events and net and launches the fitness kernel 2G + 1 times per batch
  that ran a GA.

The reference is imported by fixtures: its numpy-only modules wherever
the repository is, its Experiment layer only where JAX is (not on the
card).
"""
import copy
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.bench import (BenchEntry,  # noqa: E402
                                    PredictionStore,
                                    StreamingPredictionStore)
from repro_torch.core.device_store import DeviceStoreBatch  # noqa: E402
from repro_torch.core.engine import SelectionEngine  # noqa: E402
from repro_torch.core.nsga2 import NSGAConfig  # noqa: E402
from repro_torch.faults import (AdmissionConfig,  # noqa: E402
                                AdmissionController, ByzantineConfig,
                                ByzantineFault, CorruptionConfig,
                                CorruptionFault, CrashRestartConfig,
                                CrashRestartFault, FaultController,
                                PartitionConfig, PartitionFault,
                                ValidationGate)
from repro_torch.faults import injectors as tinj  # noqa: E402
from repro_torch.p2p import (AntiEntropyRepair, GossipConfig,  # noqa: E402
                             GossipProtocol, RepairConfig)
from repro_torch.sim import Experiment, ExperimentSpec  # noqa: E402

REPO = os.path.join(os.path.dirname(__file__), "..")
BYZANTINE_RING = os.path.join(REPO, "examples", "specs",
                              "byzantine_ring.json")
V, C = 48, 6
SELECTION_BAND = 0.05   # fleet-mean final val-acc, free GA runs


from _torch_threads import one_thread as _one_thread  # noqa: E402,F401


@pytest.fixture(scope="module")
def jf():
    """The reference's fault package (numpy only)."""
    import repro.faults as faults
    from repro.faults import injectors
    return faults, injectors


@pytest.fixture(scope="module")
def jsim():
    """The reference's Experiment layer (needs JAX)."""
    pytest.importorskip("jax")
    from repro.sim import Experiment as JExperiment
    from repro.sim import ExperimentSpec as JSpec

    def run(d, **kw):
        return JExperiment.from_spec(JSpec.from_dict(copy.deepcopy(d)),
                                     **kw)
    return run


def _port(d, device="cpu"):
    return Experiment.from_spec(ExperimentSpec.from_dict(copy.deepcopy(d)),
                                device=device)


def _probs(rng, rows, cols):
    p = rng.random((rows, cols)).astype(np.float32) + 1e-3
    return p / p.sum(1, keepdims=True)


# ---- injectors ------------------------------------------------------------

@pytest.mark.parametrize("fraction,clients,n,seed,domain", [
    (0.25, (), 16, 3, 1), (0.125, (), 16, 3, 2), (0.5, (), 7, 11, 1),
    (0.0, (), 8, 0, 1), (1.0, (), 5, 2, 2), (0.3, (4, 1, 1), 8, 0, 1)])
def test_pick_clients_matches_reference(jf, fraction, clients, n, seed,
                                        domain):
    _, jinj = jf
    assert tinj._FAULT_SALT == jinj._FAULT_SALT == 0x6B43A9B5
    ours = tinj._pick_clients(fraction, clients, n, seed, domain, "x")
    assert ours == jinj._pick_clients(fraction, clients, n, seed, domain,
                                      "x")
    with pytest.raises(ValueError) as a:
        tinj._pick_clients(0.5, (n,), n, seed, domain, "x")
    with pytest.raises(ValueError) as b:
        jinj._pick_clients(0.5, (n,), n, seed, domain, "x")
    assert str(a.value) == str(b.value)


@pytest.mark.parametrize("mode", ["label_flip", "uniform_noise",
                                  "confident_wrong"])
def test_byzantine_poison_matches_reference(jf, mode):
    jfa, _ = jf
    cfg = dict(fraction=0.25, mode=mode, confidence=0.85, seed=5)
    ours = ByzantineFault(ByzantineConfig(**cfg), 16)
    theirs = jfa.ByzantineFault(jfa.ByzantineConfig(**cfg), 16)
    assert ours.clients == theirs.clients and len(ours.clients) == 4
    rng = np.random.default_rng(0)
    for receiver, gid, rows in ((0, 3, V), (7, 3, V), (2, 31, 17)):
        p = _probs(rng, rows, C)
        a, b = ours.poison(p, receiver, gid), theirs.poison(p, receiver, gid)
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_corruption_verdicts_and_garble_match_reference(jf):
    jfa, _ = jf
    cfg = dict(flip_prob=0.4, detect_prob=0.6, seed=9)
    ours = CorruptionFault(CorruptionConfig(**cfg))
    theirs = jfa.CorruptionFault(jfa.CorruptionConfig(**cfg))
    # repeated deliveries of one (edge, key, version) draw fresh coins
    script = [(s, d, (o, m), v) for s in range(3) for d in range(3)
              for o in range(2) for m in range(2) for v in (0, 1)] * 3
    verdicts = [ours.check(*x) for x in script]
    assert verdicts == [theirs.check(*x) for x in script]
    assert {"detected", "admitted", None} <= set(verdicts)
    p = _probs(np.random.default_rng(1), V, C)
    np.testing.assert_array_equal(ours.corrupt(p, 4, 7),
                                  theirs.corrupt(p, 4, 7))
    with pytest.raises(ValueError) as a:
        CorruptionFault(CorruptionConfig(flip_prob=1.5))
    with pytest.raises(ValueError) as b:
        jfa.CorruptionFault(jfa.CorruptionConfig(flip_prob=1.5))
    assert str(a.value) == str(b.value)


def test_crash_restart_times_match_reference(jf):
    jfa, _ = jf
    cfg = dict(fraction=0.25, at=2.0, spread=1.5, downtime=1.5, seed=3)
    ours = CrashRestartFault(CrashRestartConfig(**cfg), 16)
    theirs = jfa.CrashRestartFault(jfa.CrashRestartConfig(**cfg), 16)
    assert ours.clients == theirs.clients
    assert ours.crash_t == theirs.crash_t
    assert ours.restart_t == theirs.restart_t
    assert ours.events() == theirs.events()
    for c in range(16):
        for t in np.linspace(0.0, 8.0, 33):
            assert ours.is_online(c, t) == theirs.is_online(c, t)


@pytest.mark.parametrize("params", [
    dict(mode="halves", start=1.0, duration=2.5),
    dict(mode="edges", edges=((0, 1), (5, 4)), start=0.5,
         duration=math.inf)])
def test_partition_matches_reference(jf, params):
    jfa, _ = jf
    ours = PartitionFault(PartitionConfig(**params), 8)
    theirs = jfa.PartitionFault(jfa.PartitionConfig(**params), 8)
    assert ours.events() == theirs.events()
    for a in range(8):
        for b in range(8):
            assert ours.crosses(a, b) == theirs.crosses(a, b)
            for t in (0.0, 0.75, 2.0, 3.4, 9.0):
                assert ours.cut(a, b, t) == theirs.cut(a, b, t)


def test_controller_matches_reference(jf):
    jfa, _ = jf

    def build(F):
        return F.FaultController([
            F.CrashRestartFault(F.CrashRestartConfig(fraction=0.5,
                                                     seed=1), 8),
            F.PartitionFault(F.PartitionConfig(start=1.0, duration=2.0),
                             8),
            F.CorruptionFault(F.CorruptionConfig(flip_prob=0.5,
                                                 detect_prob=0.5, seed=2)),
            F.ByzantineFault(F.ByzantineConfig(fraction=0.25, seed=4), 8)],
            8)
    import repro_torch.faults as tfa
    ours, theirs = build(tfa), build(jfa)
    assert ours.kinds == theirs.kinds
    assert ours.initial_events() == theirs.initial_events()
    for ctl in (ours, theirs):
        for s in range(4):
            for d in range(4):
                ctl.corrupt_check(s, d, (s, 0), 0)
        ctl.note_crash(1, 0.5)
        ctl.note_restart(1, 2.5)
        ctl.mark_corrupt(3, (1, 0))
        ctl.poison_payload(np.full((4, 3), 1 / 3, np.float32), 0, 2)
    assert ours.as_dict() == theirs.as_dict()
    assert ours.take_corrupt(3, (1, 0)) and not ours.take_corrupt(3, (1, 0))
    assert [ours.is_byzantine(c) for c in range(8)] == \
        [theirs.is_byzantine(c) for c in range(8)]
    for a, b, t in ((0, 5, 1.5), (0, 1, 1.5), (0, 5, 3.5)):
        assert ours.edge_cut(a, b, t) == theirs.edge_cut(a, b, t)
    with pytest.raises(ValueError) as x:
        ours.array_params()
    with pytest.raises(ValueError) as y:
        theirs.array_params()
    assert str(x.value) == str(y.value)
    dup = [tfa.PartitionFault(tfa.PartitionConfig(), 4)] * 2
    with pytest.raises(ValueError, match="duplicate fault injector kind"):
        FaultController(dup, 4)


# ---- admission ------------------------------------------------------------

class _Labels:
    """What AdmissionController reads of a store."""

    def __init__(self, client, labels, n_classes):
        self.client, self.labels, self.n_classes = client, labels, n_classes
        self.invalidated = []

    def invalidate(self, gid):
        self.invalidated.append(gid)
        return gid % 2 == 0


def test_gate_matches_reference(jf):
    jfa, _ = jf
    rng = np.random.default_rng(4)
    labels = np.full((64,), -1, np.int32)
    labels[:50] = rng.integers(0, C, 50)
    cfg = dict(holdout_frac=0.3, seed=7)
    stores = [_Labels(c, labels, C) for c in range(3)]
    jstores = [_Labels(c, labels, C) for c in range(3)]
    ours = AdmissionController(AdmissionConfig(**cfg), stores)
    theirs = jfa.AdmissionController(jfa.AdmissionConfig(**cfg), jstores)
    for c in range(3):
        np.testing.assert_array_equal(ours.gates[c].holdout,
                                      theirs.gates[c].holdout)
        assert ours.gates[c].reject_below == theirs.gates[c].reject_below
    outcomes = []
    for i in range(40):
        c, gid = i % 3, i
        q = rng.random()       # from noise to nearly the true labels
        p = _probs(rng, 64, C)
        hit = rng.random(64) < q
        p[hit, np.maximum(labels[hit], 0)] += 2.0
        a = ours.screen(c, gid, p, stores[c])
        assert a == theirs.screen(c, gid, p, jstores[c])
        outcomes.append(a)
    assert {"admitted", "quarantined", "rejected"} <= set(outcomes)
    ours.on_crash(1)
    theirs.on_crash(1)
    assert ours.as_dict() == theirs.as_dict()
    assert [g.pen for g in ours.gates.values()] == \
        [g.pen for g in theirs.gates.values()]
    assert [s.invalidated for s in stores] == \
        [s.invalidated for s in jstores]


def test_gate_argmax_takes_the_first_maximal_class():
    """Tied rows score as class 0 (the first maximum), as numpy's and
    torch's argmax both promise: a uniform payload is right exactly on
    the holdout rows labelled 0."""
    labels = np.array([0, 1, 0, 2, 0, 3, 1, 0], np.int32)
    gate = ValidationGate(AdmissionConfig(holdout_frac=1.0), 0, labels, 4)
    tied = np.full((8, 4), 0.25, np.float32)
    tied[5, 1:3] = 0.375          # a tie between classes 1 and 2
    tied[5, [0, 3]] = 0.125
    first = np.array([0, 0, 0, 0, 0, 1, 0, 0])
    np.testing.assert_array_equal(tied.argmax(1), first)
    np.testing.assert_array_equal(torch.as_tensor(tied).argmax(1).numpy(),
                                  first)
    assert gate.screen_acc(tied) == float((first == labels).mean())


# ---- store hooks ------------------------------------------------------------

def _entry(gid, owner):
    return BenchEntry(model_id=gid, owner=owner, family="f",
                      predict=lambda x: np.full((len(x), C), 1.0 / C,
                                                np.float32))


def _filled(cls, ref_cls, rng, cap=6, n_models=8):
    ours = cls(0, cap, np.zeros((V, 2), np.float32),
               rng.integers(0, C, V), C)
    theirs = ref_cls(0, cap, np.zeros((V, 2), np.float32),
                     ours.labels[:V].copy(), C)
    for gid in range(min(cap, n_models)):
        p = _probs(rng, V, C)
        for s in (ours, theirs):
            s.add(_entry(gid, gid % 3), preds=p, t=float(gid))
    return ours, theirs


def _same_store(a, b):
    for f in ("preds", "mask", "slot_gen", "hits", "last_used",
              "labels"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert a.dirty_seq == b.dirty_seq
    assert [e and e.model_id for e in a.entries] == \
        [e and e.model_id for e in b.entries]


@pytest.mark.parametrize("streaming", [False, True])
def test_store_invalidate_and_wipe_match_reference(streaming):
    from repro.core import bench as jbench
    cls, ref_cls = ((StreamingPredictionStore,
                     jbench.StreamingPredictionStore) if streaming
                    else (PredictionStore, jbench.PredictionStore))
    ours, theirs = _filled(cls, ref_cls, np.random.default_rng(3))
    for gid in (2, 2, 5, 7):          # resident, gone, resident, absent
        assert ours.invalidate(gid) == theirs.invalidate(gid)
    _same_store(ours, theirs)
    assert not ours.mask[2] and ours.slot_gen[2] == 1
    assert ours.wipe() == theirs.wipe() == 4
    _same_store(ours, theirs)
    assert ours.n_present == 0


def _engine(stores, k=2):
    return SelectionEngine(stores, NSGAConfig(pop_size=8, generations=2,
                                              k=k), ensemble_k=k,
                           device="cpu")


def test_stale_check_drops_an_invalidated_member():
    rng = np.random.default_rng(5)
    stores = [_filled(PredictionStore, PredictionStore, rng)[0]
              for _ in range(2)]
    eng = _engine(stores)
    eng.select([0], t=1.0)
    chrom = eng.chromosome(0)
    member = int(np.flatnonzero(chrom > 0.5)[0])
    assert stores[0].invalidate(member)
    assert eng._stale(stores[0], eng.results[0], chrom)
    fallback = eng.chromosome(0)
    assert not fallback[member] and fallback.sum() > 0
    assert (stores[0].is_local()[fallback > 0.5]).all()


def test_incremental_flush_equals_rebuild_after_invalidate_and_wipe():
    rng = np.random.default_rng(6)
    stores = [_filled(cls, cls, rng)[0] for cls in
              (PredictionStore, StreamingPredictionStore, PredictionStore)]
    inc = DeviceStoreBatch(stores, "cpu")
    inc.flush()
    stores[0].invalidate(1)
    stores[1].invalidate(4)
    inc.flush()
    stores[2].wipe()
    stores[2].add(_entry(3, 2), preds=_probs(rng, V, C), t=9.0)
    inc.flush()
    fresh = DeviceStoreBatch(stores, "cpu")
    fresh.flush()
    for name in ("preds", "pnorm", "masks", "acc", "S", "labels"):
        assert torch.equal(getattr(inc, name), getattr(fresh, name)), name


# ---- crash -> rejoin -> repair re-arm ---------------------------------------

def test_crash_rejoin_and_repair_rearm_match_reference():
    from repro.p2p import (AntiEntropyRepair as JRepair,
                           GossipConfig as JGossipConfig,
                           GossipProtocol as JGossip,
                           RepairConfig as JRepairConfig)
    ring = [[(c - 1) % 6, (c + 1) % 6] for c in range(6)]

    def stack(G, GC, R, RC):
        g = G(GC(mode="push"), ring)
        return g, R(RC(interval=1.0, max_rounds=4, quiesce_after=1), g)
    ours, theirs = (stack(GossipProtocol, GossipConfig, AntiEntropyRepair,
                          RepairConfig),
                    stack(JGossip, JGossipConfig, JRepair, JRepairConfig))
    log = []
    for g, r in (ours, theirs):
        out = [g.on_local(c, (c, 0), 0.0) for c in range(6)]
        for c in range(6):
            for dst, key in out[c]:
                g.note_sent(c, dst, key)
                g.on_receive(dst, c, key, 0.1)
        polls = [r.poll(a, b, 1.0 + i, sender_online=(a != 2))[1:]
                 for i, (a, b) in enumerate(r.edges)]
        g.note_crash(2)
        g.note_rejoin(2, 3.0)
        rearmed = [r.rearm(a, b) for a, b in r.edges]
        again = g.on_local(2, (2, 0), 3.0)
        log.append((polls, rearmed, again, g.incarnation, g.rejoined_at,
                    [dict(h) for h in g.have],
                    [{d: sorted(k) for d, k in ph.items()}
                     for ph in g.peer_has],
                    sorted(r.active), dict(r.calm), r.stats.as_dict()))
    assert log[0] == log[1]
    assert log[0][3][2] == 1 and log[0][2]   # a fresh incarnation re-sends


# ---- whole runs ---------------------------------------------------------------

def _spec_dict(path):
    with open(path) as f:
        d = json.load(f)
    d.pop("smoke_overrides", None)
    return d


@pytest.fixture(scope="module")
def ring_runs(jsim):
    d = _spec_dict(BYZANTINE_RING)
    ours, theirs = _port(d), jsim(d)
    return ours.run(), theirs.run(), ours, theirs


@pytest.mark.parametrize("field", ["events", "net", "bench_sizes",
                                   "select_batches"])
def test_byzantine_ring_matches_reference(ring_runs, field):
    ours, theirs, _, _ = ring_runs
    assert getattr(ours.trace, field) == getattr(theirs.trace, field)


def test_byzantine_ring_selections_by_outcome(ring_runs):
    ours, theirs, _, _ = ring_runs
    assert ours.net["faults"]["n_crashes"] == 2
    assert ours.net["admission"]["n_rejected"] > 0
    keys = {c: [t for t, _ in v] for c, v in ours.selections.items()}
    assert keys == {c: [t for t, _ in v]
                    for c, v in theirs.selections.items()}

    def final(res):
        return float(np.mean([v[-1][1] for v in res.selections.values()
                              if v]))
    assert abs(final(ours) - final(theirs)) <= SELECTION_BAND
    assert ours.coverage == theirs.coverage == 1.0


def test_honest_stores_hold_no_byzantine_payload(ring_runs):
    ours, _, ours_exp, theirs_exp = ring_runs
    byz = ours_exp.faults.byzantine.clients
    assert len(byz) == 4 and byz == theirs_exp.faults.byzantine.clients
    for c, store in enumerate(ours.stores):
        if c in byz:
            continue
        owners = {e.owner for e in store.entries if e is not None}
        assert not owners & byz, (c, owners & byz)


def test_byzantine_ring_through_both_clis(tmp_path):
    pytest.importorskip("jax")
    out = {}
    for pkg in ("repro", "repro_torch"):
        cmd = [sys.executable, "-m", f"{pkg}.sim.run", "--spec",
               BYZANTINE_RING, "--json-out", str(tmp_path / pkg)]
        if pkg == "repro_torch":
            cmd += ["--device", "cpu"]
        proc = subprocess.run(
            cmd, capture_output=True, text=True, timeout=600,
            env=dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
                     JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1"))
        assert proc.returncode == 0, proc.stderr
        out[pkg] = json.loads((tmp_path / pkg).read_text())
    ours, theirs = out["repro_torch"], out["repro"]
    for key in ("net", "n_events", "coverage", "t_full", "n_selections"):
        assert ours[key] == theirs[key], key
    assert set(ours["net"]) == {"lost_offline", "transport", "gossip",
                                "repair", "faults", "admission"}


DISSEMINATION = {
    "data": {"kind": "none", "n_clients": 8, "n_val": 32,
             "models_per_client": 2},
    "selection": {"enabled": False},
    "network": {"topology": "ring",
                "transport": {"name": "gossip", "params": {
                    "drop_prob": 0.1, "base_latency": 0.05}},
                "gossip": "push",
                "repair": {"name": "anti_entropy",
                           "params": {"max_rounds": 30}}},
    "schedule": {"mode": "async"},
    "faults": {"injectors": [
        {"name": "crash_restart", "params": {"fraction": 0.25, "at": 1.0}},
        {"name": "partition", "params": {"mode": "halves", "start": 0.5,
                                         "duration": 2.0}},
        {"name": "corruption", "params": {"flip_prob": 0.2,
                                          "detect_prob": 0.5}}]},
    "obs": {"enabled": True},
    "seed": 2,
}


def test_crash_partition_corruption_run_matches_reference(jsim):
    ours, theirs = _port(DISSEMINATION).run(), jsim(DISSEMINATION).run()
    assert ours.trace.events == theirs.trace.events
    assert ours.net == theirs.net and ours.coverage == theirs.coverage
    assert ours.net["faults"]["n_partition_blocked"] > 0
    assert ours.metrics.names() == theirs.metrics.names()
    for name, value in theirs.metrics.scalars.items():
        if not (isinstance(value, float) and np.isnan(value)):
            assert ours.metrics.scalars[name] == value, name
    assert any(n.startswith("faults.injected") for n in ours.metrics.names())


REFUSED = {
    "byzantine_without_stores": {**DISSEMINATION, "faults": {
        "injectors": [{"name": "byzantine", "params": {"fraction": 0.25}}]}},
    "admission_without_stores": {**DISSEMINATION, "faults": {
        "admission": "validation_gate"}},
    "sync_faults": {"data": {"kind": "synthetic_images", "n_clients": 2},
                    "faults": {"injectors": ["crash_restart"]}},
    "unknown_fault_param": {**DISSEMINATION, "faults": {"injectors": [
        {"name": "partition", "params": {"mode": "thirds"}}]}},
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_fault_refusals_match_reference(jsim, name):
    d = REFUSED[name]
    with pytest.raises(ValueError) as theirs:
        jsim(d).build()
    with pytest.raises(ValueError) as ours:
        _port(d).build()
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("name", ["byzantine_ring", "serve_drift"])
def test_faults_and_serve_specs_default_to_cuda(name):
    """No fallback: without a card these specs raise unless the caller
    asks for the CPU."""
    spec = ExperimentSpec.from_dict(_spec_dict(os.path.join(
        REPO, "examples", "specs", f"{name}.json")))
    if torch.cuda.is_available():
        assert Experiment.from_spec(spec).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            Experiment.from_spec(spec)
    assert Experiment.from_spec(spec, device="cpu").device.type == "cpu"


# ---- on the card -------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no CPU mode")


SMALL_FAULTS = {
    "data": {"kind": "prediction_world", "n_clients": 8, "n_classes": C,
             "n_val": V, "models_per_client": 2},
    "selection": {"pop_size": 16, "generations": 3, "k": 3},
    "network": DISSEMINATION["network"],
    "schedule": {"mode": "async"},
    "faults": {"injectors": [
        {"name": "byzantine", "params": {"fraction": 0.25}},
        {"name": "corruption", "params": {"flip_prob": 0.2}},
        {"name": "crash_restart", "params": {"fraction": 0.25}}],
        "admission": "validation_gate"},
    "seed": 1,
}


@pytest.mark.cuda
def test_cuda_faults_run_matches_cpu_and_launches_the_kernel(cuda):
    from repro_torch.kernels.ensemble_fitness import kernel
    cpu = _port(SMALL_FAULTS).run()
    kernel.KERNEL.launches = 0
    card = _port(SMALL_FAULTS, device="cuda").run()
    launches = kernel.KERNEL.launches
    for field in ("events", "net", "bench_sizes", "select_batches"):
        assert getattr(card.trace, field) == getattr(cpu.trace, field)
    ran = {t for v in card.selections.values() for t, _ in v}
    assert ran and launches == (2 * 3 + 1) * len(ran)
