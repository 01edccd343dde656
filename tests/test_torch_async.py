"""The port's asynchronous event path against the JAX reference, on the
CPU at small sizes.

- Golden trace: the lossy-churn scenario of tests/test_spec.py (8
  clients, ring, 20% drops, bounded inboxes, churn, anti-entropy repair)
  on a prediction world gives the reference's events, net dict, bench
  sizes and select batches exactly; selections have the same (client, t)
  keys, and the fleet-mean final validation accuracy is within 0.05
  (the GA's random streams differ by design).
- The paper's 20 x 5 schedule at select_debounce 0.5: the events of a
  full port run equal the reference's scheduler's on the same config,
  and the port's own scheduler run again with a stub selection — the
  check chip_smoke.py's card run leans on.
- The streaming store evicts as the reference's does on one scripted
  sequence; incremental device statistics equal a rebuild bit for bit.
- The `run_fedpae_async` shim equals the spec path; observability emits
  the reference's metric names and both sinks write strict JSON; the
  refusals match the reference's words.
- On the card (`cuda` marker): a small async spec gives the CPU's events
  and launches the fitness kernel 2G + 1 times per batch that ran a GA.
  JAX is absent there, so the reference is imported by the `ref`
  fixture, which skips the parity tests where JAX is missing.
"""
import copy
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.bench import (BenchEntry,  # noqa: E402
                                    StreamingPredictionStore)
from repro_torch.core.device_store import DeviceStoreBatch  # noqa: E402
from repro_torch.core.engine import SelectionEngine  # noqa: E402
from repro_torch.core.fedpae import (FedPAEConfig,  # noqa: E402
                                     build_benches, run_fedpae,
                                     run_fedpae_async)
from repro_torch.core.nsga2 import NSGAConfig  # noqa: E402
from repro_torch.fl import scheduler as tsched  # noqa: E402
from repro_torch.fl.topology import make_topology  # noqa: E402
from repro_torch.p2p import (AntiEntropyRepair, ChurnConfig,  # noqa: E402
                             ChurnSchedule, GossipConfig, GossipProtocol,
                             GossipTransport, RepairConfig,
                             TransportConfig, prediction_matrix_bytes)
from repro_torch.sim import Experiment, ExperimentSpec  # noqa: E402
from repro_torch.sim.build import build_client_datasets  # noqa: E402

REPO = os.path.join(os.path.dirname(__file__), "..")
VAL_ACC_BAND = 0.05
NETWORK = {
    "topology": "ring",
    "transport": {"name": "gossip", "params": {
        "base_latency": 0.05, "jitter": 1.0, "drop_prob": 0.2,
        "inbox_capacity": 32,
        "sizer": {"name": "prediction_matrix",
                  "params": {"n_val": 64, "n_classes": 4}}}},
    "gossip": "push",
    "churn": {"name": "lognormal", "params": {
        "availability_beta": 0.2, "join_spread": 1.0, "leave_prob": 0.2}},
    "repair": {"name": "anti_entropy", "params": {"max_rounds": 30,
                                                  "max_attempts": 6}},
}
GOLDEN = {
    "data": {"kind": "prediction_world", "n_clients": 8, "n_classes": 4,
             "n_val": 64, "models_per_client": 1},
    "selection": {"pop_size": 8, "generations": 2, "k": 3,
                  "ensemble_k": 3},
    "network": NETWORK,
    "schedule": {"mode": "async"},
    "obs": {"enabled": True, "trace": True},
    "seed": 0,
}


from _torch_threads import one_thread as _one_thread  # noqa: E402,F401


@pytest.fixture(scope="module")
def ref():
    """The reference package (needs JAX): (Experiment builder, its
    scheduler module, its StreamingPredictionStore)."""
    pytest.importorskip("jax")
    from repro.core.bench import StreamingPredictionStore
    from repro.fl import scheduler
    from repro.sim import Experiment as JExperiment
    from repro.sim import ExperimentSpec as JSpec

    def build(d):
        return JExperiment.from_spec(JSpec.from_dict(copy.deepcopy(d)))
    return build, scheduler, StreamingPredictionStore


def _port(d, device="cpu"):
    return Experiment.from_spec(ExperimentSpec.from_dict(copy.deepcopy(d)),
                                device=device)


def _keys(selections):
    return {c: [t for t, _ in v] for c, v in selections.items()}


def _final_mean(selections):
    return float(np.mean([v[-1][1] for v in selections.values() if v]))


@pytest.fixture(scope="module")
def golden(ref):
    return _port(GOLDEN).run(), ref[0](GOLDEN).run()


@pytest.mark.parametrize("field", ["events", "bench_sizes",
                                   "select_batches", "net"])
def test_golden_trace_matches_reference(golden, field):
    ours, theirs = golden
    assert getattr(ours.trace, field) == getattr(theirs.trace, field)
    assert len(ours.trace.events) > 300


def test_golden_selections_match_by_outcome(golden):
    ours, theirs = golden
    assert _keys(ours.selections) == _keys(theirs.selections)
    assert sum(len(v) for v in ours.selections.values()) > 20
    assert abs(_final_mean(ours.selections)
               - _final_mean(theirs.selections)) <= VAL_ACC_BAND
    assert ours.coverage == theirs.coverage
    assert ours.curve is not None and len(ours.curve) == len(theirs.curve)
    assert [b for b, _ in ours.curve] == [b for b, _ in theirs.curve]


def test_golden_metrics_match_reference(golden):
    ours, theirs = golden
    assert ours.metrics.names() == theirs.metrics.names()
    skip = {"engine.flush_wall_s", "engine.select_wall_s"}  # wall clocks
    for name, value in theirs.metrics.scalars.items():
        if name not in skip and not (isinstance(value, float)
                                     and np.isnan(value)):
            assert ours.metrics.scalars[name] == value, name
    assert ours.metrics.meta == theirs.metrics.meta


PAPER = {
    "data": {"kind": "prediction_world", "n_clients": 20, "n_classes": 10,
             "n_val": 128, "models_per_client": 5},
    "selection": {"pop_size": 8, "generations": 2, "k": 5,
                  "ensemble_k": 5},
    "schedule": {"mode": "async", "speed_lognorm_sigma": 0.6,
                 "link_latency": 0.05, "select_debounce": 0.5,
                 "train_cost": {"name": "affine",
                                "params": {"base": 1.0, "slope": 0.3}}},
    "seed": 0,
}


def _stub_schedule(sched, d):
    """A scheduler's trace of the spec's schedule with a stub selection."""
    s, n = d["schedule"], d["data"]["n_clients"]
    cfg = sched.AsyncConfig(
        n_clients=n, models_per_client=d["data"]["models_per_client"],
        speed_lognorm_sigma=s["speed_lognorm_sigma"],
        link_latency=s["link_latency"],
        select_debounce=s["select_debounce"], seed=d["seed"])
    return sched.simulate_async(
        cfg, make_topology("full", n), train_cost=lambda c, m: 1.0 + 0.3 * m,
        on_select_batch=lambda cs, ids, t: {})


def test_paper_schedule_matches_reference(ref):
    res = _port(PAPER).run()
    theirs = _stub_schedule(ref[1], PAPER)
    ours = _stub_schedule(tsched, PAPER)
    for trace in (theirs, ours):
        assert res.trace.events == trace.events
        assert res.trace.bench_sizes == trace.bench_sizes
        assert res.trace.select_batches == trace.select_batches
    assert len(res.select_batches) == 28
    assert sum(b for _, b in res.select_batches) == 493
    assert res.coverage == 1.0
    assert sum(len(v) for v in res.selections.values()) > 0


# ---- the streaming store -------------------------------------------------

V, C = 20, 4


def _entry(gid, owner):
    return BenchEntry(model_id=gid, owner=owner, family="f",
                      predict=lambda x: np.full((len(x), C), 1.0 / C,
                                                np.float32))


def _script(seed, cap, n_models, client):
    """Adds of global ids (locals among them), selections that tie on
    hits and on last-used times, re-adds of resident ids."""
    rng = np.random.default_rng(seed)
    ops = []
    for step in range(60):
        r = rng.random()
        t = float(step // 3)        # repeated times: recency ties
        if r < 0.65:
            gid = int(rng.integers(n_models))
            owner = client if gid % 5 == 0 else int(gid % 7) + 1
            p = rng.random((V, C)).astype(np.float32)
            ops.append(("add", gid, owner, p / p.sum(1, keepdims=True), t))
        else:
            ops.append(("sel", rng.random(cap) < 0.3, t))
    return ops


STREAMS = [(0, 6, 30, True), (1, 4, 12, True), (2, 3, 40, True),
           (3, 5, 25, False)]


@pytest.mark.parametrize("seed,cap,n_models,protect", STREAMS)
def test_streaming_store_evicts_as_the_reference(ref, seed, cap, n_models,
                                                 protect):
    JStreaming = ref[2]
    labels = np.random.default_rng(seed).integers(0, C, V)
    x = np.zeros((V, 2), np.float32)
    ours = StreamingPredictionStore(0, cap, x, labels, C,
                                    protect_local=protect)
    theirs = JStreaming(0, cap, x, labels, C, protect_local=protect)
    for op in _script(seed, cap, n_models, client=0):
        if op[0] == "add":
            _, gid, owner, p, t = op
            assert ours.add(_entry(gid, owner), preds=p, t=t) == \
                theirs.add(_entry(gid, owner), preds=p, t=t)
        else:
            ours.note_selection(op[1], t=op[2])
            theirs.note_selection(op[1], t=op[2])
        assert ours.slot_of == theirs.slot_of
        assert [ours._slot_for(g) for g in range(n_models)] == \
            [theirs._slot_for(g) for g in range(n_models)]
        for name in ("slot_gen", "mask", "hits", "last_used", "preds"):
            np.testing.assert_array_equal(getattr(ours, name),
                                          getattr(theirs, name))
        assert ours.dirty_seq == theirs.dirty_seq
    assert (ours.evictions, ours.n_rejected) == \
        (theirs.evictions, theirs.n_rejected)
    assert ours.evictions > 0


def test_incremental_stats_equal_rebuild_through_evictions():
    """Three streaming stores flushed after every step of their scripts
    (evictions zero, mask off and re-dirty slots) end in the statistics a
    from-scratch flush of the final stores computes, bit for bit."""
    stores, scripts = [], []
    for c in range(3):
        labels = np.random.default_rng(c).integers(0, C, V)
        stores.append(StreamingPredictionStore(c, 6, np.zeros((V, 2)),
                                               labels, C))
        scripts.append(_script(10 + c, 6, 30, client=c))
    inc = DeviceStoreBatch(stores, "cpu")
    for step in range(60):
        for store, script in zip(stores, scripts):
            op = script[step]
            if op[0] == "add":
                store.add(_entry(op[1], op[2]), preds=op[3], t=op[4])
            else:
                store.note_selection(op[1], t=op[2])
        inc.flush()
    assert sum(s.evictions for s in stores) > 0
    fresh = DeviceStoreBatch(stores, "cpu")
    fresh.flush()
    for name in ("preds", "pnorm", "masks", "acc", "S"):
        assert torch.equal(getattr(inc, name), getattr(fresh, name)), name
    rows = inc.gather([2, 0, 2, 0])
    for got, full in zip(rows, (inc.preds, inc.labels, inc.masks, inc.acc,
                                inc.S)):
        assert torch.equal(got, full[[2, 0, 2, 0]])


def test_serving_after_eviction_falls_back_to_local_members():
    rng = np.random.default_rng(4)
    labels = rng.integers(0, C, V)
    store = StreamingPredictionStore(0, 6, np.zeros((V, 2)), labels, C)
    for gid in range(6):            # gids 0, 1 local; the rest remote
        p = np.full((V, C), 0.05, np.float32)
        good = rng.random(V) < 0.8
        p[np.arange(V), np.where(good, labels, (labels + 1) % C)] = 0.8
        store.add(_entry(gid, 0 if gid < 2 else gid), preds=p, t=gid)
    engine = SelectionEngine([store], NSGAConfig(pop_size=16, generations=5,
                                                 k=2, seed=0),
                             ensemble_k=2, device="cpu")
    engine.select(t=10.0)
    chrom = engine.chromosome(0)
    victim = next(s for s in np.flatnonzero(chrom > 0.5)
                  if store.entries[s].owner != 0)
    store.hits[:] = 5
    store.hits[victim] = 0
    store.add(_entry(99, 7), preds=np.full((V, C), 0.25, np.float32),
              t=11.0)
    assert store.slot_of[99] == victim and store.slot_gen[victim] == 1
    assert engine._stale(store, engine.results[0], chrom)
    sel = np.flatnonzero(engine.chromosome(0) > 0.5)
    assert len(sel) == 2 and all(store.entries[s].owner == 0 for s in sel)


# ---- the shim, observability, refusals -----------------------------------

IMAGES = {"kind": "synthetic_images", "n_clients": 8, "n_classes": 4,
          "n_samples": 640, "image_size": 8, "alpha": 0.5}


def test_shim_matches_spec_path():
    """`run_fedpae_async` with hand-built collaborators gives the spec
    path's trace and test accuracies (tests/test_spec.py's check of the
    reference, on the port)."""
    n = 8
    d = {"data": IMAGES,
         "train": {"families": ["cnn4"], "width": 8, "max_epochs": 2,
                   "patience": 2},
         "selection": {"pop_size": 8, "generations": 2, "k": 3,
                       "ensemble_k": 3},
         "network": NETWORK, "schedule": {"mode": "async"}, "seed": 0}
    r_spec = _port(d).run()
    cfg = FedPAEConfig(
        families=("cnn4",), ensemble_k=3,
        nsga=NSGAConfig(pop_size=8, generations=2, k=3, seed=0),
        topology="ring", width=8, max_epochs=2, patience=2, seed=0)
    spec = ExperimentSpec.from_dict(d)
    datasets = build_client_datasets(spec.data, spec.seed)
    nb = make_topology("ring", n, seed=0)
    churn = ChurnSchedule(ChurnConfig(availability_beta=0.2,
                                      join_spread=1.0, leave_prob=0.2,
                                      seed=0), n)
    gossip = GossipProtocol(GossipConfig(mode="push", seed=0), nb,
                            churn=churn)
    transport = GossipTransport(
        TransportConfig(base_latency=0.05, jitter=1.0, drop_prob=0.2,
                        inbox_capacity=32, seed=0),
        n, lambda s, d_, k: prediction_matrix_bytes(64, 4))
    repair = AntiEntropyRepair(
        RepairConfig(max_rounds=30, max_attempts=6, seed=0), gossip,
        churn=churn)
    r_shim = run_fedpae_async(datasets, 4, cfg, transport=transport,
                              gossip=gossip, churn=churn, repair=repair,
                              device="cpu")
    assert r_spec.trace.events == r_shim.trace.events
    assert r_spec.trace.net == r_shim.trace.net
    assert r_spec.trace.select_batches == r_shim.trace.select_batches
    assert np.array_equal(r_spec.test_acc, r_shim.test_acc)
    assert r_spec.test_acc.shape == (n,)


def test_sync_shim_matches_spec_path():
    d = {"data": {**IMAGES, "n_clients": 3, "n_samples": 300},
         "train": {"families": ["cnn4", "vgg"], "width": 4,
                   "max_epochs": 1},
         "selection": {"pop_size": 8, "generations": 2, "k": 2,
                       "ensemble_k": 2}, "seed": 0}
    r_spec = _port(d).run()
    cfg = FedPAEConfig(families=("cnn4", "vgg"), ensemble_k=2,
                       nsga=NSGAConfig(pop_size=8, generations=2, k=2),
                       width=4, max_epochs=1, seed=0)
    spec = ExperimentSpec.from_dict(d)
    datasets = build_client_datasets(spec.data, spec.seed)
    r_shim = run_fedpae(datasets, 4, cfg, device="cpu")
    np.testing.assert_array_equal(r_spec.test_acc, r_shim.test_acc)
    for a, b in zip(r_spec.chromosomes, r_shim.chromosomes):
        np.testing.assert_array_equal(a, b)
    with pytest.warns(DeprecationWarning, match="build_stores"):
        stores = build_benches(datasets, r_shim.models, r_spec.stores[0]
                               .entries[0].ccfg, cfg)
    np.testing.assert_array_equal(stores[1].preds, r_shim.benches[1].preds)


def _strict(path):
    def no_constant(tok):
        raise ValueError(f"non-strict JSON token {tok}")
    with open(path) as f:
        return json.load(f, parse_constant=no_constant)


def test_sinks_write_strict_json(tmp_path):
    d = copy.deepcopy(GOLDEN)
    d["data"]["n_clients"] = 5
    d["obs"]["sinks"] = [
        {"name": "metrics_json", "params": {"path": str(tmp_path / "m")}},
        {"name": "perfetto", "params": {"path": str(tmp_path / "t")}}]
    res = _port(d).run()
    frame = _strict(tmp_path / "m")
    assert set(frame["scalars"]) | set(frame["series"]) == \
        res.metrics.names()
    assert frame["scalars"]["coverage.t_full"] is None or \
        frame["scalars"]["coverage.t_full"] > 0
    trace = _strict(tmp_path / "t")
    phases = {e["ph"] for e in trace["traceEvents"]}
    assert {"M", "X", "s", "f", "C"} <= phases


def test_cli_writes_metrics_and_trace(tmp_path):
    d = copy.deepcopy(GOLDEN)
    d["data"]["n_clients"] = 4
    d["obs"] = {}
    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps(d, allow_nan=False))
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.sim.run", "--spec", str(spec),
         "--device", "cpu", "--metrics-out", str(tmp_path / "m.json"),
         "--trace-out", str(tmp_path / "t.json")],
        capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    summary = json.loads(proc.stdout)
    assert summary["mode"] == "async" and summary["obs"]["n_scalars"] > 0
    assert _strict(tmp_path / "m.json")["meta"]["backend"] == "event"
    assert _strict(tmp_path / "t.json")["traceEvents"]


SYNC_IMAGES = {"data": {**IMAGES, "n_clients": 2, "n_samples": 160},
               "train": {"families": ["cnn4"], "width": 4},
               "schedule": {"mode": "sync"}}
ASYNC_WORLD = {"data": {"kind": "prediction_world", "n_clients": 4,
                        "n_val": 16},
               "schedule": {"mode": "async"}}
COMPILED = {"mode": "async", "backend": "compiled",
            "select_during_run": False}
REFUSED_AS_IN_REFERENCE = {
    "sinks_without_obs": {**ASYNC_WORLD, "obs": {"sinks": ["perfetto"]}},
    "trace_in_sync": {**SYNC_IMAGES, "obs": {"enabled": True,
                                             "trace": True}},
    "trace_on_compiled": {**ASYNC_WORLD, "obs": {"enabled": True,
                                                 "trace": True},
                          "schedule": {"mode": "async",
                                       "backend": "compiled"}},
    "sync_faults": {**SYNC_IMAGES, "faults": {"injectors":
                                              ["crash_restart"]}},
    "sync_serve": {**SYNC_IMAGES, "serve": {"traffic": "poisson"}},
    "sync_prediction_world": {**ASYNC_WORLD, "schedule": {"mode": "sync"}},
    "sync_compiled": {**SYNC_IMAGES, "schedule": {"mode": "sync",
                                                  "backend": "compiled"}},
    "sync_network": {**SYNC_IMAGES, "network": {"gossip": "push"}},
    "repair_without_gossip": {**ASYNC_WORLD, "network": {
        "transport": "gossip", "repair": "anti_entropy"}},
    "unknown_transport": {**ASYNC_WORLD, "network": {
        "transport": "warp_drive"}},
    "unknown_churn_param": {**ASYNC_WORLD, "network": {
        "churn": {"name": "lognormal", "params": {"beta_typo": 1}}}},
    # the compiled backend's refusals, raised when it runs
    "compiled_image_world": {**SYNC_IMAGES, "schedule": COMPILED},
    "compiled_in_loop_selection": {**ASYNC_WORLD, "schedule": {
        **COMPILED, "select_during_run": True}},
    "compiled_push_pull": {**ASYNC_WORLD, "schedule": COMPILED,
                           "network": {"gossip": "push_pull"}},
    "compiled_faults": {**ASYNC_WORLD, "schedule": COMPILED,
                        "faults": {"injectors": ["crash_restart"]}},
    "compiled_admission": {**ASYNC_WORLD, "schedule": COMPILED,
                           "faults": {"admission": "validation_gate"}},
    "compiled_serving": {**ASYNC_WORLD, "schedule": COMPILED,
                         "serve": {"traffic": "poisson",
                                   "monitor": False}},
}


@pytest.mark.parametrize("name", sorted(REFUSED_AS_IN_REFERENCE))
def test_refusals_match_reference(ref, name):
    d = REFUSED_AS_IN_REFERENCE[name]
    with pytest.raises(ValueError) as theirs:
        ref[0](d).run()
    with pytest.raises(ValueError) as ours:
        _port(d).run()
    assert str(ours.value) == str(theirs.value)


FORMERLY_REFUSED = {
    "compiled_backend": {**ASYNC_WORLD, "schedule": COMPILED,
                         "network": {"topology": "ring", "gossip": "push",
                                     "transport": "gossip"}},
    "restack": {**ASYNC_WORLD, "selection": {"device_resident": False}},
}


@pytest.mark.parametrize("name", sorted(FORMERLY_REFUSED))
def test_formerly_refused_sections_run(ref, name):
    """The compiled backend and the restack selection path build and run
    on the CPU, with the reference's net dict and coverage."""
    d = FORMERLY_REFUSED[name]
    ours, theirs = _port(d).run(), ref[0](d).run()
    assert ours.net == theirs.net and ours.coverage == theirs.coverage
    assert ours.perf["backend"] == theirs.perf["backend"]
    if name == "restack":
        assert ours.engine.store_batch is None
        assert ours.trace.events == theirs.trace.events
        assert _keys(ours.selections) == _keys(theirs.selections)


def test_async_entry_points_default_to_cuda():
    spec = ExperimentSpec.from_dict(copy.deepcopy(ASYNC_WORLD))
    if torch.cuda.is_available():
        assert Experiment.from_spec(spec).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            Experiment.from_spec(spec)


def test_none_world_runs_dissemination_only(ref):
    d = {"data": {"kind": "none", "n_clients": 6, "n_val": 16,
                  "models_per_client": 2},
         "selection": {"enabled": False},
         "network": {"topology": "ring", "gossip": "push",
                     "transport": "gossip"},
         "schedule": {"mode": "async"}, "seed": 1}
    ours, theirs = _port(d).run(), ref[0](d).run()
    assert ours.stores is None and ours.engine is None
    assert ours.trace.events == theirs.trace.events
    assert ours.net == theirs.net and ours.coverage == theirs.coverage


# ---- on the card -----------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no CPU mode")


SMALL_CARD = {**GOLDEN, "data": {**GOLDEN["data"], "n_clients": 12},
              "selection": {"pop_size": 24, "generations": 4, "k": 3,
                            "ensemble_k": 3, "store_capacity": 6},
              "obs": {}}


@pytest.mark.cuda
def test_cuda_async_run_matches_cpu_and_launches_the_kernel(cuda):
    from repro_torch.kernels.ensemble_fitness import kernel
    cpu = _port(SMALL_CARD).run()
    kernel.KERNEL.launches = 0
    card = _port(SMALL_CARD, device="cuda").run()
    launches = kernel.KERNEL.launches
    for field in ("events", "bench_sizes", "select_batches", "net"):
        assert getattr(card.trace, field) == getattr(cpu.trace, field)
    assert _keys(card.selections) == _keys(cpu.selections)
    ran = {t for v in card.selections.values() for t, _ in v}
    assert ran and launches == (2 * 4 + 1) * len(ran)


def test_chip_smoke_takes_the_slice_config_from_paper_cnn():
    """chip_smoke.py builds its synchronous slice from the port's
    configs/paper_cnn.py (full=True, 2 epochs) with the values it used to
    inline, and configuration 8 differs from it only in the schedule."""
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    inlined = ExperimentSpec.from_dict({
        "data": {"kind": "synthetic_images", "n_clients": 20,
                 "n_classes": 10, "n_samples": 60000, "image_size": 10,
                 "channels": 3, "alpha": 0.1},
        "train": {"families": ["cnn4", "vgg", "resnet", "densenet",
                               "inception"],
                  "lr": 0.05, "batch": 32, "max_epochs": 2, "patience": 8,
                  "width": 16},
        "selection": {"pop_size": 100, "generations": 100, "k": 5,
                      "ensemble_k": 5},
        "schedule": {"mode": "sync"}, "seed": 0})
    assert chip_smoke.paper_spec() == inlined
    async_spec = chip_smoke.paper_spec(chip_smoke.ASYNC_PAPER)
    assert async_spec.schedule.mode == "async"
    assert async_spec.schedule.select_debounce == 0.5
    async_spec.schedule = inlined.schedule
    assert async_spec == inlined
