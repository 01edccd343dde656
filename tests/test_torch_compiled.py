"""The port's compiled array-world backend (`repro_torch/sim/compiled.py`)
against the reference's (`repro/sim/compiled.py`), on the CPU.

The acceptance bar is exact equality: the same spec gives the same
`have_tick` matrix, net dict, coverage, `t_full` and `n_ticks` in both
packages — on the deterministic tier (T1, also equal to the port's own
event loop), lossy links with anti-entropy repair (T2), churn (T3), key
block sharding, the prediction world's store fill, the metric frames and
`examples/specs/fleet_sweep.json --smoke` through both CLIs. The splitmix
hash equals the reference's bit for bit, the refusals use the
reference's words, and chip_smoke.py's configuration-13 constants are
re-derived from the reference's full-size run. A `cuda` case holds the
card against the CPU.
"""
import contextlib
import copy
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.sim import Experiment, ExperimentSpec  # noqa: E402
from repro_torch.sim import compiled as tcompiled  # noqa: E402

REPO = os.path.join(os.path.dirname(__file__), "..")
FLEET = os.path.join(REPO, "examples", "specs", "fleet_sweep.json")
REPAIR = {"interval": 0.5, "start": 0.5, "max_rounds": 40}
CHURN = {"availability_beta": 0.3, "window": 0.5, "join_spread": 1.0}


from _torch_threads import one_thread as _one_thread  # noqa: E402,F401


@pytest.fixture(scope="module")
def ref():
    """The reference package (needs JAX): (a function that makes its
    Experiment from a spec dict, its compiled module)."""
    pytest.importorskip("jax")
    from repro.sim import Experiment as JExperiment
    from repro.sim import ExperimentSpec as JSpec
    from repro.sim import compiled as jcompiled

    def build(d):
        return JExperiment.from_spec(JSpec.from_dict(copy.deepcopy(d)))
    return build, jcompiled


def spec(backend, topo, n, mpc=1, seed=0, drop=0.0, churn=None,
         repair=None, backend_params=None, kind="none", gossip="push",
         selection=None, select_during_run=False, obs=None):
    """tests/test_compiled.py's spec, as a dict both packages parse."""
    net = {"topology": topo, "topology_k": 4,
           "transport": {"name": "gossip",
                         "params": {"base_latency": 0.05, "jitter": 0.0,
                                    "drop_prob": drop}},
           "gossip": gossip}
    if churn is not None:
        net["churn"] = {"name": "lognormal", "params": churn}
    if repair is not None:
        net["repair"] = {"name": "anti_entropy", "params": repair}
    d = {"data": {"kind": kind, "n_clients": n, "models_per_client": mpc,
                  "n_val": 16, "n_classes": 4},
         "selection": selection or {"enabled": False},
         "network": net,
         "schedule": {"mode": "async",
                      "select_during_run": select_during_run,
                      "backend": {"name": backend,
                                  "params": backend_params or {}}},
         "seed": seed}
    if obs is not None:
        d["obs"] = obs
    return d


def _port(d, device="cpu"):
    return Experiment.from_spec(ExperimentSpec.from_dict(copy.deepcopy(d)),
                                device=device)


@contextlib.contextmanager
def recording(module):
    """Record what `module.simulate_compiled` returns (its `have_tick`
    never reaches the RunResult)."""
    seen = []
    inner = module.simulate_compiled

    def wrapped(*a, **kw):
        out = inner(*a, **kw)
        seen.append(out)
        return out
    module.simulate_compiled = wrapped
    try:
        yield seen
    finally:
        module.simulate_compiled = inner


def both(ref, d, device="cpu"):
    """(port run, port raw output, reference run, reference raw output)."""
    with recording(tcompiled) as ours:
        res = _port(d, device).run()
    with recording(ref[1]) as theirs:
        jres = ref[0](d).run()
    return res, ours[0], jres, theirs[0]


def assert_equal_runs(ours, theirs):
    """have_tick, net, coverage, t_full and n_ticks equal."""
    np.testing.assert_array_equal(ours["have_tick"],
                                  np.asarray(theirs["have_tick"]))
    assert ours["have_tick"].dtype == np.int32
    assert ours["net"] == theirs["net"]
    assert ours["coverage"] == theirs["coverage"]
    assert ours["n_ticks"] == theirs["n_ticks"]
    assert (ours["t_full"] == theirs["t_full"]
            or (math.isnan(ours["t_full"]) and math.isnan(theirs["t_full"])))


# ---- the in-step hash ------------------------------------------------------

def test_hash_matches_reference(ref):
    jnp = pytest.importorskip("jax.numpy")
    rng = np.random.default_rng(0)
    parts = [rng.integers(-1, 2**31 - 1, 200_000).astype(np.int32)
             for _ in range(3)]
    parts[0][:100] = -1                  # the adjacency's padding
    for seed, dom in ((0, 0x1111), (2**32 + 7, 0x5555), (12345, 0x7777)):
        want = np.asarray(ref[1]._hash_u32(
            seed, dom, *(jnp.asarray(p) for p in parts)))
        got = tcompiled._hash_u32(seed, dom,
                                  *(torch.as_tensor(p) for p in parts))
        np.testing.assert_array_equal(
            got.numpy().view(np.uint32), want.astype(np.uint32))
        want01 = np.asarray(ref[1]._hash01(
            seed, dom, *(jnp.asarray(p) for p in parts)))
        got01 = tcompiled._hash01(seed, dom,
                                  *(torch.as_tensor(p) for p in parts))
        np.testing.assert_array_equal(got01.numpy(), want01)


# ---- T1: the deterministic tier ------------------------------------------

T1 = [("full", 5, 1, 0, 0.05), ("ring", 8, 2, 1, 0.025),
      ("small_world", 16, 1, 2, 0.05), ("small_world", 32, 2, 3, 0.025),
      ("ring", 32, 1, 4, 0.05), ("full", 16, 2, 0, 0.025)]


@pytest.mark.parametrize("topo,n,mpc,seed,tick", T1)
def test_deterministic_tier_equals_reference(ref, topo, n, mpc, seed,
                                             tick):
    d = spec("compiled", topo, n, mpc, seed, backend_params={"tick": tick})
    res, ours, _, theirs = both(ref, d)
    assert_equal_runs(ours, theirs)
    assert res.coverage == 1.0
    # the reference's T1 contract holds on the port's own event loop too
    ev = _port(spec("event", topo, n, mpc, seed)).run()
    assert res.net == ev.net
    assert abs(ev.t_full - res.t_full) <= tick + 1e-9


# ---- T2: lossy links + repair; T3: churn ---------------------------------

@pytest.mark.parametrize("topo,n,seed", [("ring", 16, 0),
                                         ("small_world", 32, 1),
                                         ("small_world", 16, 3)])
def test_lossy_repair_tier_equals_reference(ref, topo, n, seed):
    d = spec("compiled", topo, n, 1, seed, drop=0.1, repair=REPAIR,
             backend_params={"tick": 0.05})
    res, ours, _, theirs = both(ref, d)
    assert_equal_runs(ours, theirs)
    assert res.coverage == 1.0 and res.net["repair"]["n_resends"] > 0


@pytest.mark.parametrize("topo,n,seed", [("full", 16, 0), ("ring", 32, 2)])
def test_churn_tier_equals_reference(ref, topo, n, seed):
    d = spec("compiled", topo, n, 1, seed, drop=0.1, churn=CHURN,
             repair=REPAIR, backend_params={"tick": 0.05})
    res, ours, _, theirs = both(ref, d)
    assert_equal_runs(ours, theirs)
    assert res.net["lost_offline"] > 0


def test_jittered_links_equal_reference(ref):
    """Jitter and a finite bandwidth: every latency formula's float32
    arithmetic (forward, digest, re-send) as the reference computes it."""
    d = spec("compiled", "small_world", 24, 2, 5, drop=0.2, repair=REPAIR,
             backend_params={"tick": 0.025})
    d["network"]["transport"]["params"].update(jitter=1.0, bandwidth=5e6)
    _, ours, _, theirs = both(ref, d)
    assert_equal_runs(ours, theirs)


# ---- deterministic contracts ---------------------------------------------

def test_key_block_sharding_equals_reference(ref):
    base = spec("compiled", "ring", 8, 2, 0, backend_params={"tick": 0.05})
    shard = spec("compiled", "ring", 8, 2, 0,
                 backend_params={"tick": 0.05, "key_block": 5})
    a, raw_a, _, _ = both(ref, base)
    b, raw_b, _, theirs = both(ref, shard)
    assert_equal_runs(raw_b, theirs)
    np.testing.assert_array_equal(raw_a["have_tick"], raw_b["have_tick"])
    assert (a.net, a.t_full, a.coverage) == (b.net, b.t_full, b.coverage)
    assert raw_b["n_ticks"] > raw_a["n_ticks"]     # two blocks ran


def test_compiled_rerun_is_deterministic():
    d = spec("compiled", "small_world", 16, 2, 3, drop=0.2, repair=REPAIR)
    with recording(tcompiled) as seen:
        a = _port(d).run()
        b = _port(d).run()
    assert a.net == b.net and a.t_full == b.t_full
    np.testing.assert_array_equal(seen[0]["have_tick"], seen[1]["have_tick"])


def test_perf_keys(ref):
    d = spec("compiled", "ring", 8, 1, 0, backend_params={"tick": 0.05})
    res, _, jres, _ = both(ref, d)
    assert res.perf["backend"] == "compiled"
    assert set(res.perf) == set(jres.perf)
    assert set(res.perf["phases"]) == set(jres.perf["phases"])
    assert res.perf["n_ticks"] == jres.perf["n_ticks"] > 0
    assert res.perf["wall_s"] >= res.perf["phases"]["scan_s"] >= 0
    assert res.summary()["perf"] == res.perf


def test_prediction_world_store_fill_equals_reference(ref):
    d = spec("compiled", "ring", 6, 2, 1, drop=0.1, repair=REPAIR,
             kind="prediction_world", backend_params={"tick": 0.05},
             selection={"enabled": True, "pop_size": 8, "generations": 2,
                        "k": 2})
    res, ours, jres, theirs = both(ref, d)
    assert_equal_runs(ours, theirs)
    assert res.coverage == 1.0
    for s, js in zip(res.stores, jres.stores):
        assert [e and e.model_id for e in s.entries] == \
            [e and e.model_id for e in js.entries]
        np.testing.assert_array_equal(s.preds, js.preds)
        np.testing.assert_array_equal(s.mask, js.mask)
        np.testing.assert_array_equal(s.last_used, js.last_used)
    picked = res.engine.select()
    assert sorted(picked) == list(range(6))
    assert all(r["chromosome"].sum() == 2 for r in picked.values())


@pytest.mark.parametrize("n,seed", [(10, 3), (16, 7)])
def test_metric_frame_parity(ref, n, seed):
    """tests/test_obs.py's event-vs-compiled parity on the port, and the
    port's compiled frame equal to the reference's."""
    def obs_spec(backend):
        d = spec(backend, "ring", n, 2, seed, obs={"enabled": True})
        return d
    ev = _port(obs_spec("event")).run().metrics
    co = _port(obs_spec("compiled")).run().metrics
    jco = ref[0](obs_spec("compiled")).run().metrics
    assert ev.names() == co.names()
    assert set(ev.series) == set(co.series)
    for k in ev.scalars:
        if k == "coverage.t_full":
            assert abs(ev.scalars[k] - co.scalars[k]) <= 0.05 + 1e-9
        else:
            assert ev.scalars[k] == co.scalars[k], k
    for k in ("net.msgs_on_wire", "net.bytes_on_wire", "gossip.accepted"):
        assert ev.series[k][-1][1] == co.series[k][-1][1], k
    assert co.meta["backend"] == "compiled"
    assert co.to_dict() == jco.to_dict()


# ---- refusals, in the reference's words ----------------------------------

# the section-level refusals (image worlds, in-loop selection, push_pull,
# faults, admission, serving) are cases of test_torch_async.py's
# test_refusals_match_reference; these are the p2p stack's and the
# backend's own
REFUSALS = {
    "bounded_inbox": spec("compiled", "ring", 4),
    "repair_partial_key_block": spec(
        "compiled", "ring", 8, mpc=2, repair=REPAIR,
        backend_params={"tick": 0.05, "key_block": 5}),
    "unknown_backend_param": spec("compiled", "ring", 4,
                                  backend_params={"nope": 1}),
    "fanout": spec("compiled", "ring", 4,
                   gossip={"name": "push", "params": {"fanout": 1}}),
    "non_constant_sizer": None,
}
REFUSALS["bounded_inbox"]["network"]["transport"]["params"][
    "inbox_capacity"] = 2


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_refusals_match_reference(ref, name):
    d = REFUSALS[name]
    if name == "non_constant_sizer":
        # no stock sizer varies per message: a transport built by hand
        from repro.p2p import transport as jt
        from repro_torch.p2p import transport as tt
        with pytest.raises(ValueError) as theirs:
            _nonconstant(jt).array_params()
        with pytest.raises(ValueError) as ours:
            _nonconstant(tt).array_params()
    else:
        with pytest.raises(ValueError) as theirs:
            ref[0](d).run()
        with pytest.raises(ValueError) as ours:
            _port(d).run()
    assert str(ours.value) == str(theirs.value)


def _nonconstant(mod):
    return mod.GossipTransport(mod.TransportConfig(), 4,
                               lambda s, d, key: 100 + key[0])


# ---- the repo's fleet spec ----------------------------------------------

def _cli(module, *args):
    proc = subprocess.run(
        [sys.executable, "-m", module, "--spec", FLEET, *args],
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
                 JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout)


def test_fleet_sweep_smoke_equals_reference_through_both_clis(ref):
    ours = _cli("repro_torch.sim.run", "--smoke", "--device", "cpu")
    theirs = _cli("repro.sim.run", "--smoke")
    assert ours["coverage"] == theirs["coverage"] == 1.0
    assert ours["net"] == theirs["net"]
    assert ours["t_full"] == theirs["t_full"] == 8.25
    assert ours["perf"]["n_ticks"] == theirs["perf"]["n_ticks"] == 64
    assert ours["n_clients"] == 256


def test_chip_smoke_fleet_constants_equal_reference_full_size(ref):
    """chip_smoke.py holds the card's full-size fleet_sweep run to these
    constants; here they come from the reference's own full-size run."""
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    with open(FLEET) as f:
        d = json.load(f)
    d.pop("smoke_overrides")
    with recording(ref[1]) as theirs:
        jres = ref[0](d).run()
    want = chip_smoke.FLEET_FULL
    assert jres.net == want["net"]
    assert jres.t_full == want["t_full"]
    assert theirs[0]["n_ticks"] == want["n_ticks"]
    assert jres.coverage == 1.0


# ---- on the card ---------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the card-vs-CPU check")


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["lossy_repair_churn", "jitter"])
def test_card_equals_cpu(cuda, case):
    d = spec("compiled", "small_world", 48, 2, 1, drop=0.1, repair=REPAIR,
             churn=CHURN if case == "lossy_repair_churn" else None,
             backend_params={"tick": 0.05, "chunk_ticks": 16})
    if case == "jitter":
        d["network"]["transport"]["params"].update(jitter=1.0,
                                                   bandwidth=5e6)
    with recording(tcompiled) as seen:
        card = _port(d, "cuda").run()
        cpu = _port(d, "cpu").run()
    np.testing.assert_array_equal(seen[0]["have_tick"], seen[1]["have_tick"])
    assert card.net == cpu.net and card.perf["n_ticks"] == cpu.perf["n_ticks"]
    assert card.t_full == cpu.t_full or (math.isnan(card.t_full)
                                         and math.isnan(cpu.t_full))
    h = torch.tensor([-1, 0, 7, 2**31 - 1], dtype=torch.int32)
    for dom in (0x1111, 0x7777):
        assert torch.equal(tcompiled._hash_u32(2**32 + 5, dom, h, h).cpu(),
                           tcompiled._hash_u32(2**32 + 5, dom, h.cuda(),
                                               h.cuda()).cpu())
