"""The port's p2p stack (`repro_torch.p2p`) and component registry against
the JAX package's (`repro.p2p`, `repro.sim.registry`), which are plain
numpy: the same configs and seeds give the same draws, the same message
logs, the same stats dicts and the same event traces, exactly.

The event-loop cases drive both packages' `simulate_async` with the same
layers and a stub selection callback (the trace does not depend on what
a selection returns), across push / push_pull gossip, fanout, churn,
bounded inboxes and anti-entropy repair.
"""
import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")   # repro.sim imports JAX

import repro.p2p as jp2p  # noqa: E402
import repro.sim as jsim  # noqa: E402
from repro.fl import scheduler as jsched  # noqa: E402
from repro.fl.topology import make_topology  # noqa: E402
from repro.p2p.params import check_params as jcheck_params  # noqa: E402
import repro_torch.p2p as tp2p  # noqa: E402
import repro_torch.sim as tsim  # noqa: E402
from repro_torch.fl import scheduler as tsched  # noqa: E402
from repro_torch.p2p.params import check_params  # noqa: E402
from repro_torch.sim.spec import ComponentSpec  # noqa: E402

EDGES = [(0, 0, 1, (0, 0), 0, 0), (7, 3, 5, (2, 1), 2, 1),
         (123, 63, 0, (jp2p.DIGEST_OWNER, 4), 0, 0)]


@pytest.mark.parametrize("seed,src,dst,key,attempt,version", EDGES)
def test_edge_and_repair_streams_match(seed, src, dst, key, attempt,
                                       version):
    assert tp2p.DIGEST_OWNER == jp2p.DIGEST_OWNER
    for ours, theirs in ((tp2p.edge_rng, jp2p.edge_rng),
                         (tp2p.repair_rng, jp2p.repair_rng)):
        a = ours(seed, src, dst, key, attempt, version).random(6)
        b = theirs(seed, src, dst, key, attempt, version).random(6)
        np.testing.assert_array_equal(a, b)


def test_message_sizers_match():
    for v, c in ((64, 4), (128, 8), (450, 10)):
        assert tp2p.prediction_matrix_bytes(v, c) == \
            jp2p.prediction_matrix_bytes(v, c)
    assert tp2p.checkpoint_bytes(250_000) == jp2p.checkpoint_bytes(250_000)
    for n in (0, 1, 17):
        assert tp2p.digest_nbytes(n, 12) == jp2p.digest_nbytes(n, 12)


CHURNS = [dict(), dict(availability_beta=0.2, join_spread=1.0,
                       leave_prob=0.2, seed=3),
          dict(availability_beta=0.1, leave_prob=0.05, window=0.5, seed=0),
          dict(availability_beta=0.0, join_spread=2.0, seed=1)]


@pytest.mark.parametrize("kw", CHURNS)
def test_churn_schedule_matches(kw):
    n = 24
    ours = tp2p.ChurnSchedule(tp2p.ChurnConfig(**kw), n)
    theirs = jp2p.ChurnSchedule(jp2p.ChurnConfig(**kw), n)
    for name in ("p_online", "join", "leave"):
        np.testing.assert_array_equal(getattr(ours, name),
                                      getattr(theirs, name))
    for t in np.linspace(0.0, 9.0, 37):
        for c in range(n):
            assert ours.is_online(c, t) == theirs.is_online(c, t)
            assert ours.departed(c, t) == theirs.departed(c, t)


TRANSPORTS = [dict(), dict(drop_prob=0.3, seed=5),
              dict(inbox_capacity=2, bandwidth=1e4, jitter=0.5, seed=1),
              dict(drop_prob=0.1, inbox_capacity=3, bandwidth=50e6)]


@pytest.mark.parametrize("kw", TRANSPORTS)
def test_transport_matches(kw):
    """A scripted mix of sends (sized and digest-sized, repeated edges so
    attempts fold in) and deliveries gives the same arrivals, outcomes,
    logs, inbox levels and stats."""
    n = 6
    size = (lambda s, d, k: 100 * (1 + k[1]))
    ours = tp2p.GossipTransport(tp2p.TransportConfig(**kw), n, size)
    theirs = jp2p.GossipTransport(jp2p.TransportConfig(**kw), n, size)
    rng = np.random.default_rng(0)
    inflight = []
    for step in range(200):
        t = step * 0.01
        if inflight and rng.random() < 0.4:
            args = inflight.pop(int(rng.integers(len(inflight))))
            lost = bool(rng.random() < 0.2)
            for tr in (ours, theirs):
                tr.deliver(*args, lost=lost, t=t)
            continue
        src, dst = (int(x) for x in rng.integers(0, n, 2))
        key = (int(rng.integers(0, n)), int(rng.integers(0, 2)))
        nbytes = int(rng.integers(12, 60)) if rng.random() < 0.2 else None
        version = int(rng.integers(0, 2))
        a = ours.send(src, dst, key, t, nbytes=nbytes, version=version)
        b = theirs.send(src, dst, key, t, nbytes=nbytes, version=version)
        assert a == b and ours.last_outcome == theirs.last_outcome
        if a is not None:
            inflight.append((src, dst, key))
    assert ours.log == theirs.log
    np.testing.assert_array_equal(ours.inflight, theirs.inflight)
    assert ours.stats.as_dict() == theirs.stats.as_dict()


def _gossip_pair(mode, fanout, n=10):
    nb = make_topology("small_world", n, k=4, seed=2)
    churn = [mod.ChurnSchedule(mod.ChurnConfig(leave_prob=0.3, seed=4), n)
             for mod in (tp2p, jp2p)]
    return [mod.GossipProtocol(mod.GossipConfig(mode=mode, fanout=fanout,
                                                seed=1), nb, churn=ch)
            for mod, ch in zip((tp2p, jp2p), churn)]


@pytest.mark.parametrize("mode,fanout", [("push", 0), ("push_pull", 0),
                                         ("push", 2), ("push_pull", 3)])
def test_gossip_protocol_matches(mode, fanout):
    """Scripted local models, receives (fresh, stale and re-versioned),
    sends and losses: the same forwards and the same version vectors,
    beliefs and stats."""
    ours, theirs = _gossip_pair(mode, fanout)
    rng = np.random.default_rng(1)
    n = len(ours.neighbors)
    for step in range(300):
        t = step * 0.05
        c = int(rng.integers(n))
        r = rng.random()
        if r < 0.15:
            key = (c, int(rng.integers(2)))
            assert ours.on_local(c, key, t) == theirs.on_local(c, key, t)
        elif r < 0.8:
            src = int(rng.choice(ours.neighbors[c]))
            key = (int(rng.integers(n)), int(rng.integers(2)))
            ver = int(rng.integers(0, 2))
            assert ours.on_receive(c, src, key, t, version=ver) == \
                theirs.on_receive(c, src, key, t, version=ver)
        elif r < 0.9:
            dst = int(rng.choice(ours.neighbors[c]))
            key = (int(rng.integers(n)), 0)
            ours.note_sent(c, dst, key)
            theirs.note_sent(c, dst, key)
        else:
            dst = int(rng.choice(ours.neighbors[c]))
            key = (int(rng.integers(n)), 0)
            ours.note_lost(c, dst, key)
            theirs.note_lost(c, dst, key)
    assert ours.have == theirs.have and ours.peer_has == theirs.peer_has
    assert ours.stats.as_dict() == theirs.stats.as_dict()


@pytest.mark.parametrize("budget,attempts", [(8, 4), (2, 1)])
def test_repair_decisions_match(budget, attempts):
    """Scripted digest polls, receipts, refunds and wakes: the same
    digests, re-send schedules, re-arms and stats."""
    gossip = _gossip_pair("push", 0)
    n = len(gossip[0].neighbors)
    rng = np.random.default_rng(2)
    for step in range(60):     # give the clients uneven holdings
        c, key = int(rng.integers(n)), (int(rng.integers(n)), 0)
        for g in gossip:
            g.have[c][key] = int(step % 3 == 0)
    cfgs = [mod.RepairConfig(max_resends_per_digest=budget,
                             max_attempts=attempts, seed=6)
            for mod in (tp2p, jp2p)]
    ours = tp2p.AntiEntropyRepair(cfgs[0], gossip[0])
    theirs = jp2p.AntiEntropyRepair(cfgs[1], gossip[1])
    assert ours.edges == theirs.edges
    for step in range(400):
        t = 1.0 + step * 0.03
        a, b = ours.edges[int(rng.integers(len(ours.edges)))]
        r = rng.random()
        if r < 0.4:
            assert ours.poll(a, b, t) == theirs.poll(a, b, t)
        elif r < 0.85:
            entries = tuple(sorted(gossip[0].have[a].items()))
            assert ours.on_digest(b, a, entries, t) == \
                theirs.on_digest(b, a, entries, t)
        elif r < 0.95:
            key = (int(rng.integers(n)), 0)
            ours.refund_attempt(b, a, key, 0)
            theirs.refund_attempt(b, a, key, 0)
        else:
            assert ours.wake(a, t) == theirs.wake(a, t)
    assert ours.stats.as_dict() == theirs.stats.as_dict()
    assert ours.attempts == theirs.attempts and ours.active == theirs.active


NETS = {
    "ideal": dict(),
    "lossy_churn_repair": dict(
        transport=dict(drop_prob=0.2, inbox_capacity=32), gossip="push",
        churn=dict(availability_beta=0.2, join_spread=1.0,
                   leave_prob=0.2),
        repair=dict(max_rounds=30, max_attempts=6)),
    "push_pull_fanout": dict(
        transport=dict(drop_prob=0.05, bandwidth=1e5), gossip="push_pull",
        fanout=2, churn=dict(availability_beta=0.1, leave_prob=0.1)),
    "inbox_pressure_repair": dict(
        transport=dict(inbox_capacity=2, jitter=2.0), gossip="push",
        repair=dict(max_resends_per_digest=2, quiesce_after=1)),
}


def _layers(mod, net, n, seed):
    nb = make_topology("small_world" if net else "full", n, k=4,
                       seed=seed)
    churn = (mod.ChurnSchedule(mod.ChurnConfig(**net["churn"], seed=seed),
                               n) if "churn" in net else None)
    gossip = (mod.GossipProtocol(mod.GossipConfig(
        mode=net["gossip"], fanout=net.get("fanout", 0), seed=seed), nb,
        churn=churn) if "gossip" in net else None)
    transport = (mod.GossipTransport(
        mod.TransportConfig(**net["transport"], seed=seed), n,
        lambda s, d, k: 4 * 64 * 8) if "transport" in net else None)
    repair = (mod.AntiEntropyRepair(
        mod.RepairConfig(**net["repair"], seed=seed), gossip, churn=churn)
        if "repair" in net else None)
    return nb, dict(transport=transport, gossip=gossip, churn=churn,
                    repair=repair)


@pytest.mark.parametrize("name", sorted(NETS))
def test_event_loop_matches_reference(name):
    """Both packages' simulate_async over the same layers: events, bench
    sizes, select batches, selections and the net dict all equal."""
    n, seed = 12, 3
    traces = []
    for mod, sched in ((tp2p, tsched), (jp2p, jsched)):
        nb, layers = _layers(mod, NETS[name], n, seed)
        cfg = sched.AsyncConfig(n_clients=n, models_per_client=2,
                                select_debounce=0.25, seed=seed)
        traces.append(sched.simulate_async(
            cfg, nb, train_cost=lambda c, m: 1.0 + 0.3 * m,
            on_select_batch=lambda cs, ids, t: {c: 0.5 for c in cs},
            **layers))
    ours, theirs = traces
    assert len(ours.events) > 4 * n
    for field in ("events", "bench_sizes", "select_batches", "selections",
                  "net"):
        assert getattr(ours, field) == getattr(theirs, field), field
    assert ours.perf.keys() == theirs.perf.keys()


def test_train_completions_match():
    cfg = dict(n_clients=9, models_per_client=3, speed_lognorm_sigma=0.6,
               seed=4)
    churn = [mod.ChurnSchedule(mod.ChurnConfig(join_spread=2.0, seed=4), 9)
             for mod in (tp2p, jp2p)]
    np.testing.assert_array_equal(
        tsched.client_speeds(tsched.AsyncConfig(**cfg)),
        jsched.client_speeds(jsched.AsyncConfig(**cfg)))
    np.testing.assert_array_equal(
        tsched.train_completions(tsched.AsyncConfig(**cfg),
                                 lambda c, m: 1.0 + 0.2 * m, churn[0]),
        jsched.train_completions(jsched.AsyncConfig(**cfg),
                                 lambda c, m: 1.0 + 0.2 * m, churn[1]))


# ---- the component registry ---------------------------------------------

@pytest.mark.parametrize("kind", ["transport", "gossip", "churn", "repair",
                                  "train_cost", "sizer", "backend", "sink"])
def test_registry_lists_the_reference_stock_set(kind):
    assert tsim.known(kind) == jsim.known(kind)
    with pytest.raises(ValueError, match="registered: ") as ours:
        tsim.resolve(kind, "no_such_component")
    with pytest.raises(ValueError) as theirs:
        jsim.resolve(kind, "no_such_component")
    assert str(ours.value) == str(theirs.value)


def test_registry_unknown_kind_and_custom_registration():
    with pytest.raises(ValueError, match="unknown component kind"):
        tsim.resolve("teleporter", "x")
    with pytest.raises(ValueError, match="unknown component kind"):
        tsim.register("teleporter", "x")

    @tsim.register("train_cost", "quadratic_test")
    def _quadratic(params, ctx):
        check_params(params, ("a",), "train_cost[quadratic_test]")
        a = float(params.get("a", 1.0))
        return lambda c, m: a * (1 + m) ** 2
    fn = tsim.resolve("train_cost", "quadratic_test")({"a": 2.0}, {})
    assert fn(0, 2) == 18.0
    assert "quadratic_test" in tsim.known("train_cost")


BAD_PARAMS = [("transport", "gossip", {"drop_rate": 0.1}),
              ("gossip", "push", {"fan_out": 2}),
              ("gossip", "push_pull", {"mode": "push"}),
              ("churn", "lognormal", {"beta": 0.1}),
              ("repair", "anti_entropy", {"rounds": 3}),
              ("train_cost", "affine", {"intercept": 1.0}),
              ("sizer", "prediction_matrix", {"n_rows": 3}),
              ("backend", "event", {"tick": 0.1}),
              ("sink", "metrics_json", {"file": "x.json"})]


@pytest.mark.parametrize("kind,name,params", BAD_PARAMS)
def test_unknown_params_raise_as_in_the_reference(kind, name, params):
    ctx = {"n_clients": 4, "n_val": 8, "n_classes": 2, "seed": 0,
           "neighbors": [[1], [0], [3], [2]]}
    errors = []
    for mod, gossip_mod in ((tsim, tp2p), (jsim, jp2p)):
        c = dict(ctx, gossip=gossip_mod.GossipProtocol(
            gossip_mod.GossipConfig(), ctx["neighbors"]))
        with pytest.raises(ValueError) as e:
            mod.resolve(kind, name)(dict(params), c)
        errors.append(str(e.value))
    assert errors[0] == errors[1]
    assert "unknown" in errors[0] or "must not carry" in errors[0]


def test_check_params_matches_reference():
    for params, allowed in (({"a": 1}, ("a", "b")), ({"c": 1, "a": 2},
                                                     ("a",))):
        got = want = None
        try:
            check_params(params, allowed, "x[y]")
        except ValueError as e:
            got = str(e)
        try:
            jcheck_params(params, allowed, "x[y]")
        except ValueError as e:
            want = str(e)
        assert got == want
    assert ComponentSpec.of("push", "x") == ComponentSpec("push", {})
