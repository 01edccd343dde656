"""The paper's seven comparison methods, clustered gossip and the table
scripts of the port against the JAX reference.

Each baseline runs at `tests/test_fl.py`'s two-round size (3 clients, 6
classes, 8x8 images, width 8, 2 rounds of 1 local step) in both
packages from the same weights (the reference's `init_model`, carried
across through `init=`) and the same numpy draws; the final test
probabilities, recorded by wrapping each module's `predict_probs`, agree
to 1e-4 and the accuracies are equal. `clustering` and Table IV's FLOP
counts are exact. The table scripts run at `paper_cnn.smoke()` on the
CPU; the `cuda` case runs every baseline on the card and on the CPU.
"""
import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.benchmarks import table1_accuracy as t1  # noqa: E402
from repro_torch.benchmarks import table2_negative_transfer as t2  # noqa: E402
from repro_torch.benchmarks.table4_cost import family_forward_flops  # noqa: E402
from repro_torch.benchmarks.common import make_clients  # noqa: E402
from repro_torch.configs import paper_cnn  # noqa: E402
from repro_torch.fl import baselines as tb  # noqa: E402
from repro_torch.fl import clustering as tc  # noqa: E402
from repro_torch.models.cnn import CNNConfig, params_from_jax  # noqa: E402

REPO = os.path.join(os.path.dirname(__file__), "..")
PROB_ATOL = 1e-4
FAMILIES = ("cnn4", "vgg", "resnet", "densenet", "inception")


from _torch_threads import one_thread as _one_thread  # noqa: E402,F401


@pytest.fixture(scope="module")
def ref():
    """The reference's baselines and clustering modules and an `init=`
    that hands the port the reference's weights (needs JAX)."""
    jax = pytest.importorskip("jax")
    from repro.fl import baselines, clustering
    from repro.models.cnn import CNNConfig as JConfig
    from repro.models.cnn import init_model

    def init(family, seed, ccfg):
        p = init_model(family, jax.random.PRNGKey(seed), JConfig(
            n_classes=ccfg.n_classes, width=ccfg.width,
            in_channels=ccfg.in_channels))
        return params_from_jax(family, {k: np.asarray(v)
                                        for k, v in p.items()})
    return baselines, clustering, init


@pytest.fixture(scope="module")
def ref_tables():
    """The reference's table scripts (`benchmarks/`, needs JAX)."""
    pytest.importorskip("jax")
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    from benchmarks import table1_accuracy, table2_negative_transfer
    from benchmarks import table4_cost
    return table1_accuracy, table2_negative_transfer, table4_cost


def _clients(n_clients):
    """tests/test_fl.py's world: 600 images of 8x8 in 6 classes."""
    datasets, _ = make_clients(n_clients, 0.5, 600, 6, size=8, seed=0)
    return datasets


def _recorded(monkeypatch, module):
    """Wrap `module.predict_probs` so every call's probabilities land in
    the returned list."""
    seen, orig = [], module.predict_probs

    def predict_probs(*args, **kw):
        out = orig(*args, **kw)
        seen.append(np.asarray(out))
        return out
    monkeypatch.setattr(module, "predict_probs", predict_probs)
    return seen


def _both(ref, monkeypatch, name, n_clients, families):
    baselines, _, init = ref
    datasets = _clients(n_clients)
    theirs_p = _recorded(monkeypatch, baselines)
    ours_p = _recorded(monkeypatch, tb)
    kw = dict(rounds=2, local_steps=1, families=families, width=8)
    theirs = baselines.BASELINES[name](datasets, 6, baselines.FLConfig(**kw))
    ours = tb.BASELINES[name](datasets, 6, tb.FLConfig(**kw), device="cpu",
                              init=init)
    return theirs, ours, theirs_p, ours_p


def _hold(theirs, ours, theirs_p, ours_p, n_clients):
    assert ours.shape == (n_clients,) and len(ours_p) == len(theirs_p)
    for a, b in zip(ours_p, theirs_p):
        assert a.shape == b.shape
        assert float(np.abs(a - b).max()) <= PROB_ATOL
    np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize("name", list(tb.BASELINES))
def test_baseline_matches_reference(ref, monkeypatch, name):
    _hold(*_both(ref, monkeypatch, name, 3, ("cnn4", "vgg")), 3)


@pytest.mark.parametrize("name", ["lg_fedavg", "fedgh"])
def test_head_baselines_match_reference_on_all_five_families(
        ref, monkeypatch, name):
    # five clients, so every family holds a client
    _hold(*_both(ref, monkeypatch, name, 5, FAMILIES), 5)


def test_baselines_table_matches_reference(ref):
    assert list(tb.BASELINES) == list(ref[0].BASELINES)
    assert tb.DEFAULT_FAMILIES == ref[0].DEFAULT_FAMILIES
    import dataclasses
    assert dataclasses.asdict(tb.FLConfig()) == \
        dataclasses.asdict(ref[0].FLConfig())


# the integer each method passes to `init`, as the reference's PRNGKey:
# fl.seed for the global cnn4, fl.seed + i for client i, fl.seed - 1 for
# FML's auxiliary model, 0 for FedGH's first head whatever the seed
INIT_SEEDS = {
    "fedavg": [("cnn4", 5)], "fedprox": [("cnn4", 5)],
    "feddistill": [("cnn4", 5), ("vgg", 6), ("cnn4", 7)],
    "lg_fedavg": [("cnn4", 5), ("vgg", 6), ("cnn4", 7)],
    "fedgh": [("cnn4", 5), ("vgg", 6), ("cnn4", 7), ("cnn4", 0)],
    "fml": [("cnn4", 5), ("vgg", 6), ("cnn4", 7), ("cnn4", 4)],
    "fedkd": [("cnn4", 5), ("vgg", 6), ("cnn4", 7), ("cnn4", 4)],
}


@pytest.mark.parametrize("name", list(tb.BASELINES))
def test_init_seam_gets_the_reference_keys(name):
    from repro_torch.models.cnn import init_model
    calls = []

    def init(family, seed, ccfg):
        calls.append((family, seed))
        return init_model(family, seed, ccfg)
    fl = tb.FLConfig(rounds=0, families=("cnn4", "vgg"), width=4, seed=5)
    acc = tb.BASELINES[name](_clients(3), 6, fl, device="cpu", init=init)
    assert calls == INIT_SEEDS[name] and acc.shape == (3,)


@pytest.mark.parametrize("name", ["fedavg", "fml"])
def test_cpu_runs_are_bitwise_repeatable(monkeypatch, name):
    seen = _recorded(monkeypatch, tb)
    fl = tb.FLConfig(rounds=2, local_steps=1, families=("cnn4", "vgg"),
                     width=8, seed=3)
    for _ in range(2):
        tb.BASELINES[name](_clients(3), 6, fl, device="cpu")
    half = len(seen) // 2
    assert all(np.array_equal(a, b) for a, b in zip(seen[:half],
                                                     seen[half:]))


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="cuda"):
        tb.run_fedavg(_clients(3), 6, tb.FLConfig(rounds=0, width=4))


# ---- clustered gossip ----------------------------------------------------

def _history(seed, n=9, rounds=3):
    """A random selection history: every client picks a few owners a
    round (some never pick a peer)."""
    rng = np.random.default_rng(seed)
    steps = []
    for _ in range(rounds):
        for c in range(n):
            k = int(rng.integers(0, 4))
            steps.append((c, rng.integers(0, n, k).tolist()))
    return n, steps


@pytest.mark.parametrize("explore", [0, 1, 2])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_clustering_matches_reference(ref, seed, explore):
    rc = ref[1]
    n, steps = _history(seed)
    ours, theirs = tc.ClusterState.init(n), rc.ClusterState.init(n)
    for c, owners in steps:
        ours.update(c, owners)
        theirs.update(c, owners)
        assert ours.rounds == theirs.rounds
    np.testing.assert_array_equal(ours.select_counts, theirs.select_counts)
    for c in range(n):
        np.testing.assert_array_equal(ours.preferred_peers(c),
                                      theirs.preferred_peers(c))
    topo = tc.pruned_topology(ours, explore, seed=seed)
    assert topo == rc.pruned_topology(theirs, explore, seed=seed)
    assert tc.communication_volume(topo, 5, 2.5) == \
        rc.communication_volume(topo, 5, 2.5)
    assert tc.clustering_savings(ours, 5, 1.0, explore) == \
        rc.clustering_savings(theirs, 5, 1.0, explore)


# ---- the table scripts ---------------------------------------------------

@pytest.mark.parametrize("width", [8, 16])
@pytest.mark.parametrize("family", FAMILIES)
def test_table4_flops_match_reference(ref_tables, monkeypatch, family,
                                      width):
    import jax

    from repro.models.cnn import CNNConfig as JConfig
    table4 = ref_tables[2]
    init = table4.init_model

    def zeros_like_init(f, key, cfg):
        # the counter reads only shapes: trace the init (no compile, no
        # draws) and count on zeros of those shapes
        shapes = jax.eval_shape(lambda: init(f, key, cfg))
        return {k: np.zeros(s.shape, s.dtype) for k, s in shapes.items()}
    monkeypatch.setattr(table4, "init_model", zeros_like_init)
    want = table4.family_forward_flops(family,
                                       JConfig(n_classes=10, width=width))
    got = family_forward_flops(family, CNNConfig(n_classes=10, width=width))
    assert got == want


def test_table4_analytic_gflops_match_reference(ref_tables, monkeypatch):
    """Table IV at the paper's setting (20 clients, 60000 images, 5
    families, 60 epochs, NSGA-II 100 x 100, 400 rounds): both scripts'
    analytic GFLOPs, with the timed runs stubbed out."""
    import jax

    from repro_torch.benchmarks import table4_cost as t4
    table4 = ref_tables[2]
    init = table4.init_model
    monkeypatch.setattr(table4, "init_model", lambda f, key, cfg: {
        k: np.zeros(s.shape, s.dtype)
        for k, s in jax.eval_shape(lambda: init(f, key, cfg)).items()})
    for mod in (table4, t4):
        monkeypatch.setattr(mod, "run_local_ensemble",
                            lambda *a, **kw: (None, None, None))
        monkeypatch.setattr(mod, "run_fedpae", lambda *a, **kw: None)
        monkeypatch.setattr(mod, "BASELINES",
                            {"fedavg": lambda *a, **kw: None})
    theirs, ours = table4.main(full=True), t4.main(full=True, device="cpu")
    assert sorted(ours) == sorted(theirs)
    for k in ("fedpae_gflops", "round_gflops"):
        assert ours[k] == theirs[k], k


RESULTS = {  # a fixed grid: two Dir(0.1) cells and one Dir(0.5) cell
    "synthetic10|0.1|0": {"local": [0.5, 0.8, 0.0], "fedpae": [0.6, 0.8, 0.1],
                          "fedpae_local_frac": [0.4, 1.0, 0.2],
                          "fedavg": [0.3, 0.9, 0.2], "fml": [0.5, 0.7, 0.0]},
    "synthetic10|0.1|1": {"local": [0.4, 0.6], "fedpae": [0.4, 0.7],
                          "fedpae_local_frac": [0.8, 0.6],
                          "fedavg": [0.2, 0.65], "fml": [0.45, 0.6]},
    "synthetic10|0.5|0": {"local": [0.9], "fedpae": [0.1],
                          "fedavg": [0.0], "fml": [0.95]},
}


def test_negative_transfer_matches_reference(ref_tables):
    assert t2.negative_transfer(RESULTS) == \
        ref_tables[1].negative_transfer(RESULTS)


def _strict(path):
    def no_constant(tok):
        raise ValueError(f"non-strict JSON token {tok}")
    with open(path) as f:
        return json.load(f, parse_constant=no_constant)


def test_table1_grid_runs_at_smoke(ref_tables, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    pc = paper_cnn.smoke()
    results = t1.run_grid(pc=pc, alphas=(0.1,), rounds=2, device="cpu")
    assert t1.METHODS == ref_tables[0].METHODS
    assert list(results) == ["synthetic10|0.1|0"]
    cell = results["synthetic10|0.1|0"]
    assert sorted(cell) == sorted(t1.METHODS + ["fedpae_local_frac"])
    for m, accs in cell.items():
        a = np.asarray(accs)
        assert a.shape == (pc["n_clients"],) and np.isfinite(a).all(), m
        assert ((a >= 0) & (a <= 1)).all(), m
    assert _strict(tmp_path / "results/torch/table1.json") == results
    assert not (tmp_path / "results/table1.json").exists()
    t1.print_table(results)


def test_table2_main_runs_at_smoke(ref_tables, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "results/torch/table2.json"
    table = t2.main(["--json", str(out)], device="cpu",
                    pc=paper_cnn.smoke())
    assert list(table) == ["fedpae"]
    rows = _strict(out)
    assert [r["name"] for r in rows] == ["table2_fedpae",
                                         "table2_local_frac"]
    lo, hi = table["fedpae"]
    assert rows[0] == {"name": "table2_fedpae", "min_rel": round(lo, 4),
                       "max_rel": round(hi, 4)}


def test_table2_main_reads_the_ports_table1(ref_tables, tmp_path,
                                            monkeypatch, capsys):
    """With results/torch/table1.json present the script trains nothing:
    its rows are the reference's `negative_transfer` of that grid."""
    monkeypatch.chdir(tmp_path)
    os.makedirs("results/torch")
    with open("results/torch/table1.json", "w") as f:
        json.dump(RESULTS, f, allow_nan=False)
    with open("results/table1.json", "w") as f:   # the reference's: unread
        json.dump({}, f, allow_nan=False)
    table = t2.main(["--json", "rows.json"], device="cpu")
    assert table == ref_tables[1].negative_transfer(RESULTS)
    rows = _strict("rows.json")
    assert [r["name"] for r in rows] == [f"table2_{m}" for m in table] + [
        "table2_local_frac"]
    assert rows[-1]["mean"] == round(float(np.mean(
        [0.4, 1.0, 0.2, 0.8, 0.6])), 4)
    assert "fedavg" in capsys.readouterr().out


# ---- on the card -----------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(tb.BASELINES))
def test_cuda_baseline_matches_cpu(cuda, monkeypatch, name):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    seen = _recorded(monkeypatch, tb)
    fl = tb.FLConfig(rounds=2, local_steps=1, families=("cnn4", "vgg"),
                     width=8)
    card = tb.BASELINES[name](_clients(3), 6, fl, device="cuda")
    n = len(seen)
    cpu = tb.BASELINES[name](_clients(3), 6, fl, device="cpu")
    assert card.shape == cpu.shape == (3,)
    for a, b in zip(seen[:n], seen[n:]):
        assert float(np.abs(a - b).max()) <= PROB_ATOL
