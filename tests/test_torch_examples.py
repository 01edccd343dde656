"""The port's example drivers (`repro_torch.examples`) against the
reference's (`examples/*.py`, imported by path).

Each driver's spec equals the reference driver's at the same arguments
(`to_dict()`; for the drivers whose reference builds its spec inside
`main`, the spec `main` hands to `Experiment.from_spec`). lossy_links'
dissemination run at 6 clients is exact (events, net, coverage, t_full,
wire bytes), and its `--json` rows at `--smoke` are the reference's
byte for byte. One byzantine arm and one serve-drift arm at 4 clients
give every count that no selection and no trained weight decides equal
to the reference's (whose GA a top-k stub answers and whose models are
the port's weights, to spare its compiles); the port's accuracies are
held by outcome (above chance, k members). The rows' names and keys are
the reference's (read from the reference's source). Everything runs on
the CPU at tiny sizes.
"""
from __future__ import annotations

import ast
import copy
import importlib.util
import json
import math
import os
import re
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.examples import (async_decentralized,  # noqa: E402
                                  beyond_paper, byzantine_peers,
                                  gossip_churn, lossy_links, pareto_front,
                                  quickstart, serve_drift)
from repro_torch.sim import Experiment, ExperimentSpec  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = {"lossy_links": lossy_links, "quickstart": quickstart,
        "async_decentralized": async_decentralized,
        "gossip_churn": gossip_churn, "pareto_front": pareto_front,
        "beyond_paper": beyond_paper, "byzantine_peers": byzantine_peers,
        "serve_drift": serve_drift}


from _torch_threads import one_thread as _one_thread  # noqa: E402,F401


def _load_ref(name):
    path = os.path.join(REPO, "examples", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_ref_example_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ref():
    """The reference drivers (they need JAX), by file name."""
    pytest.importorskip("jax")
    return {name: _load_ref(name) for name in PORT}


# ---- the specs ----------------------------------------------------------

MAKE_SPEC = [
    ("lossy_links", (24, 2, 0.1, True), {}),
    ("lossy_links", (8, 2, 0.3, False), {"seed": 3}),
    ("gossip_churn", (64, 2, 16), {}),
    ("gossip_churn", (16, 2, 8), {"pop": 16, "gens": 5, "k": 3}),
    ("gossip_churn", (64, 2, 16), {"size_mode": "checkpoint"}),
    ("gossip_churn", (10, 3, 5), {"seed": 2, "world_seed": 4,
                                  "drop": 0.2}),
    ("byzantine_peers", (10, 6000, 0.3, True), {}),
    ("byzantine_peers", (6, 3600, 0.0, False), {}),
    ("byzantine_peers", (4, 800, 0.1, True), {"seed": 1}),
    ("serve_drift", (10, True, 0.12, 9.5, 14.5), {}),
    ("serve_drift", (6, False, 0.05, 9.5, 14.0), {"seed": 2}),
]


@pytest.mark.parametrize("name,args,kw", MAKE_SPEC,
                         ids=[f"{n}-{i}" for i, (n, _, _) in
                              enumerate(MAKE_SPEC)])
def test_make_spec_equals_reference(ref, name, args, kw):
    want = ref[name].make_spec(*args, **kw).to_dict()
    got = PORT[name].make_spec(*args, **kw).to_dict()
    assert got == want
    assert ExperimentSpec.from_dict(got).to_dict() == got


class _Captured(Exception):
    pass


@pytest.mark.parametrize("name", ["quickstart", "async_decentralized",
                                  "pareto_front", "beyond_paper"])
def test_inline_spec_equals_reference(ref, monkeypatch, name):
    """These reference drivers build their spec inside `main`: the spec
    they hand to `Experiment.from_spec` is the port's `make_spec()`."""
    seen = []

    class Capture:
        @classmethod
        def from_spec(cls, spec):
            seen.append(spec)
            raise _Captured

    monkeypatch.setattr(ref[name], "Experiment", Capture)
    with pytest.raises(_Captured):
        ref[name].main()
    (spec,) = seen
    assert PORT[name].make_spec().to_dict() == spec.to_dict()


def test_gossip_spec_of_chip_smoke_is_the_drivers():
    """chip_smoke's configuration 9 is gossip_churn's make_spec at full
    size, its obs section replaced."""
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    g = chip_smoke.GOSSIP
    obs = {"enabled": True, "trace": True}
    want = gossip_churn.make_spec(g["n"], g["mpc"], g["capacity"]).to_dict()
    want["obs"] = ExperimentSpec.from_dict({"obs": obs}).to_dict()["obs"]
    assert chip_smoke.gossip_spec(g["capacity"], obs).to_dict() == want


# ---- lossy_links: exact -------------------------------------------------

def _same_float(a, b):
    return (a == b) or (isinstance(a, float) and isinstance(b, float)
                        and math.isnan(a) and math.isnan(b))


def test_lossy_links_run_once_exact(ref):
    r_res, r_st = ref["lossy_links"].run_once(6, 2, 0.1, True)
    t_res, t_st = lossy_links.run_once(6, 2, 0.1, True, device="cpu")
    assert t_res.trace.events == r_res.trace.events
    assert t_res.net == r_res.net
    assert t_res.coverage == r_res.coverage
    assert _same_float(t_res.t_full, r_res.t_full)
    for k in ("bytes_sent", "bytes_rejected", "dropped", "repair"):
        assert t_st[k] == r_st[k], k


def test_lossy_links_main_rows_equal_reference(ref, tmp_path, monkeypatch,
                                               capsys):
    want, got = tmp_path / "ref.json", tmp_path / "port.json"
    monkeypatch.setattr(sys, "argv", ["lossy_links.py", "--smoke",
                                      "--json", str(want)])
    ref["lossy_links"].main()
    rows = lossy_links.main(["--smoke", "--json", str(got),
                             "--device", "cpu"])
    assert got.read_text() == want.read_text()
    assert json.loads(got.read_text()) == rows
    out = capsys.readouterr().out
    assert "OK: anti-entropy repair" in out


# ---- the rows' names and keys -------------------------------------------

def _row_templates(path):
    """(name regex, keyword names) of every `dict(name=..., ...)` in a
    driver's source, in order."""
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read())
    out = []
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id == "dict" and node.keywords
                and node.keywords[0].arg == "name"):
            continue
        v = node.keywords[0].value
        if isinstance(v, ast.JoinedStr):
            pat = "".join(re.escape(p.value) if isinstance(p, ast.Constant)
                          else ".+" for p in v.values)
        else:
            pat = re.escape(v.value)
        out.append((pat, tuple(k.arg for k in node.keywords)))
    return sorted(out)


@pytest.mark.parametrize("name", ["lossy_links", "byzantine_peers",
                                  "serve_drift"])
def test_row_templates_equal_reference(name):
    want = _row_templates(os.path.join(REPO, "examples", f"{name}.py"))
    got = _row_templates(PORT[name].__file__)
    assert got == want


def _matches(rows, templates):
    for row in rows:
        hits = [keys for pat, keys in templates
                if re.fullmatch(pat, row["name"])]
        assert tuple(row) in hits, (row, templates)


def test_row_builders_give_reference_rows():
    ref_dir = os.path.join(REPO, "examples")
    adm = {"n_rejected": 3, "n_admitted": 5, "n_quarantined": 1}
    rows = byzantine_peers.arm_rows(0.3, 0.81, 0.8, 0.4, adm)
    assert [r["name"] for r in rows] == ["byz30_gated", "byz30_ungated",
                                         "byz30_allpeers"]
    _matches(rows, _row_templates(os.path.join(ref_dir,
                                               "byzantine_peers.py")))
    sv = {"n_reselections": 2, "regret": 0.5, "n_queries": 10,
          "latency_p50": 0.1, "latency_p99": 0.2}
    curve = [dict(name="curve_thr12", threshold=0.12, reselections=2,
                  regret=0.5, post_acc=0.7)]
    rows = serve_drift.make_rows(0.8, 0.75, sv, 0.8, 0.5,
                                 dict(sv, n_reselections=0), True, curve)
    assert [r["name"] for r in rows] == ["serve_monitored", "serve_frozen",
                                         "determinism", "curve_thr12"]
    _matches(rows, _row_templates(os.path.join(ref_dir, "serve_drift.py")))
    st = {"coverage": 1.0, "t_full": float("nan"), "bytes_sent": 10,
          "dropped": 0, "repair": None}
    rows = [lossy_links.make_row(0.1, "off", st)]
    assert rows[0]["name"] == "repair_drop10_off"
    assert rows[0]["us_per_call"] == 0.0
    _matches(rows, _row_templates(os.path.join(ref_dir, "lossy_links.py")))


# ---- one byzantine arm, one serve-drift arm at 4 clients ---------------
#
# The counts compared below are decided by no selection (the event trace,
# the net counters, the bench sizes and select ticks; the serve counters
# but the window accuracy): the schedule never depends on what a GA
# picks. So the reference runs them with its GA replaced by a top-k stub,
# which spares the GA's compiles (tens of seconds on one core); the
# port's run keeps its real GA, whose outcome is held by outcome.


def _stub_ga(acc, S, preds, labels, nsga, use_kernel=False, keys=None,
             model_mask=None):
    """The reference engine's GA call answered by the k most accurate
    present members (the result keys its callers read)."""
    acc = np.asarray(acc)
    mask = np.asarray(model_mask) > 0.5
    N, M = acc.shape
    top = np.argsort(-np.where(mask, acc, -np.inf), axis=1,
                     kind="stable")[:, :nsga.k]
    chrom = np.zeros((N, M), np.float32)
    np.put_along_axis(chrom, top, 1.0, axis=1)
    chrom *= mask
    P = nsga.pop_size
    return {"chromosome": chrom,
            "val_accuracy": (acc * chrom).sum(1) / np.maximum(
                chrom.sum(1), 1),
            "member_acc": acc, "pareto_mask": np.ones((N, P), bool),
            "pop": np.repeat(chrom[:, None], P, 1),
            "objs": np.zeros((N, P, 2), np.float32)}


@pytest.fixture
def stub_ref_ga(ref, monkeypatch):
    from repro.core import engine
    monkeypatch.setattr(engine, "select_ensembles_from_stats", _stub_ga)


# cut from 15 epochs at width 16 and NSGA-II 24 x 10
BYZ_CUT = {"train": {"max_epochs": 2, "width": 8},
           "selection": {"pop_size": 8, "generations": 2}}


def _byz_spec(cls, frac, gated):
    d = byzantine_peers.make_spec(4, 800, frac, gated).to_dict()
    for section, v in BYZ_CUT.items():
        d[section].update(v)
    return cls.from_dict(copy.deepcopy(d))


def _jax_models(models):
    """The port's trained models in the reference's format (numpy, HWIO
    conv weights): the ungated arm's counts depend on no weight, and this
    spares the reference's training compiles."""
    return {key: ({n: (p.detach().permute(2, 3, 1, 0) if p.dim() == 4
                       else p.detach()).numpy()
                   for n, p in model.named_parameters()}, va)
            for key, (model, va) in models.items()}


def test_byzantine_arm_counts_equal_reference(ref, stub_ref_ga):
    from repro.models.cnn import CNNConfig as JCNNConfig
    from repro.sim import Experiment as JExperiment
    from repro.sim import ExperimentSpec as JSpec
    pbase = Experiment(_byz_spec(ExperimentSpec, 0.0, False), device="cpu")
    pbase._ensure_models()
    p_shared = dict(datasets=pbase.datasets, models=pbase.models,
                    ccfg=pbase.ccfg)
    jbase = JExperiment(_byz_spec(JSpec, 0.0, False))
    jbase._ensure_world()
    c = pbase.ccfg
    r_shared = dict(datasets=jbase.datasets,
                    models=_jax_models(pbase.models),
                    ccfg=JCNNConfig(n_classes=c.n_classes, width=c.width,
                                    in_channels=c.in_channels))
    for a, b in zip(r_shared["datasets"], p_shared["datasets"]):
        np.testing.assert_array_equal(a.x_te, b.x_te)
        np.testing.assert_array_equal(a.y_va, b.y_va)
    r_exp, r_res, r_honest, _ = ref["byzantine_peers"].run_arm(
        _byz_spec(JSpec, 0.3, False), r_shared)
    p_exp, p_res, p_honest, p_acc = byzantine_peers.run_arm(
        _byz_spec(ExperimentSpec, 0.3, False), p_shared, device="cpu")
    assert p_exp.faults.byzantine.clients == r_exp.faults.byzantine.clients
    assert p_honest == r_honest and len(p_honest) < 4
    for f in ("events", "net", "bench_sizes", "select_batches"):
        assert getattr(p_res.trace, f) == getattr(r_res.trace, f), f
    assert p_res.coverage == r_res.coverage
    assert p_res.net["faults"]["n_byzantine_poisoned"] > 0
    # by outcome: above chance, k members wherever a GA ran
    assert 1 / 8 < p_acc <= 1.0
    k = p_res.spec.selection.k
    for c in p_honest:
        chrom = p_res.engine.results[c]["chromosome"]
        assert int(np.asarray(chrom).sum()) == k
    # the all-peers vote depends on no GA pick: both sides hold the same
    # weights, so each honest store's summed poisoned and honest outputs
    # (the stores' wrapped predict) and the vote's accuracy must agree
    for c in p_honest:
        r_store, p_store = r_res.stores[c], p_res.stores[c]
        np.testing.assert_array_equal(p_store.mask, r_store.mask)
        x_te = p_shared["datasets"][c].x_te
        np.testing.assert_allclose(
            p_store.predictions(x_te, mask=p_store.mask).sum(0),
            r_store.predictions(x_te, mask=r_store.mask).sum(0),
            rtol=0, atol=1e-5, err_msg=f"client {c}")
    ap = byzantine_peers.allpeers_acc(p_res, p_shared["datasets"],
                                      p_honest)
    r_ap = ref["byzantine_peers"].allpeers_acc(r_res, r_shared["datasets"],
                                               r_honest)
    n_te = min(len(p_shared["datasets"][c].y_te) for c in p_honest)
    assert abs(ap - r_ap) <= 1 / n_te, (ap, r_ap)


def test_serve_drift_frozen_arm_counts_equal_reference(ref, stub_ref_ga):
    args = (4, False, 0.12, 9.5, 14.0)
    r_res, _, _ = ref["serve_drift"].run_arm(*args)
    p_res, p_pre, p_post = serve_drift.run_arm(*args, device="cpu")
    for f in ("events", "bench_sizes", "select_batches"):
        assert getattr(p_res.trace, f) == getattr(r_res.trace, f), f
    r_net, p_net = copy.deepcopy(r_res.net), copy.deepcopy(p_res.net)
    # the window accuracy is the one figure a GA's pick decides
    r_net["serve"].pop("window_acc")
    p_net["serve"].pop("window_acc")
    assert p_net == r_net
    assert p_res.net["serve"]["n_reselections"] == 0
    assert p_res.net["serve"]["n_drift_events"] == 1
    for v in (p_pre, p_post):
        assert 1 / 8 < v <= 1.0
    k = p_res.spec.selection.k
    for c, res in p_res.engine.results.items():
        assert int(np.asarray(res["chromosome"]).sum()) == k, c
