"""The whole synchronous slice of the port against the JAX reference at a
tiny size: 3 clients, families (cnn4, resnet), width 8, 600 images of
8x8, NSGA-II population 16 over 5 generations, k = 2.

Both packages get the same datasets and the same models (trained in JAX
for one epoch and carried across with `params_from_jax`). Store
predictions agree to atol 1e-4; selection is compared by outcome (the
random streams differ by design); serving the same fixed chromosomes
gives the same votes to atol 1e-5.
"""
import copy
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.core.fedpae import train_all_clients  # noqa: E402
from repro.sim import Experiment as JExperiment  # noqa: E402
from repro.sim import fedpae_config as jfedpae_config  # noqa: E402
from repro.sim.build import build_client_datasets as jdatasets  # noqa: E402
from repro_torch.fl.client import ClientData  # noqa: E402
from repro_torch.models.cnn import CNNConfig, params_from_jax  # noqa: E402
from repro_torch.sim import Experiment, ExperimentSpec  # noqa: E402
from repro_torch.sim.build import build_client_datasets as tdatasets  # noqa: E402

K = 2
# the fleet-mean validation accuracy of the two packages' winners may
# differ by this much: the GA's random streams differ by design
VAL_ACC_BAND = 0.1
SPEC = {
    "data": {"kind": "synthetic_images", "n_clients": 3, "n_classes": 10,
             "n_samples": 600, "image_size": 8, "alpha": 0.1},
    "train": {"families": ["cnn4", "resnet"], "max_epochs": 1,
              "patience": 2, "width": 8},
    "selection": {"pop_size": 16, "generations": 5, "k": K,
                  "ensemble_k": K, "use_kernel": True},
    "schedule": {"mode": "sync"},
    "seed": 0,
}
REPO = os.path.join(os.path.dirname(__file__), "..")


@pytest.fixture(scope="module")
def runs():
    spec = ExperimentSpec.from_dict(copy.deepcopy(SPEC))
    from repro.sim import ExperimentSpec as JSpec
    jspec = JSpec.from_dict(copy.deepcopy(SPEC))
    jds = jdatasets(jspec.data, jspec.seed)
    jmodels, jccfg = train_all_clients(jds, jfedpae_config(jspec), 10)
    tds = [ClientData(*(np.array(getattr(d, f)) for f in
                        ("x_tr", "y_tr", "x_va", "y_va", "x_te", "y_te")))
           for d in jds]
    tmodels = {key: (params_from_jax(key[1], {n: np.asarray(v) for n, v
                                              in params.items()}), va)
               for key, (params, va) in jmodels.items()}
    tccfg = CNNConfig(n_classes=10, width=8, in_channels=3)
    jres = JExperiment(jspec, datasets=jds, models=jmodels,
                       ccfg=jccfg).run()
    tres = Experiment(spec, datasets=tds, models=tmodels, ccfg=tccfg,
                      device="cpu").run()
    return spec, jres, tres, tds


def test_datasets_equal_reference():
    spec = ExperimentSpec.from_dict(copy.deepcopy(SPEC))
    for t, j in zip(tdatasets(spec.data, spec.seed),
                    jdatasets(spec.data, spec.seed)):
        for f in ("x_tr", "y_tr", "x_va", "y_va", "x_te", "y_te"):
            np.testing.assert_array_equal(getattr(t, f), getattr(j, f))


def test_store_predictions_match(runs):
    _, jres, tres, _ = runs
    for ts, js in zip(tres.stores, jres.stores):
        np.testing.assert_array_equal(ts.mask, js.mask)
        np.testing.assert_array_equal(ts.labels, js.labels)
        np.testing.assert_allclose(ts.preds, js.preds, atol=1e-4)


def test_selection_outcome(runs):
    _, jres, tres, _ = runs
    for c, store in enumerate(tres.stores):
        res = tres.engine.results[c]
        chrom = res["chromosome"]
        assert chrom.sum() == K and store.mask[chrom > 0.5].all()
        row = np.flatnonzero((res["pop"] == chrom).all(-1))
        assert res["pareto_mask"][row].all()     # winner is on its front
    tval = np.mean([r["val_accuracy"] for r in tres.engine.results.values()])
    jval = np.mean([float(r["val_accuracy"])
                    for r in jres.engine.results.values()])
    assert abs(tval - jval) <= VAL_ACC_BAND, (tval, jval)
    assert np.isfinite(tres.test_acc).all() and tres.test_acc.shape == (3,)


def test_serving_fixed_chromosomes_gives_same_votes(runs):
    _, jres, tres, tds = runs
    for c, d in enumerate(tds):
        jchrom = np.asarray(jres.engine.chromosome(c))
        tres.engine.results[c] = {
            "chromosome": jchrom,
            "slot_gen": tres.stores[c].slot_gen.copy()}
        tvote, tchrom = tres.engine.serve(c, d.x_te)
        jvote, _ = jres.engine.serve(c, d.x_te)
        np.testing.assert_array_equal(tchrom, jchrom)
        np.testing.assert_allclose(tvote, np.asarray(jvote), atol=1e-5)


def test_spec_runs_through_cli(tmp_path):
    path = tmp_path / "spec.json"
    path.write_text(json.dumps(SPEC, allow_nan=False))
    out = tmp_path / "summary.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.sim.run", "--spec", str(path),
         "--device", "cpu", "--json-out", str(out)],
        capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    summary = json.loads(out.read_text())
    assert summary["mode"] == "sync" and len(summary["test_acc"]) == 3
    assert set(summary["perf"]) == {"train_s", "exchange_s", "select_s",
                                    "serve_s"}


def test_restack_path_runs_the_slice(runs):
    """selection.device_resident=False: the same slice on the restack path
    (a host restack and fresh statistics every select, no device mirror)
    picks the resident run's chromosomes and serves its test accuracy."""
    _, _, tres, tds = runs
    spec = ExperimentSpec.from_dict(
        {**SPEC, "selection": {**SPEC["selection"],
                               "device_resident": False}})
    res = Experiment(spec, datasets=tds, models=tres.models,
                     ccfg=CNNConfig(n_classes=10, width=8, in_channels=3),
                     device="cpu").run()
    assert res.engine.store_batch is None
    for a, b in zip(res.chromosomes, tres.chromosomes):
        assert a.sum() == K
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(res.test_acc, tres.test_acc)


def test_compiled_backend_runs_fleet_sweep_through_cli(tmp_path):
    """schedule.backend="compiled" through the port's CLI on the repo's
    fleet spec at its smoke size, on the CPU."""
    out = tmp_path / "summary.json"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.sim.run", "--spec",
         os.path.join(REPO, "examples", "specs", "fleet_sweep.json"),
         "--smoke", "--device", "cpu", "--json-out", str(out)],
        capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
                 OMP_NUM_THREADS="1"),
        timeout=300)
    assert proc.returncode == 0, proc.stderr
    summary = json.loads(out.read_text())
    assert summary["coverage"] == 1.0 and summary["n_clients"] == 256
    assert summary["perf"]["backend"] == "compiled"
