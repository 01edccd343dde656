"""Paper Table II on the port: range of per-client relative accuracy change
vs the local-ensemble baseline under the highest heterogeneity Dir(0.1)
— the negative-transfer result (FedPAE's floor is the local ensemble;
pFL baselines can dip below it). Port of
`benchmarks/table2_negative_transfer.py`.

Runs on the declarative spec path: each (dataset, alpha, seed) cell is
one `ExperimentSpec`, the local baseline comes from the same
`Experiment`'s trained models (`local_ensemble()`), so baseline and
FedPAE share data, training, and seeds by construction. When
results/torch/table1.json exists (the port's Table I grid), its cells are
reused instead of re-training.

Usage:
    PYTHONPATH=src python -m repro_torch.benchmarks.table2_negative_transfer \
        [--full] [--json results/torch/table2.json] [--device cpu]

`--json` dumps machine-readable rows ({"name", "min_rel", "max_rel",
"local_frac"}) for CI gates.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np

from repro_torch.benchmarks.common import RESULTS
from repro_torch.configs.paper_cnn import config as paper_config
from repro_torch.sim import (DataSpec, Experiment, ExperimentSpec,
                             ScheduleSpec, SelectionSpec, TrainSpec)


def spec_for(n_classes: int, alpha: float, seed: int,
             pc: dict) -> ExperimentSpec:
    """One Table-II grid cell as a declarative spec (sync protocol —
    the paper's Table I/II setting)."""
    fp = pc["fedpae"]
    nsga = fp.nsga
    return ExperimentSpec(
        data=DataSpec(kind="synthetic_images", n_clients=pc["n_clients"],
                      n_classes=n_classes, n_samples=pc["n_samples"],
                      alpha=alpha),
        train=TrainSpec(families=tuple(fp.families), lr=fp.lr,
                        batch=fp.batch, max_epochs=fp.max_epochs,
                        patience=fp.patience, width=fp.width),
        selection=SelectionSpec(pop_size=nsga.pop_size,
                                generations=nsga.generations, k=nsga.k,
                                p_mut=nsga.p_mut, p_cross=nsga.p_cross,
                                ensemble_k=fp.ensemble_k),
        schedule=ScheduleSpec(mode="sync"),
        seed=seed)


def run_grid(full=False, alphas=(0.1,), seeds=(0,), device=None, pc=None):
    """Fresh spec-path grid: {key: {"local": [...], "fedpae": [...],
    "fedpae_local_frac": [...]}} — the same cell shape table1 writes, so
    `negative_transfer` consumes either source."""
    pc = pc or paper_config(full)
    results = {}
    for dname, n_classes in pc["datasets"].items():
        for alpha in alphas:
            for seed in seeds:
                key = f"{dname}|{alpha}|{seed}"
                exp = Experiment.from_spec(
                    spec_for(n_classes, alpha, seed, pc), device=device)
                local_acc = exp.local_ensemble()
                res = exp.run()
                results[key] = {
                    "local": local_acc.tolist(),
                    "fedpae": res.test_acc.tolist(),
                    "fedpae_local_frac": res.local_frac.tolist(),
                }
                print(f"[{key}] local={local_acc.mean():.3f} "
                      f"fedpae={res.test_acc.mean():.3f}", flush=True)
    return results


def negative_transfer(results):
    """{method: (min_rel, max_rel)} over every Dir(0.1) cell — the
    paper's headline: FedPAE's min_rel stays >= 0 (no negative
    transfer), rounds-based pFL baselines go negative."""
    out = {}
    for key, r in results.items():
        if "|0.1|" not in key:
            continue
        local = np.array(r["local"])
        for m, accs in r.items():
            if m == "local" or m.endswith("_local_frac"):
                continue
            rel = (np.array(accs) - local) / np.maximum(local, 1e-9)
            lo, hi = out.get(m, (np.inf, -np.inf))
            out[m] = (min(lo, float(rel.min())), max(hi, float(rel.max())))
    return out


def main(argv=None, device=None, pc=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="dump machine-readable rows for CI gates")
    ap.add_argument("--device", default=device,
                    help="'cpu' to run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    path = f"{RESULTS}/table1.json"
    if os.path.exists(path):
        with open(path) as f:
            results = json.load(f)
    else:
        results = run_grid(full=args.full, device=args.device, pc=pc)
    table = negative_transfer(results)
    fracs = [f for key, r in results.items() if "|0.1|" in key
             for f in r.get("fedpae_local_frac", [])]
    print("method,min_rel_change,max_rel_change")
    rows = []
    for m, (lo, hi) in table.items():
        print(f"{m},{lo:+.1%},{hi:+.1%}")
        rows.append({"name": f"table2_{m}", "min_rel": round(lo, 4),
                     "max_rel": round(hi, 4)})
    if fracs:
        rows.append({"name": "table2_local_frac",
                     "mean": round(float(np.mean(fracs)), 4)})
    if args.json:
        d = os.path.dirname(args.json)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=2, allow_nan=False)
        print(f"# wrote {len(rows)} rows to {args.json}")
    return table


if __name__ == "__main__":
    main()
