"""Paper Table I on the port: mean test accuracy across clients, methods x
Dir(alpha) (port of `benchmarks/table1_accuracy.py`).

Usage: PYTHONPATH=src python -m repro_torch.benchmarks.table1_accuracy \
    [--full] [--alphas 0.1,0.3,0.5] [--rounds R] [--device cpu]
Writes results/torch/table1.json; prints the table.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np

from repro_torch.benchmarks.common import RESULTS, make_clients
from repro_torch.configs.paper_cnn import config as paper_config
from repro_torch.core.fedpae import run_fedpae, run_local_ensemble
from repro_torch.fl.baselines import BASELINES, FLConfig

METHODS = ["fedavg", "fedprox", "feddistill", "lg_fedavg", "fedkd", "fedgh",
           "fml", "local", "fedpae"]


def run_grid(full=False, alphas=None, rounds=None,
             out=f"{RESULTS}/table1.json", seeds=(0,), device=None, pc=None):
    """`pc` (default `configs.paper_cnn.config(full)`) sets the world, the
    local training and the selection; the baselines run `rounds` rounds
    (400 with `full`, else 60) of 2 local steps."""
    pc = pc or paper_config(full)
    alphas = alphas or pc["alphas"]
    results = {}
    for dname, n_classes in pc["datasets"].items():
        for alpha in alphas:
            for seed in seeds:
                key = f"{dname}|{alpha}|{seed}"
                results[key] = {}
                datasets, _ = make_clients(pc["n_clients"], alpha,
                                           pc["n_samples"], n_classes, seed=seed)
                fl = FLConfig(rounds=rounds or (400 if full else 60),
                              local_steps=2,
                              families=pc["fedpae"].families,
                              width=pc["fedpae"].width, seed=seed)
                local_acc, models, ccfg = run_local_ensemble(
                    datasets, n_classes, pc["fedpae"], device=device)
                results[key]["local"] = local_acc.tolist()
                res = run_fedpae(datasets, n_classes, pc["fedpae"],
                                 models=models, ccfg=ccfg, device=device)
                results[key]["fedpae"] = res.test_acc.tolist()
                results[key]["fedpae_local_frac"] = res.local_frac.tolist()
                for m in METHODS:
                    if m in ("local", "fedpae"):
                        continue
                    results[key][m] = BASELINES[m](
                        datasets, n_classes, fl, device=device).tolist()
                print(f"[{key}] " + " ".join(
                    f"{m}={np.mean(results[key][m]):.3f}"
                    for m in METHODS if m in results[key]), flush=True)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(results, f, indent=1, allow_nan=False)
    return results


def print_table(results):
    keys = sorted(results)
    print("\nmethod," + ",".join(keys))
    for m in METHODS:
        cells = []
        for k in keys:
            if m in results[k]:
                a = np.array(results[k][m])
                cells.append(f"{a.mean():.3f}±{1.96*a.std()/max(1,len(a))**0.5:.3f}")
            else:
                cells.append("-")
        print(f"{m}," + ",".join(cells))


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--alphas", default=None)
    ap.add_argument("--rounds", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU (default: the card)")
    a = ap.parse_args()
    alphas = tuple(float(x) for x in a.alphas.split(",")) if a.alphas else None
    print_table(run_grid(a.full, alphas, a.rounds, device=a.device))
