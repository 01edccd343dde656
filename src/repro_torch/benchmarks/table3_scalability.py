"""Paper Table III on the port: scalability — accuracy at an increased
client count with the total data held constant (less data per client).
Port of `benchmarks/table3_scalability.py`.

Usage: PYTHONPATH=src python -m repro_torch.benchmarks.table3_scalability \
    [--full] [--scale 2] [--device cpu]
Writes results/torch/table3.json.
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


def main(full=False, scale=2, out=f"{RESULTS}/table3.json", device=None,
         pc=None):
    pc = pc or paper_config(full)
    n_clients = pc["n_clients"] * scale  # e.g. 20 -> 50-ish in the paper
    n_classes = list(pc["datasets"].values())[0]
    datasets, _ = make_clients(n_clients, 0.1, pc["n_samples"], n_classes, seed=0)
    fl = FLConfig(rounds=400 if full else 60, local_steps=2,
                  families=pc["fedpae"].families, width=pc["fedpae"].width)
    results = {}
    local_acc, models, ccfg = run_local_ensemble(datasets, n_classes,
                                                 pc["fedpae"], device=device)
    results["local"] = local_acc.tolist()
    res = run_fedpae(datasets, n_classes, pc["fedpae"], models=models,
                     ccfg=ccfg, device=device)
    results["fedpae"] = res.test_acc.tolist()
    for m in ("fedavg", "feddistill", "lg_fedavg", "fedkd", "fml", "fedgh"):
        results[m] = BASELINES[m](datasets, n_classes, fl,
                                  device=device).tolist()
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(results, f, indent=1, allow_nan=False)
    print(f"clients={n_clients}")
    print("method,mean_acc,std")
    for m, a in results.items():
        a = np.array(a)
        print(f"{m},{a.mean():.3f},{a.std():.3f}")
    return results


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--scale", type=int, default=2)
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU (default: the card)")
    a = ap.parse_args()
    main(a.full, a.scale, device=a.device)
