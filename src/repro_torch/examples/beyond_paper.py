"""Beyond-paper extensions (the paper's own §VI/§VII future-work items;
port of `examples/beyond_paper.py`):

1. Clustered gossip — clients prune their exchange graph to historically
   selected peers (+1 explore), cutting communication volume while keeping
   FedPAE accuracy.
2. Dynamic per-sample ensemble selection (KNORA-style DES) on top of the
   same model bench, on the device (`core.dynamic.des_accuracy`).

The run is one synchronous selection (2 x 20 + 1 ensemble_fitness
launches on the card). `--json PATH` writes the printed figures as rows
(`fedpae`, `clustered_gossip`, `des`; the reference writes none).

    PYTHONPATH=src python -m repro_torch.examples.beyond_paper \
        [--smoke] [--json PATH] [--device cpu]
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from repro_torch.core.dynamic import des_accuracy
from repro_torch.fl.clustering import ClusterState, clustering_savings
from repro_torch.obs.metrics import json_ready
from repro_torch.sim import (DataSpec, Experiment, ExperimentSpec,
                             ScheduleSpec, SelectionSpec, TrainSpec)


def make_spec(smoke=False) -> ExperimentSpec:
    """The reference's spec (3000 images, Dirichlet(0.1), cnn4 + vgg +
    resnet at width 12, NSGA-II 32 x 20); `smoke` cuts it to 600 images
    of 8 x 8, 2 epochs at width 4, NSGA-II 16 x 5."""
    return ExperimentSpec(
        data=DataSpec(kind="synthetic_images", n_clients=6, n_classes=8,
                      n_samples=600 if smoke else 3000,
                      image_size=8 if smoke else 10, alpha=0.1),
        train=TrainSpec(families=("cnn4", "vgg", "resnet"),
                        max_epochs=2 if smoke else 10, patience=4,
                        width=4 if smoke else 12),
        selection=SelectionSpec(pop_size=16 if smoke else 32,
                                generations=5 if smoke else 20, k=3,
                                ensemble_k=3),
        schedule=ScheduleSpec(mode="sync"),
        seed=0)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="600 images, 2 epochs, NSGA-II 16 x 5")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="dump the printed figures as rows")
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args(argv)
    spec = make_spec(args.smoke)
    n_clients, ensemble_k = spec.data.n_clients, spec.selection.ensemble_k
    exp = Experiment.from_spec(spec, device=args.device)
    datasets = exp.build().datasets
    res = exp.run()
    print(f"FedPAE (full gossip): {res.test_acc.mean():.3f}")

    # --- 1. clustered gossip from selection history ---------------------
    st = ClusterState.init(n_clients)
    for c, chrom in enumerate(res.chromosomes):
        owners = res.stores[c].owners[chrom > 0.5]
        st.update(c, owners.tolist())
    sav = clustering_savings(st,
                             models_per_client=len(spec.train.families))
    print(f"clustered gossip: {sav:.0%} of exchange volume saved "
          f"(paper §VI proposal)")

    # --- 2. dynamic per-sample selection ---------------------------------
    dev = exp.device

    def on(a):
        return torch.as_tensor(np.asarray(a), device=dev)

    des, static = [], []
    for c, data in enumerate(datasets):
        bench = res.stores[c]
        pv = bench.val_predictions(data.x_va)
        pt = bench.predictions(data.x_te)
        d = float(des_accuracy(on(data.x_te), on(data.y_te),
                               on(data.x_va), on(data.y_va),
                               on(pv), on(pt), K=11, k=ensemble_k))
        des.append(d)
        static.append(res.test_acc[c])
    print(f"dynamic selection (DES): {np.mean(des):.3f} vs "
          f"static NSGA-II ensemble: {np.mean(static):.3f} (paper §VII)")
    rows = [dict(name="fedpae", acc=round(float(res.test_acc.mean()), 4)),
            dict(name="clustered_gossip", savings=round(float(sav), 4)),
            dict(name="des", acc=round(float(np.mean(des)), 4),
                 static_acc=round(float(np.mean(static)), 4))]
    if args.json:
        with open(args.json, "w") as f:
            json.dump(json_ready(rows), f, indent=2, allow_nan=False)
        print(f"wrote {len(rows)} rows to {args.json}")
    return rows


if __name__ == "__main__":
    main()
