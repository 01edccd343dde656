"""Paper Fig. 3: the strength/diversity Pareto front for one client
(port of `examples/pareto_front.py`).

Uses `Experiment.build()` — the spec layer's construction-without-run
path: the declarative spec materializes datasets, trained models, and
filled prediction stores, and this script then drives a single client's
NSGA-II selection itself (`core.selection.select_ensemble`, whose
objectives run through the single-client ensemble_fitness entry: 2 x 40
+ 1 launches on the card) to inspect the full population. `--json PATH`
writes one row (`pareto_client0`; the reference writes none).

    PYTHONPATH=src python -m repro_torch.examples.pareto_front \
        [--smoke] [--json PATH] [--device cpu]
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from repro_torch.core.selection import select_ensemble
from repro_torch.obs.metrics import json_ready
from repro_torch.sim import (DataSpec, Experiment, ExperimentSpec,
                             ScheduleSpec, SelectionSpec, TrainSpec)


def ascii_scatter(xs, ys, sel_idx, width=60, height=18):
    xs, ys = np.asarray(xs), np.asarray(ys)
    lo_x, hi_x = xs.min(), xs.max() + 1e-9
    lo_y, hi_y = ys.min(), ys.max() + 1e-9
    grid = [[" "] * width for _ in range(height)]
    for i, (x, y) in enumerate(zip(xs, ys)):
        cx = int((x - lo_x) / (hi_x - lo_x) * (width - 1))
        cy = height - 1 - int((y - lo_y) / (hi_y - lo_y) * (height - 1))
        grid[cy][cx] = "*" if i == sel_idx else "o"
    print(f"diversity ^   (selected ensemble = *)  strength range "
          f"[{lo_x:.3f}, {hi_x:.3f}]")
    for r in grid:
        print("".join(r))


def make_spec(smoke=False) -> ExperimentSpec:
    """The reference's spec (4 clients, Dirichlet(0.3), cnn4 + vgg at
    width 12, NSGA-II 64 x 40); `smoke` cuts it to 600 images of 8 x 8,
    2 epochs at width 4, NSGA-II 16 x 5."""
    return ExperimentSpec(
        data=DataSpec(kind="synthetic_images", n_clients=4, n_classes=8,
                      n_samples=600 if smoke else 2000,
                      image_size=8 if smoke else 10, alpha=0.3),
        train=TrainSpec(families=("cnn4", "vgg"),
                        max_epochs=2 if smoke else 8, patience=3,
                        width=4 if smoke else 12),
        selection=SelectionSpec(pop_size=16 if smoke else 64,
                                generations=5 if smoke else 40, k=3,
                                ensemble_k=3),
        schedule=ScheduleSpec(mode="sync"),
        seed=0)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="600 images, 2 epochs, NSGA-II 16 x 5")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="dump the printed figures as a row")
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args(argv)
    exp = Experiment.from_spec(make_spec(args.smoke),
                               device=args.device).build()  # train, exchange
    c = 0
    # the store already holds the padded (M, V_pad, C) selection-ready tensor
    pv, yv, mask = exp.stores[c].padded()
    dev = exp.device
    sel = select_ensemble(torch.as_tensor(pv, device=dev),
                          torch.as_tensor(yv, device=dev),
                          exp.engine.nsga,
                          model_mask=torch.as_tensor(
                              mask, dtype=torch.float32, device=dev))
    objs = sel["objs"].cpu().numpy()
    pareto = sel["pareto_mask"].cpu().numpy()
    pop = sel["pop"].cpu().numpy()
    chrom = sel["chromosome"].cpu().numpy()
    sel_idx = int(np.where((pop[pareto] == chrom).all(axis=1))[0][0]) \
        if (pop[pareto] == chrom).all(axis=1).any() else 0
    print(f"client {c}: {pareto.sum()} Pareto-optimal ensembles "
          f"out of population {len(pop)}")
    ascii_scatter(objs[pareto, 0], objs[pareto, 1], sel_idx)
    members = np.where(chrom > 0.5)[0].tolist()
    val_acc = float(sel["val_accuracy"])
    print(f"\nselected members: {members} (val acc {val_acc:.3f})")
    rows = [dict(name=f"pareto_client{c}", n_pareto=int(pareto.sum()),
                 pop=len(pop), members=members, val_acc=round(val_acc, 4),
                 front=objs[pareto].round(4).tolist())]
    if args.json:
        with open(args.json, "w") as f:
            json.dump(json_ready(rows), f, indent=2, allow_nan=False)
        print(f"wrote {len(rows)} rows to {args.json}")
    return rows


if __name__ == "__main__":
    main()
