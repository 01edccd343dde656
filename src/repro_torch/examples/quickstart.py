"""Quickstart: FedPAE on a 5-client non-IID network (port of
`examples/quickstart.py`).

One declarative `ExperimentSpec` (repro_torch.sim) describes the whole
run — data partition, heterogeneous model families, NSGA-II selection
shape — and `Experiment.from_spec(spec).run()` executes it and returns a
structured `RunResult`: local training, the exchange of prediction
matrices, one batched selection (2 x 30 + 1 ensemble_fitness launches)
and serving. The paper's local-only baseline
(`Experiment.local_ensemble`) is printed beside it. `--json PATH` writes
the printed figures as rows (`local_ensemble`, `fedpae`; the reference
writes none).

    PYTHONPATH=src python -m repro_torch.examples.quickstart \
        [--smoke] [--json PATH] [--device cpu]
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from repro_torch.obs.metrics import json_ready
from repro_torch.sim import (DataSpec, Experiment, ExperimentSpec,
                             ScheduleSpec, SelectionSpec, TrainSpec)


def make_spec(smoke=False) -> ExperimentSpec:
    """The reference's spec (5 clients, Dirichlet(0.1) label skew, three
    heterogeneous families per client, NSGA-II 48 x 30); `smoke` cuts
    it to 3 clients of 600 images, 2 epochs at width 4, NSGA-II 16 x 5."""
    if smoke:
        return ExperimentSpec(
            data=DataSpec(kind="synthetic_images", n_clients=3,
                          n_classes=6, n_samples=600, image_size=8,
                          alpha=0.1),
            train=TrainSpec(families=("cnn4", "vgg", "resnet"),
                            max_epochs=2, patience=4, width=4),
            selection=SelectionSpec(pop_size=16, generations=5, k=3,
                                    ensemble_k=3),
            schedule=ScheduleSpec(mode="sync"),
            seed=0)
    # one spec = the whole scenario: 5 clients, Dirichlet(0.1) label
    # skew, three heterogeneous families per client, NSGA-II selection
    return ExperimentSpec(
        data=DataSpec(kind="synthetic_images", n_clients=5, n_classes=10,
                      n_samples=3000, image_size=10, alpha=0.1),
        train=TrainSpec(families=("cnn4", "vgg", "resnet"),
                        max_epochs=12, patience=4, width=12),
        selection=SelectionSpec(pop_size=48, generations=30, k=3,
                                ensemble_k=3),
        schedule=ScheduleSpec(mode="sync"),
        seed=0)


def make_rows(local_acc, res) -> list:
    return [dict(name="local_ensemble",
                 acc=round(float(local_acc.mean()), 4),
                 per_client=np.round(local_acc, 4).tolist()),
            dict(name="fedpae", acc=round(float(res.test_acc.mean()), 4),
                 local_frac=round(float(res.local_frac.mean()), 4),
                 per_client=np.round(res.test_acc, 4).tolist())]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="3 clients of 600 images, 2 epochs, NSGA-II 16 x 5")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="dump the printed figures as rows")
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args(argv)
    exp = Experiment.from_spec(make_spec(args.smoke), device=args.device)
    print("client train sizes:",
          [len(d.x_tr) for d in exp.build().datasets])

    local_acc = exp.local_ensemble()  # paper's local-only baseline
    res = exp.run()                   # trains, exchanges, selects, serves

    print(f"\nlocal-ensemble accuracy : {local_acc.mean():.3f}")
    print(f"FedPAE accuracy         : {res.test_acc.mean():.3f}")
    print(f"local models selected   : {res.local_frac.mean():.0%}")
    print("per-client accs         :", np.round(res.test_acc, 3))
    rows = make_rows(local_acc, res)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(json_ready(rows), f, indent=2, allow_nan=False)
        print(f"wrote {len(rows)} rows to {args.json}")
    return rows


if __name__ == "__main__":
    main()
