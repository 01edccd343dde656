"""Asynchronous decentralized FedPAE: heterogeneous client speeds, gossip
latency, ensemble re-selection on model arrival (virtual clock; port of
`examples/async_decentralized.py`).

The whole scenario is one declarative `ExperimentSpec` with
`schedule.mode="async"`: the schedule section carries the speed
heterogeneity and the train-cost model (a tagged registry component),
and `Experiment.run()` drives the event loop — every `recv` event
materializes the receiving client's prediction store, and every
debounced `select` tick re-runs batched NSGA-II selection for all ready
clients in one call (2 x 15 + 1 ensemble_fitness launches a batch that
ran a GA) — producing per-client validation accuracy over virtual time.
`--json PATH` writes one row a client (`client<c>`: its (t, val_acc)
series and final test accuracy) and a `fleet` row (the reference writes
none).

    PYTHONPATH=src python -m repro_torch.examples.async_decentralized \
        [--smoke] [--json PATH] [--device cpu]
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from repro_torch.obs.metrics import json_ready
from repro_torch.sim import (ComponentSpec, DataSpec, Experiment,
                             ExperimentSpec, ScheduleSpec, SelectionSpec,
                             TrainSpec)


def make_spec(smoke=False) -> ExperimentSpec:
    """The reference's spec (8 classes, 2500 images, cnn4 + vgg at width
    12, NSGA-II 32 x 15, speed sigma 0.8); `smoke` cuts it to 600 images
    of 8 x 8, 2 epochs at width 4, NSGA-II 16 x 5."""
    return ExperimentSpec(
        data=DataSpec(kind="synthetic_images", n_clients=5,
                      n_classes=8, n_samples=600 if smoke else 2500,
                      image_size=8 if smoke else 10, alpha=0.1),
        train=TrainSpec(families=("cnn4", "vgg"),
                        max_epochs=2 if smoke else 8, patience=3,
                        width=4 if smoke else 12),
        selection=SelectionSpec(pop_size=16 if smoke else 32,
                                generations=5 if smoke else 15, k=3,
                                ensemble_k=3),
        schedule=ScheduleSpec(
            mode="async", speed_lognorm_sigma=0.8,
            train_cost=ComponentSpec("affine",
                                     {"base": 1.0, "slope": 0.3})),
        seed=0)


def make_rows(res, n_clients) -> list:
    rows = [dict(name=f"client{c}",
                 selections=[[t, a] for t, a in res.selections[c]],
                 test_acc=round(float(res.test_acc[c]), 4))
            for c in range(n_clients)]
    rows.append(dict(name="fleet",
                     test_acc=round(float(res.test_acc.mean()), 4),
                     n_selections=sum(len(v)
                                      for v in res.selections.values()),
                     select_batches=len(res.select_batches)))
    return rows


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
    n_clients = spec.data.n_clients
    res = Experiment.from_spec(spec, device=args.device).run()

    print("virtual-time ensemble quality per client (t, val_acc):")
    for c in range(n_clients):
        series = " -> ".join(f"({t:.2f}, {a:.3f})"
                             for t, a in res.selections[c])
        print(f"  client {c}: {series}")
    print(f"\nfinal test accuracy per client: "
          f"{np.round(res.test_acc, 3).tolist()} "
          f"(mean {res.test_acc.mean():.3f})")
    # asynchrony: quality is non-decreasing as more peers arrive
    for c in range(n_clients):
        accs = [a for _, a in res.selections[c]]
        if len(accs) >= 2:
            assert accs[-1] >= accs[0] - 0.05, "quality degraded over time"
    print("\nOK: ensemble quality improves (or holds) as peer models arrive, "
          "with no global synchronization barrier.")
    rows = make_rows(res, n_clients)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(json_ready(rows), f, indent=2, allow_nan=False)
        print(f"wrote {len(rows)} rows to {args.json}")
    return rows


if __name__ == "__main__":
    main()
