"""64-client decentralized FedPAE over a LOSSY gossip network with churn
(port of `examples/gossip_churn.py`).

A small-world overlay, per-edge latency + bandwidth with 10% message
drops and bounded inboxes, epidemic push gossip with version-vector
dedupe, lognormal availability with permanent dropouts, and
capacity-bounded STREAMING prediction stores whose contribution-aware
eviction keeps each client's bench at 16 slots while ~128 models churn
through the network (DESIGN.md §6). Each configuration is ONE
declarative `ExperimentSpec`; the world is `data.kind="prediction_world"`
(per-client labels plus quality-parameterized prediction matrices, no
CNN training), and every select tick that runs a GA launches
ensemble_fitness 2 x 8 + 1 times.

It reports the two claims the subsystem exists to quantify:
  1. bounded stores at capacity 16 stay within 2 points of unbounded
     stores' final validation accuracy;
  2. exchanging (V, C) prediction matrices (§III-A) is >= 10x cheaper in
     bytes-on-wire than exchanging checkpoints.
And it traces mean val-acc against cumulative bytes on the wire
(`results/torch/gossip_churn.png` when matplotlib is available, else the
curves as `gossip_churn_curves.json` / `.csv` there). `--json PATH`
writes one row a run (`bounded`, `unbounded`, `checkpoint`; the
reference writes none).

    PYTHONPATH=src python -m repro_torch.examples.gossip_churn \
        [--smoke] [--json PATH] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np

from repro_torch.obs.metrics import json_ready
from repro_torch.sim import (ComponentSpec, DataSpec, Experiment,
                             ExperimentSpec, NetworkSpec, ObsSpec,
                             ScheduleSpec, SelectionSpec)

V, C = 128, 8
# Checkpoint-exchange baseline: parameter count of the paper's smallest
# CNN family at width 16 (conv stack + head), order-of-magnitude honest.
CKPT_PARAMS = 250_000
OUT_DIR = os.path.join("results", "torch")


def make_spec(n, mpc, capacity, *, seed=0, world_seed=17, drop=0.1,
              size_mode="prediction", pop=24, gens=8, k=5):
    """One full gossip+churn scenario as a serializable spec."""
    # dict form (not a ComponentSpec instance) so the spec's
    # from_dict(to_dict()) round-trip identity holds for this spec too
    sizer = ({"name": "prediction_matrix",
              "params": {"n_val": V, "n_classes": C}}
             if size_mode == "prediction"
             else {"name": "checkpoint",
                   "params": {"n_params": CKPT_PARAMS}})
    return ExperimentSpec(
        data=DataSpec(kind="prediction_world", n_clients=n, n_classes=C,
                      n_val=V, models_per_client=mpc, seed=world_seed),
        selection=SelectionSpec(pop_size=pop, generations=gens, k=k,
                                store_capacity=capacity),
        network=NetworkSpec(
            topology="small_world", topology_k=4,
            transport=ComponentSpec("gossip", {
                "base_latency": 0.05, "jitter": 1.0, "bandwidth": 50e6,
                "drop_prob": drop, "inbox_capacity": 64, "sizer": sizer}),
            gossip="push",
            churn=ComponentSpec("lognormal", {"availability_beta": 0.1,
                                              "leave_prob": 0.05})),
        schedule=ScheduleSpec(
            mode="async", select_debounce=0.5,
            train_cost=ComponentSpec("affine",
                                     {"base": 1.0, "slope": 0.2})),
        # metrics on (no trace): the runs below report from the typed
        # metrics frame in addition to the raw net counters
        obs=ObsSpec(enabled=True),
        seed=seed)


def write_curves(runs, n):
    """The val-acc vs bytes-on-wire figure under OUT_DIR, or its data
    when matplotlib is absent."""
    os.makedirs(OUT_DIR, exist_ok=True)
    title = f"FedPAE gossip, {n} clients, 10% drop, churn"
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, ax = plt.subplots(figsize=(6, 4))
        for name, style in (("bounded", "-"), ("unbounded", "--")):
            xs = [b / 1e6 for b, _ in runs[name]["curve"]]
            ys = [a for _, a in runs[name]["curve"]]
            ax.plot(xs, ys, style, label=f"{name} store")
        ax.set_xlabel("cumulative bytes on wire (MB)")
        ax.set_ylabel("mean validation accuracy")
        ax.set_title(title)
        ax.legend()
        fig.tight_layout()
        path = os.path.join(OUT_DIR, "gossip_churn.png")
        fig.savefig(path, dpi=120)
        plt.close(fig)
        print(f"\nwrote {path}")
    except ImportError:
        # headless/minimal environments still get the figure's DATA:
        # the same curves as JSON (+ a flat CSV) instead of pixels
        import csv
        payload = {
            "title": title,
            "x": "cumulative bytes on wire (MB)",
            "y": "mean validation accuracy",
            "curves": {name: [[b / 1e6, a] for b, a in runs[name]["curve"]]
                       for name in ("bounded", "unbounded")},
            # the full typed metrics frames ride along, so the headless
            # artifact carries everything the obs layer collected
            "metrics": {name: runs[name]["metrics"].to_dict()
                        for name in ("bounded", "unbounded")}}
        base = os.path.join(OUT_DIR, "gossip_churn_curves")
        with open(base + ".json", "w") as f:
            json.dump(json_ready(payload), f, indent=2, allow_nan=False)
        with open(base + ".csv", "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["store", "mb_on_wire", "mean_val_acc"])
            for name, curve in payload["curves"].items():
                w.writerows([name, f"{b:.4f}", f"{a:.4f}"]
                            for b, a in curve)
        print(f"\n(matplotlib unavailable — wrote {base}.json/.csv "
              "instead of the PNG)")


def make_rows(runs, ckpt_b) -> list:
    rows = [dict(name=name, capacity=r["capacity"],
                 acc=round(r["acc"], 4), bytes=r["bytes"],
                 evictions=r["evictions"], n_selecting=r["n_selecting"])
            for name, r in runs.items()]
    rows.append(dict(name="checkpoint", bytes=ckpt_b,
                     ratio=round(ckpt_b / max(runs["bounded"]["bytes"], 1),
                                 4)))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="fast CI subset: 16 clients, lighter GA")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="dump one row a run")
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args(argv)
    n, mpc, capacity = (16, 2, 8) if args.smoke else (64, 2, 16)
    ga = dict(pop=16, gens=5, k=3) if args.smoke else {}
    print(f"world: {n} clients x {mpc} models, bounded capacity {capacity}, "
          f"small-world overlay, 10% drops, lognormal churn")

    runs = {}
    for name, cap in (("bounded", capacity), ("unbounded", n * mpc)):
        res = Experiment.from_spec(make_spec(n, mpc, cap, **ga),
                                   device=args.device).run()
        evictions = sum(getattr(s, "evictions", 0) for s in res.stores)
        finals = [res.selections[c][-1][1] for c in range(n)
                  if res.selections[c]]
        tstats = res.net["transport"]
        runs[name] = dict(acc=float(np.mean(finals)), curve=res.curve,
                          bytes=tstats["bytes_sent"], evictions=evictions,
                          metrics=res.metrics, capacity=cap,
                          n_selecting=len(finals))
        print(f"\n[{name} cap={cap}] final mean val-acc "
              f"{runs[name]['acc']:.3f} over {len(finals)} selecting "
              f"clients | bytes-on-wire {tstats['bytes_sent']/1e6:.1f}"
              f" MB (+{tstats['bytes_rejected']/1e6:.1f} MB "
              f"inbox-rejected, not on wire) | evictions {evictions} | "
              f"dropped link/inbox/offline "
              f"{tstats['n_dropped_link']}/"
              f"{tstats['n_dropped_inbox']}/"
              f"{res.net['lost_offline']} | "
              f"gossip dedup {res.net['gossip']['n_dedup']} "
              f"suppressed {res.net['gossip']['n_suppressed']}")

    # -- claim 1: bounded within 2 points of unbounded ------------------
    gap = runs["unbounded"]["acc"] - runs["bounded"]["acc"]
    print(f"\nbounded-vs-unbounded val-acc gap: {gap:+.3f} "
          f"(claim: within 0.02)")
    assert gap <= 0.02, f"bounded store lost {gap:.3f} val-acc"

    # -- claim 2: prediction-matrix exchange >= 10x cheaper -------------
    res_ckpt = Experiment.from_spec(
        make_spec(n, mpc, capacity, size_mode="checkpoint", **ga),
        device=args.device).run()
    pred_b = runs["bounded"]["bytes"]
    ckpt_b = res_ckpt.net["transport"]["bytes_sent"]
    print(f"bytes-on-wire: prediction-matrix {pred_b/1e6:.1f} MB vs "
          f"checkpoint {ckpt_b/1e6:.1f} MB -> {ckpt_b/max(pred_b,1):.0f}x")
    assert ckpt_b >= 10 * pred_b

    # -- val-acc vs bytes-on-wire curve ---------------------------------
    print("\nmean val-acc vs MB on wire (bounded run):")
    curve = runs["bounded"]["curve"]
    for b, a in curve[:: max(1, len(curve) // 10)]:
        print(f"  {b/1e6:8.2f} MB  acc={a:.3f}  " + "#" * int(a * 40))
    write_curves(runs, n)
    rows = make_rows(runs, ckpt_b)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(json_ready(rows), f, indent=2, allow_nan=False)
        print(f"wrote {len(rows)} rows to {args.json}")
    print("\nOK: bounded streaming stores track unbounded accuracy under "
          "churn and loss, at prediction-matrix (not checkpoint) cost.")
    return rows


if __name__ == "__main__":
    main()
