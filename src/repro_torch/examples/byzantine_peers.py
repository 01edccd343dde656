"""FedPAE under Byzantine peers: validation-gated admission vs the
ungated mean-vote ensemble (DESIGN.md §12; port of
`examples/byzantine_peers.py`).

FedPAE's exchange unit — the prediction matrix on the RECEIVER's own
validation set (§III-A) — is also its natural defense: every arriving
model can be screened by one cheap argmax before it enters the
selection pool. This example measures that defense under colluding
`confident_wrong` Byzantine owners who ship high-confidence votes for a
shared row-indexed wrong class.

Three arms per Byzantine fraction, all sharing ONE set of honestly
trained models (the adversary poisons what it ships, not what it
learns):

  gated     — byzantine injector + `validation_gate` admission; report
              the NSGA-served test accuracy over honest clients;
  ungated   — byzantine injector only; same NSGA serving (selection
              pressure alone is the implicit defense);
  allpeers  — the naive baseline read off the ungated arm's stores:
              mean-prob vote over EVERY stored model, poisoned included
              (the store serves a Byzantine entry through its wrapped,
              poisoning forward, on the card as on the CPU).

Headline: at 30% Byzantine on a lossy ring, the gated arm retains >=95%
of its fault-free accuracy while the ungated all-peers vote degrades by
>=5 points, and the gate's rejection counter is nonzero. Fault schedules
are pure functions of the spec seed: the chaotic arm is re-run and must
be bit-identical. Every select tick that runs a GA launches
ensemble_fitness 2 x 10 + 1 times on the card. `--json PATH` dumps the
reference's rows.

    PYTHONPATH=src python -m repro_torch.examples.byzantine_peers \
        [--smoke] [--json PATH] [--device cpu]
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from repro_torch.fl.client import accuracy
from repro_torch.obs.metrics import json_ready
from repro_torch.sim import (ComponentSpec, DataSpec, Experiment,
                             ExperimentSpec, FaultSpec, NetworkSpec,
                             ScheduleSpec, SelectionSpec, TrainSpec)


def make_spec(n: int, n_samples: int, frac: float, gated: bool,
              seed: int = 0) -> ExperimentSpec:
    injectors = []
    if frac > 0:
        injectors.append(ComponentSpec("byzantine", {
            "fraction": frac, "mode": "confident_wrong",
            "confidence": 0.95}))
    return ExperimentSpec(
        data=DataSpec(kind="synthetic_images", n_clients=n, n_classes=8,
                      n_samples=n_samples, alpha=1.0),
        train=TrainSpec(families=("cnn4",), max_epochs=15, patience=4,
                        width=16),
        selection=SelectionSpec(pop_size=24, generations=10, k=3),
        network=NetworkSpec(
            topology="ring",
            transport=ComponentSpec("gossip", {
                "base_latency": 0.05, "jitter": 1.0, "bandwidth": 50e6,
                "drop_prob": 0.1, "inbox_capacity": 64}),
            gossip="push",
            repair=ComponentSpec("anti_entropy", {
                "interval": 1.0, "start": 1.0, "max_rounds": 40,
                "quiesce_after": 2, "max_attempts": 6,
                "max_resends_per_digest": 6})),
        schedule=ScheduleSpec(mode="async"),
        faults=FaultSpec(
            injectors=tuple(injectors),
            admission=ComponentSpec("validation_gate") if gated else None),
        seed=seed)


def allpeers_acc(res, datasets, honest) -> float:
    """The naive undefended ensemble: each honest client mean-prob votes
    over EVERY model its store holds (Byzantine entries serve poisoned
    outputs — the store wraps their predict)."""
    accs = []
    for c in honest:
        store, d = res.stores[c], datasets[c]
        k = max(1, int(store.mask.sum()))
        probs = store.predictions(d.x_te, mask=store.mask)
        accs.append(accuracy(probs.sum(0) / k, d.y_te))
    return float(np.mean(accs))


def run_arm(spec, shared, *, device=None):
    """One arm on the shared honestly-trained world. Returns (exp, res,
    honest clients, honest-mean FedPAE acc)."""
    exp = Experiment(spec, datasets=shared["datasets"],
                     models=shared["models"], ccfg=shared["ccfg"],
                     device=device)
    res = exp.run()
    byz = (exp.faults.byzantine.clients
           if exp.faults is not None and exp.faults.byzantine is not None
           else frozenset())
    honest = [c for c in range(spec.data.n_clients) if c not in byz]
    acc = float(np.mean([res.test_acc[c] for c in honest]))
    return exp, res, honest, acc


def arm_rows(frac, g, u, ap_acc, adm) -> list:
    """The reference's three rows of one Byzantine fraction."""
    pct = int(round(frac * 100))
    return [
        dict(name=f"byz{pct}_gated", acc=round(g, 4),
             rejected=int(adm.get("n_rejected", 0)),
             admitted=int(adm.get("n_admitted", 0)),
             quarantined=int(adm.get("n_quarantined", 0))),
        dict(name=f"byz{pct}_ungated", acc=round(u, 4)),
        dict(name=f"byz{pct}_allpeers", acc=round(ap_acc, 4)),
    ]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="fast CI subset: 6 clients, fractions {0, 30%}")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="dump the rows (the reference's names and keys)")
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args(argv)
    dev = args.device
    n, n_samples = (6, 3600) if args.smoke else (10, 6000)
    fracs = (0.0, 0.3) if args.smoke else (0.0, 0.1, 0.3)

    # train ONCE (honest world), share datasets/models across every arm:
    # arms differ only in what the adversary ships / what the gate does
    base = Experiment(make_spec(n, n_samples, 0.0, False), device=dev)
    base._ensure_models()
    shared = dict(datasets=base.datasets, models=base.models,
                  ccfg=base.ccfg)
    print(f"world: {n} clients x 1 cnn4 on a lossy ring (10% drops, "
          f"anti-entropy repair), confident_wrong collusion\n")
    print(f"{'byz':>5} {'gated':>7} {'ungated':>8} {'allpeers':>9} "
          f"{'rejected':>9} {'coverage':>9}")

    rows, acc_g, acc_ap, rej = [], {}, {}, {}
    for frac in fracs:
        _, res_g, _, g = run_arm(make_spec(n, n_samples, frac, True),
                                 shared, device=dev)
        exp_u, res_u, honest, u = run_arm(
            make_spec(n, n_samples, frac, False), shared, device=dev)
        ap_acc = allpeers_acc(res_u, shared["datasets"], honest)
        adm = (res_g.net or {}).get("admission") or {}
        acc_g[frac], acc_ap[frac] = g, ap_acc
        rej[frac] = int(adm.get("n_rejected", 0))
        print(f"{frac:5.0%} {g:7.3f} {u:8.3f} {ap_acc:9.3f} "
              f"{rej[frac]:9d} {res_g.coverage:9.3f}")
        rows += arm_rows(frac, g, u, ap_acc, adm)

    # -- headline: the gate keeps FedPAE at its fault-free level --------
    worst = max(fracs)
    retention = acc_g[worst] / max(acc_g[0.0], 1e-9)
    degrade = acc_ap[0.0] - acc_ap[worst]
    print(f"\nat {worst:.0%} byzantine: gated retains {retention:.1%} of "
          f"fault-free accuracy; ungated all-peers vote drops "
          f"{degrade * 100:.1f} pts; gate rejected {rej[worst]} payloads")
    assert retention >= 0.95, \
        f"gated arm lost {1 - retention:.1%} of fault-free accuracy"
    assert degrade >= 0.05, \
        f"all-peers vote degraded only {degrade * 100:.1f} pts — the " \
        "attack is vacuous at this seed"
    assert rej[worst] > 0, "gate never rejected anything at the worst " \
                           "fraction — the defense is untested"

    # -- determinism: fault schedules are pure functions of the seed ----
    _, r1, _, _ = run_arm(make_spec(n, n_samples, worst, True), shared,
                          device=dev)
    _, r2, _, _ = run_arm(make_spec(n, n_samples, worst, True), shared,
                          device=dev)
    assert r1.trace.events == r2.trace.events and r1.net == r2.net, \
        "chaotic run is not bit-identical across reruns"
    print("determinism: the chaotic arm is bit-identical across reruns")

    if args.json:
        with open(args.json, "w") as f:
            json.dump(json_ready(rows), f, indent=2, allow_nan=False)
        print(f"wrote {len(rows)} rows to {args.json}")
    print("\nOK: one argmax on the receiver's own validation set is "
          "enough to hold FedPAE's floor under 30% collusion.")
    return rows


if __name__ == "__main__":
    main()
