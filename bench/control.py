#!/usr/bin/env python3
"""Readings that set a cell's limits of `correct`, on the card at the
cell's own size (the benchmark's runs never run this):

    python3 bench/control.py --workload <cell> --seeds 11,12,13 \
        [--faults control,half_batch]

Score cells, each seed: the program serves the mix's calls until a
block ends with as many calls as a run checks, then over the run's
sample of them the script prints the program's vote gaps (their mean,
`vote_gap_mean`, and the widest) and the control's: the reference with
every bf16 matrix through float8 e4m3 (`reference.fp8_weights`), its top
token judged as a served one.
Train cells, each seed: the program's checked steps as a run makes them,
against the reference (`loss_gap`, `grad_gap`, `change_gap`); with
`--faults` also those named of the control (the reference's steps
through float8 matrices) and the fault of half the batch left out (the
reference on the first half of each batch's rows), each against the
reference. A step
that leaves the state unchanged reads `change_gap` 1 by construction.
One JSON line a seed.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def score_seed(cell, seed, device):
    import torch

    from bench import gen, reference, weights
    from bench.drivers import score
    from repro_torch.launch import serve
    mix, arch = cell.traffic, cell.arch
    cfg = score.port_config(cell, False)
    flats = score.members_for(cell, arch, seed, device)
    members = [weights.port_params(f) for f in flats]
    recs = []
    for i, L, last in gen.score_calls(mix, seed):
        p = torch.as_tensor(gen.prompts(mix, seed, i, L, arch["vocab"]),
                            device=device)
        out = serve.serve_batch(cfg, members, p, gen_len=1).cpu().numpy()
        recs.append((i, L, 0.0, out))
        if last and len(recs) >= cell.data["check"]["calls"]:
            break
    del members
    torch.cuda.empty_cache()
    gaps = {"vote_gap": [], "control.vote_gap": []}
    for j in score.sample_calls(cell, recs, seed):
        i, L, _, toks = recs[j]
        prompts = torch.as_tensor(gen.prompts(mix, seed, i, L,
                                              arch["vocab"]), device=device)
        lp = reference.vote_logprobs(arch, flats, prompts)
        ctrl = reference.vote_logprobs(arch, flats, prompts,
                                       weight_fn=reference.fp8_weights)
        for k, first in (("vote_gap", torch.as_tensor(toks[:, 0],
                                                      device=device)),
                         ("control.vote_gap", ctrl.argmax(-1))):
            gaps[k] += (lp.max(-1).values
                        - lp.gather(1, first.long()[:, None])[:, 0]).tolist()
    out = {}
    for k, g in gaps.items():
        out[k + "_mean"] = sum(g) / len(g)
        out[k + "_widest"] = max(g)
    return dict(out, lengths=sorted(r[1] for r in recs))


def train_seed(cell, seed, device, faults):
    import torch

    from bench.drivers import train
    mix, arch = cell.traffic, cell.arch
    cfg = train.port_config(cell, False)
    params, state, step_fn, prog = train.checked_steps(cfg, arch, mix, seed,
                                                       device, False)
    del params, state, step_fn
    torch.cuda.empty_cache()
    ref = train.reference_steps(arch, mix, seed, device, False)
    out = train.compare(prog, ref, arch, seed, device)
    out["losses"] = prog["losses"]
    out["ref_losses"] = ref["losses"]
    B = mix["batch"]
    for name, kw in (("control", {"control": True}),
                     ("half_batch", {"rows": list(range(B // 2))})):
        if name in faults:
            r = train.reference_steps(arch, mix, seed, device, False, **kw)
            for k, v in train.compare(r, ref, arch, seed, device).items():
                out[f"{name}.{k}"] = v
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--faults", default="",
                    help="comma list of control, half_batch (train cells)")
    a = ap.parse_args()
    import torch

    from bench import harness
    cell = harness.Cell(a.workload)
    device = torch.device("cuda", 0)
    for seed in [int(s) for s in a.seeds.split(",")]:
        t = time.time()
        if cell.kind == "score":
            r = score_seed(cell, seed, device)
        else:
            r = train_seed(cell, seed, device, a.faults.split(","))
        r.update(workload=a.workload, seed=seed, seconds=time.time() - t)
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    sys.exit(main())
