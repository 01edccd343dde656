"""Paper Table IV on the port: computational-cost comparison (port of
`benchmarks/table4_cost.py`).

FLOPs model follows the paper: training FLOPs = 3 x forward FLOPs
(Chiang et al.); FedPAE total = N (M T D f_fwd + P G f_fitness + pf V f_fwd);
round-based methods = N R E f_fwd_bwd. Forward FLOPs per family are
counted analytically from the conv/fc shapes, as the reference counts
them: every convolution at the full img x img input, pooling and stride 2
ignored, so the counts equal the reference's integers. Runtimes are
measured on the reduced benchmark grid.

Usage: PYTHONPATH=src python -m repro_torch.benchmarks.table4_cost \
    [--full] [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.benchmarks.common import make_clients
from repro_torch.configs.paper_cnn import config as paper_config
from repro_torch.core.fedpae import run_fedpae, run_local_ensemble
from repro_torch.fl.baselines import BASELINES, FLConfig
from repro_torch.models.cnn import CNNConfig, init_model
from repro_torch.obs.metrics import Stopwatch


def conv_flops(shape_in, w_shape, stride=1):
    """`shape_in` (h, w, cin); `w_shape` the port's OIHW weight shape."""
    h, w_, cin = shape_in
    cout, _, kh, kw = w_shape
    return 2 * (h // stride) * (w_ // stride) * kh * kw * cin * cout


def family_forward_flops(family: str, ccfg: CNNConfig, img=10):
    """Analytic forward FLOPs for one image."""
    total = 0
    for _, p in init_model(family, 0, ccfg).named_parameters():
        if p.dim() == 4:  # conv, OIHW
            total += conv_flops((img, img, p.shape[1]), tuple(p.shape))
        elif p.dim() == 2:  # dense, (din, dout)
            total += 2 * p.shape[0] * p.shape[1]
    return total


def analytic_flops(fp, fl, ccfg: CNNConfig, N, D, V):
    """(FedPAE, round-based) analytic FLOPs of the paper's cost model: `fp`
    a FedPAEConfig, `fl` the baselines' FLConfig, N clients of D training
    and V validation samples on average."""
    f_fwd = {f: family_forward_flops(f, ccfg) for f in fp.families}
    f_avg = float(np.mean(list(f_fwd.values())))
    T = fp.max_epochs  # epochs over D samples
    P, G = fp.nsga.pop_size, fp.nsga.generations
    M = len(fp.families)
    # NSGA fitness evaluation cost: P x (matvec M + quadform M^2) per gen
    f_fit = 2 * (N * M) ** 2 + 2 * N * M
    fedpae_flops = N * (M * 3 * f_avg * T * D + P * G * f_fit + 10 * V * f_avg)
    round_flops = N * fl.rounds * fl.local_steps * fl.batch * 3 * f_avg
    return fedpae_flops, round_flops


def main(full=False, device=None, pc=None):
    pc = pc or paper_config(full)
    n_classes = list(pc["datasets"].values())[0]
    fp = pc["fedpae"]
    ccfg = CNNConfig(n_classes=n_classes, width=fp.width)
    datasets, _ = make_clients(pc["n_clients"], 0.1, pc["n_samples"], n_classes)
    N = len(datasets)
    D = int(np.mean([len(d.x_tr) for d in datasets]))
    V = int(np.mean([len(d.x_va) for d in datasets]))

    fl = FLConfig(rounds=400 if full else 60, local_steps=2,
                  families=fp.families, width=fp.width)
    fedpae_flops, round_flops = analytic_flops(fp, fl, ccfg, N, D, V)

    # measured wall-clock on the reduced grid
    sw = Stopwatch()
    sw.start()
    local_acc, models, ccfg2 = run_local_ensemble(datasets, n_classes, fp,
                                                  device=device)
    t_train = sw.stop()
    sw.start()
    run_fedpae(datasets, n_classes, fp, models=models, ccfg=ccfg2,
               device=device)
    t_select = sw.stop()
    sw.start()
    BASELINES["fedavg"](datasets, n_classes, fl, device=device)
    t_fedavg = sw.stop()

    print("method,gflops_analytic,runtime_s")
    print(f"fedpae,{fedpae_flops/1e9:.2f},{t_train + t_select:.1f}")
    print(f"fedavg,{round_flops/1e9:.2f},{t_fedavg:.1f}")
    print(f"# fedpae breakdown: train {t_train:.1f}s + exchange/select {t_select:.1f}s")
    return {"fedpae_gflops": fedpae_flops / 1e9, "round_gflops": round_flops / 1e9,
            "t_fedpae": t_train + t_select, "t_fedavg": t_fedavg}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU (default: the card)")
    a = ap.parse_args()
    main(a.full, device=a.device)
