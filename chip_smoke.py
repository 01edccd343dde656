#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Device: the card's name and power limit (nvidia-smi), the torch
   device name and count.
2. Build: compiles the five sources under `src/repro_torch/csrc/`
   (ensemble_fitness, flash_attention, ssd_scan, wkv_scan and its
   backward wkv_scan_bwd) with nvcc for
   sm_90a, one nvcc each, started together, and prints each build's
   seconds and ptxas register / shared-memory report.
3. Kernel: both entry points of ensemble_fitness at the main path's
   shapes and at edge shapes (dense rows, non-binary rows, all-zero and
   single-member rows, ragged row counts), each held against its plain
   PyTorch version (max abs error <= 1e-5), and timed with CUDA events
   against the plain version (in turns: plain, kernel, kernel, plain),
   with the kernel's device time from torch.profiler beside it and the
   bound (pop read whole, the entries of acc and S its rows' nonzeros
   pick, the (N, P, 2) objectives written; the count with S whole is
   printed beside it).
4. Slice: the paper's synchronous configuration (configs/paper_cnn.py,
   full=True: 20 clients, 5 CNN families, width 16, 10 classes, 60000
   synthetic 10x10x3 images, Dirichlet 0.1, NSGA-II 100 x 100, k = 5)
   with local training cut from 60 epochs to 2; selection scores every
   population through the kernel.
   The launch count is reset just before the run and must come out at
   2 * generations + 1 per selection. Two more selections of the same
   engine state must give identical populations, objectives and winners
   (is select() deterministic on the card?). One more selection under
   torch.profiler prints its kernel launches beside the 43055 that the
   dense-form kernel's run on this card counted, and beside those of the
   same selection through that version's per-call fitness wrapper (a
   diag(S) copy, two outputs, a stack), which must launch at least 201
   more.
5. Kernel: flash_attention at the reference's test shapes and variants,
   head dim 112, bf16 window and softcap at hd 64, 112 and 128, a ragged
   S = 100, the serving slice's shape (4, 32, 8, 2048, 2048, 128),
   zamba2-7b's shared-attention shape (4, 32, 32, 2048, 2048, 112), also
   with window and softcap, and the long-context shape (1, 32, 8, 8192,
   8192, 128), bf16 causal, each held against its plain version on the
   card (fp32 atol = rtol = 2e-5, bf16 2e-2, as
   tests/test_kernels.py:70,83). At the slice's shape ops.flash_attention
   on the same data in the model layout (B, S, H, hd) must equal the
   kernel's output bitwise and come out contiguous. At the three large
   causal shapes: timed in turns against the plain version (and, at the
   slice's shape, through ops.py on the model layout), the kernel's
   device time from torch.profiler, scaled_dot_product_attention timed as
   the library yardstick (never called by the port), and the bound.
6. Kernel: ssd_scan and wkv_scan at the reference's test shapes
   (tests/test_kernels.py:86-90,107-111), its padding shapes (S = 200
   and 100), a wkv case with a carried state and two with strong decay
   (logw = -2 and -8 on every step, past the range of the TPU kernel's
   factorisation; they must also be finite), and
   the serving slices' shapes, ssd (4, 2048, 112, 64, 64) and wkv (4,
   2048, 40, 64), in fp32 and bf16 (dt and logw fp32 as the models pass
   them; at the slices' shapes B and C are views of one tensor and wkv
   carries a nonzero state, as the models pass them), each held against
   its plain version (the naive recurrence) on
   the card: y max abs error / max |y| < 1e-5 in fp32 and < 2**-7 (one
   bf16 step at the top of y's range) in bf16, the fp32 state atol =
   rtol = 1e-3. At both slice shapes y is also held against a float64
   recurrence: within 1e-6 of max |y| in fp32, printed in bf16. At the
   slices' shapes: timed in turns against the plain version, the
   kernels' device time from torch.profiler (every kernel of a call),
   the torch copy of the model's chunked scan timed as the
   chunked-PyTorch comparator (no single PyTorch call computes either
   scan), and the bound: the least multiply-add work of the function
   (the chunked form at its cheapest chunk size, C B^T once a batch) on
   the bf16 tensor cores, each product with an fp32 factor counted at
   the bf16 terms that keep fp32 accuracy (3 against an exact bf16
   operand, 6 for two fp32 factors), against the bytes; the count with
   the fp32 factors on the FMA units is printed beside it.
7. Kernel: the wkv_scan backward (wkv_scan_bwd, no TPU counterpart),
   through ops.wkv_scan's autograd Function (one forward and one
   backward launch), at (2, 512, 4, 64) in fp32 and bf16, at logw = -2
   and -8 on every step and at a padded S = 100, each with a non-zero u,
   an s0 and a gradient on s_T: dr, dk, dv, dlogw, du and ds0 held
   against the plain backward (ref.wkv_scan_bwd_ref) to 1e-5 of each
   gradient's max |g| (2**-7 for bf16 dr, dk, dv) and, at (2, 512, 4,
   64), printed against torch.autograd of a float64 recurrence (fp32
   within 1e-5); every gradient finite. At the training shapes, a
   rwkv6-3b microbatch (2, 2048, 40, 64) and the whole batch (4, 2048,
   40, 64), bf16, as a layer calls it (no s0, s_T unused: no d s_T, no
   ds0): dr, dk, dv, dlogw and du held against the plain backward with
   the same limits. At (2, 2048, 40, 64) two calls must give bitwise
   equal dr, dk, dv, dlogw and du. At both shapes: timed in turns
   against the plain backward, device time from torch.profiler (a call
   runs four kernels, wkv_scan_bwd_*; each one's time printed), and the
   bound (bytes of the function's inputs and outputs, against twice the
   forward's least work).
8. Model check: the smoke rwkv6-3b and zamba2-7b in fp32, the same
   weights on the card (kernels) and on the CPU (plain versions):
   prefill logits and states agree (atol 3e-4, rtol 1e-3).
9. Train check: the smoke qwen2.5-3b and rwkv6-3b in fp32, from the
   same parameters (drawn on the CPU, as train() draws them) and the same
   TokenPipeline(seed=0) batches, on the card (rwkv6: both wkv kernels)
   and on the CPU (plain versions): every parameter's gradient on the
   first batch within 1e-4 of its max |g|, then 10 adamw steps of 4 x 64
   tokens as train() takes them, whose losses agree within 1e-5
   relative; the card's last loss is below its first; rwkv6-3b launches
   wkv_scan twice (once more under the checkpoint's recompute) and
   wkv_scan_bwd once a layer and pass. Then the rwkv6-3b card run once
   more with a planted fault (the wkv backward's dk zeroed): the
   gradient check must fail on it (its gaps are printed).
10. Serve, in turn: FedPAE soft-vote serving
   (`launch/serve.py::serve_batch`) of two full-width members (bf16,
   random weights from seeds 0 and 1) of llama3-8b (attn_impl="pallas":
   flash_attention on every layer), rwkv6-3b (wkv_scan on every layer)
   and zamba2-7b (ssd_scan on every Mamba2 layer) on 4 x 2048-token
   prompts, 16 generated tokens. The kernel's launch count is reset
   just before the run and must come out at n_layers x members (64, 64,
   162); the tokens must be (4, 16) and inside the vocabulary; weights
   [1, 0] must give member 0's own tokens; every last-position prefill
   logit and one decode step's logits must be finite. Reports prefill
   seconds, decode tokens/s, peak memory (each phase frees the previous
   one's members first), the device's busy share of the prefill (with
   its largest kernels) and of one decode step (with its launches), and
   for llama3-8b the pallas-vs-xla gap of member 0's last-position
   probabilities.
11. Train, in turn: `train()` of qwen2.5-3b and rwkv6-3b at full width
   and depth (bf16, random weights from seed 0), adamw (weight decay
   0.01) and warmup_cosine, 6 steps of 4 x 2048 tokens from
   TokenPipeline(seed=0) in 2 microbatches. The wkv counts are reset
   just before each run: rwkv6-3b must launch wkv_scan 32 x 2 x 2 and
   wkv_scan_bwd 32 x 2 times a step, 6 steps in all. Reports every loss
   (all finite), step seconds (as train() returns them), tokens/s over
   steps 2-6, peak device memory and the launches, then one more step
   under torch.profiler by kernel.
12. Every share of bound printed (bound / time) must be <= 1.05: a
   kernel faster than its bound means the bound is no floor. The shares,
   the `kernels` JSON line, then the result line.

Exits non-zero at the first failure, and when no CUDA device is present.
TF32 is off for cuBLAS and cuDNN throughout, so every fp32 product is a
full fp32 product.
"""
from __future__ import annotations

import copy
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

TOL = 1e-5
TOL_GRAM = 2e-4
PEAK_FP32_FLOPS = 67e12       # H100 SXM, fp32 outside the tensor cores
PEAK_BYTES = 3.35e12          # H100 SXM HBM3
PEAK_BF16_FLOPS = 989e12      # H100 SXM, bf16 dense tensor cores
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
SLICE_SHAPE = (4, 32, 8, 2048, 2048, 128)     # llama3-8b prefill, batch 4
LONG_SHAPE = (1, 32, 8, 8192, 8192, 128)
ZAMBA_ATTN_SHAPE = (4, 32, 32, 2048, 2048, 112)   # its shared attention
SHARE_MAX = 1.05     # a kernel faster than its bound means a wrong bound
SHARES = {}          # what -> share of bound, every one printed
SERVE = {"seeds": [0, 1], "batch": 4, "prompt_len": 2048,
         "gen_len": 16}                                    # a member a seed
SERVES = [  # (arch, config overrides, the kernel package its prefill runs)
    ("llama3-8b", {"attn_impl": "pallas"}, "flash_attention"),
    ("rwkv6-3b", {}, "wkv_scan"),
    ("zamba2-7b", {}, "ssd_scan")]
SCAN_Y_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}   # of max |y|
SCAN_STATE_TOL = 1e-3
SCAN_F64_TOL = 1e-6    # fp32 scans at the slice shapes, of max |y|
SSD_SLICE = (4, 2048, 112, 64, 64)     # zamba2-7b prefill, batch 4
WKV_SLICE = (4, 2048, 40, 64)          # rwkv6-3b prefill, batch 4
SELECT_LAUNCHES_DENSE = 43055  # kernels of one profiled select() with
                               # the dense-form fitness kernel, H100
PAPER_SPEC = {
    "data": {"kind": "synthetic_images", "n_clients": 20, "n_classes": 10,
             "n_samples": 60000, "image_size": 10, "channels": 3,
             "alpha": 0.1},
    "train": {"families": ["cnn4", "vgg", "resnet", "densenet",
                           "inception"],
              "lr": 0.05, "batch": 32, "max_epochs": 2, "patience": 8,
              "width": 16},
    "selection": {"pop_size": 100, "generations": 100, "k": 5,
                  "ensemble_k": 5},
    "schedule": {"mode": "sync"},
    "seed": 0,
}
REDUCED = {"train.max_epochs": "60 -> 2 (configs/paper_cnn.py full=True)"}


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def share(what: str, bound_ms: float, ms: float) -> float:
    """Records and checks a kernel's share of its bound (bound / time):
    above SHARE_MAX the bound is no floor and the run fails."""
    SHARES[what] = bound_ms / ms
    check(SHARES[what] <= SHARE_MAX, f"{what}: share of bound "
          f"{SHARES[what]:.4f} above {SHARE_MAX}: the bound is no floor")
    return SHARES[what]


def nvidia_smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def fitness_bound(pop):
    """Least time (ms) the card needs for one batched call on `pop`
    (N, P, M), the larger of the bytes over the memory rate and the
    operations over the fp32 peak. The bytes this data needs: pop read
    whole (each row's nonzeros have to be found), of acc (N, M) and S (N,
    M, M) only the entries the rows' nonzeros pick (acc[n, i] and S[n, i,
    j] for i, j nonzero in one row of client n, each counted once), and
    the (N, P, 2) objectives written once. The operations: k^2
    multiply-adds a row for the quadratic form and 3 k for strength, self
    similarity and k, k the row's nonzeros. Returns ((ms, bound_by), (ms,
    bound_by) with acc and S counted whole, the count of earlier
    versions)."""
    import torch
    N, P, M = pop.shape
    nz = (pop != 0).double()
    k = nz.sum(-1)
    needed = float((2 * (k * k + 3 * k)).sum())
    acc_used = int((nz.sum(1) > 0).sum())
    s_used = int((torch.einsum("npi,npj->nij", nz, nz) > 0).sum())
    out = []
    for n_acc, n_s in ((acc_used, s_used), (N * M, N * M * M)):
        t_bytes = 4 * (N * P * M + n_acc + n_s + 2 * N * P) / PEAK_BYTES
        t_ops = needed / PEAK_FP32_FLOPS
        out.append((1e3 * max(t_bytes, t_ops),
                    "bytes" if t_bytes >= t_ops else "operations"))
    return out


def make_inputs(torch, rng, N, P, M, rows="k5"):
    """Populations whose rows hold k in {0, 1, 5, 5, 5} ones ("k5"),
    about M / 2 ones ("dense") or about M / 16 nonzeros of any value and
    sign ("values"), accuracies and a symmetric similarity matrix."""
    import numpy as np
    pop = np.zeros((N, P, M), np.float32)
    for n in range(N):
        for p in range(P):
            if rows == "dense":
                pop[n, p] = rng.random(M) < 0.5
            elif rows == "values":
                pop[n, p] = (rng.random(M) < 1 / 16) * rng.normal(size=M)
            else:
                k = min((0, 1, 5, 5, 5)[p % 5], M)
                pop[n, p, rng.choice(M, k, replace=False)] = 1.0
    acc = rng.random((N, M)).astype(np.float32)
    a = rng.random((N, M, M)).astype(np.float32)
    S = (a + a.transpose(0, 2, 1)) / 2
    return tuple(torch.as_tensor(x, device="cuda") for x in (pop, acc, S))


def time_ms(torch, fn, iters=200, warmup=20):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def device_ms(torch, fn, iters=50, name="ensemble_fitness_kernel"):
    """Device time from torch.profiler: (the kernels whose names hold
    `name`, per call; every kernel of the calls, per call; the number of
    their launches recorded; {kernel: its mean per recorded launch}),
    times in ms, None where the profiler saw no device time. A call runs
    each kernel of `name` once (ssd_scan and wkv_scan_bwd run four,
    wkv_scan three), so a call's time is the sum over those kernels of
    each one's mean per recorded launch: the profiler may drop records of
    long kernels on this machine, and this sum equals the total over the
    calls divided by the calls when it drops none."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type.name == "CUDA" and e.self_device_time_total]
    own = [e for e in events if name in e.key]
    n_own = sum(e.count for e in own)
    own_us = sum(e.self_device_time_total / e.count for e in own)
    every_us = sum(e.self_device_time_total for e in events)
    parts = {e.key: e.self_device_time_total / e.count / 1e3 for e in own}
    return (own_us / 1e3 if own_us else None,
            every_us / 1e3 / iters if every_us else None, n_own, parts)


def kernel_phase(torch):
    import numpy as np

    from repro_torch.kernels.ensemble_fitness import kernel, ref
    rng = np.random.default_rng(0)
    cases = [  # (entry point, N, P, M, rows)
        ("batched", 32, 100, 100, "k5"), ("batched", 32, 200, 100, "k5"),
        ("single", 1, 100, 100, "k5"), ("single", 1, 200, 100, "k5"),
        ("batched", 4, 128, 320, "dense"), ("single", 1, 37, 320, "dense"),
        ("batched", 3, 50, 7, "k5"), ("single", 1, 50, 7, "dense"),
        ("batched", 2, 1, 100, "k5"), ("single", 1, 1, 7, "k5"),
        ("batched", 5, 61, 100, "values"), ("single", 1, 45, 320, "values"),
    ]
    max_err = 0.0
    timings = {}
    for entry, N, P, M, rows in cases:
        pop, acc, S = make_inputs(torch, rng, N, P, M, rows)
        if entry == "batched":
            def run_kernel(pop=pop, acc=acc, S=S):
                return kernel.ensemble_fitness_batched(pop, acc, S)

            def run_plain(pop=pop, acc=acc, S=S):
                return ref.ensemble_fitness_batched_ref(pop, acc, S)
        else:
            def run_kernel(pop=pop[0], acc=acc[0], S=S[0]):
                return kernel.ensemble_fitness(pop, acc, S)

            def run_plain(pop=pop[0], acc=acc[0], S=S[0]):
                return ref.ensemble_fitness_ref(pop, acc, S)
        got = run_kernel()
        torch.cuda.synchronize()
        want = run_plain()
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        print(f"kernel ensemble_fitness[{entry}] (N, P, M) = {(N, P, M)}"
              f" {rows} rows: max abs err {err:.3e}")
        check(err <= TOL, f"ensemble_fitness[{entry}] at {(N, P, M)} "
                          f"disagrees with its plain version: {err}")
        max_err = max(max_err, err)
        if M == 100 and P in (100, 200) and rows == "k5":   # main path
            # in turns: plain, kernel, kernel, plain
            p1, k1, k2, p2 = (time_ms(torch, fn) for fn in
                              (run_plain, run_kernel, run_kernel, run_plain))
            k_ms, p_ms = (k1 + k2) / 2, (p1 + p2) / 2
            own_ms, call_ms, n_rec, _ = device_ms(torch, run_kernel)
            (b_ms, b_by), (d_ms, d_by) = fitness_bound(pop)
            timings[(entry, N, P, M)] = (k_ms, p_ms, b_ms, b_by)
            share(f"ensemble_fitness[{entry}] {(N, P, M)}", b_ms, k_ms)
            print(f"  time {entry} (N, P, M) = {(N, P, M)}: kernel "
                  f"{k_ms:.6f} ms ({k1:.6f}, {k2:.6f}), plain {p_ms:.6f} ms "
                  f"({p1:.6f}, {p2:.6f}) per call; on the device (profiler, "
                  f"{n_rec} of 50 launches recorded) the kernel {own_ms} ms, "
                  f"all kernels of the call "
                  f"{call_ms} ms; bound {b_ms:.6f} ms ({b_by}; with acc "
                  f"and S read whole {d_ms:.6f} ms, {d_by}), share of bound "
                  f"{b_ms / k_ms:.4f}; no single PyTorch call computes "
                  "this function (library: none)")
    print("clocks/power after timing:",
          nvidia_smi("clocks.sm,power.draw,temperature.gpu"))
    return max_err, timings


def slice_phase(torch):
    import numpy as np

    from repro_torch.core.device_store import DeviceStoreBatch
    from repro_torch.core.nsga2 import nondominated_rank
    from repro_torch.core.selection import selection_stats
    from repro_torch.kernels.ensemble_fitness import kernel, ref
    from repro_torch.obs.metrics import Stopwatch
    from repro_torch.sim import Experiment, ExperimentSpec

    spec = ExperimentSpec.from_dict(copy.deepcopy(PAPER_SPEC))
    print("slice config:", json.dumps({"spec": PAPER_SPEC,
                                       "reduced": REDUCED}, allow_nan=False))
    sel = spec.selection
    torch.cuda.reset_peak_memory_stats()
    kernel.KERNEL.launches = 0
    sw = Stopwatch().start()
    exp = Experiment.from_spec(spec, device="cuda")
    res = exp.run()
    torch.cuda.synchronize()
    wall = sw.stop()
    launches = kernel.KERNEL.launches
    peak = torch.cuda.max_memory_allocated()
    n_select = 1                    # the synchronous protocol selects once
    per_select = 2 * sel.generations + 1
    print(f"slice: wall {wall:.3f} s, phases (s) "
          f"{json.dumps(res.perf, allow_nan=False)}, peak device memory "
          f"{peak} bytes ({peak / 2**20:.1f} MiB)")
    print(f"slice: kernel launches {launches} in {n_select} select(), "
          f"expected {per_select} per select()")
    check(launches == per_select * n_select,
          f"ensemble_fitness launched {launches} times, expected "
          f"{per_select * n_select}")

    C, k = spec.data.n_classes, sel.k
    acc = res.test_acc
    check(acc.shape == (spec.data.n_clients,) and np.isfinite(acc).all()
          and ((acc >= 0) & (acc <= 1)).all(), f"bad test accuracies {acc}")
    for c, store in enumerate(res.stores):
        r = exp.engine.results[c]
        chrom = r["chromosome"]
        check(chrom.sum() == k and store.mask[chrom > 0.5].all(),
              f"client {c}: winner does not hold exactly {k} present "
              "members")
        row = np.flatnonzero((r["pop"] == chrom).all(-1))
        check(len(row) > 0 and r["pareto_mask"][row].all(),
              f"client {c}: winner is not on its Pareto front")
        check(np.isfinite(r["objs"]).all(), f"client {c}: objectives")
    local = exp.local_ensemble()
    print(f"slice: fleet-mean test accuracy {float(acc.mean()):.6f} "
          f"(FedPAE), {float(local.mean()):.6f} (local ensemble); "
          f"local-member fraction {float(res.local_frac.mean()):.6f}")
    check(acc.mean() > 1.0 / C, "fleet-mean test accuracy at or below "
                                "chance")

    # the cached statistics equal a from-scratch rebuild of the stores:
    # acc exactly; S to TOL_GRAM, since each entry is an fp32 dot product
    # over V*C = 14080 terms summed in another order (worst case about
    # 14080 * 2**-24 = 8e-4 for entries near 1)
    sb = exp.engine.store_batch
    acc_s, S_s = selection_stats(sb.preds, sb.labels)
    acc_err = float((acc_s - sb.acc).abs().max())
    s_err = float((S_s - sb.S).abs().max())
    print(f"slice: cached acc vs selection_stats max abs err {acc_err:.3e}"
          f", cached S {s_err:.3e} (V*C = {sb.v_max * sb.n_classes})")
    check(acc_err == 0.0 and s_err <= TOL_GRAM,
          f"cached statistics disagree: acc {acc_err}, S {s_err}")
    # incremental flushes vs one from-scratch flush on cuBLAS (reported):
    # re-adding a slot's own entry and predictions marks it dirty
    inc = DeviceStoreBatch(res.stores, "cuda", v_max=sb.v_max)
    inc.flush()
    for wave in ([0], [3, 4, 5], list(range(10, min(40, sb.capacity)))):
        for c in (0, len(res.stores) - 1):
            store = res.stores[c]
            for slot in wave:
                store.add(store.entries[slot],
                          preds=store.preds[slot, :store.n_val].copy())
        inc.flush()
    full = DeviceStoreBatch(res.stores, "cuda", v_max=sb.v_max)
    full.flush()
    same = all(torch.equal(getattr(inc, n), getattr(full, n))
               for n in ("preds", "pnorm", "masks", "acc", "S"))
    print(f"slice: incremental flush == rebuild bitwise on this card: "
          f"{same} (max abs diff "
          f"{float((inc.S - full.S).abs().max()):.3e})")

    # the winners' objectives, re-scored by the plain version
    pops = torch.as_tensor(np.stack([exp.engine.results[c]["pop"]
                                     for c in range(len(res.stores))]),
                           device="cuda")
    st, dv = ref.ensemble_fitness_batched_ref(
        pops, sb.acc[:len(res.stores)], sb.S[:len(res.stores)])
    objs = np.stack([exp.engine.results[c]["objs"]
                     for c in range(len(res.stores))])
    oerr = float(np.abs(np.stack([st.cpu().numpy(), dv.cpu().numpy()], -1)
                        - objs).max())
    ranks = nondominated_rank(torch.stack([st, dv], -1)).cpu().numpy()
    print(f"slice: final objectives vs plain version max abs err "
          f"{oerr:.3e}; front sizes {[int((r == 0).sum()) for r in ranks]}")
    check(oerr <= TOL, f"final objectives disagree: {oerr}")
    select_determinism(exp.engine)
    profile_select(torch, exp.engine)
    return launches, n_select


def _profiled_select(torch, engine):
    """(wall s, device busy s, kernel launches, events) of one select()
    under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs.metrics import Stopwatch
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sw = Stopwatch().start()
        engine.select()
        torch.cuda.synchronize()
        wall = sw.stop()
    kernels = [e for e in prof.key_averages()
               if e.device_type.name == "CUDA" and e.self_device_time_total]
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    return wall, busy, sum(e.count for e in kernels), kernels


def profile_select(torch, engine):
    """One more selection of the same fleet under torch.profiler (after
    the launch count was read): device time by kernel and the device's
    busy share of the selection's wall time (profiler on). Then the same
    selection again with the dense-form version's per-call fitness
    wrapper around the same kernel (a copy of diag(S), two outputs, a
    stack of them), so that the launches the gather form's wrapper saves
    show on the same data: the GA draws the same numbers and the
    objectives are the same values."""
    from repro_torch.core import selection
    from repro_torch.kernels.ensemble_fitness import kernel

    wall, busy, n, kernels = _profiled_select(torch, engine)
    print(f"profiled select(): wall {wall:.6f} s, device busy {busy:.6f} s "
          f"({busy / wall:.4f} of wall), {n} kernel launches (dense "
          f"form: {SELECT_LAUNCHES_DENSE})")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {e.self_device_time_total / 1e3:10.3f} ms  "
              f"{e.count:6d} x  {e.key[:90]}")

    def dense_form_eval_fn(acc, S):
        def eval_fn(pop):
            torch.diagonal(S, dim1=-2, dim2=-1).contiguous()
            out = kernel.Objectives(acc, S)(pop.contiguous())
            return torch.stack([out[..., 0], out[..., 1]], dim=-1)
        return eval_fn
    current = selection._eval_fn
    selection._eval_fn = dense_form_eval_fn
    try:
        wall_d, _, n_d, _ = _profiled_select(torch, engine)
    finally:
        selection._eval_fn = current
    wall2, _, n2, _ = _profiled_select(torch, engine)
    print(f"profiled select() with the dense form's per-call wrapper on "
          f"the same data: wall {wall_d:.6f} s, {n_d} kernel launches; "
          f"with the gather form's again: wall {wall2:.6f} s, {n2} "
          f"launches; the gather form launches {n_d - n} and {n_d - n2} "
          "fewer (2 x 201 expected)")
    check(min(n_d - n, n_d - n2) >= 201, f"select() saves {n_d - n} and "
          f"{n_d - n2} launches, expected at least 201 (the diag(S) copies)")


def attention_bound(B, H, KV, Sq, Sk, hd, causal=True, window=0,
                    elem_bytes=2):
    """Least time (ms) for one flash_attention call: 4 B H hd FLOP per
    unmasked (q, k) pair over the bf16 tensor-core peak, against q, k, v
    and o each moved once over the memory rate. Returns (ms, bound_by,
    flops, bytes)."""
    import numpy as np
    qpos = np.arange(Sq) + (Sk - Sq)
    hi = np.minimum(qpos + 1, Sk) if causal else np.full(Sq, Sk)
    lo = np.maximum(0, qpos - window + 1) if window else np.zeros(Sq)
    pairs = int(np.clip(hi - lo, 0, None).sum())
    flops = 4 * B * H * hd * pairs
    nbytes = elem_bytes * (2 * B * H * Sq * hd + 2 * B * KV * Sk * hd)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes", flops, nbytes)


def flash_phase(torch):
    """Every flash_attention case against its plain version on the card;
    timings at the slice's, zamba2-7b's shared-attention and the
    long-context shape. At the slice's shape the kernel is timed on
    contiguous (B, H, S, hd) inputs, as earlier versions were timed, and
    through ops.py on the same data in the model layout (B, S, H, hd),
    in turns with SDPA."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import kernel, ops, ref
    gen = torch.Generator(device="cuda").manual_seed(0)
    test_shapes = [(2, 4, 4, 256, 256, 64), (1, 8, 2, 128, 384, 64),
                   (1, 4, 1, 64, 64, 32), (1, 2, 2, 1, 256, 64),
                   (2, 4, 2, 256, 256, 112)]
    cases = ([(s, d, 0, 0.0) for s in test_shapes
              for d in ("float32", "bfloat16")]
             + [((2, 4, 2, 256, 256, 64), "float32", w, c)
                for w, c in ((64, 0.0), (0, 30.0), (32, 50.0))]
             + [((2, 4, 2, 256, 256, hd), "bfloat16", w, c)
                for hd in (64, 112, 128) for w, c in ((64, 0.0), (32, 50.0))]
             + [((2, 4, 2, 100, 100, hd), d, 0, 0.0)
                for hd in (112, 128) for d in ("float32", "bfloat16")]
             + [(SLICE_SHAPE, "bfloat16", 0, 0.0),
                (ZAMBA_ATTN_SHAPE, "bfloat16", 0, 0.0),
                (ZAMBA_ATTN_SHAPE, "bfloat16", 512, 30.0),
                (LONG_SHAPE, "bfloat16", 0, 0.0)])
    timings = {}
    for shape, dtype, window, cap in cases:
        B, H, KV, Sq, Sk, hd = shape
        dt = getattr(torch, dtype)
        q = torch.randn((B, H, Sq, hd), generator=gen, device="cuda").to(dt)
        k = torch.randn((B, KV, Sk, hd), generator=gen, device="cuda").to(dt)
        v = torch.randn((B, KV, Sk, hd), generator=gen, device="cuda").to(dt)

        def run_kernel(q=q, k=k, v=v, window=window, cap=cap):
            return kernel.flash_attention(q, k, v, window=window, softcap=cap)

        def run_plain(q=q, k=k, v=v, window=window, cap=cap):
            return ref.flash_attention_ref(q, k, v, window=window,
                                           softcap=cap)
        got = run_kernel()
        torch.cuda.synchronize()
        want = run_plain()
        tol = FLASH_TOL[dtype]
        err = float((got.float() - want.float()).abs().max())
        ok = bool(torch.allclose(got.float(), want.float(), atol=tol,
                                 rtol=tol))
        print(f"kernel flash_attention (B, H, KV, Sq, Sk, hd) = {shape} "
              f"{dtype} window {window} softcap {cap}: max abs err "
              f"{err:.3e} (atol = rtol = {tol})")
        check(ok and got.dtype == dt, f"flash_attention at {shape} {dtype} "
              f"window {window} softcap {cap} disagrees with its plain "
              f"version: max abs err {err}")
        timed = window == 0 and shape in (SLICE_SHAPE, ZAMBA_ATTN_SHAPE,
                                          LONG_SHAPE)
        if shape == SLICE_SHAPE:   # the same data in the model layout
            qm, km, vm = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            before = kernel.KERNEL.launches
            got_m = ops.flash_attention(qm, km, vm)
            torch.cuda.synchronize()
            same = bool(torch.equal(got_m, got.transpose(1, 2)))
            print(f"  ops.flash_attention on the model layout (B, S, H, hd): "
                  f"one launch {kernel.KERNEL.launches == before + 1}, "
                  f"output contiguous {got_m.is_contiguous()}, equal to the "
                  f"kernel's on (B, H, S, hd): {same}")
            check(same and got_m.is_contiguous()
                  and kernel.KERNEL.launches == before + 1,
                  "ops.flash_attention on the model layout differs from "
                  "the kernel on (B, H, S, hd) or copied its output")
            del got_m
        del got, want
        if timed:
            iters = 50 if shape == SLICE_SHAPE else 10

            def run_sdpa(q=q, k=k, v=v, hd=hd):
                return F.scaled_dot_product_attention(
                    q, k, v, is_causal=True, scale=hd ** -0.5,
                    enable_gqa=True)
            sdpa_err = float((run_sdpa().float()
                              - run_plain().float()).abs().max())
            tm = lambda fn, it=iters: time_ms(torch, fn, iters=it,  # noqa
                                              warmup=3)
            if shape == SLICE_SHAPE:
                def run_model(qm=qm, km=km, vm=vm):
                    return ops.flash_attention(qm, km, vm)
                # in turns: plain, kernel, model layout, SDPA, and back
                p1, k1, m1, l1 = (tm(run_plain, 3), tm(run_kernel),
                                  tm(run_model), tm(run_sdpa))
                l2, m2, k2, p2 = (tm(run_sdpa), tm(run_model),
                                  tm(run_kernel), tm(run_plain, 3))
                m_ms = (m1 + m2) / 2
                model = (f", through ops.py on the model layout {m_ms:.6f} "
                         f"ms ({m1:.6f}, {m2:.6f})")
                del qm, km, vm
            else:
                p1, k1, l1 = tm(run_plain, 3), tm(run_kernel), tm(run_sdpa)
                l2, k2, p2 = tm(run_sdpa), tm(run_kernel), tm(run_plain, 3)
                m_ms, model = None, ""
            own_ms, _, n_rec, _ = device_ms(torch, run_kernel, iters=iters,
                                            name="flash_fwd")
            b_ms, b_by, flops, nbytes = attention_bound(*shape)
            k_ms, p_ms, lib_ms = (k1 + k2) / 2, (p1 + p2) / 2, (l1 + l2) / 2
            timings[shape] = dict(err=err, ms=k_ms, plain_ms=p_ms,
                                  bound_ms=b_ms, bound_by=b_by,
                                  library_ms=lib_ms, model_ms=m_ms)
            share(f"flash_attention {shape}", b_ms, k_ms)
            print(f"  time {shape}: kernel {k_ms:.6f} ms ({k1:.6f}, "
                  f"{k2:.6f}){model}, plain {p_ms:.6f} ms ({p1:.6f}, "
                  f"{p2:.6f}), SDPA {lib_ms:.6f} ms ({l1:.6f}, {l2:.6f}; max "
                  f"abs diff to plain {sdpa_err:.3e}) per call; kernel on "
                  f"the device (profiler, {n_rec} of {iters} launches "
                  f"recorded) {own_ms} ms; bound {b_ms:.6f} ms ({b_by}: "
                  f"{flops} FLOP, {nbytes} bytes), share of bound "
                  f"{b_ms / k_ms:.4f}, {flops / k_ms / 1e9:.1f} TFLOP/s")
        del q, k, v
        torch.cuda.empty_cache()
    b_slice = timings[SLICE_SHAPE]["bound_ms"]
    check(abs(b_slice - 0.139) < 0.0015 and
          timings[SLICE_SHAPE]["bound_by"] == "operations",
          f"bound at the slice's shape {b_slice} ms is not the 0.139 ms "
          "(operations) worked out in the kernel's source note")
    print("clocks/power after timing:",
          nvidia_smi("clocks.sm,power.draw,temperature.gpu"))
    return timings


def profile_serve(torch, cfg, members, prompts, toks, label="serve"):
    """Under torch.profiler: the prefill of every member through
    serve_batch (device busy share, the largest kernels) and one decode
    step of member 0 (busy share, launches)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.serve import serve_batch
    from repro_torch.models import transformer as tf
    from repro_torch.obs.metrics import Stopwatch

    S = prompts.shape[1]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sw = Stopwatch().start()
        serve_batch(cfg, members, prompts, gen_len=1)
        torch.cuda.synchronize()
        wall = sw.stop()
    events = [e for e in prof.key_averages()
              if e.device_type.name == "CUDA" and e.self_device_time_total]
    busy = sum(e.self_device_time_total for e in events) / 1e6
    print(f"{label}: profiled prefill (both members): wall {wall:.6f} s, "
          f"device busy {busy:.6f} s ({busy / wall:.4f} of wall)")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {e.self_device_time_total / 1e3:10.3f} ms  "
              f"{e.count:6d} x  {e.key[:90]}")

    with torch.inference_mode():
        _, cache = tf.forward(members[0], cfg, prompts, mode="prefill",
                              cache_len=S + 2, last_only=True)
        tok = toks[:, :1].contiguous()
        tf.forward(members[0], cfg, tok, mode="decode", cache=cache, t=S)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            sw = Stopwatch().start()
            tf.forward(members[0], cfg, tok, mode="decode", cache=cache,
                       t=S + 1)
            torch.cuda.synchronize()
            wall = sw.stop()
        del cache
    events = [e for e in prof.key_averages()
              if e.device_type.name == "CUDA" and e.self_device_time_total]
    busy = sum(e.self_device_time_total for e in events) / 1e6
    print(f"{label}: profiled decode step (one member): wall {wall:.6f} s, "
          f"device busy {busy:.6f} s ({busy / wall:.4f} of wall), "
          f"{sum(e.count for e in events)} kernel launches")


def _chunk_sizes(S):
    """The chunk sizes a chunked scan could take at length S: the powers
    of two that divide S (1 is the plain recurrence)."""
    return [q for q in (2 ** i for i in range(S.bit_length())) if S % q == 0]


def ssd_cost(Bb, S, nh, hd, ds, elem_bytes):
    """The ssd_scan call's bytes (x, B, C and y in the activation type,
    dt, A_log, D and h_T in fp32, each moved once) and the least
    multiply-add work that computes it, as (fp32-factor FLOP, FLOP whose
    operands are both exact bf16). The work is the chunked form's at the
    chunk size that needs least time (the recurrence, 5 hd ds a (token,
    head), is chunk 1): per chunk and (batch, head) the causal half of
    scores @ x, C h_prev, the state update and its decay, with one fp32
    factor each; per chunk and batch, shared by the heads, the causal half
    of C B^T, exact on the bf16 tensor cores when B and C are bf16. The
    O(hd) terms of a step (exps, decay and dt factors, D x) are left out,
    so the count stays a floor. `fp32_rate` prices the fp32-factor work:
    False (the count the table uses) on the bf16 tensor cores at TERMS
    bf16 terms a product, the split that keeps fp32 accuracy against an
    exact bf16 operand; True (the older count, printed beside it) on the
    fp32 FMA units, one term."""
    nbytes = (elem_bytes * (2 * Bb * S * nh * hd + 2 * Bb * S * ds)
              + 4 * (Bb * S * nh + 2 * nh + Bb * nh * hd * ds))
    out = {}
    for fp32_rate in (False, True):
        best = None
        for Q in _chunk_sizes(S):
            fp32 = Bb * nh * (S // Q) * (Q * (Q + 1) * hd + 4 * Q * hd * ds
                                         + hd * ds)
            cb = Bb * (S // Q) * Q * (Q + 1) * ds
            if elem_bytes != 2:
                fp32, cb = fp32 + cb, 0
            t = _ops_time(fp32, cb, fp32_rate, elem_bytes)
            if best is None or t < best[0]:
                best = (t, fp32, cb)
        out[fp32_rate] = (nbytes, best[1], best[2])
    return out


TERMS = 3       # bf16 terms of an fp32 factor against an exact bf16 operand
TERMS_F32 = 6   # products of 3-term splits of two fp32 factors, i + j <= 2


def _ops_time(fp32, tc, fp32_rate, elem_bytes, terms=TERMS):
    """Seconds of `fp32` fp32-factor FLOP and `tc` exact bf16 FLOP: on the
    fp32 FMA units (fp32_rate, or fp32 activations) or on the bf16 tensor
    cores at `terms` products a multiply-add."""
    if fp32_rate or elem_bytes != 2:
        return fp32 / PEAK_FP32_FLOPS + tc / PEAK_BF16_FLOPS
    return (terms * fp32 + tc) / PEAK_BF16_FLOPS


def wkv_cost(B, S, nh, hd, elem_bytes, with_s0):
    """The wkv_scan call's bytes (r, k, v and y in the activation type,
    logw, u, s0 if given and s_T in fp32) and the least multiply-add work
    that computes it, all with fp32 factors on both sides (r and k are
    scaled by fp32 decays before any product): the chunked form's at the
    chunk size that needs least (the recurrence, 5 hd^2 a (token, head),
    is chunk 1), per chunk and (batch, head) the strictly lower A and A
    v, r_dec s_prev, the state update and its decay. The O(hd) terms of a
    step (exps, decays, the bonus u) are left out, so the count stays a
    floor. Priced as ssd_cost prices it, with TERMS_F32 products a
    multiply-add on the tensor cores."""
    nbytes = (elem_bytes * 4 * B * S * nh * hd
              + 4 * (B * S * nh * hd + nh * hd
                     + (2 if with_s0 else 1) * B * nh * hd * hd))
    flops = min(B * nh * (S // Q) * (2 * Q * (Q - 1) * hd + 4 * Q * hd * hd
                                     + hd * hd) for Q in _chunk_sizes(S))
    return {rate: (nbytes, flops, 0) for rate in (False, True)}


def roofline(nbytes, fp32_flops, tc_flops, fp32_rate, elem_bytes,
             terms=TERMS):
    """(ms, bound_by): the larger of the bytes over the memory rate and
    the operations over the rate of the unit that does them (see
    _ops_time)."""
    t_bytes = nbytes / PEAK_BYTES
    t_ops = _ops_time(fp32_flops, tc_flops, fp32_rate, elem_bytes, terms)
    return 1e3 * max(t_bytes, t_ops), \
        "operations" if t_ops >= t_bytes else "bytes"


def ssd_case(torch, gen, Bb, S, nh, hd, ds, dtype, split=False):
    """Inputs drawn as tests/test_kernels.py draws them; with `split`, B
    and C are views of one (Bb, S, 2 ds) tensor, as ssm_forward passes
    them."""
    F = torch.nn.functional
    n = lambda *s: torch.randn(s, generator=gen, device="cuda")  # noqa
    dt = getattr(torch, dtype)
    B, C = (n(Bb, S, 2 * ds).to(dt).split(ds, dim=-1) if split
            else (n(Bb, S, ds).to(dt), n(Bb, S, ds).to(dt)))
    return (n(Bb, S, nh, hd).to(dt), F.softplus(n(Bb, S, nh)), 0.5 * n(nh),
            B, C, torch.ones(nh, device="cuda"))


def ssd_float64(x, dt, A_log, B, C, D):
    """The ssd recurrence in float64 on the card: y (float64)."""
    import torch
    x, dt, B, C = x.double(), dt.double(), B.double(), C.double()
    A = -A_log.double().exp()
    h = x.new_zeros(x.shape[0], x.shape[2], x.shape[3], B.shape[-1])
    ys = []
    for t in range(x.shape[1]):
        h = h * (dt[:, t] * A).exp()[:, :, None, None] \
            + (dt[:, t, :, None] * x[:, t])[..., None] * B[:, t, None, None]
        ys.append((h * C[:, t, None, None]).sum(-1))
    return torch.stack(ys, 1) + x * D.double()[None, None, :, None]


def wkv_float64(r, k, v, logw, u, s0):
    """The wkv recurrence in float64 on the card: y (float64)."""
    import torch
    r, k, v, w = r.double(), k.double(), v.double(), logw.double()
    s = s0.double() if s0 is not None else r.new_zeros(
        r.shape[0], r.shape[2], r.shape[3], r.shape[3])
    ud = u.double()
    ys = []
    for t in range(r.shape[1]):
        rt, kt, vt = r[:, t], k[:, t], v[:, t]
        ys.append(torch.einsum("bhk,bhkv->bhv", rt, s)
                  + (rt * ud * kt).sum(-1, keepdim=True) * vt)
        s = s * w[:, t].exp()[..., None] + kt[..., None] * vt[:, :, None]
    return torch.stack(ys, 1)


def wkv_case(torch, gen, B, S, nh, hd, dtype, s0=False, logw=None):
    n = lambda *s: torch.randn(s, generator=gen, device="cuda")  # noqa
    dt = getattr(torch, dtype)
    lw = -torch.exp(n(B, S, nh, hd) - 1.0) if logw is None \
        else torch.full((B, S, nh, hd), logw, device="cuda")
    return (n(B, S, nh, hd).to(dt), n(B, S, nh, hd).to(dt),
            n(B, S, nh, hd).to(dt), lw, 0.3 * n(nh, hd),
            0.5 * n(B, nh, hd, hd) if s0 else None)


def scan_phase(torch):
    """ssd_scan and wkv_scan at every case against their plain versions;
    timings at the serving slices' shapes."""
    from repro_torch.kernels.ssd_scan import kernel as sk
    from repro_torch.kernels.ssd_scan import ops as so
    from repro_torch.kernels.ssd_scan import ref as sr
    from repro_torch.kernels.wkv_scan import kernel as wk
    from repro_torch.kernels.wkv_scan import ops as wo
    from repro_torch.kernels.wkv_scan import ref as wr
    from repro_torch.models.rwkv import wkv_chunk_scan
    from repro_torch.models.ssm import ssd_chunk_scan
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = []   # (name, shape, dtype, inputs, kernel fn, plain fn, chunk)
    for shape in [(2, 256, 4, 64, 64, 128), (1, 128, 2, 32, 16, 64),
                  (2, 512, 3, 64, 64, 128), (2, 200, 2, 32, 16, 128),
                  SSD_SLICE + (128,)]:
        for dtype in ("float32", "bfloat16"):
            cases.append(("ssd_scan", shape, dtype, ssd_case(
                torch, gen, *shape[:5], dtype,
                split=shape[:5] == SSD_SLICE)))
    for shape, s0, lw in [((2, 128, 4, 64, 64), False, None),
                          ((1, 256, 2, 32, 64), False, None),
                          ((2, 192, 3, 64, 32), False, None),
                          ((2, 100, 2, 32, 64), False, None),
                          ((2, 128, 2, 32, 64), True, None),
                          ((2, 128, 2, 64, 64), False, -2.0),
                          ((2, 256, 2, 64, 64), True, -8.0),
                          (WKV_SLICE + (64,), True, None)]:
        for dtype in ("float32", "bfloat16"):
            cases.append(("wkv_scan", shape, dtype,
                          wkv_case(torch, gen, *shape[:4], dtype, s0, lw)))
    out = {}
    for name, shape, dtype, inp in cases:
        chunk = shape[-1]
        if name == "ssd_scan":
            def run_kernel(inp=inp, chunk=chunk):
                return so.ssd_scan(*inp, chunk=chunk)

            def run_plain(inp=inp):
                return sr.ssd_scan_ref(*inp)

            def run_chunked(inp=inp):
                return ssd_chunk_scan(*inp)
            lib, kname = sk.KERNEL, "ssd_scan"
        else:
            def run_kernel(inp=inp, chunk=chunk):
                return wo.wkv_scan(*inp[:5], s0=inp[5], chunk=chunk)

            def run_plain(inp=inp):
                return wr.wkv_scan_ref(*inp)

            def run_chunked(inp=inp):
                s0 = inp[5] if inp[5] is not None else torch.zeros(
                    (inp[0].shape[0],) + inp[4].shape + inp[4].shape[-1:],
                    device="cuda")
                return wkv_chunk_scan(*inp[:5], s0)
            lib, kname = wk.KERNEL, "wkv_scan"
        before = lib.launches
        y, st = run_kernel()
        torch.cuda.synchronize()
        check(lib.launches == before + 1, f"{name} did not launch once")
        y0, st0 = run_plain()
        y_err = float((y.float() - y0.float()).abs().max())
        y_rel = y_err / (float(y0.float().abs().max()) + 1e-6)
        s_err = float((st - st0).abs().max())
        ok = (y.dtype == y0.dtype and st.dtype == torch.float32
              and y_rel < SCAN_Y_TOL[dtype]
              and bool(torch.allclose(st, st0, atol=SCAN_STATE_TOL,
                                      rtol=SCAN_STATE_TOL)))
        print(f"kernel {name} {shape} {dtype}: y max abs err {y_err:.3e} "
              f"({y_rel:.3e} of max |y|, limit {SCAN_Y_TOL[dtype]:.3e}); "
              f"state max abs err {s_err:.3e}")
        check(ok, f"{name} at {shape} {dtype} disagrees with its plain "
                  f"version: y {y_rel} of max |y|, state {s_err}")
        check(bool(torch.isfinite(y).all()), f"{name} at {shape} {dtype}: "
              "non-finite y")
        if shape[:-1] in (SSD_SLICE, WKV_SLICE):
            y64 = (ssd_float64 if name == "ssd_scan" else wkv_float64)(*inp)
            f64 = float((y.double() - y64).abs().max() / y64.abs().max())
            p64 = float((y0.double() - y64).abs().max() / y64.abs().max())
            print(f"  {name} {shape[:-1]} {dtype} against a float64 "
                  f"recurrence: y {f64:.3e} of max |y| (the plain version "
                  f"{p64:.3e}{'' if dtype == 'float32' else '; bf16 y'})")
            if dtype == "float32":
                check(f64 <= SCAN_F64_TOL, f"{name} fp32 at the slice "
                      f"shape is {f64} of max |y| from float64, above "
                      f"{SCAN_F64_TOL}")
            del y64
        del y, st, y0, st0
        if dtype == "bfloat16" and shape[:-1] in (SSD_SLICE, WKV_SLICE):
            # in turns: plain, kernel, kernel, plain
            p1, k1, k2, p2 = (time_ms(torch, fn, iters=it, warmup=1)
                              for fn, it in ((run_plain, 3),
                                             (run_kernel, 20),
                                             (run_kernel, 20),
                                             (run_plain, 3)))
            c_ms = time_ms(torch, run_chunked, iters=5, warmup=1)
            own_ms, _, n_rec, parts = device_ms(torch, run_kernel,
                                                iters=10, name=kname)
            if name == "ssd_scan":
                counts, terms = ssd_cost(*shape[:5], 2), TERMS
            else:
                counts = wkv_cost(*shape[:4], 2, inp[5] is not None)
                terms = TERMS_F32
            nbytes, flops, tc_flops = counts[False]
            b_ms, b_by = roofline(*counts[False], False, 2, terms)
            o_ms, o_by = roofline(*counts[True], True, 2)
            k_ms, p_ms = (k1 + k2) / 2, (p1 + p2) / 2
            share(f"{name} {shape[:-1]}", b_ms, k_ms)
            out[name] = dict(err=y_err, ms=k_ms, plain_ms=p_ms,
                             chunked_ms=c_ms, bound_ms=b_ms, bound_by=b_by,
                             device_ms=own_ms)
            print(f"  time {name} {shape[:-1]} bf16: kernel {k_ms:.6f} ms "
                  f"({k1:.6f}, {k2:.6f}), plain {p_ms:.6f} ms ({p1:.6f}, "
                  f"{p2:.6f}), chunked PyTorch copy {c_ms:.6f} ms per call;"
                  f" kernels on the device (profiler, {n_rec} launches of "
                  f"them recorded over 10 calls) {own_ms} ms a call; bound "
                  f"{b_ms:.6f} ms ({b_by}: {flops} fp32-factor FLOP at "
                  f"{terms} bf16 products each and {tc_flops} exact bf16 "
                  f"FLOP on the tensor cores, {nbytes} bytes; the "
                  f"count with the fp32 factors on the FMA units "
                  f"{o_ms:.6f} ms, {o_by}: {counts[True][1]} fp32 FLOP), "
                  f"share of bound {b_ms / k_ms:.4f}, "
                  f"{(flops + tc_flops) / k_ms / 1e9:.2f} TFLOP/s of the "
                  "least work; no single PyTorch call "
                  "computes this function (library: none)")
            for key, ms in parts.items():
                print(f"    {ms:.6f} ms a launch  {key[:90]}")
        del inp
        torch.cuda.empty_cache()
    print("clocks/power after timing:",
          nvidia_smi("clocks.sm,power.draw,temperature.gpu"))
    return out


WKV_GRADS = ("dr", "dk", "dv", "dlogw", "du", "ds0")
WKV_BWD_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}  # of each max |g|
WKV_BWD_F32_TOL = 1e-5   # fp32 gradients (dlogw, du, ds0) in both dtypes
WKV_BWD_CHECK = (2, 512, 4, 64)
WKV_MB = (2, 2048, 40, 64)   # a rwkv6-3b training microbatch: 4 rows in 2


def wkv_bwd_cost(B, S, nh, hd, elem_bytes):
    """The backward's bytes and least work, as wkv_cost counts the
    forward's: r, k, v and dy read and dr, dk, dv written in the
    activation type, logw read and dlogw written in fp32, u and du (the
    model's case: no s0, no gradient on s_T; the forward's chunk states
    are the kernel's own choice and not counted). The least work is the
    chunked form's backward: each product of the forward's least work
    (wkv_cost) takes two products backward, so twice its FLOP, all with
    fp32 factors."""
    nbytes = (elem_bytes * 7 * B * S * nh * hd
              + 4 * (2 * B * S * nh * hd + 2 * nh * hd))
    flops = 2 * wkv_cost(B, S, nh, hd, elem_bytes, False)[False][1]
    return {rate: (nbytes, flops, 0) for rate in (False, True)}


def wkv_grads_float64(torch, r, k, v, logw, u, s0, dy, dsT):
    """torch.autograd of the wkv recurrence in float64 on the card: the
    gradients of sum(y dy) + sum(s_T dsT) with respect to r, k, v, logw,
    u, s0."""
    ins = [a.detach().double().requires_grad_() for a in
           (r, k, v, logw, u, s0)]
    rd, kd, vd, wd, ud, s = ins
    ys = []
    for t in range(rd.shape[1]):
        rt, kt, vt = rd[:, t], kd[:, t], vd[:, t]
        ys.append(torch.einsum("bhk,bhkv->bhv", rt, s)
                  + (rt * ud * kt).sum(-1, keepdim=True) * vt)
        s = s * wd[:, t].exp()[..., None] + kt[..., None] * vt[:, :, None]
    loss = (torch.stack(ys, 1) * dy.double()).sum() \
        + (s * dsT.double()).sum()
    return torch.autograd.grad(loss, ins)


def _grad_errs(got, want):
    """Each gradient's max abs error over its largest |entry|."""
    return {n: float((g.double() - w.double()).abs().max()
                     / w.double().abs().max().clamp_min(1e-30))
            for n, g, w in zip(WKV_GRADS, got, want) if w is not None}


def _hold_grads(errs, dtype, what):
    """dr, dk, dv within WKV_BWD_TOL of each max |g| in their dtype, the
    fp32 gradients (dlogw, du, ds0 where given) within WKV_BWD_F32_TOL."""
    check(all(errs[n] <= WKV_BWD_TOL[dtype] for n in WKV_GRADS[:3])
          and all(e <= WKV_BWD_F32_TOL for n, e in errs.items()
                  if n in WKV_GRADS[3:]),
          f"wkv_scan_bwd at {what} disagrees with its plain version: {errs}")


def wkv_bwd_phase(torch):
    """The wkv_scan backward kernel against its plain version (and, at
    the check shape, autograd of a float64 recurrence), through
    ops.wkv_scan's autograd Function; timed at the training shape."""
    import torch.nn.functional as F

    from repro_torch.kernels.wkv_scan import kernel as wk
    from repro_torch.kernels.wkv_scan import ops as wo
    from repro_torch.kernels.wkv_scan import ref as wr
    gen = torch.Generator(device="cuda").manual_seed(1)
    out = {}
    cases = [(WKV_BWD_CHECK, d, None) for d in ("float32", "bfloat16")] + [
        ((2, 256, 2, 64), "float32", -2.0),
        ((2, 256, 2, 64), "float32", -8.0),
        ((2, 256, 2, 64), "bfloat16", -8.0),
        ((2, 100, 2, 32), "float32", None)]
    for shape, dtype, lw in cases:
        r, k, v, logw, u, s0 = wkv_case(torch, gen, *shape, dtype, True, lw)
        dy = torch.randn(r.shape, generator=gen, device="cuda").to(r.dtype)
        dsT = torch.randn(s0.shape, generator=gen, device="cuda")
        ins = [a.clone().requires_grad_() for a in (r, k, v, logw, u, s0)]
        fwd, bwd = wk.KERNEL.launches, wk.KERNEL_BWD.launches
        y, sT = wo.wkv_scan(*ins)
        got = torch.autograd.grad([y, sT], ins, [dy, dsT])
        torch.cuda.synchronize()
        check(wk.KERNEL.launches == fwd + 1
              and wk.KERNEL_BWD.launches == bwd + 1,
              f"wkv_scan_bwd at {shape} {dtype}: the forward and backward "
              "kernels did not launch once each")
        pad = (-shape[1]) % 64
        p = [F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (r, k, v, logw, dy)]
        want = list(wr.wkv_scan_bwd_ref(*p[:4], u, s0, p[4], dsT))
        want[:4] = [w[:, :shape[1]] for w in want[:4]]
        errs = _grad_errs(got, want)
        finite = all(bool(torch.isfinite(g).all()) for g in got)
        line = (f"kernel wkv_scan_bwd {shape} {dtype}"
                f"{'' if lw is None else f' logw = {lw}'}, s0 and d s_T: "
                f"against the plain backward "
                + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
                + f" of each max |g|; finite {finite}")
        if shape == WKV_BWD_CHECK:
            e64 = _grad_errs(got, wkv_grads_float64(
                torch, r, k, v, logw, u, s0, dy, dsT))
            line += ("; against autograd of a float64 recurrence "
                     + ", ".join(f"{n} {e:.3e}" for n, e in e64.items()))
            if dtype == "float32":
                check(max(e64.values()) <= WKV_BWD_F32_TOL,
                      f"wkv_scan_bwd fp32 is {e64} from float64")
        print(line)
        check(finite, f"wkv_scan_bwd at {shape} {dtype} logw {lw}: "
                      "non-finite gradients")
        _hold_grads(errs, dtype, f"{shape} {dtype} logw {lw}")
        out["err"] = max(out.get("err", 0.0), max(
            float((g.float() - w.float()).abs().max())
            for g, w in zip(got, want)))
        del ins, y, sT, got, want, p
    # the training shapes, as a layer calls the scan: bf16, no s0, and s_T
    # unused, so the kernel gets no d s_T and makes no ds0
    draws = {}
    for shape in (WKV_MB, WKV_SLICE):
        r, k, v, logw, u, _ = wkv_case(torch, gen, *shape, "bfloat16")
        dy = torch.randn(r.shape, generator=gen, device="cuda").to(r.dtype)
        draws[shape] = (r, k, v, logw, u, dy)
        ins = [a.clone().requires_grad_() for a in (r, k, v, logw, u)]
        fwd, bwd = wk.KERNEL.launches, wk.KERNEL_BWD.launches
        y, _ = wo.wkv_scan(*ins)
        got = torch.autograd.grad(y, ins, dy)
        torch.cuda.synchronize()
        check(wk.KERNEL.launches == fwd + 1
              and wk.KERNEL_BWD.launches == bwd + 1,
              f"wkv_scan_bwd at {shape}: the forward and backward kernels "
              "did not launch once each")
        want = wr.wkv_scan_bwd_ref(r, k, v, logw, u, None, dy)
        errs = _grad_errs(got, want)
        finite = all(bool(torch.isfinite(g).all()) for g in got)
        print(f"kernel wkv_scan_bwd {shape} bfloat16 as a layer calls it "
              "(no s0, no d s_T): against the plain backward "
              + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
              + f" of each max |g|; finite {finite}")
        check(finite, f"wkv_scan_bwd at {shape}: non-finite gradients")
        _hold_grads(errs, "bfloat16", f"{shape} as a layer calls it")
        out["err"] = max(out["err"], max(
            float((g.float() - w.float()).abs().max())
            for g, w in zip(got, want)))
        del ins, y, got, want
    # timed at both training shapes on their draws, in turns against the
    # plain backward; at WKV_MB two calls must give the same bits
    for shape in (WKV_MB, WKV_SLICE):
        r, k, v, logw, u, dy = draws.pop(shape)
        _, _, states = wk.wkv_scan_fwd(r, k, v, logw, u)

        def run_kernel():
            return wk.wkv_scan_bwd(r, k, v, logw, u, states, dy, None,
                                   want_ds0=False)

        def run_plain():
            return wr.wkv_scan_bwd_ref(r, k, v, logw, u, None, dy)
        if shape == WKV_MB:
            first, second = run_kernel()[:5], run_kernel()[:5]
            same = [n for n, a, b in zip(WKV_GRADS, first, second)
                    if torch.equal(a, b)]
            print(f"kernel wkv_scan_bwd {shape}: two calls bitwise equal in "
                  f"{same} of {list(WKV_GRADS[:5])}")
            check(len(same) == 5, f"wkv_scan_bwd at {shape} is not "
                  f"deterministic: only {same} agree bitwise")
            del first, second
        p1, k1, k2, p2 = (time_ms(torch, fn, iters=it, warmup=1)
                          for fn, it in ((run_plain, 1), (run_kernel, 10),
                                         (run_kernel, 10), (run_plain, 1)))
        own_ms, _, n_rec, parts = device_ms(torch, run_kernel, iters=5,
                                            name="wkv_scan_bwd")
        counts = wkv_bwd_cost(*shape, 2)
        b_ms, b_by = roofline(*counts[False], False, 2, TERMS_F32)
        k_ms, p_ms = (k1 + k2) / 2, (p1 + p2) / 2
        share(f"wkv_scan_bwd {shape}", b_ms, k_ms)
        nbytes, flops, _ = counts[False]
        print(f"  time wkv_scan_bwd {shape} bf16 (no s0, no d s_T): kernel "
              f"{k_ms:.6f} ms ({k1:.6f}, {k2:.6f}), plain {p_ms:.6f} ms "
              f"({p1:.6f}, {p2:.6f}) per call; on the device (profiler, "
              f"{n_rec} launches recorded over 5 calls) {own_ms} ms a call; "
              f"bound {b_ms:.6f} ms ({b_by}: {nbytes} bytes, {flops} "
              f"fp32-factor FLOP at {TERMS_F32} bf16 products each), share "
              f"{b_ms / k_ms:.4f}; no single PyTorch call computes this "
              "function (library: none)")
        for key, ms in parts.items():
            print(f"    {ms:.6f} ms a launch  {key[:90]}")
        if shape == WKV_SLICE:
            out.update(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                       device_ms=own_ms)
        del r, k, v, logw, u, dy, states
        torch.cuda.empty_cache()
    return out


TRAIN_CHECK = {"steps": 10, "batch": 4, "seq": 64, "seed": 0, "lr": 3e-4}
TRAIN_LOSS_RTOL = 1e-5     # card against CPU, fp32 smoke losses
TRAIN_GRAD_TOL = 1e-4      # card against CPU, each parameter's first-step
                           # gradient, of its max |g|
TRAIN_FULL = {"steps": 6, "batch": 4, "seq": 2048, "microbatches": 2,
              "seed": 0}
TRAINS = ("qwen2.5-3b", "rwkv6-3b")


def smoke_train(torch, arch, device):
    """The smoke `arch` in fp32 on `device` from parameters drawn on the
    CPU (as train() draws them): the first batch's gradients (on the
    CPU, by name), then TRAIN_CHECK's adamw steps as train() takes them
    (weight decay 0.01, warmup_cosine over 10 steps) on the same
    TokenPipeline batches; returns (grads, losses)."""
    from repro_torch.configs import get_smoke
    from repro_torch.data import TokenPipeline
    from repro_torch.launch import steps as steps_mod
    from repro_torch.models import transformer as tf
    from repro_torch.models.common import cross_entropy
    from repro_torch.optim import make_optimizer, warmup_cosine
    c = TRAIN_CHECK
    cfg = get_smoke(arch).replace(dtype="float32")
    params = tf.init_params(cfg, torch.Generator().manual_seed(c["seed"]))
    params = params.to(device)
    pipe = TokenPipeline(cfg.vocab, c["batch"], c["seq"], seed=c["seed"])
    batches = [{k: torch.as_tensor(hb[k], device=device)
                for k in ("tokens", "labels")}
               for hb, _ in zip(pipe, range(c["steps"]))]
    named = dict(params.named_parameters())
    logits, _ = tf.forward(params, cfg, batches[0]["tokens"], mode="train")
    loss = cross_entropy(logits, batches[0]["labels"],
                         cfg.final_logit_softcap)
    grads = {n: torch.zeros(p.shape) if g is None else g.detach().cpu()
             for (n, p), g in zip(named.items(), torch.autograd.grad(
                 loss, list(named.values()), allow_unused=True))}
    opt = make_optimizer("adamw", weight_decay=0.01)
    state = opt.init(named)
    step_fn = steps_mod.make_train_step(cfg, opt, warmup_cosine(
        c["lr"], warmup=max(10, c["steps"] // 20), total_steps=c["steps"]))
    losses = [float(step_fn(params, state, b)) for b in batches]
    return grads, losses


def _train_gaps(card, cpu):
    """(largest relative loss gap, largest gradient gap of its parameter's
    max |g|, that parameter's name) between two smoke_train results."""
    (g1, l1), (g2, l2) = card, cpu
    rel = max(abs(a - b) / abs(b) for a, b in zip(l1, l2))
    gerr = {n: float((g1[n].double() - g2[n].double()).abs().max()
                     / g2[n].double().abs().max().clamp_min(1e-30))
            for n in g2}
    worst = max(gerr, key=gerr.get)
    return rel, gerr[worst], worst


def _zero_dk(torch, wo):
    """A planted fault: the wkv backward's dk replaced by zeros. Returns
    the function that undoes it."""
    orig = wo._WkvScan.backward

    def backward(ctx, dy, dsT):
        grads = list(orig(ctx, dy, dsT))
        grads[1] = torch.zeros_like(grads[1])
        return tuple(grads)
    wo._WkvScan.backward = staticmethod(backward)
    return lambda: setattr(wo._WkvScan, "backward", staticmethod(orig))


def train_check_phase(torch):
    """Smoke qwen2.5-3b and rwkv6-3b training in fp32, on the card (the
    wkv kernels forward and backward) and on the CPU (plain versions)
    from the same parameters and batches: first-step gradients and the
    losses agree, the card's loss falls, and every rwkv6 layer's scan
    went through both wkv kernels. Then the same card run with a planted
    fault (the wkv backward's dk zeroed) must fail the gradient check."""
    from repro_torch.configs import get_smoke
    from repro_torch.kernels.wkv_scan import kernel as wk
    from repro_torch.kernels.wkv_scan import ops as wo
    c = TRAIN_CHECK
    for arch in TRAINS:
        fwd, bwd = wk.KERNEL.launches, wk.KERNEL_BWD.launches
        on_card = smoke_train(torch, arch, "cuda")
        fwd, bwd = wk.KERNEL.launches - fwd, wk.KERNEL_BWD.launches - bwd
        on_cpu = smoke_train(torch, arch, "cpu")
        rel, gerr, worst = _train_gaps(on_card, on_cpu)
        losses = on_card[1]
        print(f"train check {arch} smoke fp32, {c}: card losses {losses}, "
              f"CPU {on_cpu[1]}; max relative loss difference {rel:.3e} "
              f"(limit {TRAIN_LOSS_RTOL}); largest first-step gradient "
              f"difference {gerr:.3e} of its max |g| ({worst}; limit "
              f"{TRAIN_GRAD_TOL}); wkv_scan launches {fwd}, wkv_scan_bwd "
              f"{bwd}")
        check(rel <= TRAIN_LOSS_RTOL, f"{arch}: card and CPU training "
              f"losses differ by {rel} relative")
        check(gerr <= TRAIN_GRAD_TOL, f"{arch}: card and CPU gradients of "
              f"{worst} differ by {gerr} of its max |g|")
        check(losses[-1] < losses[0], f"{arch}: the card's loss did not "
              f"fall: {losses}")
        cfg = get_smoke(arch)
        if cfg.family == "ssm":   # one gradient pass and `steps` steps
            per = cfg.n_layers * (c["steps"] + 1)
            check(fwd == 2 * per and bwd == per, f"{arch}: wkv launches "
                  f"{fwd} / {bwd}, expected {2 * per} / {per}")
            undo = _zero_dk(torch, wo)
            try:
                f_rel, f_gerr, f_worst = _train_gaps(
                    smoke_train(torch, arch, "cuda"), on_cpu)
            finally:
                undo()
            print(f"train check {arch} with a planted fault (dk of the wkv "
                  f"backward zeroed): loss difference {f_rel:.3e}, "
                  f"gradient difference {f_gerr:.3e} ({f_worst})")
            check(f_gerr > TRAIN_GRAD_TOL, f"{arch}: the gradient check "
                  "did not see the planted fault")


def full_train_phase(torch, arch):
    """train() of `arch` at full width and depth on the card: adamw and
    warmup_cosine, batch 4 x 2048 in 2 microbatches, 6 steps from seed
    0; then one more step (a fresh adamw state) under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data import TokenPipeline
    from repro_torch.kernels.wkv_scan import kernel as wk
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch.train import scaled_config, train
    from repro_torch.optim import make_optimizer, warmup_cosine
    c = TRAIN_FULL
    cfg = scaled_config(arch, "full")
    print(f"train {arch} config:", json.dumps({"train": dict(c, arch=arch),
          "model": {k: getattr(cfg, k) for k in (
              "family", "n_layers", "d_model", "n_heads", "n_kv_heads",
              "head_dim", "d_ff", "vocab", "rwkv_head_dim", "attn_impl",
              "attn_chunk", "dtype", "source")}}, allow_nan=False))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    wk.KERNEL.launches = wk.KERNEL_BWD.launches = 0
    params, losses, cfg, secs = train(
        arch, "full", steps=c["steps"], batch=c["batch"], seq=c["seq"],
        seed=c["seed"], microbatches=c["microbatches"], log_every=1,
        device="cuda")
    fwd, bwd = wk.KERNEL.launches, wk.KERNEL_BWD.launches
    peak = torch.cuda.max_memory_allocated()
    n_par = sum(p.numel() for p in params.parameters())
    tok = c["batch"] * c["seq"]
    later = secs[1:]
    print(f"train {arch}: {n_par} parameters; losses {losses}; step "
          f"seconds {secs}; steps 2-"
          f"{c['steps']}: {sum(later) / len(later):.6f} s a step, "
          f"{tok * len(later) / sum(later):.1f} tokens/s; peak device "
          f"memory {peak} bytes ({peak / 2**30:.2f} GiB); wkv_scan / "
          f"wkv_scan_bwd launches {fwd} / {bwd} in {c['steps']} steps")
    check(all(map(math.isfinite, losses)),
          f"{arch}: non-finite training losses {losses}")
    n_mb = c["microbatches"]
    if cfg.family == "ssm":
        want = (2 * cfg.n_layers * n_mb, cfg.n_layers * n_mb)
        check((fwd, bwd) == (c["steps"] * want[0], c["steps"] * want[1]),
              f"{arch}: wkv launches {fwd} / {bwd} in {c['steps']} steps, "
              f"expected {want} a step (n_layers x microbatches x 2 "
              "forward, one under the checkpoint's recompute, and n_layers "
              "x microbatches backward)")
    # one more step under the profiler, by kernel name
    opt = make_optimizer("adamw", weight_decay=0.01)
    state = opt.init(dict(params.named_parameters()))
    step_fn = steps_mod.make_train_step(cfg, opt, warmup_cosine(3e-4, 1, 2),
                                        microbatches=n_mb)
    hb = next(iter(TokenPipeline(cfg.vocab, c["batch"], c["seq"], seed=1)))
    b = {k: torch.as_tensor(hb[k], device="cuda") for k in ("tokens",
                                                            "labels")}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        float(step_fn(params, state, b))
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type.name == "CUDA" and e.self_device_time_total]
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    print(f"train {arch}: one profiled step: device busy {busy:.6f} s, "
          f"{sum(e.count for e in kernels)} kernel launches; by kernel:")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"  {e.self_device_time_total / 1e3:10.3f} ms  "
              f"{e.count:6d} x  {e.key[:90]}")
    del params, state, opt, step_fn, b, prof
    torch.cuda.empty_cache()
    return {"fwd": fwd, "bwd": bwd, "losses": losses}


def select_determinism(engine):
    """Two select() calls on the same engine state: identical
    populations, objectives and winners for every client."""
    import numpy as np
    a, b = engine.select(), engine.select()
    keys = ("pop", "objs", "chromosome")
    differ = sorted(c for c in a if not all(
        np.array_equal(a[c][k], b[c][k]) for k in keys))
    gap = max(float(np.abs(a[c]["objs"] - b[c]["objs"]).max()) for c in a)
    print(f"select() twice on the same state: populations, objectives and "
          f"winners identical for {len(a) - len(differ)} of {len(a)} "
          f"clients; differing clients {differ}; max objective gap {gap:.3e}")
    check(not differ, f"select() is not deterministic on the card: clients "
                      f"{differ} differ, objective gap {gap}")


def _tree_err(a, b):
    """Largest |a - b| over matching tensors of two caches."""
    if isinstance(a, dict):
        return max(_tree_err(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return max(_tree_err(x, y) for x, y in zip(a, b))
    return float((a.float().cpu() - b.float().cpu()).abs().max())


def model_check_phase(torch):
    """Smoke rwkv6-3b and zamba2-7b in fp32: the same weights give the
    same prefill on the card (kernels) as on the CPU (plain versions)."""
    import numpy as np

    from repro_torch.configs import get_smoke
    from repro_torch.models import transformer as tf
    for arch in ("rwkv6-3b", "zamba2-7b"):
        cfg = get_smoke(arch).replace(dtype="float32")
        cpu = tf.init_params(cfg, torch.Generator().manual_seed(3))
        card = copy.deepcopy(cpu).to("cuda")
        toks = np.random.default_rng(4).integers(
            0, cfg.vocab, (2, 200)).astype(np.int32)
        with torch.inference_mode():
            want, wc = tf.forward(cpu, cfg, torch.as_tensor(toks),
                                  mode="prefill")
            got, c = tf.forward(card, cfg, torch.as_tensor(toks,
                                                           device="cuda"),
                                mode="prefill")
        torch.cuda.synchronize()
        ok = bool(torch.allclose(got.cpu(), want, atol=3e-4, rtol=1e-3))
        err = float((got.cpu() - want).abs().max())
        c_err = _tree_err(c, wc)
        print(f"model check {arch} smoke fp32, S = 200: card vs CPU prefill "
              f"logits max abs diff {err:.3e}, states {c_err:.3e}")
        check(ok and c_err < 1e-3, f"{arch}: card and CPU prefill disagree "
                                   f"(logits {err}, states {c_err})")


def serve_phase(torch, arch, overrides, kname):
    """Two full-width members of `arch` served through serve_batch; every
    prefill layer of the family runs kernel `kname`."""
    import importlib

    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.launch.serve import serve_batch
    from repro_torch.models import transformer as tf
    from repro_torch.obs.metrics import Stopwatch

    kernel = importlib.import_module(f"repro_torch.kernels.{kname}.kernel")
    cfg = get_config(arch).replace(**overrides)
    B, S, G = SERVE["batch"], SERVE["prompt_len"], SERVE["gen_len"]
    torch.cuda.empty_cache()
    print(f"serve {arch} config:", json.dumps({
        "serve": dict(SERVE, arch=arch, **overrides), "model": {
            k: getattr(cfg, k) for k in (
                "family", "n_layers", "d_model", "n_heads", "n_kv_heads",
                "head_dim", "d_ff", "vocab", "ssm_state", "ssm_head_dim",
                "shared_attn_every", "n_shared_attn", "rwkv_head_dim",
                "attn_impl", "dtype", "source")}}, allow_nan=False))
    sw = Stopwatch().start()
    members = [tf.init_params(cfg, torch.Generator(device="cuda")
                              .manual_seed(seed)) for seed in SERVE["seeds"]]
    torch.cuda.synchronize()
    n_par = sum(p.numel() for p in members[0].parameters())
    print(f"serve {arch}: {len(members)} members of {n_par} parameters "
          f"initialised on the card in {sw.stop():.3f} s")
    prompts = torch.as_tensor(next(iter(TokenPipeline(
        cfg.vocab, B, S, seed=0)))["tokens"], device="cuda")
    serve_batch(cfg, members, prompts, gen_len=2)      # warm-up
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    kernel.KERNEL.launches = 0
    sw = Stopwatch().start()
    toks = serve_batch(cfg, members, prompts, gen_len=G)
    torch.cuda.synchronize()
    total = sw.stop()
    launches = kernel.KERNEL.launches
    peak = torch.cuda.max_memory_allocated()
    expect = cfg.n_layers * len(members)
    print(f"serve {arch}: {kname} launches {launches}, expected n_layers x "
          f"members = {expect}")
    check(launches == expect, f"{kname} launched {launches} times in "
                              f"serve_batch of {arch}, expected {expect}")
    check(tuple(toks.shape) == (B, G) and toks.dtype == torch.int32
          and int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab,
          f"bad served tokens: shape {tuple(toks.shape)}, range "
          f"[{int(toks.min())}, {int(toks.max())}]")

    sw = Stopwatch().start()
    serve_batch(cfg, members, prompts, gen_len=1)       # prefill only
    torch.cuda.synchronize()
    prefill = sw.stop()
    decode_tps = B * (G - 1) / (total - prefill)
    print(f"serve {arch}: {B} x {S} prompts, {G} tokens: serve_batch "
          f"{total:.6f} s; prefill (gen_len 1) {prefill:.6f} s "
          f"({B * S * len(members) / prefill:.1f} prompt tokens/s over both "
          f"members); decode {total - prefill:.6f} s, {decode_tps:.3f} "
          f"generated tokens/s; peak device memory {peak} bytes "
          f"({peak / 2**30:.2f} GiB)")
    print(f"serve {arch}: tokens", toks.cpu().tolist())

    solo = serve_batch(cfg, members[:1], prompts, gen_len=G)
    masked = serve_batch(cfg, members, prompts, gen_len=G,
                         weights=[1.0, 0.0])
    same = bool(torch.equal(solo, masked))
    print(f"serve {arch}: weights [1, 0] == member 0 alone: {same}")
    check(same, f"{arch}: serve_batch with weights [1, 0] differs from "
                "member 0 served alone")
    profile_serve(torch, cfg, members, prompts, toks, f"serve {arch}")

    finite = True
    with torch.inference_mode():
        for m in members:
            logits, cache = tf.forward(m, cfg, prompts, mode="prefill",
                                       cache_len=S + 1, last_only=True)
            step, _ = tf.forward(m, cfg, toks[:, :1].contiguous(),
                                 mode="decode", cache=cache, t=S)
            finite &= bool(torch.isfinite(logits).all()) \
                and bool(torch.isfinite(step).all())
            del logits, cache, step
    print(f"serve {arch}: every last-position prefill logit and decode-step "
          f"logit of both members finite: {finite}")
    check(finite, f"{arch}: non-finite logits")

    if cfg.attn_impl == "pallas":
        with torch.inference_mode():
            probs = {}
            for impl in ("pallas", "xla"):
                logits, _ = tf.forward(members[0],
                                       cfg.replace(attn_impl=impl), prompts,
                                       last_only=True)
                probs[impl] = torch.softmax(logits[:, -1].float(), dim=-1)
            gap = float((probs["pallas"] - probs["xla"]).abs().max())
            agree = bool(torch.equal(probs["pallas"].argmax(-1),
                                     probs["xla"].argmax(-1)))
        print(f"serve {arch}: member 0 last-position probabilities, pallas "
              f"vs xla prefill: max abs diff {gap:.3e} (largest probability "
              f"{float(probs['xla'].max()):.3e}); same argmax: {agree}")
        check(gap < 1e-2, f"pallas and xla prefill disagree: {gap}")
    del members, solo, masked, prompts
    torch.cuda.empty_cache()
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels._build import build_all
    from repro_torch.kernels.ensemble_fitness import kernel
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    from repro_torch.kernels.wkv_scan import kernel as wkv_kernel

    print(nvidia_smi("name,power.limit"))
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; device "
          f"{name!r}, count {count}")
    libs = [kernel.KERNEL, fa_kernel.KERNEL, ssd_kernel.KERNEL,
            wkv_kernel.KERNEL, wkv_kernel.KERNEL_BWD]
    build_all(libs)
    for lib in libs:
        built = "built" if lib.build_seconds is not None \
            else "loaded an earlier build"
        print(f"{lib.name}: {built} in {lib.build_seconds} s from "
              f"{lib.source.relative_to(ROOT)}")
        for line in lib.ptxas.splitlines():
            if "registers" in line or "Compiling entry" in line:
                print("  ptxas:", line.strip())

    max_err, timings = kernel_phase(torch)
    launches, n_select = slice_phase(torch)
    torch.cuda.empty_cache()
    flash = flash_phase(torch)[SLICE_SHAPE]
    scans = scan_phase(torch)
    bwd = wkv_bwd_phase(torch)
    model_check_phase(torch)
    train_check_phase(torch)
    served = {kname: serve_phase(torch, arch, overrides, kname)
              for arch, overrides, kname in SERVES}
    trained = {arch: full_train_phase(torch, arch) for arch in TRAINS}
    check(trained["rwkv6-3b"]["bwd"] > 0, "wkv_scan_bwd did not launch in "
          "rwkv6-3b training")

    k_ms, p_ms, b_ms, b_by = timings[("batched", 32, 200, 100)]
    print(f"shares of bound (every one <= {SHARE_MAX}):",
          json.dumps({k: round(v, 6) for k, v in SHARES.items()}))
    print(json.dumps({"kernels": [{
        "name": "ensemble_fitness", "route": "cuda",
        "source": "src/repro_torch/csrc/ensemble_fitness.cu",
        "replaces": "src/repro/kernels/ensemble_fitness/kernel.py:109",
        "launches": launches, "max_abs_err": max_err, "ms": k_ms,
        "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None}, {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:103",
        "launches": served["flash_attention"], "max_abs_err": flash["err"],
        "ms": flash["ms"], "plain_ms": flash["plain_ms"],
        "bound_ms": flash["bound_ms"], "bound_by": flash["bound_by"],
        "library_ms": flash["library_ms"]}] + [{
        "name": kname, "route": "cuda",
        "source": f"src/repro_torch/csrc/{kname}.cu",
        "replaces": f"src/repro/kernels/{kname}/kernel.py:{line}",
        "launches": served[kname],
        "max_abs_err": scans[kname]["err"], "ms": scans[kname]["ms"],
        "plain_ms": scans[kname]["plain_ms"],
        "bound_ms": scans[kname]["bound_ms"],
        "bound_by": scans[kname]["bound_by"], "library_ms": None}
        for kname, line in (("ssd_scan", 88), ("wkv_scan", 76))] + [{
        "name": "wkv_scan_bwd", "route": "cuda",
        "source": "src/repro_torch/csrc/wkv_scan_bwd.cu",
        "replaces": "src/repro/models/rwkv.py:64 (no TPU kernel: jax.grad "
                    "of wkv_chunk_scan)",
        "launches": trained["rwkv6-3b"]["bwd"], "max_abs_err": bwd["err"],
        "ms": bwd["ms"], "plain_ms": bwd["plain_ms"],
        "bound_ms": bwd["bound_ms"], "bound_by": bwd["bound_by"],
        "library_ms": None}]}, allow_nan=False))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}},
        allow_nan=False))
    return 0


if __name__ == "__main__":
    sys.exit(main())
