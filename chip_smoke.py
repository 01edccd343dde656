#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Device: the card's name and power limit (nvidia-smi), the torch
   device name and count.
2. Build: compiles `src/repro_torch/csrc/ensemble_fitness.cu` and
   `src/repro_torch/csrc/flash_attention.cu` with nvcc for sm_90a, one
   nvcc each, started together, and prints each build's seconds and
   ptxas register / shared-memory report.
3. Kernel: both entry points of ensemble_fitness at the main path's
   shapes and at edge shapes, each held against its plain PyTorch
   version (max abs error <= 1e-5), and timed with CUDA events against
   the plain version (in turns: plain, kernel, kernel, plain), with the
   kernel's device time from torch.profiler beside it.
4. Slice: the paper's synchronous configuration (configs/paper_cnn.py,
   full=True: 20 clients, 5 CNN families, width 16, 10 classes, 60000
   synthetic 10x10x3 images, Dirichlet 0.1, NSGA-II 100 x 100, k = 5)
   with local training cut from 60 epochs to 2; selection scores every
   population through the kernel.
   The launch count is reset just before the run and must come out at
   2 * generations + 1 per selection.
5. Kernel: flash_attention at the reference's test shapes and variants,
   a ragged S = 100, the serving slice's shape (4, 32, 8, 2048, 2048,
   128) and the long-context shape (1, 32, 8, 8192, 8192, 128), bf16
   causal, each held against its plain version on the card (fp32 atol =
   rtol = 2e-5, bf16 2e-2, as tests/test_kernels.py:70,83). At the last
   two shapes: timed in turns against the plain version, the kernel's
   device time from torch.profiler, scaled_dot_product_attention timed as
   the library yardstick (never called by the port), and the bound.
6. Serve: FedPAE soft-vote serving (`launch/serve.py::serve_batch`) of
   two full-width llama3-8b members (32 layers, bf16, attn_impl="pallas",
   random weights from seeds 0 and 1) on 4 x 2048-token prompts, 16
   generated tokens. The flash launch count is reset just before the run
   and must come out at n_layers x members = 64; the tokens must be
   (4, 16) and inside the vocabulary; weights [1, 0] must give member
   0's own tokens. Reports prefill seconds, decode tokens/s, peak memory,
   the device's busy share of the prefill and of one decode step (with
   that step's launches), and the pallas-vs-xla gap of member 0's
   last-position probabilities.
7. The `kernels` JSON line, then the result line.

Exits non-zero at the first failure, and when no CUDA device is present.
TF32 is off for cuBLAS and cuDNN throughout, so every fp32 product is a
full fp32 product.
"""
from __future__ import annotations

import copy
import json
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
SERVE = {"arch": "llama3-8b", "attn_impl": "pallas", "seeds": [0, 1],
         "batch": 4, "prompt_len": 2048, "gen_len": 16}   # a member a seed
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


def nvidia_smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def fitness_bound(pop):
    """Least time (ms) the card needs for one batched call on `pop`
    (N, P, M): the function's inputs pop, acc (N, M) and S (N, M, M)
    each read once and its two (N, P) outputs each written once, over
    the memory rate, against the operations over the fp32 peak. diag(S)
    is part of S and is not counted again. Returns (ms, bound_by) for
    the operations this data needs (rows hold k ones: k^2 multiply-adds
    for the quadratic form, 3 k for strength, self similarity and k) and
    for the dense product (2 N P M^2 + 6 N P M)."""
    N, P, M = pop.shape
    nbytes = 4 * (N * P * M + N * M + N * M * M + 2 * N * P)
    k = pop.sum(-1).double()
    needed = float((2 * (k * k + 3 * k)).sum())
    dense = 2 * N * P * M * M + 3 * 2 * N * P * M
    t_bytes = nbytes / PEAK_BYTES
    out = []
    for flops in (needed, dense):
        t_ops = flops / PEAK_FP32_FLOPS
        out.append((1e3 * max(t_bytes, t_ops),
                    "bytes" if t_bytes >= t_ops else "operations"))
    return out


def make_inputs(torch, rng, N, P, M, dense=False):
    """Populations whose rows hold k in {0, 1, 5, 5, ...} ones (dense:
    about M / 2 ones), accuracies and a symmetric similarity matrix."""
    import numpy as np
    pop = np.zeros((N, P, M), np.float32)
    for n in range(N):
        for p in range(P):
            if dense:
                pop[n, p] = rng.random(M) < 0.5
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
    """Device time per call from torch.profiler: (the kernel whose name
    holds `name` alone, every kernel the call launches), in ms; None
    where the profiler saw no device time."""
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
    own = sum(e.self_device_time_total for e in events if name in e.key)
    every = sum(e.self_device_time_total for e in events)
    return tuple(us / 1e3 / iters if us else None for us in (own, every))


def kernel_phase(torch):
    import numpy as np

    from repro_torch.kernels.ensemble_fitness import kernel, ref
    rng = np.random.default_rng(0)
    cases = [  # (entry point, N, P, M, dense rows)
        ("batched", 32, 100, 100, False), ("batched", 32, 200, 100, False),
        ("single", 1, 100, 100, False), ("single", 1, 200, 100, False),
        ("batched", 4, 128, 320, True), ("single", 1, 37, 320, True),
        ("batched", 3, 50, 7, False), ("single", 1, 50, 7, True),
        ("batched", 2, 1, 100, False), ("single", 1, 1, 7, False),
    ]
    max_err = 0.0
    timings = {}
    for entry, N, P, M, dense in cases:
        pop, acc, S = make_inputs(torch, rng, N, P, M, dense)
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
              f"{' dense rows' if dense else ''}: max abs err {err:.3e}")
        check(err <= TOL, f"ensemble_fitness[{entry}] at {(N, P, M)} "
                          f"disagrees with its plain version: {err}")
        max_err = max(max_err, err)
        if M == 100 and P in (100, 200):     # the main path's shapes
            # in turns: plain, kernel, kernel, plain
            p1, k1, k2, p2 = (time_ms(torch, fn) for fn in
                              (run_plain, run_kernel, run_kernel, run_plain))
            k_ms, p_ms = (k1 + k2) / 2, (p1 + p2) / 2
            own_ms, call_ms = device_ms(torch, run_kernel)
            (b_ms, b_by), (d_ms, d_by) = fitness_bound(pop)
            timings[(entry, N, P, M)] = (k_ms, p_ms, b_ms, b_by)
            print(f"  time {entry} (N, P, M) = {(N, P, M)}: kernel "
                  f"{k_ms:.6f} ms ({k1:.6f}, {k2:.6f}), plain {p_ms:.6f} ms "
                  f"({p1:.6f}, {p2:.6f}) per call; on the device (profiler) "
                  f"the kernel {own_ms} ms, all kernels of the call "
                  f"{call_ms} ms; bound {b_ms:.6f} ms ({b_by}; dense "
                  f"product {d_ms:.6f} ms, {d_by}), share of bound "
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
    profile_select(torch, exp.engine)
    return launches, n_select


def profile_select(torch, engine):
    """One more selection of the same fleet under torch.profiler (after
    the launch count was read): device time by kernel and the device's
    busy share of the selection's wall time (profiler on)."""
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
    busy_us = sum(e.self_device_time_total for e in kernels)
    print(f"profiled select(): wall {wall:.6f} s, device busy "
          f"{busy_us / 1e6:.6f} s ({busy_us / 1e6 / wall:.4f} of wall), "
          f"{sum(e.count for e in kernels)} kernel launches")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {e.self_device_time_total / 1e3:10.3f} ms  "
              f"{e.count:6d} x  {e.key[:90]}")


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
    timings at the slice's and the long-context shape."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import kernel, ref
    gen = torch.Generator(device="cuda").manual_seed(0)
    test_shapes = [(2, 4, 4, 256, 256, 64), (1, 8, 2, 128, 384, 64),
                   (1, 4, 1, 64, 64, 32), (1, 2, 2, 1, 256, 64)]
    cases = ([(s, d, 0, 0.0) for s in test_shapes
              for d in ("float32", "bfloat16")]
             + [((2, 4, 2, 256, 256, 64), "float32", w, c)
                for w, c in ((64, 0.0), (0, 30.0), (32, 50.0))]
             + [((2, 4, 2, 100, 100, 128), d, 0, 0.0)
                for d in ("float32", "bfloat16")]
             + [(SLICE_SHAPE, "bfloat16", 0, 0.0),
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
        del got, want
        if shape in (SLICE_SHAPE, LONG_SHAPE):
            iters = 50 if shape == SLICE_SHAPE else 5

            def run_sdpa(q=q, k=k, v=v, hd=hd):
                return F.scaled_dot_product_attention(
                    q, k, v, is_causal=True, scale=hd ** -0.5,
                    enable_gqa=True)
            sdpa_err = float((run_sdpa().float()
                              - run_plain().float()).abs().max())
            # in turns: plain, kernel, kernel, plain
            p1, k1, k2, p2 = (time_ms(torch, fn, iters=iters, warmup=3)
                              for fn in (run_plain, run_kernel, run_kernel,
                                         run_plain))
            lib_ms = time_ms(torch, run_sdpa, iters=iters, warmup=3)
            own_ms, _ = device_ms(torch, run_kernel, iters=iters,
                                  name="flash_fwd")
            b_ms, b_by, flops, nbytes = attention_bound(*shape)
            k_ms, p_ms = (k1 + k2) / 2, (p1 + p2) / 2
            timings[shape] = dict(err=err, ms=k_ms, plain_ms=p_ms,
                                  bound_ms=b_ms, bound_by=b_by,
                                  library_ms=lib_ms)
            print(f"  time {shape}: kernel {k_ms:.6f} ms ({k1:.6f}, "
                  f"{k2:.6f}), plain {p_ms:.6f} ms ({p1:.6f}, {p2:.6f}), "
                  f"SDPA {lib_ms:.6f} ms (max abs diff to plain "
                  f"{sdpa_err:.3e}) per call; kernel on the device "
                  f"(profiler) {own_ms} ms; bound {b_ms:.6f} ms ({b_by}: "
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


def serve_phase(torch):
    """Two full-width llama3-8b members served through serve_batch."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels.flash_attention import kernel
    from repro_torch.launch.serve import serve_batch
    from repro_torch.models import transformer as tf
    from repro_torch.obs.metrics import Stopwatch

    cfg = get_config(SERVE["arch"]).replace(attn_impl=SERVE["attn_impl"])
    B, S, G = SERVE["batch"], SERVE["prompt_len"], SERVE["gen_len"]
    print("serve config:", json.dumps({"serve": SERVE, "model": {
        k: getattr(cfg, k) for k in ("n_layers", "d_model", "n_heads",
                                     "n_kv_heads", "head_dim", "d_ff",
                                     "vocab", "dtype", "source")}},
        allow_nan=False))
    sw = Stopwatch().start()
    members = [tf.init_params(cfg, torch.Generator(device="cuda")
                              .manual_seed(seed)) for seed in SERVE["seeds"]]
    torch.cuda.synchronize()
    n_par = sum(p.numel() for p in members[0].parameters())
    print(f"serve: {len(members)} members of {n_par} parameters "
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
    print(f"serve: flash_attention launches {launches}, expected "
          f"n_layers x members = {expect}")
    check(launches == expect, f"flash_attention launched {launches} times "
                              f"in serve_batch, expected {expect}")
    check(tuple(toks.shape) == (B, G) and toks.dtype == torch.int32
          and int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab,
          f"bad served tokens: shape {tuple(toks.shape)}, range "
          f"[{int(toks.min())}, {int(toks.max())}]")

    sw = Stopwatch().start()
    serve_batch(cfg, members, prompts, gen_len=1)       # prefill only
    torch.cuda.synchronize()
    prefill = sw.stop()
    decode_tps = B * (G - 1) / (total - prefill)
    print(f"serve: {B} x {S} prompts, {G} tokens: serve_batch {total:.6f} "
          f"s; prefill (gen_len 1) {prefill:.6f} s ({B * S * len(members) / prefill:.1f} "
          f"prompt tokens/s over both members); decode {total - prefill:.6f}"
          f" s, {decode_tps:.3f} generated tokens/s; peak device memory "
          f"{peak} bytes ({peak / 2**30:.2f} GiB)")
    print("serve: tokens", toks.cpu().tolist())

    solo = serve_batch(cfg, members[:1], prompts, gen_len=G)
    masked = serve_batch(cfg, members, prompts, gen_len=G,
                         weights=[1.0, 0.0])
    same = bool(torch.equal(solo, masked))
    print(f"serve: weights [1, 0] == member 0 alone: {same}")
    check(same, "serve_batch with weights [1, 0] differs from member 0 "
                "served alone")

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
    print(f"profiled prefill (both members): wall {wall:.6f} s, device "
          f"busy {busy:.6f} s ({busy / wall:.4f} of wall)")
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
    print(f"profiled decode step (one member): wall {wall:.6f} s, device "
          f"busy {busy:.6f} s ({busy / wall:.4f} of wall), "
          f"{sum(e.count for e in events)} kernel launches")

    with torch.inference_mode():
        probs = {}
        for impl in ("pallas", "xla"):
            logits, _ = tf.forward(members[0], cfg.replace(attn_impl=impl),
                                   prompts, last_only=True)
            probs[impl] = torch.softmax(logits[:, -1].float(), dim=-1)
        gap = float((probs["pallas"] - probs["xla"]).abs().max())
        agree = bool(torch.equal(probs["pallas"].argmax(-1),
                                 probs["xla"].argmax(-1)))
    print(f"serve: member 0 last-position probabilities, pallas vs xla "
          f"prefill: max abs diff {gap:.3e} (largest probability "
          f"{float(probs['xla'].max()):.3e}); same argmax: {agree}")
    check(gap < 1e-2, f"pallas and xla prefill disagree: {gap}")
    del members
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

    print(nvidia_smi("name,power.limit"))
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; device "
          f"{name!r}, count {count}")
    build_all([kernel.KERNEL, fa_kernel.KERNEL])
    for lib in (kernel.KERNEL, fa_kernel.KERNEL):
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
    flash_launches = serve_phase(torch)

    k_ms, p_ms, b_ms, b_by = timings[("batched", 32, 200, 100)]
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
        "launches": flash_launches, "max_abs_err": flash["err"],
        "ms": flash["ms"], "plain_ms": flash["plain_ms"],
        "bound_ms": flash["bound_ms"], "bound_by": flash["bound_by"],
        "library_ms": flash["library_ms"]}]}, allow_nan=False))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}},
        allow_nan=False))
    return 0


if __name__ == "__main__":
    sys.exit(main())
