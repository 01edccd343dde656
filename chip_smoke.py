#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Device: the card's name and power limit (nvidia-smi), the torch
   device name and count.
2. Build: compiles the six sources under `src/repro_torch/csrc/`
   (ensemble_fitness, flash_attention, ssd_scan and its backward
   ssd_scan_bwd, wkv_scan and its backward wkv_scan_bwd) with nvcc for
   sm_90a, one nvcc each, started together, and prints each build's
   seconds and ptxas register / shared-memory report.
3. Kernel: both entry points of ensemble_fitness at the main paths'
   shapes (the sync slice's (32, 100, 100) and (32, 200, 100), the async
   configurations' (64, 24, 16) and (64, 24, 128)), a batch padded by
   duplicated clients as the engine pads a select (their objectives must
   equal the original's bitwise), and at edge shapes (dense rows,
   non-binary rows, all-zero and single-member rows, ragged row counts),
   each held against its plain
   PyTorch version (max abs error <= 1e-5), and timed with CUDA events
   against the plain version (in turns: plain, kernel, kernel, plain),
   with the kernel's device time from torch.profiler beside it and the
   bound (pop read whole, the entries of acc and S its rows' nonzeros
   pick, the (N, P, 2) objectives written; the count with S whole is
   printed beside it).
3b. Repeatable local training: each CNN family's local training loop,
   64 steps on client 0's data of the slice, run in turns with the
   flags the process has and under fl.client.repeatable_cudnn (cuDNN's
   deterministic algorithms), twice each: prints the first step and
   parameter at which the two unscoped runs' gradients differ and the ms
   a step of each; the two scoped runs must agree at every step.
4. Slice: the paper's synchronous configuration (the port's
   configs/paper_cnn.py, full=True: 20 clients, 5 CNN families, width
   16, 10 classes, 60000 synthetic 10x10x3 images, Dirichlet 0.1,
   NSGA-II 100 x 100, k = 5) with local training cut from 60 epochs to
   2; selection scores every population through the kernel.
   The launch count is reset just before the run and must come out at
   2 * generations + 1 per selection. Two more selections of the same
   engine state must give identical populations, objectives and winners
   (is select() deterministic on the card?). One more selection under
   torch.profiler prints its kernel launches beside the 43055 that the
   dense-form kernel's run on this card counted, and beside those of the
   same selection through that version's per-call fitness wrapper (a
   diag(S) copy, two outputs, a stack), which must launch at least 201
   more. Then the slice runs a second time from the same spec: its
   fleet-mean test accuracy, the digests of the selected chromosomes and
   of every trained parameter must equal the first call's bits (both
   printed, with both calls' train_s).
4b. Async, configuration 8: the same configuration on the asynchronous
   event loop (speed sigma 0.6, link latency 0.05, train cost affine(1.0,
   0.3), select_debounce 0.5, ideal links, observability on) with the
   slice's datasets and trained models injected: every arrival is one
   CNN forward on the receiver's validation set, every debounced select
   tick one batched selection of the ready clients (padded to a power of
   two, gathered from the resident buffers). Its events, bench sizes and
   select batches must equal the port's scheduler run again on the CPU
   with a stub selection; fitness launches must be 201 x the batches
   that ran a GA; coverage 1.0; fleet-mean test accuracy above chance;
   no client's last validation accuracy more than 0.05 below its first.
   Prints batches, client selections, wall, net_s and select_s (ms a
   batch beside the sync round's select), t_full and peak memory.
4b'. Async, configuration 12: configuration 8 serving queries once its
   models have spread (Poisson, 20 queries/s a client in batches of 8
   from t = 18 for 15 s; a label shift to class 7 on half the clients at
   t = 23 and a covariate shift of severity 0.5 on half at t = 27;
   monitor window 64, threshold 0.12, debounce 0.5; policy "ensemble"). Every query batch must be answered
   by a masked forward of at most k selected members (the models are on
   the card); the queries served and dropped must add up to those a
   stub-selection schedule with the monitor off offers; fitness launches
   201 x the batches that ran a GA; at least one re-selection the
   monitor asked for. Prints the serve counters (regret, latency p50 and
   p99, window accuracy), net_s against select_s and peak memory.
4c. Async, configuration 9: examples/gossip_churn.py at its full size
   (the spec from the port driver's make_spec: prediction world of 64
   clients x 2 models, V = 128, C = 8, world seed 17; small-world k = 4;
   lossy gossip with inboxes of 64, push, lognormal churn;
   select_debounce 0.5; GA 24 x 8, k = 5) on the card at store capacity
   16 (traced, both sinks written and read back as strict JSON) and
   unbounded, and at capacity 16 on the CPU. Card and CPU must give
   equal events, net dicts, bench sizes, select batches and selection
   keys; fitness launches 17 x the batches that ran; the bounded-vs-
   unbounded gap of the final mean validation accuracy <= 0.02; after
   the bounded run the cached acc must equal a one-shot selection_stats
   exactly and S within 2e-4, and a gather of a batch with repeated
   clients must equal the resident rows bitwise. Prints MB on the wire,
   coverage, net_s / select_s, events/s and the metrics.
4d. Async, configuration 10: examples/specs/byzantine_ring.json at its
   full size (byzantine, corruption, crash-restart, the validation gate)
   on the card and on the CPU: events, net (faults and admission
   included), bench sizes and select batches equal; no honest store
   holds a byzantine owner's payload; fitness launches 17 x the batches
   that ran a GA.
4e. Async, configuration 11: examples/specs/serve_drift.json at its full
   size on the card with the monitor on and off, and on the CPU with it
   off: the monitor-off runs give equal events, bench sizes, select
   batches and net (the window accuracy, which depends on what each
   GA picked, printed beside); with the monitor on, the same queries,
   one drift, at least one re-selection, and every select tick only the
   monitor made ran a GA; launches 17 x the batches that ran.
4g. The port's example drivers (repro_torch.examples: lossy_links,
   quickstart, async_decentralized, gossip_churn, pareto_front,
   beyond_paper, byzantine_peers, serve_drift) at their full sizes on the
   card, in process, each through its own main(["--json", path]): its
   own asserts (the headline claims of lossy_links, byzantine_peers and
   serve_drift, gossip_churn's two, async_decentralized's, every
   determinism rerun) must pass; its rows must read back as strict JSON
   with the expected names (DRIVERS: the reference's where it writes
   rows); its fitness launches, reset just before, must equal 2 G + 1
   times its sync selections and the select batches that ran a GA
   (driver_launches; 0 for lossy_links, 2 x 40 + 1 = 81 for
   pareto_front's single-client select_ensemble). Prints each one's
   wall seconds and peak device memory beside the card's name and power
   limit. lossy_links runs again on the CPU at full size: its rows must
   equal the card's byte for byte. Then the single-client fitness entry
   at pareto_front's (P, M) and (2 P, M) (only that driver may launch
   it) is held against its plain version and timed with its bound.
4b''. Restack: the sync slice's fleet selected once on the restack path
   (`selection.device_resident=False`: a host restack and fresh
   statistics every select) and once on the resident path, in turns
   (restack, resident, resident, restack), each timed: 201 fitness
   launches a select on both; the chromosomes held by outcome (k members
   everywhere, fleet-mean validation accuracy within 0.02), since cached
   and one-shot S differ in the last bits.
4b'''. The paper's tables (phase 16, configuration 16; no kernel but
   ensemble_fitness: the baselines are autograd over the CNNs, on cuDNN).
   (a) On the sync slice's world (20 clients, Dir(0.1), 60000 images, 10
   classes, the 5 families at width 16) the seven baselines of
   fl/baselines.py (FLConfig(rounds=60, local_steps=2, seed=0): 60 rounds,
   cut from table1_accuracy.py's --full 400), each timed: every accuracy
   array (20,), finite, in [0, 1]. Prints Table I's row of every method
   (fleet mean +- 1.96 std / sqrt(n), seconds, local steps/s; local and
   fedpae from the slice's models and result), Table II's min / max
   relative change against local, Table IV's analytic GFLOPs beside the
   measured seconds, the clustered-gossip saving of the slice's chosen
   owners (examples/beyond_paper.py:38-45), and one FedAvg round under
   torch.profiler (launches, the device's busy share). (b) Each baseline
   at 3 clients, width 8, 2 rounds of 1 step, from the port's own init
   and draws, on the card and on the CPU: final test probabilities
   within 1e-4. (c) FedAvg and FML twice at full width for 3 rounds:
   bitwise-equal probabilities. (d) The port's Table I script,
   repro_torch.benchmarks.table1_accuracy.run_grid, at
   paper_cnn.smoke(), Dir(0.1), 2 rounds, on the card: the fitness
   count, reset just before, must be 2 * generations + 1 per selection.
4f'. Compiled array world (`sim/compiled.py`, no kernel: eager PyTorch
   tensor steps on the card). Configuration 13:
   examples/specs/fleet_sweep.json at its full size (2048 clients,
   small-world k = 8, 10% drops, anti-entropy repair, tick 0.25,
   32-tick chunks) must give FLEET_FULL, the JAX package's net dict,
   t_full 8.75 and 64 ticks; a second run profiles its first chunk
   (launches a tick, device busy share); at the smoke size (256 clients)
   card and CPU must agree bitwise (have_tick, net, t_full, ticks).
   Configuration 14: benchmarks/run.py's full simloop tier (10,000
   clients, small-world k = 8, ideal links, tick 0.5, 16-tick chunks,
   the key axis sharded into blocks): coverage 1.0 and n_accepted = K (N
   - 1). Configuration 14b: the deterministic tier at N = 128 (k = 4,
   tick 0.05): the port's event loop on the CPU and the compiled backend
   on the card give equal net dicts. Each prints wall, build_s, scan_s,
   ticks/s and peak memory beside the card's name and power limit.
4f''. Configuration 15: configuration 9's prediction world and network
   (no inbox cap) with fleet_sweep's repair on the compiled backend
   (32-tick chunks), unbounded stores, on the card and on the CPU:
   have_tick, net and every store's model ids and predictions equal;
   then one select() over the 64 clients (GA 24 x 8) on each: 17
   fitness launches on the card, k members everywhere, fleet-mean
   validation accuracy within 0.02 of the CPU's.
4f. Kernel: ensemble_fitness at every (N, P, M) shape configurations
   10-12 and 15, the restack select and the example drivers launched
   (recorded from their runs), held against its plain version; at each
   path's widest batches timed against it with its bound.
5. Kernel: flash_attention at the reference's test shapes and variants,
   head dim 112, bf16 window and softcap at hd 64, 112 and 128, a ragged
   S = 100, the serving slice's shape (4, 32, 8, 2048, 2048, 128),
   zamba2-7b's shared-attention shape (4, 32, 32, 2048, 2048, 112), also
   with window and softcap, the long-context shape (1, 32, 8, 8192,
   8192, 128) and the zoo's prefill shapes (ZOO_FLASH_SHAPES: arctic-480b's
   (4, 56, 8, 2048, 2048, 128), G = 7; command-r-plus-104b's (4, 96, 8,
   ..., 128), G = 12; musicgen-medium's (4, 24, 24, ..., 64), MHA), bf16
   causal, each held against its plain version on the
   card (fp32 atol = rtol = 2e-5, bf16 2e-2, as
   tests/test_kernels.py:70,83). At the slice's shape ops.flash_attention
   on the same data in the model layout (B, S, H, hd) must equal the
   kernel's output bitwise and come out contiguous. At the three large
   causal shapes: timed in turns against the plain version (and, at the
   slice's shape, through ops.py on the model layout), the kernel's
   device time from torch.profiler, scaled_dot_product_attention timed as
   the library yardstick (never called by the port), and the bound; so at
   the zoo's three shapes.
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
7b. Kernel: the ssd_scan backward (ssd_scan_bwd, no TPU counterpart),
   through ops.ssd_scan's autograd Function with B and C views of one
   tensor (one forward and one backward launch), at (2, 512, 4, 64, 64)
   in fp32 and bf16, at a per-step log decay down to -18 (dt in [3, 4],
   A_log in [1, 1.5]) in both, at a ragged S = 100, and with five heads
   (2, 256, 5, 64, 64: a head group of 4 and a ragged one of 1) and a
   single chunk (2, 128, 3, 64, 64) in both dtypes, each with a
   gradient on h_T: dx, ddt, dA_log, dB, dC and dD held against the
   plain backward (ref.ssd_scan_bwd_ref) with wkv_scan_bwd's limits
   (2**-7 of max |g| for bf16 dx, dB, dC, 1e-5 otherwise) and, at (2,
   512, 4, 64, 64), against torch.autograd of a float64 recurrence (fp32
   within 1e-6); every gradient finite. At the training shapes, a
   zamba2-7b microbatch (2, 2048, 112, 64, 64) and the whole batch (4,
   2048, 112, 64, 64), bf16, as a layer calls it (no d h_T): held
   against the plain backward with the same limits; at the microbatch
   two calls must give the same bits in all six gradients; at both:
   timed in turns against the plain backward, device time from
   torch.profiler (a call runs four kernels, ssd_scan_bwd_*; each one's
   time printed beside the bytes it moves in the kernel's own design,
   ssd_bwd_design_bytes, and the rate that gives), and the bound (bytes,
   against twice the forward's least work).
8. Model check: the smoke rwkv6-3b, zamba2-7b, qwen3-moe-235b-a22b,
   arctic-480b, command-r-plus-104b, llama-3.2-vision-11b (with images)
   and musicgen-medium (with codebooks) in fp32, the last five under
   attn_impl "pallas", the same weights on the card (kernels) and on the
   CPU (plain versions): prefill logits and states or caches agree (atol
   3e-4, rtol 1e-3).
9. Train check: the smoke qwen2.5-3b, rwkv6-3b, zamba2-7b,
   qwen3-moe-235b-a22b (the loss with 0.01 x the router aux),
   llama-3.2-vision-11b (image embeddings from a seed) and
   musicgen-medium (codebooks) in fp32,
   from the same parameters (drawn on the CPU, as train() draws them)
   and the same TokenPipeline(seed=0) batches, on the card (rwkv6: both
   wkv kernels; zamba2: both ssd kernels) and on the CPU (plain
   versions): every parameter's gradient on the first batch within 1e-4
   of its max |g|, then 10 adamw steps of 4 x 64 tokens as train() takes
   them, whose losses agree within 1e-5 relative; the card's last loss
   is below its first; each rwkv6 and Mamba2 layer launches its scan
   twice (once more under the checkpoint's recompute) and the scan's
   backward once a layer and pass. Then the rwkv6-3b and zamba2-7b card
   runs once more with a planted fault (the wkv backward's dk, the ssd
   backward's ddt zeroed): the gradient check must fail on each (its
   gaps are printed).
10. Serve, in turn: FedPAE soft-vote serving
   (`launch/serve.py::serve_batch`) of two full-width members (bf16,
   random weights from seeds 0 and 1) of llama3-8b (attn_impl="pallas":
   flash_attention on every layer), rwkv6-3b (wkv_scan on every layer)
   and zamba2-7b (ssd_scan on every Mamba2 layer) on 4 x 2048-token
   prompts, 16 generated tokens. The kernel's launch count is reset
   just before the run and must come out at n_layers x members (64, 64,
   162); the tokens must be (4, 16) and inside the vocabulary; weights
   [1, 0] must give member 0's own tokens (4 of them: the decodes are
   host-bound); every last-position prefill
   logit and one decode step's logits must be finite. Reports prefill
   seconds, decode tokens/s, peak memory (each phase frees the previous
   one's members first), the device's busy share of the prefill (with
   its largest kernels) and of one decode step (with its launches), and
   for llama3-8b the pallas-vs-xla gap of member 0's last-position
   probabilities. Then the rest of the zoo the same way, the depth cut
   where two bf16 members would not fit (REDUCED_SERVE):
   qwen3-moe-235b-a22b at 6 of 94 layers (g_major, so no flash: 0
   launches), arctic-480b at 1 of 35 (2) and command-r-plus-104b at 8 of
   64 (16), each MoE member's prefill run twice with bitwise equal logits
   and cache; llama-3.2-vision-11b (full depth) and musicgen-medium (full
   depth) through make_prefill_step and 15 make_serve_step calls a member
   (step_serve: the same soft vote, greedy per codebook for audio), vlm
   with image embeddings (4, 1600, 1280) from a seed (flash on its 32
   self-attention layers: 64) and then text-only through serve_batch
   (every layer: 80), musicgen on (4, 2048, 4) codebook prompts (96).
10b. Multi-device (launch/mesh.py, launch/fedpae_pods.py, the MoE's mesh
   branch) over NCCL at a world of one rank a card (in this process at
   one card; its world size and backend printed first). Pods: a (pod
   world, data 1, model 1) mesh, each pod's llama3-8b member (full width
   and depth, "pallas", seed = its pod) sent round the ring once by
   pod_ring_exchange (bytes and ms printed; at one card a device copy,
   not a link rate): the received parameters must equal the sender's
   bitwise; then one chromosome-weighted ensemble vote on 4 x 2048
   prompts, whose flash_attention launches (count reset just before)
   must be n_layers (32), and which at one pod must equal the member's
   own softmax bitwise. MoE: qwen3-moe-235b-a22b at 6 layers on a (data
   1, model world) mesh, each rank its experts (moe.local_experts): a
   prefill through the mesh= branch must equal the mesh=None prefill
   (bitwise at one rank, else within MULTI_TOL) and repeat bitwise; one
   train step at 1 layer (cell 22's batch) on the mesh must equal the
   unmeshed step (loss and every parameter after it; bitwise at one
   rank). The group is destroyed when the phase ends.
11. Train, in turn: `train()` of qwen2.5-3b at full width and 18 of its
   36 layers, rwkv6-3b at full width and 16 of its 32 (the script's time
   limit: train() draws its weights on the host), zamba2-7b at full
   width and 21 of its 81 layers (3 super-blocks of 6 Mamba2 blocks and
   a tail of 3) and qwen3-moe-235b-a22b at full width and 1 of its 94
   layers (then its cross-entropy and router aux on a held-out batch),
   bf16, random weights from seed 0, adamw (weight decay 0.01) and
   warmup_cosine, 6 steps of 4 x 2048 tokens from TokenPipeline(seed=0)
   in 2 microbatches. The scan kernels' counts are reset just before
   each run: rwkv6-3b must launch wkv_scan 16 x 2 x 2 and wkv_scan_bwd
   16 x 2 times a step, zamba2-7b ssd_scan 21 x 2 x 2 and ssd_scan_bwd
   21 x 2, 6 steps in all. Reports every loss (all finite), step seconds
   (as train() returns them), tokens/s over steps 2-6, peak device
   memory and the launches, then one more step under torch.profiler by
   kernel, with the scan kernels' share of it.
12. Every share of bound printed (bound / time) must be <= 1.05: a
   kernel faster than its bound means the bound is no floor. The shares,
   the `kernels` JSON line (ensemble_fitness's `launches` is the sync
   slice's count; `launches_by_path` adds each async run's, those of
   configurations 10-12 included, configuration 15's select, the
   restack select, the tables' smoke grid and each example driver's,
   `by_shape` the timings at every path's shape, `single_by_shape` the
   single-client entry's at pareto_front's; flash_attention's
   `launches` is llama3-8b's serve_batch, its `launches_by_path` every
   serving path's and the pod vote's, its `by_shape` every timed
   shape's), then the result line.

Exits non-zero at the first failure, and when no CUDA device is present.
TF32 is off for cuBLAS and cuDNN throughout, so every fp32 product is a
full fp32 product.
"""
from __future__ import annotations

import contextlib
import copy
import os
import hashlib
import json
import math
import subprocess
import sys
import time
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
CARD = ""            # nvidia-smi's name and power limit, printed beside times
PHASE_SECONDS = {}   # phase -> wall seconds, printed before the kernels line
SERVE = {"seeds": [0, 1], "batch": 4, "prompt_len": 2048,
         "gen_len": 16}                                    # a member a seed
SERVE_CHECK_GEN = 4   # tokens of the weights-[1, 0] check (host-bound)
SERVES = [  # (arch, config overrides, the kernel package its prefill runs)
    ("llama3-8b", {"attn_impl": "pallas"}, "flash_attention"),
    ("rwkv6-3b", {}, "wkv_scan"),
    ("zamba2-7b", {}, "ssd_scan")]
PALLAS = {"attn_impl": "pallas"}
ZOO_SERVES = [  # (arch, config overrides): serve_batch, 2 members of SERVE
    ("qwen3-moe-235b-a22b", dict(PALLAS, n_layers=6)),   # g_major: no flash
    ("arctic-480b", dict(PALLAS, n_layers=1)),
    ("command-r-plus-104b", dict(PALLAS, n_layers=8))]
ZOO_STEP_SERVES = ["llama-3.2-vision-11b", "musicgen-medium"]  # full depth
REDUCED_SERVE = {  # 2 bf16 members must fit one 80 GB card beside the run
    "qwen3-moe-235b-a22b": "n_layers 94 -> 6: 4.975 GB a layer and 2.49 GB "
                           "of embedding and head a member",
    "arctic-480b": "n_layers 35 -> 1: 27.2 GB a layer; 2 layers x 2 members "
                   "= 111 GB do not fit",
    "command-r-plus-104b": "n_layers 64 -> 8: 3.15 GB a layer and 6.29 GB "
                           "of tied embedding a member"}
ZOO_FLASH_SHAPES = [   # the zoo's prefill shapes at batch 4, new to the kernel
    (4, 56, 8, 2048, 2048, 128),    # arctic-480b, G = 7
    (4, 96, 8, 2048, 2048, 128),    # command-r-plus-104b, G = 12
    (4, 24, 24, 2048, 2048, 64)]    # musicgen-medium, MHA at head dim 64
# the sharded step's new local shapes at batch 4 (model 4, then 16):
# llama3-8b's 32 / 8 heads -> 8 / 2 and 2 / 1 (kv whole at 16, each rank
# reads the one kv head of its q heads), command-r-plus-104b's 96 / 8 ->
# 24 / 2 and 6 / 1
SHARD_FLASH_SHAPES = [(4, 8, 2, 2048, 2048, 128), (4, 24, 2, 2048, 2048, 128),
                      (4, 2, 1, 2048, 2048, 128), (4, 6, 1, 2048, 2048, 128)]
SSD_SHARD_SHAPES = [(4, 2048, 28, 64, 64), (4, 2048, 7, 64, 64)]  # zamba2's
                                                  # 112 heads at model 4, 16
SCAN_Y_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}   # of max |y|
SCAN_STATE_TOL = 1e-3
SCAN_F64_TOL = 1e-6    # fp32 scans at the slice shapes, of max |y|
SSD_SLICE = (4, 2048, 112, 64, 64)     # zamba2-7b prefill, batch 4
WKV_SLICE = (4, 2048, 40, 64)          # rwkv6-3b prefill, batch 4
SELECT_LAUNCHES_DENSE = 43055  # kernels of one profiled select() with
                               # the dense-form fitness kernel, H100
SLICE_EPOCHS = 2     # local training, cut from the paper's 60
REDUCED = {"train.max_epochs": "60 -> 2 (configs/paper_cnn.py full=True)"}
ASYNC_PAPER = {  # configuration 8's schedule (examples/async_decentralized)
    "mode": "async", "speed_lognorm_sigma": 0.6, "link_latency": 0.05,
    "select_debounce": 0.5,
    "train_cost": {"name": "affine", "params": {"base": 1.0, "slope": 0.3}}}
GOSSIP = {"n": 64, "mpc": 2, "capacity": 16, "world_seed": 17, "pop": 24,
          "gens": 8, "k": 5}  # configuration 9
GOSSIP_GAP_MAX = 0.02   # bounded-vs-unbounded val-acc (examples/gossip_churn)
FLEET_SPEC = "examples/specs/fleet_sweep.json"      # configuration 13
# configuration 13 at its full size as the JAX package computes it on the
# CPU (repro.sim.compiled); tests/test_torch_compiled.py re-derives these
# from the reference's full-size run
FLEET_FULL = {"t_full": 8.75, "n_ticks": 64, "net": {
    "lost_offline": 0,
    "transport": {"n_sent": 30547351, "n_delivered": 27494043,
                  "n_dropped_link": 3053308, "n_dropped_inbox": 0,
                  "bytes_sent": 124539704232,
                  "bytes_delivered": 111838994088, "bytes_rejected": 0,
                  "n_corrupt_detected": 0, "n_corrupt_admitted": 0},
    "gossip": {"n_accepted": 4192256, "n_dedup": 23050004,
               "n_suppressed": 0, "n_pull": 0},
    "repair": {"n_digests_sent": 279888, "n_digests_recv": 251783,
               "n_digests_lost": 0, "n_gaps_found": 4303451,
               "n_resends": 905287, "n_budget_deferred": 3398164,
               "n_inflight_skipped": 0, "n_attempts_exhausted": 0,
               "n_quiesced": 21135, "bytes_digests": 564175784}}}
FLEET_REPAIR = {"interval": 0.5, "start": 0.5, "max_rounds": 40}
# configuration 14: benchmarks/run.py's full simloop tier; 14b its
# deterministic tier at N = 128 (event loop == compiled backend)
SIMLOOP_FULL = {"n": 10_000, "k": 8, "tick": 0.5, "chunk_ticks": 16}
SIMLOOP_PARITY = {"n": 128, "k": 4, "tick": 0.05}
COMPILED_CHUNK = 32   # configuration 15's chunk_ticks
FITNESS_ASYNC_SHAPES = [(32, 100, 100), (64, 24, 16), (64, 24, 128)]
PROBE_STEPS = 64      # local-training steps compared a family
CHAOS = {  # configurations 10 and 11: the repo's spec files, full size
    "faults": "examples/specs/byzantine_ring.json",
    "serve": "examples/specs/serve_drift.json"}
# configuration 12: configuration 8 serving queries once its models have
# spread (its last arrival lands at t_full = 17.59): until then every
# client re-selects on arrivals about every 0.7 s, and each re-selection
# restarts the monitor's 64-query window (3.2 s of this traffic), so a
# drift during dissemination cannot breach it
SERVE_PAPER = {
    "traffic": {"name": "poisson", "params": {
        "rate": 20.0, "batch": 8, "start": 18.0, "duration": 15.0}},
    "drift": [
        {"name": "label_shift", "params": {
            "at": 23.0, "classes": [7], "skew": 1.0, "fraction": 0.5}},
        {"name": "covariate_shift", "params": {
            "at": 27.0, "severity": 0.5, "fraction": 0.5}}],
    "policy": "ensemble", "monitor": True, "window": 64,
    "threshold": 0.12, "debounce": 0.5}
# phase 16, the paper's tables: the baselines on cell 1's world, their
# rounds cut from table1_accuracy.py's --full 400 to its default 60
TABLES_FL = {"rounds": 60, "local_steps": 2, "width": 16, "seed": 0}
REDUCED_TABLES = {"baselines.rounds": "400 -> 60 (benchmarks/"
                                      "table1_accuracy.py:35, --full)"}
TABLES_SMALL = {"n_clients": 3, "alpha": 0.5, "n_samples": 600,
                "n_classes": 6, "size": 8, "rounds": 2, "local_steps": 1,
                "width": 8}
TABLES_CPU_TOL = 1e-4     # card against CPU, final test probabilities
TABLES_REPEAT_ROUNDS = 3


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


def timed(name, fn, *args):
    """fn(*args), its wall seconds printed and kept in PHASE_SECONDS."""
    t0 = time.perf_counter()
    out = fn(*args)
    PHASE_SECONDS[name] = round(time.perf_counter() - t0, 3)
    print(f"phase {name}: {PHASE_SECONDS[name]} s")
    return out


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
    sign ("values"), accuracies and a symmetric similarity matrix. "dup"
    is "k5" with the last N - 20 clients copies of client 0 (population,
    acc and S), as the engine's power-of-two padding of a batch of 20
    ready clients makes them."""
    import numpy as np
    if rows == "dup":
        pop, acc, S = make_inputs(torch, rng, N, P, M, "k5")
        pad = list(range(20)) + [0] * (N - 20)
        return pop[pad].contiguous(), acc[pad].contiguous(), \
            S[pad].contiguous()
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
    each kernel of `name` once (ssd_scan and both backwards run four,
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
        # the async paths' shapes (configurations 8 and 9), and a batch
        # padded by duplicated clients
        ("batched", 64, 24, 16, "k5"), ("batched", 64, 24, 128, "k5"),
        ("batched", 32, 100, 100, "dup"),
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
        if rows == "dup":   # a padded client scores as its original
            same = all(torch.equal(g[20:], g[:1].expand_as(g[20:]))
                       for g in got)
            print(f"  duplicated clients' objectives equal client 0's "
                  f"bitwise: {same}")
            check(same, "ensemble_fitness gives a duplicated client other "
                        "objectives than its original")
        max_err = max(max_err, err)
        if rows == "k5" and ((M == 100 and P in (100, 200))
                             or (N, P, M) in FITNESS_ASYNC_SHAPES):
            # the paths' shapes
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


def paper_spec(schedule=None):
    """The paper's configuration from the port's configs/paper_cnn.py
    (full=True: 20 clients, 5 CNN families at width 16, 60000 synthetic
    10x10x3 images of 10 classes, Dirichlet 0.1, NSGA-II 100 x 100, k =
    5), local training cut to SLICE_EPOCHS; `schedule` (a ScheduleSpec
    dict) replaces the synchronous schedule."""
    import dataclasses

    from repro_torch.configs.paper_cnn import config
    from repro_torch.sim import (DataSpec, ExperimentSpec, ScheduleSpec,
                                 spec_from_fedpae)
    cfg = config(full=True)
    fed = dataclasses.replace(cfg["fedpae"], max_epochs=SLICE_EPOCHS)
    n_classes = cfg["datasets"]["synthetic10"]
    spec = spec_from_fedpae(fed, n_clients=cfg["n_clients"],
                            n_classes=n_classes)
    d = spec.to_dict()
    d["data"] = dataclasses.asdict(DataSpec(
        kind="synthetic_images", n_clients=cfg["n_clients"],
        n_classes=n_classes, n_samples=cfg["n_samples"],
        alpha=min(cfg["alphas"])))
    if schedule is not None:
        d["schedule"] = dataclasses.asdict(ScheduleSpec(**schedule))
    return ExperimentSpec.from_dict(d)


def slice_phase(torch):
    import numpy as np

    from repro_torch.core.device_store import DeviceStoreBatch
    from repro_torch.core.nsga2 import nondominated_rank
    from repro_torch.core.selection import selection_stats
    from repro_torch.kernels.ensemble_fitness import kernel, ref
    from repro_torch.obs.metrics import Stopwatch
    from repro_torch.sim import Experiment

    spec = paper_spec()
    print("slice config:", json.dumps({"spec": spec.to_dict(),
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
    return launches, exp, res


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
    print(f"profiled select() with the dense form's per-call wrapper on "
          f"the same data: wall {wall_d:.6f} s, {n_d} kernel launches; "
          f"the gather form launches {n_d - n} fewer (2 x 201 expected)")
    check(n_d - n >= 201, f"select() saves {n_d - n} launches, expected "
          "at least 201 (the diag(S) copies)")


class StubServing:
    """The serve section's query and drift events with nothing answered
    and no monitor: counts the queries the schedule offers (served or
    dropped)."""

    def __init__(self, spec):
        from repro_torch.sim.build import _seeded
        from repro_torch.sim.registry import build as build_component
        sv = spec.serve
        base = sv.seed if sv.seed is not None else spec.seed
        ctx = {"n_clients": spec.data.n_clients, "seed": base,
               "spec": spec}
        self.traffic = build_component("traffic",
                                       _seeded(sv.traffic, base), ctx)
        self.drifts = [build_component("drift", _seeded(d, base), ctx)
                       for d in sv.drift]
        self.n_clients = spec.data.n_clients
        self.offered = 0

    def initial_events(self):
        from repro_torch.serve import ServingEngine
        return ServingEngine.initial_events(self)

    def on_query(self, c, t, batch_idx, n):
        self.offered += n
        return False

    def note_dropped(self, c, n):
        self.offered += n

    def on_drift(self, di, t):
        pass

    def note_selected(self, clients, t):
        pass


def stub_schedule(spec, serving=None):
    """The port's event loop over `spec`'s schedule and network on the
    CPU, with a stub selection (and, given a `StubServing`, its query and
    drift events): the trace that every run of the spec must reproduce,
    whatever its device (arrivals and select ticks do not depend on what
    a selection returns; without a monitor, neither do queries)."""
    from repro_torch.fl.scheduler import AsyncConfig, simulate_async
    from repro_torch.sim.build import build_network
    sched = spec.schedule
    net = build_network(spec, spec.data.n_clients)
    mpc = (len(spec.train.families) if spec.data.kind == "synthetic_images"
           else spec.data.models_per_client)
    cfg = AsyncConfig(
        n_clients=spec.data.n_clients, models_per_client=mpc,
        speed_lognorm_sigma=sched.speed_lognorm_sigma,
        link_latency=sched.link_latency,
        select_debounce=sched.select_debounce,
        seed=sched.seed if sched.seed is not None else spec.seed)
    return simulate_async(cfg, net["neighbors"], net["train_cost"],
                          on_select_batch=lambda cs, ids, t: {},
                          transport=net["transport"], gossip=net["gossip"],
                          churn=net["churn"], repair=net["repair"],
                          serving=serving)


def ran_batches(res):
    """Select ticks at which a GA ran: those where some client recorded
    a selection (a tick whose clients could not yet fill an ensemble
    launches nothing)."""
    return sorted({t for v in res.selections.values() for t, _ in v})


def async_report(what, res, wall, launches, per_batch):
    """Print and check the numbers every async run reports: batches,
    client selections, launches against per_batch x the batches that ran
    a GA, wall/net/select seconds, events/s, coverage, t_full, MB on the
    wire. Returns the number of batches that ran a GA."""
    ran = ran_batches(res)
    perf, net = res.perf, res.net or {}
    expect = ("no kernel on the CPU" if per_batch is None else
              f"expected {per_batch} x {len(ran)} = {per_batch * len(ran)}")
    n_batches = len(res.select_batches)
    sel_s = perf["phases"]["select_s"]
    mb = net.get("transport", {}).get("bytes_sent", 0) / 1e6
    print(f"{what}: {n_batches} select batches ({len(ran)} ran a GA), "
          f"{sum(b for _, b in res.select_batches)} client selections "
          f"drained, {sum(len(v) for v in res.selections.values())} "
          f"recorded; {perf['n_events']} events; fitness launches "
          f"{launches} ({expect})")
    print(f"{what}: wall {wall:.6f} s (loop {perf['wall_s']} s: net_s "
          f"{perf['phases']['net_s']}, select_s {sel_s}, "
          f"{perf['events_per_s']} events/s), select "
          f"{1e3 * sel_s / max(len(ran), 1):.3f} ms per batch that ran; "
          f"coverage {res.coverage}, t_full {res.t_full}, "
          f"{mb:.6f} MB on the wire")
    check(launches == (0 if per_batch is None else per_batch * len(ran)),
          f"{what}: ensemble_fitness launched {launches} times ({expect})")
    check(len(ran) > 0, f"{what}: no select batch ran a GA")
    return len(ran)


def async_paper_phase(torch, sync_exp, sync_res):
    """Configuration 8: the paper's 20 clients x 5 CNN families on the
    asynchronous event loop (ideal links), with the sync slice's datasets
    and trained models injected, observability on."""
    import numpy as np

    from repro_torch.kernels.ensemble_fitness import kernel
    from repro_torch.obs.metrics import Stopwatch
    from repro_torch.sim import Experiment

    spec = paper_spec(ASYNC_PAPER)
    spec.obs.enabled = True
    print("async config 8:", json.dumps({
        "spec": spec.to_dict(), "reduced": REDUCED,
        "injected": "the sync slice's datasets and trained models"},
        allow_nan=False))
    exp = Experiment(spec, datasets=sync_exp.datasets,
                     models=sync_exp.models, ccfg=sync_exp.ccfg,
                     device="cuda")
    torch.cuda.reset_peak_memory_stats()
    kernel.KERNEL.launches = 0
    sw = Stopwatch().start()
    res = exp.run()
    torch.cuda.synchronize()
    wall = sw.stop()
    launches = kernel.KERNEL.launches
    peak = torch.cuda.max_memory_allocated()
    per_batch = 2 * spec.selection.generations + 1
    n_ran = async_report("async config 8", res, wall, launches,
                         per_batch)
    cpu = stub_schedule(spec)
    same = {f: getattr(res.trace, f) == getattr(cpu, f)
            for f in ("events", "bench_sizes", "select_batches")}
    print(f"async config 8: card trace == CPU schedule (stub selection): "
          f"{same}")
    check(all(same.values()), f"async config 8: the card's trace departs "
                              f"from the CPU schedule: {same}")
    sync_sel = sync_res.perf["select_s"]
    arrivals = sum(len(b) for b in res.trace.bench_sizes.values())
    print(f"async config 8: select {res.perf['phases']['select_s']} s over "
          f"{n_ran} batches ({res.perf['phases']['select_s'] / n_ran:.6f} "
          f"s each) beside the sync round's one select() {sync_sel:.6f} s; "
          f"net_s (event loop + {arrivals} per-arrival forwards) "
          f"{res.perf['phases']['net_s']} s; peak "
          f"device memory {peak} bytes ({peak / 2**20:.1f} MiB)")
    check(res.coverage == 1.0, f"async config 8: coverage {res.coverage}")
    C = spec.data.n_classes
    acc = res.test_acc
    print(f"async config 8: fleet-mean test accuracy {float(acc.mean()):.6f}"
          f" (sync round {float(sync_res.test_acc.mean()):.6f}); metrics "
          f"{sorted(res.metrics.names())}")
    check(np.isfinite(acc).all() and acc.mean() > 1.0 / C,
          f"async config 8: fleet-mean test accuracy {acc.mean()} at or "
          "below chance")
    worse = {c: (v[0][1], v[-1][1]) for c, v in res.selections.items()
             if v and v[-1][1] < v[0][1] - 0.05}
    print(f"async config 8: clients whose last val-acc fell more than 0.05 "
          f"below their first: {worse}")
    check(not worse, f"async config 8: quality degraded over time: {worse}")
    return {"launches": launches, "batches": len(res.select_batches),
            "ran": n_ran, "wall_s": wall, "perf": res.perf,
            "test_acc": float(acc.mean()), "peak": peak}


def gossip_spec(capacity, obs):
    """Configuration 9: examples/gossip_churn.py's make_spec (the port's
    driver, repro_torch.examples.gossip_churn) at its full size (64
    clients x 2 models on a prediction world, small-world k = 4, lossy
    gossip with bounded inboxes, lognormal churn, GA 24 x 8), its obs
    section replaced by `obs`."""
    from repro_torch.examples.gossip_churn import make_spec
    from repro_torch.sim import ExperimentSpec
    g = GOSSIP
    d = make_spec(g["n"], g["mpc"], capacity, world_seed=g["world_seed"],
                  pop=g["pop"], gens=g["gens"], k=g["k"]).to_dict()
    d["obs"] = obs
    return ExperimentSpec.from_dict(d)


def _final_val_acc(res):
    import numpy as np
    return float(np.mean([v[-1][1] for v in res.selections.values() if v]))


def _strict_json(path):
    def no_constant(tok):
        raise ValueError(f"non-strict JSON token {tok}")
    with open(path) as f:
        return json.load(f, parse_constant=no_constant)


def gossip_churn_phase(torch):
    """Configuration 9 on the card at capacity 16 (traced, both sinks)
    and unbounded, and at capacity 16 on the CPU."""
    import tempfile

    from repro_torch.core.selection import selection_stats
    from repro_torch.kernels.ensemble_fitness import kernel
    from repro_torch.obs.metrics import Stopwatch
    from repro_torch.sim import Experiment

    g = GOSSIP
    per_batch = 2 * g["gens"] + 1
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        paths = {"metrics_json": str(Path(tmp) / "metrics.json"),
                 "perfetto": str(Path(tmp) / "trace.json")}
        traced = {"enabled": True, "trace": True,
                  "sinks": [{"name": k, "params": {"path": v}}
                            for k, v in paths.items()]}
        runs = (("bounded", g["capacity"], "cuda", traced),
                ("unbounded", g["n"] * g["mpc"], "cuda", {"enabled": True}),
                ("bounded cpu", g["capacity"], "cpu", {"enabled": True}))
        for name, cap, device, obs in runs:
            spec = gossip_spec(cap, obs)
            if name == "bounded":
                print("async config 9:", json.dumps(
                    {"spec": spec.to_dict(), "reduced": {},
                     "runs": [r[:3] for r in runs]}, allow_nan=False))
            kernel.KERNEL.launches = 0
            sw = Stopwatch().start()
            res = Experiment.from_spec(spec, device=device).run()
            if device == "cuda":
                torch.cuda.synchronize()
            wall = sw.stop()
            launches = kernel.KERNEL.launches
            evictions = sum(s.evictions for s in res.stores)
            what = f"async config 9 {name} (capacity {cap}, {device})"
            async_report(what, res, wall, launches,
                         per_batch if device == "cuda" else None)
            print(f"{what}: final mean val-acc {_final_val_acc(res):.6f}, "
                  f"evictions {evictions}, net {json.dumps(res.net)}")
            out[name] = (res, launches, wall)
        for kind, path in paths.items():
            doc = _strict_json(path)
            print(f"async config 9: sink {kind} wrote "
                  f"{Path(path).stat().st_size} bytes of strict JSON "
                  f"({len(doc)} top-level keys)")
    card, cpu = out["bounded"][0], out["bounded cpu"][0]
    same = {f: getattr(card.trace, f) == getattr(cpu.trace, f)
            for f in ("events", "net", "bench_sizes", "select_batches")}
    same["selection keys"] = (
        {c: [t for t, _ in v] for c, v in card.selections.items()}
        == {c: [t for t, _ in v] for c, v in cpu.selections.items()})
    print(f"async config 9: card == CPU at capacity {g['capacity']}: {same}")
    check(all(same.values()), f"async config 9: card and CPU traces "
                              f"differ: {same}")
    gap = _final_val_acc(out["unbounded"][0]) - _final_val_acc(card)
    print(f"async config 9: bounded-vs-unbounded final mean val-acc gap "
          f"{gap:+.6f} (limit {GOSSIP_GAP_MAX}); metrics frame names "
          f"{sorted(card.metrics.names())}")
    check(gap <= GOSSIP_GAP_MAX, f"async config 9: the bounded store lost "
                                 f"{gap} val-acc")
    sb = card.engine.store_batch
    acc_s, S_s = selection_stats(sb.preds, sb.labels)
    acc_err = float((acc_s - sb.acc).abs().max())
    s_err = float((S_s - sb.S).abs().max())
    batch = [5, 0, 5, g["n"] - 1, 0, 17, 5, 33]
    gathered = sb.gather(batch)
    rows_same = all(torch.equal(x, full[batch]) for x, full in zip(
        gathered, (sb.preds, sb.labels, sb.masks, sb.acc, sb.S)))
    print(f"async config 9: after the bounded run, cached acc vs "
          f"selection_stats max abs err {acc_err:.3e}, cached S "
          f"{s_err:.3e}; gather of {batch} == resident rows bitwise: "
          f"{rows_same}")
    check(acc_err == 0.0 and s_err <= TOL_GRAM,
          f"async config 9: cached statistics disagree: acc {acc_err}, "
          f"S {s_err}")
    check(rows_same, "async config 9: gathered rows differ from the "
                     "resident rows")
    return {name: {"launches": r[1], "ran": len(ran_batches(r[0])),
                   "wall_s": r[2], "perf": r[0].perf}
            for name, r in out.items()}


# ---- local training on the card, repeatable -----------------------------


def _probe_run(torch, family, fi, cfg, data, lr, batch, scoped):
    """PROBE_STEPS steps of local training's loop (train_local_model's
    model, optimizer and minibatches), under repeatable_cudnn or under
    the flags the process had. Returns (parameter names, every step's
    gradients, ms a step)."""
    import numpy as np
    import torch.nn.functional as F

    from repro_torch.fl.client import repeatable_cudnn
    from repro_torch.models.cnn import init_model
    from repro_torch.obs.metrics import Stopwatch
    from repro_torch.optim import make_optimizer
    model = init_model(family, fi, cfg).to("cuda")
    names = [n for n, _ in model.named_parameters()]
    params = list(model.parameters())
    opt = make_optimizer("momentum")
    state = opt.init(params)
    x = torch.as_tensor(data.x_tr, device="cuda")
    y = torch.as_tensor(data.y_tr, dtype=torch.int64, device="cuda")
    idx = torch.as_tensor(np.random.default_rng(fi).integers(
        0, len(x), (PROBE_STEPS, batch)), device="cuda")
    grads = []
    torch.cuda.synchronize()
    sw = Stopwatch().start()
    with repeatable_cudnn() if scoped else contextlib.nullcontext():
        for step in range(PROBE_STEPS):
            loss = F.cross_entropy(model(x[idx[step]]), y[idx[step]])
            g = torch.autograd.grad(loss, params)
            grads.append([t.clone() for t in g])
            opt.update(g, state, params, lr)
    torch.cuda.synchronize()
    return names, grads, 1e3 * sw.stop() / PROBE_STEPS


def _first_difference(torch, a, b, names):
    """(step, parameter) of the first gradient that differs, or None."""
    for step, (ga, gb) in enumerate(zip(a, b)):
        for name, x, y in zip(names, ga, gb):
            if not torch.equal(x, y):
                return step, name
    return None


def training_determinism_phase(torch):
    """Each family's local training, PROBE_STEPS steps on client 0's data
    of the sync slice, run four times in turns after a warm-up run: with
    the flags the process has (local training's before the scope existed),
    under repeatable_cudnn twice, and with the process's flags again.
    Prints the first step and parameter whose gradient differs between
    the two unscoped runs, and the ms a step of each; the two scoped runs
    must give the same gradients at every step."""
    from repro_torch.models.cnn import CNNConfig
    from repro_torch.sim.build import build_client_datasets
    spec = paper_spec()
    tr = spec.train
    data = build_client_datasets(spec.data, spec.seed)[0]
    cfg = CNNConfig(n_classes=spec.data.n_classes, width=tr.width,
                    in_channels=data.x_tr.shape[-1])
    cudnn = torch.backends.cudnn
    print(f"training determinism: cudnn.deterministic "
          f"{cudnn.deterministic}, cudnn.benchmark {cudnn.benchmark} "
          f"outside the scope; {PROBE_STEPS} steps of batch {tr.batch} a "
          f"run, client 0 ({len(data.x_tr)} training images)")
    out = {}
    for fi, fam in enumerate(tr.families):
        runs = [_probe_run(torch, fam, fi, cfg, data, tr.lr, tr.batch,
                           scoped)   # the first one warms up, untimed
                for scoped in (False, False, True, True, False)][1:]
        names = runs[0][0]
        free = _first_difference(torch, runs[0][1], runs[3][1], names)
        scoped = _first_difference(torch, runs[1][1], runs[2][1], names)
        ms_free = (runs[0][2] + runs[3][2]) / 2
        ms_scoped = (runs[1][2] + runs[2][2]) / 2
        at = ("no step" if free is None
              else "step %d, gradient of %s" % free)
        held = ("equal at every step" if scoped is None
                else "differ at step %d, %s" % scoped)
        print(f"training determinism {fam}: unscoped runs first differ at "
              f"{at}; scoped runs {held}"
              f"; ms a step unscoped {ms_free:.6f} ({runs[0][2]:.6f}, "
              f"{runs[3][2]:.6f}), scoped {ms_scoped:.6f} "
              f"({runs[1][2]:.6f}, {runs[2][2]:.6f})")
        check(scoped is None, f"training determinism {fam}: two runs "
                              f"under repeatable_cudnn differ at {scoped}")
        out[fam] = {"first_difference_unscoped": free,
                    "ms_step": (ms_free, ms_scoped)}
    return out


def _digests(res):
    """sha256 (first 16 hex digits) of the selected chromosomes' bytes
    and of every trained parameter's bytes, in client and family order."""
    import numpy as np
    chrom = hashlib.sha256(np.stack(res.chromosomes).tobytes()).hexdigest()
    params = hashlib.sha256()
    for key in sorted(res.models):
        for p in res.models[key][0].parameters():
            params.update(p.detach().cpu().numpy().tobytes())
    return chrom[:16], params.hexdigest()[:16]


def sync_repeat_phase(torch, first):
    """The sync slice a second time in this process, from the same spec:
    the fleet-mean test accuracy, the chromosomes and the trained
    parameters must be the first call's bits."""
    from repro_torch.sim import Experiment
    res = Experiment.from_spec(paper_spec(), device="cuda").run()
    torch.cuda.synchronize()
    a, b = float(first.test_acc.mean()), float(res.test_acc.mean())
    d1, d2 = _digests(first), _digests(res)
    print(f"sync slice, two calls: fleet-mean test accuracy {a!r} and "
          f"{b!r} (bit-equal: {a == b}); chromosome digests {d1[0]} and "
          f"{d2[0]}; trained-parameter digests {d1[1]} and {d2[1]}; "
          f"train_s {first.perf['train_s']:.6f} and "
          f"{res.perf['train_s']:.6f}")
    check(a == b and d1 == d2, "the sync slice is not repeatable on the "
                               "card: two calls from one seed differ")
    return {"test_acc": (a, b), "digests": (d1, d2),
            "train_s": (first.perf["train_s"], res.perf["train_s"])}


# ---- configurations 10-12: faults, admission, serving --------------------


@contextlib.contextmanager
def recorded_fitness_shapes(shapes):
    """Adds to `shapes` the (N, P, M) of every population the selection
    scores while the scope is open (the kernel's shapes on that path)."""
    from repro_torch.core import selection
    inner = selection._eval_fn

    def eval_fn(acc, S):
        fn = inner(acc, S)

        def recorded(pop):
            shapes.add(tuple(pop.shape))
            return fn(pop)
        return recorded
    selection._eval_fn = eval_fn
    try:
        yield shapes
    finally:
        selection._eval_fn = inner


def chaos_spec(name, **serve):
    """Configuration 10's or 11's spec file at its full size (its
    smoke_overrides dropped), `serve` replacing keys of its serve
    section."""
    from repro_torch.sim import ExperimentSpec
    with open(ROOT / CHAOS[name]) as f:
        d = json.load(f)
    d.pop("smoke_overrides", None)
    d.get("serve", {}).update(serve)
    return ExperimentSpec.from_dict(d)


def _timed_run(torch, exp, device, shapes=None):
    """(result, wall s, fitness launches) of one run, its launch count
    set to 0 just before it and read just after."""
    from repro_torch.kernels.ensemble_fitness import kernel
    from repro_torch.obs.metrics import Stopwatch
    kernel.KERNEL.launches = 0
    sw = Stopwatch().start()
    with recorded_fitness_shapes(set() if shapes is None else shapes):
        res = exp.run()
    if device == "cuda":
        torch.cuda.synchronize()
    return res, sw.stop(), kernel.KERNEL.launches


def faults_phase(torch):
    """Configuration 10: examples/specs/byzantine_ring.json at its full
    size on the card and on the CPU."""
    from repro_torch.sim import Experiment
    spec = chaos_spec("faults")
    print("async config 10:", json.dumps(
        {"spec": spec.to_dict(), "reduced": {}, "runs": ["cuda", "cpu"]},
        allow_nan=False))
    per_batch = 2 * spec.selection.generations + 1
    shapes = set()
    exp = Experiment(spec, device="cuda")
    card, wall, launches = _timed_run(torch, exp, "cuda", shapes)
    n_ran = async_report("async config 10 (cuda)", card, wall, launches,
                         per_batch)
    cpu, wall_c, launches_c = _timed_run(
        torch, Experiment(spec, device="cpu"), "cpu")
    async_report("async config 10 (cpu)", cpu, wall_c, launches_c, None)
    same = {f: getattr(card.trace, f) == getattr(cpu.trace, f)
            for f in ("events", "net", "bench_sizes", "select_batches")}
    print(f"async config 10: card == CPU: {same}; net faults "
          f"{json.dumps(card.net['faults'])}, admission "
          f"{json.dumps(card.net['admission'])}")
    check(all(same.values()), f"async config 10: card and CPU differ: "
                              f"{same}")
    byz = exp.faults.byzantine.clients
    held = {c: sorted({e.owner for e in st.entries if e is not None}
                      & byz)
            for c, st in enumerate(card.stores) if c not in byz}
    held = {c: v for c, v in held.items() if v}
    print(f"async config 10: byzantine owners {sorted(byz)}; honest "
          f"stores holding their payloads: {held}; fitness shapes "
          f"{sorted(shapes)}")
    check(not held, f"async config 10: honest stores hold byzantine "
                    f"payloads: {held}")
    return {"launches": launches, "ran": n_ran, "wall_s": wall,
            "perf": card.perf, "shapes": shapes}


def serve_drift_phase(torch):
    """Configuration 11: examples/specs/serve_drift.json at its full size
    on the card with the monitor on and off, and on the CPU with it
    off."""
    from repro_torch.sim import Experiment
    runs = (("monitor on", "cuda", True), ("monitor off", "cuda", False),
            ("monitor off cpu", "cpu", False))
    shapes = set()
    out = {}
    for name, device, monitor in runs:
        spec = chaos_spec("serve", monitor=monitor)
        if name == "monitor on":
            print("async config 11:", json.dumps(
                {"spec": spec.to_dict(), "reduced": {},
                 "runs": [r[:2] for r in runs]}, allow_nan=False))
        res, wall, launches = _timed_run(
            torch, Experiment(spec, device=device), device,
            shapes if device == "cuda" else None)
        what = f"async config 11 {name} ({device})"
        per_batch = 2 * spec.selection.generations + 1
        n_ran = async_report(what, res, wall, launches,
                             per_batch if device == "cuda" else None)
        print(f"{what}: net serve {json.dumps(res.net['serve'])}")
        out[name] = {"res": res, "launches": launches, "ran": n_ran,
                     "wall_s": wall, "perf": res.perf}
    on, off, cpu = (out[k]["res"] for k in ("monitor on", "monitor off",
                                            "monitor off cpu"))
    same = {f: getattr(off.trace, f) == getattr(cpu.trace, f)
            for f in ("events", "bench_sizes", "select_batches")}
    # the window accuracy is the one figure that depends on what the
    # card's and the CPU's GA picked (their random streams differ)
    net_card, net_cpu = copy.deepcopy(off.net), copy.deepcopy(cpu.net)
    w_card = net_card["serve"].pop("window_acc")
    w_cpu = net_cpu["serve"].pop("window_acc")
    same["net (window_acc aside)"] = net_card == net_cpu
    print(f"async config 11: monitor off, card == CPU: {same}; window "
          f"accuracy card {w_card}, CPU {w_cpu}")
    check(all(same.values()), f"async config 11: monitor-off card and CPU "
                              f"differ: {same}")
    sv, sv_off = on.net["serve"], off.net["serve"]
    monitor_ticks = sorted({t for t, _ in on.select_batches}
                           - {t for t, _ in off.select_batches})
    ran = set(ran_batches(on))
    missing = [t for t in monitor_ticks if t not in ran]
    print(f"async config 11: monitor on: {sv['n_queries']} queries (off: "
          f"{sv_off['n_queries']}), {sv['n_drift_events']} drift event, "
          f"{sv['n_reselections']} re-selections; {len(monitor_ticks)} "
          f"select ticks only the monitor made, each ran a GA: "
          f"{not missing}; fitness shapes {sorted(shapes)}")
    check(sv["n_queries"] == sv_off["n_queries"], "async config 11: the "
          "monitor changed the query traffic")
    check(sv["n_drift_events"] == 1 and sv["n_reselections"] >= 1,
          f"async config 11: drift {sv['n_drift_events']}, re-selections "
          f"{sv['n_reselections']}")
    check(not missing, f"async config 11: monitor ticks {missing} ran no "
                       "GA")
    for v in out.values():
        del v["res"]
    out["shapes"] = shapes
    return out


DRIVERS = {  # the port's example drivers (phase 4g) -> their --json rows
    "lossy_links": [f"repair_drop{d}_{t}" for d in (0, 10, 30)
                    for t in ("off", "on")],
    "quickstart": ["local_ensemble", "fedpae"],
    "async_decentralized": [f"client{c}" for c in range(5)] + ["fleet"],
    "gossip_churn": ["bounded", "unbounded", "checkpoint"],
    "pareto_front": ["pareto_client0"],
    "beyond_paper": ["fedpae", "clustered_gossip", "des"],
    "byzantine_peers": [f"byz{p}_{a}" for p in (0, 10, 30)
                        for a in ("gated", "ungated", "allpeers")],
    "serve_drift": ["serve_monitored", "serve_frozen", "determinism"]
    + [f"curve_thr{t}" for t in (5, 12, 25, 40)],
}


def driver_launches(name, mod, runs):
    """The fitness launches a driver's runs must make, as {2 G + 1:
    selections}: one a sync run, one a select batch that ran a GA in an
    async run, and pareto_front's one single-client selection outside
    any run."""
    parts = {}
    for res in runs:
        if res.engine is None:
            continue
        per = 2 * res.spec.selection.generations + 1
        n = 1 if res.mode == "sync" else len(ran_batches(res))
        parts[per] = parts.get(per, 0) + n
    if name == "pareto_front":
        per = 2 * mod.make_spec().selection.generations + 1
        parts[per] = parts.get(per, 0) + 1
    return parts


def single_fitness_timing(torch, shape):
    """The single-client ensemble_fitness entry at `shape` (P, M), held
    against its plain version and timed against it with its bound."""
    import numpy as np

    from repro_torch.kernels.ensemble_fitness import kernel, ref
    P, M = shape
    pop, acc, S = (x[0] for x in make_inputs(
        torch, np.random.default_rng(2), 1, P, M))

    def run_kernel():
        return kernel.ensemble_fitness(pop, acc, S)

    def run_plain():
        return ref.ensemble_fitness_ref(pop, acc, S)
    got = run_kernel()
    torch.cuda.synchronize()
    err = max(float((g - w).abs().max()) for g, w in zip(got, run_plain()))
    check(err <= TOL, f"ensemble_fitness[single] at {shape} disagrees "
                      f"with its plain version: {err}")
    p1, k1, k2, p2 = (time_ms(torch, fn) for fn in
                      (run_plain, run_kernel, run_kernel, run_plain))
    k_ms, p_ms = (k1 + k2) / 2, (p1 + p2) / 2
    own_ms, _, n_rec, _ = device_ms(torch, run_kernel)
    (b_ms, b_by), _ = fitness_bound(pop[None])
    share(f"ensemble_fitness[single] {shape}", b_ms, k_ms)
    print(f"kernel ensemble_fitness[single] at a pareto_front shape (P, M) "
          f"= {shape}: max abs err {err:.3e}; kernel {k_ms:.6f} ms "
          f"({k1:.6f}, {k2:.6f}), plain {p_ms:.6f} ms ({p1:.6f}, "
          f"{p2:.6f}); device {own_ms} ms ({n_rec} of 50 recorded); bound "
          f"{b_ms:.6e} ms ({b_by}), share {b_ms / k_ms:.6f}")
    return err, (k_ms, p_ms, b_ms, b_by)


def drivers_phase(torch):
    """Phase 4g: the port's example drivers 1-8 at their full sizes on the
    card, in process, each through its own main(["--json", path]): its
    asserts must pass, its rows read back as strict JSON with the
    expected names, and its fitness launches (reset just before) equal 2
    G + 1 times its selections (driver_launches). lossy_links runs again
    on the CPU: its rows must equal the card's. pareto_front's
    single-client fitness shapes are then timed."""
    import importlib
    import tempfile

    from repro_torch.kernels.ensemble_fitness import kernel
    from repro_torch.obs.metrics import Stopwatch, json_ready
    from repro_torch.sim.experiment import Experiment

    runs = []
    inner = Experiment.run

    def recorded_run(self):
        res = inner(self)
        runs.append(res)
        return res

    out, batched, single = {}, set(), {}
    print(f"drivers: {CARD}")
    with tempfile.TemporaryDirectory() as tmp:
        for name, want_rows in DRIVERS.items():
            mod = importlib.import_module(f"repro_torch.examples.{name}")
            path = str(Path(tmp) / f"{name}.json")
            runs.clear()
            found = set()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            kernel.KERNEL.launches = 0
            sw = Stopwatch().start()
            Experiment.run = recorded_run
            try:
                with recorded_fitness_shapes(found):
                    rows = mod.main(["--json", path])
            except AssertionError as e:
                raise SmokeFailure(f"driver {name}: its own assert failed: "
                                   f"{e}") from e
            finally:
                Experiment.run = inner
            torch.cuda.synchronize()
            wall = sw.stop()
            launches = kernel.KERNEL.launches
            peak = torch.cuda.max_memory_allocated()
            parts = driver_launches(name, mod, runs)
            expect = sum(per * n for per, n in parts.items())
            doc = _strict_json(path)
            names = [r["name"] for r in doc]
            print(f"driver {name}: asserts passed; {len(doc)} rows read back "
                  f"as strict JSON, names {names}; fitness launches "
                  f"{launches} (expected {expect} = "
                  f"{' + '.join(f'{p} x {n}' for p, n in parts.items())}); "
                  f"{len(runs)} runs; wall {wall:.6f} s; peak device memory "
                  f"{peak} bytes ({peak / 2**20:.1f} MiB); {CARD}")
            check(names == want_rows, f"driver {name}: rows {names}, "
                                      f"expected {want_rows}")
            check(doc == json.loads(json.dumps(json_ready(rows),
                                               allow_nan=False)),
                  f"driver {name}: the rows written differ from those "
                  "main returned")
            check(launches == expect, f"driver {name}: {launches} fitness "
                                      f"launches, expected {expect}")
            batched |= {s for s in found if len(s) == 3}
            single[name] = sorted(s for s in found if len(s) == 2)
            out[name] = {"launches": launches, "expected": expect,
                         "wall_s": wall, "peak": peak, "runs": len(runs)}
        runs.clear()
        mod = importlib.import_module("repro_torch.examples.lossy_links")
        cpu_path = str(Path(tmp) / "lossy_links_cpu.json")
        sw = Stopwatch().start()
        mod.main(["--json", cpu_path, "--device", "cpu"])
        cpu_s = sw.stop()
        with open(Path(tmp) / "lossy_links.json") as a, open(cpu_path) as b:
            same = a.read() == b.read()
        print(f"driver lossy_links: card rows == CPU rows (full size, "
              f"CPU {cpu_s:.6f} s): {same}")
        check(same, "driver lossy_links: the card's rows differ from the "
                    "CPU's")
    single = {k: v for k, v in single.items() if v}
    print(f"drivers: fitness shapes single {single}, batched "
          f"{sorted(batched)}")
    check(list(single) == ["pareto_front"], f"drivers: single-client "
          f"fitness shapes {single}, expected pareto_front's alone")
    timings, err = {}, 0.0
    for shape in single["pareto_front"]:   # the population, then 2 P
        e, timings[shape] = single_fitness_timing(torch, shape)
        err = max(err, e)
    out["shapes"] = batched
    out["single"] = (timings, err)
    return out


def serve_paper_phase(torch, sync_exp, sync_res):
    """Configuration 12: configuration 8 (the sync slice's datasets and
    trained models injected) serving Poisson queries with a label shift
    and a covariate shift, the monitor on."""
    import numpy as np

    from repro_torch.core.bench import PredictionStore
    from repro_torch.sim import Experiment, ExperimentSpec
    d = paper_spec(ASYNC_PAPER).to_dict()
    d["serve"] = SERVE_PAPER
    spec = ExperimentSpec.from_dict(d)
    print("async config 12:", json.dumps({
        "spec": spec.to_dict(), "reduced": REDUCED,
        "injected": "the sync slice's datasets and trained models"},
        allow_nan=False))
    devices = {p.device.type for m, _ in sync_exp.models.values()
               for p in m.parameters()}
    check(devices == {"cuda"}, f"async config 12: models on {devices}")
    exp = Experiment(spec, datasets=sync_exp.datasets,
                     models=sync_exp.models, ccfg=sync_exp.ccfg,
                     device="cuda")
    batch = SERVE_PAPER["traffic"]["params"]["batch"]
    forwards = []   # (rows, members) of every masked forward
    inner = PredictionStore.predictions

    def counted(self, x, mask=None):
        forwards.append((len(x), None if mask is None
                         else int(np.asarray(mask).sum())))
        return inner(self, x, mask)
    torch.cuda.reset_peak_memory_stats()
    shapes = set()
    PredictionStore.predictions = counted
    try:
        res, wall, launches = _timed_run(torch, exp, "cuda", shapes)
    finally:
        PredictionStore.predictions = inner
    peak = torch.cuda.max_memory_allocated()
    per_batch = 2 * spec.selection.generations + 1
    n_ran = async_report("async config 12", res, wall, launches, per_batch)
    sv = res.net["serve"]
    query_fwd = [m for rows, m in forwards if rows == batch]
    k = spec.selection.ensemble_k
    print(f"async config 12: net serve {json.dumps(sv)}; {len(query_fwd)} "
          f"masked forwards of {batch}-query batches on the card for "
          f"{sv['n_batches']} batches (a second one a batch for the "
          f"frozen shadow ensemble once a client breached), members a "
          f"forward {min(query_fwd)}-{max(query_fwd)}")
    check(len(query_fwd) >= sv["n_batches"] > 0
          and all(1 <= m <= k for m in query_fwd),
          "async config 12: a query batch was not answered by a masked "
          "forward of the selected members")
    off = ExperimentSpec.from_dict({**d, "serve": {**SERVE_PAPER,
                                                   "monitor": False}})
    stub = StubServing(off)
    stub_schedule(off, serving=stub)
    print(f"async config 12: queries served {sv['n_queries']} + dropped "
          f"{sv['n_dropped']} against {stub.offered} offered by the "
          f"stub-selection schedule (monitor off)")
    check(sv["n_queries"] + sv["n_dropped"] == stub.offered,
          "async config 12: queries lost or invented")
    check(sv["n_drift_events"] == 2 and sv["n_reselections"] >= 1,
          f"async config 12: drift {sv['n_drift_events']}, re-selections "
          f"{sv['n_reselections']}")
    acc = res.test_acc
    perf = res.perf
    print(f"async config 12: regret {sv['regret']}, latency p50 "
          f"{sv['latency_p50']} s, p99 {sv['latency_p99']} s (virtual), "
          f"window accuracy {sv['window_acc']}; net_s "
          f"{perf['phases']['net_s']} s against select_s "
          f"{perf['phases']['select_s']} s; peak device memory {peak} "
          f"bytes; fleet-mean test accuracy {float(acc.mean()):.6f} (sync "
          f"round {float(sync_res.test_acc.mean()):.6f}); fitness shapes "
          f"{sorted(shapes)}")
    check(np.isfinite(acc).all() and acc.mean() > 1.0 / spec.data.n_classes,
          "async config 12: fleet-mean test accuracy at or below chance")
    return {"launches": launches, "ran": n_ran, "wall_s": wall,
            "perf": perf, "serve": sv, "peak": peak, "shapes": shapes}


def fitness_path_phase(torch, shapes):
    """The fitness kernel at the (N, P, M) shapes configurations 10-12
    launched: held against its plain version and, at each
    configuration's widest batches, timed against it with its bound."""
    import numpy as np

    from repro_torch.kernels.ensemble_fitness import kernel, ref
    rng = np.random.default_rng(1)
    widest = {what: sorted(s for s in found
                           if s[0] == max(n for n, _, _ in found))
              for what, found in shapes.items() if found}
    timed = set().union(*map(set, widest.values()))
    max_err, timings = 0.0, {}
    for shape in sorted(set().union(*shapes.values())):
        pop, acc, S = make_inputs(torch, rng, *shape)

        def run_kernel(pop=pop, acc=acc, S=S):
            return kernel.ensemble_fitness_batched(pop, acc, S)

        def run_plain(pop=pop, acc=acc, S=S):
            return ref.ensemble_fitness_batched_ref(pop, acc, S)
        got = run_kernel()
        torch.cuda.synchronize()
        err = max(float((g - w).abs().max())
                  for g, w in zip(got, run_plain()))
        max_err = max(max_err, err)
        check(err <= TOL, f"ensemble_fitness at {shape} disagrees with its "
                          f"plain version: {err}")
        line = f"kernel ensemble_fitness at a path shape {shape}: max abs " \
               f"err {err:.3e}"
        if shape in timed:
            p1, k1, k2, p2 = (time_ms(torch, fn) for fn in
                              (run_plain, run_kernel, run_kernel, run_plain))
            k_ms, p_ms = (k1 + k2) / 2, (p1 + p2) / 2
            (b_ms, b_by), _ = fitness_bound(pop)
            timings[shape] = (k_ms, p_ms, b_ms, b_by)
            share(f"ensemble_fitness[batched] {shape}", b_ms, k_ms)
            line += (f"; kernel {k_ms:.6f} ms ({k1:.6f}, {k2:.6f}), plain "
                     f"{p_ms:.6f} ms, bound {b_ms:.6f} ms ({b_by}), share "
                     f"{b_ms / k_ms:.4f}")
        print(line)
    print(f"fitness path shapes: the widest batches a configuration "
          f"{json.dumps(widest)}")
    return max_err, timings


# ---- configurations 13-15: the compiled array world; the restack path ----


def fleet_spec(smoke=False):
    """Configuration 13: examples/specs/fleet_sweep.json at its full size,
    or at its smoke size (its smoke_overrides: 256 clients)."""
    from repro_torch.sim import ExperimentSpec
    with open(ROOT / FLEET_SPEC) as f:
        d = json.load(f)
    overrides = d.pop("smoke_overrides")
    if smoke:
        d["data"]["n_clients"] = overrides["data.n_clients"]
    return ExperimentSpec.from_dict(d)


def simloop_spec(n, k, backend, params):
    """benchmarks/run.py's simloop spec: a dissemination-only fleet on a
    small world, ideal links (configurations 14 and 14b)."""
    from repro_torch.sim import ExperimentSpec
    return ExperimentSpec.from_dict({
        "data": {"kind": "none", "n_clients": n, "models_per_client": 1},
        "selection": {"enabled": False},
        "network": {"topology": "small_world", "topology_k": k,
                    "transport": {"name": "gossip",
                                  "params": {"base_latency": 0.05,
                                             "jitter": 0.0,
                                             "drop_prob": 0.0}},
                    "gossip": "push"},
        "schedule": {"mode": "async", "select_during_run": False,
                     "backend": {"name": backend, "params": params}},
        "seed": 0})


def compiled_world_spec():
    """Configuration 15: configuration 9's prediction world and network
    (no inbox cap, which the compiled backend refuses) with
    fleet_sweep's repair, on the compiled backend, unbounded stores and
    no selection during the run."""
    d = gossip_spec(None, {"enabled": False}).to_dict()
    d["network"]["transport"]["params"].pop("inbox_capacity")
    d["network"]["repair"] = {"name": "anti_entropy",
                              "params": dict(FLEET_REPAIR)}
    d["schedule"].update(select_during_run=False, backend={
        "name": "compiled", "params": {"chunk_ticks": COMPILED_CHUNK}})
    from repro_torch.sim import ExperimentSpec
    return ExperimentSpec.from_dict(d)


def _chunk_profile(torch, fn, state, t0, k_lo, online, ticks):
    """One chunk under torch.profiler: kernel launches (a tick and in
    all), device busy seconds, wall seconds (profiler on) and the
    largest kernels."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs.metrics import Stopwatch
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sw = Stopwatch().start()
        out = fn(state, t0, k_lo, online)
        torch.cuda.synchronize()
        wall = sw.stop()
    kernels = [e for e in prof.key_averages()
               if e.device_type.name == "CUDA" and e.self_device_time_total]
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    n = sum(e.count for e in kernels)
    top = [(e.key[:70], e.count, e.self_device_time_total / 1e3)
           for e in sorted(kernels, key=lambda e: -e.self_device_time_total)
           [:6]]
    return out, {"launches": n, "per_tick": n / ticks, "busy_s": busy,
                 "wall_s": wall, "busy_share": busy / wall, "top": top}


def compiled_run(torch, spec, device, profile=False):
    """One compiled-backend run through Experiment.run(): (result, what
    simulate_compiled returned (have_tick included), wall s, peak device
    bytes, the key blocks as {first key: width}, the profile of the first
    chunk when asked). The profiled run's wall includes the profiler."""
    from repro_torch.obs.metrics import Stopwatch
    from repro_torch.sim import Experiment, compiled
    raw, blocks, prof = [], {}, {}
    inner_sim, inner_make = compiled.simulate_compiled, compiled._make_chunk_fn

    def sim(*a, **kw):
        raw.append(inner_sim(*a, **kw))
        return raw[-1]

    def make(W, chunk_ticks, Kb):
        fn = inner_make(W, chunk_ticks, Kb)

        def chunk(state, t0, k_lo, online):
            blocks[k_lo] = Kb
            if not profile or prof:
                return fn(state, t0, k_lo, online)
            out, p = _chunk_profile(torch, fn, state, t0, k_lo, online,
                                    chunk_ticks)
            prof.update(p)
            return out
        return chunk
    exp = Experiment.from_spec(spec, device=device)
    exp.build()
    cuda = device == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    compiled.simulate_compiled, compiled._make_chunk_fn = sim, make
    try:
        sw = Stopwatch().start()
        res = exp.run()
        if cuda:
            torch.cuda.synchronize()
        wall = sw.stop()
    finally:
        compiled.simulate_compiled = inner_sim
        compiled._make_chunk_fn = inner_make
    peak = torch.cuda.max_memory_allocated() if cuda else None
    return res, raw[0], wall, peak, blocks, prof


def _compiled_line(what, res, wall, peak):
    p = res.perf
    mem = ("" if peak is None
           else f", peak device memory {peak / 2**30:.6f} GiB")
    return (f"{what} [{CARD}]: wall {wall:.6f} s (backend wall_s "
            f"{p['wall_s']}, "
            f"build_s {p['phases']['build_s']}, scan_s "
            f"{p['phases']['scan_s']}), {p['n_ticks']} ticks, "
            f"{p['ticks_per_s']} ticks/s; coverage {res.coverage}, t_full "
            f"{res.t_full}{mem}")


def _same_compiled(a, b, ra, rb):
    """Which of have_tick, net, t_full, n_ticks two runs share bitwise."""
    import numpy as np
    return {"have_tick": bool(np.array_equal(a["have_tick"],
                                             b["have_tick"])),
            "net": ra.net == rb.net,
            "t_full": ra.t_full == rb.t_full or (
                math.isnan(ra.t_full) and math.isnan(rb.t_full)),
            "n_ticks": a["n_ticks"] == b["n_ticks"]}


def compiled_fleet_phase(torch):
    """Configurations 13, 14 and 14b: the compiled array world on the
    card at fleet_sweep's full and smoke sizes (the smoke size also on
    the CPU), benchmarks/run.py's 10,000-client simloop tier, and the
    deterministic tier against the port's event loop on the CPU."""
    full = fleet_spec()
    print("compiled config 13:", json.dumps(
        {"spec": full.to_dict(), "reduced": {},
         "runs": ["cuda full", "cuda full profiled", "cuda smoke",
                  "cpu smoke"]}, allow_nan=False))
    res, raw, wall, peak, _, _ = compiled_run(torch, full, "cuda")
    print(_compiled_line("compiled config 13 (2048 clients, cuda)", res,
                         wall, peak) + f"; net {json.dumps(res.net)}")
    want = FLEET_FULL
    same = {"net": res.net == want["net"],
            "t_full": res.t_full == want["t_full"],
            "n_ticks": raw["n_ticks"] == want["n_ticks"],
            "coverage": res.coverage == 1.0}
    print(f"compiled config 13: card == the JAX package's full-size run "
          f"on the CPU (FLEET_FULL): {same}")
    check(all(same.values()), f"compiled config 13: the card's full-size "
                              f"run differs from the reference's: {same}")
    res_p, _, _, _, _, prof = compiled_run(torch, full, "cuda",
                                                profile=True)
    print(f"compiled config 13 [{CARD}]: first chunk under torch.profiler: "
          f"{prof['launches']} kernel launches ({prof['per_tick']:.6f} a "
          f"tick), device busy {prof['busy_s']:.6f} s of {prof['wall_s']:.6f}"
          f" s wall ({prof['busy_share']:.6f}); largest kernels "
          f"{json.dumps(prof['top'])}")
    check(res_p.net == res.net, "compiled config 13: the profiled run "
                                "differs from the unprofiled one")
    smoke = fleet_spec(smoke=True)
    card, raw_c, wall_c, peak_c, _, _ = compiled_run(torch, smoke, "cuda")
    cpu, raw_h, wall_h, _, _, _ = compiled_run(torch, smoke, "cpu")
    print(_compiled_line("compiled config 13 smoke (256 clients, cuda)",
                         card, wall_c, peak_c))
    print(_compiled_line("compiled config 13 smoke (256 clients, cpu)", cpu,
                         wall_h, None))
    same = _same_compiled(raw_c, raw_h, card, cpu)
    print(f"compiled config 13 smoke: card == CPU bitwise: {same}")
    check(all(same.values()), f"compiled config 13 smoke: card and CPU "
                              f"differ: {same}")
    s = SIMLOOP_FULL
    big = simloop_spec(s["n"], s["k"], "compiled",
                       {"tick": s["tick"], "chunk_ticks": s["chunk_ticks"]})
    print("compiled config 14:", json.dumps(
        {"spec": big.to_dict(), "reduced": {}, "runs": ["cuda"]},
        allow_nan=False))
    res, raw, wall, peak, blocks, _ = compiled_run(torch, big, "cuda")
    n = s["n"]
    print(_compiled_line(f"compiled config 14 ({n} clients, cuda)", res,
                         wall, peak) + f"; key blocks (first key: width) "
          f"{blocks}; n_sent "
          f"{res.net['transport']['n_sent']}, n_accepted "
          f"{res.net['gossip']['n_accepted']}")
    check(res.coverage == 1.0, f"compiled config 14: coverage "
                               f"{res.coverage}")
    check(res.net["gossip"]["n_accepted"] == n * (n - 1),
          f"compiled config 14: n_accepted {res.net['gossip']['n_accepted']}"
          f" != K (N - 1) = {n * (n - 1)}")
    check(len(blocks) >= 2 and sum(blocks.values()) == n,
          f"compiled config 14: key blocks {blocks} do not shard the "
          f"{n} keys")
    p = SIMLOOP_PARITY
    ev_spec = simloop_spec(p["n"], p["k"], "event", {})
    co_spec = simloop_spec(p["n"], p["k"], "compiled", {"tick": p["tick"]})
    from repro_torch.obs.metrics import Stopwatch
    from repro_torch.sim import Experiment
    sw = Stopwatch().start()
    ev = Experiment.from_spec(ev_spec, device="cpu").run()
    wall_ev = sw.stop()
    co, _, wall_co, _, _, _ = compiled_run(torch, co_spec, "cuda")
    print(f"compiled config 14b [{CARD}] ({p['n']} clients, k = "
          f"{p['k']}, tick {p['tick']}): event loop on the CPU {wall_ev:.6f} s, compiled "
          f"on the card {wall_co:.6f} s; net equal: {ev.net == co.net}; "
          f"t_full {ev.t_full} and {co.t_full}")
    check(ev.net == co.net, "compiled config 14b: the deterministic tier's "
                            "net dicts differ")
    check(abs(ev.t_full - co.t_full) <= p["tick"] + 1e-9,
          "compiled config 14b: t_full differs by more than a tick")


def _val_acc(results):
    import numpy as np
    return float(np.mean([float(r["val_accuracy"]) for r in
                          results.values()]))


def compiled_world_phase(torch, shapes):
    """Configuration 15: the prediction world through the compiled backend
    on the card and on the CPU, then one select() over every client."""
    import numpy as np

    from repro_torch.kernels.ensemble_fitness import kernel
    from repro_torch.obs.metrics import Stopwatch
    spec = compiled_world_spec()
    g = GOSSIP
    print("compiled config 15:", json.dumps(
        {"spec": spec.to_dict(), "reduced": {}, "runs": ["cuda", "cpu"]},
        allow_nan=False))
    runs = {}
    for device in ("cuda", "cpu"):
        res, raw, wall, peak, _, _ = compiled_run(torch, spec, device)
        print(_compiled_line(f"compiled config 15 ({device})", res, wall,
                             peak) + f"; net {json.dumps(res.net)}")
        runs[device] = (res, raw)
    (card, raw_c), (cpu, raw_h) = runs["cuda"], runs["cpu"]
    same = _same_compiled(raw_c, raw_h, card, cpu)
    same["stores"] = all(
        [e and e.model_id for e in a.entries]
        == [e and e.model_id for e in b.entries]
        and np.array_equal(a.preds, b.preds)
        for a, b in zip(card.stores, cpu.stores))
    print(f"compiled config 15: card == CPU: {same}")
    check(all(same.values()), f"compiled config 15: card and CPU differ: "
                              f"{same}")
    picked = {}
    for device, res in (("cuda", card), ("cpu", cpu)):
        kernel.KERNEL.launches = 0
        sw = Stopwatch().start()
        with recorded_fitness_shapes(shapes if device == "cuda" else set()):
            picked[device] = res.engine.select()
        if device == "cuda":
            torch.cuda.synchronize()
        sel_s = sw.stop()
        if device == "cuda":
            launches = kernel.KERNEL.launches
        sizes = {int(r["chromosome"].sum()) for r in picked[device].values()}
        print(f"compiled config 15 [{CARD}]: select() over "
              f"{len(picked[device])} "
              f"clients on the {device}: {sel_s:.6f} s, chromosome sizes "
              f"{sorted(sizes)}, fleet-mean val acc "
              f"{_val_acc(picked[device]):.6f}")
        check(sorted(picked[device]) == list(range(g["n"])) and
              sizes == {g["k"]}, f"compiled config 15: the {device} select "
                                 f"did not pick k members for every client")
    per = 2 * g["gens"] + 1
    gap = abs(_val_acc(picked["cuda"]) - _val_acc(picked["cpu"]))
    print(f"compiled config 15: fitness launches {launches} (expected "
          f"{per}); card-vs-CPU fleet-mean val-acc gap {gap:.6f} (limit "
          f"{GOSSIP_GAP_MAX})")
    check(launches == per, f"compiled config 15: ensemble_fitness launched "
                           f"{launches} times, expected {per}")
    check(gap <= GOSSIP_GAP_MAX, f"compiled config 15: card and CPU "
                                 f"selections differ by {gap} val-acc")
    return {"launches": launches, "perf": card.perf}


def restack_phase(torch, sync_res, shapes):
    """One select() of the sync slice's fleet on the restack path and one
    on the resident path, on the card, in turns (restack, resident,
    resident, restack)."""
    from repro_torch.core.engine import SelectionEngine
    from repro_torch.kernels.ensemble_fitness import kernel
    from repro_torch.obs.metrics import Stopwatch
    eng = sync_res.engine
    engines = {resident: SelectionEngine(
        sync_res.stores, eng.nsga, seed=eng.seed, ensemble_k=eng.ensemble_k,
        device_resident=resident, device="cuda")
        for resident in (False, True)}
    check(engines[False].store_batch is None, "restack: the engine kept a "
                                              "device mirror")
    engines[True].select()       # the resident mirror's first flush
    times, launches, picked = {False: [], True: []}, {}, {}
    for resident in (False, True, True, False):
        kernel.KERNEL.launches = 0
        torch.cuda.synchronize()
        sw = Stopwatch().start()
        with recorded_fitness_shapes(shapes):
            picked[resident] = engines[resident].select()
        torch.cuda.synchronize()
        times[resident].append(sw.stop())
        launches[resident] = kernel.KERNEL.launches
    per = 2 * eng.nsga.generations + 1
    k = eng.ensemble_k
    same = sum(bool((picked[True][c]["chromosome"]
                     == picked[False][c]["chromosome"]).all())
               for c in picked[True])
    gap = abs(_val_acc(picked[True]) - _val_acc(picked[False]))
    sizes = {int(r["chromosome"].sum()) for p in picked.values()
             for r in p.values()}
    print(f"restack [{CARD}]: select() of the sync slice's "
          f"{len(picked[True])} "
          f"clients: restack {times[False]} s, resident {times[True]} s; "
          f"fitness launches restack {launches[False]}, resident "
          f"{launches[True]} (expected {per}); chromosomes equal for "
          f"{same} clients, by outcome: sizes {sorted(sizes)}, fleet-mean "
          f"val acc {_val_acc(picked[False]):.6f} and "
          f"{_val_acc(picked[True]):.6f} (gap {gap:.6f}, limit "
          f"{GOSSIP_GAP_MAX})")
    check(launches[False] == per and launches[True] == per,
          f"restack: ensemble_fitness launched {launches}, expected {per}")
    check(sizes == {k} and gap <= GOSSIP_GAP_MAX,
          f"restack: the two paths' selections differ in outcome: sizes "
          f"{sizes}, gap {gap}")
    return {"launches": launches[False], "restack_s": times[False],
            "resident_s": times[True]}


def baseline_probs(name, datasets, n_classes, fl, device):
    """(accuracies, every final test-probability array) of one baseline
    run: the module's predict_probs is wrapped for the run."""
    from repro_torch.fl import baselines
    seen, orig = [], baselines.predict_probs

    def predict_probs(*args, **kw):
        out = orig(*args, **kw)
        seen.append(out)
        return out
    baselines.predict_probs = predict_probs
    try:
        acc = baselines.BASELINES[name](datasets, n_classes, fl,
                                        device=device)
    finally:
        baselines.predict_probs = orig
    return acc, seen


def profile_fedavg_round(torch, datasets, n_classes, fl):
    """One FedAvg round (rounds=1: with its data upload, init and the
    final evaluation of the test sets) under torch.profiler: launches and
    the device's busy share of the wall."""
    import dataclasses

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.fl.baselines import BASELINES
    from repro_torch.obs.metrics import Stopwatch
    one = dataclasses.replace(fl, rounds=1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sw = Stopwatch().start()
        BASELINES["fedavg"](datasets, n_classes, one, device="cuda")
        torch.cuda.synchronize()
        wall = sw.stop()
    kernels = [e for e in prof.key_averages()
               if e.device_type.name == "CUDA" and e.self_device_time_total]
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    n = sum(e.count for e in kernels)
    print(f"tables [{CARD}]: one profiled FedAvg round ({len(datasets)} "
          f"clients x {fl.local_steps} steps, with upload, init and the "
          f"test-set evaluation): wall {wall:.6f} s, device busy "
          f"{busy:.6f} s ({busy / wall:.4f} of wall), {n} kernel launches;"
          " by kernel:")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {e.self_device_time_total / 1e3:10.3f} ms  "
              f"{e.count:6d} x  {e.key[:90]}")


def tables_phase(torch, sync_exp, sync_res):
    """Phase 16, the paper's tables: (a) the seven baselines at full
    width on cell 1's world (Table I, II and IV rows, the clustered-gossip
    saving, one profiled FedAvg round); (b) each baseline at a small size
    on the card and on the CPU; (c) FedAvg and FML twice at full width;
    (d) Table I's script end to end at paper_cnn.smoke()."""
    import dataclasses

    import numpy as np

    from repro_torch.benchmarks import table1_accuracy
    from repro_torch.benchmarks import table2_negative_transfer as table2
    from repro_torch.benchmarks.common import make_clients
    from repro_torch.benchmarks.table4_cost import analytic_flops
    from repro_torch.configs import paper_cnn
    from repro_torch.fl.baselines import BASELINES, FLConfig
    from repro_torch.fl.clustering import ClusterState, clustering_savings
    from repro_torch.kernels.ensemble_fitness import kernel
    from repro_torch.models.cnn import CNNConfig
    from repro_torch.obs.metrics import Stopwatch
    from repro_torch.sim import fedpae_config

    spec = sync_exp.spec
    datasets, C = sync_exp.datasets, spec.data.n_classes
    fams = tuple(spec.train.families)
    N = len(datasets)
    fl = FLConfig(families=fams, **TABLES_FL)
    print("tables config:", json.dumps({
        "world": "cell 1 (the slice's datasets and trained models)",
        "fl": dataclasses.asdict(fl), "reduced": REDUCED_TABLES},
        allow_nan=False))

    # (a) the seven baselines at full width
    key = f"synthetic{C}|{spec.data.alpha}|{spec.seed}"
    cell = {"local": sync_exp.local_ensemble().tolist(),
            "fedpae": sync_res.test_acc.tolist(),
            "fedpae_local_frac": sync_res.local_frac.tolist()}
    steps = N * fl.rounds * fl.local_steps
    rows = {}
    for name in BASELINES:
        torch.cuda.synchronize()
        sw = Stopwatch().start()
        acc = BASELINES[name](datasets, C, fl, device="cuda")
        torch.cuda.synchronize()
        secs = sw.stop()
        check(acc.shape == (N,) and np.isfinite(acc).all()
              and ((acc >= 0) & (acc <= 1)).all(),
              f"{name}: bad test accuracies {acc}")
        cell[name] = acc.tolist()
        rows[name] = {"s": secs, "steps_per_s": steps / secs}
    for m in table1_accuracy.METHODS:
        a = np.array(cell[m])
        ci = 1.96 * a.std() / max(1, len(a)) ** 0.5
        timing = (f"; {rows[m]['s']:.6f} s, {rows[m]['steps_per_s']:.3f} "
                  f"local steps/s ({steps} steps)" if m in rows else "")
        print(f"table I [{CARD}] {key} {m}: {a.mean():.6f} ± {ci:.6f}"
              + timing)
    table = table2.negative_transfer({key: cell})
    for m, (lo, hi) in table.items():
        print(f"table II {key} {m}: relative change against local "
              f"min {lo:+.6f}, max {hi:+.6f}")
    print(f"table II: FedPAE >= local on every client (min_rel >= 0): "
          f"{table['fedpae'][0] >= 0}")

    ccfg = CNNConfig(n_classes=C, width=fl.width,
                     in_channels=datasets[0].x_tr.shape[-1])
    D = int(np.mean([len(d.x_tr) for d in datasets]))
    V = int(np.mean([len(d.x_va) for d in datasets]))
    fp = fedpae_config(spec)
    fedpae_flops, round_flops = analytic_flops(fp, fl, ccfg, N, D, V)
    perf = sync_res.perf
    t_fedpae = sum(v for v in perf.values() if isinstance(v, float))
    print(f"table IV [{CARD}]: fedpae {fedpae_flops / 1e9:.6f} GFLOP "
          f"analytic ({fp.max_epochs} epochs), {t_fedpae:.6f} s measured "
          f"(cell 1's round: {json.dumps(perf, allow_nan=False)}); fedavg "
          f"{round_flops / 1e9:.6f} GFLOP analytic ({fl.rounds} rounds), "
          f"{rows['fedavg']['s']:.6f} s measured")

    # the clustered-gossip saving from cell 1's chosen owners
    # (examples/beyond_paper.py:38-45)
    st = ClusterState.init(N)
    for c, chrom in enumerate(sync_res.chromosomes):
        st.update(c, sync_res.stores[c].owners[chrom > 0.5].tolist())
    saving = clustering_savings(st, models_per_client=len(fams))
    print(f"clustered gossip from cell 1's selections: {saving:.6f} of the "
          "full graph's exchange volume saved")
    profile_fedavg_round(torch, datasets, C, fl)

    # (b) card against CPU at a small size, from the port's own init
    sm = TABLES_SMALL
    small, _ = make_clients(sm["n_clients"], sm["alpha"], sm["n_samples"],
                            sm["n_classes"], size=sm["size"], seed=0)
    fl_s = FLConfig(rounds=sm["rounds"], local_steps=sm["local_steps"],
                    width=sm["width"])
    gaps = {}
    for name in BASELINES:
        _, card = baseline_probs(name, small, sm["n_classes"], fl_s, "cuda")
        _, cpu = baseline_probs(name, small, sm["n_classes"], fl_s, "cpu")
        gaps[name] = max(float(np.abs(a - b).max())
                         for a, b in zip(card, cpu))
    print(f"tables: card vs CPU final test probabilities ({sm}), max abs "
          f"gap by method: {json.dumps(gaps, allow_nan=False)} (limit "
          f"{TABLES_CPU_TOL})")
    check(max(gaps.values()) <= TABLES_CPU_TOL,
          f"baselines: card and CPU disagree: {gaps}")

    # (c) FedAvg and FML twice at full width: the same bits
    fl_r = dataclasses.replace(fl, rounds=TABLES_REPEAT_ROUNDS)
    for name in ("fedavg", "fml"):
        runs = [baseline_probs(name, datasets, C, fl_r, "cuda")[1]
                for _ in range(2)]
        same = all(np.array_equal(a, b) for a, b in zip(*runs))
        print(f"tables: {name} twice at full width, {fl_r.rounds} rounds: "
              f"final test probabilities bitwise equal: {same}")
        check(same, f"{name} is not repeatable on the card")

    # (d) Table I's script end to end on the card
    pc = paper_cnn.smoke()
    per = 2 * pc["fedpae"].nsga.generations + 1
    out = ROOT / "results" / "torch" / "table1.json"
    kernel.KERNEL.launches = 0
    sw = Stopwatch().start()
    grid = table1_accuracy.run_grid(pc=pc, alphas=(0.1,), rounds=2,
                                    device="cuda", out=str(out))
    torch.cuda.synchronize()
    wall = sw.stop()
    launches = kernel.KERNEL.launches
    table1_accuracy.print_table(grid)
    check(_strict_json(out) == grid, "table1.json is not the grid")
    print(f"tables (smoke) [{CARD}]: run_grid of {len(grid)} cell in "
          f"{wall:.6f} s; ensemble_fitness launches {launches}, expected "
          f"{per} per selection")
    check(launches == per * len(grid),
          f"run_grid: ensemble_fitness launched {launches} times, "
          f"expected {per * len(grid)}")
    return launches


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
    timings at the slice's, zamba2-7b's shared-attention, the
    long-context shape and the zoo's three (ZOO_FLASH_SHAPES). At the
    slice's shape the kernel is timed on contiguous (B, H, S, hd) inputs,
    as earlier versions were timed, and through ops.py on the same data
    in the model layout (B, S, H, hd), in turns with SDPA."""
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
                (LONG_SHAPE, "bfloat16", 0, 0.0)]
             + [(shape, "bfloat16", 0, 0.0) for shape in ZOO_FLASH_SHAPES]
             + [(shape, "bfloat16", 0, 0.0) for shape in SHARD_FLASH_SHAPES])
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
                                          LONG_SHAPE, *ZOO_FLASH_SHAPES,
                                          *SHARD_FLASH_SHAPES)
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
    profile_report(prof, wall, f"{label}: profiled prefill (both "
                   "members)", top=8)

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
    profile_report(prof, wall, f"{label}: profiled decode step (one "
                   "member)")


def profile_report(prof, wall, what, top=0):
    """Prints a profiled window's device busy time and share of `wall`
    (s), its kernel launches and its `top` largest kernels."""
    events = [e for e in prof.key_averages()
              if e.device_type.name == "CUDA" and e.self_device_time_total]
    busy = sum(e.self_device_time_total for e in events) / 1e6
    print(f"{what}: wall {wall:.6f} s, device busy {busy:.6f} s "
          f"({busy / wall:.4f} of wall), {sum(e.count for e in events)} "
          "kernel launches")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"  {e.self_device_time_total / 1e3:10.3f} ms  "
              f"{e.count:6d} x  {e.key[:90]}")


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
    for shape in SSD_SHARD_SHAPES:   # a rank's heads under the sharded step
        cases.append(("ssd_scan", shape + (128,), "bfloat16", ssd_case(
            torch, gen, *shape, "bfloat16", split=True)))
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
        if dtype == "bfloat16" and shape[:-1] in (SSD_SLICE, WKV_SLICE,
                                                  *SSD_SHARD_SHAPES):
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
            key = name if shape[:-1] in (SSD_SLICE, WKV_SLICE) \
                else (name, shape[:-1])
            out[key] = dict(err=y_err, ms=k_ms, plain_ms=p_ms,
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


def _grad_errs(got, want, names=WKV_GRADS):
    """Each gradient's max abs error over its largest |entry|."""
    return {n: float((g.double() - w.double()).abs().max()
                     / w.double().abs().max().clamp_min(1e-30))
            for n, g, w in zip(names, got, want) if w is not None}


def _hold_grads(errs, dtype, what, act=WKV_GRADS[:3],
                kernel="wkv_scan_bwd"):
    """The gradients of the activation dtype (`act`: dr, dk, dv; dx, dB,
    dC for ssd) within WKV_BWD_TOL of each max |g| in their dtype, the
    fp32 gradients (dlogw, du, ds0 where given; ddt, dA_log, dD) within
    WKV_BWD_F32_TOL."""
    check(all(e <= (WKV_BWD_TOL[dtype] if n in act else WKV_BWD_F32_TOL)
              for n, e in errs.items()),
          f"{kernel} at {what} disagrees with its plain version: {errs}")


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


SSD_GRADS = ("dx", "ddt", "dA_log", "dB", "dC", "dD")
SSD_ACT = ("dx", "dB", "dC")   # the gradients in the activation dtype
SSD_BWD_CHECK = (2, 512, 4, 64, 64)
SSD_MB = (2, 2048, 112, 64, 64)   # a zamba2-7b training microbatch
SSD_BWD_F64_TOL = 1e-6   # fp32 gradients against float64, of each max |g|


def ssd_bwd_cost(Bb, S, nh, hd, ds, elem_bytes):
    """The backward's bytes and least work, as ssd_cost counts the
    forward's: x, dy and dx, B, C, dB and dC in the activation type; dt,
    ddt, A_log, D, dA_log and dD in fp32 (the model's case: no gradient
    on h_T; the forward's chunk states are the kernel's own choice and
    not counted). The least work is the chunked form's backward: each
    product of the forward's least work (ssd_cost) takes two products
    backward, so twice its FLOP."""
    nbytes = (elem_bytes * (3 * Bb * S * nh * hd + 4 * Bb * S * ds)
              + 4 * (2 * Bb * S * nh + 4 * nh))
    return {rate: (nbytes, 2 * c[1], 2 * c[2]) for rate, c in
            ssd_cost(Bb, S, nh, hd, ds, elem_bytes).items()}


def ssd_bwd_design_bytes(Bb, S, nh, hd, ds, elem_bytes, G, Q=128):
    """The bytes each kernel of the ssd_scan backward moves in its own
    design (csrc/ssd_scan_bwd.cu's header), each tensor it reads or
    writes counted once, no d h_T: {kernel: bytes}. The chunk states (the
    gradient's and the forward's) are fp32 (Bb, nh, S / Q, hd, ds), the
    head groups' parts of dB and dC fp32 (Bb, ceil(nh / G), S, ds)."""
    nc = S // Q
    act = elem_bytes * Bb * S * nh * hd        # x, dy or dx
    bc = elem_bytes * Bb * S * ds              # B, C, dB or dC
    states = 4 * Bb * nh * nc * hd * ds        # one chunk-state tensor
    step = 4 * Bb * S * nh                     # dt or ddt
    decay = 4 * Bb * nh * nc
    parts = 4 * Bb * -(-nh // G) * S * ds      # dB's or dC's group parts
    chunk = 4 * Bb * nc * nh                   # dA_log's or dD's chunk parts
    return {"state": act + bc + step + states + decay,
            "pass": 2 * states + decay,
            "chunk": (3 * act + 2 * bc + 2 * step + 2 * states + 2 * parts
                      + 2 * chunk + 8 * nh),
            "sum": 2 * parts + 2 * bc + 2 * chunk + 12 * nh}


def ssd_bwd_case(torch, gen, Bb, S, nh, hd, ds, dtype, strong=False):
    """x, dt, A_log, bc (B and C as one (Bb, S, 2 ds) tensor, as
    ssm_forward makes them), D, dy and d h_T; `strong`: dt in [3, 4] and
    A_log in [1, 1.5], a log decay down to -18 a step."""
    F = torch.nn.functional
    n = lambda *s: torch.randn(s, generator=gen, device="cuda")  # noqa
    u = lambda *s: torch.rand(s, generator=gen, device="cuda")   # noqa
    dt_ = getattr(torch, dtype)
    dt, A_log = ((3.0 + u(Bb, S, nh), 1.0 + 0.5 * u(nh)) if strong
                 else (F.softplus(n(Bb, S, nh)), 0.5 * n(nh)))
    return (n(Bb, S, nh, hd).to(dt_), dt, A_log, n(Bb, S, 2 * ds).to(dt_),
            1.0 + 0.3 * n(nh), n(Bb, S, nh, hd).to(dt_), n(Bb, nh, hd, ds))


def ssd_grads_float64(torch, x, dt, A_log, B, C, D, dy, dhT):
    """torch.autograd of the ssd recurrence in float64 on the card: the
    gradients of sum(y dy) + sum(h_T dhT) with respect to x, dt, A_log,
    B, C, D."""
    ins = [a.detach().double().requires_grad_() for a in
           (x, dt, A_log, B, C, D)]
    xd, dtd, ad, bd, cd, Dd = ins
    A = -ad.exp()
    h = xd.new_zeros(x.shape[0], x.shape[2], x.shape[3], B.shape[-1])
    ys = []
    for t in range(x.shape[1]):
        h = h * (dtd[:, t] * A).exp()[:, :, None, None] \
            + (dtd[:, t, :, None] * xd[:, t])[..., None] * bd[:, t, None, None]
        ys.append((h * cd[:, t, None, None]).sum(-1))
    y = torch.stack(ys, 1) + xd * Dd[None, None, :, None]
    loss = (y * dy.double()).sum() + (h * dhT.double()).sum()
    return torch.autograd.grad(loss, ins)


def ssd_bwd_phase(torch):
    """The ssd_scan backward kernel against its plain version (and, at
    the check shape, autograd of a float64 recurrence), through
    ops.ssd_scan's autograd Function with B and C views of one tensor;
    timed at the training shapes."""
    import torch.nn.functional as F

    from repro_torch.kernels.ssd_scan import kernel as sk
    from repro_torch.kernels.ssd_scan import ops as so
    from repro_torch.kernels.ssd_scan import ref as sr
    gen = torch.Generator(device="cuda").manual_seed(2)
    out = {"err": 0.0}
    cases = [(SSD_BWD_CHECK, d, False) for d in ("float32", "bfloat16")] + [
        ((2, 256, 2, 64, 64), "float32", True),
        ((2, 256, 2, 64, 64), "bfloat16", True),
        ((2, 100, 2, 32, 16), "float32", False)] + [
        (shape, d, False) for shape in ((2, 256, 5, 64, 64),
                                        (2, 128, 3, 64, 64))
        for d in ("float32", "bfloat16")]
    for shape, dtype, strong in cases:
        x, dt, A_log, bc, D, dy, dhT = ssd_bwd_case(torch, gen, *shape,
                                                    dtype, strong)
        ds = shape[-1]
        ins = [a.clone().requires_grad_() for a in (x, dt, A_log, bc, D)]
        Bv, Cv = ins[3].split(ds, dim=-1)
        fwd, bwd = sk.KERNEL.launches, sk.KERNEL_BWD.launches
        y, hT = so.ssd_scan(ins[0], ins[1], ins[2], Bv, Cv, ins[4])
        g = torch.autograd.grad([y, hT], ins, [dy, dhT])
        torch.cuda.synchronize()
        check(sk.KERNEL.launches == fwd + 1
              and sk.KERNEL_BWD.launches == bwd + 1,
              f"ssd_scan_bwd at {shape} {dtype}: the forward and backward "
              "kernels did not launch once each")
        got = [g[0], g[1], g[2], g[3][..., :ds], g[3][..., ds:], g[4]]
        B, C = bc.split(ds, dim=-1)
        pad = (-shape[1]) % 128
        p4 = lambda a: F.pad(a, (0, 0, 0, 0, 0, pad))  # noqa: E731
        p3 = lambda a: F.pad(a, (0, 0, 0, pad))        # noqa: E731
        want = list(sr.ssd_scan_bwd_ref(p4(x), p3(dt), A_log, p3(B), p3(C),
                                        D, p4(dy), dhT))
        for i in (0, 1, 3, 4):
            want[i] = want[i][:, :shape[1]]
        errs = _grad_errs(got, want, SSD_GRADS)
        finite = all(bool(torch.isfinite(a).all()) for a in got)
        line = (f"kernel ssd_scan_bwd {shape} {dtype}"
                f"{' strong decay (down to -18 a step)' if strong else ''}, "
                f"d h_T: against the plain backward "
                + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
                + f" of each max |g|; finite {finite}")
        if shape == SSD_BWD_CHECK:
            e64 = _grad_errs(got, ssd_grads_float64(
                torch, x, dt, A_log, B, C, D, dy, dhT), SSD_GRADS)
            line += ("; against autograd of a float64 recurrence "
                     + ", ".join(f"{n} {e:.3e}" for n, e in e64.items()))
            if dtype == "float32":
                check(max(e64.values()) <= SSD_BWD_F64_TOL,
                      f"ssd_scan_bwd fp32 is {e64} from float64")
        print(line)
        check(finite, f"ssd_scan_bwd at {shape} {dtype} strong {strong}: "
                      "non-finite gradients")
        _hold_grads(errs, dtype, f"{shape} {dtype} strong {strong}",
                    SSD_ACT, "ssd_scan_bwd")
        out["err"] = max(out["err"], max(
            float((a.float() - w.float()).abs().max())
            for a, w in zip(got, want)))
        del ins, y, hT, g, got, want
    # the training shapes, as a layer calls the scan: bf16, B and C views
    # of one tensor, h_T unused (no d h_T); checked, then timed in turns
    # against the plain backward; at SSD_MB two calls must give the same
    # bits
    for shape in (SSD_MB, SSD_SLICE):
        x, dt, A_log, bc, D, dy, _ = ssd_bwd_case(torch, gen, *shape,
                                                  "bfloat16")
        B, C = bc.split(shape[-1], dim=-1)
        _, _, states = sk.ssd_scan_fwd(x, dt, A_log, B, C, D)

        def run_kernel():
            return sk.ssd_scan_bwd(x, dt, A_log, B, C, D, states, dy)

        def run_plain():
            return sr.ssd_scan_bwd_ref(x, dt, A_log, B, C, D, dy)
        bwd = sk.KERNEL_BWD.launches
        got = run_kernel()
        torch.cuda.synchronize()
        check(sk.KERNEL_BWD.launches == bwd + 1,
              f"ssd_scan_bwd at {shape} did not launch once")
        want = run_plain()
        errs = _grad_errs(got, want, SSD_GRADS)
        finite = all(bool(torch.isfinite(a).all()) for a in got)
        print(f"kernel ssd_scan_bwd {shape} bfloat16 as a layer calls it "
              "(no d h_T): against the plain backward "
              + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
              + f" of each max |g|; finite {finite}")
        check(finite, f"ssd_scan_bwd at {shape}: non-finite gradients")
        _hold_grads(errs, "bfloat16", f"{shape} as a layer calls it",
                    SSD_ACT, "ssd_scan_bwd")
        out["err"] = max(out["err"], max(
            float((a.float() - w.float()).abs().max())
            for a, w in zip(got, want)))
        if shape == SSD_MB:
            again = run_kernel()
            same = [n for n, a, b in zip(SSD_GRADS, got, again)
                    if torch.equal(a, b)]
            print(f"kernel ssd_scan_bwd {shape}: two calls bitwise equal in "
                  f"{same} of {list(SSD_GRADS)}")
            check(len(same) == 6, f"ssd_scan_bwd at {shape} is not "
                  f"deterministic: only {same} agree bitwise")
            del again
        del got, want
        p1, k1, k2, p2 = (time_ms(torch, fn, iters=it, warmup=1)
                          for fn, it in ((run_plain, 1), (run_kernel, 10),
                                         (run_kernel, 10), (run_plain, 1)))
        own_ms, _, n_rec, parts = device_ms(torch, run_kernel, iters=5,
                                            name="ssd_scan_bwd")
        counts = ssd_bwd_cost(*shape, 2)
        b_ms, b_by = roofline(*counts[False], False, 2)
        k_ms, p_ms = (k1 + k2) / 2, (p1 + p2) / 2
        share(f"ssd_scan_bwd {shape}", b_ms, k_ms)
        nbytes, flops, tc_flops = counts[False]
        print(f"  time ssd_scan_bwd {shape} bf16 (no d h_T): kernel "
              f"{k_ms:.6f} ms ({k1:.6f}, {k2:.6f}), plain {p_ms:.6f} ms "
              f"({p1:.6f}, {p2:.6f}) per call; on the device (profiler, "
              f"{n_rec} launches recorded over 5 calls) {own_ms} ms a call; "
              f"bound {b_ms:.6f} ms ({b_by}: {nbytes} bytes; twice the "
              f"forward's least work, {flops} fp32-factor FLOP at {TERMS} "
              f"bf16 products each and {tc_flops} exact bf16 FLOP), share "
              f"{b_ms / k_ms:.4f}; no single PyTorch call computes this "
              "function (library: none)")
        G = sk.heads_per_block(shape[0], shape[2], shape[1] // 128,
                               torch.cuda.get_device_properties(0)
                               .multi_processor_count)
        design = ssd_bwd_design_bytes(*shape, 2, G)
        moved = sum(design.values())
        print(f"  its own design moves {moved} bytes at G = {G} heads a "
              f"chunk block, {1e3 * moved / PEAK_BYTES:.6f} ms at "
              f"{PEAK_BYTES / 1e12} TB/s")
        for key, ms in parts.items():
            own = next((k for k in design if f"ssd_scan_bwd_{k}" in key),
                       None)
            rate = ("" if own is None else f"; {design[own]} bytes, "
                    f"{design[own] / ms / 1e6:.1f} GB/s")
            print(f"    {ms:.6f} ms a launch  {key[:90]}{rate}")
        out[shape] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                          bound_by=b_by, device_ms=own_ms)
        if shape == SSD_SLICE:
            out.update(out[shape])
        del x, dt, A_log, bc, B, C, D, dy, states
        torch.cuda.empty_cache()
    return out


TRAIN_CHECK = {"steps": 10, "batch": 4, "seq": 64, "seed": 0, "lr": 3e-4}
TRAIN_LOSS_RTOL = 1e-5     # card against CPU, fp32 smoke losses
TRAIN_GRAD_TOL = 1e-4      # card against CPU, each parameter's first-step
                           # gradient, of its max |g|
TRAIN_FULL = {"steps": 6, "batch": 4, "seq": 2048, "microbatches": 2,
              "seed": 0}
TRAINS = {  # arch -> n_layers: the depth cut (REDUCED_TRAIN says why)
    "qwen2.5-3b": 36, "rwkv6-3b": 32, "zamba2-7b": 45,
    "qwen3-moe-235b-a22b": 1}
TRAIN_BWD_LAUNCHES = {"rwkv6-3b": 384, "zamba2-7b": 540}   # in 6 steps
TRAIN_CHECKS = ["qwen2.5-3b", "rwkv6-3b", "zamba2-7b", "qwen3-moe-235b-a22b",
                "llama-3.2-vision-11b", "musicgen-medium"]
# the weights are drawn on the card from a seeded CUDA generator
# (`_draw`), as the pods' are, and handed to train(params=)
REDUCED_TRAIN = {"zamba2-7b": "n_layers 81 -> 45 (7 super-blocks of 6 "
                 "Mamba2 blocks and a tail of 3, both shared attention "
                 "blocks in use): 6956658896 parameters with adamw's fp32 "
                 "moments and gradients do not fit one 80 GB card (45 "
                 "layers do)",
                 "qwen3-moe-235b-a22b": "n_layers 94 -> 1: 3.73e9 "
                 "parameters x 16 bytes (bf16 weights, fp32 moments and "
                 "accumulator, bf16 gradients) = 59.7 GB beside the "
                 "microbatches' activations; 2 layers add 10.3e9 x 16 bytes"}


def smoke_train(torch, arch, device):
    """The smoke `arch` in fp32 on `device` from parameters drawn on the
    CPU (as train() draws them): the first batch's gradients of the
    step's loss (the moe family's with 0.01 x its router aux; vlm with
    image embeddings from a seed, the same every batch; audio with
    codebooks), on the CPU, by name, then TRAIN_CHECK's adamw steps as
    train() takes them (weight decay 0.01, warmup_cosine over 10 steps)
    on the same TokenPipeline batches; returns (grads, losses)."""
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
    pipe = TokenPipeline(cfg.vocab, c["batch"], c["seq"],
                         n_codebooks=cfg.n_codebooks, seed=c["seed"])
    _, img = zoo_inputs(cfg, c["batch"], 1, c["seed"], device)
    batches = [{k: torch.as_tensor(hb[k], device=device)
                for k in ("tokens", "labels")}
               for hb, _ in zip(pipe, range(c["steps"]))]
    if img is not None:
        batches = [dict(b, img_emb=img) for b in batches]
    named = dict(params.named_parameters())
    logits, aux = tf.forward(params, cfg, batches[0]["tokens"], mode="train",
                             img_emb=img)
    loss = cross_entropy(logits, batches[0]["labels"],
                         cfg.final_logit_softcap)
    if cfg.n_experts:
        loss = loss + 0.01 * aux
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


def _zero_grad(torch, fn_class, index):
    """A planted fault: gradient `index` of the autograd Function
    `fn_class`'s backward replaced by zeros. Returns the function that
    undoes it."""
    orig = fn_class.backward

    def backward(ctx, *grads_out):
        grads = list(orig(ctx, *grads_out))
        grads[index] = torch.zeros_like(grads[index])
        return tuple(grads)
    fn_class.backward = staticmethod(backward)
    return lambda: setattr(fn_class, "backward", staticmethod(orig))


def _scan_kernels():
    """family -> (the kernel module of its scan, the scan's autograd
    Function, the planted fault's gradient index and what it zeroes: the
    wkv backward's dk, the ssd backward's ddt, which moves in_dt, dt_bias
    and A_log). A family with no scan kernel is absent."""
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.wkv_scan import kernel as wkv_kernel
    from repro_torch.kernels.wkv_scan import ops as wkv_ops
    return {"ssm": (wkv_kernel, wkv_ops._WkvScan, 1, "dk of the wkv backward"),
            "hybrid": (ssd_kernel, ssd_ops._SsdScan, 1,
                       "ddt of the ssd backward")}


def train_check_phase(torch):
    """Smoke training in fp32 of TRAIN_CHECKS (qwen2.5-3b, rwkv6-3b,
    zamba2-7b, qwen3-moe-235b-a22b, llama-3.2-vision-11b and
    musicgen-medium), on the card (the scan kernels forward and backward)
    and on the CPU (plain versions) from the same parameters and batches:
    first-step gradients and the losses agree, the card's loss falls,
    and every rwkv6 and Mamba2 layer's scan went through both of its
    kernels. Then the same
    card run with a planted fault (the wkv backward's dk, the ssd
    backward's ddt zeroed) must fail the gradient check."""
    from repro_torch.configs import get_smoke
    c = TRAIN_CHECK
    for arch in TRAIN_CHECKS:
        cfg = get_smoke(arch)
        kern, fn_class, index, what = _scan_kernels().get(
            cfg.family, (None,) * 4)
        kname = kern and kern.KERNEL.name
        libs = (kern.KERNEL, kern.KERNEL_BWD) if kern else ()
        before = [lib.launches for lib in libs]
        on_card = smoke_train(torch, arch, "cuda")
        fwd, bwd = ([lib.launches - b for lib, b in zip(libs, before)]
                    or (0, 0))
        on_cpu = smoke_train(torch, arch, "cpu")
        rel, gerr, worst = _train_gaps(on_card, on_cpu)
        losses = on_card[1]
        scan = (f"{kname} launches {fwd}, {kname}_bwd {bwd}" if kern
                else "no scan kernel")
        print(f"train check {arch} smoke fp32, {c}: card losses {losses}, "
              f"CPU {on_cpu[1]}; max relative loss difference {rel:.3e} "
              f"(limit {TRAIN_LOSS_RTOL}); largest first-step gradient "
              f"difference {gerr:.3e} of its max |g| ({worst}; limit "
              f"{TRAIN_GRAD_TOL}); {scan}")
        check(rel <= TRAIN_LOSS_RTOL, f"{arch}: card and CPU training "
              f"losses differ by {rel} relative")
        check(gerr <= TRAIN_GRAD_TOL, f"{arch}: card and CPU gradients of "
              f"{worst} differ by {gerr} of its max |g|")
        check(losses[-1] < losses[0], f"{arch}: the card's loss did not "
              f"fall: {losses}")
        if kern is None:
            continue
        per = cfg.n_layers * (c["steps"] + 1)  # a gradient pass and steps
        check(fwd == 2 * per and bwd == per, f"{arch}: {kname} launches "
              f"{fwd} / {bwd}, expected {2 * per} / {per}")
        undo = _zero_grad(torch, fn_class, index)
        try:
            f_rel, f_gerr, f_worst = _train_gaps(
                smoke_train(torch, arch, "cuda"), on_cpu)
        finally:
            undo()
        print(f"train check {arch} with a planted fault ({what} zeroed): "
              f"loss difference {f_rel:.3e}, gradient difference "
              f"{f_gerr:.3e} ({f_worst})")
        check(f_gerr > TRAIN_GRAD_TOL, f"{arch}: the gradient check did "
              "not see the planted fault")


def full_train_phase(torch, arch, n_layers):
    """train() of `arch` at full width (and depth, unless `n_layers` cuts
    it) on the card: adamw and warmup_cosine, batch 4 x 2048 in 2
    microbatches, 6 steps from seed 0; then one more step (a fresh adamw
    state) under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data import TokenPipeline
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch.train import scaled_config, train
    from repro_torch.optim import make_optimizer, warmup_cosine
    c = TRAIN_FULL
    cfg = scaled_config(arch, "full")
    if n_layers is not None:
        cfg = cfg.replace(n_layers=n_layers)
    print(f"train {arch} config:", json.dumps({
        "train": dict(c, arch=arch, n_layers=n_layers),
        "reduced": REDUCED_TRAIN.get(arch, "nothing"), "model": {
            k: getattr(cfg, k) for k in (
                "family", "n_layers", "d_model", "n_heads", "n_kv_heads",
                "head_dim", "d_ff", "vocab", "rwkv_head_dim", "ssm_state",
                "ssm_head_dim", "shared_attn_every", "n_shared_attn",
                "n_experts", "top_k", "capacity_factor", "attn_impl",
                "attn_chunk", "dtype", "source")}},
        allow_nan=False))
    kern = _scan_kernels().get(cfg.family, (None,))[0]
    kname = kern and kern.KERNEL.name
    libs = (kern.KERNEL, kern.KERNEL_BWD) if kern else ()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    drawn = _draw(torch, cfg, c["seed"])
    for lib in libs:
        lib.launches = 0
    params, losses, cfg, secs = train(
        arch, "full", steps=c["steps"], batch=c["batch"], seq=c["seq"],
        seed=c["seed"], microbatches=c["microbatches"], log_every=1,
        device="cuda", n_layers=n_layers, params=drawn)
    del drawn
    fwd, bwd = [lib.launches for lib in libs] or (0, 0)
    peak = torch.cuda.max_memory_allocated()
    n_par = sum(p.numel() for p in params.parameters())
    tok = c["batch"] * c["seq"]
    later = secs[1:]
    print(f"train {arch}: {n_par} parameters; losses {losses}; step "
          f"seconds {secs}; steps 2-"
          f"{c['steps']}: {sum(later) / len(later):.6f} s a step, "
          f"{tok * len(later) / sum(later):.1f} tokens/s; peak device "
          f"memory {peak} bytes ({peak / 2**30:.2f} GiB); "
          + (f"{kname} / {kname}_bwd launches {fwd} / {bwd} in "
             f"{c['steps']} steps" if kern else "no scan kernel"))
    check(all(map(math.isfinite, losses)),
          f"{arch}: non-finite training losses {losses}")
    if cfg.n_experts:   # the step's loss is cross-entropy + 0.01 x aux
        from repro_torch.models import transformer as tf
        from repro_torch.models.common import cross_entropy
        hb = next(iter(TokenPipeline(cfg.vocab, 2, c["seq"], seed=2)))
        with torch.no_grad():
            logits, aux = tf.forward(params, cfg, torch.as_tensor(
                hb["tokens"], device="cuda"), mode="train")
            ce = float(cross_entropy(logits, torch.as_tensor(
                hb["labels"], device="cuda")))
        del logits
        print(f"train {arch}: after the steps, a held-out batch of 2 x "
              f"{c['seq']} tokens: cross-entropy {ce:.6f}, router aux "
              f"{float(aux):.6f} (each step's loss above is cross-entropy "
              "+ 0.01 x aux)")
        check(math.isfinite(ce) and math.isfinite(float(aux)),
              f"{arch}: non-finite loss {ce} or aux {float(aux)}")
    n_mb = c["microbatches"]
    if kern is not None:
        want = (2 * cfg.n_layers * n_mb, cfg.n_layers * n_mb)
        check((fwd, bwd) == (c["steps"] * want[0], c["steps"] * want[1]),
              f"{arch}: {kname} launches {fwd} / {bwd} in {c['steps']} "
              f"steps, expected {want} a step (n_layers x microbatches x 2 "
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
    scans = [e for e in kernels if kname and kname in e.key]
    if scans:
        print(f"train {arch}: the {kname} kernels of the profiled step: "
              + "; ".join(f"{e.key[:60]} {e.self_device_time_total / 1e3:.3f}"
                          f" ms ({e.count} x)" for e in scans))
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


def _tree_equal(torch, a, b):
    """Whether two caches (dicts, lists, tensors) are bitwise equal."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_tree_equal(torch, a[k], b[k])
                                            for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_tree_equal(torch, x, y)
                                        for x, y in zip(a, b))
    return bool(torch.equal(a, b))


def _tree_err(a, b):
    """Largest |a - b| over matching tensors of two caches."""
    if isinstance(a, dict):
        return max(_tree_err(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return max(_tree_err(x, y) for x, y in zip(a, b))
    return float((a.float().cpu() - b.float().cpu()).abs().max())


MODEL_CHECKS = {  # arch -> config overrides: smoke fp32, card vs CPU
    "rwkv6-3b": {}, "zamba2-7b": {},
    "qwen3-moe-235b-a22b": PALLAS, "arctic-480b": PALLAS,
    "command-r-plus-104b": PALLAS, "llama-3.2-vision-11b": PALLAS,
    "musicgen-medium": PALLAS}


def zoo_inputs(cfg, B, S, seed, device):
    """Tokens ((B, S), or (B, S, ncb) for audio) from TokenPipeline(seed)
    and, for vlm, image embeddings (B, n_img_tokens, d_vision) in bf16
    from a numpy seed, on `device`."""
    import numpy as np
    import torch

    from repro_torch.data import TokenPipeline
    toks = next(iter(TokenPipeline(cfg.vocab, B, S,
                                   n_codebooks=cfg.n_codebooks,
                                   seed=seed)))["tokens"]
    img = None
    if cfg.family == "vlm":
        img = torch.as_tensor(np.random.default_rng(seed).standard_normal(
            (B, cfg.n_img_tokens, cfg.d_vision)).astype(np.float32)).to(
            torch.bfloat16).to(device)
    return torch.as_tensor(toks, device=device), img


def model_check_phase(torch):
    """The smoke configs of the recurrent families and of the rest of the
    zoo in fp32 (attn_impl "pallas": flash_attention on the card where
    the config is kv_major; vlm with images, audio with codebooks): the
    same weights give the same prefill on the card (kernels) as on the
    CPU (plain versions)."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import transformer as tf
    for arch, overrides in MODEL_CHECKS.items():
        cfg = get_smoke(arch).replace(dtype="float32", **overrides)
        cpu = tf.init_params(cfg, torch.Generator().manual_seed(3))
        card = copy.deepcopy(cpu).to("cuda")
        toks, img = zoo_inputs(cfg, 2, 200, 4, "cpu")
        with torch.inference_mode():
            want, wc = tf.forward(cpu, cfg, toks, mode="prefill",
                                  img_emb=img)
            got, c = tf.forward(card, cfg, toks.cuda(), mode="prefill",
                                img_emb=None if img is None else img.cuda())
        torch.cuda.synchronize()
        ok = bool(torch.allclose(got.cpu(), want, atol=3e-4, rtol=1e-3))
        err = float((got.cpu() - want).abs().max())
        c_err = _tree_err(c, wc)
        print(f"model check {arch} smoke fp32 {overrides}, S = 200: card vs "
              f"CPU prefill logits max abs diff {err:.3e}, caches / states "
              f"{c_err:.3e}")
        check(ok and c_err < 1e-3, f"{arch}: card and CPU prefill disagree "
                                   f"(logits {err}, states {c_err})")


def kernel_layers(cfg, kname, images=False):
    """The layers of one member's prefill that launch `kname`: every
    layer for a scan; for flash_attention every self-attention layer of a
    kv_major config under attn_impl "pallas" (vlm: the cross layers too
    when no images reach them, as serve_batch passes none), else none."""
    if kname != "flash_attention":
        return cfg.n_layers
    if cfg.attn_impl != "pallas" or cfg.gqa_layout != "kv_major":
        return 0
    if cfg.family == "vlm":
        n_super = cfg.n_layers // cfg.cross_attn_every
        return n_super * (cfg.cross_attn_every - int(images))
    return cfg.n_layers


SERVE_CONFIG_KEYS = (
    "family", "n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
    "d_ff", "vocab", "ssm_state", "ssm_head_dim", "shared_attn_every",
    "n_shared_attn", "rwkv_head_dim", "n_experts", "top_k",
    "moe_dense_residual", "capacity_factor", "gqa_layout",
    "cross_attn_every", "n_img_tokens", "d_vision", "n_codebooks",
    "tie_embeddings", "attn_impl", "dtype", "source")


def serve_members(torch, arch, cfg, what):
    """Prints the config and draws SERVE's members of `cfg` on the card
    (each from its seed); returns them."""
    from repro_torch.models import transformer as tf
    from repro_torch.obs.metrics import Stopwatch
    torch.cuda.empty_cache()
    print(f"serve {arch} config:", json.dumps({
        "serve": dict(SERVE, arch=arch, path=what),
        "reduced": REDUCED_SERVE.get(arch, "nothing"),
        "model": {k: getattr(cfg, k) for k in SERVE_CONFIG_KEYS}},
        allow_nan=False))
    sw = Stopwatch().start()
    members = []
    for seed in SERVE["seeds"]:
        members.append(tf.init_params(cfg, torch.Generator(
            device="cuda").manual_seed(seed)))
        torch.cuda.empty_cache()    # the draws' fp32 temporaries
    torch.cuda.synchronize()
    n_par = sum(p.numel() for p in members[0].parameters())
    n_bytes = sum(p.numel() * p.element_size()
                  for m in members for p in m.parameters())
    print(f"serve {arch}: {len(members)} members of {n_par} parameters "
          f"({n_bytes} bytes of weights, {n_bytes / 1e9:.3f} GB) initialised "
          f"on the card in {sw.stop():.3f} s; device memory in use "
          f"{torch.cuda.memory_allocated()} bytes")
    return members


def moe_repeat_check(torch, cfg, member, prompts, arch):
    """The same member's prefill twice: bitwise equal logits and cache
    (the MoE combine adds each token's contributions in a fixed order,
    without atomics)."""
    from repro_torch.models import transformer as tf
    S = prompts.shape[1]
    with torch.inference_mode():
        a = tf.forward(member, cfg, prompts, mode="prefill",
                       cache_len=S + 1, last_only=True)
        b = tf.forward(member, cfg, prompts, mode="prefill",
                       cache_len=S + 1, last_only=True)
        diff = _tree_err([a[0], a[1]], [b[0], b[1]])
    same = _tree_equal(torch, [a[0], a[1]], [b[0], b[1]])
    print(f"serve {arch}: member 0 prefilled twice: logits and cache "
          f"bitwise equal {same} (max abs diff {diff:.3e})")
    check(same, f"{arch}: two prefills of one member differ by {diff}")
    del a, b


def serve_phase(torch, arch, overrides, kname="flash_attention"):
    """Two full-width members of `arch` (its depth cut as `overrides`
    say) served through serve_batch; the prefill layers of the family
    that run kernel `kname` (kernel_layers) must launch it."""
    import importlib

    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.launch.serve import serve_batch
    from repro_torch.models import transformer as tf
    from repro_torch.obs.metrics import Stopwatch

    kernel = importlib.import_module(f"repro_torch.kernels.{kname}.kernel")
    cfg = get_config(arch).replace(**overrides)
    B, S, G = SERVE["batch"], SERVE["prompt_len"], SERVE["gen_len"]
    members = serve_members(torch, arch, cfg, "serve_batch")
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
    expect = kernel_layers(cfg, kname) * len(members)
    print(f"serve {arch}: {kname} launches {launches}, expected its layers "
          f"x members = {expect}")
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

    solo = serve_batch(cfg, members[:1], prompts, gen_len=SERVE_CHECK_GEN)
    masked = serve_batch(cfg, members, prompts, gen_len=SERVE_CHECK_GEN,
                         weights=[1.0, 0.0])
    same = bool(torch.equal(solo, masked))
    print(f"serve {arch}: weights [1, 0] == member 0 alone: {same}")
    check(same, f"{arch}: serve_batch with weights [1, 0] differs from "
                "member 0 served alone")
    del solo, masked
    if cfg.n_experts:
        moe_repeat_check(torch, cfg, members[0], prompts, arch)
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

    if expect and kname == "flash_attention":
        pallas_vs_xla(torch, cfg, members[0], {"tokens": prompts}, arch)
    del members, prompts
    torch.cuda.empty_cache()
    return launches


def pallas_vs_xla(torch, cfg, member, batch, arch):
    """Member 0's last-position probabilities from a prefill with
    flash_attention ("pallas") and with the plain chunked path ("xla")."""
    from repro_torch.launch.steps import make_prefill_step
    with torch.inference_mode():
        probs = {}
        for impl in ("pallas", "xla"):
            logits, cache = make_prefill_step(cfg.replace(attn_impl=impl))(
                member, batch)
            probs[impl] = torch.softmax(logits.float(), dim=-1)
            del logits, cache
        gap = float((probs["pallas"] - probs["xla"]).abs().max())
        agree = bool(torch.equal(probs["pallas"].argmax(-1),
                                 probs["xla"].argmax(-1)))
    print(f"serve {arch}: member 0 last-position probabilities, pallas "
          f"vs xla prefill: max abs diff {gap:.3e} (largest probability "
          f"{float(probs['xla'].max()):.3e}); same argmax: {agree}")
    check(gap < 1e-2, f"pallas and xla prefill disagree: {gap}")


def step_serve(torch, cfg, members, batch, gen_len):
    """FedPAE soft-vote greedy generation through the step functions, as
    the reference's dry run uses them: make_prefill_step on `batch`
    (tokens, and vlm's img_emb), then gen_len - 1 make_serve_step calls
    a member; the members' probabilities are averaged equally, and audio
    is greedy per codebook. Returns (B, gen_len) int32 tokens, or
    (B, gen_len, ncb) for audio."""
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    S = batch["tokens"].shape[1]
    prefill = make_prefill_step(cfg, cache_len=S + gen_len)
    serve_step = make_serve_step(cfg)

    def vote(logits_of):
        prob = sum(torch.softmax(lg.float(), dim=-1) for lg in logits_of)
        return torch.argmax(prob / len(logits_of), dim=-1)[:, None].to(
            torch.int32)
    with torch.inference_mode():
        caches, logits = [], []
        for m in members:
            lg, cache = prefill(m, batch)
            caches.append(cache)
            logits.append(lg)
        tok = vote(logits)
        out = [tok]
        for g in range(1, gen_len):
            logits = []
            for i, m in enumerate(members):
                lg, caches[i] = serve_step(m, {"tokens": tok,
                                               "cache": caches[i],
                                               "t": S + g - 1})
                logits.append(lg)
            tok = vote(logits)
            out.append(tok)
    return torch.cat(out, dim=1)


def profile_steps(torch, cfg, members, batch, arch):
    """Under torch.profiler: every member's make_prefill_step (device busy
    share, the largest kernels), then one make_serve_step of member 0
    (busy share, launches)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.obs.metrics import Stopwatch
    S = batch["tokens"].shape[1]
    prefill = make_prefill_step(cfg, cache_len=S + 2)
    with torch.inference_mode():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            sw = Stopwatch().start()
            for m in members:
                logits, cache = prefill(m, batch)
                del cache
            torch.cuda.synchronize()
            wall = sw.stop()
        profile_report(prof, wall, f"serve {arch}: profiled prefill steps "
                       "(both members)", top=8)
        logits, cache = prefill(members[0], batch)
        tok = torch.argmax(logits.float(), dim=-1)[:, None].to(torch.int32)
        step = make_serve_step(cfg)
        step(members[0], {"tokens": tok, "cache": cache, "t": S})
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            sw = Stopwatch().start()
            step(members[0], {"tokens": tok, "cache": cache, "t": S + 1})
            torch.cuda.synchronize()
            wall = sw.stop()
        del cache, logits
    profile_report(prof, wall, f"serve {arch}: profiled serve step (one "
                   "member)")


def step_serve_phase(torch, arch):
    """Two full-width members of the vlm or audio `arch` served through
    make_prefill_step and make_serve_step (step_serve), vlm with image
    embeddings (B, n_img_tokens, d_vision) from a seed, audio with
    (B, S, ncb) codebook prompts; every self-attention prefill layer runs
    flash_attention. vlm is then served text-only through serve_batch,
    where its cross layers run the kernel too."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel
    from repro_torch.launch.serve import serve_batch
    from repro_torch.obs.metrics import Stopwatch

    cfg = get_config(arch).replace(**PALLAS)
    B, S, G = SERVE["batch"], SERVE["prompt_len"], SERVE["gen_len"]
    members = serve_members(torch, arch, cfg, "make_prefill_step + "
                            "make_serve_step")
    toks, img = zoo_inputs(cfg, B, S, 0, "cuda")
    batch = {"tokens": toks, "img_emb": img}
    step_serve(torch, cfg, members, batch, 2)          # warm-up
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    kernel.KERNEL.launches = 0
    sw = Stopwatch().start()
    out = step_serve(torch, cfg, members, batch, G)
    torch.cuda.synchronize()
    total = sw.stop()
    launches = kernel.KERNEL.launches
    peak = torch.cuda.max_memory_allocated()
    expect = kernel_layers(cfg, "flash_attention", img is not None) \
        * len(members)
    print(f"serve {arch}: flash_attention launches {launches}, expected "
          f"self-attention layers x members = {expect}")
    check(launches == expect, f"flash_attention launched {launches} times "
                              f"in the step serving of {arch}, expected "
                              f"{expect}")
    shape = (B, G, cfg.n_codebooks) if cfg.n_codebooks else (B, G)
    check(tuple(out.shape) == shape and out.dtype == torch.int32
          and int(out.min()) >= 0 and int(out.max()) < cfg.vocab,
          f"bad served tokens: shape {tuple(out.shape)}, range "
          f"[{int(out.min())}, {int(out.max())}]")
    sw = Stopwatch().start()
    step_serve(torch, cfg, members, batch, 1)          # prefill only
    torch.cuda.synchronize()
    prefill = sw.stop()
    per = B * (cfg.n_codebooks or 1)
    print(f"serve {arch}: {B} x {S} prompts"
          + (f" with {cfg.n_img_tokens} image tokens a row" if img is not None
             else f" of {cfg.n_codebooks} codebooks") +
          f", {G} steps: a call {total:.6f} s; prefill {prefill:.6f} s "
          f"({B * S * len(members) / prefill:.1f} prompt positions/s over "
          f"both members); decode {total - prefill:.6f} s, "
          f"{B * (G - 1) / (total - prefill):.3f} generated positions/s "
          f"({per * (G - 1) / (total - prefill):.3f} tokens/s); peak device "
          f"memory {peak} bytes ({peak / 2**30:.2f} GiB)")
    print(f"serve {arch}: tokens", out.cpu().tolist())
    profile_steps(torch, cfg, members, batch, arch)

    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    finite = True
    with torch.inference_mode():
        for m in members:
            logits, cache = make_prefill_step(cfg, cache_len=S + 1)(m, batch)
            step, _ = make_serve_step(cfg)(m, {
                "tokens": out[:, :1].contiguous(), "cache": cache, "t": S})
            finite &= bool(torch.isfinite(logits).all()) \
                and bool(torch.isfinite(step).all())
            del logits, cache, step
    print(f"serve {arch}: every last-position prefill logit and serve-step "
          f"logit of both members finite: {finite}")
    check(finite, f"{arch}: non-finite logits")
    pallas_vs_xla(torch, cfg, members[0], batch, arch)

    launches = {"steps": launches}
    if cfg.family == "vlm":
        kernel.KERNEL.launches = 0
        sw = Stopwatch().start()
        text = serve_batch(cfg, members, toks, gen_len=G)
        torch.cuda.synchronize()
        secs = sw.stop()
        launches["serve_batch"] = kernel.KERNEL.launches
        expect = kernel_layers(cfg, "flash_attention") * len(members)
        print(f"serve {arch}: text-only serve_batch (no images, as the "
              f"reference's): {secs:.6f} s a call, flash_attention launches "
              f"{launches['serve_batch']}, expected every layer x members = "
              f"{expect}; tokens {text.cpu().tolist()}")
        check(launches["serve_batch"] == expect and tuple(text.shape) ==
              (B, G) and int(text.min()) >= 0 and int(text.max()) < cfg.vocab,
              f"{arch}: text-only serve_batch launched flash_attention "
              f"{launches['serve_batch']} times (expected {expect}) or gave "
              f"bad tokens")
        del text
    del members, batch, toks, img, out
    torch.cuda.empty_cache()
    return launches


# ---- multi-device: FedPAE's pod primitives and the expert-parallel MoE ----

MULTI_POD = ("llama3-8b", PALLAS)    # a pod's member, full width and depth
MULTI_MOE = ("qwen3-moe-235b-a22b", 6)   # cell 17's depth cut
MULTI_TRAIN_LAYERS = 1                   # cell 22's
MULTI_LR = 3e-4    # the train step's (not warmup_cosine's first step, lr 0)
MULTI_TOL = 1e-2   # mesh vs no mesh above one rank, probabilities and
                   # parameters (bf16; the combine sums in another order)
MULTI_LOSS_RTOL = 1e-3


def _ms(torch, fn):
    """(fn(), its ms on the card by CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _draw(torch, cfg, seed):
    from repro_torch.models import transformer as tf
    member = tf.init_params(cfg, torch.Generator(device="cuda").manual_seed(
        seed))
    torch.cuda.empty_cache()    # the draws' fp32 temporaries
    return member


def pod_path(torch, rank, world, say):
    """The pods' ring exchange and ensemble vote: one pod a rank, each
    holding the llama3-8b member drawn from its pod's seed."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels.flash_attention import kernel
    from repro_torch.launch import fedpae_pods
    from repro_torch.models import transformer as tf

    arch, overrides = MULTI_POD
    cfg = get_config(arch).replace(**overrides)
    mesh = init_device_mesh("cuda", (world, 1, 1),
                            mesh_dim_names=("pod", "data", "model"))
    member = _draw(torch, cfg, rank)
    n_bytes = sum(t.numel() * t.element_size() for t in member.parameters())
    fedpae_pods.pod_ring_exchange(member, mesh)          # warm-up
    torch.cuda.empty_cache()
    got, ms = _ms(torch, lambda: fedpae_pods.pod_ring_exchange(member,
                                                               mesh))
    parts = {}
    split = fedpae_pods.pod_ring_exchange(member, mesh, times=parts)
    sender = member if world == 1 else _draw(torch, cfg, (rank - 1) % world)
    want = dict(sender.named_parameters())
    same = all(torch.equal(t, want[n]) and t.dtype == want[n].dtype
               for n, t in got.named_parameters())
    same_split = all(torch.equal(t, want[n]) for n, t in
                     split.named_parameters())
    say(f"multi-device pods [{CARD}]: the exchange timed by part: pack "
        f"{parts['pack']:.6f} ms, collective {parts['collective']:.6f} ms, "
        f"unpack {parts['unpack']:.6f} ms (each ended by a device sync); "
        f"received == the sender's bitwise: {same_split}")
    check(same_split, "the part-timed exchange differs from the sender's")
    del split
    what = ("a device copy through the one-rank pod group, not a link "
            "rate" if world == 1 else f"over {world} ranks")
    say(f"multi-device pods [{CARD}]: {arch} member ({n_bytes} bytes) "
        f"through pod_ring_exchange in {ms:.6f} ms ({what}; "
        f"{n_bytes / ms / 1e6:.3f} GB/s); received == pod "
        f"{(rank - 1) % world}'s member bitwise: {same}")
    check(same, f"pod {rank}: the exchanged parameters differ from the "
                "sender's")
    del got, sender, want
    torch.cuda.empty_cache()

    B, S = SERVE["batch"], SERVE["prompt_len"]
    toks = torch.as_tensor(next(iter(TokenPipeline(cfg.vocab, B, S,
                                                   seed=0)))["tokens"],
                           device="cuda")
    step = fedpae_pods.make_ensemble_serve_step(cfg, mesh)
    with torch.inference_mode():
        step(member, 1.0, toks)                          # warm-up
        kernel.KERNEL.launches = 0
        vote, vote_ms = _ms(torch, lambda: step(member, 1.0, toks))
        launches = kernel.KERNEL.launches
        own = torch.softmax(tf.forward(member, cfg, toks, mode="train",
                                       last_only=True)[0].float(), dim=-1)
    finite = bool(torch.isfinite(vote).all())
    gap = float((vote - own).abs().max())
    say(f"multi-device pods [{CARD}]: ensemble vote of {world} pod(s) on "
        f"{B} x {S} prompts in {vote_ms:.6f} ms, shape {tuple(vote.shape)}, "
        f"finite {finite}; flash_attention launches {launches} (expected "
        f"n_layers = {cfg.n_layers}); max |vote - own softmax| {gap:.3e}")
    check(launches == cfg.n_layers, f"the pod vote launched flash_attention "
          f"{launches} times, expected {cfg.n_layers}")
    check(finite and tuple(vote.shape) == (B, 1, cfg.vocab),
          f"bad vote: shape {tuple(vote.shape)}, finite {finite}")
    if world == 1:
        check(torch.equal(vote, own), "at one pod the vote is not the "
              f"member's own softmax (max abs diff {gap})")
    dist.barrier()
    del member, vote, own
    torch.cuda.empty_cache()
    return {"launches": launches, "exchange_ms": ms, "vote_ms": vote_ms,
            "exchange_parts_ms": parts}


def moe_mesh_path(torch, rank, world, say):
    """qwen3-moe-235b-a22b's expert-parallel branch on a (data 1, model
    world) mesh: prefill against mesh=None and twice; one train step at
    1 layer against the unmeshed step."""
    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import steps as steps_mod
    from repro_torch.models import moe
    from repro_torch.optim import constant

    arch, n_layers = MULTI_MOE
    cfg = get_config(arch).replace(**PALLAS, n_layers=n_layers)
    mesh = mesh_mod.make_host_mesh(1, world)
    B, S = SERVE["batch"], SERVE["prompt_len"]
    axes = mesh_mod.batch_axes(mesh, B)
    toks = torch.as_tensor(next(iter(TokenPipeline(cfg.vocab, B, S,
                                                   seed=0)))["tokens"],
                           device="cuda")
    batch = {"tokens": toks}
    plain = steps_mod.make_prefill_step(cfg, cache_len=S + 1)
    meshed = steps_mod.make_prefill_step(cfg, mesh=mesh, batch_axes=axes,
                                         cache_len=S + 1)
    full = _draw(torch, cfg, 0)
    with torch.inference_mode():
        want = plain(full, batch)
    local = moe.local_experts(full, cfg, mesh)
    del full
    torch.cuda.empty_cache()
    with torch.inference_mode():
        meshed(local, batch)                              # warm-up
        a, prefill_ms = _ms(torch, lambda: meshed(local, batch))
        b = meshed(local, batch)
    repeat = _tree_equal(torch, list(a), list(b))
    gap = _tree_err(list(a), list(want))
    same = _tree_equal(torch, list(a), list(want))
    p_gap = float((torch.softmax(a[0].float(), -1) - torch.softmax(
        want[0].float(), -1)).abs().max())
    say(f"multi-device moe [{CARD}]: {arch} at {n_layers} layers, experts "
        f"split over a {world}-way model axis: a mesh prefill of {B} x {S} "
        f"in {prefill_ms:.6f} ms; logits and cache equal to the mesh=None "
        f"prefill's bitwise {same} (max abs diff {gap:.3e}; last-position "
        f"probabilities {p_gap:.3e}); two mesh prefills bitwise equal "
        f"{repeat}")
    check(repeat, f"two mesh prefills of {arch} differ")
    check(same if world == 1 else p_gap < MULTI_TOL,
          f"the mesh prefill differs from mesh=None by {gap} (logits), "
          f"{p_gap} (probabilities)")
    del local, a, b, want
    torch.cuda.empty_cache()

    c = TRAIN_FULL
    tcfg = cfg.replace(n_layers=MULTI_TRAIN_LAYERS)
    hb = next(iter(TokenPipeline(tcfg.vocab, c["batch"], c["seq"],
                                 seed=c["seed"])))
    tb = {k: torch.as_tensor(hb[k], device="cuda") for k in ("tokens",
                                                             "labels")}
    axes = mesh_mod.batch_axes(mesh, c["batch"])
    runs = {}
    for name, m in (("plain", None), ("mesh", mesh)):
        params = _draw(torch, tcfg, c["seed"])
        if m is not None:
            params = moe.local_experts(params, tcfg, m)
            torch.cuda.empty_cache()
        opt = steps_mod.choose_optimizer(tcfg, steps_mod.count_params(
            params, m))
        state = opt.init(dict(params.named_parameters()))
        step = steps_mod.make_train_step(
            tcfg, opt, constant(MULTI_LR), mesh=m, batch_axes=axes,
            microbatches=c["microbatches"])
        loss, ms = _ms(torch, lambda: float(step(params, state, tb)))
        leaves = dict(params.named_parameters())
        if m is not None:
            leaves.update(moe.gather_experts(params, tcfg, m))
        runs[name] = {"loss": loss, "ms": ms, "opt": opt.name, "leaves": {
            k: t.detach().cpu() for k, t in leaves.items()}}
        del params, state, opt, step, leaves
        torch.cuda.empty_cache()
    p, q = runs["plain"], runs["mesh"]
    same = p["loss"] == q["loss"] and all(
        torch.equal(t, q["leaves"][k]) for k, t in p["leaves"].items())
    gap = 0.0 if same else max(
        float((t.float() - q["leaves"][k].float()).abs().max())
        for k, t in p["leaves"].items())
    say(f"multi-device moe [{CARD}]: one {p['opt']} train step (lr "
        f"{MULTI_LR}) at {MULTI_TRAIN_LAYERS} layer, {c['batch']} x "
        f"{c['seq']} tokens in "
        f"{c['microbatches']} microbatches: loss {p['loss']!r} unmeshed in "
        f"{p['ms']:.6f} ms (the process's first train step at this width: "
        f"warm-up included), {q['loss']!r} on the mesh in {q['ms']:.6f} "
        "ms; "
        f"parameters after it bitwise equal {same} (max abs diff "
        f"{gap:.3e})")
    check(same if world == 1 else (
        abs(p["loss"] - q["loss"]) <= MULTI_LOSS_RTOL * abs(p["loss"])
        and gap < MULTI_TOL),
        f"the mesh train step differs from the unmeshed one: loss "
        f"{q['loss']} against {p['loss']}, parameters by {gap}")
    return {"prefill_ms": prefill_ms, "train_ms": q["ms"]}


SHARD_TRAIN = ("qwen2.5-3b", 4, 2)   # arch, layers, batch of 2048 tokens
PEAK_FLOPS = 989e12   # H100 SXM bf16 dense (roofline/analysis.py)
DRYRUN_CELLS = [("llama3-8b", "prefill_32k"), ("llama3-8b", "train_4k")]
DRYRUN_TIMEOUT = 300   # seconds, each dry-run subprocess


def sharded_path(torch, rank, world, say):
    """The sharded step at world 1 (a 1 x 1 (data, model) mesh over NCCL):
    llama3-8b's prefill and a decode step, and one qwen2.5-3b SGD train
    step, through `rules.shard_params` and the sharded steps, each
    bitwise equal to mesh=None, flash's launches unchanged; the prefill's
    model-FLOP share of the card (prefill_mfu)."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels.flash_attention import kernel
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch.shapes import InputShape
    from repro_torch.optim import constant, make_optimizer
    from repro_torch.roofline.analysis import model_flops
    from repro_torch.sharding.rules import shard_params

    if world != 1:
        say(f"sharded step: world {world}; the bitwise checks need world 1")
        return {}
    mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data",
                                                            "model"))
    arch, overrides = MULTI_POD
    cfg = get_config(arch).replace(**overrides)
    B, S = SERVE["batch"], SERVE["prompt_len"]
    hb = next(iter(TokenPipeline(cfg.vocab, B, S + 1, seed=0)))["tokens"]
    toks = torch.as_tensor(hb, device="cuda")
    member = _draw(torch, cfg, 0)
    local = shard_params(member, mesh, cfg)
    plain = (steps_mod.make_prefill_step(cfg, cache_len=S + 8),
             steps_mod.make_serve_step(cfg))
    meshed = (steps_mod.make_prefill_step(cfg, mesh=mesh,
                                          batch_axes=("data",),
                                          cache_len=S + 8),
              steps_mod.make_serve_step(cfg, mesh=mesh,
                                        batch_axes=("data",)))
    out, launches = {}, {}
    with torch.inference_mode():
        plain[0](member, {"tokens": toks[:, :S]})           # warm-up
        for what, params, (pre, serve) in (("plain", member, plain),
                                           ("sharded", local, meshed)):
            kernel.KERNEL.launches = 0
            (logits, cache), ms = _ms(torch, lambda: pre(
                params, {"tokens": toks[:, :S]}))
            launches[what] = kernel.KERNEL.launches
            d_logits, cache = serve(params, {"tokens": toks[:, S:],
                                             "cache": cache, "t": S})
            out[what] = (logits, d_logits, cache, ms)
    same_pre = torch.equal(out["plain"][0], out["sharded"][0])
    same_dec = torch.equal(out["plain"][1], out["sharded"][1])
    same_cache = _tree_equal(torch, out["plain"][2], out["sharded"][2])
    n_params = sum(t.numel() for t in member.parameters())
    secs = out["plain"][3] / 1e3
    mf = model_flops(cfg, InputShape("serve_prefill", S, B, "prefill"),
                     n_params)
    mfu = mf / (secs * PEAK_FLOPS)
    say(f"sharded step [{CARD}]: {arch} on a 1 x 1 mesh: prefill of {B} x "
        f"{S} logits bitwise {same_pre}, decode logits bitwise {same_dec}, "
        f"caches bitwise {same_cache}; flash launches {launches['plain']} "
        f"unmeshed, {launches['sharded']} sharded; prefill "
        f"{out['plain'][3]:.6f} ms unmeshed, {out['sharded'][3]:.6f} ms "
        f"sharded")
    print(f"prefill_mfu [{CARD}]: {mfu:.6f} ({arch} prefill of {B} x {S} "
          f"tokens: model_flops 2 N D = {mf:.6e} FLOP, N = {n_params}, in "
          f"{secs:.6f} s, against {PEAK_FLOPS:.3e} FLOP/s)")
    check(same_pre and same_dec and same_cache,
          "the sharded llama3-8b steps at world 1 differ from mesh=None")
    check(launches["plain"] == launches["sharded"] == cfg.n_layers,
          f"flash launches {launches} (expected {cfg.n_layers} each)")
    del member, local, out
    torch.cuda.empty_cache()

    arch, n_layers, b = SHARD_TRAIN
    cfg = get_config(arch).replace(n_layers=n_layers)
    hb = next(iter(TokenPipeline(cfg.vocab, b, S, seed=1)))
    batch = {k: torch.as_tensor(hb[k], device="cuda")
             for k in ("tokens", "labels")}
    res = {}
    for what, mesh_ in (("plain", None), ("sharded", mesh)):
        params = _draw(torch, cfg, 0)
        if mesh_ is not None:
            params = shard_params(params, mesh_, cfg)
        opt = make_optimizer("sgd")
        step = steps_mod.make_train_step(cfg, opt, constant(MULTI_LR),
                                          mesh=mesh_, batch_axes=("data",))
        loss, ms = _ms(torch, lambda: step(params, opt.init(None), batch))
        res[what] = (float(loss), params, ms)
    same_loss = res["plain"][0] == res["sharded"][0]
    same_params = _tree_equal(torch, list(res["plain"][1].parameters()),
                              list(res["sharded"][1].parameters()))
    say(f"sharded step [{CARD}]: {arch} at {n_layers} layers, one SGD step "
        f"of {b} x {S}: loss {res['sharded'][0]!r} (unmeshed "
        f"{res['plain'][0]!r}), bitwise {same_loss}; parameters bitwise "
        f"{same_params}; {res['sharded'][2]:.6f} ms sharded, "
        f"{res['plain'][2]:.6f} ms unmeshed")
    check(same_loss and same_params, "the sharded qwen2.5-3b train step at "
          "world 1 differs from mesh=None")
    del res
    torch.cuda.empty_cache()
    return {"prefill_mfu": mfu, "launches": launches}


def dryrun_phase(torch):
    """`launch/dryrun.py` in two subprocesses side by side (no card:
    torch's fake process group of 256 ranks, meta tensors) for llama3-8b at prefill_32k and
    train_4k on 16 x 16: strict JSON records whose n_params is the full
    config's, and their roofline terms."""
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import MetaGen
    from repro_torch.models import transformer as tf
    from repro_torch.roofline.analysis import roofline_terms
    out_dir = ROOT / "build" / "dryrun"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = {cell: subprocess.Popen(    # the cells side by side
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         cell[0], "--shape", cell[1], "--out", str(out_dir)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for cell in DRYRUN_CELLS}
    records = {}
    for (arch, shape), proc in procs.items():
        try:
            stdout, stderr = proc.communicate(timeout=DRYRUN_TIMEOUT)
        except subprocess.TimeoutExpired:
            proc.kill()
            stdout, stderr = proc.communicate()
        print(stdout.strip())
        check(proc.returncode == 0, f"dry run of {arch} {shape} exited "
              f"{proc.returncode}: {stderr[-2000:]}")
        rec = _strict_json(out_dir / f"{arch}__{shape}__sp.json")
        n = sum(t.numel() for t in tf.init_params(
            get_config(arch), MetaGen()).parameters())
        check(rec["n_params"] == n, f"dry run n_params {rec['n_params']} "
              f"!= the full config's {n}")
        terms = roofline_terms(rec)
        print(f"dry run {arch} {shape} (16 x 16, rank 0): flops/dev "
              f"{rec['flops_per_device']:.6e}, bytes/dev "
              f"{rec['bytes_per_device']:.6e}, collective bytes/dev "
              + json.dumps(rec["collective_bytes_per_device"])
              + f", argument bytes {rec['memory']['argument_bytes']}, traced "
              f"in {rec['compile_seconds']} s; roofline (H100 SXM data "
              f"sheet at 700 W) compute {terms['compute_s']:.6f} s, memory "
              f"{terms['memory_s']:.6f} s, collective "
              f"{terms['collective_s']:.6f} s: {terms['dominant']}")
        records[(arch, shape)] = rec
    return records


def multidevice_rank(rank, world, init_method, card):
    """One rank of the multi-device phase on card `rank`: the pod path,
    then the MoE path, over NCCL; returns rank 0's counts."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch import mesh as mesh_mod
    global CARD
    CARD = card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh_mod.init_world("cuda", rank=rank, world_size=world,
                        init_method=init_method, timeout=600)
    say = print if rank == 0 else (lambda *a, **kw: None)
    try:
        say(f"multi-device [{CARD}]: world {dist.get_world_size()}, backend "
            f"{dist.get_backend()}, rank {rank} on "
            f"{torch.cuda.get_device_name(torch.cuda.current_device())}")
        out = {"pods": pod_path(torch, rank, world, say)}
        out["moe"] = moe_mesh_path(torch, rank, world, say)
        out["sharded"] = sharded_path(torch, rank, world, say)
    finally:
        dist.destroy_process_group()
    return out


def _multidevice_child(rank, world, init_method, card, queue, fn=None):
    out = (fn or multidevice_rank)(rank, world, init_method, card)
    queue.put((rank, out))


def multidevice_phase(torch, rank_fn=None):
    """The multi-device phase (or `rank_fn`) over a world of one rank a
    card: in this process at one card, else one spawned process a
    card."""
    import multiprocessing
    import queue as queue_mod
    import socket
    world = torch.cuda.device_count()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        init_method = f"tcp://127.0.0.1:{s.getsockname()[1]}"
    if world == 1:
        return (rank_fn or multidevice_rank)(0, 1, init_method, CARD)
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=_multidevice_child, args=(
        r, world, init_method, CARD, queue, rank_fn)) for r in range(world)]
    for p in procs:
        p.start()
    outs = {}
    try:
        while len(outs) < world:
            try:
                rank, out = queue.get(timeout=5)
                outs[rank] = out
            except queue_mod.Empty:
                if any(p.exitcode not in (None, 0) for p in procs):
                    break
    finally:
        for p in procs:
            p.join(60)
            if p.is_alive():
                p.kill()
                p.join()
    codes = [p.exitcode for p in procs]
    check(codes == [0] * world and len(outs) == world,
          f"multi-device ranks exited {codes}")
    return outs[0]


ZOO4 = {"arch": "command-r-plus-104b", "model": 4, "gen": 16}


def _draw_pieces(torch, cfg, mesh, seed):
    """This rank's pieces of a model too large for one card, drawn on
    it: `rules.shard_params` of the meta model gives each piece's shape,
    then each piece is drawn as `dense_init` draws a whole leaf (a
    truncated normal at the whole leaf's fan-in) from a CUDA generator
    seeded by (seed, model rank); norms are zeros, as `init_rms`'s."""
    from repro_torch.launch.dryrun import MetaGen
    from repro_torch.models import transformer as tf
    from repro_torch.models.common import with_leaves
    from repro_torch.sharding.rules import leaf_split, shard_params
    full = tf.init_params(cfg, MetaGen())
    whole = {n: tuple(t.shape) for n, t in full.named_parameters()}
    local = shard_params(full, mesh, cfg)
    gen = torch.Generator(device="cuda").manual_seed(
        1000 * seed + mesh.get_local_rank("model"))
    leaves, splits = {}, {}
    for name, t in local.named_parameters():
        splits[name] = leaf_split(t)
        if t.dim() == 1:
            leaves[name] = torch.zeros(t.shape, dtype=t.dtype, device="cuda")
            continue
        fan_in = whole[name][-1 if name == "embed.embed" else -2]
        w = torch.empty(t.shape, dtype=torch.float32, device="cuda")
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
        leaves[name] = (w * fan_in ** -0.5).to(t.dtype)
        del w
    out = with_leaves(local, leaves)
    for name, p in out.named_parameters():
        if splits[name]:
            p.mesh_split = splits[name]
    torch.cuda.empty_cache()
    return out


def zoo4_rank(rank, world, init_method, card):
    """command-r-plus-104b at all 64 layers, split over a (data 1, model
    world) mesh: a prefill of 4 x 2048 prompts and greedy decode, the
    vocab-parallel logits gathered for the argmax."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels.flash_attention import kernel
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch.dryrun import collective_bytes
    from repro_torch.obs.metrics import Stopwatch
    global CARD
    CARD = card
    mesh_mod.init_world("cuda", rank=rank, world_size=world,
                        init_method=init_method, timeout=600)
    say = print if rank == 0 else (lambda *a, **kw: None)
    try:
        cfg = get_config(ZOO4["arch"]).replace(**PALLAS)
        mesh = mesh_mod.make_host_mesh(1, world)
        B, S, G = SERVE["batch"], SERVE["prompt_len"], ZOO4["gen"]
        torch.cuda.reset_peak_memory_stats()
        sw = Stopwatch().start()
        params = _draw_pieces(torch, cfg, mesh, 0)
        torch.cuda.synchronize()
        draw_s = sw.stop()
        n_bytes = sum(t.numel() * t.element_size()
                      for t in params.parameters())
        toks = torch.as_tensor(next(iter(TokenPipeline(
            cfg.vocab, B, S, seed=0)))["tokens"], device="cuda")
        pre = steps_mod.make_prefill_step(cfg, mesh=mesh,
                                          batch_axes=("data",),
                                          cache_len=S + G)
        serve = steps_mod.make_serve_step(cfg, mesh=mesh,
                                          batch_axes=("data",))

        def whole(logits):
            return mesh_mod.all_gather_over(logits.float().contiguous(),
                                            mesh, "model", 1)
        with torch.inference_mode():
            _, first_ms = _ms(torch, lambda: pre(params, {"tokens": toks}))
            torch.cuda.empty_cache()
            kernel.KERNEL.launches = 0
            with mesh_mod.record_collectives() as events:
                (logits, cache), pre_ms = _ms(torch, lambda: pre(
                    params, {"tokens": toks}))
            launches = kernel.KERNEL.launches
            coll, counts = collective_bytes(events, world)
            nxt = whole(logits).argmax(-1)
            out, finite = [nxt], bool(torch.isfinite(logits).all())
            dist.barrier()
            steps = []
            for i in range(G - 1):
                torch.cuda.synchronize()
                sw = Stopwatch().start()
                logits, cache = serve(params, {"tokens": nxt[:, None],
                                               "cache": cache, "t": S + i})
                finite &= bool(torch.isfinite(logits).all())
                nxt = whole(logits).argmax(-1)
                out.append(nxt)
                torch.cuda.synchronize()
                steps.append(sw.stop())
            dec_s = sum(steps[1:]) / len(steps[1:])
        gen = torch.stack(out, 1)
        same = [torch.empty_like(gen) for _ in range(world)]
        dist.all_gather(same, gen)
        agree = all(torch.equal(g, gen) for g in same)
        peak = torch.cuda.max_memory_allocated()
        say(f"zoo4 [{CARD}]: {ZOO4['arch']} at all {cfg.n_layers} layers "
            f"over a (data 1, model {world}) mesh, NCCL: {n_bytes} bytes "
            f"of weights a card, drawn in {draw_s:.3f} s; prefill of {B} x "
            f"{S} in {pre_ms:.6f} ms (the first, warm-up included, "
            f"{first_ms:.6f} ms; {launches} flash launches, "
            f"{dict(counts)} collectives, ring bytes a card "
            f"{json.dumps(coll)}); decode steps 2-{G - 1} {dec_s:.6f} s a "
            f"step ({B / dec_s:.3f} tokens/s; the first {steps[0]:.6f} "
            f"s); logits finite "
            f"{finite}; every rank's tokens equal {agree}; peak device "
            f"memory {peak} bytes ({peak / 2**30:.2f} GiB) on rank 0")
        check(finite and agree and launches == cfg.n_layers,
              f"zoo4: finite {finite}, ranks agree {agree}, flash "
              f"launches {launches}")
        return {"prefill_ms": pre_ms, "decode_s": dec_s, "peak": peak}
    finally:
        dist.destroy_process_group()


def zoo4_main(torch) -> int:
    """`python3 chip_smoke.py --zoo-4` (four cards; the run with no
    arguments, on one card, never takes it): command-r-plus-104b at all
    64 layers served over a 4-way model axis."""
    from repro_torch.kernels._build import build_all
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    world = torch.cuda.device_count()
    check(world >= ZOO4["model"], f"--zoo-4 needs {ZOO4['model']} cards, "
          f"the machine has {world}")
    build_all([fa_kernel.KERNEL])
    timed("zoo4", multidevice_phase, torch, zoo4_rank)
    print("phase seconds:", json.dumps(PHASE_SECONDS))
    return 0


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    global CARD
    CARD = nvidia_smi("name,power.limit")
    if "--zoo-4" in sys.argv[1:]:
        print(CARD)
        return zoo4_main(torch)
    from repro_torch.kernels._build import build_all
    from repro_torch.kernels.ensemble_fitness import kernel
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    from repro_torch.kernels.wkv_scan import kernel as wkv_kernel

    print(CARD)
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; device "
          f"{name!r}, count {count}")
    libs = [kernel.KERNEL, fa_kernel.KERNEL, ssd_kernel.KERNEL,
            ssd_kernel.KERNEL_BWD, wkv_kernel.KERNEL, wkv_kernel.KERNEL_BWD]
    build_all(libs)
    for lib in libs:
        built = "built" if lib.build_seconds is not None \
            else "loaded an earlier build"
        print(f"{lib.name}: {built} in {lib.build_seconds} s from "
              f"{lib.source.relative_to(ROOT)}")
        for line in lib.ptxas.splitlines():
            if "registers" in line or "Compiling entry" in line:
                print("  ptxas:", line.strip())

    max_err, timings = timed("kernel", kernel_phase, torch)
    timed("training determinism", training_determinism_phase, torch)
    launches, sync_exp, sync_res = timed("slice", slice_phase, torch)
    timed("slice repeat", sync_repeat_phase, torch, sync_res)
    paper_async = timed("async config 8", async_paper_phase, torch,
                        sync_exp, sync_res)
    serve_paper = timed("async config 12", serve_paper_phase, torch,
                        sync_exp, sync_res)
    restack_shapes, world_shapes = set(), set()
    restack = timed("restack", restack_phase, torch, sync_res,
                    restack_shapes)
    tables = timed("tables", tables_phase, torch, sync_exp, sync_res)
    del sync_exp, sync_res
    gossip = timed("async config 9", gossip_churn_phase, torch)
    faults = timed("async config 10", faults_phase, torch)
    serve_drift = timed("async config 11", serve_drift_phase, torch)
    drivers = timed("drivers", drivers_phase, torch)
    single_timings, single_err = drivers.pop("single")
    timed("compiled configs 13-14", compiled_fleet_phase, torch)
    world = timed("compiled config 15", compiled_world_phase, torch,
                  world_shapes)
    path_err, path_timings = timed("fitness paths", fitness_path_phase,
                                   torch, {
        "async config 10": faults["shapes"],
        "async config 11": serve_drift.pop("shapes"),
        "async config 12": serve_paper["shapes"],
        "compiled config 15": world_shapes, "restack": restack_shapes,
        "drivers": drivers.pop("shapes")})
    max_err = max(max_err, path_err, single_err)
    timings.update({("batched",) + k: v for k, v in path_timings.items()})
    torch.cuda.empty_cache()
    flash_timings = timed("flash", flash_phase, torch)
    flash = flash_timings[SLICE_SHAPE]
    scans = timed("scans", scan_phase, torch)
    bwd = timed("wkv_scan_bwd", wkv_bwd_phase, torch)
    ssd_bwd = timed("ssd_scan_bwd", ssd_bwd_phase, torch)
    timed("model check", model_check_phase, torch)
    timed("train check", train_check_phase, torch)
    served = {kname: timed(f"serve {arch}", serve_phase, torch, arch,
                           overrides, kname)
              for arch, overrides, kname in SERVES}
    flash_paths = {"llama3-8b serve_batch": served["flash_attention"]}
    for arch, overrides in ZOO_SERVES:
        flash_paths[f"{arch} serve_batch"] = timed(
            f"serve {arch}", serve_phase, torch, arch, overrides)
    for arch in ZOO_STEP_SERVES:
        for path, n in timed(f"serve {arch}", step_serve_phase, torch,
                             arch).items():
            flash_paths[f"{arch} {path}"] = n
    multi = timed("multi-device", multidevice_phase, torch)
    timed("dry run", dryrun_phase, torch)
    flash_paths[f"{MULTI_POD[0]} pod vote"] = multi["pods"]["launches"]
    trained = {arch: timed(f"train {arch}", full_train_phase, torch, arch,
                           n_layers)
               for arch, n_layers in TRAINS.items()}
    for arch, n in TRAIN_BWD_LAUNCHES.items():
        check(trained[arch]["bwd"] == n, f"{arch} training: "
              f"{trained[arch]['bwd']} backward scan launches, expected {n}")

    print("phase seconds:", json.dumps(PHASE_SECONDS))
    k_ms, p_ms, b_ms, b_by = timings[("batched", 32, 200, 100)]
    print(f"shares of bound (every one <= {SHARE_MAX}):",
          json.dumps({k: round(v, 6) for k, v in SHARES.items()}))
    print(json.dumps({"kernels": [{
        "name": "ensemble_fitness", "route": "cuda",
        "source": "src/repro_torch/csrc/ensemble_fitness.cu",
        "replaces": "src/repro/kernels/ensemble_fitness/kernel.py:109",
        "launches": launches, "max_abs_err": max_err, "ms": k_ms,
        "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None,
        "launches_by_path": {
            "sync slice": launches,
            "async config 8": paper_async["launches"],
            **{f"async config 9 {k}": v["launches"]
               for k, v in gossip.items()},
            "async config 10": faults["launches"],
            **{f"async config 11 {k}": v["launches"]
               for k, v in serve_drift.items()},
            "async config 12": serve_paper["launches"],
            "compiled config 15": world["launches"],
            "restack": restack["launches"],
            "tables (smoke)": tables,
            **{f"driver {k}": v["launches"] for k, v in drivers.items()}},
        "by_shape": {str(shape): dict(zip(
            ("ms", "plain_ms", "bound_ms", "bound_by"),
            timings[("batched",) + shape]))
            for shape in [(32, 200, 100)] + FITNESS_ASYNC_SHAPES
            + sorted(path_timings)},
        "single_by_shape": {str(shape): dict(zip(
            ("ms", "plain_ms", "bound_ms", "bound_by"), t))
            for shape, t in single_timings.items()}}, {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:103",
        "launches": served["flash_attention"], "max_abs_err": flash["err"],
        "ms": flash["ms"], "plain_ms": flash["plain_ms"],
        "bound_ms": flash["bound_ms"], "bound_by": flash["bound_by"],
        "library_ms": flash["library_ms"],
        "launches_by_path": flash_paths,
        "by_shape": {str(shape): {k: t[k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
            for shape, t in flash_timings.items()}}] + [{
        "name": kname, "route": "cuda",
        "source": f"src/repro_torch/csrc/{kname}.cu",
        "replaces": f"src/repro/kernels/{kname}/kernel.py:{line}",
        "launches": served[kname],
        "max_abs_err": scans[kname]["err"], "ms": scans[kname]["ms"],
        "plain_ms": scans[kname]["plain_ms"],
        "bound_ms": scans[kname]["bound_ms"],
        "bound_by": scans[kname]["bound_by"], "library_ms": None,
        "by_shape": {str(key[1]): {k: t[k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by")}
            for key, t in scans.items() if key[0] == kname}}
        for kname, line in (("ssd_scan", 88), ("wkv_scan", 76))] + [{
        "name": "wkv_scan_bwd", "route": "cuda",
        "source": "src/repro_torch/csrc/wkv_scan_bwd.cu",
        "replaces": "src/repro/models/rwkv.py:64 (no TPU kernel: jax.grad "
                    "of wkv_chunk_scan)",
        "launches": trained["rwkv6-3b"]["bwd"], "max_abs_err": bwd["err"],
        "ms": bwd["ms"], "plain_ms": bwd["plain_ms"],
        "bound_ms": bwd["bound_ms"], "bound_by": bwd["bound_by"],
        "library_ms": None}, {
        "name": "ssd_scan_bwd", "route": "cuda",
        "source": "src/repro_torch/csrc/ssd_scan_bwd.cu",
        "replaces": "src/repro/models/ssm.py:75 (no TPU kernel: jax.grad "
                    "of ssd_chunk_scan)",
        "launches": trained["zamba2-7b"]["bwd"],
        "max_abs_err": ssd_bwd["err"], "ms": ssd_bwd["ms"],
        "plain_ms": ssd_bwd["plain_ms"], "bound_ms": ssd_bwd["bound_ms"],
        "bound_by": ssd_bwd["bound_by"], "library_ms": None}]},
        allow_nan=False))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}},
        allow_nan=False))
    return 0


if __name__ == "__main__":
    sys.exit(main())
