"""Train mixes: a client training its member through the port's
`launch.steps.make_train_step` with the port's AdamW and warmup-cosine
schedule (`optim`), as `launch/train.py` builds them, at the mix's
batch, length and microbatches.

Set-up draws the member on the device, builds the one step object, and
drives it through the mix's `checked_steps` first steps, each on a new
seeded batch, through the window's own call and feed; it keeps what the
check needs of them: each step's loss, each leaf's first gradient (its
AdamW first moment after step 1 over 1 - b1) and, after the last checked
step, a host copy of the weights. The window then goes on with the same
object, dispatching steps without a sync until `--seconds` have passed;
the losses are read after it. With `--trace 1` the window's first
`traced_steps` steps run under the profiler (`trace.py`), and
`--seconds` of untraced steps follow them.

`correct`: once the window has closed, the peak memory is read and the
step is freed, the reference (`reference/train.py`) runs the checked
steps from the same draw in float32. Compared, by leaf: the gap between
the port's and the reference's first gradient norms (`grad_gap`) and
change norms after the checked steps (`change_gap`), each over the
larger of the reference's norm of that leaf and of the median leaf, the
worst leaf taken; leaves whose reference gradient is under a thousandth
of the median leaf's are left out of the change (they move by
round-off); and the largest relative gap of a step's loss (`loss_gap`).
"""
from __future__ import annotations

import statistics
import time

from bench import gen, weights
from bench.drivers.score import SCANS, port_config, smoke_arch
from bench.trace import launch_counts, read, traced

ROUNDOFF = 1e-3   # of the median leaf's first gradient norm
COMPARED = ("loss_gap", "grad_gap", "change_gap")


def make_step(cfg, mix):
    from repro_torch.launch import steps
    from repro_torch.optim import make_optimizer, warmup_cosine
    o, s = mix["optimizer"], mix["schedule"]
    opt = make_optimizer(o["name"], b1=o["b1"], b2=o["b2"], eps=o["eps"],
                         weight_decay=o["weight_decay"])
    lr_fn = warmup_cosine(s["lr"], warmup=s["warmup"],
                          total_steps=s["total_steps"])
    return opt, steps.make_train_step(cfg, opt, lr_fn,
                                      microbatches=mix["microbatches"])


def batch(mix, seed, step, V, device, smoke):
    """One step's batch on `device`, copied from pinned host memory
    without a sync (the host allocator keeps each pinned buffer until its
    copy has run)."""
    import numpy as np
    import torch
    tok, lab = gen.train_batch(mix, seed, step, V, smoke)

    def up(a):
        t = torch.from_numpy(np.ascontiguousarray(a))
        if device.type != "cuda":
            return t.to(device)
        return t.pin_memory().to(device, non_blocking=True)
    return {"tokens": up(tok), "labels": up(lab)}


def run(ctx) -> dict:
    import torch

    cell, seed, device, smoke = ctx.cell, ctx.seed, ctx.device, ctx.smoke
    mix = cell.traffic
    cfg = port_config(cell, smoke)
    arch = smoke_arch(cell, cfg) if smoke else cell.arch
    V = arch["vocab"]
    params, state, step_fn, prog = checked_steps(cfg, arch, mix, seed, device,
                                                 smoke)
    n_check = mix["checked_steps"]
    if device.type == "cuda":
        torch.cuda.synchronize()
    ctx.setup_done()

    B, S = mix["batch"], mix["smoke_seq"] if smoke else mix["seq"]
    tr, out = {}, []
    t = n_check

    def step():
        nonlocal t
        out.append(step_fn(params, state, batch(mix, seed, t, V, device,
                                                smoke)))
        t += 1
    t0 = time.perf_counter()
    with traced(torch, ctx.trace, tr):
        for _ in range(mix["traced_steps"] if ctx.trace else 0):
            step()
    # a traced run trains `seconds` more after the profiler has stopped
    n_traced, t_rest = len(out), time.perf_counter()
    t_from = t_rest if ctx.trace else t0
    while time.perf_counter() - t_from < ctx.seconds:
        step()
    t_host = time.perf_counter()
    if device.type == "cuda":
        torch.cuda.synchronize()
    t_end = time.perf_counter()
    window_s = t_end - t0
    window_losses = [float(x) for x in out]
    failed = sum(1 for x in window_losses if x != x or abs(x) == float("inf"))
    ctx.log(f"window {window_s:.6f} s: {len(out)} steps of {B} x {S} "
            f"tokens; losses {window_losses[0]:.6f} .. "
            f"{window_losses[-1]:.6f}; the device ran "
            f"{t_end - t_host:.6f} s past the host's last dispatch")
    e2e = {"train_tokens_per_s": len(out) * B * S / window_s}
    ctx.record_device()
    del params, state, step_fn, out
    if device.type == "cuda":
        torch.cuda.empty_cache()

    ref = reference_steps(arch, mix, seed, device, smoke)
    nums = compare(prog, ref, arch, seed, device)
    ctx.log(f"each step's loss {prog['losses']} against {ref['losses']}")
    checks = {k: ctx.check(k, nums[k]) for k in COMPARED}
    trace = read(tr) if ctx.trace else None
    if trace:
        ctx.log(f"traced scan launches: {launch_counts(trace, SCANS)}")
    layer = {"arch": arch, "trace": trace,
             "steps": n_traced,
             "after_trace": {"steps": len(window_losses) - n_traced,
                             "seconds": t_end - t_rest},
             "tokens_per_step": B * S, "microbatch": (B // mix["microbatches"],
                                                      S),
             "microbatches": mix["microbatches"],
             "n_body_and_head": weights.count_applied(arch)
             + arch["d_model"] * arch["vocab"]}
    return {"attempted": len(window_losses), "failed": failed, "e2e": e2e,
            "layer": layer, "checks": checks}


def checked_steps(cfg, arch, mix, seed, device, smoke):
    """Draw the member, build the one step object and drive it through
    the mix's checked steps. Returns (params, optimizer state, step,
    readings): the readings are each step's loss, each leaf's first
    gradient norm (its AdamW first moment after step 1 over 1 - b1) and
    a host copy of the weights after the last checked step."""
    import torch
    params = weights.port_params(weights.make_member(arch, seed, 0, device))
    opt, step_fn = make_step(cfg, mix)
    named = dict(params.named_parameters())
    state = opt.init(named)
    losses = []
    for t in range(mix["checked_steps"]):
        losses.append(step_fn(params, state, batch(mix, seed, t,
                                                   arch["vocab"], device,
                                                   smoke)))
        if t == 0:
            g1 = torch.stack([m.norm() for m in state["m"]]) \
                / (1 - mix["optimizer"]["b1"])
    prog = {"losses": [float(x) for x in losses],
            "grad_norm": dict(zip(named, g1.tolist())),
            "weights": {n: p.detach().to("cpu", copy=True)
                        for n, p in named.items()}}
    return params, state, step_fn, prog


def reference_steps(arch, mix, seed, device, smoke, control=False,
                    rows=None):
    """The reference over the checked steps' batches, from the same draw
    (made again from the seed)."""
    from bench.reference import train as rtrain
    flat = weights.make_member(arch, seed, 0, device)
    batches = [tuple(batch(mix, seed, t, arch["vocab"], device,
                           smoke).values())
               for t in range(mix["checked_steps"])]
    return rtrain.train(arch, flat, batches, mix, control=control, rows=rows)


def compare(prog: dict, ref: dict, arch, seed, device) -> dict:
    """loss_gap, grad_gap and change_gap of a run's readings (`prog`: its
    losses, first gradient norms and host weights after the checked
    steps) against the reference's."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in
                   zip(prog["losses"], ref["losses"]))
    g_ref = ref["grad_norm"]
    med = statistics.median(g_ref.values())
    grad_gap = max(abs(prog["grad_norm"][n] - g) / max(g, med)
                   for n, g in g_ref.items())
    if "change_norm" in prog:
        change = prog["change_norm"]
    else:
        flat0 = weights.make_member(arch, seed, 0, device)
        change = {n: float((w.to(device).float() - flat0[n].float()).norm())
                  for n, w in prog["weights"].items()}
        del flat0
    kept = [n for n in g_ref if g_ref[n] >= ROUNDOFF * med]
    c_ref = ref["change_norm"]
    c_med = statistics.median(c_ref[n] for n in kept)
    change_gap = max(abs(change[n] - c_ref[n]) / max(c_ref[n], c_med)
                     for n in kept)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "change_gap": change_gap}
