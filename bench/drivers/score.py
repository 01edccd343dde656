"""Score mixes: a client's ensemble scoring prompts through the port's
`serve_batch(cfg, members, prompts, gen_len=1)`, one call outstanding.

Set-up draws every member on the device (`weights.py`) and serves each
length of the cycle once. The window serves calls in the mix's order
until `--seconds` have passed and a block of the cycle has ended; a
request's latency runs from its call's submission (its prompts handed to
the device) to the voted token on the host. With `--trace 1` the first
block runs under the profiler (`trace.py`), read after the window,
and `--seconds` of untraced calls follow it.

`correct`: once the window has closed and the peak memory is read, the
reference (`reference/`) works out the soft vote in float32 over a
sample of the window's calls drawn from the seed, the longest call among
them: for each prompt, the gap by which the served token's log vote
probability lies below the reference's best; compared is their mean
(`vote_gap_mean`). The widest gap is printed beside it: it swings from
seed to seed by nature and is not compared (PERF.md).
"""
from __future__ import annotations

import re
import time

import numpy as np

from bench import gen, reference, weights
from bench.trace import call_span, launch_counts, read, traced

SCANS = re.compile(r"scan")


def port_config(cell, smoke: bool):
    """The port's config of the cell (its smoke variant for the CPU
    tests); full size must equal the configuration file's `as_run`."""
    from repro_torch.configs import get_config, get_smoke
    name = cell.config["port_config"]
    if smoke:
        return get_smoke(name)
    cfg = get_config(name)
    for k, v in cell.arch.items():
        if hasattr(cfg, k) and getattr(cfg, k) != v:
            raise ValueError(f"{cell.entry['config']}: the port's {k} is "
                             f"{getattr(cfg, k)!r}, the file runs {v!r}")
    return cfg


def smoke_arch(cell, cfg) -> dict:
    """`as_run` with the widths of the port's smoke config."""
    a = dict(cell.arch)
    for k in a:
        if hasattr(cfg, k):
            a[k] = getattr(cfg, k)
    return a


def members_for(cell, arch, seed, device):
    return [weights.make_member(arch, seed, m, device)
            for m in range(cell.data["members"])]


def run(ctx) -> dict:
    import torch

    from repro_torch.launch import serve

    cell, seed, device, smoke = ctx.cell, ctx.seed, ctx.device, ctx.smoke
    mix = cell.traffic
    cfg = port_config(cell, smoke)
    arch = smoke_arch(cell, cfg) if smoke else cell.arch
    V, gen_len = arch["vocab"], mix["gen_len"]
    flats = members_for(cell, arch, seed, device)
    members = [weights.port_params(f) for f in flats]

    for L in sorted(set(gen.length_cycle(mix, smoke))):
        p = torch.as_tensor(gen.warm_prompts(mix, L, V), device=device)
        serve.serve_batch(cfg, members, p, gen_len=gen_len).cpu()
    ctx.setup_done()

    recs = []          # (call, length, latency s, served tokens)

    def one(i, L, span=False):
        host = gen.prompts(mix, seed, i, L, V)
        t = time.perf_counter()
        with call_span(span):
            out = serve.serve_batch(cfg, members,
                                    torch.as_tensor(host, device=device),
                                    gen_len=gen_len).cpu()
        recs.append((i, L, time.perf_counter() - t, out.numpy()))

    calls = gen.score_calls(mix, seed, smoke)
    tr = {}
    t0 = time.perf_counter()
    with traced(torch, ctx.trace, tr):
        for i, L, last in calls:
            one(i, L, ctx.trace)
            if last:
                break
    # a traced run serves `seconds` more after the profiler has stopped
    n_traced, t_rest = len(recs), time.perf_counter()
    t_from = t_rest if ctx.trace else t0
    while not (last and time.perf_counter() - t_from >= ctx.seconds):
        i, L, last = next(calls)
        one(i, L)
    t_end = time.perf_counter()
    window_s = t_end - t0

    B = mix["prompts_per_call"]
    lat = np.repeat([r[2] for r in recs], B)
    tokens = sum(B * r[1] for r in recs)
    ctx.log(f"window {window_s:.6f} s: {len(recs)} calls, {len(lat)} "
            f"requests, {tokens} prompt tokens; p95 over {len(lat)} "
            f"latencies, {int(np.sum(lat > np.percentile(lat, 95)))} "
            "beyond it")
    e2e = {"score_tokens_per_s": tokens / window_s,
           "score_p95_s": float(np.percentile(lat, 95))}
    ctx.record_device()
    del members
    if device.type == "cuda":
        torch.cuda.empty_cache()

    mean_gap, widest = vote_gaps(cell, arch, flats, recs, mix, seed, device)
    ctx.log(f"vote gaps over the checked prompts: mean {mean_gap!r}, "
            f"widest {widest!r} (not compared: it swings from seed to seed)")
    checks = {"vote_gap_mean": ctx.check("vote_gap_mean", mean_gap)}
    trace = read(tr) if ctx.trace else None
    if trace:
        ctx.log(f"traced scan launches: {launch_counts(trace, SCANS)}")
    layer = {"arch": arch, "members": len(flats), "trace": trace,
             "calls": [(B, r[1]) for r in recs[:n_traced]],
             "after_trace": {"calls": [(B, r[1]) for r in recs[n_traced:]],
                             "seconds": t_end - t_rest},
             "n_body": weights.count_applied(arch)}
    return {"attempted": len(lat), "failed": 0, "e2e": e2e,
            "layer": layer, "checks": checks}


def sample_calls(cell, recs, seed):
    """The calls the reference checks: the longest of the window (the
    first at that length) and others drawn from the seed."""
    n = min(cell.data["check"]["calls"], len(recs))
    longest = max(range(len(recs)), key=lambda j: (recs[j][1], -j))
    rest = [j for j in range(len(recs)) if j != longest]
    pick = gen.rng(seed, 5).choice(len(rest), size=n - 1, replace=False)
    return [longest] + [rest[j] for j in sorted(pick)]


def vote_gaps(cell, arch, flats, recs, mix, seed, device):
    """Over the sampled calls' prompts, the gaps of the served tokens' log
    vote probability below the reference's best: (their mean, the
    widest)."""
    import torch
    gaps = []
    for j in sample_calls(cell, recs, seed):
        i, L, _, toks = recs[j]
        prompts = torch.as_tensor(gen.prompts(mix, seed, i, L, arch["vocab"]),
                                  device=device)
        lp = reference.vote_logprobs(arch, flats, prompts)
        first = torch.as_tensor(np.asarray(toks)[:, 0], device=device).long()
        if int(first.min()) < 0 or int(first.max()) >= lp.shape[-1]:
            return float("inf"), float("inf")
        gaps += (lp.max(dim=-1).values
                 - lp.gather(1, first[:, None])[:, 0]).tolist()
    return float(np.mean(gaps)), float(np.max(gaps))
