"""NSGA-II (Deb et al. 2002) in PyTorch (port of `repro/core/nsga2.py`).

Every operator takes leading batch dimensions, so one call serves one
client (P, ...) or a whole client batch (N, P, ...) in lockstep; the
reference vmaps the same per-client functions. A generation evaluates
the population twice (the batched ensemble_fitness kernel scores every
client in one launch each time), ranks it by iterative front peeling,
computes crowding distances and breeds by tournament, uniform
crossover, bit-flip mutation and exact-k repair.

Three behaviours of the reference are kept on purpose:
- sorts are stable, as `jnp.argsort` is;
- the sort keys `rank * 1e9 + value` and `rank * 1e9 - crowding` are
  computed in fp32 and so lose the value for every rank >= 1, exactly as
  the reference does (ROADMAP.md queue 3);
- the random stream of a client depends only on (seed, client), never on
  the batch it runs in. `jax.random` streams cannot be reproduced, so the
  port draws from one `torch.Generator` per client, seeded by
  `client_keys`, all at once before the loop (`_client_draws`). The
  random operators take those pre-drawn tensors (`InitDraws`,
  `BreedDraws`), so a test can feed them, and the whole loop, the
  reference's own draws.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

BIG = 1e9
_PEEL_SYNC_EVERY = 8   # front-peeling iterations between host checks


class NSGAConfig(NamedTuple):
    pop_size: int = 100
    generations: int = 100
    k: int = 5            # exact ensemble size (0 = free size)
    p_mut: float = 0.02
    p_cross: float = 0.9
    seed: int = 0


class InitDraws(NamedTuple):
    """Random inputs of `_init_population`: both U[0, 1), (..., P, M)."""
    uniform: torch.Tensor     # initial bits: uniform < 0.5
    noise: torch.Tensor       # exact-k repair noise


class BreedDraws(NamedTuple):
    """Random inputs of one `_breed` generation, in the reference's key
    order (`jax.random.split(key_g, 6)`)."""
    tourn_a: torch.Tensor     # (..., 2, P) int64 in [0, P)
    tourn_b: torch.Tensor     # (..., 2, P) int64 in [0, P)
    cross: torch.Tensor       # (..., P, M) U[0, 1): crossover mask
    do_cross: torch.Tensor    # (..., P, 1) U[0, 1): per-row crossover gate
    flip: torch.Tensor        # (..., P, M) U[0, 1): mutation mask
    noise: torch.Tensor       # (..., P, M) U[0, 1): exact-k repair noise


def draw_init(gen: torch.Generator, P: int, M: int, device) -> InitDraws:
    return InitDraws(
        torch.rand((P, M), generator=gen, device=device),
        torch.rand((P, M), generator=gen, device=device))


def draw_breed(gen: torch.Generator, P: int, M: int, device,
               lead: tuple = ()) -> BreedDraws:
    """One generation's draws, or `lead=(G,)` generations' at once."""
    def rand(*shape):
        return torch.rand(lead + shape, generator=gen, device=device)

    def tourn():
        return torch.randint(0, P, lead + (2, P), generator=gen,
                             device=device)
    return BreedDraws(tourn(), tourn(), rand(P, M), rand(P, 1), rand(P, M),
                      rand(P, M))


def dominance(objs):
    """objs: (..., P, n_obj), maximized. dom[..., i, j] = i dominates j."""
    a, b = objs.unsqueeze(-2), objs.unsqueeze(-3)
    return (a >= b).all(-1) & (a > b).any(-1)


def nondominated_rank(objs):
    """(..., P) rank per individual (0 = Pareto front) by iterative
    peeling. The loop is bounded by P; it checks for an empty remainder
    on the host only every few fronts, so a GA generation does not stall
    on a device sync per front."""
    P = objs.shape[-2]
    dom = dominance(objs).to(torch.float32)
    ranks = torch.full(objs.shape[:-1], P, dtype=torch.int64,
                       device=objs.device)
    remaining = torch.ones(objs.shape[:-1], dtype=torch.bool,
                           device=objs.device)
    for r in range(P):
        # dominated[j] = any_i remaining[i] & dom[i, j] (counts <= P are
        # exact in fp32)
        n_dom = (remaining.to(torch.float32).unsqueeze(-2) @ dom).squeeze(-2)
        front = remaining & (n_dom == 0)
        ranks = torch.where(front, r, ranks)
        remaining = remaining & ~front
        if r % _PEEL_SYNC_EVERY == _PEEL_SYNC_EVERY - 1 \
                and not bool(remaining.any()):
            break
    return ranks


def crowding_distance(objs, ranks):
    """(..., P) crowding distance computed within each rank front."""
    n_obj = objs.shape[-1]
    big = torch.tensor(BIG, dtype=torch.float32, device=objs.device)
    rf = ranks.to(torch.float32)
    dist = torch.zeros(objs.shape[:-1], dtype=torch.float32,
                       device=objs.device)
    for m in range(n_obj):
        v = objs[..., m]
        order = torch.argsort(rf * big + v, dim=-1, stable=True)
        v_sorted = v.gather(-1, order)
        r_sorted = ranks.gather(-1, order)
        same = r_sorted[..., 1:] == r_sorted[..., :-1]
        edge = torch.zeros_like(same[..., :1])
        prev_ok = torch.cat([edge, same], -1)
        next_ok = torch.cat([same, edge], -1)
        prev_v = torch.cat([v_sorted[..., :1], v_sorted[..., :-1]], -1)
        next_v = torch.cat([v_sorted[..., 1:], v_sorted[..., -1:]], -1)
        span = (v.amax(-1) - v.amin(-1)).clamp(min=1e-12).unsqueeze(-1)
        contrib = torch.where(prev_ok & next_ok, (next_v - prev_v) / span,
                              big)
        dist = dist.scatter_add(-1, order, contrib)
    return dist


def _tournament(ranks, crowd, idx):
    """Binary tournament: lower rank wins, ties by higher crowding.
    idx: (..., 2, n) drawn contestants -> (..., n) winners."""
    idx = idx.to(torch.int64)   # gather misreads expanded int32 indices
    a, b = idx[..., 0, :], idx[..., 1, :]
    ra, rb = ranks.gather(-1, a), ranks.gather(-1, b)
    a_better = (ra < rb) | ((ra == rb)
                            & (crowd.gather(-1, a) > crowd.gather(-1, b)))
    return torch.where(a_better, a, b)


def _rows(pop, idx):
    """pop (..., P, M) rows picked by idx (..., n) -> (..., n, M)."""
    return pop.gather(-2, idx.unsqueeze(-1).expand(*idx.shape,
                                                   pop.shape[-1]))


def repair_k(pop_f, noise, k: int, valid_mask=None):
    """Force exactly k ones per row: keep set bits with priority, fill the
    rest randomly. pop_f: (..., P, M) float 0/1; `noise` U[0, 1) shaped
    like pop_f (the reference draws it from its key). With `valid_mask`
    (..., M) 0/1, masked-out slots score below every valid slot and can
    never be set — rows end up with min(k, #valid) ones."""
    score = pop_f * 2.0 + noise   # existing bits rank above absent ones
    if valid_mask is not None:
        score = score - (1.0 - valid_mask).unsqueeze(-2) * 8.0
    thresh = -torch.sort(-score, dim=-1).values[..., k - 1:k]  # k-th largest
    rep = (score >= thresh).to(torch.float32)
    if valid_mask is not None:
        rep = rep * valid_mask.unsqueeze(-2)
    return rep


def _init_population(draws: InitDraws, k: int, valid_mask=None,
                     init_pop=None):
    """(..., P, M) initial population from `draws` (shaped (..., P, M))."""
    if init_pop is None:
        pop = (draws.uniform < 0.5).to(torch.float32)
    else:
        pop = init_pop.to(torch.float32).expand(draws.uniform.shape)
    if valid_mask is not None:
        pop = pop * valid_mask.unsqueeze(-2)
    if k:
        pop = repair_k(pop, draws.noise, k, valid_mask)
    return pop


def _breed(pop, ranks, crowd, draws: BreedDraws, cfg: NSGAConfig,
           valid_mask=None):
    """Offspring: tournament -> uniform crossover -> bit-flip mutation ->
    exact-k repair, from one generation's `draws`."""
    parents_a = _rows(pop, _tournament(ranks, crowd, draws.tourn_a))
    parents_b = _rows(pop, _tournament(ranks, crowd, draws.tourn_b))
    cross = (draws.cross < 0.5).to(torch.float32)
    do_cross = (draws.do_cross < cfg.p_cross).to(torch.float32)
    child = parents_a * (1 - cross * do_cross) + parents_b * cross * do_cross
    flip = (draws.flip < cfg.p_mut).to(torch.float32)
    child = (child - flip).abs()
    if valid_mask is not None:
        child = child * valid_mask.unsqueeze(-2)
    if cfg.k:
        child = repair_k(child, draws.noise, cfg.k, valid_mask)
    return child


def _survival_order(aobjs):
    """(..., 2P, n_obj) -> survival sort order (rank asc, crowding desc)."""
    aranks = nondominated_rank(aobjs)
    acrowd = crowding_distance(aobjs, aranks)
    key = aranks.to(torch.float32) * torch.tensor(
        BIG, dtype=torch.float32, device=aobjs.device) - acrowd
    return torch.argsort(key, dim=-1, stable=True), aranks, acrowd


def client_keys(seed: int, client_ids) -> list:
    """Per-client random streams: one 64-bit generator seed per client,
    a function of (seed, client) only, so a client selects identically
    whatever batch it is scored in."""
    return [int(np.random.SeedSequence([int(seed), int(c)])
                .generate_state(1, np.uint64)[0]) for c in client_ids]


def _client_draws(keys: Sequence[int], cfg: NSGAConfig, M: int, device):
    """Stack every client's init and all-generation breed draws:
    InitDraws (N, P, M) and BreedDraws (N, G, ...). Repeated clients
    (the engine's power-of-two padding) are drawn once."""
    P, G = cfg.pop_size, cfg.generations
    per_key = {}
    for key in keys:
        if key not in per_key:
            gen = torch.Generator(device=device).manual_seed(key)
            per_key[key] = (draw_init(gen, P, M, device),
                            draw_breed(gen, P, M, device, lead=(G,)))
    init, breed = zip(*(per_key[key] for key in keys))
    return (InitDraws(*map(torch.stack, zip(*init))),
            BreedDraws(*map(torch.stack, zip(*breed))))


def run_nsga2_batched(eval_fn: Callable, n_models: int, cfg: NSGAConfig,
                      keys: Sequence[int], init_pop=None, valid_mask=None,
                      device=None, draws=None):
    """N clients' GAs in lockstep. eval_fn: (N, P, M) -> (N, P, n_obj).

    `keys`: N per-client generator seeds (`client_keys`). `valid_mask`:
    optional (N, M) 0/1 per-client model-slot mask. `draws`: optional
    (InitDraws (N, P, M), BreedDraws (N, G, ...)) used instead of the
    draws from `keys`. The two objective evaluations per generation see
    the whole (N, P|2P, M) population, which lets the batched kernel
    score every client in one launch.
    Returns dict(pop, objs, ranks) of the final population."""
    P, M, k = cfg.pop_size, n_models, cfg.k
    if device is None:
        device = valid_mask.device if valid_mask is not None else "cpu"
    init, breed = draws if draws is not None else _client_draws(
        keys, cfg, M, device)
    pop = _init_population(init, k, valid_mask, init_pop)
    for g in range(cfg.generations):
        objs = eval_fn(pop)
        ranks = nondominated_rank(objs)
        crowd = crowding_distance(objs, ranks)
        child = _breed(pop, ranks, crowd,
                       BreedDraws(*(d[:, g] for d in breed)), cfg,
                       valid_mask)
        allp = torch.cat([pop, child], dim=-2)          # (N, 2P, M)
        order = _survival_order(eval_fn(allp))[0]
        pop = _rows(allp, order[..., :P])
    objs = eval_fn(pop)
    return {"pop": pop, "objs": objs, "ranks": nondominated_rank(objs)}


def run_nsga2(eval_fn: Callable, n_models: int, cfg: NSGAConfig,
              key: Optional[int] = None, init_pop=None, valid_mask=None,
              device=None):
    """One client's GA: eval_fn (P, M) -> (P, n_obj). `key` is this
    run's generator seed (defaults to client_keys(cfg.seed, [0]))."""
    if key is None:
        key = client_keys(cfg.seed, [0])[0]
    out = run_nsga2_batched(
        lambda pop: eval_fn(pop[0]).unsqueeze(0), n_models, cfg, [key],
        init_pop=init_pop,
        valid_mask=None if valid_mask is None else valid_mask.unsqueeze(0),
        device=device)
    return {name: v[0] for name, v in out.items()}
