"""Compiled array-world simulator: the tick-stepped backend (port of
`repro/sim/compiled.py`).

The event-granular loop (fl/scheduler.simulate_async) pops one heap
event at a time through Python — perfect for auditing protocol logic,
hopeless at 10k-100k clients. This module re-expresses the SAME
dissemination process (push gossip + churn + anti-entropy repair over a
lossy transport) as dense whole-fleet tensor transitions on the
experiment's device, advanced one TICK at a time:

  arrive    (N, K) int32   earliest pending arrival per (client, key),
                           bit-packed as (tick << bits) | src so one
                           scatter-min keeps (tick, src) paired (ties
                           break toward the smallest src); src == N is
                           the SELF sentinel (own training).
  have      (N, K) int32   tick at which the client admitted the key
                           (INF = not yet).
  adj       (N, deg_max)   the gossip overlay, -1 padded.
  repair    (E,)/(E, K)    per-directed-edge digest stream state:
                           rounds / calm / active / next_dig /
                           dig_arrive, and per-(edge, key) re-send
                           attempt counts.

One step = one tick: process due arrivals (churn-gated accept / loss /
dedup), fan accepted keys out to neighbors with a scatter-min, then run
the repair subsystem (digest emission, receipt, gap re-sends,
wake-on-admit). Where the reference runs a chunk as one jitted
`lax.scan`, the port runs it as a Python loop of `chunk_ticks` eager
steps on the device; between chunks the host reads the next pending
tick and fast-forwards over idle gaps, as the reference does.

The results equal the reference's compiled backend bit for bit: the
same host-side float64 precompute (`train_completions`, `edge_rng`,
`ChurnSchedule.online_matrix` / `leave_ticks`), the same splitmix
counter hash (`_hash_u32`, in wrapping int32 arithmetic with logical
shifts), the same int32 counters and the same float32 latency formulas,
operation for operation (tests/test_torch_compiled.py holds this on the
CPU, chip_smoke.py card against CPU). The tick-quantization contract and
the documented divergences from the event loop are the reference's
(DESIGN.md §10).
"""
from __future__ import annotations

import math
from types import SimpleNamespace
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.fl.scheduler import AsyncConfig, train_completions
from repro_torch.obs.metrics import Stopwatch
from repro_torch.p2p.transport import edge_rng

INF = 2**31 - 1
_EPS = 1e-4  # float32 ceil guard: latency/tick ratios land within 1e-7
#              of integers when tick divides the latency; a true
#              fractional part below 1e-4 is quantization noise

# hash domains (in-step random streams)
_D_FDROP, _D_FJIT = 0x1111, 0x2222        # forward drop / jitter
_D_DDROP, _D_DJIT = 0x3333, 0x4444        # digest drop / jitter
_D_BOFF, _D_RDROP, _D_RJIT = 0x5555, 0x6666, 0x7777  # re-send streams

_M32 = 0xFFFFFFFF


def _i32(v: int) -> int:
    """A 32-bit pattern as the signed int32 value with the same bits."""
    v &= _M32
    return v - (1 << 32) if v >= 1 << 31 else v


_C1, _C2 = _i32(0x85EBCA77), _i32(0xC2B2AE3D)


def _hash_u32(seed, dom, *parts):
    """Splitmix-style counter hash: the reference's uint32 `_hash_u32`,
    bit for bit, as int32 tensors holding the same 32-bit patterns.
    int32 multiplication and xor wrap exactly as uint32's do; the right
    shifts are made logical by masking off the sign extension."""
    h = ((0x243F6A88 ^ (seed & _M32)) ^ dom) * 0x9E3779B1
    h = _i32(h)
    for p in parts:
        h = h ^ p
        h = h * _C1
        h = h ^ ((h >> 13) & 0x7FFFF)
        h = h * _C2
        h = h ^ ((h >> 16) & 0xFFFF)
    return h


def _hash01(seed, dom, *parts):
    """uint32 hash -> float32 in [0, 1]: the unsigned value rounded to
    float32 (to nearest even, as the reference's cast), times 2^-32."""
    u = _hash_u32(seed, dom, *parts).to(torch.int64) & _M32
    return u.to(torch.float32) * 2.0**-32


def _f32(x: float) -> float:
    """A Python scalar as the float32 value the reference computes with
    (a weakly typed scalar meets a float32 array as float32)."""
    return float(np.float32(x))


def _fma(a, b, c):
    """a * b + c with one rounding to float32. XLA:CPU contracts the
    reference's float32 `a * b + c` into a fused multiply-add; eager
    torch rounds after each op. Emulated in float64: the product of two
    float32 values is exact there, so only the sum rounds twice (float64,
    then float32), which can differ from the fused result only when the
    float64 sum lands on a float32 tie (no run that the tests or
    chip_smoke.py compare shows one)."""
    def wide(x):
        return x.double() if torch.is_tensor(x) else x
    return (wide(a) * wide(b) + wide(c)).float()


def _ceil_ticks(lat, W):
    """Latency -> whole ticks, >= 1 (a hop never lands inside its own
    send tick, so same-tick forward cascades cannot occur). The
    reference's `lat / tick - _EPS` compiles to fma(lat, 1/tick, -_EPS)
    with the reciprocal rounded to float32 (XLA turns a division by a
    constant into a product with its reciprocal)."""
    return torch.clamp_min(
        torch.ceil(_fma(lat, W.recip, -_f32(_EPS))).to(torch.int32), 1)


def _link_latency(W, r):
    """The reference's `base * (1.0 + jitter * r) + C` for a uniform
    draw r, as XLA:CPU computes it: fma(base, fma(jitter, r, 1), C)
    with C the float32 message-size term."""
    return _fma(_f32(W.base), _fma(_f32(W.jitter), r, 1.0),
                _f32(W.nb * W.inv_bw))


# ---- world assembly ----------------------------------------------------


def _make_world(acfg: AsyncConfig, gossip, transport, churn, repair,
                tick: Optional[float], device) -> SimpleNamespace:
    """Validate the component stack and freeze every static parameter
    the tick step closes over (Python scalars + small device tensors)."""
    if gossip is None or transport is None:
        raise ValueError(
            "the compiled backend requires both a gossip and a transport "
            "component (the legacy single-hop broadcast path is "
            "event-only); use backend='event'")
    gs = gossip.array_state()          # validates push-only, fanout=0
    tp = transport.array_params()      # validates inbox=0, constant sizer
    n, mpc = acfg.n_clients, acfg.models_per_client
    K = n * mpc
    if tick is None:
        tick = tp["base_latency"]
    if tick <= 0:
        raise ValueError(f"tick must be > 0 (got {tick}); the default is "
                         "the transport base_latency")
    bits = max(1, int(math.ceil(math.log2(n + 2))))
    max_rep = (INF >> bits) - 1   # largest packable tick

    def dev(a):
        return torch.as_tensor(np.asarray(a), device=device)
    W = SimpleNamespace(
        n=n, mpc=mpc, K=K, tick=float(tick), bits=bits, max_rep=max_rep,
        src_mask=(1 << bits) - 1, deg_max=int(gs["deg_max"]),
        adj=dev(gs["adj"]), device=device,
        recip=float(np.float32(1.0) / np.float32(tick)),
        base=float(tp["base_latency"]), jitter=float(tp["jitter"]),
        drop=float(tp["drop_prob"]), nb=int(tp["nbytes"]),
        inv_bw=(1.0 / tp["bandwidth"]
                if math.isfinite(tp["bandwidth"]) else 0.0),
        seed=int(tp["seed"]),
        leave=dev(churn.leave_ticks(tick)) if churn is not None
        else torch.full((n,), INF, dtype=torch.int32, device=device),
        rep=None)
    if repair is not None:
        rs = repair.array_state(tick)
        W.rep = SimpleNamespace(
            E=int(rs["n_edges"]), e_src=dev(rs["e_src"]).long(),
            e_dst=dev(rs["e_dst"]).long(), rev=dev(rs["rev"]).long(),
            interval=int(rs["interval_ticks"]),
            start=int(rs["start_tick"]), max_rounds=int(rs["max_rounds"]),
            quiesce=int(rs["quiesce_after"]),
            max_att=int(rs["max_attempts"]), budget=int(rs["budget"]),
            boff_base=float(rs["backoff_base"]),
            boff_factor=float(rs["backoff_factor"]),
            bpe=int(rs["bytes_per_entry"]), seed=int(rs["seed"]))
        W.rep.e_dst32 = W.rep.e_dst.to(torch.int32)
        W.rep.rev_ext = torch.where(W.rep.rev >= 0, W.rep.rev, W.rep.E)
        W.rep.e_idx = torch.arange(W.rep.E, dtype=torch.int32,
                                   device=device)
        # factor ** attempt for every attempt count a step can hold
        # (0 ..= max_attempts + 1): one gather, where the reference
        # calls pow; exact for the default factor 2.0
        W.rep.boff_pow = dev(np.power(
            np.float32(W.rep.boff_factor),
            np.arange(W.rep.max_att + 2, dtype=np.float32)))
    return W


_CNT = ("acc", "lost", "sent", "drop", "supp")
_RC = ("dig_sent", "dig_drops", "dig_bytes", "dig_recv", "dig_lost",
       "dig_bytes_recv", "gaps", "resends", "deferred", "exhausted",
       "quiesced")


def _init_block(W, acfg, train_cost, churn, gossip, k_lo: int,
                k_hi: int) -> tuple:
    """Host-side exact precompute for keys [k_lo, k_hi): self-arrivals
    at train-completion ticks (SELF sentinel) and the FIRST-HOP pushes
    of every trained model through the REAL `edge_rng` streams — the
    draws the event backend would make for the same sends, so first-hop
    drops and jitters are bit-identical across backends."""
    n, mpc, bits, tick = W.n, W.mpc, W.bits, W.tick
    Kb = k_hi - k_lo
    arrive = np.full((n, Kb), INF, np.int64)
    comp = train_completions(acfg, train_cost, churn)  # (n, mpc) float64
    neighbors = gossip.neighbors
    sent = dropped = swallowed = 0
    for k in range(k_lo, k_hi):
        c, m = divmod(k, mpc)
        t_done = comp[c, m]
        if churn is not None and churn.departed(c, t_done):
            continue  # left before finishing: no admit, no pushes
        t_tick = min(int(math.ceil(t_done / tick - 1e-9)), W.max_rep)
        col = k - k_lo
        arrive[c, col] = min(arrive[c, col], (t_tick << bits) | n)
        if churn is not None and not churn.is_online(c, t_done):
            swallowed += len(neighbors[c])  # sends gated at the sender
            continue
        for dst in neighbors[c]:
            rng = edge_rng(W.seed, c, dst, (c, m))
            d1 = rng.random()
            d2 = rng.random()
            sent += 1
            if d1 < W.drop:
                dropped += 1
                continue
            lat = W.base * (1.0 + W.jitter * d2) + W.nb * W.inv_bw
            lt = max(1, int(math.ceil(lat / tick - 1e-9)))
            a_tick = min(t_tick + lt, W.max_rep)
            packed = (a_tick << bits) | c
            arrive[dst, col] = min(arrive[dst, col], packed)
    dev = W.device

    def zero():
        return torch.zeros((), dtype=torch.int32, device=dev)
    state = {
        "arrive": torch.as_tensor(arrive.astype(np.int32), device=dev),
        "have": torch.full((n, Kb), INF, dtype=torch.int32, device=dev),
        "cnt": {k: zero() for k in _CNT},
    }
    if W.rep is not None:
        R = W.rep
        i32 = dict(dtype=torch.int32, device=dev)
        state["rounds"] = torch.zeros(R.E, **i32)
        state["calm"] = torch.zeros(R.E, **i32)
        state["active"] = torch.ones(R.E, dtype=torch.bool, device=dev)
        state["next_dig"] = torch.full((R.E,), R.start, **i32)
        state["dig_arrive"] = torch.full((R.E,), INF, **i32)
        state["attempts"] = torch.zeros((R.E, Kb), **i32)
        state["rc"] = {k: zero() for k in _RC}
    return state, sent, dropped, swallowed


# ---- the tick step -----------------------------------------------------


def _count(mask) -> torch.Tensor:
    """The reference's `mask.sum(dtype=int32)`: an int32 0-dim count
    (one count never reaches 2^31; the int32 running totals it is added
    to wrap as the reference's do)."""
    return torch.count_nonzero(mask).to(torch.int32)


def _count_rows(mask) -> torch.Tensor:
    """Per-row int32 counts of a bool (rows, K) mask."""
    return torch.count_nonzero(mask, dim=1).to(torch.int32)


def _make_chunk_fn(W, chunk_ticks: int, Kb: int):
    """Build the chunk advance for key blocks of width Kb: `chunk_ticks`
    steps of whole-fleet tensor transitions, in place on `state`."""
    dev = W.device
    i32 = torch.int32
    INF_T = torch.tensor(INF, dtype=i32, device=dev)
    c_col = torch.arange(W.n, dtype=i32, device=dev)[:, None]
    adj_cols = [W.adj[:, s].contiguous() for s in range(W.deg_max)]
    u_safe = [u.clamp(0, W.n - 1).long()[:, None] for u in adj_cols]
    # deterministic-link fast path: with jitter=0 every model hop costs
    # the same whole number of ticks — no per-message draws at all
    lt_const = max(1, int(math.ceil(
        (W.base + W.nb * W.inv_bw) / W.tick - 1e-9)))

    def _forwards(t, arrive, recv_acc, src, cnt, k_row, dep_owner):
        """Fan this tick's accepted keys out one slot of the adjacency
        at a time: O(N*K) per slot, never materializing (N, deg, K).
        Arrivals toward clients that already hold the key are NOT
        filtered here — they land in the cell, fall through the accept
        mask, and are charged analytically as delivered - accepted."""
        for s in range(W.deg_max):
            u = adj_cols[s]                                   # (N,)
            fwd = recv_acc & (u >= 0)[:, None] & (u[:, None] != src)
            send = fwd & ~dep_owner
            cnt["supp"] += _count(fwd & dep_owner)
            cnt["sent"] += _count(send)
            del fwd
            if W.drop > 0:
                r1 = _hash01(W.seed, _D_FDROP, c_col, u[:, None], k_row)
                ok = send & (r1 >= W.drop)
                del r1
                cnt["drop"] += _count(send) - _count(ok)
            else:
                ok = send
            del send
            if W.jitter > 0:
                r2 = _hash01(W.seed, _D_FJIT, c_col, u[:, None], k_row)
                lat = _link_latency(W, r2)
                del r2
                arr = torch.clamp_max(t + _ceil_ticks(lat, W), W.max_rep)
                del lat
                packed = torch.where(ok, (arr << W.bits) | c_col, INF_T)
                del arr
            else:
                arr = min(t + lt_const, W.max_rep)
                packed = torch.where(ok, (arr << W.bits) | c_col, INF_T)
            del ok
            arrive.scatter_reduce_(0, u_safe[s].expand_as(packed), packed,
                                   "amin")
            del packed

    def _repair(t, state, have, online, woken, k_row, dep_owner_row):
        R = W.rep
        rounds, calm = state["rounds"], state["calm"]
        active, next_dig = state["active"], state["next_dig"]
        dig_arr, attempts = state["dig_arrive"], state["attempts"]
        rc, cnt = state["rc"], state["cnt"]
        arrive = state["arrive"]
        e_idx = R.e_idx
        dep_dst = t >= W.leave[R.e_dst]
        dep_src = t >= W.leave[R.e_src]
        # -- wake: this tick's admits/losses re-arm quiesced out-edges
        w_e = woken[R.e_src]
        calm = calm.masked_fill(w_e, 0)
        rearm = w_e & ~active & (rounds < R.max_rounds) & ~dep_dst
        active = active | rearm
        next_dig = next_dig.masked_fill(rearm, t + R.interval)
        # -- digest emission (sender side)
        due_e = active & (next_dig == t)
        ended = due_e & ((rounds >= R.max_rounds) | (calm >= R.quiesce)
                         | dep_dst | dep_src)
        emit_try = due_e & ~ended
        active = active & ~ended
        next_dig = next_dig.masked_fill(ended, INF)
        rounds = rounds + emit_try.to(i32)
        # an offline sender still consumes a round (tick-bounded streams)
        emit = emit_try & online[R.e_src]
        next_dig = next_dig.masked_fill(emit_try, t + R.interval)
        n_ent = _count_rows(have[R.e_src] != INF)
        nb_e = R.bpe * torch.clamp_min(n_ent, 1)
        d1 = _hash01(R.seed, _D_DDROP, e_idx, rounds)
        d2 = _hash01(R.seed, _D_DJIT, e_idx, rounds)
        ddrop = d1 < W.drop
        lat = _fma(_f32(W.base), _fma(_f32(W.jitter), d2, 1.0),
                   nb_e.to(torch.float32) * W.inv_bw)
        arr_d = torch.clamp_max(t + _ceil_ticks(lat, W), W.max_rep)
        dig_arr = torch.minimum(
            dig_arr, torch.where(emit & ~ddrop, arr_d, INF_T))
        rc["dig_sent"] += _count(emit)
        rc["dig_drops"] += _count(emit & ddrop)
        rc["dig_bytes"] += torch.where(emit, nb_e, 0).sum(dtype=i32)
        # -- digest receipt (receiver side, CURRENT have rows)
        due_d = dig_arr == t
        recv_d = due_d & online[R.e_dst]
        lost_d = due_d & ~online[R.e_dst]
        dig_arr = dig_arr.masked_fill(due_d, INF)
        remote = have[R.e_src] != INF       # (E, K)
        mine = have[R.e_dst] != INF
        live = ~dep_owner_row               # (1, K)
        nb_r = R.bpe * torch.clamp_min(_count_rows(remote), 1)
        rc["dig_recv"] += _count(recv_d)
        rc["dig_lost"] += _count(lost_d)
        rc["dig_bytes_recv"] += torch.where(recv_d, nb_r, 0).sum(dtype=i32)
        # reverse re-arm: src holds keys the receiver lacks -> restart
        # the receiver's own digest stream toward src
        wants = recv_d & (remote & ~mine & live).any(1) & (R.rev >= 0)
        backc = R.rev.clamp(0, R.E - 1)          # safe gather index
        rearm_b = wants & ~active[backc] & (rounds[backc] < R.max_rounds)
        # rev is injective, so each target index is written at most
        # once; rows with no reverse edge write to a spare slot E that is
        # dropped (the reference scatters them out of bounds with
        # mode="drop"), and never carry a True
        hit = torch.zeros(R.E + 1, dtype=torch.bool, device=dev)
        hit[R.rev_ext] = wants
        calm = calm.masked_fill(hit[:R.E], 0)
        hit[R.rev_ext] = rearm_b
        active = active | hit[:R.E]
        next_dig = next_dig.masked_fill(hit[:R.E], t + R.interval)
        # gaps: keys the receiver holds that the digest sender lacks
        gaps = recv_d[:, None] & mine & ~remote & live
        del remote, mine
        exh_now = gaps & (attempts == R.max_att)
        eligible = gaps & (attempts < R.max_att)
        rank = torch.cumsum(eligible, dim=1)    # key-order budget
        chosen = eligible & (rank <= R.budget)
        del rank
        deferred = eligible & ~chosen
        del eligible
        att = attempts
        attempts = attempts + (chosen | exh_now).to(i32)
        e_col = e_idx[:, None]
        b2 = _hash01(R.seed, _D_RDROP, e_col, k_row, att)
        rdrop = b2 < W.drop
        del b2
        b3 = _hash01(R.seed, _D_RJIT, e_col, k_row, att)
        lat_r = _link_latency(W, b3)
        del b3
        # delay = boff_base * factor**att * (1 + b1); delay + lat_r
        # contracts to fma(boff_base * factor**att, 1 + b1, lat_r)
        b1 = _hash01(R.seed, _D_BOFF, e_col, k_row, att)
        scale = _f32(R.boff_base) * R.boff_pow[att.long()]
        lat_r = _fma(scale, 1.0 + b1, lat_r)
        del b1, scale
        arr_r = torch.clamp_max(t + _ceil_ticks(lat_r, W), W.max_rep)
        del lat_r
        packed = torch.where(chosen & ~rdrop,
                             (arr_r << W.bits) | R.e_dst32[:, None], INF_T)
        del arr_r
        arrive.scatter_reduce_(0, R.e_src[:, None].expand_as(packed),
                               packed, "amin")
        del packed
        had_gap = gaps.any(1)
        nogap = recv_d & ~had_gap
        rc["gaps"] += _count(gaps)
        rc["resends"] += _count(chosen)
        rc["deferred"] += _count(deferred)
        rc["exhausted"] += _count(exh_now)
        rc["quiesced"] += _count(nogap & (calm + 1 == R.quiesce))
        cnt["sent"] += _count(chosen)
        cnt["drop"] += _count(chosen & rdrop)
        calm = torch.where(nogap, calm + 1, calm.masked_fill(recv_d, 0))
        state.update(rounds=rounds, calm=calm, active=active,
                     next_dig=next_dig, dig_arrive=dig_arr,
                     attempts=attempts)

    def chunk_fn(state, t0: int, k_lo: int, online_chunk):
        k_ids = k_lo + torch.arange(Kb, dtype=i32, device=dev)
        k_row = k_ids[None, :]
        owner_leave = W.leave[(k_ids // W.mpc).long()]  # (Kb,) departure
        for i in range(chunk_ticks):
            t = t0 + i
            online = online_chunk[i]
            arrive, have, cnt = state["arrive"], state["have"], state["cnt"]
            due = (arrive >> W.bits) == t
            src = arrive & W.src_mask
            is_self = src == W.n           # SELF bypasses the online
            #                                gate (trained-while-offline
            #                                still admits, event parity)
            lost = due & ~is_self & ~online[:, None]
            accept = due & ~lost & (have == INF)
            recv_acc = accept & ~is_self
            del is_self
            have.masked_fill_(accept, t)
            arrive.masked_fill_(due, INF)
            del due
            cnt["acc"] += _count(recv_acc)
            cnt["lost"] += _count(lost)
            dep_owner = (t >= owner_leave)[None, :]
            if W.deg_max > 0:
                _forwards(t, arrive, recv_acc, src, cnt, k_row, dep_owner)
            del recv_acc, src
            if W.rep is not None:
                woken = accept.any(1) | lost.any(1)
                del accept, lost
                _repair(t, state, have, online, woken, k_row, dep_owner)
            else:
                del accept, lost
        return state

    return chunk_fn


# ---- host loop ---------------------------------------------------------


def _next_tick(state, bits: int) -> Optional[int]:
    """Earliest tick with pending work, or None when the world is
    quiescent — packing is monotone, so min(arrive) >> bits IS the
    earliest pending arrival tick. The host loop fast-forwards to this
    tick, so idle stretches between train completions or digest rounds
    cost no steps."""
    out = None
    m = int(state["arrive"].min())
    if m != INF:
        out = m >> bits
    if "next_dig" in state:
        nd = int(state["next_dig"].masked_fill(~state["active"],
                                               INF).min())
        da = int(state["dig_arrive"].min())
        for v in (nd, da):
            if v != INF:
                out = v if out is None else min(out, v)
    return out


def simulate_compiled(acfg: AsyncConfig, train_cost: Callable, *,
                      transport, gossip, churn=None, repair=None,
                      tick: Optional[float] = None,
                      chunk_ticks: int = 256,
                      max_ticks: Optional[int] = None,
                      key_block: Optional[int] = None,
                      obs=None, device=None) -> dict:
    """Run the array-world simulation on `device` ("cuda" unless the
    caller passes "cpu"). Returns a dict with `have_tick` (N, K) int32
    numpy admit ticks (INF = never), `coverage`, `t_full`, `net`
    (event-trace-shaped counters), `perf`, `tick`, `n_ticks`.

    `obs` (repro_torch.obs.Obs, optional): when enabled, per-chunk
    counter aggregates are sampled ON THE HOST at each chunk boundary
    (probes.CompiledProbe) — the tick loop itself stays untouched."""
    device = resolve_device(device)
    sw_wall = Stopwatch().start()
    sw_build, sw_scan = Stopwatch(), Stopwatch()
    W = _make_world(acfg, gossip, transport, churn, repair, tick, device)
    probe = None
    if obs is not None and getattr(obs, "metrics", None) is not None \
            and obs.metrics.enabled:
        from repro_torch.obs.probes import CompiledProbe
        probe = CompiledProbe(obs.metrics, W.nb)
    if max_ticks is None:  # default: generous, but inside the packable
        max_ticks = min(200_000, W.max_rep - 1)  # (tick << bits) range
    if max_ticks >= W.max_rep:
        raise ValueError(
            f"max_ticks={max_ticks} exceeds the packable tick range "
            f"({W.max_rep} at n_clients={W.n}); use a coarser tick")
    if key_block is None:  # keep per-block int32 send counts < 2^29
        per_key = max(1, W.n * max(1, W.deg_max))
        key_block = max(1, min(W.K, (1 << 29) // per_key))
    if repair is not None and key_block < W.K:
        raise ValueError(
            "repair couples keys through shared digest streams — "
            f"key_block sharding (block={key_block} < K={W.K}) is only "
            "available with network.repair=None")
    key_block = min(key_block, W.K)
    blocks = [(lo, min(lo + key_block, W.K))
              for lo in range(0, W.K, key_block)]
    n_ticks = 0
    have_cols, cnt_tot, rc_tot = [], {}, {}
    swallowed = init_sent = init_drop = 0
    chunk_fns = {}
    for bi, (k_lo, k_hi) in enumerate(blocks):
        sw_build.start()
        state, s0, d0, sw0 = _init_block(W, acfg, train_cost, churn,
                                         gossip, k_lo, k_hi)
        init_sent += s0
        init_drop += d0
        swallowed += sw0
        if probe is not None:
            probe.start_block(bi, s0, s0 * W.nb)
        Kb = k_hi - k_lo
        if Kb not in chunk_fns:
            chunk_fns[Kb] = _make_chunk_fn(W, chunk_ticks, Kb)
        chunk = chunk_fns[Kb]
        sw_build.stop()
        sw_scan.start()
        while True:
            nxt = _next_tick(state, W.bits)
            if nxt is None:
                break
            if nxt >= max_ticks:
                raise RuntimeError(
                    f"compiled backend: pending work at tick {nxt} >= "
                    f"max_ticks={max_ticks} — the run did not quiesce; "
                    "raise max_ticks or check the repair/churn config")
            online = (torch.as_tensor(churn.online_matrix(
                nxt, chunk_ticks, W.tick), device=device)
                if churn is not None
                else torch.ones((chunk_ticks, W.n), dtype=torch.bool,
                                device=device))
            state = chunk(state, nxt, k_lo, online)
            n_ticks += chunk_ticks
            if probe is not None:
                # tiny device->host pulls (counter dicts + the covered
                # count); the tick loop itself is unchanged
                cnt = {k: int(v) for k, v in state["cnt"].items()}
                rc = ({k: int(v) for k, v in state["rc"].items()}
                      if "rc" in state else None)
                h = state["have"]
                probe.sample((nxt + chunk_ticks) * W.tick, cnt, rc,
                             int((h != INF).sum()), h.numel())
        have_cols.append(state["have"].cpu().numpy())
        for k, v in state["cnt"].items():
            cnt_tot[k] = cnt_tot.get(k, 0) + int(v)
        if "rc" in state:
            for k, v in state["rc"].items():
                rc_tot[k] = rc_tot.get(k, 0) + int(v)
        del state
        sw_scan.stop()
    have = np.concatenate(have_cols, axis=1)
    covered = have != INF
    coverage = float(covered.mean()) if have.size else 1.0
    t_full = (float(have.max() * W.tick) if coverage == 1.0 and have.size
              else float("nan"))
    # counter assembly: mirror the event trace's net dict shapes
    sent_m = init_sent + cnt_tot["sent"]
    drop_m = init_drop + cnt_tot["drop"]
    delivered_m = max(0, sent_m - drop_m - cnt_tot["lost"])
    dedup = max(0, delivered_m - cnt_tot["acc"])
    net = {
        "lost_offline": swallowed + cnt_tot["lost"],
        "transport": {
            "n_sent": sent_m + rc_tot.get("dig_sent", 0),
            "n_delivered": delivered_m + rc_tot.get("dig_recv", 0),
            "n_dropped_link": drop_m + rc_tot.get("dig_drops", 0),
            "n_dropped_inbox": 0,
            "bytes_sent": sent_m * W.nb + rc_tot.get("dig_bytes", 0),
            "bytes_delivered": delivered_m * W.nb
            + rc_tot.get("dig_bytes_recv", 0),
            "bytes_rejected": 0,
            "n_corrupt_detected": 0,
            "n_corrupt_admitted": 0,
        },
        "gossip": {"n_accepted": cnt_tot["acc"], "n_dedup": dedup,
                   "n_suppressed": cnt_tot["supp"], "n_pull": 0},
    }
    if repair is not None:
        net["repair"] = {
            "n_digests_sent": rc_tot["dig_sent"],
            "n_digests_recv": rc_tot["dig_recv"],
            "n_digests_lost": rc_tot["dig_lost"],
            "n_gaps_found": rc_tot["gaps"],
            "n_resends": rc_tot["resends"],
            "n_budget_deferred": rc_tot["deferred"],
            "n_inflight_skipped": 0,
            "n_attempts_exhausted": rc_tot["exhausted"],
            "n_quiesced": rc_tot["quiesced"],
            "bytes_digests": rc_tot["dig_bytes"],
        }
    wall = sw_wall.stop()
    perf = {"backend": "compiled", "wall_s": round(wall, 6),
            "n_ticks": n_ticks,
            "ticks_per_s": round(n_ticks / max(wall, 1e-9), 1),
            "phases": {"build_s": round(sw_build.total, 6),
                       "scan_s": round(sw_scan.total, 6)}}
    return {"have_tick": have, "coverage": coverage, "t_full": t_full,
            "net": net, "perf": perf, "tick": W.tick, "n_ticks": n_ticks}


# ---- experiment backend hook ------------------------------------------


def run_compiled(exp, *, tick: Optional[float] = None,
                 chunk_ticks: int = 256,
                 max_ticks: Optional[int] = None,
                 key_block: Optional[int] = None, obs=None):
    """`schedule.backend = "compiled"`: execute a built Experiment's
    async run in the array world, on the experiment's device, and wrap
    the result as a RunResult. Worlds with per-sample state (image
    kinds) and in-run selection are event-only — rejected loudly, never
    silently approximated."""
    from repro_torch.core.bench import BenchEntry
    from repro_torch.sim.experiment import RunResult
    spec = exp.spec
    data, sched = spec.data, spec.schedule
    if getattr(exp, "serving", None) is not None:
        exp.serving.array_params()  # always raises, naming the traffic
    if data.kind not in ("none", "prediction_world"):
        raise ValueError(
            f'the compiled backend supports data.kind "none" and '
            f'"prediction_world" (got {data.kind!r}): image worlds '
            "train real models per event; use backend='event'")
    if sched.select_during_run and exp.engine is not None:
        raise ValueError(
            "the compiled backend cannot run in-loop selection "
            "(select events are event-granular): set "
            "schedule.select_during_run=False or "
            "selection.enabled=False")
    if getattr(exp, "faults", None) is not None:
        exp.faults.array_params()  # always raises, naming active kinds
    if getattr(exp, "admission", None) is not None:
        raise ValueError(
            "the compiled backend does not support validation-gated "
            "admission (screening happens per store add, which the "
            "array world does not perform); use schedule.backend="
            "'event'")
    n, mpc = data.n_clients, exp.models_per_client
    acfg = AsyncConfig(
        n_clients=n, models_per_client=mpc,
        speed_lognorm_sigma=sched.speed_lognorm_sigma,
        link_latency=sched.link_latency,
        select_debounce=sched.select_debounce,
        seed=sched.seed if sched.seed is not None else spec.seed)
    out = simulate_compiled(
        acfg, exp.train_cost, transport=exp.transport, gossip=exp.gossip,
        churn=exp.churn, repair=exp.repair, tick=tick,
        chunk_ticks=chunk_ticks, max_ticks=max_ticks,
        key_block=key_block, obs=obs if obs is not None
        else getattr(exp, "obs", None), device=exp.device)
    if data.kind == "prediction_world" and exp.stores is not None:
        _, mats = exp.world
        C = data.n_classes
        have = out["have_tick"]
        for c in range(n):
            ks = np.flatnonzero(have[c] != INF)
            for k in ks[np.argsort(have[c][ks], kind="stable")]:
                gid = int(k)
                owner, m = divmod(gid, mpc)
                exp.stores[c].add(
                    BenchEntry(model_id=gid, owner=owner, family=f"f{m}",
                               predict=lambda x: np.full(
                                   (len(x), C), 1.0 / C, np.float32)),
                    preds=mats[(c, gid)],
                    t=float(have[c][k] * out["tick"]))
    return RunResult(
        spec=spec, mode="async", coverage=out["coverage"],
        t_full=out["t_full"], net=out["net"], perf=out["perf"],
        stores=exp.stores, engine=exp.engine,
        transport=exp.transport, gossip=exp.gossip, churn=exp.churn,
        repair=exp.repair)
