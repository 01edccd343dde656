"""Asynchronous decentralized learning simulator (virtual clock; port of
`repro/fl/scheduler.py`, plain Python on the host as there).

The paper's asynchrony claim: clients train, exchange, and re-select at
their own pace with NO global synchronization barrier. We simulate this
with a discrete-event loop: heterogeneous client speeds, per-edge gossip
latency, and ensemble re-selection triggered by model arrivals.

Events:
  ("trained", c, model_id)  — client c finished local training of a model
  ("recv",    c, model_id)  — a peer's model arrived at client c
  ("select",  c)            — client c re-runs ensemble selection

Selection is DEBOUNCED and BATCHED: arrivals schedule the client's select
on the next tick of a `select_debounce`-spaced grid, so clients whose
arrivals land in the same window share one select timestamp, and the loop
drains all same-TICK select events (integer grid indices, robust to FP
error in the tick times) into a single `on_select_batch` call — which the
unified engine (core/engine.py) answers with one batched NSGA-II run
covering every ready client, scored by the ensemble_fitness kernel on
the card. With the device-resident engine (DESIGN.md §7) each
`recv`/`trained` arrival only enqueues a dirty slot on the host store;
the batched select drains those queues into one in-place device scatter
before the GA launches, so steady-state select cost is
proportional to what changed since the last tick, not to fleet size. The
trace records each drained batch in `select_batches`.

The exchange layer is pluggable (DESIGN.md §6, §8):
  - `transport` (p2p.GossipTransport): per-edge latency/bandwidth/drop and
    bounded inboxes decide each recv's delay — or loss — instead of the
    flat `link_latency`;
  - `gossip` (p2p.GossipProtocol): epidemic relay with version-vector
    dedupe instead of single-hop broadcast. `gossip.note_sent` fires only
    AFTER `transport.send` accepted the message (a failed send leaves the
    peer re-targetable), and a receiver-offline arrival is reported back
    via `gossip.note_lost` so the sender's belief is invalidated;
  - `churn` (p2p.ChurnSchedule): offline clients neither send nor
    receive; departed clients' models stop propagating;
  - `repair` (p2p.AntiEntropyRepair, requires transport + gossip):
    periodic per-edge digest exchange ("digest_send"/"digest" events,
    priced through the transport) detects missing (key, version) pairs
    and schedules bounded "resend" events with deterministic per-attempt
    backoff — the loop that makes lossy-link dissemination eventually
    complete instead of best-effort.
All latency draws come from per-(src, dst, model, attempt, version)
fold_in-style streams (`p2p.transport.edge_rng`), never from a shared rng
consumed in event order, so a trace is a pure function of the seed — and
equal, event for event, to the reference's for the same inputs.
"""
from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Callable, Optional

import numpy as np

from repro_torch.obs.metrics import NULL_METRICS, Stopwatch
from repro_torch.p2p.transport import DIGEST_OWNER, edge_rng


@dataclasses.dataclass
class AsyncConfig:
    n_clients: int = 8
    models_per_client: int = 2
    speed_lognorm_sigma: float = 0.6   # systems heterogeneity
    link_latency: float = 0.05         # fraction of mean train time
    select_debounce: float = 0.1       # batch arrivals before re-selecting
    seed: int = 0


@dataclasses.dataclass
class AsyncTrace:
    events: list                       # (time, kind, client, payload)
    bench_sizes: dict                  # client -> [(t, size)]
    selections: dict                   # client -> [(t, val_acc)]
    select_batches: list = dataclasses.field(default_factory=list)
    # ^ (t, n_clients) per drained select tick — how well the debounce
    #   grid coalesces the fleet into one batched (device-resident) select
    net: Optional[dict] = None         # transport/gossip/churn counters
    perf: Optional[dict] = None        # in-band throughput counters
    # ^ {"wall_s", "n_events", "events_per_s", "phases": {"net_s",
    #   "select_s"}}, measured in the loop itself


def client_speeds(cfg: AsyncConfig) -> np.ndarray:
    """Per-client lognormal speed multipliers — the reference's seed
    convention, so train completions agree with its runs."""
    rng = np.random.default_rng(cfg.seed)
    return np.exp(rng.normal(0, cfg.speed_lognorm_sigma, cfg.n_clients))


def train_completions(cfg: AsyncConfig, train_cost: Callable,
                      churn=None) -> np.ndarray:
    """(n_clients, models_per_client) virtual completion time of every
    local training — join-offset, speed-scaled, sequential per client.
    The single source of truth for "trained" event times."""
    speeds = client_speeds(cfg)
    out = np.zeros((cfg.n_clients, cfg.models_per_client))
    for c in range(cfg.n_clients):
        t_done = float(churn.join[c]) if churn is not None else 0.0
        for m in range(cfg.models_per_client):
            t_done += speeds[c] * train_cost(c, m)
            out[c, m] = t_done
    return out


def _select_tick(t: float, debounce: float) -> int:
    """Integer index of the next debounce-grid tick after t. Comparing
    tick INDICES (not the float times reconstructed from them) is what
    makes same-window coalescing robust to FP error in the grid."""
    return math.floor(t / debounce) + 1


def simulate_async(cfg: AsyncConfig, neighbors, train_cost: Callable,
                   on_select: Optional[Callable] = None,
                   on_add: Optional[Callable] = None,
                   on_select_batch: Optional[Callable] = None,
                   transport=None, gossip=None, churn=None,
                   repair=None, faults=None, on_crash=None,
                   serving=None, obs=None) -> AsyncTrace:
    """train_cost(client, local_idx) -> virtual duration of that training.
    on_add(client, model_key, t) — a model (own or peer) entered the
      client's bench; the engine uses this to incrementally materialize
      the prediction store.
    on_select(client, bench_ids, t) -> val_acc (or None to skip recording).
    on_select_batch(clients, {client: bench_ids}, t) -> {client: val_acc}
      — preferred: all clients whose debounced select fires at time t are
      handed over in ONE call for batched re-selection.
    transport/gossip/churn — optional p2p layers (see module docstring);
      with none given the legacy single-hop, lossless exchange runs, but
      with per-edge deterministic latency streams.
    repair — optional p2p.AntiEntropyRepair (requires transport AND
      gossip): drives the periodic digest / bounded-resend event kinds.
    faults — optional repro_torch.faults.FaultController: seeds the heap with
      "crash"/"restart"/"partition"/"heal" events, gates sends on crash
      downtime and cut edges, runs the per-delivery corruption check, and
      marks corrupt-admitted payloads for the driver's on_add. Every
      consultation is behind `faults is not None`, so a fault-free run is
      byte-identical to one without the parameter.
    on_crash(client, t) — driver hook fired when a crash event wipes a
      client's bench (the driver wipes its prediction store and any
      admission-gate state in the same instant).
    serving — optional repro_torch.serve.ServingEngine: seeds the heap with
      "query"/"drift" events (every micro-batch precomputed from the
      serve seed), answers each query batch from the client's current
      ensemble, and — when its accuracy monitor breaches — requests a
      re-selection through the standard debounced select grid. Offline
      clients (churn or crash) drop their query batches. Every
      consultation is behind `serving is not None`, so a serve-free run
      is byte-identical to one without the parameter.
    obs — optional repro_torch.obs.probes.Obs: when given, the loop
      feeds the metrics registry (coverage gauge, select-batch width, select
      wall time) and — if `obs.trace` is set — the per-event Perfetto
      trace collector (one track per client: train/recv/select/digest/
      resend slices, send->recv flow events, bytes-on-wire and coverage
      counter tracks).

    Returns the full event trace — tests assert gossip convergence and
    monotone bench growth on it. `trace.net` carries the p2p counters
    (bytes on wire, drops, dedups, offline losses, repair activity) when
    layers are given.
    """
    if repair is not None and (transport is None or gossip is None):
        raise ValueError("repair requires both transport and gossip layers")
    mx = obs.metrics if obs is not None else NULL_METRICS
    tc = obs.trace if obs is not None else None
    # the ONE perf_counter idiom: total run wall time plus the selection
    # phase, which (bound to an enabled registry) doubles as the
    # engine.select_wall_s series
    sw_wall = Stopwatch().start()
    sw_select = mx.stopwatch("engine.select_wall_s")
    q = []  # (time, seq, kind, client, payload, src)
    seq = 0
    bench = {c: set() for c in range(cfg.n_clients)}
    pending_select = set()
    n_admits = 0
    cov_total = cfg.n_clients * cfg.n_clients * cfg.models_per_client
    n_lost_offline = 0  # sends/recvs swallowed because an endpoint was away
    trace = AsyncTrace(events=[], bench_sizes={c: [] for c in range(cfg.n_clients)},
                       selections={c: [] for c in range(cfg.n_clients)})
    want_select = on_select is not None or on_select_batch is not None

    def push(t, kind, c, payload, src=-1):
        nonlocal seq
        heapq.heappush(q, (t, seq, kind, c, payload, src))
        seq += 1

    def schedule_select(c, t):
        if c in pending_select:
            return
        pending_select.add(c)
        if cfg.select_debounce > 0:
            tick = _select_tick(t, cfg.select_debounce)
            push(tick * cfg.select_debounce, "select", c, tick)
        else:
            push(t, "select", c, None)

    def record_selection(c, t, acc):
        if acc is not None:
            trace.selections[c].append((t, float(acc)))

    def send_model(src, dst, key, t, version=None):
        """One message through the exchange layer: churn gates the sender,
        the transport (or the legacy per-edge stream) prices the link.
        `gossip.note_sent` fires only once the transport ACCEPTED the
        message — a dropped or inbox-rejected send must leave dst
        re-targetable (the optimistic-ack fix). The message carries the
        sender's CURRENT version of the key (default) so it survives
        delivery into `gossip.on_receive`; repair re-sends pin the
        version their retry streams were folded with."""
        nonlocal n_lost_offline
        if churn is not None and not churn.is_online(src, t):
            n_lost_offline += 1
            return
        if faults is not None:
            if not faults.is_online(src, t):
                n_lost_offline += 1  # crashed sender: nothing goes out
                return
            if faults.edge_cut(src, dst, t):
                faults.stats.n_partition_blocked += 1
                return  # the link is physically down, no transport attempt
        if version is None:
            version = gossip.have[src].get(key, 0) if gossip is not None \
                else 0
        if transport is not None:
            arrival = transport.send(src, dst, key, t, version=version)
            if tc is not None:  # dropped sends book wire bytes too
                tc.counter("bytes_on_wire", t, transport.stats.bytes_sent)
            if arrival is None:
                return
        else:
            lat = cfg.link_latency * (1 + edge_rng(cfg.seed, src, dst,
                                                   key).random())
            arrival = t + lat
        if gossip is not None:
            gossip.note_sent(src, dst, key)
        if tc is not None:
            tc.flow(src, dst, f"({key[0]},{key[1]})", t, arrival)
        push(arrival, "recv", dst, (key, version), src)

    def admit(c, key, t):
        """A new model enters client c's bench."""
        nonlocal n_admits
        bench[c].add(key)
        n_admits += 1
        if mx.enabled:  # fraction of all (client, key) pairs held
            mx.set("coverage.fraction", n_admits / cov_total, t=t)
        if tc is not None:
            tc.counter("coverage", t, n_admits / cov_total)
        trace.bench_sizes[c].append((t, len(bench[c])))
        if on_add is not None:
            on_add(c, key, t)
        if repair is not None:  # new content re-arms quiesced digest edges
            for dst in repair.wake(c, t):
                push(t + repair.cfg.interval, "digest_send", c, dst)

    completions = train_completions(cfg, train_cost, churn)
    if tc is not None:
        # per-model training DURATIONS: completions are sequential per
        # client starting at the join time, so slice widths come from
        # consecutive differences
        durs = completions.copy()
        durs[:, 1:] = np.diff(completions, axis=1)
        if churn is not None:
            durs[:, 0] -= np.asarray(churn.join)[:cfg.n_clients]
    for c in range(cfg.n_clients):
        for m in range(cfg.models_per_client):
            push(completions[c, m], "trained", c, (c, m))
    if repair is not None:
        for a, b in repair.edges:
            push(repair.cfg.start, "digest_send", a, b)
    if faults is not None:
        for ft, fkind, fc, fpay in faults.initial_events():
            push(ft, fkind, fc, fpay)
    if serving is not None:
        for st, skind, sc, spay in serving.initial_events():
            push(st, skind, sc, spay)

    while q:
        t, _, kind, c, payload, src = heapq.heappop(q)
        if kind == "select":
            tpay = None
        elif kind == "digest":  # elide the version-vector snapshot:
            tpay = (payload[0], payload[2])  # (round, nbytes)
        elif kind == "recv":
            tpay = payload[0]  # the key; the in-flight version rides along
        else:
            tpay = payload
        trace.events.append((t, kind, c, tpay))
        if kind == "trained":
            if churn is not None and churn.departed(c, t):
                continue  # client left before finishing this training
            if faults is not None and (not faults.is_online(c, t)
                                       or payload in bench[c]):
                # crashed mid-training (the restart handler re-admits
                # durable artifacts), or the restart at exactly this t
                # already re-admitted it — never admit twice
                continue
            if tc is not None:
                tc.slice(c, f"train m{payload[1]}", t - durs[c, payload[1]],
                         t, cat="train")
            admit(c, payload, t)
            if want_select:  # own models also re-trigger selection
                schedule_select(c, t)
            if gossip is not None:
                targets = gossip.on_local(c, payload, t)
            else:
                targets = [(nb, payload) for nb in neighbors[c]]
            for dst, key in targets:
                send_model(c, dst, key, t)
        elif kind == "recv":
            key, ver = payload
            away = (churn is not None and not churn.is_online(c, t)) \
                or (faults is not None and not faults.is_online(c, t))
            if tc is not None:  # flow ends bind to this arrival slice
                tc.slice(c, ("recv lost" if away else "recv") +
                         f" ({key[0]},{key[1]})", t, t, cat="recv",
                         args={"src": src, "ver": ver})
                if transport is not None and transport.cfg.inbox_capacity:
                    tc.counter("inbox_depth", t,
                               int(transport.inflight[c]) - 1)
            if transport is not None:
                transport.deliver(src, c, key, lost=away, t=t)
            if away:
                n_lost_offline += 1  # receiver away: message is lost
                if gossip is not None:  # NACK: sender must not believe it
                    gossip.note_lost(src, c, key)
                if repair is not None:
                    # the loss re-opens a gap only c's own digests can
                    # advertise — re-arm its (possibly quiesced) streams
                    for dst in repair.wake(c, t):
                        push(t + repair.cfg.interval, "digest_send", c,
                             dst)
                continue
            if faults is not None:
                verdict = faults.corrupt_check(src, c, key, ver)
                if verdict == "detected":
                    # checksum caught the corruption: the delivery is
                    # discarded, the sender's belief invalidated, and the
                    # receiver's digest streams re-armed so anti-entropy
                    # re-delivers — same recovery path as an offline loss
                    if transport is not None:
                        transport.stats.n_corrupt_detected += 1
                    if gossip is not None:
                        gossip.note_lost(src, c, key)
                    if repair is not None:
                        for dst in repair.wake(c, t):
                            push(t + repair.cfg.interval, "digest_send",
                                 c, dst)
                    continue
                if verdict == "admitted":
                    if transport is not None:
                        transport.stats.n_corrupt_admitted += 1
                    faults.mark_corrupt(c, key)
            if gossip is not None:
                accepted, forwards = gossip.on_receive(c, src, key, t,
                                                       version=ver)
                if accepted and key not in bench[c]:
                    admit(c, key, t)
                    schedule_select(c, t)
                elif accepted and faults is not None \
                        and on_add is not None:
                    # a higher-version refresh of a resident key (a
                    # rejoined owner's re-announcement): the CONTENT may
                    # have changed — re-materialize and re-screen
                    on_add(c, key, t)
                    schedule_select(c, t)
                for dst, fkey in forwards:
                    send_model(c, dst, fkey, t)
            elif key not in bench[c]:
                admit(c, key, t)
                schedule_select(c, t)
            if faults is not None:
                # a marked corrupt delivery that never reached an on_add
                # (version dedupe) must not poison a later clean one
                faults.clear_corrupt(c, key)
        elif kind == "digest_send":
            if faults is not None:
                # a cut or crashed sender still consumes a digest round
                # (so even an unhealed partition cannot keep the stream
                # alive past max_rounds); the heal handler re-arms edges
                # that quiesced during the window
                cut = faults.edge_cut(c, payload, t)
                s_on = ((not cut) and faults.is_online(c, t)
                        and (churn is None or churn.is_online(c, t)))
                entries, rnd, nb, again = repair.poll(c, payload, t,
                                                      sender_online=s_on)
                if cut and again:
                    faults.stats.n_partition_blocked += 1
            else:
                entries, rnd, nb, again = repair.poll(c, payload, t)
            if again:
                push(t + repair.cfg.interval, "digest_send", c, payload)
            if entries is not None:
                if tc is not None:
                    tc.slice(c, f"digest_send r{rnd}", t, t, cat="repair",
                             args={"dst": payload, "nbytes": nb})
                arrival = transport.send(c, payload, (DIGEST_OWNER, rnd),
                                         t, nbytes=nb)
                if transport.last_outcome != "inbox":
                    # inbox-rejected digests never touched the wire —
                    # keep bytes_digests consistent with bytes_sent
                    repair.stats.bytes_digests += nb
                if arrival is not None:
                    push(arrival, "digest", payload, (rnd, entries, nb),
                         src=c)
        elif kind == "digest":
            rnd, entries, nb = payload
            away = churn is not None and not churn.is_online(c, t)
            if tc is not None:
                tc.slice(c, ("digest lost" if away else "digest") +
                         f" r{rnd}", t, t, cat="repair",
                         args={"src": src, "nbytes": nb})
            transport.deliver(src, c, (DIGEST_OWNER, rnd), lost=away,
                              nbytes=nb, t=t)
            if away:
                repair.stats.n_digests_lost += 1
                continue
            sends, rearm = repair.on_digest(c, src, entries, t)
            for dst, key, ver, t_re in sends:
                push(t_re, "resend", c, (dst, key, ver))
            if rearm:  # src holds keys c lacks: restart c's digests to src
                push(t + repair.cfg.interval, "digest_send", c, src)
        elif kind == "resend":
            dst, key, ver = payload
            offline_c = churn is not None and not churn.is_online(c, t)
            cut = False
            if faults is not None:
                offline_c = offline_c or not faults.is_online(c, t)
                cut = faults.edge_cut(c, dst, t)
            if offline_c or cut:
                # swallowed before the transport: the attempt refunds so
                # max_attempts bounds transmissions, not intentions
                repair.refund_attempt(c, dst, key, ver)
                if cut and not offline_c:
                    faults.stats.n_partition_blocked += 1
                else:
                    n_lost_offline += 1
            else:
                if tc is not None:
                    tc.slice(c, f"resend ({key[0]},{key[1]})", t, t,
                             cat="repair", args={"dst": dst, "ver": ver})
                send_model(c, dst, key, t, version=ver)
                if transport.last_outcome == "inbox":
                    # rejected at send time — nothing crossed the wire,
                    # so this was not a transmission either
                    repair.refund_attempt(c, dst, key, ver)
        elif kind == "crash":
            # client c loses its VOLATILE state: bench membership, the
            # driver's prediction store (via on_crash), and its gossip
            # beliefs. Trained-model artifacts are durable — the restart
            # handler re-admits them.
            faults.note_crash(c, t)
            if tc is not None:
                tc.slice(c, "crash", t, t, cat="fault")
            lost = len(bench[c])
            if lost:
                n_admits -= lost
                bench[c].clear()
                trace.bench_sizes[c].append((t, 0))
                if mx.enabled:
                    mx.set("coverage.fraction", n_admits / cov_total, t=t)
                if tc is not None:
                    tc.counter("coverage", t, n_admits / cov_total)
            if gossip is not None:
                gossip.note_crash(c)
            if on_crash is not None:
                on_crash(c, t)
        elif kind == "restart":
            # rejoin: fresh gossip incarnation (re-announcements outrank
            # every pre-crash version), re-admit durable local models,
            # re-disseminate
            faults.note_restart(c, t)
            if tc is not None:
                tc.slice(c, "restart", t, t, cat="fault")
            if gossip is not None:
                gossip.note_rejoin(c, t)
            for m in range(cfg.models_per_client):
                mkey = (c, m)
                if completions[c, m] <= t and mkey not in bench[c]:
                    admit(c, mkey, t)
                    if gossip is not None:
                        targets = gossip.on_local(c, mkey, t)
                    else:
                        targets = [(nb, mkey) for nb in neighbors[c]]
                    for dst, fkey in targets:
                        send_model(c, dst, fkey, t)
            if want_select and bench[c]:
                schedule_select(c, t)
        elif kind == "partition":
            pass  # the cut is enforced at every send; this marks the trace
        elif kind == "heal":
            # edges that quiesced (or round-capped their pending work)
            # while cut need their digest streams re-armed, otherwise the
            # accumulated divergence across the former cut never repairs
            if repair is not None:
                for a, b in repair.edges:
                    if faults.crosses_cut(a, b) and repair.rearm(a, b):
                        push(t + repair.cfg.interval, "digest_send", a, b)
        elif kind == "query":
            b_idx, nq = payload
            away = (churn is not None and not churn.is_online(c, t)) \
                or (faults is not None and not faults.is_online(c, t))
            if tc is not None:
                tc.slice(c, ("query lost" if away else "query")
                         + f" x{nq}", t, t, cat="serve")
            if away:
                serving.note_dropped(c, nq)
                continue
            if serving.on_query(c, t, b_idx, nq) and want_select:
                schedule_select(c, t)
        elif kind == "drift":
            # payload is the drift component index; the engine shifts its
            # affected clients' query streams and validation state
            serving.on_drift(payload, t)
        elif kind == "select":
            pending_select.discard(c)
            ready = [c]
            if on_select_batch is not None:
                # drain every same-tick select into one batched call;
                # `payload` holds the integer grid index, so coalescing
                # never depends on float equality of reconstructed times
                def same_tick(entry):
                    return entry[2] == "select" and (
                        entry[4] == payload if payload is not None
                        else entry[0] == t)
                while q and same_tick(q[0]):
                    t2, _, _, c2, _, _ = heapq.heappop(q)
                    trace.events.append((t2, "select", c2, None))
                    pending_select.discard(c2)
                    ready.append(c2)
                trace.select_batches.append((t, len(ready)))
                if mx.enabled:
                    mx.observe("engine.select_batch_width", len(ready), t=t)
                if tc is not None:
                    tc.slice(c, f"select x{len(ready)}", t, t, cat="select",
                             args={"clients": len(ready)})
                with sw_select(t=t):
                    accs = on_select_batch(
                        ready, {b: sorted(bench[b]) for b in ready}, t) or {}
                for b in ready:
                    record_selection(b, t, accs.get(b))
                if serving is not None:
                    serving.note_selected(ready, t)
            elif on_select is not None:
                if tc is not None:
                    tc.slice(c, "select x1", t, t, cat="select",
                             args={"clients": 1})
                with sw_select(t=t):
                    acc = on_select(c, sorted(bench[c]), t)
                record_selection(c, t, acc)
                if serving is not None:
                    serving.note_selected([c], t)

    if transport is not None or gossip is not None or churn is not None \
            or faults is not None:
        trace.net = {"lost_offline": n_lost_offline}
        if transport is not None:
            trace.net["transport"] = transport.stats.as_dict()
        if gossip is not None:
            trace.net["gossip"] = gossip.stats.as_dict()
        if repair is not None:
            trace.net["repair"] = repair.stats.as_dict()
        if faults is not None:
            trace.net["faults"] = faults.as_dict()
    wall = sw_wall.stop()
    select_wall = sw_select.total
    trace.perf = {
        "backend": "event", "wall_s": round(wall, 6),
        "n_events": len(trace.events),
        "events_per_s": round(len(trace.events) / max(wall, 1e-9), 1),
        # phase split: the p2p/event machinery (with the stores' per-
        # arrival materialization) vs time spent inside the selection
        # callbacks (the engine's GA + device flush)
        "phases": {"net_s": round(wall - select_wall, 6),
                   "select_s": round(select_wall, 6)},
    }
    return trace
