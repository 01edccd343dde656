"""The one traffic generator: it reads a mix's parameters
(`traffic/<mix>.json`) and the run's seed, and gives the host arrays the
program is handed. Nothing here depends on the program.

Score mixes (`kind` "score"): calls of `prompts_per_call` prompts that
share one length, one call outstanding (a closed loop). The lengths are
a fixed cycle: `calls` calls of one `length` (`dist` "fixed"), or the
`quantiles` mid-quantiles of a log-normal (`median`, `sigma`), clipped
to [`min`, `max`] and rounded up to a multiple of `multiple`. The cycle
is dealt into `blocks` blocks of nearly equal work, and a run stops at
a block's end. The seed orders the blocks and the calls inside each, and
draws the token ids, so the set of lengths, and with it the tail, is
the same on every seed.

Train mixes (`kind` "train"): one batch of `batch` rows of `seq` + 1
tokens a step, tokens and labels shifted by one.

Token ids are the zipf-with-bigram-copies draw of the port's
`TokenPipeline` (`synthetic_token_batch`, frozen here).
"""
from __future__ import annotations

import math
from statistics import NormalDist

import numpy as np

SEED_MOD = 2 ** 63


def rng(seed: int, *tags: int) -> np.random.Generator:
    """A generator for one purpose of one run: (seed, tags) -> stream."""
    return np.random.default_rng([int(seed) % SEED_MOD, *tags])


def synthetic_token_batch(g: np.random.Generator, vocab: int, batch: int,
                          seq: int, zipf_a: float = 1.3) -> np.ndarray:
    """Zipf unigrams; half the positions copy (prev * 7 + 13) % vocab."""
    shape = (batch, seq)
    toks = np.minimum(g.zipf(zipf_a, size=shape), vocab - 1).astype(np.int32)
    flip = g.random(shape) < 0.5
    rolled = np.roll((toks * 7 + 13) % vocab, 1, axis=1)
    return np.where(flip, rolled, toks).astype(np.int32)


def length_cycle(mix: dict, smoke: bool = False) -> list:
    """The cycle's lengths, sorted. `smoke` divides them by 128 (at least
    `smoke_min`), for the CPU tests."""
    p = mix["lengths"]
    if p["dist"] == "fixed":
        L = p["length"]
        return [max(p["smoke_min"], L // 128) if smoke else L] * p["calls"]
    out = []
    for i in range(p["quantiles"]):
        z = NormalDist().inv_cdf((i + 0.5) / p["quantiles"])
        x = min(max(p["median"] * math.exp(p["sigma"] * z), p["min"]),
                p["max"])
        L = int(math.ceil(x / p["multiple"]) * p["multiple"])
        out.append(max(p["smoke_min"], L // 128) if smoke else L)
    return sorted(out)


def blocks(mix: dict, smoke: bool = False) -> list:
    """The cycle dealt into `blocks` blocks in snake order (sorted
    lengths 0..nb-1 to blocks 0..nb-1, the next nb to blocks nb-1..0, and
    so on), so the blocks carry nearly the same work."""
    cyc = length_cycle(mix, smoke)
    nb = mix["blocks"]
    out = [[] for _ in range(nb)]
    for i, L in enumerate(cyc):
        row, col = divmod(i, nb)
        out[col if row % 2 == 0 else nb - 1 - col].append(L)
    return out


def score_calls(mix: dict, seed: int, smoke: bool = False):
    """Endless (call index, length, last call of a block) triples."""
    bl = blocks(mix, smoke)
    i, cycle = 0, 0
    while True:
        g = rng(seed, 1, cycle)
        for b in g.permutation(len(bl)):
            lens = [bl[b][j] for j in g.permutation(len(bl[b]))]
            for n, L in enumerate(lens):
                yield i, L, n == len(lens) - 1
                i += 1
        cycle += 1


def prompts(mix: dict, seed: int, call: int, length: int,
            vocab: int) -> np.ndarray:
    """The (prompts_per_call, length) int32 token ids of one call."""
    return synthetic_token_batch(rng(seed, 2, call), vocab,
                                 mix["prompts_per_call"], length,
                                 mix["tokens"]["zipf_a"])


def warm_prompts(mix: dict, length: int, vocab: int) -> np.ndarray:
    """Token ids for warming one length up (the same on every seed)."""
    return synthetic_token_batch(rng(0, 3, length), vocab,
                                 mix["prompts_per_call"], length,
                                 mix["tokens"]["zipf_a"])


def train_batch(mix: dict, seed: int, step: int, vocab: int,
                smoke: bool = False):
    """(tokens, labels) int32 (batch, seq) of one step; every step's rows
    differ."""
    seq = mix["smoke_seq"] if smoke else mix["seq"]
    t = synthetic_token_batch(rng(seed, 4, step), vocab, mix["batch"],
                              seq + 1, mix["tokens"]["zipf_a"])
    return t[:, :-1], t[:, 1:]
