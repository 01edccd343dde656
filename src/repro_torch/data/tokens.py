"""Token pipeline for the LLM-scale architectures (numpy copy of
`repro/data/tokens.py`): deterministic synthetic token streams (zipfian
unigram + local bigram structure) batched on the host. It supplies the
prompts of `launch/serve.py` and `chip_smoke.py`."""
from __future__ import annotations

import numpy as np


def synthetic_token_batch(rng: np.random.Generator, vocab: int, batch: int,
                          seq: int, n_codebooks: int = 0):
    """Zipf-ish unigram with bigram copy structure (so loss can fall)."""
    shape = (batch, seq, n_codebooks) if n_codebooks else (batch, seq)
    ranks = rng.zipf(1.3, size=shape).astype(np.int64)
    toks = np.minimum(ranks, vocab - 1).astype(np.int32)
    # inject copy structure: token t depends on t-1 half the time
    flip = rng.random(shape) < 0.5
    rolled = np.roll((toks * 7 + 13) % vocab, 1, axis=1)
    toks = np.where(flip, rolled, toks).astype(np.int32)
    return toks


class TokenPipeline:
    """Iterator of {tokens, labels} host batches."""

    def __init__(self, vocab: int, batch: int, seq: int, n_codebooks: int = 0,
                 seed: int = 0):
        self.vocab, self.batch, self.seq = vocab, batch, seq
        self.n_codebooks = n_codebooks
        self.rng = np.random.default_rng(seed)

    def __iter__(self):
        return self

    def __next__(self):
        toks = synthetic_token_batch(self.rng, self.vocab, self.batch,
                                     self.seq + 1, self.n_codebooks)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
