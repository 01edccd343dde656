"""The reference forward of a configuration's equations, in float32,
block by block, from the benchmark's weights by name (`weights.py`):
`w(name)` returns the leaf as float32 (the bf16 leaf upcast exactly, or
the control's lower-precision copy of it). The blocks and their order
are the family's (`families/<equations>.py`); every family ends in
rms(x, final_norm) @ head.
"""
from __future__ import annotations

import torch

from bench import families

from . import layers as L


def blocks(a):
    """[(block function, name prefix)] in the order the equations apply
    them."""
    return families.get(a).blocks(a)


def hidden(w, a, tokens, block_fn=None):
    """The final normed hidden state (B, S, d) of tokens (B, S).
    `block_fn(fn, w, prefix, a, x)` may wrap each block (a checkpoint)."""
    x = w("embed.embed")[tokens.long()]
    for fn, p in blocks(a):
        x = fn(w, p, a, x) if block_fn is None else block_fn(fn, w, p, a, x)
    return L.rms_norm(x, w("final_norm"), a["norm_eps"])


def last_logits(w, a, tokens):
    """Logits (B, V) at each row's last position."""
    with torch.no_grad():
        return hidden(w, a, tokens)[:, -1] @ w("embed.head")
