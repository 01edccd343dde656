"""The benchmark's plain reference: the configurations' equations in
float32 PyTorch with TF32 off (`layers.py`, `models.py`), its AdamW
(`train.py`), and the lower-precision control that the limits of
`correct` are set against (`fp8_weights`). It imports nothing of the
port: it reads the benchmark's weights and inputs, and works out again
whatever the port derived from them."""
from __future__ import annotations

import torch

from . import layers, models


def exact_weights(flat: dict):
    """w(name): the leaf upcast to float32 (exact from bf16)."""
    return lambda name: flat[name].float()


def fp8_round(t):
    """A weight matrix, or a stack of them (an expert layer's), through
    float8 e4m3 with one scale per output column of each matrix (its amax
    over dim -2), back in float32: the step below bf16 that the control
    takes."""
    s = t.float().abs().amax(dim=-2, keepdim=True).clamp_min(1e-12) / 448.0
    return (t.float() / s).to(torch.float8_e4m3fn).float() * s


def fp8_weights(flat: dict):
    """w(name): every bf16 leaf of 2 dims or more (projections, expert
    stacks, embedding, head) through `fp8_round`; the fp32 leaves as they
    are."""
    def w(name):
        t = flat[name]
        if t.dtype == torch.bfloat16 and t.dim() >= 2:
            return fp8_round(t)
        return t.float()
    return w


def vote_logprobs(arch: dict, members: list, tokens, weights=None,
                  weight_fn=exact_weights):
    """log of the ensemble's soft vote at each row's last position: the
    weighted mean of the members' softmax (weights uniform when None), as
    float32 (B, V). `members` are {name: tensor} dicts."""
    n = len(members)
    wts = [1.0 / n] * n if weights is None else \
        [float(x) / sum(weights) for x in weights]
    vote = 0.0
    with layers.fp32_exact(), torch.no_grad():
        for wt, flat in zip(wts, members):
            logits = models.last_logits(weight_fn(flat), arch, tokens)
            vote = vote + wt * torch.softmax(logits, dim=-1)
    return torch.log(vote)
