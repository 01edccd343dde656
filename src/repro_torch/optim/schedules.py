"""Learning-rate schedules as plain callables of the step count (port of
`repro/optim/schedules.py`). The step is a Python int: the optimizer
state's count before the update, so the first step of a warmup has lr 0.
Values are computed in float32 arithmetic, as the reference's are."""
from __future__ import annotations

import numpy as np


def constant(lr: float):
    return lambda step: float(np.float32(lr))


def cosine(lr: float, total_steps: int, final_frac: float = 0.1):
    def f(step):
        frac = np.clip(np.float32(step) / np.float32(total_steps),
                       np.float32(0.0), np.float32(1.0))
        cos = np.float32(0.5) * (np.float32(1.0)
                                 + np.cos(np.float32(np.pi) * frac))
        return float(np.float32(lr) * (np.float32(final_frac)
                                       + np.float32(1 - final_frac) * cos))
    return f


def warmup_cosine(lr: float, warmup: int, total_steps: int,
                  final_frac: float = 0.1):
    base = cosine(lr, max(1, total_steps - warmup), final_frac)

    def f(step):
        w = np.clip(np.float32(step) / np.float32(max(1, warmup)),
                    np.float32(0.0), np.float32(1.0))
        return float(w * np.float32(base(max(step - warmup, 0))))
    return f
