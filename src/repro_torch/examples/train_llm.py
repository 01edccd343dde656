"""End-to-end driver: train a ~100M-parameter model of the zoo for a few
hundred steps on synthetic token data, checkpoint it, reload it, and
verify the loss curve (port of `examples/train_llm.py`; use --preset 25m
--steps 60 for a quick run).

    PYTHONPATH=src python -m repro_torch.examples.train_llm --device cpu \
        --preset 25m --steps 60

The checkpoint is written under `results/torch/ckpts/` in the
reference's npz format.
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from repro_torch.checkpoint import load_pytree
from repro_torch.launch.train import train

CKPT_DIR = os.path.join("results", "torch", "ckpts")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--preset", default="100m")
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu'")
    a = ap.parse_args(argv)
    _, losses, _, _ = train(a.arch, a.preset, steps=a.steps, batch=4,
                            seq=256, ckpt_dir=CKPT_DIR, device=a.device)
    first = float(np.mean(losses[:10]))
    last = float(np.mean(losses[-10:]))
    print(f"loss: first10={first:.3f} last10={last:.3f}")
    assert last < first, "training did not reduce loss"
    _, meta = load_pytree(os.path.join(
        CKPT_DIR, f"{a.arch}_{a.preset}_final.npz"))
    assert meta["steps"] == a.steps
    print("checkpoint round-trip OK:", meta)


if __name__ == "__main__":
    main()
