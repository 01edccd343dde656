"""Synthetic image-classification data (the offline stand-in for
CIFAR-10/100 — DESIGN.md §2).

Class-conditional generative model rich enough that architectural
diversity matters: each class is a mixture of 2 prototype templates
(low-frequency patterns) + per-sample smooth deformation + pixel noise,
so classes overlap and accuracy saturates well below 100%.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SyntheticImageDataset:
    x: np.ndarray  # (N, H, W, C) float32
    y: np.ndarray  # (N,) int32
    n_classes: int

    def __len__(self):
        return len(self.y)


def make_synthetic_images(n_samples: int, n_classes: int, size: int = 12,
                          channels: int = 3, noise: float = 0.55,
                          seed: int = 0) -> SyntheticImageDataset:
    rng = np.random.default_rng(seed)
    H = W = size
    # 2 prototypes per class, built from smooth random fields
    protos = []
    for _ in range(n_classes * 2):
        field = rng.normal(size=(H // 2 + 1, W // 2 + 1, channels))
        up = np.kron(field, np.ones((2, 2, 1)))[:H, :W, :]
        protos.append(up)
    protos = np.stack(protos).astype(np.float32)  # (2K, H, W, C)
    protos /= np.abs(protos).max(axis=(1, 2, 3), keepdims=True) + 1e-9

    y = rng.integers(0, n_classes, size=n_samples).astype(np.int32)
    mode = rng.integers(0, 2, size=n_samples)
    base = protos[y * 2 + mode]
    # smooth per-sample deformation: random global shift + scale
    shift = rng.normal(scale=0.3, size=(n_samples, 1, 1, channels)).astype(np.float32)
    scale = (1.0 + rng.normal(scale=0.2, size=(n_samples, 1, 1, 1))).astype(np.float32)
    x = base * scale + shift
    x = x + rng.normal(scale=noise, size=x.shape).astype(np.float32)
    return SyntheticImageDataset(x=x.astype(np.float32), y=y, n_classes=n_classes)
