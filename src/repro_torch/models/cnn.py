"""Paper-scale image classifiers (port of `repro/models/cnn.py`).

Five distinct families, mirroring the paper's CNN-4 / ResNet-18 /
DenseNet-121 / GoogleNet / VGG-11 heterogeneity at synthetic-data scale:
  cnn4      — 2x conv + 2x fc (McMahan et al. FedAvg CNN)
  resnet    — residual blocks with projection shortcuts
  vgg       — deep 3x3 conv stacks + maxpool
  densenet  — dense concatenation blocks
  inception — parallel 1x1 / 3x3 / 5x5 branches

Each model is a `CNN` module whose parameters carry the reference's
names. Inputs stay NHWC at the public boundary, as in the reference, and
are viewed as NCHW inside. Conv weights are OIHW; dense weights keep the
reference's (din, dout) layout and apply as `x @ w`.
`params_from_jax` loads a reference parameter dict (numpy arrays).

Two details of the reference are reproduced exactly: SAME padding is
asymmetric for a stride-2 3x3 convolution on an even input (0 low, 1
high), and the channel `norm` uses the biased variance.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    family: str = "cnn4"
    n_classes: int = 10
    width: int = 16
    in_channels: int = 3


# Every family produces features of dim FEAT_MULT * width and ends with a
# linear "head" (FEAT, n_classes).
FEAT_MULT = 2


def conv(x, w, stride: int = 1):
    """NCHW x, OIHW w, JAX "SAME" padding (the extra row/column of an odd
    total pad goes on the high side)."""
    pads = []
    for size, k in zip(x.shape[-2:], w.shape[-2:]):
        out = -(-size // stride)
        total = max((out - 1) * stride + k - size, 0)
        pads.append((total // 2, total - total // 2))
    (hlo, hhi), (wlo, whi) = pads
    if hlo == hhi and wlo == whi:
        return F.conv2d(x, w, stride=stride, padding=(hlo, wlo))
    return F.conv2d(F.pad(x, (wlo, whi, hlo, hhi)), w, stride=stride)


def pool(x, k: int = 2):
    return F.max_pool2d(x, k)


def gap(x):
    return x.mean(dim=(2, 3))


def norm(x):  # parameter-free channel norm
    m = x.mean(dim=1, keepdim=True)
    v = x.var(dim=1, keepdim=True, correction=0)
    return (x - m) * torch.rsqrt(v + 1e-5)


def _shapes(family: str, cfg: CNNConfig) -> Dict[str, tuple]:
    """Parameter shapes in the reference's layout (HWIO conv, (din, dout)
    dense), in the reference's order."""
    w, cin, feat = cfg.width, cfg.in_channels, FEAT_MULT * cfg.width
    head = (feat, cfg.n_classes)
    if family == "cnn4":
        return {"c1": (3, 3, cin, w), "c2": (3, 3, w, 2 * w),
                "f1": (2 * w, feat), "head": head}
    if family == "vgg":
        chans = [cin, w, w, 2 * w, feat]
        shapes = {f"c{i}": (3, 3, chans[i], chans[i + 1])
                  for i in range(len(chans) - 1)}
        return {**shapes, "head": head}
    if family == "resnet":
        return {"stem": (3, 3, cin, w), "b1a": (3, 3, w, w),
                "b1b": (3, 3, w, w), "b2a": (3, 3, w, 2 * w),
                "b2b": (3, 3, 2 * w, 2 * w), "proj2": (1, 1, w, 2 * w),
                "head": head}
    if family == "densenet":
        g = w // 2  # growth rate
        return {"stem": (3, 3, cin, w), "d1": (3, 3, w, g),
                "d2": (3, 3, w + g, g), "d3": (3, 3, w + 2 * g, g),
                "mix": (1, 1, w + 3 * g, feat), "head": head}
    if family == "inception":
        h = w // 2
        return {"stem": (3, 3, cin, w), "b1": (1, 1, w, h),
                "b3": (3, 3, w, h), "b5": (5, 5, w, h),
                "mix": (1, 1, 3 * h, feat), "head": head}
    raise ValueError(f"unknown CNN family {family!r}; choose from "
                     f"{tuple(FAMILIES)}")


def feat_cnn4(p, x):
    x = pool(F.relu(conv(x, p["c1"])))
    x = pool(F.relu(conv(x, p["c2"])))
    return F.relu(gap(x) @ p["f1"])


def feat_vgg(p, x):
    x = F.relu(conv(x, p["c0"]))
    x = pool(F.relu(conv(x, p["c1"])))
    x = F.relu(conv(x, p["c2"]))
    x = pool(F.relu(conv(x, p["c3"])))
    return gap(x)


def feat_resnet(p, x):
    x = F.relu(conv(x, p["stem"]))
    h = F.relu(conv(x, p["b1a"]))
    x = F.relu(x + conv(h, p["b1b"]))
    h = F.relu(conv(x, p["b2a"], stride=2))
    x = F.relu(conv(x, p["proj2"], stride=2) + conv(h, p["b2b"]))
    return gap(norm(x))


def feat_densenet(p, x):
    x = F.relu(conv(x, p["stem"]))
    for name in ("d1", "d2", "d3"):
        h = F.relu(conv(norm(x), p[name]))
        x = torch.cat([x, h], dim=1)
    return gap(F.relu(conv(x, p["mix"])))


def feat_inception(p, x):
    x = pool(F.relu(conv(x, p["stem"])))
    b = torch.cat([F.relu(conv(x, p[k])) for k in ("b1", "b3", "b5")],
                  dim=1)
    return gap(F.relu(conv(norm(b), p["mix"])))


FAMILIES: Dict[str, Callable] = {
    "cnn4": feat_cnn4,
    "vgg": feat_vgg,
    "resnet": feat_resnet,
    "densenet": feat_densenet,
    "inception": feat_inception,
}


def _to_torch_layout(a):
    """HWIO conv weights -> OIHW; dense (din, dout) weights unchanged."""
    a = torch.tensor(np.asarray(a, np.float32))
    return a.permute(3, 2, 0, 1).contiguous() if a.dim() == 4 else a


class CNN(nn.Module):
    """One image classifier of `family`; forward: NHWC images -> logits."""

    def __init__(self, family: str, cfg: CNNConfig,
                 params: Dict[str, torch.Tensor]):
        super().__init__()
        expect = _shapes(family, cfg)
        if list(params) != list(expect):
            raise ValueError(f"{family} parameters {sorted(params)} do not "
                             f"match {sorted(expect)}")
        self.family = family
        self.cfg = cfg
        self._names = tuple(params)
        for name, t in params.items():
            self.register_parameter(name, nn.Parameter(t))

    def features(self, x):
        """(B, FEAT_MULT*width) penultimate features of NHWC images."""
        p = {name: getattr(self, name) for name in self._names}
        return FAMILIES[self.family](p, x.permute(0, 3, 1, 2))

    def forward(self, x):
        return self.features(x) @ self.head


def init_model(family: str, seed: int, cfg: CNNConfig) -> CNN:
    """Normal(0, fan_in^-1/2) weights from a CPU generator seeded with
    `seed` (so a model is the same whatever device it is moved to)."""
    gen = torch.Generator().manual_seed(int(seed))
    params = {}
    for name, shape in _shapes(family, cfg).items():
        fan_in = int(np.prod(shape[:-1]))
        w = torch.randn(shape, generator=gen) * fan_in ** -0.5
        params[name] = _to_torch_layout(w.numpy())
    return CNN(family, cfg, params)


def params_from_jax(family: str, params_np: dict) -> CNN:
    """The reference's parameter dict (numpy arrays, HWIO conv weights)
    -> a port module on the CPU with the same weights. Width, classes and
    input channels are read off the shapes."""
    feat, n_classes = np.shape(params_np["head"])
    first = next(iter(_shapes(family, CNNConfig())))     # first conv
    cfg = CNNConfig(n_classes=int(n_classes),
                    width=int(feat) // FEAT_MULT,
                    in_channels=int(np.shape(params_np[first])[2]))
    return CNN(family, cfg, {name: _to_torch_layout(params_np[name])
                             for name in _shapes(family, cfg)})


def n_params(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
