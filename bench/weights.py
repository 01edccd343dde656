"""The benchmark's model weights: every leaf of a member, named as the
port's parameter tree names it (`embed.head`, `final_norm`), drawn on
the device from the run's seed, in the layout of the configuration's
family (`families/<equations>.py`).

A member is two flat buffers, one of the served type (bf16: the
projections, the embedding and the head) and one fp32 (norm scales,
mixes, decays, the conv filters), each filled by one `normal_` call from
a `torch.Generator` on the device; each leaf is a view of its buffer,
scaled or shifted in place. The reference (`reference/`) reads the same
tensors by the same names; the port gets them wrapped in its `Params`
modules (`port_params`), which share their storage.

Each family writes its layout from its own reference equations, not from
the port: `test_bench_reference.py` holds every score cell's layout to
the port's `init_params` (names, shapes, dtypes) at the smoke widths.
"""
from __future__ import annotations

import math

import torch

from bench import families

# (name, shape, kind): kind "w" a projection (normal * fan_in**-0.5, the
# second-to-last dim the fan-in, so that a stack of matrices draws as its
# matrices), "e" the embedding (normal * d**-0.5); in fp32: "c" a conv
# filter (normal * 0.1 * K**-0.5), "lora_a" / "lora_b" a LoRA pair (fan-in
# scaled, the second * 0.1), "mix" a token-shift mix (uniform in [0, 1)),
# or a normal of (mean, std), from NORMALS or the family's own:
NORMALS = {
    "norm": (0.0, 0.1),      # rms scale, applied as (1 + scale)
    "bias": (0.0, 0.1),      # conv bias
}


def layout(arch: dict):
    """[(name, shape, kind)] of one member of the configuration file's
    `as_run` block, from its family (`families/<equations>.py`)."""
    return families.get(arch).layout(arch)


def _is_low(kind: str) -> bool:
    return kind in ("w", "e")


def _fill(view, kind, shape, kinds):
    """Turn a view of standard normals into the leaf's draw, in place
    (`kinds`: the normals by kind)."""
    if kind == "w":
        view.mul_(shape[-2] ** -0.5)
    elif kind == "e":
        view.mul_(shape[1] ** -0.5)
    elif kind == "c":
        view.mul_(0.1 * shape[0] ** -0.5)
    elif kind == "lora_a":
        view.mul_(shape[0] ** -0.5)
    elif kind == "lora_b":
        view.mul_(0.1 * shape[0] ** -0.5)
    elif kind == "mix":
        # a normal's cdf is uniform on [0, 1)
        view.copy_(0.5 * (1.0 + torch.erf(view * 2.0 ** -0.5)))
    else:
        mean, std = kinds[kind]
        view.mul_(std).add_(mean)


def member_seed(seed: int, member: int) -> int:
    """A member's generator seed: distinct per (run seed, member)."""
    return (int(seed) * 1_000_003 + 7_919 * (member + 1)) % (2 ** 63)


def make_member(arch: dict, seed: int, member: int, device,
                low_dtype=torch.bfloat16) -> dict:
    """{name: tensor} of one member, drawn on `device` from the run's
    seed: two `normal_` calls on one generator, then each leaf's scaling
    in place. The same (arch, seed, member, device) gives the same
    tensors."""
    fam = families.get(arch)
    lay = fam.layout(arch)
    kinds = {**NORMALS, **getattr(fam, "NORMALS", {})}
    gen = torch.Generator(device=device).manual_seed(member_seed(seed, member))
    n_low = sum(math.prod(s) for _, s, k in lay if _is_low(k))
    n_f32 = sum(math.prod(s) for _, s, k in lay if not _is_low(k))
    # normal_ draws in the buffer's own type: the bf16 leaves are bf16
    # normals, scaled once in bf16
    low = torch.empty(n_low, dtype=low_dtype, device=device).normal_(
        generator=gen)
    f32 = torch.empty(n_f32, dtype=torch.float32, device=device).normal_(
        generator=gen)
    out, at_low, at_f32 = {}, 0, 0
    for name, shape, kind in lay:
        n = math.prod(shape)
        if _is_low(kind):
            view, at_low = low[at_low:at_low + n].view(shape), at_low + n
        else:
            view, at_f32 = f32[at_f32:at_f32 + n].view(shape), at_f32 + n
        _fill(view, kind, shape, kinds)
        out[name] = view
    return out


def count(arch: dict, embedding: bool = False, head: bool = False) -> int:
    """Parameters of one member: without the embedding and the head,
    unless asked for."""
    n = 0
    for name, shape, _ in layout(arch):
        if name == "embed.embed" and not embedding:
            continue
        if name == "embed.head" and not head:
            continue
        n += math.prod(shape)
    return n


def count_applied(arch: dict) -> int:
    """Non-embedding, non-head parameters a token passes through in one
    member's forward, as its family counts them (a shared block once per
    application)."""
    return families.get(arch).applied(arch)


def port_params(flat: dict):
    """The port's parameter module over the member's tensors (no copy):
    a `Params` tree whose integer-named levels are `nn.ModuleList`s, as
    the port's `init_params` builds it."""
    from torch import nn

    from repro_torch.models.common import Params

    tree: dict = {}
    for name, t in flat.items():
        node = tree
        parts = name.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = t

    def build(node):
        if all(k.isdigit() for k in node):
            return nn.ModuleList([build(node[str(i)])
                                  for i in range(len(node))])
        return Params({k: build(v) if isinstance(v, dict) else v
                       for k, v in node.items()})
    return build(tree)
