"""The benchmark's model weights: every leaf of a member, named as the
port's parameter tree names it (`layers.3.rwkv.wr`), drawn on the device
from the run's seed.

A member is two flat buffers, one of the served type (bf16: the
projections, the embedding and the head) and one fp32 (norm scales,
mixes, decays, the conv filters), each filled by one `normal_` call from
a `torch.Generator` on the device; each leaf is a view of its buffer,
scaled or shifted in place. The reference (`reference/`) reads the same
tensors by the same names; the port gets them wrapped in its `Params`
modules (`port_params`), which share their storage.

The layouts are written from the layer equations of `reference/`, not
read from the port: `test_bench_reference.py` holds them to the port's
`init_params` (names, shapes, dtypes) at the smoke widths.
"""
from __future__ import annotations

import math

import torch

# (name, shape, kind): kind "w" a projection (normal * fan_in**-0.5, the
# first dim the fan-in), "e" the embedding (normal * d**-0.5); in fp32:
# "c" a conv filter (normal * 0.1 * K**-0.5), "lora_a" / "lora_b" the
# RWKV decay LoRA (fan-in scaled, the second * 0.1), "mix" a token-shift
# mix (uniform in [0, 1)), or a normal of (mean, std):
NORMALS = {
    "norm": (0.0, 0.1),      # rms scale, applied as (1 + scale)
    "w0": (-1.0, 0.25),      # RWKV decay base: logw = -exp(w0 + ...)
    "u": (0.0, 0.5),         # RWKV bonus
    "a_log": (0.0, 0.25),    # Mamba2 A = -exp(A_log)
    "skip": (1.0, 0.1),      # Mamba2 D
    "dt_bias": (-0.5, 0.25),
    "bias": (0.0, 0.1),      # conv bias
}


def rwkv6_layout(a: dict):
    d, ff, V = a["d_model"], a["d_ff"], a["vocab"]
    lora = a["rwkv_lora"]
    out = [("embed.embed", (V, d), "e"), ("embed.head", (d, V), "w"),
           ("final_norm", (d,), "norm")]
    for i in range(a["n_layers"]):
        p = f"layers.{i}.rwkv."
        out += [(p + n, (d,), "mix") for n in
                ("mix_r", "mix_k", "mix_v", "mix_w", "mix_g")]
        out += [(p + n, (d, d), "w") for n in ("wr", "wk", "wv", "wg", "wo")]
        out += [(p + "w0", (d,), "w0"), (p + "w_a", (d, lora), "lora_a"),
                (p + "w_b", (lora, d), "lora_b"), (p + "u", (d,), "u"),
                (p + "ln", (d,), "norm"), (p + "n1", (d,), "norm"),
                (p + "n2", (d,), "norm"), (p + "cm_mix", (d,), "mix"),
                (p + "cm_k", (d, ff), "w"), (p + "cm_v", (ff, d), "w")]
    return out


def _mamba2_block(p: str, a: dict):
    d = a["d_model"]
    di = a["ssm_expand"] * d
    nh, ds, K = di // a["ssm_head_dim"], a["ssm_state"], a["ssm_conv"]
    return [(p + "ln", (d,), "norm"),
            (p + "ssm.in_z", (d, di), "w"), (p + "ssm.in_x", (d, di), "w"),
            (p + "ssm.in_bc", (d, 2 * ds), "w"),
            (p + "ssm.in_dt", (d, nh), "w"),
            (p + "ssm.conv_x", (K, di), "c"),
            (p + "ssm.conv_bc", (K, 2 * ds), "c"),
            (p + "ssm.conv_xb", (di,), "bias"),
            (p + "ssm.conv_bcb", (2 * ds,), "bias"),
            (p + "ssm.A_log", (nh,), "a_log"), (p + "ssm.D", (nh,), "skip"),
            (p + "ssm.dt_bias", (nh,), "dt_bias"),
            (p + "ssm.norm", (di,), "norm"),
            (p + "ssm.out_proj", (di, d), "w")]


def zamba2_layout(a: dict):
    d, ff, V = a["d_model"], a["d_ff"], a["vocab"]
    H, KV, hd = a["n_heads"], a["n_kv_heads"], a["head_dim"]
    every = a["shared_attn_every"]
    n_super = a["n_layers"] // every
    out = [("embed.embed", (V, d), "e"), ("embed.head", (d, V), "w"),
           ("final_norm", (d,), "norm")]
    for i in range(n_super):
        for j in range(every):
            out += _mamba2_block(f"m_main.{i}.{j}.", a)
    for i in range(a["n_layers"] - n_super * every):
        out += _mamba2_block(f"m_tail.{i}.", a)
    for i in range(a["n_shared_attn"]):
        p = f"shared_attn.{i}."
        out += [(p + "ln1", (d,), "norm"), (p + "ln2", (d,), "norm"),
                (p + "attn.wq", (d, H * hd), "w"),
                (p + "attn.wk", (d, KV * hd), "w"),
                (p + "attn.wv", (d, KV * hd), "w"),
                (p + "attn.wo", (H * hd, d), "w"),
                (p + "ffn.w_gate", (d, ff), "w"),
                (p + "ffn.w_up", (d, ff), "w"),
                (p + "ffn.w_down", (ff, d), "w")]
    return out


LAYOUTS = {"rwkv6": rwkv6_layout, "zamba2": zamba2_layout}


def layout(arch: dict):
    """[(name, shape, kind)] of one member of the configuration file's
    `as_run` block."""
    return LAYOUTS[arch["equations"]](arch)


def _is_low(kind: str) -> bool:
    return kind in ("w", "e")


def _fill(view, kind, shape):
    """Turn a view of standard normals into the leaf's draw, in place."""
    if kind == "w":
        view.mul_(shape[0] ** -0.5)
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
        mean, std = NORMALS[kind]
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
    lay = layout(arch)
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
        _fill(view, kind, shape)
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
    member's forward: `count`, with each shared block counted once per
    application (zamba2 applies its `n_shared_attn` blocks in turn after
    every `shared_attn_every` Mamba2 layers)."""
    n = count(arch)
    if arch["equations"] != "zamba2":
        return n
    uses = arch["n_layers"] // arch["shared_attn_every"]
    shared = sum(math.prod(s) for name, s, _ in layout(arch)
                 if name.startswith("shared_attn."))
    return n - shared + shared * uses // arch["n_shared_attn"]


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
