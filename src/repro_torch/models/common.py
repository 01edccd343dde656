"""Shared model config and primitive ops of the LLM model zoo (port of
`repro/models/common.py`).

Parameters are `Params` modules: the reference's nested dict of arrays
becomes nested modules with the same names (`layers.0.attn.wq`), each
weight in the reference's (din, dout) layout and applied as `x @ w`.
`p["wq"]` and `"bq" in p` read as they do on the reference's dicts, so
the layer functions keep the reference's shape: `init_*(cfg, gen) ->
Params` and `*_apply(p, cfg, x, ...)`. Every random draw comes from an
explicit `torch.Generator`, on the device the parameters are made on.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One config describes any architecture of the reference's pool
    (same fields and defaults as `repro.models.common.ModelConfig`)."""

    name: str = "model"
    family: str = "dense"  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    d_ff: int = 512
    vocab: int = 1024
    head_dim: int = 0  # 0 -> d_model // n_heads
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    act: str = "silu"
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    final_logit_softcap: float = 0.0
    attn_logit_softcap: float = 0.0
    # gemma2-style local/global alternation (training + prefill)
    attn_pattern: str = "global"  # "global" | "local_global"
    local_window: int = 0
    post_block_norms: bool = False
    # sliding-window KV cache for long-context decode (0 = full cache)
    decode_window: int = 0
    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_dense_residual: bool = False
    capacity_factor: float = 1.25
    # SSM (Mamba2-style)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    # hybrid (zamba2): shared attention block applied every k SSM layers
    shared_attn_every: int = 0
    n_shared_attn: int = 2
    # RWKV6
    rwkv_head_dim: int = 64
    # VLM (llama3.2-vision): every k-th layer is cross-attention to image emb
    cross_attn_every: int = 0
    n_img_tokens: int = 0
    d_vision: int = 0
    # audio (musicgen): parallel codebooks with delay pattern
    n_codebooks: int = 0
    # numerics / runtime
    dtype: str = "bfloat16"
    attn_chunk: int = 1024  # query-chunked attention above this seq len
    # GQA head layout: "kv_major" groups q-heads consecutively per kv head
    # (h = kv*G + g); "g_major" interleaves (h = g*KV + kv).
    gqa_layout: str = "kv_major"
    # "xla" = chunked plain attention; "pallas" = the flash-attention
    # kernel (kernels/flash_attention: CUDA C++ on CUDA tensors, its plain
    # version on CPU tensors). The names are the reference's, so a config
    # means the same thing in both packages.
    attn_impl: str = "xla"
    scan_layers: bool = True  # the reference's lax.scan switch; the port loops
    source: str = ""  # citation for the config

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def is_subquadratic(self) -> bool:
        """True when decode state is O(1) or windowed."""
        return self.family in ("ssm", "hybrid")

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


class Params(nn.Module):
    """A parameter dict as a module. Tensors become parameters, nested
    dicts become child `Params`, modules are added as they are."""

    def __init__(self, tree: dict):
        super().__init__()
        for name, value in tree.items():
            if isinstance(value, dict):
                value = Params(value)
            if isinstance(value, nn.Module):
                self.add_module(name, value)
            else:
                self.register_parameter(name, nn.Parameter(value))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules


class Leaves:
    """A module's tensors by its names, as `Params` reads them (`p["wq"]`,
    `"bq" in p`, `named_parameters`), holding any tensors: the sharded
    step's view of a block whose pieces were gathered, each tensor still
    in its autograd graph (a `Params` would make each a new leaf)."""

    def __init__(self, module, leaves: dict, prefix: str = ""):
        self._t = {n: leaves[prefix + n]
                   for n, _ in module.named_parameters(recurse=False)}
        self._c = {n: Leaves(c, leaves, f"{prefix}{n}.")
                   for n, c in module.named_children()}

    def __getitem__(self, name: str):
        return self._t[name] if name in self._t else self._c[name]

    def __contains__(self, name: str) -> bool:
        return name in self._t or name in self._c

    def named_parameters(self, prefix: str = "", recurse: bool = True):
        for n, t in self._t.items():
            yield prefix + n, t
        if recurse:
            for n, c in self._c.items():
                yield from c.named_parameters(f"{prefix}{n}.")


def with_leaves(module: nn.Module, leaves: dict, prefix: str = ""):
    """A module of `module`'s structure (`Params` and `nn.ModuleList`s)
    whose parameters are `leaves[name]` by dotted name (no copy: each
    parameter shares its tensor's storage)."""
    if isinstance(module, nn.ModuleList):
        return nn.ModuleList([with_leaves(c, leaves, f"{prefix}{i}.")
                              for i, c in enumerate(module)])
    tree = {n: leaves[prefix + n]
            for n, _ in module.named_parameters(recurse=False)}
    tree.update({n: with_leaves(c, leaves, f"{prefix}{n}.")
                 for n, c in module.named_children()})
    return Params(tree)


# ---------------------------------------------------------------------------
# primitive ops
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, shape, in_axis=0, dtype=torch.bfloat16):
    """Fan-in scaled truncated-normal init: a standard normal cut at +-2,
    drawn in fp32 on the generator's device, scaled by fan_in**-0.5, then
    cast."""
    fan_in = shape[in_axis] if isinstance(in_axis, int) else 1
    if not isinstance(in_axis, int):
        for a in in_axis:
            fan_in *= shape[a]
    w = torch.empty(shape, dtype=torch.float32, device=gen.device)
    nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (w * fan_in ** -0.5).to(dtype)


def rms_norm(x, scale, eps=1e-6):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + scale.float())).to(dt)


def init_rms(d, device=None):
    return torch.zeros((d,), dtype=torch.float32, device=device)


def _gelu_tanh(x):
    return F.gelu(x, approximate="tanh")   # jax.nn.gelu's default


def activation(name: str):
    return {"silu": F.silu, "gelu": _gelu_tanh, "relu": F.relu}[name]


def softcap(x, cap: float):
    if not cap:
        return x
    return torch.tanh(x / cap) * cap


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(hd: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, hd); positions: (..., S) int32. Halves are rotated
    (not interleaved pairs), in fp32."""
    hd = x.shape[-1]
    inv = rope_freqs(hd, theta, x.device)  # (hd/2,)
    ang = positions[..., None].float() * inv  # (..., S, hd/2)
    cos = torch.cos(ang)[..., None, :]        # (..., S, 1, hd/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------

def init_mlp(cfg: ModelConfig, gen: torch.Generator, d_ff: int = 0) -> Params:
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    return Params({
        "w_gate": dense_init(gen, (d, ff), 0, cfg.cdtype),
        "w_up": dense_init(gen, (d, ff), 0, cfg.cdtype),
        "w_down": dense_init(gen, (ff, d), 0, cfg.cdtype),
    })


def mlp_apply(p, cfg: ModelConfig, x, lay=None):
    """x (B, S, d) -> (B, S, d). Under a layout (`sharding/layout.py`)
    with w_gate / w_up split over `model` by columns and w_down by rows:
    column-parallel in, row-parallel out, one all-reduce over `model`
    (a reduce-scatter into the sequence-split training residual)."""
    act = activation(cfg.act)
    wg, wu, wd = p["w_gate"], p["w_up"], p["w_down"]
    if lay is None:
        h = act(x @ wg) * (x @ wu)
        return h @ wd
    region = lay.region(wg.shape[1] < cfg.d_ff)
    if not region.split:
        wg, wu, wd = map(region.rep, (wg, wu, wd))
    x = region.into(x)
    h = act(x @ wg) * (x @ wu)
    return region.out(h @ wd)


def cross_entropy(logits, labels, softcap_val: float = 0.0):
    """Mean token cross-entropy; logits (..., V) any float dtype, labels
    int."""
    logits = softcap(logits.float(), softcap_val)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.mean(logz - gold)
