"""The four assigned input shapes and per-(arch, shape) input specs (port
of `repro/launch/shapes.py`).

`input_specs` returns a stand-in for every input of the step function
of an (arch, shape): tensors on the `meta` device (shape and dtype, no
memory), where the reference returns `jax.ShapeDtypeStruct`s. The
decode cache is `transformer.init_cache(..., device="meta")`: the port's
lists of per-layer caches, where the reference stacks the layers on a
leading axis.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import transformer as tf
from repro_torch.models.common import ModelConfig


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}

# sliding window used when a quadratic-attention arch runs long_500k
LONG_CONTEXT_WINDOW = 8192


def arch_for_shape(cfg: ModelConfig, shape: InputShape) -> ModelConfig:
    """Adapt a config to a shape: long-context decode uses the sliding-
    window KV-cache variant for every arch that has attention layers
    (SSM/hybrid state is O(1) regardless)."""
    if shape.name == "long_500k" and cfg.family != "ssm":
        return cfg.replace(decode_window=LONG_CONTEXT_WINDOW)
    return cfg


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def token_struct(cfg: ModelConfig, batch: int, seq: int):
    shp = (batch, seq, cfg.n_codebooks) if cfg.n_codebooks else (batch, seq)
    return _meta(shp, torch.int32)


def input_specs(cfg: ModelConfig, shape: InputShape):
    """Meta-tensor inputs for the step function of this (arch, shape)."""
    cfg = arch_for_shape(cfg, shape)
    B, S = shape.global_batch, shape.seq_len
    if shape.kind in ("train", "prefill"):
        batch = {"tokens": token_struct(cfg, B, S)}
        if shape.kind == "train":
            batch["labels"] = token_struct(cfg, B, S)
        if cfg.family == "vlm":
            batch["img_emb"] = _meta((B, cfg.n_img_tokens, cfg.d_vision),
                                     torch.bfloat16)
        return batch
    # decode: one new token against a cache of seq_len (window-capped)
    cache_len = min(S, cfg.decode_window) if cfg.decode_window else S
    return {"tokens": token_struct(cfg, B, 1),
            "cache": tf.init_cache(cfg, B, cache_len, device="meta"),
            "t": _meta((), torch.int32)}
