"""Zamba2-7B — Mamba2 backbone + 2 shared attention blocks [arXiv:2411.15242]."""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-7b", family="hybrid",
        n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32, d_ff=14336,
        vocab=32000, head_dim=112,
        ssm_state=64, ssm_expand=2, ssm_head_dim=64, ssm_conv=4,
        shared_attn_every=6, n_shared_attn=2,
        source="arXiv:2411.15242",
    )


def smoke() -> ModelConfig:
    return config().replace(
        n_layers=5, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
        d_ff=256, vocab=256, ssm_state=16, ssm_head_dim=32,
        shared_attn_every=2, n_shared_attn=2)
