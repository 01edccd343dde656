"""RWKV6 (Finch) 3B — attention-free, data-dependent decay [arXiv:2404.05892]."""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-3b", family="ssm",
        n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40, d_ff=8960,
        vocab=65536, rwkv_head_dim=64,
        source="arXiv:2404.05892",
    )


def smoke() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, d_ff=256,
        vocab=256, rwkv_head_dim=32)
