"""Llama-3-8B — dense GQA kv=8, 128k vocab [arXiv:2407.21783]."""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama3-8b", family="dense",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
        vocab=128256, head_dim=128, rope_theta=5e5,
        source="arXiv:2407.21783",
    )


def smoke() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=256, vocab=256)
