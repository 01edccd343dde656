"""Qwen2.5-3B — dense GQA (kv=2) with QKV bias [hf:Qwen/Qwen2.5-0.5B family]."""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-3b", family="dense",
        n_layers=36, d_model=2048, n_heads=16, n_kv_heads=2, d_ff=11008,
        vocab=151936, head_dim=128, qkv_bias=True, tie_embeddings=True,
        rope_theta=1e6,
        source="hf:Qwen/Qwen2.5-0.5B",
    )


def smoke() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=256, vocab=256)
