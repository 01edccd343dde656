"""Qwen3-MoE 235B-A22B — 94L, 128 experts top-8, QK-norm
[hf:Qwen/Qwen3-30B-A3B family]."""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-235b-a22b", family="moe",
        n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, d_ff=1536,
        vocab=151936, head_dim=128, qk_norm=True, rope_theta=1e6,
        n_experts=128, top_k=8,
        gqa_layout="g_major",  # G=16 divides the model axis (§Perf iter E)
        source="hf:Qwen/Qwen3-30B-A3B",
    )


def smoke() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=64, vocab=256, n_experts=4, top_k=2)
