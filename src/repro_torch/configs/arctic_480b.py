"""Snowflake Arctic 480B — 128-expert top-2 MoE with a parallel dense
residual FFN [hf:Snowflake/snowflake-arctic-base]."""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="arctic-480b", family="moe",
        n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8, d_ff=4864,
        vocab=32000, head_dim=128,
        n_experts=128, top_k=2, moe_dense_residual=True,
        source="hf:Snowflake/snowflake-arctic-base",
    )


def smoke() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=128, vocab=256, n_experts=4, top_k=2)
