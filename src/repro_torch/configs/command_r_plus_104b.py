"""Command R+ 104B — dense GQA (96H, kv=8), no bias, tied embeddings
[hf:CohereForAI/c4ai-command-r-v01]."""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="command-r-plus-104b", family="dense",
        n_layers=64, d_model=12288, n_heads=96, n_kv_heads=8, d_ff=33792,
        vocab=256000, head_dim=128, tie_embeddings=True, rope_theta=75e4,
        source="hf:CohereForAI/c4ai-command-r-v01",
    )


def smoke() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=192, n_heads=6, n_kv_heads=2, head_dim=32,
        d_ff=384, vocab=256)
