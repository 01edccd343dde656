"""Llama-3.2-11B-Vision — text decoder with cross-attention image layers
every 5th layer [hf:meta-llama/Llama-3.2-11B-Vision]. The ViT vision
encoder is a STUB: input_specs supplies precomputed patch embeddings
(B, n_img_tokens, d_vision) pre-projector (the allowed carve-out)."""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-11b", family="vlm",
        n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
        vocab=128256, head_dim=128, rope_theta=5e5,
        cross_attn_every=5, n_img_tokens=1600, d_vision=1280,
        source="hf:meta-llama/Llama-3.2-11B-Vision",
    )


def smoke() -> ModelConfig:
    return config().replace(
        n_layers=4, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=256, vocab=256, cross_attn_every=2, n_img_tokens=16, d_vision=64)
