"""Gemma2-27B — alternating local(4096)/global attention, logit softcaps,
post-block norms, GeGLU [arXiv:2408.00118]."""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-27b", family="dense",
        n_layers=46, d_model=4608, n_heads=32, n_kv_heads=16, d_ff=36864,
        vocab=256000, head_dim=128, tie_embeddings=True, act="gelu",
        attn_pattern="local_global", local_window=4096,
        attn_logit_softcap=50.0, final_logit_softcap=30.0,
        post_block_norms=True,
        source="arXiv:2408.00118",
    )


def smoke() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=256, vocab=256, local_window=16)
