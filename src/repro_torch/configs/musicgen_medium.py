"""MusicGen-medium — decoder-only transformer over 4 EnCodec codebooks
(delay pattern applied in the data layer) [arXiv:2306.05284]. The EnCodec
conv codec frontend is a STUB: the model consumes token ids directly."""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-medium", family="audio",
        n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24, d_ff=6144,
        vocab=2048, head_dim=64, n_codebooks=4,
        source="arXiv:2306.05284",
    )


def smoke() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
        d_ff=256, vocab=64, n_codebooks=4)
