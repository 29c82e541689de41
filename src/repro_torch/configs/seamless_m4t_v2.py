"""seamless-m4t-large-v2 [audio]: 24L enc + 24L dec, d=1024 16H ff=8192
vocab=256206, multimodal enc-dec; audio frontend STUB (precomputed frame
embeddings) [arXiv:2308.11596]."""
from .base import ModelConfig, register, register_smoke


@register
def seamless_m4t_large_v2() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-large-v2", family="audio",
        n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
        d_ff=8192, vocab=256206, head_dim=64,
        enc_layers=24, frontend="audio", frontend_tokens=512,
        notes="enc-dec: decode shapes exercise the decoder w/ cross-attn cache",
    )


register_smoke("seamless-m4t-large-v2", lambda: ModelConfig(
    name="seamless-m4t-large-v2@smoke", family="audio",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=256,
    head_dim=16, enc_layers=2, frontend="audio", frontend_tokens=16,
))
