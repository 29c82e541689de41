"""stablelm-1.6b [dense]: 24L d=2048 32H (kv=32, i.e. MHA) ff=5632
vocab=100352 [hf:stabilityai/stablelm-2-1_6b]."""
from .base import ModelConfig, register, register_smoke


@register
def stablelm_1_6b() -> ModelConfig:
    return ModelConfig(
        name="stablelm-1.6b", family="dense",
        n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32,
        d_ff=5632, vocab=100352, head_dim=64,
    )


register_smoke("stablelm-1.6b", lambda: ModelConfig(
    name="stablelm-1.6b@smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=256,
    head_dim=16,
))
