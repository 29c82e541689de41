"""llama3-8b [dense]: 32L d=4096 32H (GQA kv=8) ff=14336 vocab=128256
[arXiv:2407.21783]."""
from .base import ModelConfig, register, register_smoke


@register
def llama3_8b() -> ModelConfig:
    return ModelConfig(
        name="llama3-8b", family="dense",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=14336, vocab=128256, head_dim=128, rope_theta=500_000.0,
    )


register_smoke("llama3-8b", lambda: ModelConfig(
    name="llama3-8b@smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
    head_dim=16,
))
