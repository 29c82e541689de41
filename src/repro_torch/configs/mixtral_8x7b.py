"""mixtral-8x7b [moe]: 32L d=4096 32H (GQA kv=8) ff=14336 vocab=32000,
8 experts top-2, sliding-window attention [arXiv:2401.04088]."""
from .base import ModelConfig, register, register_smoke


@register
def mixtral_8x7b() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x7b", family="moe",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=14336, vocab=32000, head_dim=128,
        n_experts=8, experts_per_token=2, moe_every=1,
        sliding_window=4096, rope_theta=1_000_000.0,
        notes="8 experts < tp=16: expert-TP sharding (DESIGN.md §5); SWA => long_500k",
    )


register_smoke("mixtral-8x7b", lambda: ModelConfig(
    name="mixtral-8x7b@smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
    head_dim=16, n_experts=4, experts_per_token=2, moe_every=1, sliding_window=32,
))
