"""olmoe-1b-7b [moe]: 16L d=2048 16H (kv=16) vocab=50304, 64 experts top-8,
per-expert ff=1024 [arXiv:2409.02060]."""
from .base import ModelConfig, register, register_smoke


@register
def olmoe_1b_7b() -> ModelConfig:
    return ModelConfig(
        name="olmoe-1b-7b", family="moe",
        n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
        d_ff=1024, vocab=50304, head_dim=128,
        n_experts=64, experts_per_token=8, moe_d_ff=1024, moe_every=1,
        notes="64 experts shard cleanly over tp=16 (EP)",
    )


register_smoke("olmoe-1b-7b", lambda: ModelConfig(
    name="olmoe-1b-7b@smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=64, vocab=256,
    head_dim=16, n_experts=8, experts_per_token=2, moe_d_ff=64, moe_every=1,
))
