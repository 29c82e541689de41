"""h2o-danube-3-4b [dense]: 24L d=3840 32H (GQA kv=8) ff=10240 vocab=32000,
llama+mistral mix with sliding-window attention [arXiv:2401.16818]."""
from .base import ModelConfig, register, register_smoke


@register
def h2o_danube3_4b() -> ModelConfig:
    return ModelConfig(
        name="h2o-danube-3-4b", family="dense",
        n_layers=24, d_model=3840, n_heads=32, n_kv_heads=8,
        d_ff=10240, vocab=32000, head_dim=120,
        sliding_window=4096, rope_theta=10_000.0,
        notes="SWA => windowed KV cache => long_500k supported",
    )


register_smoke("h2o-danube-3-4b", lambda: ModelConfig(
    name="h2o-danube-3-4b@smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
    head_dim=16, sliding_window=32,
))
