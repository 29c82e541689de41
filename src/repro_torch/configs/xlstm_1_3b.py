"""xlstm-1.3b [ssm]: 48L d=2048 4H vocab=50304, sLSTM + mLSTM blocks
(7 mLSTM : 1 sLSTM per period) [arXiv:2405.04517]."""
from .base import ModelConfig, SSMConfig, register, register_smoke

_PATTERN = ("mlstm",) * 7 + ("slstm",)


@register
def xlstm_1_3b() -> ModelConfig:
    return ModelConfig(
        name="xlstm-1.3b", family="ssm",
        n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4,
        d_ff=0, vocab=50304, head_dim=512,
        block_pattern=_PATTERN, ssm=SSMConfig(),
        notes="recurrent state => O(1)/token decode => long_500k supported",
    )


register_smoke("xlstm-1.3b", lambda: ModelConfig(
    name="xlstm-1.3b@smoke", family="ssm",
    n_layers=2, d_model=64, n_heads=2, n_kv_heads=2, d_ff=0, vocab=256,
    head_dim=32, block_pattern=("mlstm", "slstm"), ssm=SSMConfig(chunk=16),
))
