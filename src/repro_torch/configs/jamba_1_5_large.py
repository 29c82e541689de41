"""jamba-1.5-large-398b [hybrid]: 72L d=8192 64H (GQA kv=8) ff=24576
vocab=65536, Mamba+attention 1:7 interleave, MoE 16 experts top-2
[arXiv:2403.19887]."""
from .base import ModelConfig, SSMConfig, register, register_smoke

# period of 8: attention at index 3, mamba elsewhere; MoE every 2nd layer
_PATTERN = ("mamba", "mamba", "mamba", "attn", "mamba", "mamba", "mamba", "mamba")


@register
def jamba_1_5_large() -> ModelConfig:
    return ModelConfig(
        name="jamba-1.5-large-398b", family="hybrid",
        n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8,
        d_ff=24576, vocab=65536, head_dim=128,
        n_experts=16, experts_per_token=2, moe_every=2,
        block_pattern=_PATTERN, ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
        notes="9/72 attention layers; long_500k decode uses sequence-sharded KV",
    )


register_smoke("jamba-1.5-large-398b", lambda: ModelConfig(
    name="jamba-1.5-large-398b@smoke", family="hybrid",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
    head_dim=16, n_experts=4, experts_per_token=2, moe_every=2,
    block_pattern=("mamba", "attn"), ssm=SSMConfig(d_state=4, d_conv=2, chunk=16),
))
