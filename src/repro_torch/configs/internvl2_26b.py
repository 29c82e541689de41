"""internvl2-26b [vlm]: 48L d=6144 48H (GQA kv=8) ff=16384 vocab=92553,
InternViT frontend (STUB: precomputed patch embeddings) + InternLM2 backbone
[arXiv:2404.16821]."""
from .base import ModelConfig, register, register_smoke


@register
def internvl2_26b() -> ModelConfig:
    return ModelConfig(
        name="internvl2-26b", family="vlm",
        n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8,
        d_ff=16384, vocab=92553, head_dim=128,
        frontend="vit", frontend_tokens=256,
        notes="frontend stub: input_specs() provides patch embeddings",
    )


register_smoke("internvl2-26b", lambda: ModelConfig(
    name="internvl2-26b@smoke", family="vlm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
    head_dim=16, frontend="vit", frontend_tokens=8,
))
