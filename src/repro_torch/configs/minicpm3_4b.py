"""minicpm3-4b [dense]: 62L d=2560 40H (GQA kv=40) ff=6400 vocab=73448,
multi-head latent attention [hf:openbmb/MiniCPM3-4B]."""
from .base import MLAConfig, ModelConfig, register, register_smoke


@register
def minicpm3_4b() -> ModelConfig:
    return ModelConfig(
        name="minicpm3-4b", family="dense",
        n_layers=62, d_model=2560, n_heads=40, n_kv_heads=40,
        d_ff=6400, vocab=73448, head_dim=64,
        attention="mla",
        mla=MLAConfig(q_lora_rank=768, kv_lora_rank=256,
                      qk_nope_head_dim=64, qk_rope_head_dim=32, v_head_dim=64),
        notes="MLA compressed KV cache (kv_lora_rank+rope dims per token)",
    )


register_smoke("minicpm3-4b", lambda: ModelConfig(
    name="minicpm3-4b@smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=256,
    head_dim=16, attention="mla",
    mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                  qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16),
))
