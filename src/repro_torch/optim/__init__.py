"""AdamW with a cosine schedule, global-norm clipping and fp32 master
weights, for the port's training step."""
from .optimizer import AdamWConfig, adamw_update, cosine_lr, global_norm, init_opt_state

__all__ = ["AdamWConfig", "adamw_update", "cosine_lr", "global_norm", "init_opt_state"]
