"""Flash attention and its backward: CUDA kernels and plain versions."""
from .ops import flash_attention, flash_attention_backward, flash_attention_with_lse
from .ref import (
    attention_reference,
    flash_attention_backward_reference,
    flash_attention_reference,
)

__all__ = ["attention_reference", "flash_attention", "flash_attention_backward",
           "flash_attention_backward_reference", "flash_attention_reference",
           "flash_attention_with_lse"]
