"""Flash attention: CUDA kernel and plain versions."""
from .ops import flash_attention
from .ref import attention_reference, flash_attention_reference

__all__ = ["attention_reference", "flash_attention", "flash_attention_reference"]
