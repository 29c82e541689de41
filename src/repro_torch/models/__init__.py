"""LM models on PyTorch: GQA (optionally windowed) or MLA attention and
Mamba blocks, with dense SwiGLU MLPs or MoE feed-forwards, served by
:mod:`repro_torch.launch.serve`."""

from .model import Model, build_model

__all__ = ["Model", "build_model"]
