"""LM models on PyTorch: GQA attention (optionally windowed) with dense
SwiGLU MLPs, served by :mod:`repro_torch.launch.serve`."""

from .model import Model, build_model

__all__ = ["Model", "build_model"]
