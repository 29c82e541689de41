"""Modality-frontend stubs, as in the reference package: an architecture's
``[audio]``/``[vlm]`` entry specifies the transformer backbone only, and the
frontend is a (batch, frontend_tokens, d_model) tensor of precomputed frame
or patch embeddings.  A learned projection, ``frontend_proj``, maps them
into the backbone's residual stream: the encoder's input for an
encoder-decoder model, tokens prepended to the text for a decoder-only one.

The reference's ``frontend_embed_struct`` is a JAX shape struct for its
dry-run and has no counterpart here.
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig


def frontend_embed_shape(cfg: ModelConfig, batch: int) -> tuple[int, int, int]:
    return (batch, cfg.frontend_tokens, cfg.d_model)


def apply_frontend_proj(proj: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
    """``emb @ frontend_proj``: (B, T, d) embeddings into the residual
    stream."""
    return emb @ proj
