"""Decoder stack of attention blocks with a dense SwiGLU MLP.

Parameters are declared stacked along a leading "layers" axis, as in the
reference (one period per layer for the ``("attn",)`` pattern), so both
packages count and initialise the same tree.  The port holds one
:class:`ParamModule` per layer in an ``nn.ModuleList`` and runs the layers
in a Python loop where the reference scans; inference needs no remat.
Mamba, mLSTM/sLSTM, MoE and encoder-decoder blocks are later slices
(ROADMAP queue 1, item 11).
"""
from __future__ import annotations

import torch
from torch import nn

from ..configs.base import ModelConfig
from . import attention as attn
from .common import ParamDef, rms_norm, swiglu


class ParamModule(nn.Module):
    """A module whose parameters and submodules carry the names of one node
    of the reference's parameter tree.  The tensors are wrapped as they are
    (views included, so a layer can be a slice of a stacked tensor) and need
    no gradient: the port only serves."""

    def __init__(self, tree: dict):
        super().__init__()
        for name, value in sorted(tree.items()):
            if isinstance(value, dict):
                self.add_module(name, ParamModule(value))
            else:
                self.register_parameter(name, nn.Parameter(value, requires_grad=False))


# ---------------------------------------------------------------------------
# Parameter tables
# ---------------------------------------------------------------------------


def mlp_defs(cfg: ModelConfig, stack: int) -> dict:
    d, ff = cfg.d_model, cfg.d_ff
    L = (stack,)
    lax_ = ("layers",)
    return {
        "w1": ParamDef(L + (d, ff), lax_ + ("embed_w", "ff")),
        "w3": ParamDef(L + (d, ff), lax_ + ("embed_w", "ff")),
        "w2": ParamDef(L + (ff, d), lax_ + ("ff", "embed_w")),
    }


def _block_defs(cfg: ModelConfig, kind: str, stack: int) -> dict:
    if kind != "attn" or cfg.attention != "gqa" or cfg.is_moe:
        raise NotImplementedError(
            f"{cfg.name}: only GQA attention blocks with a dense MLP are ported "
            "(ROADMAP queue 1, item 11)"
        )
    d = cfg.d_model
    norm = lambda: ParamDef((stack, d), ("layers", "embed_w"), init="ones")
    defs: dict = {"norm1": norm(), "attn": attn.gqa_defs(cfg, stack)}
    if cfg.d_ff > 0:
        defs["norm2"] = norm()
        defs["mlp"] = mlp_defs(cfg, stack)
    return defs


def decoder_defs(cfg: ModelConfig) -> dict:
    stack = cfg.n_periods()
    d = cfg.d_model
    defs: dict = {
        "embed": ParamDef((cfg.padded_vocab, d), ("vocab", "embed_w"), init="embed"),
        "final_norm": ParamDef((d,), ("embed_w",), init="ones"),
    }
    if not cfg.tie_embeddings:
        defs["lm_head"] = ParamDef((d, cfg.padded_vocab), ("embed_w", "vocab"))
    defs["blocks"] = {
        f"b{i}_{kind}": _block_defs(cfg, kind, stack)
        for i, kind in enumerate(cfg.pattern())
    }
    return defs


# ---------------------------------------------------------------------------
# Block application
# ---------------------------------------------------------------------------


def _ffn_half(bp: nn.Module, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if hasattr(bp, "mlp"):
        h = rms_norm(x, bp.norm2, cfg.norm_eps)
        return x + swiglu(h, bp.mlp.w1, bp.mlp.w3, bp.mlp.w2)
    return x


def apply_block(bp: nn.Module, x: torch.Tensor, cfg: ModelConfig, mode: str,
                state: dict | None, positions):
    """One attention block.  ``mode`` is "prefill" (``positions`` (B, S);
    returns the block's new KV cache) or "decode" (``positions`` is the
    shared int position; ``state`` is the block's cache, updated in
    place)."""
    h = rms_norm(x, bp.norm1, cfg.norm_eps)
    if mode == "decode":
        y, new_state = attn.gqa_decode(bp.attn, h, cfg, state, positions)
    elif mode == "prefill":
        y, new_state = attn.gqa_prefill(bp.attn, h, cfg, positions, make_cache=True)
    else:
        raise ValueError(f"mode must be 'prefill' or 'decode', got {mode!r}")
    x = x + y
    return _ffn_half(bp, x, cfg), new_state


# ---------------------------------------------------------------------------
# Stack
# ---------------------------------------------------------------------------


def run_decoder_stack(blocks: nn.ModuleList, x: torch.Tensor, cfg: ModelConfig,
                      mode: str, caches: dict | None = None, positions=None):
    """Returns (x, caches).  Caches keep the reference's layout:
    ``{"b0_attn": {"k": (L, B, T, KV, hd), "v": ...}}``.  Prefill stacks the
    layers' new caches; decode updates ``caches`` in place and returns it."""
    key = "b0_attn"
    new: list[dict] = []
    for i, bp in enumerate(blocks):
        state = None if caches is None else {n: c[i] for n, c in caches[key].items()}
        x, ns = apply_block(bp, x, cfg, mode, state, positions)
        new.append(ns)
    if mode == "decode":
        return x, caches
    return x, {key: {n: torch.stack([s[n] for s in new]) for n in new[0]}}
