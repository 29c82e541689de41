"""The Model: parameters built from the reference's parameter tables,
prefill and decode forward passes, and decode caches.

Weights keep the reference's (in, out) orientation (``x @ w``), and the
state dict names follow its parameter tree with the period axis unstacked:
``embed``, ``final_norm``, ``lm_head``, ``blocks.<i>.norm1``,
``blocks.<i>.attn.wq`` ... ``blocks.<i>.mlp.w2`` for ``("attn",)`` models,
and with the block key for longer patterns:
``blocks.<i>.b0_mamba.mamba.in_proj`` ... ``blocks.<i>.b3_attn.attn.wq``.
"""
from __future__ import annotations

import torch
from torch import nn

from ..configs.base import ModelConfig
from ..device import resolve_device
from .attention import make_cache_struct
from .common import add_rms_norm, count_params, init_params
from .ssm import mamba_state_struct
from .transformer import (
    ParamModule,
    block_keys,
    decoder_defs,
    period_tree,
    run_decoder_stack,
)

#: What this slice of the port leaves out, with the ROADMAP item that
#: brings it (queue 1, item 11).
_NOT_PORTED = (
    (lambda c: c.attention == "mla", "MLA attention (ROADMAP queue 1, item 11b)"),
    (lambda c: c.is_moe, "MoE feed-forward (ROADMAP queue 1, item 11c)"),
    (lambda c: not set(c.pattern()) <= {"attn", "mamba"},
     "mLSTM/sLSTM (xLSTM) blocks (ROADMAP queue 1, item 11a)"),
    (lambda c: c.frontend is not None, "modality frontends (ROADMAP queue 1, item 11d)"),
    (lambda c: c.is_encdec, "encoder-decoder stacks (ROADMAP queue 1, item 11d)"),
)


class Model(nn.Module):
    """A decoder-only LM of GQA attention and Mamba blocks with dense SwiGLU
    MLPs, in periods of ``cfg.pattern()``.

    ``params`` is the reference-shaped tree of tensors (block leaves stacked
    along the period axis), as :func:`~.common.init_params` makes it; each
    period's parameters are views of the stacked tensors, so building the
    model copies nothing.
    """

    def __init__(self, cfg: ModelConfig, params: dict):
        super().__init__()
        self.cfg = cfg
        for name, value in params.items():
            if name != "blocks":
                self.register_parameter(name, nn.Parameter(value, requires_grad=False))
        stacked = period_tree(cfg, params["blocks"])
        self.blocks = nn.ModuleList(
            ParamModule(_tree_index(stacked, i)) for i in range(cfg.n_periods())
        )

    def n_params(self) -> int:
        return count_params(decoder_defs(self.cfg))

    # -- embedding / head ----------------------------------------------------
    def _head(self, x: torch.Tensor) -> torch.Tensor:
        w = self.lm_head if hasattr(self, "lm_head") else self.embed.T
        logits = x @ w
        if self.cfg.padded_vocab != self.cfg.vocab:
            # mask padded vocabulary rows out of the softmax
            valid = torch.arange(self.cfg.padded_vocab, device=x.device) < self.cfg.vocab
            logits = logits.masked_fill(~valid, -1e9)
        return logits

    # -- forward passes ------------------------------------------------------
    def forward_prefill(self, tokens: torch.Tensor):
        """Causal forward over ``tokens`` (B, S) that also builds the decode
        caches.  Returns the last position's logits (B, 1, V) and the caches,
        one entry per block of the period stacked along the period axis
        (``{"b0_attn": {"k": (P, B, S', KV, hd), "v": ...}}``, S' = S or the
        sliding window; ``{"b1_mamba": {"h": (P, B, di, N), "conv": ...}}``)."""
        B, S = tokens.shape
        x = self.embed[tokens]
        positions = torch.arange(S, device=x.device).expand(B, S)
        x, delta, caches = run_decoder_stack(self.blocks, x, self.cfg, "prefill",
                                             positions=positions)
        _, h = add_rms_norm(x, delta, self.final_norm, self.cfg.norm_eps)
        return self._head(h[:, -1:, :]), caches

    def forward_decode(self, token: torch.Tensor, caches: dict, pos: int):
        """One decode step: ``token`` (B, 1) at the shared position ``pos``.
        Writes the new K/V and Mamba states into ``caches`` in place and
        returns (logits (B, 1, V), caches)."""
        x = self.embed[token]
        x, delta, caches = run_decoder_stack(self.blocks, x, self.cfg, "decode",
                                             caches=caches, positions=int(pos))
        _, h = add_rms_norm(x, delta, self.final_norm, self.cfg.norm_eps)
        return self._head(h), caches

    # -- caches ----------------------------------------------------------------
    def cache_struct(self, batch: int, ctx_len: int, dtype: torch.dtype | None = None) -> dict:
        """Zero decode caches, stacked along the period axis, on the model's
        device: K/V caches for attention blocks, Mamba states (``h`` fp32,
        ``conv`` in ``dtype``) for Mamba blocks."""
        dtype = dtype or self.embed.dtype
        device = self.embed.device
        P = self.cfg.n_periods()
        caches = {}
        for key, kind in block_keys(self.cfg):
            if kind == "attn":
                one = make_cache_struct(self.cfg, batch, ctx_len, dtype, device)
            else:
                one = mamba_state_struct(self.cfg, batch, dtype, device)
            caches[key] = {n: t.new_zeros((P, *t.shape)) for n, t in one.items()}
        return caches


def _tree_index(tree: dict, i: int) -> dict:
    return {k: _tree_index(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def build_model(cfg: ModelConfig, *, device=None, dtype: torch.dtype = torch.float32,
                seed: int = 0) -> Model:
    """A :class:`Model` for ``cfg`` on ``device`` (``None`` means the CUDA
    card), its weights drawn from a ``torch.Generator`` on that device
    seeded with ``seed``.  Raises ``NotImplementedError`` for the
    architecture features this slice of the port leaves out."""
    for test, what in _NOT_PORTED:
        if test(cfg):
            raise NotImplementedError(f"{cfg.name}: {what} is not ported yet")
    device = resolve_device(device)
    generator = torch.Generator(device=device).manual_seed(seed)
    return Model(cfg, init_params(decoder_defs(cfg), generator, dtype, device))
