"""The Model: parameters built from the reference's parameter tables,
prefill and decode forward passes, and decode caches.

Weights keep the reference's (in, out) orientation (``x @ w``), and the
state dict names follow its parameter tree with the period axis unstacked:
``embed``, ``final_norm``, ``lm_head``, ``blocks.<i>.norm1``,
``blocks.<i>.attn.wq`` ... ``blocks.<i>.mlp.w2`` for ``("attn",)`` models,
and with the block key for longer patterns:
``blocks.<i>.b0_mamba.mamba.in_proj`` ... ``blocks.<i>.b3_attn.attn.wq``.
An MoE layer holds ``moe.router`` and ``moe.w1``/``w3``/``w2`` (the expert
axis first) where a dense one holds ``mlp``; an MLA layer ``attn.wq_down``,
``attn.q_norm`` ... ``attn.wo``.
An encoder-decoder model adds ``encoder.blocks.<i>.norm1`` ...
``encoder.blocks.<i>.mlp.w2``, ``encoder.final_norm`` and, per decoder
period, ``cross.<i>.norm`` and ``cross.<i>.attn.wq`` ... ``.wo``; a model
with a frontend adds ``frontend_proj``.
"""
from __future__ import annotations

import torch
from torch import nn

from ..configs.base import ModelConfig
from ..device import resolve_device
from .attention import make_cache_struct
from .common import add_rms_norm, count_params, init_params
from .frontends import apply_frontend_proj
from .ssm import mamba_state_struct
from .transformer import (
    ParamModule,
    block_keys,
    decoder_defs,
    period_tree,
    run_decoder_stack,
    run_encoder_stack,
)

#: What this slice of the port leaves out, with the ROADMAP item that
#: brings it (queue 1, item 3d).
_NOT_PORTED = (
    (lambda c: not set(c.pattern()) <= {"attn", "mamba"},
     "mLSTM/sLSTM (xLSTM) blocks (ROADMAP queue 1, item 3d)"),
)


class Model(nn.Module):
    """An LM of attention (GQA or MLA) and Mamba blocks, each with a dense
    SwiGLU MLP or an MoE feed-forward, in periods of ``cfg.pattern()``:
    decoder-only, decoder-only behind a
    modality frontend's tokens (``cfg.frontend``), or encoder-decoder
    (``cfg.is_encdec``: a bidirectional encoder over the frontend's frames,
    read by a cross-attention sub-block in every decoder period).

    ``params`` is the reference-shaped tree of tensors (block leaves stacked
    along the period axis), as :func:`~.common.init_params` makes it; each
    period's parameters are views of the stacked tensors, so building the
    model copies nothing.
    """

    def __init__(self, cfg: ModelConfig, params: dict):
        super().__init__()
        self.cfg = cfg
        for name, value in params.items():
            if name not in ("blocks", "encoder", "cross"):
                self.register_parameter(name, nn.Parameter(value, requires_grad=False))
        stacked = period_tree(cfg, params["blocks"])
        self.blocks = nn.ModuleList(
            ParamModule(_tree_index(stacked, i)) for i in range(cfg.n_periods())
        )
        self.encoder = self.cross = None
        if cfg.is_encdec:
            enc = params["encoder"]
            self.encoder = ParamModule({"final_norm": enc["final_norm"]})
            self.encoder.blocks = nn.ModuleList(
                ParamModule(_tree_index(enc["blocks"]["b0_attn"], i))
                for i in range(cfg.enc_layers)
            )
            self.cross = nn.ModuleList(
                ParamModule(_tree_index(params["cross"], i)) for i in range(cfg.n_periods())
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

    def _assemble_inputs(self, tokens: torch.Tensor, frontend: torch.Tensor | None):
        """Token embeddings, behind the projected frontend tokens for a
        decoder-only model with a frontend; and their positions (B, S)."""
        x = self.embed[tokens]
        if self.cfg.frontend is not None and not self.cfg.is_encdec:
            fe = apply_frontend_proj(self.frontend_proj, frontend.to(x.dtype))
            x = torch.cat([fe, x], dim=1)
        B, S, _ = x.shape
        return x, torch.arange(S, device=x.device).expand(B, S)

    # -- forward passes ------------------------------------------------------
    def forward_prefill(self, tokens: torch.Tensor, frontend: torch.Tensor | None = None):
        """Causal forward over ``tokens`` (B, S) that also builds the decode
        caches.  Returns the last position's logits (B, 1, V) and the caches,
        one entry per block of the period stacked along the period axis
        (``{"b0_attn": {"k": (P, B, S', KV, hd), "v": ...}}``, S' = S or the
        sliding window; ``{"b1_mamba": {"h": (P, B, di, N), "conv": ...}}``).

        A model with a frontend takes its embeddings ``frontend`` (B, T, d)
        and raises without them: an encoder-decoder model encodes them and
        adds ``"cross_kv"`` ``{"k": (P, B, T, KV, hd), "v": ...}`` to the
        caches; a decoder-only one prepends them to the tokens, so its
        caches and positions count T + S.

        An MLA model's caches are ``{"c_kv": (P, B, S, rank), "k_rope":
        (P, B, S, rope)}``.  The MoE layers' aux values are dropped, as the
        reference's serving drops them."""
        cfg = self.cfg
        if (frontend is None) != (cfg.frontend is None):
            raise ValueError(f"{cfg.name}: frontend embeddings are "
                             f"{'required' if frontend is None else 'not taken'}")
        enc_out = None
        if cfg.is_encdec:
            enc_in = apply_frontend_proj(self.frontend_proj, frontend.to(self.embed.dtype))
            enc_out = run_encoder_stack(self.encoder, enc_in, cfg)
        x, positions = self._assemble_inputs(tokens, frontend)
        x, delta, caches = run_decoder_stack(self.blocks, x, cfg, "prefill",
                                             positions=positions, cross=self.cross,
                                             enc_out=enc_out)
        _, h = add_rms_norm(x, delta, self.final_norm, cfg.norm_eps)
        return self._head(h[:, -1:, :]), caches

    def forward_decode(self, token: torch.Tensor, caches: dict, pos: int):
        """One decode step: ``token`` (B, 1) at the shared position ``pos``.
        Writes the new K/V (or MLA latents) and Mamba states into ``caches``
        in place and returns (logits (B, 1, V), caches).  An
        encoder-decoder model's cross-attention reads
        ``caches["cross_kv"]``."""
        x = self.embed[token]
        x, delta, caches = run_decoder_stack(self.blocks, x, self.cfg, "decode",
                                             caches=caches, positions=int(pos),
                                             cross=self.cross)
        _, h = add_rms_norm(x, delta, self.final_norm, self.cfg.norm_eps)
        return self._head(h), caches

    # -- caches ----------------------------------------------------------------
    def cache_struct(self, batch: int, ctx_len: int, dtype: torch.dtype | None = None) -> dict:
        """Zero decode caches, stacked along the period axis, on the model's
        device: K/V caches for GQA blocks, ``c_kv`` (P, batch, ctx_len,
        rank) and ``k_rope`` (P, batch, ctx_len, rope) for MLA blocks, Mamba
        states (``h`` fp32, ``conv`` in ``dtype``) for Mamba blocks, and for
        an encoder-decoder model the cross-attention K/V ``"cross_kv"`` of
        shape (P, batch, T, KV, hd), T the frontend's frames."""
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
        if self.cfg.is_encdec:
            shape = (P, batch, self.cfg.frontend_tokens, self.cfg.n_kv_heads, self.cfg.head_dim)
            caches["cross_kv"] = {n: torch.zeros(shape, dtype=dtype, device=device)
                                  for n in ("k", "v")}
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
