"""Grouped-query attention (with optional sliding window): prefill through
the flash-attention kernel, and single-token decode against a static KV
cache (a circular buffer for sliding windows).

The reference package computes the prefill core in plain jnp and names its
Pallas flash kernel as the drop-in for that core on real chips
(``models/attention.py:7-8``).  The port makes that swap: every prefill
runs :func:`repro_torch.kernels.flash_attention.flash_attention`, which
computes the same function as the reference's ``causal_mask`` +
``_gqa_core`` and its q-chunked variant.  Decode attention stays plain
torch (:func:`_gqa_core`), as in the reference.

An encoder-decoder's cross-attention reads the encoder's K/V
(:func:`encoder_kv`), which the reference computes with ``_gqa_core`` and
an all-ones mask: at prefill the port runs the flash kernel non-causal with
keys of their own length, at decode the same plain single-token core as
:func:`gqa_decode`.

MLA and sequence-sharded decode are later slices (ROADMAP queue 1, items
3b and 3e).
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..kernels.flash_attention import flash_attention
from .common import ParamDef, apply_rope, softmax_fp32

# ---------------------------------------------------------------------------
# Parameter tables
# ---------------------------------------------------------------------------


def gqa_defs(cfg: ModelConfig, stack: int, cross: bool = False) -> dict:
    """Q/K/V/O projections of ``stack`` layers; a cross-attention layer
    (``cross=True``) has the same shapes, as in the reference."""
    d, hd = cfg.d_model, cfg.head_dim
    H, KV = cfg.n_heads, cfg.n_kv_heads
    L = (stack,)
    lax_ = ("layers",)
    return {
        "wq": ParamDef(L + (d, H * hd), lax_ + ("embed_w", "heads_w")),
        "wk": ParamDef(L + (d, KV * hd), lax_ + ("embed_w", "kv_w")),
        "wv": ParamDef(L + (d, KV * hd), lax_ + ("embed_w", "kv_w")),
        "wo": ParamDef(L + (H * hd, d), lax_ + ("heads_w", "embed_w")),
    }


# ---------------------------------------------------------------------------
# Core attention math (grouped-query, fp32 softmax)
# ---------------------------------------------------------------------------


def _gqa_core(q, k, v, mask, scale) -> torch.Tensor:
    """q: (B,S,H,hd)  k/v: (B,T,KV,hd)  mask: (S,T) or (B,S,T) bool.

    K/V are expanded to the full head count (query head ``h`` reads kv head
    ``h // G``), as in the reference."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    if G > 1:
        k = k.repeat_interleave(G, dim=2)
        v = v.repeat_interleave(G, dim=2)
    scores = torch.einsum("bsnh,btnh->bnst", q, k) * scale
    mask = mask[None, None] if mask.dim() == 2 else mask[:, None]
    scores = torch.where(mask, scores.to(torch.float32), -1e30)
    p = softmax_fp32(scores)
    return torch.einsum("bnst,btnh->bsnh", p.to(v.dtype), v)


def gqa_prefill(p, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor,
                make_cache: bool = False):
    """Full-sequence causal attention.  ``p`` holds ``wq``, ``wk``, ``wv``
    and ``wo`` as attributes.  Returns (out, cache|None)."""
    B, S, d = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ p.wq).reshape(B, S, H, hd)
    k = (x @ p.wk).reshape(B, S, KV, hd)
    v = (x @ p.wv).reshape(B, S, KV, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    out = flash_attention(q, k, v, causal=True, window=cfg.sliding_window,
                          scale=1.0 / hd ** 0.5)
    out = out.reshape(B, S, H * hd) @ p.wo
    cache = None
    if make_cache:
        W = cfg.sliding_window
        if W is not None and S >= W:
            k, v = k[:, -W:], v[:, -W:]
        cache = {"k": k, "v": v}
    return out, cache


def gqa_decode(p, x: torch.Tensor, cfg: ModelConfig, cache: dict, pos: int):
    """Single-token decode against a static cache.

    cache["k"]/["v"]: (B, T, KV, hd) with T = full context (or the sliding
    window, used as a circular buffer).  ``pos`` is the absolute position of
    the new token, shared by every row.  The new token's K/V are written
    into ``cache`` in place (the reference returns updated copies); the
    write index is clamped into the cache as ``dynamic_update_slice``
    clamps it.
    """
    B, S, d = x.shape
    if S != 1:
        raise ValueError(f"decode takes one token per row, got {S}")
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    T = cache["k"].shape[1]
    q = (x @ p.wq).reshape(B, 1, H, hd)
    k = (x @ p.wk).reshape(B, 1, KV, hd)
    v = (x @ p.wv).reshape(B, 1, KV, hd)
    posb = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q = apply_rope(q, posb, cfg.rope_theta)
    k = apply_rope(k, posb, cfg.rope_theta)
    slot = pos % T if cfg.sliding_window is not None else pos
    slot = min(max(slot, 0), T - 1)
    cache["k"][:, slot] = k[:, 0]
    cache["v"][:, slot] = v[:, 0]
    if cfg.sliding_window is not None:
        # circular buffer: every slot counts as holding one of the last T
        # tokens, filled or not (the reference's quirk, kept for parity)
        valid = torch.ones(T, dtype=torch.bool, device=x.device)
    else:
        valid = torch.arange(T, device=x.device) <= pos
    mask = valid[None, None, :].expand(B, 1, T)
    out = _gqa_core(q, cache["k"], cache["v"], mask, 1.0 / hd ** 0.5)
    out = out.reshape(B, 1, H * hd) @ p.wo
    return out, cache


# ---------------------------------------------------------------------------
# Cross-attention (encoder-decoder)
# ---------------------------------------------------------------------------


def cross_attention(p, x: torch.Tensor, enc_kv: dict, cfg: ModelConfig, *,
                    decode: bool = False) -> torch.Tensor:
    """Decoder cross-attention over precomputed encoder K/V: ``x`` (B, S, d)
    attends to all T encoder frames of ``enc_kv["k"]``/``["v"]`` (B, T, KV,
    hd), without RoPE.  A prefill runs the flash kernel non-causal with T
    keys; a decode step (``decode=True``, S = 1) the plain core."""
    B, S, _ = x.shape
    H, hd = cfg.n_heads, cfg.head_dim
    q = (x @ p.wq).reshape(B, S, H, hd)
    k, v = enc_kv["k"], enc_kv["v"]
    if decode:
        mask = torch.ones((1, k.shape[1]), dtype=torch.bool, device=x.device)
        out = _gqa_core(q, k, v, mask, 1.0 / hd ** 0.5)
    else:
        out = flash_attention(q, k, v, causal=False, scale=1.0 / hd ** 0.5)
    return out.reshape(B, S, H * hd) @ p.wo


def encoder_kv(p, enc_out: torch.Tensor, cfg: ModelConfig) -> dict:
    """The cross-attention K/V of one decoder layer from the encoder's
    output (B, T, d): ``{"k": (B, T, KV, hd), "v": ...}``."""
    B, T, _ = enc_out.shape
    KV, hd = cfg.n_kv_heads, cfg.head_dim
    return {"k": (enc_out @ p.wk).reshape(B, T, KV, hd),
            "v": (enc_out @ p.wv).reshape(B, T, KV, hd)}


# ---------------------------------------------------------------------------
# Cache allocation
# ---------------------------------------------------------------------------


def make_cache_struct(cfg: ModelConfig, batch: int, ctx_len: int,
                      dtype: torch.dtype = torch.float32, device=None) -> dict:
    """Zero-filled KV cache for ONE attention layer; the model stacks these
    along the layer axis."""
    T = min(ctx_len, cfg.sliding_window) if cfg.sliding_window else ctx_len
    shape = (batch, T, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
