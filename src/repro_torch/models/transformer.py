"""Decoder stack of attention (GQA or MLA) and Mamba blocks, each with a
dense SwiGLU MLP or a Mixture-of-Experts feed-forward, and of xLSTM's
self-contained mLSTM and sLSTM blocks; and the bidirectional encoder stack
of encoder-decoder models.

Parameters are declared stacked along a leading period axis, as in the
reference: a period is one repetition of ``cfg.pattern()`` (one layer for
``("attn",)``; jamba's 7 Mamba blocks and 1 attention block), so both
packages count and initialise the same tree.  The port holds one
:class:`ParamModule` per period in an ``nn.ModuleList`` and runs the periods
and the blocks within each in Python loops where the reference scans;
training keeps every activation unless the stack runs with
``remat="full"``, which recomputes each block, and each encoder layer,
in the backward (``torch.utils.checkpoint``, the reference's
``jax.checkpoint``: memory, not numbers).  An encoder-decoder model adds
the encoder (one module per layer) and, per decoder period, a
cross-attention sub-block after the mixer, with its own norm.  A block's feed-forward is the MoE
layer where the reference puts one (``idx % moe_every == moe_every - 1``
within the period), else the dense MLP.  mLSTM and sLSTM blocks have no
feed-forward half: their output is the residual update.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from . import attention as attn
from . import ssm
from .moe import moe_defs, moe_ffn
from ..kernels.flash_attention import flash_attention
from .common import (ParamDef, add_rms_norm, apply_rope, axis_rules, current_rules,
                     replicated_like, seq_whole, shard_act, swiglu)


class ParamModule(nn.Module):
    """A module whose parameters and submodules carry the names of one node
    of the reference's parameter tree.  The tensors are wrapped as they are
    (views included, so a layer can be a slice of a stacked tensor) and are
    built without gradients for serving; training turns them on in place
    (:meth:`repro_torch.models.Model.trainable`)."""

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


#: Block kinds and their parameter tables; mLSTM and sLSTM blocks are
#: self-contained (a gated output, no feed-forward half).
BLOCK_KINDS = ("attn", "mamba", "mlstm", "slstm")


def _block_defs(cfg: ModelConfig, kind: str, idx_in_period: int, stack: int) -> dict:
    if kind not in BLOCK_KINDS:
        raise ValueError(f"unknown block kind {kind!r}")
    d = cfg.d_model
    norm = lambda: ParamDef((stack, d), ("layers", "embed_w"), init="ones")
    defs: dict = {"norm1": norm()}
    if kind == "attn":
        defs["attn"] = (attn.mla_defs(cfg, stack) if cfg.attention == "mla"
                        else attn.gqa_defs(cfg, stack))
    elif kind == "mamba":
        defs["mamba"] = ssm.mamba_defs(cfg, stack)
    else:
        defs[kind] = (ssm.mlstm_defs if kind == "mlstm" else ssm.slstm_defs)(cfg, stack)
        return defs
    if cfg.is_moe and idx_in_period % cfg.moe_every == cfg.moe_every - 1:
        defs["norm2"] = norm()
        defs["moe"] = moe_defs(cfg, stack)
    elif cfg.d_ff > 0:
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
    defs["blocks"] = {key: _block_defs(cfg, kind, i, stack)
                      for i, (key, kind) in enumerate(block_keys(cfg))}
    if cfg.is_encdec:
        E = cfg.enc_layers
        enc_norm = lambda: ParamDef((E, d), ("layers", "embed_w"), init="ones")
        defs["encoder"] = {
            "blocks": {"b0_attn": {"norm1": enc_norm(), "attn": attn.gqa_defs(cfg, E),
                                   "norm2": enc_norm(), "mlp": mlp_defs(cfg, E)}},
            "final_norm": ParamDef((d,), ("embed_w",), init="ones"),
        }
        defs["cross"] = {
            "norm": ParamDef((stack, d), ("layers", "embed_w"), init="ones"),
            "attn": attn.gqa_defs(cfg, stack, cross=True),
        }
    if cfg.frontend is not None:
        defs["frontend_proj"] = ParamDef((d, d), ("embed_w", None))
    return defs


# ---------------------------------------------------------------------------
# Block application
# ---------------------------------------------------------------------------


def _ffn_half(bp: nn.Module, x: torch.Tensor, y: torch.Tensor, cfg: ModelConfig,
              aux: dict | None = None):
    """The feed-forward half after a mixer whose output is ``y``: returns
    ``(x + y, ffn(rmsnorm(x + y)))``, the feed-forward's output being the
    residual update still to add; ``ffn`` is the MoE layer or the dense
    MLP.  A block with neither returns ``(x, y)``: ``y`` is added by the
    next norm.  The MoE layer's aux values are computed and summed into
    ``aux`` only when it is given (training); serving drops them, as the
    reference's does."""
    if hasattr(bp, "moe"):
        x, h = add_rms_norm(x, y, bp.norm2, cfg.norm_eps)
        x = shard_act(x, ("act_batch", "act_seq", None))
        y, layer_aux = moe_ffn(bp.moe, h, cfg, need_aux=aux is not None)
        for k, v in (layer_aux or {}).items():
            aux[k] = aux[k] + v if k in aux else v
        return x, y
    if hasattr(bp, "mlp"):
        x, h = add_rms_norm(x, y, bp.norm2, cfg.norm_eps)
        x = shard_act(x, ("act_batch", "act_seq", None))
        h = shard_act(h, ("act_batch", "act_seq", None))
        return x, swiglu(h, bp.mlp.w1, bp.mlp.w3, bp.mlp.w2)
    return x, y


def apply_block(bp: nn.Module, kind: str, x: torch.Tensor, delta: torch.Tensor | None,
                cfg: ModelConfig, mode: str, state: dict | None, positions,
                cross: tuple[nn.Module, dict] | None = None, aux: dict | None = None):
    """One block of ``kind`` (one of :data:`BLOCK_KINDS`) on the residual stream
    ``x + delta``: ``delta`` is the previous block's update, not yet added
    (None before the first block).  The add is fused into the block's first
    norm and the mixer's output into its second, so the block returns
    ``(x, delta, state)`` with its own update as the new ``delta``; the
    reference's stream after the block is ``x + delta``.

    ``cross`` is an encoder-decoder period's cross-attention sub-block, its
    parameters (``norm``, ``attn``) and the encoder's K/V: it runs after the
    mixer, its norm taking the mixer's output as the residual add, and its
    output goes on to the MLP's norm.

    ``mode`` is "prefill" (``positions`` (B, S); the returned state is the
    block's new cache or state, a recurrent block's from its start state
    as in the reference), "train" (prefill without building caches: the
    returned state is None, and the MoE layer's aux values are summed into
    ``aux``) or "decode" (``positions`` is the shared int position;
    ``state`` is the block's cache or state, updated in place).

    Outside decode the update leaves the block laid out as the reference
    lays out its stream after every block, ``("act_batch", "act_seq",
    None)``: a partial sum over 'model' is reduce-scattered here, so the
    next norm adds two sequence shards and, under remat, the next block's
    checkpoint keeps ``x`` and ``delta`` at 1/tp of the sequence each (the
    update whole and unreduced was the largest thing a train step kept)."""
    if mode not in ("prefill", "train", "decode"):
        raise ValueError(f"mode must be 'prefill', 'train' or 'decode', got {mode!r}")
    x, h = add_rms_norm(x, delta, bp.norm1, cfg.norm_eps)
    x = shard_act(x, ("act_batch", "act_seq", None))
    h = shard_act(h, ("act_batch", "act_seq", None))
    mla = cfg.attention == "mla"
    if kind == "attn" and mode == "decode":
        decode = attn.mla_decode if mla else attn.gqa_decode
        y, new_state = decode(bp.attn, h, cfg, state, positions)
    elif kind == "attn":
        prefill = attn.mla_prefill if mla else attn.gqa_prefill
        y, new_state = prefill(bp.attn, h, cfg, positions, make_cache=mode == "prefill")
    elif kind in _RECURRENT:
        block, decode = _RECURRENT[kind]
        if mode == "decode":
            y, ns = decode(getattr(bp, kind), h, cfg, state)
            for name, t in ns.items():
                state[name].copy_(_placed_like(t, state[name]))
            new_state = state
        else:
            y, new_state = block(getattr(bp, kind), h, cfg)
    else:
        raise ValueError(f"unknown block kind {kind!r}")
    if mode == "train":
        new_state = None
    if cross is not None:
        cp, kv = cross
        x, hc = add_rms_norm(x, y, cp.norm, cfg.norm_eps)
        y = attn.cross_attention(cp.attn, hc, kv, cfg, decode=mode == "decode")
    x, delta = _ffn_half(bp, x, y, cfg, aux if mode == "train" else None)
    if mode != "decode":
        delta = shard_act(delta, ("act_batch", "act_seq", None))
    return x, delta, new_state


def _placed_like(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``t`` redistributed to ``like``'s placements when both are DTensors
    (a recurrent state computed on head shards, written back into a cache
    laid out by the plan's cache specs)."""
    if isinstance(t, DTensor) and isinstance(like, DTensor) and t.placements != like.placements:
        return t.redistribute(like.device_mesh, like.placements)
    return t


#: The recurrent block kinds' prefill and decode functions.
_RECURRENT = {
    "mamba": (ssm.mamba_block, ssm.mamba_decode),
    "mlstm": (ssm.mlstm_block, ssm.mlstm_decode),
    "slstm": (ssm.slstm_block, ssm.slstm_decode),
}


# ---------------------------------------------------------------------------
# Stack
# ---------------------------------------------------------------------------


def block_keys(cfg: ModelConfig) -> list[tuple[str, str]]:
    """(key, kind) of each block of one period: ``("b0_mamba", "mamba")``
    ...; the keys of the reference's parameter and cache trees."""
    return [(f"b{i}_{kind}", kind) for i, kind in enumerate(cfg.pattern())]


def period_tree(cfg: ModelConfig, blocks: dict) -> dict:
    """The tree one period's module holds, from the reference's ``blocks``
    tree.  An ``("attn",)`` period's module is its one block (state-dict
    names ``blocks.<i>.attn.wq``); longer patterns keep the block keys
    (``blocks.<i>.b3_attn.attn.wq``)."""
    return blocks["b0_attn"] if cfg.pattern() == ("attn",) else blocks


def period_block(period: nn.Module, cfg: ModelConfig, key: str) -> nn.Module:
    """One block's parameters within a period's module (see
    :func:`period_tree`)."""
    return period if cfg.pattern() == ("attn",) else getattr(period, key)


def _with_rules(fn, rules):
    """``fn`` under ``rules``: a checkpointed block is recomputed inside the
    backward, which autograd runs on a device thread of its own for CUDA
    tensors, where the step's thread-local rules are not installed (every
    ``shard_act`` there would keep its input's layout)."""
    def run(*args):
        with axis_rules(rules):
            return fn(*args)
    return run


def run_decoder_stack(blocks: nn.ModuleList, x: torch.Tensor, cfg: ModelConfig,
                      mode: str, caches: dict | None = None, positions=None,
                      cross: nn.ModuleList | None = None,
                      enc_out: torch.Tensor | None = None, aux: dict | None = None,
                      remat: str = "none"):
    """Returns (x, delta, caches): the residual stream after the stack is
    ``x + delta``, the last block's update left for the final norm to add.
    ``blocks`` holds one module per period.  Caches keep the reference's
    layout, one entry per block of the period stacked along the period
    axis: ``{"b0_attn": {"k": (P, B, T, KV, hd), "v": ...}, "b1_mamba":
    {"h": (P, B, di, N), "conv": (P, B, d_conv-1, di)}}``, an MLA block's
    ``{"c_kv": (P, B, T, rank), "k_rope": (P, B, T, rope)}``, an mLSTM
    block's ``{"C": (P, B, H, dh, dh), "n": (P, B, H, dh)}``, an sLSTM
    block's ``{"h", "c", "n", "m"}`` (P, B, d).  Prefill stacks the
    periods' new caches; decode updates ``caches`` in place and returns
    it; "train" returns None and sums the MoE aux values into ``aux``.

    An encoder-decoder model passes ``cross``, one cross-attention module
    per period.  Its K/V per period, ``caches["cross_kv"]`` ``{"k": (P, B,
    T, KV, hd), "v": ...}``, are built from the encoder's output
    ``enc_out`` (B, T, d) at prefill and read from ``caches`` at decode.

    ``remat="full"`` recomputes each block in the backward of a "train"
    stack (``torch.utils.checkpoint``); "none" keeps every activation."""
    if remat not in ("none", "full"):
        raise ValueError(f"remat must be 'none' or 'full', got {remat!r}")
    keys = block_keys(cfg)
    new: dict[str, list[dict]] = {key: [] for key, _ in keys}
    cross_kv = None
    if cross is not None:
        if enc_out is not None:
            per = [attn.encoder_kv(c.attn, enc_out, cfg) for c in cross]
            cross_kv = {n: torch.stack([kv[n] for kv in per]) for n in ("k", "v")}
        elif caches is not None and "cross_kv" in caches:
            cross_kv = caches["cross_kv"]
        else:
            raise ValueError("cross-attention needs the encoder's output or cached cross_kv")
    delta = None
    for i, period in enumerate(blocks):
        cross_i = None if cross is None else (cross[i], {n: t[i] for n, t in cross_kv.items()})
        for key, kind in keys:
            state = None if caches is None else {n: c[i] for n, c in caches[key].items()}
            args = (period_block(period, cfg, key), kind, x, delta, cfg, mode, state,
                    positions, cross_i, aux)
            if remat == "full" and mode == "train":
                x, delta, ns = checkpoint(_with_rules(apply_block, current_rules()), *args,
                                          use_reentrant=False)
            else:
                x, delta, ns = apply_block(*args)
            new[key].append(ns)
    if mode == "decode":
        return x, delta, caches
    if mode == "train":
        return x, delta, None
    out = {key: {n: torch.stack([s[n] for s in per]) for n in per[0]}
           for key, per in new.items()}
    if cross_kv is not None:
        out["cross_kv"] = cross_kv
    return x, delta, out


def _encoder_layer(bp: nn.Module, x: torch.Tensor, delta: torch.Tensor | None,
                   positions: torch.Tensor, cfg: ModelConfig):
    """One encoder layer: returns (x, delta), the stream before its MLP's
    update and that update, which the next layer's first norm adds."""
    B, T, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    x, h = add_rms_norm(x, delta, bp.norm1, cfg.norm_eps)
    h = seq_whole(h)
    q = apply_rope((h @ bp.attn.wq).reshape(B, T, H, hd), positions, cfg.rope_theta)
    k = apply_rope((h @ bp.attn.wk).reshape(B, T, KV, hd), positions, cfg.rope_theta)
    v = (h @ bp.attn.wv).reshape(B, T, KV, hd)
    y = attn.call_flash(flash_attention, q, k, v, causal=False, scale=1.0 / hd ** 0.5)
    x, h = add_rms_norm(x, y.reshape(B, T, H * hd) @ bp.attn.wo, bp.norm2, cfg.norm_eps)
    return x, swiglu(h, bp.mlp.w1, bp.mlp.w3, bp.mlp.w2)


def run_encoder_stack(encoder: nn.Module, x: torch.Tensor, cfg: ModelConfig,
                      mode: str = "prefill", remat: str = "none") -> torch.Tensor:
    """The bidirectional encoder of an encoder-decoder model over ``x`` (B,
    T, d): per layer RoPE'd self-attention over all T frames (the flash
    kernel, non-causal) and a SwiGLU MLP, each after its norm, then the
    final norm.  ``encoder`` holds ``blocks`` (one module per layer:
    ``norm1``, ``attn``, ``norm2``, ``mlp``) and ``final_norm``.  As in the
    decoder stack, each residual add is fused into the norm after it.

    ``remat="full"`` recomputes each layer in the backward of a "train"
    encoder (``torch.utils.checkpoint``, the step's axis rules carried into
    the recompute), as the reference's ``jax.checkpoint`` does; "none"
    keeps every activation, and serving ("prefill") never checkpoints."""
    if remat not in ("none", "full"):
        raise ValueError(f"remat must be 'none' or 'full', got {remat!r}")
    B, T, _ = x.shape
    positions = replicated_like(torch.arange(T, device=x.device).expand(B, T), x)
    delta = None
    for bp in encoder.blocks:
        if remat == "full" and mode == "train":
            x, delta = checkpoint(_with_rules(_encoder_layer, current_rules()), bp, x, delta,
                                  positions, cfg, use_reentrant=False)
        else:
            x, delta = _encoder_layer(bp, x, delta, positions, cfg)
    return add_rms_norm(x, delta, encoder.final_norm, cfg.norm_eps)[1]
