"""Mixture-of-Experts feed-forward: top-k router and capacity-bounded
scatter dispatch, as the reference computes it (``models/moe.py``).

Tokens are split into G dispatch groups (G halves from ``cfg.moe_groups``
until it divides the token count), each with its own capacity
``C = max(1, round(Tg·k/E·cf))`` (Python's ``round``, half to even).  A
token's place in an expert is the exclusive running count of that expert
over the group's flattened ``(token, k)`` choices; choices at or past the
capacity are dropped: their contribution is zeroed, sent to slot ``C - 1``
and weighted by 0 on the way back.  Every expert's SwiGLU runs over its
whole (G, C) buffer, as the reference's einsums do.

The reference computes all of this in plain jnp outside any Pallas
kernel, so the port keeps library calls here: ``index_put_`` with
``accumulate=True`` for the scatter (exact: each kept slot receives one
token and exact zeros) and batched fp32 matmuls for the experts.  The
router's top-k takes the lower expert index first among equal
probabilities, as ``lax.top_k`` does (a stable descending sort).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from .common import ParamDef, shard_act


def moe_defs(cfg: ModelConfig, stack: int) -> dict:
    d, ff, E = cfg.d_model, cfg.expert_ff, cfg.n_experts
    L = (stack,)
    lax_ = ("layers",)
    return {
        "router": ParamDef(L + (d, E), lax_ + ("embed_w", None), scale=0.1),
        "w1": ParamDef(L + (E, d, ff), lax_ + ("experts", "embed_w", "expert_ff")),
        "w3": ParamDef(L + (E, d, ff), lax_ + ("experts", "embed_w", "expert_ff")),
        "w2": ParamDef(L + (E, ff, d), lax_ + ("experts", "expert_ff", "embed_w")),
    }


def _moe_groups(cfg: ModelConfig, T: int) -> int:
    """Dispatch-group count: ``cfg.moe_groups`` halved until it divides
    ``T`` (at least 1)."""
    g = cfg.moe_groups
    while g > 1 and T % g != 0:
        g //= 2
    return max(g, 1)


def capacity(cfg: ModelConfig, tokens_per_group: int) -> int:
    """Slots per expert and group: ``max(1, round(Tg·k/E·cf))``."""
    E, k = cfg.n_experts, cfg.experts_per_token
    return int(max(1, round(tokens_per_group * k / E * cfg.capacity_factor)))


def route(p, xt: torch.Tensor, cfg: ModelConfig):
    """The router on grouped tokens ``xt`` (G, Tg, d): fp32 logits (G, Tg,
    E), their softmax, and the top-k gates (renormalised by ``max(sum,
    1e-9)``) and expert ids (G, Tg, k), largest probability first and the
    lower expert index first among equal ones."""
    k = cfg.experts_per_token
    logits = (xt @ p.router).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    sorted_probs, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, expert_ids = sorted_probs[..., :k], order[..., :k]
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    return logits, probs, gate_vals, expert_ids


def moe_ffn(p, x: torch.Tensor, cfg: ModelConfig, need_aux: bool = True):
    """x: (B, S, d) -> (y, aux).  ``p`` holds :func:`moe_defs`' leaves of
    one layer as attributes (``router`` (d, E), ``w1``/``w3`` (E, d, ff),
    ``w2`` (E, ff, d)).  ``aux`` holds the load-balance loss ``lb_loss``,
    the router z-loss ``z_loss`` and the dropped share of the (token, k)
    choices ``dropped_frac``, as 0-d fp32 tensors; ``need_aux=False``
    skips them (the reference computes them and serving drops them) and
    returns None."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.experts_per_token
    T = B * S
    G = _moe_groups(cfg, T)
    Tg = T // G
    C = capacity(cfg, Tg)
    xt = shard_act(x.reshape(G, Tg, d), ("act_batch", None, None))
    logits, probs, gate_vals, expert_ids = route(p, xt, cfg)

    flat_ids = expert_ids.reshape(G, Tg * k)                         # (G, Tk)
    # one-hot by comparison: F.one_hot checks its range on the host, a sync
    onehot = (flat_ids[..., None] == torch.arange(E, device=x.device)).to(torch.int32)
    pos_all = torch.cumsum(onehot, dim=1) - onehot
    pos = torch.gather(pos_all, 2, flat_ids[..., None])[..., 0]      # (G, Tk)
    keep = pos < C
    safe_pos = torch.where(keep, pos, C - 1)

    # scatter the kept choices into (G, E, C, d)
    contrib = torch.where(keep[..., None], xt.repeat_interleave(k, dim=1), 0.0)
    g_idx = torch.arange(G, device=x.device)[:, None].expand(G, Tg * k)
    buf = x.new_zeros((G, E, C, d))
    buf.index_put_((g_idx, flat_ids, safe_pos), contrib, accumulate=True)
    buf = shard_act(buf, ("act_batch", "experts_act", None, None))

    # every expert's SwiGLU over its (G·C) rows, one batched matmul each
    rows = buf.permute(1, 0, 2, 3).reshape(E, G * C, d)
    h = F.silu(torch.bmm(rows, p.w1)) * torch.bmm(rows, p.w3)
    h = shard_act(h, ("experts_act", None, "expert_act_ff"))        # (E, G·C, ff)
    out_buf = torch.bmm(h, p.w2).reshape(E, G, C, d).permute(1, 0, 2, 3)
    out_buf = shard_act(out_buf, ("act_batch", "experts_act", None, None))

    # gather back and gate
    y_rep = out_buf[g_idx, flat_ids, safe_pos]                       # (G, Tk, d)
    w = keep.to(x.dtype) * gate_vals.reshape(G, Tg * k).to(x.dtype)
    y = (y_rep * w[..., None]).reshape(G, Tg, k, d).sum(dim=2).reshape(B, S, d)
    if not need_aux:
        return y, None

    me = probs.reshape(T, E).mean(dim=0)
    ce = onehot.reshape(T, k, E).sum(1).to(torch.float32).mean(0) / k
    aux = {"lb_loss": E * torch.sum(me * ce),
           "z_loss": torch.mean(torch.logsumexp(logits, dim=-1) ** 2),
           "dropped_frac": 1.0 - keep.to(torch.float32).mean()}
    return y, aux
