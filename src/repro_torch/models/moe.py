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

Under the sharded steps (DTensor inputs) the layer runs in three
``local_map`` stages on each rank's tokens, with the same G and capacity
as on one device, so every drop decision is the single device's: the
router and the slots on the rank's whole dispatch groups (tokens are
replicated over 'model'); then the scatter, the experts' matmuls and the
gather back on the rank's expert weights, either its experts (EP:
"experts" over 'model', each rank fills and reads only its experts' slice
of the (G, E, C, d) buffer, the other experts' choices weighted by 0) or
its slice of every expert's ff (expert-TP).  Either way each rank's
output is a partial sum over 'model', reduced to the (G, Tg, d) tokens:
the buffer never crosses ranks.  This is the reference's ``shard_act``
layout of the dispatch buffer, G over 'data' and E over 'model'; the
sum over ranks adds a token's k outputs in another order than one device.
"""
from __future__ import annotations

from types import SimpleNamespace

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from ..configs.base import ModelConfig
from .common import ParamDef, on_shards, rule_dims, shard_index


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


def _positions(expert_ids: torch.Tensor, E: int, C: int):
    """Each (token, k) choice's slot in its expert: the flattened ids (G,
    Tk), the one-hot (G, Tk, E), the kept mask and the slot (``C - 1``
    for a dropped choice)."""
    G, Tg, k = expert_ids.shape
    flat_ids = expert_ids.reshape(G, Tg * k)                         # (G, Tk)
    # one-hot by comparison: F.one_hot checks its range on the host, a sync
    onehot = (flat_ids[..., None] == torch.arange(E, device=flat_ids.device)).to(torch.int32)
    pos_all = torch.cumsum(onehot, dim=1) - onehot
    pos = torch.gather(pos_all, 2, flat_ids[..., None])[..., 0]      # (G, Tk)
    keep = pos < C
    return flat_ids, onehot, keep, torch.where(keep, pos, C - 1)


def _local_choices(flat_ids, safe_pos, keep, first: int, El: int, C: int):
    """The choices as experts ``first .. first + El - 1`` see them: ids
    counted from ``first``, and a choice of another expert treated as a
    dropped one (expert 0, slot ``C - 1``, not kept)."""
    mask = keep & (flat_ids >= first) & (flat_ids < first + El)
    return torch.where(mask, flat_ids - first, 0), torch.where(mask, safe_pos, C - 1), mask


def _experts(xt, ids, pos, mask, w1, w3, w2, C: int, k: int):
    """Scatter the kept choices into the (G, El, C, d) buffer of the El =
    ``w1.shape[0]`` experts and run each expert's SwiGLU over its (G·C)
    rows, one batched matmul each.  Returns the experts' outputs (G, El,
    C, d).  A choice not kept adds an exact zero into its slot."""
    G, Tg, d = xt.shape
    El = w1.shape[0]
    contrib = torch.where(mask[..., None], xt.repeat_interleave(k, dim=1), 0.0)
    g_idx = torch.arange(G, device=xt.device)[:, None].expand(G, Tg * k)
    buf = xt.new_zeros((G, El, C, d))
    buf.index_put_((g_idx, ids, pos), contrib, accumulate=True)
    rows = buf.permute(1, 0, 2, 3).reshape(El, G * C, d)
    h = F.silu(torch.bmm(rows, w1)) * torch.bmm(rows, w3)            # (El, G·C, ff)
    return torch.bmm(h, w2).reshape(El, G, C, d).permute(1, 0, 2, 3)


def _combine(out_buf, flat_ids, safe_pos, keep, gate_vals, k: int, dtype):
    """Gather each choice's expert output back and sum a token's k
    outputs weighted by their gates (0 for a dropped choice): (G, Tg, d)."""
    G, Tk = flat_ids.shape
    d = out_buf.shape[-1]
    g_idx = torch.arange(G, device=out_buf.device)[:, None].expand(G, Tk)
    y_rep = out_buf[g_idx, flat_ids, safe_pos]                       # (G, Tk, d)
    w = keep.to(dtype) * gate_vals.reshape(G, Tk).to(dtype)
    return (y_rep * w[..., None]).reshape(G, Tk // k, k, d).sum(dim=2)


def moe_ffn(p, x: torch.Tensor, cfg: ModelConfig, need_aux: bool = True):
    """x: (B, S, d) -> (y, aux).  ``p`` holds :func:`moe_defs`' leaves of
    one layer as attributes (``router`` (d, E), ``w1``/``w3`` (E, d, ff),
    ``w2`` (E, ff, d)).  ``aux`` holds the load-balance loss ``lb_loss``,
    the router z-loss ``z_loss`` and the dropped share of the (token, k)
    choices ``dropped_frac``, as 0-d fp32 tensors; ``need_aux=False``
    skips them (the reference computes them and serving drops them) and
    returns None.  DTensor inputs run :func:`_moe_on_shards`."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.experts_per_token
    T = B * S
    G = _moe_groups(cfg, T)
    Tg = T // G
    C = capacity(cfg, Tg)
    if isinstance(x, DTensor):
        return _moe_on_shards(p, x, cfg, G, C, need_aux)
    xt = x.reshape(G, Tg, d)
    logits, probs, gate_vals, expert_ids = route(p, xt, cfg)
    flat_ids, onehot, keep, safe_pos = _positions(expert_ids, E, C)
    out_buf = _experts(xt, flat_ids, safe_pos, keep, p.w1, p.w3, p.w2, C, k)
    y = _combine(out_buf, flat_ids, safe_pos, keep, gate_vals, k, x.dtype).reshape(B, S, d)
    if not need_aux:
        return y, None
    return y, _aux(logits, probs, onehot.sum(dim=(0, 1)).to(torch.float32), keep, T, cfg)


def _aux(logits, probs, counts, keep, T: int, cfg: ModelConfig) -> dict:
    """The load-balance loss from the mean router probability and each
    expert's share of the (token, k) choices (``counts``, summed over the
    T tokens), the router z-loss and the dropped share."""
    E, k = cfg.n_experts, cfg.experts_per_token
    me = probs.mean(dim=(0, 1))
    ce = counts / T / k
    return {"lb_loss": E * torch.sum(me * ce),
            "z_loss": torch.mean(torch.logsumexp(logits, dim=-1) ** 2),
            "dropped_frac": 1.0 - keep.to(torch.float32).mean()}


def _moe_on_shards(p, x: DTensor, cfg: ModelConfig, G: int, C: int, need_aux: bool):
    """:func:`moe_ffn` on DTensors, in two stages on local shards.  A mesh
    dim that splits x's batch keeps it split where each rank then holds
    whole dispatch groups (G divides over it); a mesh dim that the rules'
    "experts" (EP) or "expert_ff" (expert-TP) names splits the expert
    weights; any other dim is replicated.

    A batch dim that G does not divide (``moe_groups`` 16 over 'pod' and
    'data', 2 x 16 ranks) still splits the groups, unevenly, as GSPMD pads
    the (G, ...) buffers: x is gathered over it, and its rank ``i`` of
    ``n`` routes and runs groups ``i·c ... i·c + c - 1`` of its whole
    ones (``c = ceil(G_local / n)``; none for a rank past the last).  The
    routing outputs and the experts' output then hold the rank's own
    groups and zeros elsewhere, a partial sum over those dims, whose
    gradients come back whole to every rank; the output is reduced back
    onto x's batch shards."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.experts_per_token
    T = B * S
    Tg = T // G
    mesh = x.device_mesh
    ep = rule_dims(mesh, "experts")
    tp = [i for i in rule_dims(mesh, "expert_ff") if i not in ep]
    shard, _ = shard_index(mesh, ep)
    R = Replicate()
    tok, count = [], 1
    for i, pl in enumerate(x.placements):
        n = count * mesh.size(i)
        split = pl == Shard(0) and i not in ep + tp and G % n == 0 and B % n == 0
        tok.append(Shard(0) if split else R)
        count = n if split else count
    # the batch dims that split groups unevenly, and this rank's own groups
    grp = [i for i, pl in enumerate(x.placements)
           if pl == Shard(0) and i not in ep + tp and tok[i] == R]
    index, n_grp = shard_index(mesh, grp)
    local_groups = G // count
    per_rank = -(-local_groups // n_grp)
    lo = min(local_groups, index * per_rank)
    hi = min(local_groups, lo + per_rank)
    own = [Partial() if i in grp else t for i, t in enumerate(tok)]   # zeros off the own groups
    per_token = [Partial() if t == Shard(0) else o for t, o in zip(tok, own)]   # a sum over tokens
    rep = [R] * mesh.ndim
    back = [Shard(0) if i in grp else t for i, t in enumerate(tok)]
    x = x.redistribute(mesh, tok)       # each rank's whole groups, the sequence whole

    def role(i, ep_pl, tp_pl, other):
        return ep_pl if i in ep else tp_pl if i in tp else other

    def filled(t):
        """``t`` (the own groups' rows) in a zero tensor of every local group;
        ``t`` itself where the rank's groups are all its local ones."""
        if not grp:
            return t
        whole = t.new_zeros((local_groups, *t.shape[1:]))
        whole[lo:hi] = t
        return whole

    # 1. route the rank's own groups; the slots depend only on the ids
    def route_local(xl, router):
        xt = xl.reshape(-1, Tg, d)[lo:hi]
        logits, probs, gate_vals, expert_ids = route(SimpleNamespace(router=router), xt, cfg)
        flat_ids, onehot, keep, safe_pos = _positions(expert_ids, E, C)
        counts = onehot.sum(dim=(0, 1)).to(torch.float32)
        return (filled(logits), filled(probs), filled(gate_vals), filled(flat_ids),
                filled(keep.to(torch.int32)), filled(safe_pos), counts)

    logits, probs, gate_vals, flat_ids, keep, safe_pos, counts = on_shards(
        route_local, (x, p.router), (tok, rep), (own,) * 6 + (per_token,),
        (own, per_token))

    # 2. scatter into the rank's experts (or ff slice), run them and gather
    # back: a partial sum over the expert dims, then reduced
    w13 = [role(i, Shard(0), Shard(2), R) for i in range(mesh.ndim)]
    w2_ = [role(i, Shard(0), Shard(1), R) for i in range(mesh.ndim)]
    part = [role(i, Partial(), Partial(), t) for i, t in enumerate(own)]
    w_grad = [[role(i, w[i], w[i], g) for i, g in enumerate(per_token)] for w in (w13, w2_)]

    def experts_local(xl, ids, pos, kp, gates, w1, w3, w2):
        xt = xl.reshape(-1, Tg, d)
        ids, pos, kp, gates = ids[lo:hi], pos[lo:hi], kp[lo:hi].bool(), gates[lo:hi]
        El = w1.shape[0]
        if El < E:
            ids, pos, kp = _local_choices(ids, pos, kp, shard * El, El, C)
        out_buf = _experts(xt[lo:hi], ids, pos, kp, w1, w3, w2, C, k)
        y = _combine(out_buf, ids, pos, kp, gates, k, x.dtype)
        return filled(y).reshape(-1, S, d)

    y = on_shards(experts_local, (x, flat_ids, safe_pos, keep, gate_vals, p.w1, p.w3, p.w2),
                  (tok,) + (own,) * 4 + (w13, w13, w2_), part,
                  (part, own, own, own, part, w_grad[0], w_grad[0], w_grad[1]))
    y = y.redistribute(mesh, back)
    if not need_aux:
        return y, None
    return y, _aux(logits, probs, counts, keep, T, cfg)
