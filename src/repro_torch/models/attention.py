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

Multi-head latent attention (MLA, minicpm3) keeps a compressed cache, the
normed latent ``c_kv`` and one shared RoPE key per token.  Its prefill
assembles per-head q and k as ``[nope ‖ rope]`` and runs the same flash
kernel (v zero-padded to the q/k width, the output sliced back), its two
latent norms run the RMSNorm kernel, and its decode attends to the
compressed cache directly with ``wk_up`` absorbed into the query, in plain
torch as in the reference.

Under the sharded steps (:mod:`repro_torch.launch.steps`) the flash
kernel and the MLA norms run on each rank's local shards
(:func:`call_flash`, :func:`~.common.call_norm`), and GQA decode against a
DTensor cache whose time axis is sharded combines each rank's partial
softmax as flash-decoding does (:func:`gqa_decode_seqsharded` is that
combine over one process group, on local tensors).  MLA prefill whose
heads do not divide the ranks of 'model' splits the keys over them
instead (:func:`key_shard_attention`), as the reference's score tensors
are split on the key axis.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from ..configs.base import MLAConfig, ModelConfig
from ..kernels.flash_attention import (
    flash_attention,
    flash_attention_backward,
    flash_attention_with_lse,
)
from ..kernels.rmsnorm import rmsnorm
from .common import (
    ParamDef,
    apply_rope,
    call_norm,
    current_rules,
    input_whole,
    merge_heads,
    on_shards,
    replicated_like,
    rule_dims,
    seq_whole,
    shard_act,
    shard_index,
    softmax_fp32,
    split_heads,
)

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


def mla_defs(cfg: ModelConfig, stack: int) -> dict:
    m = cfg.mla or MLAConfig()
    d, H = cfg.d_model, cfg.n_heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    L = (stack,)
    lax_ = ("layers",)
    return {
        "wq_down": ParamDef(L + (d, m.q_lora_rank), lax_ + ("embed_w", "rank")),
        "q_norm": ParamDef(L + (m.q_lora_rank,), lax_ + (None,), init="ones"),
        "wq_up": ParamDef(L + (m.q_lora_rank, H * qk), lax_ + ("rank", "heads_w")),
        "wkv_down": ParamDef(
            L + (d, m.kv_lora_rank + m.qk_rope_head_dim), lax_ + ("embed_w", None)
        ),
        "kv_norm": ParamDef(L + (m.kv_lora_rank,), lax_ + (None,), init="ones"),
        "wk_up": ParamDef(
            L + (m.kv_lora_rank, H * m.qk_nope_head_dim), lax_ + ("rank", "heads_w")
        ),
        "wv_up": ParamDef(
            L + (m.kv_lora_rank, H * m.v_head_dim), lax_ + ("rank", "heads_w")
        ),
        "wo": ParamDef(L + (H * m.v_head_dim, d), lax_ + ("heads_w", "embed_w")),
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
    score_axes = ("act_batch", "act_heads", None, None)
    k = shard_act(k, ("act_batch", None, "act_heads", None))
    v = shard_act(v, ("act_batch", None, "act_heads", None))
    scores = shard_act(torch.einsum("bsnh,btnh->bnst", q, k) * scale, score_axes)
    mask = mask[None, None] if mask.dim() == 2 else mask[:, None]
    scores = torch.where(mask, scores.to(torch.float32), -1e30)
    p = shard_act(softmax_fp32(scores), score_axes)
    return torch.einsum("bnst,btnh->bsnh", p.to(v.dtype), v)


def call_flash(kernel, q, k, v, **options) -> torch.Tensor:
    """``kernel(q, k, v, **options)`` (the flash-attention kernel), or on
    each rank's local shards when ``q`` is a DTensor.  Per mesh dim the
    call keeps q's batch shard, or its head shard where k's heads are
    sharded on that dim too (each rank's query heads then read its own
    kv heads); everything else, the sequence and head dim always, is
    gathered whole first.

    Where q's heads are sharded and k's are not (fewer kv heads than
    ranks: llama3-8b's 8 at tp 16), q keeps its head shard and each rank
    takes, from k and v gathered whole, the kv heads its own query heads
    read, as GSPMD slices them; their gradients add up over those ranks
    (``Partial``).  This needs each rank's query heads to read whole kv
    heads, i.e. a rank's heads and a kv group's to divide one another;
    else q is gathered too."""
    if not isinstance(q, DTensor):
        return kernel(q, k, v, **options)
    k, v = replicated_like(k, q), replicated_like(v, q)
    H, KV = q.shape[2], k.shape[2]
    group = H // KV
    own = [i for i, (qp, kp) in enumerate(zip(q.placements, k.placements))
           if qp == Shard(2) and kp != Shard(2)]
    local_heads = H // math.prod(q.device_mesh.size(i) for i in own) if own else H
    if own and (group % local_heads and local_heads % group):
        own = []
    pl, kv_pl, kv_grad = [], [], []
    for i, (qp, kp) in enumerate(zip(q.placements, k.placements)):
        if qp == Shard(0) or (qp == Shard(2) and kp == Shard(2)):
            pl.append(qp)
            kv_pl.append(qp)
            kv_grad.append(qp)
        elif i in own:
            pl.append(qp)
            kv_pl.append(Replicate())
            kv_grad.append(Partial())
        else:
            pl.append(Replicate())
            kv_pl.append(Replicate())
            kv_grad.append(Replicate())
    if not own:
        return on_shards(
            lambda ql, kl, vl: kernel(ql.contiguous(), kl.contiguous(), vl.contiguous(), **options),
            (q, k, v), (pl, pl, pl), pl)
    idx, _ = shard_index(q.device_mesh, own)
    first, n_kv = idx * local_heads // group, max(1, local_heads // group)

    def local(ql, kl, vl):
        kl, vl = kl[:, :, first:first + n_kv], vl[:, :, first:first + n_kv]
        return kernel(ql.contiguous(), kl.contiguous(), vl.contiguous(), **options)

    return on_shards(local, (q, k, v), (pl, kv_pl, kv_pl), pl, (pl, kv_grad, kv_grad))


def gqa_prefill(p, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor,
                make_cache: bool = False):
    """Full-sequence causal attention.  ``p`` holds ``wq``, ``wk``, ``wv``
    and ``wo`` as attributes.  Returns (out, cache|None)."""
    x = seq_whole(x)
    B, S, d = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = split_heads(x @ p.wq, B, S, H, hd)
    k = split_heads(x @ p.wk, B, S, KV, hd)
    v = split_heads(x @ p.wv, B, S, KV, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    # SP hands off to TP here: seq gathers, heads shard (Megatron-SP style)
    q = shard_act(q, ("act_batch", None, "act_heads", None))
    k = shard_act(k, ("act_batch", None, "act_kv", None))
    out = call_flash(flash_attention, q, k, v, causal=True, window=cfg.sliding_window,
                     scale=1.0 / hd ** 0.5)
    out = merge_heads(out) @ p.wo
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

    A DTensor cache (the sharded decode step) is updated and attended on
    each rank's local shard (:func:`_decode_on_shards`).
    """
    B, S, d = x.shape
    if S != 1:
        raise ValueError(f"decode takes one token per row, got {S}")
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    T = cache["k"].shape[1]
    q = split_heads(x @ p.wq, B, 1, H, hd)
    k = split_heads(x @ p.wk, B, 1, KV, hd)
    v = split_heads(x @ p.wv, B, 1, KV, hd)
    posb = replicated_like(torch.full((B, 1), pos, dtype=torch.int32, device=x.device), x)
    q = apply_rope(q, posb, cfg.rope_theta)
    k = apply_rope(k, posb, cfg.rope_theta)
    if isinstance(cache["k"], DTensor):
        out = _decode_on_shards(q, k, v, cache, cfg, pos)
        return merge_heads(out) @ p.wo, cache
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
    out = merge_heads(out) @ p.wo
    return out, cache


def _partial_attend(q, ck, cv, valid, reduce, scale: float | None = None) -> torch.Tensor:
    """Decode attention of ``q`` (B, 1, H, hd) over one slice of the cache
    ``ck`` (B, Tl, KV, hd) and ``cv`` (B, Tl, KV, hd_v), positions where
    ``valid`` (Tl,) is False masked at -1e30, the scores scaled by
    ``scale`` (1/sqrt(hd) by default): each slice's softmax statistics,
    then ``reduce(t, op)`` ("max" or "sum" across the slices) combines
    them as the reference's ``pmax`` and ``psum`` do.  Returns (B, 1, H,
    hd_v) in q's dtype."""
    B, _, H, hd = q.shape
    KV = ck.shape[2]
    G = H // KV
    qg = q.reshape(B, 1, KV, G, hd)
    scale = 1.0 / hd ** 0.5 if scale is None else scale
    scores = torch.einsum("bskgh,btkh->bkgst", qg, ck) * scale
    scores = torch.where(valid[None, None, None, None, :], scores.to(torch.float32), -1e30)
    m_loc = scores.amax(dim=-1, keepdim=True)
    e = torch.exp(scores - m_loc)
    num_loc = torch.einsum("bkgst,btkh->bskgh", e.to(cv.dtype), cv).to(torch.float32)
    den_loc = e.sum(dim=-1)[..., None]                    # (B, KV, G, 1, 1)
    m_glob = reduce(m_loc, "max")
    corr = torch.exp(m_loc - m_glob)                       # (B, KV, G, 1, 1)
    num = reduce(num_loc * corr.movedim(-2, 1), "sum")    # (B, 1, KV, G, hd)
    den = reduce(den_loc * corr, "sum").movedim(-2, 1)
    return (num / torch.clamp_min(den, 1e-30)).to(q.dtype).reshape(B, 1, H, cv.shape[-1])


def _all_reduce(groups):
    """``reduce(t, op)`` for :func:`_partial_attend`: ``t`` all-reduced
    (MAX or SUM) over each process group in turn, out of place."""
    ops = {"max": dist.ReduceOp.MAX, "sum": dist.ReduceOp.SUM}

    def reduce(t, op):
        t = t.clone()
        for g in groups:
            dist.all_reduce(t, op=ops[op], group=g)
        return t

    return reduce


def gqa_decode_seqsharded(p, x: torch.Tensor, cfg: ModelConfig, cache: dict, pos: int,
                          group):
    """Flash-decoding over a sequence-sharded KV cache, on local tensors:
    ``cache["k"]``/``["v"]`` (B, Tl, KV, hd) are this rank's slice of the
    time axis, rank ``r`` of ``group`` (the process group of the mesh dim
    the reference calls ``axis_name``, e.g. ``mesh.get_group("data")``)
    holding positions ``r·Tl`` ... ``(r+1)·Tl - 1``.  Each rank attends
    over its slice and the partial statistics are combined by all-reduce,
    MAX then SUM, as the reference's ``pmax`` and ``psum``.  The new
    token's K/V is written in place, on the rank that owns slot ``pos``
    only.  Returns (out (B, 1, d), cache)."""
    B, S, d = x.shape
    if S != 1:
        raise ValueError(f"decode takes one token per row, got {S}")
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    Tl = cache["k"].shape[1]
    shard = dist.get_rank(group)
    q = split_heads(x @ p.wq, B, 1, H, hd)
    k_new = split_heads(x @ p.wk, B, 1, KV, hd)
    v_new = split_heads(x @ p.wv, B, 1, KV, hd)
    posb = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q = apply_rope(q, posb, cfg.rope_theta)
    k_new = apply_rope(k_new, posb, cfg.rope_theta)
    if pos // Tl == shard:
        cache["k"][:, pos % Tl] = k_new[:, 0]
        cache["v"][:, pos % Tl] = v_new[:, 0]
    valid = shard * Tl + torch.arange(Tl, device=x.device) <= pos
    out = _partial_attend(q, cache["k"], cache["v"], valid, _all_reduce([group]))
    return merge_heads(out) @ p.wo, cache


def _time_split(cache: DTensor):
    """How a DTensor cache's time axis (dim 1) lies on its mesh: the
    placements that bring a decode step's other inputs whole to every rank
    (the cache's batch shard kept), the number of shards that the mesh
    dims splitting the time axis cut it into (in mesh order), this rank's
    index among them, and the ``reduce`` of :func:`_partial_attend` over
    those mesh dims."""
    mesh = cache.device_mesh
    pl = [pc if pc == Shard(0) else Replicate() for pc in cache.placements]
    dims = [i for i, pc in enumerate(cache.placements) if pc == Shard(1)]
    shard, nsh = shard_index(mesh, dims)
    return pl, nsh, shard, _all_reduce([mesh.get_group(i) for i in dims])


def _decode_on_shards(q, k, v, cache: dict, cfg: ModelConfig, pos: int) -> torch.Tensor:
    """:func:`gqa_decode`'s cache write and attention on each rank's local
    shard of a DTensor cache (B, T, KV, hd): q, k and v (replicated but for
    the cache's batch shard) come in whole.  Where the cache's time axis
    is not split the shard runs the single-device write and core as they
    are; where it is (:func:`_time_split`), the rank owning the slot
    writes it and the partial softmaxes are combined as in
    :func:`gqa_decode_seqsharded`.  Returns the attention output (B, 1, H,
    hd)."""
    ck = cache["k"]
    T = ck.shape[1]
    window = cfg.sliding_window
    slot = min(max(pos % T if window is not None else pos, 0), T - 1)
    pl, nsh, shard, reduce = _time_split(ck)

    def attend(ql, kl, vl, ckl, cvl):
        B = ql.shape[0]
        if nsh == 1:
            ckl[:, slot] = kl[:, 0]
            cvl[:, slot] = vl[:, 0]
            if window is not None:
                valid = torch.ones(T, dtype=torch.bool, device=ql.device)
            else:
                valid = torch.arange(T, device=ql.device) <= pos
            mask = valid[None, None, :].expand(B, 1, T)
            return _gqa_core(ql, ckl, cvl, mask, 1.0 / ql.shape[-1] ** 0.5)
        Tl = ckl.shape[1]
        if slot // Tl == shard:
            ckl[:, slot % Tl] = kl[:, 0]
            cvl[:, slot % Tl] = vl[:, 0]
        gpos = shard * Tl + torch.arange(Tl, device=ql.device)
        valid = torch.ones_like(gpos, dtype=torch.bool) if window is not None else gpos <= pos
        return _partial_attend(ql, ckl, cvl, valid, reduce)

    return on_shards(attend, (q, k, v, ck, cache["v"]),
                     (pl, pl, pl, ck.placements, cache["v"].placements), pl)


# ---------------------------------------------------------------------------
# Causal attention split over the keys
# ---------------------------------------------------------------------------


def _padded_to(t, width: int | None):
    """``t`` contiguous, its last axis zero-padded to ``width`` where it is
    narrower (the kernel takes one head width for q, k and v)."""
    if width is not None and t.shape[-1] < width:
        t = F.pad(t, (0, width - t.shape[-1]))
    return t.contiguous()


def key_chunks(S: int, index: int, count: int) -> list[tuple[int, int]]:
    """The key positions ``[start, stop)`` that shard ``index`` of ``count``
    takes of a causal attention over ``S`` keys: chunks ``index`` and ``2 ·
    count - 1 - index`` of ``2 · count`` near-equal chunks, so every shard
    scores about the same number of visible (query, key) pairs (contiguous
    shards would give the first ``2 - 1/count`` times the mean); the
    whole sequence for one shard.  Empty chunks are left out."""
    if count == 1:
        return [(0, S)]
    n = 2 * count
    cuts = [(j * S // n, (j + 1) * S // n) for j in (index, n - 1 - index)]
    return [(a, b) for a, b in cuts if b > a]


def combine_partials(parts, reduce=None):
    """``(out, lse)`` of the attention over every key from partial results
    ``parts``, each ``(out (B, S, H, w), lse (B, H, S))`` over some of the
    keys (a row that sees none of them: out 0, lse -1e30): each part
    weighted by ``exp(lse_part - lse)``, ``lse`` their log-sum-exp, in
    fp32.  ``reduce(t, op)`` ("max" or "sum") combines the statistics and
    the weighted sums across ranks holding other keys (as
    :func:`_partial_attend`'s); None when ``parts`` hold every key.
    ``out`` comes back in the parts' dtype, ``lse`` in fp32."""
    reduce = reduce or (lambda t, op: t)
    m = reduce(torch.stack([lse for _, lse in parts]).amax(dim=0), "max")
    total = reduce(sum(torch.exp(lse - m) for _, lse in parts), "sum")
    lse = m + torch.log(total)
    out = reduce(sum(o.float() * torch.exp(l - lse).transpose(1, 2)[..., None]
                     for o, l in parts), "sum")
    return out.to(parts[0][0].dtype), lse


def key_shard_forward(q, k, v, index: int, count: int, scale: float):
    """Shard ``index`` of ``count``'s partial results over its keys
    (:func:`key_chunks`): for each chunk the flash kernel's output and row
    log-sum-exps (``flash_attention_with_lse`` with the chunk's key
    offset), q (B, S, H, w) every query row, k and v (B, S, KV, w) the
    whole sequence's keys.  :func:`combine_partials` joins them."""
    return [flash_attention_with_lse(q, k[:, a:b].contiguous(), v[:, a:b].contiguous(),
                                     causal=True, scale=scale, key_offset=a)
            for a, b in key_chunks(k.shape[1], index, count)]


def key_shard_backward(q, k, v, out, dout, lse, index: int, count: int, scale: float):
    """Shard ``index`` of ``count``'s part of the gradients ``(dq, dk, dv)``
    of causal attention split over the keys, given the combined ``out``
    and ``lse`` (:func:`combine_partials`) and ``dout``: the flash backward
    kernel on each of its key chunks with the whole row's statistics (the
    ring-attention form).  dq is this shard's part of the sum over the
    shards, dk and dv hold its own keys' gradients and zeros elsewhere."""
    dq = torch.zeros_like(q, dtype=torch.float32)
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for a, b in key_chunks(k.shape[1], index, count):
        dqa, dk[:, a:b], dv[:, a:b] = flash_attention_backward(
            q, k[:, a:b].contiguous(), v[:, a:b].contiguous(), out, dout, causal=True,
            scale=scale, lse=lse, key_offset=a)
        dq += dqa
    return dq.to(q.dtype), dk, dv


class _KeyShardAttention(torch.autograd.Function):
    """Causal attention of q over this shard's keys, combined across the
    shards: :func:`key_shard_forward` then :func:`combine_partials`; the
    backward :func:`key_shard_backward` with the combined statistics."""

    @staticmethod
    def forward(ctx, q, k, v, index, count, scale, reduce):
        out, lse = combine_partials(key_shard_forward(q, k, v, index, count, scale), reduce)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.options = (index, count, scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = key_shard_backward(q, k, v, out, dout.contiguous(), lse, *ctx.options)
        return dq, dk, dv, None, None, None, None


def key_shard_attention(q, k, v, dims: list[int], scale: float, width: int | None = None):
    """Causal attention of DTensors q (B, S, H, hd) and k, v (B, S, KV, hd)
    split over the keys across the mesh dims ``dims``: each rank keeps its
    batch shard, takes every query row and head and the whole keys, runs
    the flash kernel on its own key chunks (:func:`key_chunks`) and the
    partial softmaxes are combined across ``dims`` (:func:`combine_partials`).
    q's gradient is then a partial sum over ``dims``, as are k's and v's
    (each rank's keys).  ``width`` zero-pads every head to that width for
    the kernel (MLA's v) and cuts the output back to v's."""
    mesh = q.device_mesh
    index, count = shard_index(mesh, dims)
    reduce = _all_reduce([mesh.get_group(i) for i in dims])
    rows = [p if p == Shard(0) else Replicate() for p in q.placements]
    grad = [Partial() if i in dims else p for i, p in enumerate(rows)]
    dv = v.shape[-1]

    def local(ql, kl, vl):
        ql, kl, vl = (_padded_to(t, width) for t in (ql, kl, vl))
        out = _KeyShardAttention.apply(ql, kl, vl, index, count, scale, reduce)
        return out[..., :dv].contiguous()

    return on_shards(local, (q, k, v), (rows, rows, rows), rows, (grad, grad, grad))


# ---------------------------------------------------------------------------
# MLA (MiniCPM3 / DeepSeek-style latent attention)
# ---------------------------------------------------------------------------


def _mla_qkv(p, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor,
             own_rows: bool = False):
    """The query halves (B, S, H, nope) and (B, S, H, rope), RoPE'd, and
    the cache entries: the normed latent ``c_kv`` (B, S, rank) and the
    shared RoPE key ``k_rope`` (B, S, rope).  Both latent norms run the
    RMSNorm kernel on the card, on each rank's rows of a DTensor (the
    rank axis whole).  ``wq_up``'s output axis (H·(nope+rope), split by
    ``heads_w``) reshapes to (H, nope+rope) on head boundaries.
    ``own_rows`` (decode) gathers the FSDP-sharded down-projections
    instead of the rows (:func:`~.common.input_whole`), so each rank
    projects and norms its own batch rows only."""
    m = cfg.mla or MLAConfig()
    x = seq_whole(x)
    B, S, _ = x.shape
    H = cfg.n_heads
    wq_down, wkv_down = p.wq_down, p.wkv_down
    if own_rows:
        wq_down, wkv_down = input_whole(wq_down), input_whole(wkv_down)
    q = call_norm(rmsnorm, x @ wq_down, p.q_norm, cfg.norm_eps) @ p.wq_up
    q = split_heads(q, B, S, H, m.qk_nope_head_dim + m.qk_rope_head_dim)
    q_nope, q_rope = q.split([m.qk_nope_head_dim, m.qk_rope_head_dim], dim=-1)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    c_kv, k_rope = (x @ wkv_down).split([m.kv_lora_rank, m.qk_rope_head_dim], dim=-1)
    c_kv = call_norm(rmsnorm, c_kv.contiguous(), p.kv_norm, cfg.norm_eps)
    k_rope = apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)[:, :, 0, :]
    return q_nope, q_rope, c_kv, k_rope


def mla_prefill(p, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor,
                make_cache: bool = False):
    """Causal MLA over the whole sequence through the flash kernel: q and
    k per head are ``[nope ‖ rope]`` (the rope key shared by every head),
    scaled by ``1/sqrt(nope + rope)``.  The kernel takes one head width
    for q, k and v, so the narrower side is zero-padded to the wider (v
    from 64 to 96 at minicpm3's widths; zero columns add nothing to q·k
    and give zero output columns) and the output is cut back to
    ``v_head_dim``.  Returns (out, cache|None), the cache ``{"c_kv": (B, S,
    rank), "k_rope": (B, S, rope)}``.

    On DTensors q, k and v are laid out by ``act_heads``: where the heads
    divide tp, :func:`call_flash` keeps the head shard; where they do not
    and ``act_seq`` names mesh dims, the attention is split over the keys
    across those dims (:func:`key_shard_attention`), as the reference
    shards its score tensors on the key axis
    (``("act_batch", None, None, "act_seq")``); otherwise every rank runs
    every head of its batch shard.  The padding and the cut run with the
    kernel on each rank's local shards."""
    m = cfg.mla or MLAConfig()
    B, S, _ = seq_whole(x).shape
    H = cfg.n_heads
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(p, x, cfg, positions)
    k_nope = split_heads(c_kv @ p.wk_up, B, S, H, m.qk_nope_head_dim)
    v = split_heads(c_kv @ p.wv_up, B, S, H, m.v_head_dim)
    qf = torch.cat([q_nope, q_rope], dim=-1)                           # (B, S, H, qk)
    kf = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, H, m.qk_rope_head_dim)],
                   dim=-1)
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    width = max(qk, m.v_head_dim)

    def padded(q, k, v, **options):
        q, k, v = (_padded_to(t, width) for t in (q, k, v))
        return flash_attention(q, k, v, **options)[..., :m.v_head_dim].contiguous()

    heads = ("act_batch", None, "act_heads", None)
    qf, kf, v = (shard_act(t, heads) for t in (qf, kf, v))
    keys = (rule_dims(qf.device_mesh, "act_seq") if isinstance(qf, DTensor)
            and (current_rules() or {}).get("act_heads") is None else [])
    if keys:
        out = key_shard_attention(qf, kf, v, keys, 1.0 / qk ** 0.5, width)
    else:
        out = call_flash(padded, qf, kf, v, causal=True, scale=1.0 / qk ** 0.5)
    out = merge_heads(out) @ p.wo
    cache = {"c_kv": c_kv, "k_rope": k_rope} if make_cache else None
    return out, cache


def mla_decode(p, x: torch.Tensor, cfg: ModelConfig, cache: dict, pos: int):
    """Absorbed-matrix decode on the compressed cache ``{"c_kv": (B, T,
    rank), "k_rope": (B, T, rope)}``: ``wk_up`` folded into the query, the
    scores taken against ``c_kv`` and ``k_rope`` directly, positions after
    ``pos`` masked at -1e30, an fp32 softmax, and ``wv_up`` applied to the
    attended latent.  The new token's entries are written into ``cache``
    in place at ``pos`` (clamped into the cache, as the reference's
    ``dynamic_update_slice`` clamps).

    A DTensor cache is written and attended on each rank's local shard:
    where its time axis is split (:func:`_time_split`), the rank that owns
    the slot writes it and the partial softmaxes are combined across the
    time shards, as GQA's :func:`_decode_on_shards` does."""
    m = cfg.mla or MLAConfig()
    B, S, _ = x.shape
    if S != 1:
        raise ValueError(f"decode takes one token per row, got {S}")
    H = cfg.n_heads
    posb = replicated_like(torch.full((B, 1), pos, dtype=torch.int32, device=x.device), x)
    q_nope, q_rope, c_kv_new, k_rope_new = _mla_qkv(p, x, cfg, posb, own_rows=True)
    ck, cr = cache["c_kv"], cache["k_rope"]
    T = ck.shape[1]
    slot = min(max(pos, 0), T - 1)
    wk = split_heads(p.wk_up, m.kv_lora_rank, H, m.qk_nope_head_dim)
    q_eff = torch.einsum("bshd,rhd->bshr", q_nope, wk)
    scale = 1.0 / (m.qk_nope_head_dim + m.qk_rope_head_dim) ** 0.5

    def attend(qe, qr, ckn, crn, ckl, crl, shard=0, reduce=None):
        """The new entries written and the attended latent (B, 1, H, rank):
        ``ckl``/``crl`` hold the positions from ``shard·Tl`` on; with
        ``reduce`` they are one time slice of the cache, and each slice's
        partial softmax is combined across the slices by
        :func:`_partial_attend` (one kv head of ``[c_kv ‖ k_rope]``, the
        values ``c_kv``)."""
        Tl = ckl.shape[1]
        if slot // Tl == shard:
            ckl[:, slot % Tl] = ckn[:, 0]
            crl[:, slot % Tl] = crn[:, 0]
        valid = shard * Tl + torch.arange(Tl, device=ckl.device) <= pos
        if reduce is not None:
            keys = torch.cat([ckl, crl], dim=-1)[:, :, None, :]
            return _partial_attend(torch.cat([qe, qr], dim=-1), keys, ckl[:, :, None, :],
                                   valid, reduce, scale)
        scores = (torch.einsum("bshr,btr->bhst", qe, ckl)
                  + torch.einsum("bshd,btd->bhst", qr, crl)) * scale
        scores = torch.where(valid[None, None, None], scores.to(torch.float32), -1e30)
        return torch.einsum("bhst,btr->bshr", softmax_fp32(scores).to(ckl.dtype), ckl)

    if isinstance(ck, DTensor):
        pl, nsh, shard, reduce = _time_split(ck)
        ctx = on_shards(lambda *ts: attend(*ts, shard, reduce if nsh > 1 else None),
                        (q_eff, q_rope, c_kv_new, k_rope_new, ck, cr),
                        (pl, pl, pl, pl, ck.placements, cr.placements), pl)
    else:
        ctx = attend(q_eff, q_rope, c_kv_new, k_rope_new, ck, cr)
    wv = split_heads(p.wv_up, m.kv_lora_rank, H, m.v_head_dim)
    out = torch.einsum("bshr,rhd->bshd", ctx, wv)
    out = merge_heads(out) @ p.wo
    return out, cache


# ---------------------------------------------------------------------------
# Cross-attention (encoder-decoder)
# ---------------------------------------------------------------------------


def cross_attention(p, x: torch.Tensor, enc_kv: dict, cfg: ModelConfig, *,
                    decode: bool = False) -> torch.Tensor:
    """Decoder cross-attention over precomputed encoder K/V: ``x`` (B, S, d)
    attends to all T encoder frames of ``enc_kv["k"]``/``["v"]`` (B, T, KV,
    hd), without RoPE.  A prefill runs the flash kernel non-causal with T
    keys; a decode step (``decode=True``, S = 1) the plain core.

    A decode step's DTensor K/V (the plan's cache specs split the frames
    over 'model', evenly or not) are read on each rank's local shard, every
    frame valid, and the partial softmaxes combined across the frame
    shards (:func:`_time_split`, :func:`_partial_attend`)."""
    x = seq_whole(x)
    B, S, _ = x.shape
    H, hd = cfg.n_heads, cfg.head_dim
    q = split_heads(x @ p.wq, B, S, H, hd)
    k, v = enc_kv["k"], enc_kv["v"]
    scale = 1.0 / hd ** 0.5

    def attend(ql, kl, vl, reduce=None):
        every = torch.ones(kl.shape[1], dtype=torch.bool, device=kl.device)
        if reduce is None:
            return _gqa_core(ql, kl, vl, every[None], scale)
        return _partial_attend(ql, kl, vl, every, reduce, scale)

    if not decode:
        out = call_flash(flash_attention, q, k, v, causal=False, scale=scale)
    elif isinstance(k, DTensor):
        pl, nsh, _, reduce = _time_split(k)
        out = on_shards(lambda *ts: attend(*ts, reduce if nsh > 1 else None), (q, k, v),
                        (pl, k.placements, v.placements), pl)
    else:
        out = attend(q, k, v)
    return merge_heads(out) @ p.wo


def encoder_kv(p, enc_out: torch.Tensor, cfg: ModelConfig) -> dict:
    """The cross-attention K/V of one decoder layer from the encoder's
    output (B, T, d): ``{"k": (B, T, KV, hd), "v": ...}``."""
    enc_out = seq_whole(enc_out)
    B, T, _ = enc_out.shape
    KV, hd = cfg.n_kv_heads, cfg.head_dim
    return {"k": split_heads(enc_out @ p.wk, B, T, KV, hd),
            "v": split_heads(enc_out @ p.wv, B, T, KV, hd)}


# ---------------------------------------------------------------------------
# Cache allocation
# ---------------------------------------------------------------------------


def make_cache_struct(cfg: ModelConfig, batch: int, ctx_len: int,
                      dtype: torch.dtype = torch.float32, device=None) -> dict:
    """Zero-filled KV cache for ONE attention layer; the model stacks these
    along the layer axis.  MLA keeps ``{"c_kv": (batch, ctx_len, rank),
    "k_rope": (batch, ctx_len, rope)}``, GQA ``{"k", "v"}`` of (batch, T,
    KV, hd), T the sliding window where it is shorter."""
    if cfg.attention == "mla":
        m = cfg.mla or MLAConfig()
        shapes = {"c_kv": (batch, ctx_len, m.kv_lora_rank),
                  "k_rope": (batch, ctx_len, m.qk_rope_head_dim)}
        return {n: torch.zeros(s, dtype=dtype, device=device) for n, s in shapes.items()}
    T = min(ctx_len, cfg.sliding_window) if cfg.sliding_window else ctx_len
    shape = (batch, T, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
