"""Recurrent blocks: Mamba (the selective-scan state-space layer of hybrid
models) and xLSTM's mLSTM (matrix memory) and sLSTM (scalar memory).

The reference package computes the prefill scan with its own chunked
associative scan (``lax.scan`` over chunks, ``associative_scan`` inside
each) and names its Pallas ``ssm_scan`` kernel as the same decomposition
for real chips (``models/ssm.py:4-7``).  The port makes that swap: every
prefill runs :func:`repro_torch.kernels.ssm_scan.ssm_scan` over the whole
sequence, and every decode step runs it with S = 1 from the carried state,
which is exactly the reference's single-step update before the D term.

mLSTM and sLSTM are eager torch in fp32, as the reference computes them in
plain jnp (``models/ssm.py:145-380``): mLSTM's prefill is the chunked
gated linear attention, a Python loop over chunks carrying ``C`` and
``n``; sLSTM's is a loop over tokens.  Their norms go through the RMSNorm
kernel on the card.  Each block returns its new state, and decode steps
take one token from the carried state.  On DTensor inputs (the sharded
steps) each block runs on each rank's batch and channel or head shards:
a fused projection's halves keep their channels on the same ranks
(:func:`~.common.split_last`), Mamba's conv and the scan kernel run on
channel shards (:func:`call_scan`), mLSTM's and sLSTM's recurrences on
head shards in one ``local_map`` each, and the norms on whole rows
(:func:`~.common.call_norm`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from ..configs.base import ModelConfig, SSMConfig
from ..kernels.rmsnorm import rmsnorm
from ..kernels.ssm_scan import ssm_scan
from .common import (
    ParamDef, call_norm, on_shards, replicated_like, rule_dims, seq_whole, shard_act, split_last,
)


def mamba_defs(cfg: ModelConfig, stack: int) -> dict:
    s = cfg.ssm or SSMConfig()
    d = cfg.d_model
    di = s.expand * d
    dt_rank = max(di // 16, 1)
    L = (stack,)
    lax_ = ("layers",)
    return {
        "in_proj": ParamDef(L + (d, 2 * di), lax_ + ("embed_w", "inner")),
        "conv_w": ParamDef(L + (s.d_conv, di), lax_ + (None, "inner"), scale=0.5),
        "x_proj": ParamDef(L + (di, dt_rank + 2 * s.d_state), lax_ + ("inner", None)),
        "dt_proj": ParamDef(L + (dt_rank, di), lax_ + (None, "inner")),
        "dt_bias": ParamDef(L + (di,), lax_ + ("inner",), init="zeros"),
        "A_log": ParamDef(L + (di, s.d_state), lax_ + ("inner", None), init="ones"),
        "D": ParamDef(L + (di,), lax_ + ("inner",), init="ones"),
        "out_proj": ParamDef(L + (di, d), lax_ + ("inner", "embed_w")),
    }


def call_scan(kernel, dt, x, bmat, cmat, a, h0):
    """``kernel(dt, x, bmat, cmat, a, h0)`` (the selective scan), or on each
    rank's local shards when ``dt`` is a DTensor.  Per mesh dim the call
    keeps dt's batch shard or its channel shard (``a`` and ``h0`` split
    with the channels; B and C whole, their gradients then partial sums
    over the channel shards, as ``a``'s are over the batch shards); the
    time axis is always whole."""
    if not isinstance(dt, DTensor):
        return kernel(dt, x, bmat, cmat, a, h0)
    bmat, cmat, a, h0 = (replicated_like(t, dt) for t in (bmat, cmat, a, h0))
    pls: list[list] = [[] for _ in range(8)]   # dt/x, B/C, a, h0, y, hT; grads of B/C, a
    for pd in dt.placements:
        if pd == Shard(0):
            row = (Shard(0), Shard(0), Replicate(), Shard(0), Shard(0), Shard(0),
                   Shard(0), Partial())
        elif pd == Shard(2):
            row = (Shard(2), Replicate(), Shard(0), Shard(1), Shard(2), Shard(1),
                   Partial(), Shard(0))
        else:
            row = (Replicate(),) * 8
        for lst, pl in zip(pls, row):
            lst.append(pl)
    seq, bc, pa, ph, py, phT, gbc, ga = pls
    return on_shards(kernel, (dt, x, bmat, cmat, a, h0),
                     (seq, seq, bc, bc, pa, ph), (py, phT), (seq, seq, gbc, gbc, ga, ph))


def _ssm_core(x_conv, z, proj, dt_proj, dt_bias, A_log, D, h0, N: int):
    """(dt, B, C) from the x_proj output ``proj``, the selective scan from
    ``h0``, the skip term and the SiLU gate.  x_conv, z: (B, S, di).
    Returns (y (B, S, di) in x_conv's dtype, hT (B, di, N) fp32)."""
    dt_rank = dt_proj.shape[0]
    if isinstance(proj, DTensor):
        # the x_proj partial sums reduced first: with dt_low Partial, torch
        # 2.11's DTensor would shard dt_proj into a Partial for the matmul
        # (Shard -> Partial), which it cannot (jamba at tp 16)
        proj = proj.redistribute(proj.device_mesh, [Replicate() if p.is_partial() else p
                                                    for p in proj.placements])
    dt_low, bmat, cmat = proj.split([dt_rank, N, N], dim=-1)        # B, C: strided views
    dt = F.softplus(dt_low @ dt_proj + dt_bias)                      # (B, S, di)
    a = -torch.exp(A_log.float())                                    # (di, N)
    y, hT = call_scan(ssm_scan, dt, x_conv, bmat, cmat, a, h0)
    y = y + D.float() * x_conv.float()
    y = y * F.silu(z.float())
    return y.to(x_conv.dtype), hT


def _conv(xs: torch.Tensor, prev: torch.Tensor, conv_w: torch.Tensor, decode: bool):
    """The depthwise causal conv of width d_conv over ``prev`` (B, d_conv-1,
    di) then ``xs`` (B, S, di), and its SiLU; and the window handed on.
    A prefill sums the taps in the reference's order; a decode step (S =
    1) contracts the window as the reference's decode does."""
    K = conv_w.shape[0]
    xp = torch.cat([prev, xs], dim=1)
    if decode:
        return F.silu(torch.einsum("bki,ki->bi", xp, conv_w))[:, None, :], xp[:, 1:]
    S = xs.shape[1]
    x_conv = F.silu(sum(xp[:, i : i + S] * conv_w[i] for i in range(K)))
    return x_conv, xp[:, -(K - 1):] if K > 1 else prev


def _mamba(p, x: torch.Tensor, cfg: ModelConfig, state: dict | None, decode: bool):
    s = cfg.ssm or SSMConfig()
    B, S, d = x.shape
    di = s.expand * d
    if isinstance(x, DTensor):
        return _mamba_on_shards(p, x, cfg, state, decode)
    xs, z = (x @ p.in_proj).split(di, dim=-1)
    prev = state["conv"] if state is not None else x.new_zeros((B, s.d_conv - 1, di))
    x_conv, conv = _conv(xs, prev, p.conv_w, decode)
    h0 = (state["h"] if state is not None
          else torch.zeros((B, di, s.d_state), dtype=torch.float32, device=x.device))
    y, hT = _ssm_core(x_conv, z, x_conv @ p.x_proj, p.dt_proj, p.dt_bias, p.A_log, p.D, h0,
                      s.d_state)
    return y @ p.out_proj, {"h": hT, "conv": conv}


def _roles(t: DTensor, logical: str):
    """The placements of a block run on local shards, as a function: per mesh dim,
    ``chan`` where the rules map ``logical`` (the block's channel or head
    axis) to it, ``batch`` where ``t``'s batch (dim 0) is split, ``other``
    elsewhere."""
    chans = rule_dims(t.device_mesh, logical)

    def lay(batch, chan, other=Replicate()):
        return [chan if i in chans else batch if pl == Shard(0) else other
                for i, pl in enumerate(t.placements)]
    return lay


def _mamba_on_shards(p, x: DTensor, cfg: ModelConfig, state: dict | None, decode: bool):
    """The Mamba block on DTensors, its inner channels split over the mesh
    dims that the rules' "act_inner" names: the projection's two halves
    keep their channels on the same ranks (:func:`~.common.split_last`);
    the conv and x_proj's partial sums run on each rank's batch and
    channel shards in one ``local_map``; the scan on local shards
    (:func:`call_scan`, its B and C summed over the channel shards first);
    ``out_proj``'s output is a partial sum that the next norm reduces."""
    s = cfg.ssm or SSMConfig()
    B, _, d = x.shape
    K, N = s.d_conv, s.d_state
    xz = shard_act(seq_whole(x) @ p.in_proj, ("act_batch", None, "act_inner"))
    xs, z = split_last(xz, 2)
    lay = _roles(xs, "act_inner")
    S0, P_ = Shard(0), Partial()
    act, chan0 = lay(S0, Shard(2)), lay(Replicate(), S0)

    def conv_local(xs_l, conv_w, x_proj, *prev):
        prev = prev[0] if prev else xs_l.new_zeros((xs_l.shape[0], K - 1, xs_l.shape[2]))
        x_conv, conv = _conv(xs_l, prev, conv_w, decode)
        return x_conv, x_conv @ x_proj, conv

    prev = () if state is None else (state["conv"],)
    x_conv, proj, conv = on_shards(
        conv_local, (xs, p.conv_w, p.x_proj) + prev,
        (act, lay(Replicate(), Shard(1)), chan0) + (act,) * len(prev),
        (act, lay(S0, P_), act),
        (act, lay(P_, Shard(1)), lay(P_, S0)) + (act,) * len(prev))
    h0 = (state["h"] if state is not None
          else torch.zeros((B, s.expand * d, N), dtype=torch.float32, device=x.device))
    y, hT = _ssm_core(x_conv, z, proj, p.dt_proj, p.dt_bias, p.A_log, p.D, h0, N)
    return y @ p.out_proj, {"h": hT, "conv": conv}


def mamba_block(p, x: torch.Tensor, cfg: ModelConfig, state: dict | None = None):
    """Prefill path.  x: (B, S, d); ``p`` holds :func:`mamba_defs`' leaves
    as attributes.  The conv window and the scan start from ``state``
    (``{"h", "conv"}`` as returned here), or from zeros as the reference's
    prefill does when it is None.  Returns (out (B, S, d), {"h": (B, di, N)
    fp32, "conv": (B, d_conv-1, di)})."""
    return _mamba(p, x, cfg, state, decode=False)


def mamba_decode(p, x: torch.Tensor, cfg: ModelConfig, state: dict):
    """One token per row.  x: (B, 1, d); ``state`` as :func:`mamba_block`
    returns it.  Returns (out (B, 1, d), new state); ``state`` is not
    written."""
    if x.shape[1] != 1:
        raise ValueError(f"decode takes one token per row, got {x.shape[1]}")
    return _mamba(p, x, cfg, state, decode=True)


def mamba_state_struct(cfg: ModelConfig, batch: int, dtype: torch.dtype = torch.float32,
                       device=None) -> dict:
    """Zero state of ONE Mamba layer: ``h`` fp32 (batch, di, N) and ``conv``
    (batch, d_conv-1, di) in ``dtype``; the model stacks these along the
    period axis."""
    s = cfg.ssm or SSMConfig()
    di = s.expand * cfg.d_model
    return {"h": torch.zeros((batch, di, s.d_state), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, s.d_conv - 1, di), dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# xLSTM: mLSTM (matrix memory, chunked linear attention form)
# ---------------------------------------------------------------------------


def mlstm_inner_dim(cfg: ModelConfig) -> int:
    """Projection width rounded up to a multiple of n_heads."""
    s = cfg.ssm or SSMConfig()
    di = int(s.mlstm_proj_factor * cfg.d_model)
    nh = cfg.n_heads
    return ((di + nh - 1) // nh) * nh


def mlstm_defs(cfg: ModelConfig, stack: int) -> dict:
    d = cfg.d_model
    di = mlstm_inner_dim(cfg)
    nh = cfg.n_heads
    dh = di // nh
    L = (stack,)
    lax_ = ("layers",)
    return {
        "up": ParamDef(L + (d, 2 * di), lax_ + ("embed_w", "inner")),
        # block-diagonal per-head q/k/v (xLSTM qkv_proj_blocksize)
        "wq": ParamDef(L + (nh, dh, dh), lax_ + ("heads", None, None)),
        "wk": ParamDef(L + (nh, dh, dh), lax_ + ("heads", None, None)),
        "wv": ParamDef(L + (nh, dh, dh), lax_ + ("heads", None, None)),
        "w_i": ParamDef(L + (di, nh), lax_ + ("inner", "heads"), scale=0.1),
        "w_f": ParamDef(L + (di, nh), lax_ + ("inner", "heads"), scale=0.1),
        "b_f": ParamDef(L + (nh,), lax_ + ("heads",), init="ones"),
        "norm": ParamDef(L + (di,), lax_ + ("inner",), init="ones"),
        "down": ParamDef(L + (di, d), lax_ + ("inner", "embed_w")),
    }


def _mlstm_chunk(q, k, v, logf, logi, C0, n0):
    """One chunk of gated linear attention (mLSTM parallel form).

    q, k, v: (B, H, Lc, dh); logf, logi: (B, H, Lc); C0: (B, H, dh, dh);
    n0: (B, H, dh).  Returns (h (B, H, Lc, dh), C1, n1)."""
    Lc = q.shape[2]
    scale = q.shape[-1] ** -0.5
    cum = torch.cumsum(logf, dim=-1)                       # inclusive cumsum
    total = cum[..., -1:]
    # intra-chunk decay: D[i, j] = exp(cum_i - cum_j) * exp(logi_j), j <= i
    dm = cum[..., :, None] - cum[..., None, :] + logi[..., None, :]
    tri = torch.ones((Lc, Lc), dtype=torch.bool, device=q.device).tril()
    dm = torch.where(tri, dm, -torch.inf)
    sg = torch.einsum("bhid,bhjd->bhij", q, k) * scale * torch.exp(dm)
    intra = torch.einsum("bhij,bhjd->bhid", sg, v)
    # inter-chunk: the carried state's part (q scaled as in the decode step)
    qdec = q * scale * torch.exp(cum)[..., None]
    num = intra + torch.einsum("bhid,bhde->bhie", qdec, C0)
    # normaliser: q·n_t = the row sum of sg plus the carried part
    den = torch.abs(sg.sum(-1, keepdim=True)
                    + torch.einsum("bhid,bhd->bhi", qdec, n0)[..., None])
    h = num / torch.clamp_min(den, 1.0)
    # the state handed to the next chunk
    kdec = k * torch.exp(total - cum + logi)[..., None]
    C1 = torch.exp(total)[..., None] * C0 + torch.einsum("bhjd,bhje->bhde", kdec, v)
    n1 = torch.exp(total) * n0 + kdec.sum(2)
    return h, C1, n1


def _mlstm_heads(u, gi, gf, wq, wk, wv):
    """q, k, v (B, H, S, dh) through the per-head block-diagonal maps of u
    (B, S, H·dh), and the gates' logs logi, logf (B, H, S) from their
    pre-activations gi, gf (B, S, H), all fp32.  H is ``wq``'s head count
    (a rank's heads on local shards)."""
    B, S, di = u.shape
    nh = wq.shape[0]
    uh = u.reshape(B, S, nh, di // nh).transpose(1, 2)               # (B, H, S, dh)
    q, k, v = (torch.einsum("bhsd,hde->bhse", uh, w).float() for w in (wq, wk, wv))
    return q, k, v, gi.transpose(1, 2).float(), F.logsigmoid(gf.transpose(1, 2)).float()


def _mlstm_cells(u, gi, gf, wq, wk, wv, C, n, chunk: int, decode: bool):
    """The mLSTM recurrence from (C, n) over u (B, S, H·dh): the prefill's
    chunked form (chunks of ``min(chunk, S)``, one chunk when that does
    not divide S, as in the reference) or one decode step.  Returns (h
    (B, S, H·dh) fp32, C, n)."""
    B, S, di = u.shape
    q, k, v, logi, logf = _mlstm_heads(u, gi, gf, wq, wk, wv)
    if decode:
        q, k, v, logi, logf = (t[:, :, 0] for t in (q, k, v, logi, logf))
        f = torch.exp(logf)[..., None]                               # (B, H, 1)
        i = torch.exp(logi)[..., None]
        C = f[..., None] * C + i[..., None] * torch.einsum("bhd,bhe->bhde", k, v)
        n = f * n + i * k
        qs = q * q.shape[-1] ** -0.5
        num = torch.einsum("bhd,bhde->bhe", qs, C)
        den = torch.abs(torch.einsum("bhd,bhd->bh", qs, n))[..., None]
        return (num / torch.clamp_min(den, 1.0)).reshape(B, 1, di), C, n
    Lc = min(chunk, S)
    if S % Lc != 0:
        Lc = S                     # one chunk, as the reference falls back
    # each tensor split once: a chunk sliced out one at a time would take
    # in the backward a zero-filled gradient of the whole sequence apiece
    hs = []
    for qc, kc, vc, fc, ic in zip(*(t.split(Lc, dim=2) for t in (q, k, v, logf, logi))):
        h, C, n = _mlstm_chunk(qc, kc, vc, fc, ic, C, n)
        hs.append(h)
    return torch.cat(hs, dim=2).transpose(1, 2).reshape(B, S, di), C, n


def _mlstm(p, x: torch.Tensor, cfg: ModelConfig, state: dict | None, decode: bool):
    s = cfg.ssm or SSMConfig()
    B, S, d = x.shape
    di = mlstm_inner_dim(cfg)
    nh = cfg.n_heads
    dh = di // nh
    if isinstance(x, DTensor):
        return _mlstm_on_shards(p, x, cfg, state, decode)
    u, z = (x @ p.up).split(di, dim=-1)
    if state is None:
        C = torch.zeros((B, nh, dh, dh), dtype=torch.float32, device=x.device)
        n = torch.zeros((B, nh, dh), dtype=torch.float32, device=x.device)
    else:
        C, n = state["C"], state["n"]
    h, C, n = _mlstm_cells(u, u @ p.w_i, u @ p.w_f + p.b_f, p.wq, p.wk, p.wv, C, n, s.chunk,
                           decode)
    h = call_norm(rmsnorm, h.to(x.dtype).contiguous(), p.norm, cfg.norm_eps)
    return (h * F.silu(z)) @ p.down, {"C": C, "n": n}


def _mlstm_on_shards(p, x: DTensor, cfg: ModelConfig, state: dict | None, decode: bool):
    """The mLSTM block on DTensors: the up-projection's halves keep their
    inner channels on the same ranks (:func:`~.common.split_last`), the
    gates' pre-activations are matmuls over the whole inner axis, and the
    recurrence runs in one ``local_map`` on each rank's batch and head
    shards (heads split where the rules' "heads" names a mesh dim, the
    head dim never: the reference's ``act_headdim``).  The norm over the
    inner axis then gathers it whole."""
    s = cfg.ssm or SSMConfig()
    di = mlstm_inner_dim(cfg)
    nh = cfg.n_heads
    dh = di // nh
    up = shard_act(seq_whole(x) @ p.up, ("act_batch", None, "act_inner"))
    u, z = split_last(up, 2)
    gi, gf = u @ p.w_i, u @ p.w_f + p.b_f
    lay = _roles(u, "heads")
    S0, R, P_ = Shard(0), Replicate(), Partial()
    act, heads_w, st = lay(S0, Shard(2)), lay(R, S0), lay(S0, Shard(1))

    def cells_local(ul, gil, gfl, wq, wk, wv, *state_l):
        if state_l:
            C, n = state_l
        else:
            B, H = ul.shape[0], wq.shape[0]
            C = torch.zeros((B, H, dh, dh), dtype=torch.float32, device=ul.device)
            n = torch.zeros((B, H, dh), dtype=torch.float32, device=ul.device)
        return _mlstm_cells(ul, gil, gfl, wq, wk, wv, C, n, s.chunk, decode)

    carried = () if state is None else (state["C"], state["n"])
    w_grad = lay(P_, S0)
    h, C, n = on_shards(cells_local, (u, gi, gf, p.wq, p.wk, p.wv) + carried,
                        (act, act, act, heads_w, heads_w, heads_w) + (st,) * len(carried),
                        (act, st, st),
                        (act, act, act, w_grad, w_grad, w_grad) + (st,) * len(carried))
    h = call_norm(rmsnorm, h.to(x.dtype).contiguous(), p.norm, cfg.norm_eps)
    return (h * F.silu(z)) @ p.down, {"C": C, "n": n}


def mlstm_block(p, x: torch.Tensor, cfg: ModelConfig, state: dict | None = None):
    """Prefill path.  x: (B, S, d); ``p`` holds :func:`mlstm_defs`' leaves
    as attributes.  The sequence runs in chunks of ``min(chunk, S)``
    tokens, or as one chunk when that does not divide S, as in the
    reference, carrying ``C`` and ``n`` from ``state`` (zeros when None).
    Returns (out (B, S, d), {"C": (B, H, dh, dh), "n": (B, H, dh)}), fp32
    states."""
    return _mlstm(p, x, cfg, state, decode=False)


def mlstm_decode(p, x: torch.Tensor, cfg: ModelConfig, state: dict):
    """One token per row.  x: (B, 1, d); ``state`` as :func:`mlstm_block`
    returns it.  Returns (out (B, 1, d), new state); ``state`` is not
    written."""
    if x.shape[1] != 1:
        raise ValueError(f"decode takes one token per row, got {x.shape[1]}")
    return _mlstm(p, x, cfg, state, decode=True)


def mlstm_state_struct(cfg: ModelConfig, batch: int, device=None) -> dict:
    """Zero state of ONE mLSTM layer: ``C`` (batch, H, dh, dh) and ``n``
    (batch, H, dh), fp32."""
    nh = cfg.n_heads
    dh = mlstm_inner_dim(cfg) // nh
    return {"C": torch.zeros((batch, nh, dh, dh), dtype=torch.float32, device=device),
            "n": torch.zeros((batch, nh, dh), dtype=torch.float32, device=device)}


# ---------------------------------------------------------------------------
# xLSTM: sLSTM (scalar memory, sequential exponential-gated recurrence)
# ---------------------------------------------------------------------------

#: The sLSTM stabiliser's start, as the reference's ``slstm_block`` and
#: ``slstm_state_struct`` set it: the first step's input gate then takes
#: the whole stabiliser (``m_new = log_i``) and the forget gate nothing.
SLSTM_M0 = -1e30


def slstm_defs(cfg: ModelConfig, stack: int) -> dict:
    s = cfg.ssm or SSMConfig()
    d = cfg.d_model
    nh = cfg.n_heads
    dh = d // nh
    ffd = int(s.slstm_ff_factor * d)
    L = (stack,)
    lax_ = ("layers",)
    return {
        "w_gates": ParamDef(L + (d, 4 * d), lax_ + ("embed_w", "inner")),
        "r_gates": ParamDef(L + (nh, dh, 4 * dh), lax_ + ("heads", None, None), scale=0.5),
        "b_gates": ParamDef(L + (4 * d,), lax_ + ("inner",), init="zeros"),
        "norm": ParamDef(L + (d,), lax_ + ("embed_w",), init="ones"),
        "ff_up": ParamDef(L + (d, ffd), lax_ + ("embed_w", "ff")),
        "ff_down": ParamDef(L + (ffd, d), lax_ + ("ff", "embed_w")),
    }


def _slstm_step(r_gates: torch.Tensor, b_gates: torch.Tensor, carry, wx_t: torch.Tensor):
    """One timestep of stabilised exponential-gated sLSTM.  carry: (h, c,
    n, m), each (B, d) with the heads folded; wx_t: (B, 4d), gate-major
    (i, f, z, o); ``r_gates`` (H, dh, 4dh) holds the heads' recurrent
    maps (a rank's heads on local shards) and ``b_gates`` (4d) the bias."""
    h, c, n, m = carry
    nh = r_gates.shape[0]
    d = h.shape[-1]
    dh = d // nh
    rec = torch.einsum("bhd,hde->bhe", h.reshape(-1, nh, dh), r_gates)  # (B, H, 4dh)
    # regroup the heads' (i, f, z, o) blocks to (B, 4d)
    rec = rec.reshape(-1, nh, 4, dh).transpose(1, 2).reshape(-1, 4 * d)
    zi, zf, zz, zo = (wx_t + rec + b_gates).chunk(4, dim=-1)
    log_f = F.logsigmoid(zf)
    m_new = torch.maximum(log_f + m, zi)
    i_t = torch.exp(zi - m_new)
    f_t = torch.exp(log_f + m - m_new)
    c_new = f_t * c + i_t * torch.tanh(zz)
    n_new = f_t * n + i_t
    h_new = torch.sigmoid(zo) * c_new / torch.clamp_min(torch.abs(n_new), 1.0)
    return h_new, c_new, n_new, m_new


def _slstm_cells(wx: torch.Tensor, r_gates, b_gates, carry):
    """The recurrence token by token over wx (B, S, 4d) fp32 from
    ``carry`` (None: zeros, ``m`` at :data:`SLSTM_M0`).  Returns (h (B,
    S, d) fp32, the last carry)."""
    B, _, d4 = wx.shape
    r_gates = r_gates.to(wx.dtype)     # bf16 weights: fp32 products, as jnp promotes them
    if carry is None:
        zero = torch.zeros((B, d4 // 4), dtype=torch.float32, device=wx.device)
        carry = (zero, zero, zero, torch.full_like(zero, SLSTM_M0))
    hs = []
    # one unbind: its backward stacks the tokens' gradients once, where
    # ``wx[:, t]`` would zero-fill a (B, S, 4d) gradient for every token
    for wx_t in wx.unbind(1):
        carry = _slstm_step(r_gates, b_gates, carry, wx_t)
        hs.append(carry[0])
    return torch.stack(hs, dim=1), carry


def _slstm_out(p, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The norm and the tanh-approximate GELU feed-forward after the
    recurrence (the reference's ``jax.nn.gelu`` defaults to the tanh form)."""
    h = call_norm(rmsnorm, h.contiguous(), p.norm, cfg.norm_eps)
    return F.gelu(h @ p.ff_up, approximate="tanh") @ p.ff_down


_SLSTM_STATE = ("h", "c", "n", "m")


def _slstm(p, x: torch.Tensor, cfg: ModelConfig, state: dict | None):
    if isinstance(x, DTensor):
        return _slstm_on_shards(p, x, cfg, state)
    carry = None if state is None else tuple(state[k] for k in _SLSTM_STATE)
    h, carry = _slstm_cells((x @ p.w_gates).float(), p.r_gates, p.b_gates, carry)
    return _slstm_out(p, h.to(x.dtype), cfg), dict(zip(_SLSTM_STATE, carry))


def _slstm_on_shards(p, x: DTensor, cfg: ModelConfig, state: dict | None):
    """The sLSTM block on DTensors: the gate projection's four gates keep
    their channels on the same ranks (:func:`~.common.split_last`, the
    bias likewise), and the whole recurrence runs in one ``local_map`` on
    each rank's batch and head shards, its token loop on plain tensors
    (heads split where the rules' "heads" names a mesh dim).  The state
    leaves split over the heads; a decode step writes it back in the
    cache's layout."""
    wx = shard_act((seq_whole(x) @ p.w_gates).float(), ("act_batch", None, "act_inner"))
    gates = split_last(wx, 4)
    bias = split_last(p.b_gates, 4)
    lay = _roles(wx, "heads")
    S0, R, P_ = Shard(0), Replicate(), Partial()
    act, st, vec = lay(S0, Shard(2)), lay(S0, Shard(1)), lay(R, S0)

    def cells_local(wi, wf, wz, wo, r_gates, bi, bf, bz, bo, *carry):
        wx_l = torch.cat([wi, wf, wz, wo], dim=-1)
        b_l = torch.cat([bi, bf, bz, bo], dim=-1)
        h, carry = _slstm_cells(wx_l, r_gates, b_l, carry or None)
        return (h, *carry)

    carry = () if state is None else tuple(state[k] for k in _SLSTM_STATE)
    vec_grad = lay(P_, S0)
    h, *carry = on_shards(cells_local, (*gates, p.r_gates, *bias) + carry,
                          (act,) * 4 + (vec,) * 5 + (st,) * len(carry),
                          (act,) + (st,) * 4,
                          (act,) * 4 + (vec_grad,) * 5 + (st,) * len(carry))
    return _slstm_out(p, h.to(x.dtype), cfg), dict(zip(_SLSTM_STATE, carry))


def slstm_block(p, x: torch.Tensor, cfg: ModelConfig, state: dict | None = None):
    """Prefill path: the recurrence token by token from ``state`` (zeros,
    ``m`` at :data:`SLSTM_M0`, when None).  x: (B, S, d).  Returns (out
    (B, S, d), {"h", "c", "n", "m"}: (B, d) fp32 each)."""
    return _slstm(p, x, cfg, state)


def slstm_decode(p, x: torch.Tensor, cfg: ModelConfig, state: dict):
    """One token per row.  x: (B, 1, d).  Returns (out (B, 1, d), new
    state); ``state`` is not written."""
    if x.shape[1] != 1:
        raise ValueError(f"decode takes one token per row, got {x.shape[1]}")
    return _slstm(p, x, cfg, state)


def slstm_state_struct(cfg: ModelConfig, batch: int, device=None) -> dict:
    """Start state of ONE sLSTM layer: ``h``, ``c``, ``n`` zeros and ``m``
    at :data:`SLSTM_M0`, each (batch, d) fp32, as the reference's
    ``slstm_state_struct(abstract=False)``."""
    zero = torch.zeros((batch, cfg.d_model), dtype=torch.float32, device=device)
    return {"h": zero, "c": zero.clone(), "n": zero.clone(),
            "m": torch.full_like(zero, SLSTM_M0)}
