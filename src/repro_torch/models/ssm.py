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
take one token from the carried state.  On DTensor inputs the scan and the
norms run on each rank's local shards (:func:`call_scan`,
:func:`~.common.call_norm`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from ..configs.base import ModelConfig, SSMConfig
from ..kernels.rmsnorm import rmsnorm
from ..kernels.ssm_scan import ssm_scan
from .common import ParamDef, call_norm, on_shards, replicated_like, shard_act


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


def _scan_and_gate(p, x_conv: torch.Tensor, z: torch.Tensor, s: SSMConfig,
                   h0: torch.Tensor):
    """x_proj → (dt, B, C), the selective scan from ``h0``, the skip term
    and the SiLU gate.  x_conv, z: (B, S, di).  Returns (y (B, S, di) in
    x_conv's dtype, hT (B, di, N) fp32)."""
    dt_rank = p.dt_proj.shape[0]
    N = s.d_state
    proj = x_conv @ p.x_proj                                         # (B, S, rank + 2N)
    dt_low, bmat, cmat = proj.split([dt_rank, N, N], dim=-1)        # B, C: strided views
    dt = F.softplus(dt_low @ p.dt_proj + p.dt_bias)                  # (B, S, di)
    a = -torch.exp(p.A_log.float())                                  # (di, N)
    y, hT = call_scan(ssm_scan, dt, x_conv, bmat, cmat, a, h0)
    y = y + p.D.float() * x_conv.float()
    y = y * F.silu(z.float())
    return y.to(x_conv.dtype), hT


def mamba_block(p, x: torch.Tensor, cfg: ModelConfig, state: dict | None = None):
    """Prefill path.  x: (B, S, d); ``p`` holds :func:`mamba_defs`' leaves
    as attributes.  The conv window and the scan start from ``state``
    (``{"h", "conv"}`` as returned here), or from zeros as the reference's
    prefill does when it is None.  Returns (out (B, S, d), {"h": (B, di, N)
    fp32, "conv": (B, d_conv-1, di)})."""
    s = cfg.ssm or SSMConfig()
    B, S, d = x.shape
    di = s.expand * d
    xz = shard_act(x @ p.in_proj, ("act_batch", None, "act_inner"))
    xs, z = xz.split(di, dim=-1)
    prev = state["conv"] if state is not None else x.new_zeros((B, s.d_conv - 1, di))
    xp = torch.cat([prev, xs], dim=1)
    # depthwise causal conv of width d_conv, summed in the reference's order
    x_conv = F.silu(sum(xp[:, i : i + S] * p.conv_w[i] for i in range(s.d_conv)))
    h0 = (state["h"] if state is not None
          else torch.zeros((B, di, s.d_state), dtype=torch.float32, device=x.device))
    y, hT = _scan_and_gate(p, x_conv, z, s, h0)
    conv = xp[:, -(s.d_conv - 1):] if s.d_conv > 1 else prev
    return y @ p.out_proj, {"h": hT, "conv": conv}


def mamba_decode(p, x: torch.Tensor, cfg: ModelConfig, state: dict):
    """One token per row.  x: (B, 1, d); ``state`` as :func:`mamba_block`
    returns it.  Returns (out (B, 1, d), new state); ``state`` is not
    written."""
    s = cfg.ssm or SSMConfig()
    B, S, d = x.shape
    if S != 1:
        raise ValueError(f"decode takes one token per row, got {S}")
    di = s.expand * d
    xs, z = (x @ p.in_proj).split(di, dim=-1)
    xp = torch.cat([state["conv"], xs], dim=1)                        # (B, d_conv, di)
    x_conv = F.silu(torch.einsum("bki,ki->bi", xp, p.conv_w))[:, None, :]
    y, h = _scan_and_gate(p, x_conv, z, s, state["h"])
    return y @ p.out_proj, {"h": h, "conv": xp[:, 1:]}


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


def _mlstm_qkv_gates(p, u: torch.Tensor, cfg: ModelConfig):
    """q, k, v (B, H, S, dh) through the per-head block-diagonal maps and
    the gates' logs logi, logf (B, H, S), all fp32, from u (B, S, di)."""
    B, S, di = u.shape
    nh = cfg.n_heads
    uh = u.reshape(B, S, nh, di // nh).transpose(1, 2)               # (B, H, S, dh)
    q, k, v = (torch.einsum("bhsd,hde->bhse", uh, w).float() for w in (p.wq, p.wk, p.wv))
    logi = (u @ p.w_i).transpose(1, 2).float()
    logf = F.logsigmoid((u @ p.w_f + p.b_f).transpose(1, 2)).float()
    return q, k, v, logi, logf


def mlstm_block(p, x: torch.Tensor, cfg: ModelConfig, state: dict | None = None):
    """Prefill path.  x: (B, S, d); ``p`` holds :func:`mlstm_defs`' leaves
    as attributes.  The sequence runs in chunks of ``min(chunk, S)``
    tokens, or as one chunk when that does not divide S, as in the
    reference, carrying ``C`` and ``n`` from ``state`` (zeros when None).
    Returns (out (B, S, d), {"C": (B, H, dh, dh), "n": (B, H, dh)}), fp32
    states."""
    s = cfg.ssm or SSMConfig()
    B, S, d = x.shape
    di = mlstm_inner_dim(cfg)
    nh = cfg.n_heads
    dh = di // nh
    u, z = (x @ p.up).split(di, dim=-1)
    q, k, v, logi, logf = _mlstm_qkv_gates(p, u, cfg)
    if state is None:
        C = torch.zeros((B, nh, dh, dh), dtype=torch.float32, device=x.device)
        n = torch.zeros((B, nh, dh), dtype=torch.float32, device=x.device)
    else:
        C, n = state["C"], state["n"]
    Lc = min(s.chunk, S)
    if S % Lc != 0:
        Lc = S                     # one chunk, as the reference falls back
    hs = []
    for c0 in range(0, S, Lc):
        c = slice(c0, c0 + Lc)
        h, C, n = _mlstm_chunk(q[:, :, c], k[:, :, c], v[:, :, c], logf[..., c], logi[..., c],
                               C, n)
        hs.append(h)
    h = torch.cat(hs, dim=2).transpose(1, 2).reshape(B, S, di)
    h = call_norm(rmsnorm, h.to(x.dtype).contiguous(), p.norm, cfg.norm_eps)
    return (h * F.silu(z)) @ p.down, {"C": C, "n": n}


def mlstm_decode(p, x: torch.Tensor, cfg: ModelConfig, state: dict):
    """One token per row.  x: (B, 1, d); ``state`` as :func:`mlstm_block`
    returns it.  Returns (out (B, 1, d), new state); ``state`` is not
    written."""
    B, S, d = x.shape
    if S != 1:
        raise ValueError(f"decode takes one token per row, got {S}")
    di = mlstm_inner_dim(cfg)
    dh = di // cfg.n_heads
    u, z = (x @ p.up).split(di, dim=-1)
    q, k, v, logi, logf = (t[:, :, 0] for t in _mlstm_qkv_gates(p, u, cfg))
    f = torch.exp(logf)[..., None]                                   # (B, H, 1)
    i = torch.exp(logi)[..., None]
    C = f[..., None] * state["C"] + i[..., None] * torch.einsum("bhd,bhe->bhde", k, v)
    n = f * state["n"] + i * k
    qs = q * dh ** -0.5
    num = torch.einsum("bhd,bhde->bhe", qs, C)
    den = torch.abs(torch.einsum("bhd,bhd->bh", qs, n))[..., None]
    h = (num / torch.clamp_min(den, 1.0)).reshape(B, 1, di).to(x.dtype)
    h = call_norm(rmsnorm, h, p.norm, cfg.norm_eps)
    return (h * F.silu(z)) @ p.down, {"C": C, "n": n}


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


def _slstm_step(p, cfg: ModelConfig, carry, wx_t: torch.Tensor):
    """One timestep of stabilised exponential-gated sLSTM.  carry: (h, c,
    n, m), each (B, d) with the heads folded; wx_t: (B, 4d)."""
    h, c, n, m = carry
    nh = cfg.n_heads
    d = h.shape[-1]
    dh = d // nh
    rec = torch.einsum("bhd,hde->bhe", h.reshape(-1, nh, dh), p.r_gates)  # (B, H, 4dh)
    # regroup the heads' (i, f, z, o) blocks to (B, 4d)
    rec = rec.reshape(-1, nh, 4, dh).transpose(1, 2).reshape(-1, 4 * d)
    zi, zf, zz, zo = (wx_t + rec + p.b_gates).chunk(4, dim=-1)
    log_f = F.logsigmoid(zf)
    m_new = torch.maximum(log_f + m, zi)
    i_t = torch.exp(zi - m_new)
    f_t = torch.exp(log_f + m - m_new)
    c_new = f_t * c + i_t * torch.tanh(zz)
    n_new = f_t * n + i_t
    h_new = torch.sigmoid(zo) * c_new / torch.clamp_min(torch.abs(n_new), 1.0)
    return h_new, c_new, n_new, m_new


def _slstm_out(p, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The norm and the tanh-approximate GELU feed-forward after the
    recurrence (the reference's ``jax.nn.gelu`` defaults to the tanh form)."""
    h = call_norm(rmsnorm, h.contiguous(), p.norm, cfg.norm_eps)
    return F.gelu(h @ p.ff_up, approximate="tanh") @ p.ff_down


def slstm_block(p, x: torch.Tensor, cfg: ModelConfig, state: dict | None = None):
    """Prefill path: the recurrence token by token from ``state`` (zeros,
    ``m`` at :data:`SLSTM_M0`, when None).  x: (B, S, d).  Returns (out
    (B, S, d), {"h", "c", "n", "m"}: (B, d) fp32 each)."""
    B, S, d = x.shape
    wx = (x @ p.w_gates).float()                                       # (B, S, 4d)
    if state is None:
        zero = torch.zeros((B, d), dtype=torch.float32, device=x.device)
        carry = (zero, zero, zero, torch.full_like(zero, SLSTM_M0))
    else:
        carry = (state["h"], state["c"], state["n"], state["m"])
    hs = []
    for t in range(S):
        carry = _slstm_step(p, cfg, carry, wx[:, t])
        hs.append(carry[0])
    h = torch.stack(hs, dim=1).to(x.dtype)
    return _slstm_out(p, h, cfg), dict(zip(("h", "c", "n", "m"), carry))


def slstm_decode(p, x: torch.Tensor, cfg: ModelConfig, state: dict):
    """One token per row.  x: (B, 1, d).  Returns (out (B, 1, d), new
    state); ``state`` is not written."""
    B, S, d = x.shape
    if S != 1:
        raise ValueError(f"decode takes one token per row, got {S}")
    wx = (x @ p.w_gates).float()[:, 0]
    carry = _slstm_step(p, cfg, (state["h"], state["c"], state["n"], state["m"]), wx)
    return _slstm_out(p, carry[0][:, None].to(x.dtype), cfg), dict(zip(("h", "c", "n", "m"),
                                                                        carry))


def slstm_state_struct(cfg: ModelConfig, batch: int, device=None) -> dict:
    """Start state of ONE sLSTM layer: ``h``, ``c``, ``n`` zeros and ``m``
    at :data:`SLSTM_M0`, each (batch, d) fp32, as the reference's
    ``slstm_state_struct(abstract=False)``."""
    zero = torch.zeros((batch, cfg.d_model), dtype=torch.float32, device=device)
    return {"h": zero, "c": zero.clone(), "n": zero.clone(),
            "m": torch.full_like(zero, SLSTM_M0)}
