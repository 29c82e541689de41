"""Mamba blocks: the selective-scan state-space layer of hybrid models.

The reference package computes the prefill scan with its own chunked
associative scan (``lax.scan`` over chunks, ``associative_scan`` inside
each) and names its Pallas ``ssm_scan`` kernel as the same decomposition
for real chips (``models/ssm.py:4-7``).  The port makes that swap: every
prefill runs :func:`repro_torch.kernels.ssm_scan.ssm_scan` over the whole
sequence, and every decode step runs it with S = 1 from the carried state,
which is exactly the reference's single-step update before the D term.

mLSTM and sLSTM (xlstm) are a later slice (ROADMAP queue 1, item 11a).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig, SSMConfig
from ..kernels.ssm_scan import ssm_scan
from .common import ParamDef


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
    y, hT = ssm_scan(dt, x_conv, bmat, cmat, a, h0)
    y = y + p.D.float() * x_conv.float()
    y = y * F.silu(z.float())
    return y.to(x_conv.dtype), hT


def mamba_block(p, x: torch.Tensor, cfg: ModelConfig):
    """Prefill path.  x: (B, S, d); ``p`` holds :func:`mamba_defs`' leaves
    as attributes.  The conv window and the scan start from zeros, as the
    reference's prefill does.  Returns (out (B, S, d), {"h": (B, di, N)
    fp32, "conv": (B, d_conv-1, di)})."""
    s = cfg.ssm or SSMConfig()
    B, S, d = x.shape
    di = s.expand * d
    xs, z = (x @ p.in_proj).split(di, dim=-1)
    prev = x.new_zeros((B, s.d_conv - 1, di))
    xp = torch.cat([prev, xs], dim=1)
    # depthwise causal conv of width d_conv, summed in the reference's order
    x_conv = F.silu(sum(xp[:, i : i + S] * p.conv_w[i] for i in range(s.d_conv)))
    h0 = torch.zeros((B, di, s.d_state), dtype=torch.float32, device=x.device)
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
