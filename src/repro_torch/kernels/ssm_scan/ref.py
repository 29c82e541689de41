"""Plain PyTorch version of the selective-scan kernel: the contract of the
reference package's ``kernels/ssm_scan/ref.py::ssm_scan_reference``, a
sequential recurrence in fp32."""
from __future__ import annotations

import torch


def ssm_scan_reference(dt, x, bmat, cmat, a, h0):
    """dt, x: (B, S, D); bmat, cmat: (B, S, N); a: (D, N); h0: (B, D, N).

    Per step ``h ← exp(dt_t·a) ⊙ h + (dt_t·x_t)·B_t`` and
    ``y_t = Σ_n h·C_t``.  Returns (y (B, S, D), hT (B, D, N)), both fp32;
    every input is converted to fp32 first."""
    dt, x, bmat, cmat, a = (t.float() for t in (dt, x, bmat, cmat, a))
    h = h0.float().clone()
    ys = []
    for t in range(dt.shape[1]):
        a_t = torch.exp(dt[:, t, :, None] * a)                         # (B, D, N)
        h = a_t * h + (dt[:, t] * x[:, t])[..., None] * bmat[:, t, None, :]
        ys.append((h * cmat[:, t, None, :]).sum(-1))                   # (B, D)
    if not ys:
        return dt.new_zeros(dt.shape), h
    return torch.stack(ys, dim=1), h


def ssm_scan_backward_reference(dt, x, bmat, cmat, a, h0, dy, dhT=None):
    """The gradients ``(ddt, dx, dB, dC, dA, dh0)`` of
    :func:`ssm_scan_reference` given ``dy = dL/dy`` (B, S, D) and ``dhT =
    dL/dhT`` (B, D, N, or None for an unused final state), written out as
    the backward kernel computes them (no autograd), in fp32: the states
    ``h_t`` of the forward recurrence, then, from ``g = dhT`` for t from
    S − 1 down to 0, ``g += dy_t·C_t`` (the gradient of ``h_t``),
    ``dC_t = Σ_d dy_t·h_t``, ``dB_t = Σ_d g·dt_t·x_t``, ``gB = Σ_n g·B_t``,
    ``e = g·h_{t−1}·exp(dt_t·A)``, ``dx_t = dt_t·gB``, ``ddt_t = Σ_n e·A +
    x_t·gB``, ``dA += Σ_b e·dt_t`` and ``g = g·exp(dt_t·A)``; ``dh0`` is the
    last ``g``.  Each gradient in its input's dtype."""
    f = [t.float() for t in (dt, x, bmat, cmat, a)]
    dt32, x32, b32, c32, a32 = f
    B, S, D = dt.shape
    h = h0.float()
    hs = [h]
    for t in range(S):
        h = (torch.exp(dt32[:, t, :, None] * a32) * h
             + (dt32[:, t] * x32[:, t])[..., None] * b32[:, t, None, :])
        hs.append(h)
    g = torch.zeros_like(hs[0]) if dhT is None else dhT.float().clone()
    ddt, dx = torch.empty_like(dt32), torch.empty_like(x32)
    db, dc = torch.empty_like(b32), torch.empty_like(c32)
    da = torch.zeros_like(a32)
    dy = dy.float()
    for t in reversed(range(S)):
        dtv, xv, dyv = dt32[:, t], x32[:, t], dy[:, t]                  # (B, D)
        a_t = torch.exp(dtv[..., None] * a32)                           # (B, D, N)
        g = g + dyv[..., None] * c32[:, t, None, :]
        dc[:, t] = (dyv[..., None] * hs[t + 1]).sum(1)
        db[:, t] = (g * (dtv * xv)[..., None]).sum(1)
        gb = (g * b32[:, t, None, :]).sum(-1)
        e = g * hs[t] * a_t
        da += (e * dtv[..., None]).sum(0)
        ddt[:, t] = (e * a32).sum(-1) + xv * gb
        dx[:, t] = dtv * gb
        g = g * a_t
    return (ddt.to(dt.dtype), dx.to(x.dtype), db.to(bmat.dtype), dc.to(cmat.dtype),
            da.to(a.dtype), g.to(h0.dtype))
