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
