"""Plain PyTorch version of the flash-attention kernel: the contract of the
reference package's ``kernels/flash_attention/ref.py::attention_reference``
and ``ops.py::flash_attention_reference``."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_reference(
    q: torch.Tensor,                 # (B, H, S, hd)
    k: torch.Tensor,                 # (B, KV, S, hd)
    v: torch.Tensor,                 # (B, KV, S, hd)
    *,
    causal: bool = True,
    window: int | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """Softmax attention over the whole sequence in fp32; query head ``h``
    reads kv head ``h // (H // KV)``.  Output in ``q``'s dtype."""
    B, H, S, hd = q.shape
    KV = k.shape[1]
    G = H // KV
    if scale is None:
        scale = hd ** -0.5
    qg = q.reshape(B, KV, G, S, hd).float()
    s = torch.einsum("bkgqh,bkth->bkgqt", qg, k.float()) * scale
    qi = torch.arange(S, device=q.device)[:, None]
    kj = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kj <= qi
    if window is not None:
        mask &= kj > qi - window
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqt,bkth->bkgqh", p, v.float())
    return o.reshape(B, H, S, hd).to(q.dtype)


def flash_attention_reference(q, k, v, causal=True, window=None, scale=None):
    """:func:`attention_reference` in the model layout (B, S, H, hd)."""
    out = attention_reference(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=causal, window=window, scale=scale,
    )
    return out.transpose(1, 2)
