"""Plain PyTorch version of the flash-attention kernel: the contract of the
reference package's ``kernels/flash_attention/ref.py::attention_reference``
and ``ops.py::flash_attention_reference``, with keys of a length of their
own in non-causal calls (the decoder's cross-attention over the encoder's
frames, which the reference computes with its plain ``_gqa_core`` and an
all-ones mask), and the plain backward that the backward kernel
implements.

A causal call may also take one shard of the keys (``key_offset``: the keys
at positions ``key_offset ... key_offset + Sk - 1`` of the queries'
sequence), as attention split over the keys runs it (MLA where the heads do
not divide the tensor-parallel ranks, the reference's ``score_axes`` on the
key axis): :func:`flash_attention_lse_reference` gives the shard's output
and each row's log-sum-exp, which the shards combine, and the backward
takes the combined row statistics."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def check_key_length(S: int, Sk: int, causal: bool, window: int | None,
                     key_offset: int | None = None) -> None:
    """Keys of their own length (``Sk != S``) only in a non-causal call
    without a window: the causal and window masks place query ``s`` at key
    ``s``.  With ``key_offset`` the call is causal without a window and its
    keys are those at positions ``key_offset ... key_offset + Sk - 1``,
    which must lie among the ``S`` queries' positions."""
    if key_offset is not None:
        if not causal or window is not None:
            raise ValueError("a key offset places a shard of the keys under the causal mask: "
                             "it takes causal=True and no window")
        if key_offset < 0 or key_offset + Sk > S:
            raise ValueError(f"keys at positions {key_offset} .. {key_offset + Sk - 1} lie "
                             f"outside the {S} queries' positions")
        return
    if Sk != S and (causal or window is not None):
        raise ValueError(
            f"{Sk} keys for {S} queries: a causal or windowed call takes as many keys as queries")


def attention_mask(S: int, Sk: int, causal: bool, window: int | None, device,
                   key_offset: int = 0) -> torch.Tensor:
    """(S, Sk) bool: key ``t`` (at position ``key_offset + t``) is seen by
    query ``s`` when its position is ``<= s`` if causal and ``> s -
    window`` if a window is given."""
    qi = torch.arange(S, device=device)[:, None]
    kj = torch.arange(Sk, device=device)[None, :] + key_offset
    mask = torch.ones((S, Sk), dtype=torch.bool, device=device)
    if causal:
        mask &= kj <= qi
    if window is not None:
        mask &= kj > qi - window
    return mask


def attention_reference(
    q: torch.Tensor,                 # (B, H, S, hd)
    k: torch.Tensor,                 # (B, KV, Sk, hd)
    v: torch.Tensor,                 # (B, KV, Sk, hd)
    *,
    causal: bool = True,
    window: int | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """Softmax attention over all ``Sk`` keys in fp32; query head ``h``
    reads kv head ``h // (H // KV)``.  ``Sk`` may differ from ``S`` only
    when the call is non-causal without a window (else ``ValueError``).
    Output in ``q``'s dtype."""
    B, H, S, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    check_key_length(S, Sk, causal, window)
    G = H // KV
    if scale is None:
        scale = hd ** -0.5
    qg = q.reshape(B, KV, G, S, hd).float()
    s = torch.einsum("bkgqh,bkth->bkgqt", qg, k.float()) * scale
    s = torch.where(attention_mask(S, Sk, causal, window, q.device), s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqt,bkth->bkgqh", p, v.float())
    return o.reshape(B, H, S, hd).to(q.dtype)


def flash_attention_reference(q, k, v, causal=True, window=None, scale=None):
    """:func:`attention_reference` in the model layout: q (B, S, H, hd), k
    and v (B, Sk, KV, hd)."""
    out = attention_reference(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=causal, window=window, scale=scale,
    )
    return out.transpose(1, 2)


def flash_attention_lse_reference(q, k, v, causal=True, window=None, scale=None,
                                  key_offset=None):
    """``(out, lse)`` in the model layout: :func:`flash_attention_reference`'s
    output, 0 in a row that sees no key (a key shard after the row's
    position), and each query row's log-sum-exp of its visible scaled
    scores, (B, H, S) fp32 (-1e30 where it sees none), as the kernel's
    forward under grad writes them.  ``key_offset`` as in
    :func:`check_key_length`."""
    B, S, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    check_key_length(S, Sk, causal, window, key_offset)
    G = H // KV
    if scale is None:
        scale = hd ** -0.5
    qg = q.float().transpose(1, 2).reshape(B, KV, G, S, hd)
    kf, vf = k.float().transpose(1, 2), v.float().transpose(1, 2)        # (B, KV, Sk, hd)
    mask = attention_mask(S, Sk, causal, window, q.device, key_offset or 0)
    s = torch.where(mask, torch.einsum("bkgqh,bkth->bkgqt", qg, kf) * scale, NEG_INF)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    o = torch.einsum("bkgqt,bkth->bkgqh", p, vf).reshape(B, H, S, v.shape[-1])
    return o.transpose(1, 2).to(q.dtype), lse.reshape(B, H, S)


def flash_attention_backward_reference(q, k, v, out, dout, causal=True, window=None, scale=None,
                                       lse=None, key_offset=None):
    """The gradients ``(dq, dk, dv)`` of :func:`flash_attention_reference`
    in the model layout, given its output ``out`` and the output's gradient
    ``dout``, written out as the backward kernel computes them (no
    autograd), in fp32: each query row's log-sum-exp ``lse`` of its
    visible scaled scores, ``P = exp(scale·q·kᵀ − lse)`` (0 where masked),
    ``D = Σ dout·out`` per row, ``dS = P ⊙ (dout·vᵀ − D)``, ``dq = scale·dS·k``,
    ``dk = scale·dSᵀ·q`` and ``dv = Pᵀ·dout``, dk and dv summed over each kv
    head's G query heads.  Gradients in the inputs' dtypes.

    ``lse`` (B, H, S), where given, stands for the rows' own statistics:
    for a key shard (``key_offset``, as in :func:`check_key_length`) the
    whole row's, combined over the shards, with ``out`` the combined
    output; the shard's dq is then its part of the row's dq, its dk and dv
    its keys' whole gradients."""
    B, S, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    check_key_length(S, Sk, causal, window, key_offset)
    G = H // KV
    if scale is None:
        scale = hd ** -0.5
    grouped = lambda t: t.float().transpose(1, 2).reshape(B, KV, G, S, t.shape[-1])
    qg, og, dog = grouped(q), grouped(out), grouped(dout)
    kf, vf = k.float().transpose(1, 2), v.float().transpose(1, 2)        # (B, KV, Sk, hd)
    mask = attention_mask(S, Sk, causal, window, q.device, key_offset or 0)
    s = torch.where(mask, torch.einsum("bkgqh,bkth->bkgqt", qg, kf) * scale, NEG_INF)
    if lse is None:
        lse = torch.logsumexp(s, dim=-1, keepdim=True)
    else:
        lse = lse.float().reshape(B, KV, G, S, 1)
    p = torch.where(mask, torch.exp(s - lse), 0.0)
    delta = (dog * og).sum(-1, keepdim=True)
    ds = p * (torch.einsum("bkgqh,bkth->bkgqt", dog, vf) - delta)
    dq = torch.einsum("bkgqt,bkth->bkgqh", ds, kf) * scale
    dk = torch.einsum("bkgqt,bkgqh->bkth", ds, qg) * scale
    dv = torch.einsum("bkgqt,bkgqh->bkth", p, dog)
    dq = dq.reshape(B, H, S, hd).transpose(1, 2)
    return dq.to(q.dtype), dk.transpose(1, 2).to(k.dtype), dv.transpose(1, 2).to(v.dtype)
