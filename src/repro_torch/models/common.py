"""Model-layer foundations: parameter definitions, initialisation, RoPE,
norms.

Parameters are declared through :class:`ParamDef`, as in the reference
package, with the same shapes, logical axis names and init rules, so that
both packages count the same parameters and a reference parameter tree maps
onto the port's modules one to one (:func:`repro_torch.interop.
model_params_from_numpy`).  The port runs on one card, so the reference's
logical-to-mesh axis rules and activation sharding constraints have no
counterpart here.
"""
from __future__ import annotations

import dataclasses
import functools

import torch
import torch.nn.functional as F

from ..kernels.rmsnorm import add_rmsnorm

# ---------------------------------------------------------------------------
# Parameter definitions
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    init: str = "normal"       # normal | zeros | ones | embed | small
    scale: float = 1.0         # extra multiplier on the init std

    def __post_init__(self) -> None:
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")


ParamTree = dict  # nested dict[str, ParamDef | ParamTree]


def init_params(defs: ParamTree, generator: torch.Generator,
                dtype: torch.dtype = torch.float32, device=None) -> dict:
    """A nested dict of tensors for ``defs``, drawn from ``generator`` leaf by
    leaf in sorted path order with the reference's rules: zeros, ones,
    ``N(0, 0.02·scale)`` for embeddings and ``N(0, scale / fan_in)`` (std
    ``scale / sqrt(fan_in)``) otherwise.  The draws happen in place on
    ``device`` (which must match the generator's), so an 8B-parameter tree
    never holds a second copy."""
    leaves: list[tuple[tuple[str, ...], ParamDef]] = []

    def walk(d, path):
        for k, v in sorted(d.items()):
            if isinstance(v, ParamDef):
                leaves.append((path + (k,), v))
            else:
                walk(v, path + (k,))

    walk(defs, ())

    def make(pd: ParamDef) -> torch.Tensor:
        if pd.init == "zeros":
            return torch.zeros(pd.shape, dtype=dtype, device=device)
        if pd.init == "ones":
            return torch.ones(pd.shape, dtype=dtype, device=device)
        fan_in = pd.shape[-2] if len(pd.shape) >= 2 else pd.shape[-1]
        std = pd.scale / max(fan_in, 1) ** 0.5
        if pd.init == "embed":
            std = pd.scale * 0.02
        t = torch.empty(pd.shape, dtype=torch.float32, device=device)
        return t.normal_(0.0, std, generator=generator).to(dtype)

    out: dict = {}
    for path, pd in leaves:
        node = out
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = make(pd)
    return out


def count_params(defs: ParamTree) -> int:
    total = 0

    def walk(d):
        nonlocal total
        for v in d.values():
            if isinstance(v, ParamDef):
                n = 1
                for s in v.shape:
                    n *= s
                total += n
            else:
                walk(v)

    walk(defs)
    return total


# ---------------------------------------------------------------------------
# Numerics
# ---------------------------------------------------------------------------


def add_rms_norm(x: torch.Tensor, delta: torch.Tensor | None, gain: torch.Tensor,
                 eps: float = 1e-5) -> tuple[torch.Tensor, torch.Tensor]:
    """The residual add and the RMSNorm after it: returns ``(x + delta,
    rmsnorm(x + delta))``, or ``(x, rmsnorm(x))`` when ``delta`` is None.
    One CUDA launch on the card, the plain versions on the CPU
    (:func:`repro_torch.kernels.rmsnorm.add_rmsnorm`)."""
    return add_rmsnorm(x, delta, gain, eps)


def rope_freqs(head_dim: int, theta: float) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32) / half))


@functools.lru_cache(maxsize=32)
def _rope_freqs_on(head_dim: int, theta: float, device: torch.device) -> torch.Tensor:
    """:func:`rope_freqs`, computed on the host (so every device rotates by
    the same frequencies) and copied once to ``device``."""
    return rope_freqs(head_dim, theta).to(device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq) integers.

    The reference's half-split layout: the first and second halves of the
    head dimension form the rotated pairs."""
    hd = x.shape[-1]
    freqs = _rope_freqs_on(hd, float(theta), x.device)            # (hd/2,)
    ang = positions[..., :, None, None].to(torch.float32) * freqs  # (..., S, 1, hd/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def swiglu(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    h = F.silu(x @ w1) * (x @ w3)
    return h @ w2


def softmax_fp32(scores: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return torch.softmax(scores.to(torch.float32), dim=dim)


def causal_mask(q_len: int, kv_len: int, q_offset: int = 0,
                window: int | None = None, device=None) -> torch.Tensor:
    """(q_len, kv_len) boolean mask; True = attend.  ``q_offset`` positions the
    query block inside the kv sequence (for decode/chunked prefill); ``window``
    enables sliding-window attention."""
    qi = torch.arange(q_len, device=device)[:, None] + q_offset
    kj = torch.arange(kv_len, device=device)[None, :]
    m = kj <= qi
    if window is not None:
        m &= kj > qi - window
    return m
