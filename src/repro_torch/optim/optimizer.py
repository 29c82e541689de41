"""AdamW with cosine schedule, global-norm clipping and mixed precision
(fp32 master copies and moments in the optimizer state, whatever the
parameters' dtype), as the reference package's ``optim/optimizer.py``.

Parameters, gradients and the moments are flat dicts of tensors keyed by
parameter name (``dict(model.named_parameters())``).  The update is
computed leaf by leaf in the reference's order (clip, moments, bias
correction, decoupled weight decay) and written into the parameters and
the state in place: the reference returns new trees, but on the card a
second copy of a 1.3B-parameter model's state would cost gigabytes, so
:func:`adamw_update` returns the same dicts, updated.

The leaves may be DTensors (the sharded train step): the moments and the
master copies then take their parameter's placements (ZeRO), and the
gradient norm sums every shard's squares.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch.distributed.tensor import DTensor


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    min_lr_frac: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    use_master: bool = True       # keep fp32 master weights when params are low-precision
    moments_dtype: str = "float32"  # "bfloat16" halves m/v memory


def _moments_dtype(cfg: AdamWConfig) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[cfg.moments_dtype]


def cosine_lr(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup then cosine decay to ``min_lr_frac`` of the peak, in
    fp32 on ``step``'s device (``step`` an integer tensor)."""
    step = step.to(torch.float32)
    warm = torch.clamp_max(step / max(cfg.warmup_steps, 1), 1.0)
    t = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                    0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.peak_lr * warm * frac


def init_opt_state(cfg: AdamWConfig, params: dict[str, torch.Tensor]) -> dict:
    """``{"step": 0, "m": zeros, "v": zeros, "master": fp32 copies}`` (no
    ``master`` unless ``cfg.use_master``), each leaf on its parameter's
    device (a DTensor parameter's with its placements); the moments in
    ``cfg.moments_dtype``."""
    mdt = _moments_dtype(cfg)
    device = next(iter(params.values())).device

    def zeros(p):
        return torch.zeros_like(p, dtype=mdt, memory_format=torch.contiguous_format)

    state = {
        "step": torch.zeros((), dtype=torch.int32, device=device),
        "m": {n: zeros(p) for n, p in params.items()},
        "v": {n: zeros(p) for n, p in params.items()},
    }
    if cfg.use_master:
        state["master"] = {n: p.detach().to(torch.float32, copy=True)
                           for n, p in params.items()}
    return state


def _sum_squares(t: torch.Tensor) -> torch.Tensor:
    sq = torch.sum(torch.square(t.float()))
    # a sharded leaf's sum is a partial sum per rank: add up every shard's
    return sq.full_tensor() if isinstance(sq, DTensor) else sq


def global_norm(tree: dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum over leaves of their sums of squares, in fp32; a
    DTensor leaf's sum covers all of its shards."""
    return torch.sqrt(sum(_sum_squares(t) for t in tree.values()))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: dict[str, torch.Tensor],
                 grads: dict[str, torch.Tensor], state: dict) -> tuple[dict, dict, dict]:
    """One AdamW step, in place.  Returns (params, state, metrics), the
    first two the dicts passed in; metrics ``lr`` and ``grad_norm`` (the
    norm before clipping), 0-d fp32 tensors."""
    step = state["step"] + 1
    lr = cosine_lr(cfg, step)
    gnorm = global_norm(grads)
    scale = torch.clamp_max(cfg.clip_norm / torch.clamp_min(gnorm, 1e-9), 1.0)
    b1c = 1 - cfg.b1 ** step.to(torch.float32)
    b2c = 1 - cfg.b2 ** step.to(torch.float32)
    mdt = _moments_dtype(cfg)
    master = state.get("master") if cfg.use_master else None
    for name, p in params.items():
        g = grads[name].to(torch.float32) * scale
        m = (cfg.b1 * state["m"][name].to(torch.float32) + (1 - cfg.b1) * g).to(mdt)
        v = (cfg.b2 * state["v"][name].to(torch.float32) + (1 - cfg.b2) * g * g).to(mdt)
        state["m"][name].copy_(m)
        state["v"][name].copy_(v)
        p32 = (master[name] if master is not None else p).to(torch.float32)
        u = (m.to(torch.float32) / b1c) / (torch.sqrt(v.to(torch.float32) / b2c) + cfg.eps)
        new = p32 - lr * (u + cfg.weight_decay * p32)
        if master is not None:
            master[name].copy_(new)
        p.copy_(new.to(p.dtype))
    state["step"].copy_(step)
    return params, state, {"lr": lr, "grad_norm": gnorm}
