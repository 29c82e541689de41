"""Device selection for the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: ``None`` means the CUDA card.

    There is no fallback: asking for CUDA on a host without a card raises,
    so a run never lands on the CPU unless the caller names it
    (``device="cpu"``, as the tests do).

    Also pins fp32 matrix products to full precision.  The reference
    simulator runs in float32 with x64 off, and its container-contention
    products (``C.T @ x``) are exact float32 sums; TF32 would keep about
    three decimal digits and push the tick physics off the reference.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the host"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
