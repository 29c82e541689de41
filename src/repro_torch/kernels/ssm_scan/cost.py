"""What one launch of the selective-scan kernels costs: the FLOPs they do
and the bytes they must move (each input read once, each output written
once), from the shapes.  ``chip_smoke.py`` divides them by the card's
rates for each kernel's bound; counters (:mod:`repro_torch.kernels._cost`)
add them up per launch."""
from __future__ import annotations


def ssm_scan_cost(B: int, S: int, D: int, N: int, itemsize: int = 4,
                  ckpt_steps: int = 0) -> tuple[int, int]:
    """``(flops, bytes)`` of a forward launch: dt and x read (B·S·D each, in
    their dtype) and y written in fp32, B and C read once (B·S·N each), a,
    h0 and hT once in fp32; 1 + 7·N operations per (b, t, channel) (dt·x;
    per state: dt·A, exp, a·h, dx·B, +, h·C, +).  ``ckpt_steps`` > 0 adds
    the state stored every that many steps (the forward under grad)."""
    nbytes = itemsize * (2 * B * S * D + 2 * B * S * N) + 4 * (B * S * D + D * N + 2 * B * D * N)
    if ckpt_steps:
        nbytes += 4 * B * -(-S // ckpt_steps) * D * N
    return B * S * D * (1 + 7 * N), nbytes


def ssm_scan_backward_cost(B: int, S: int, D: int, N: int, itemsize: int = 4) -> tuple[int, int]:
    """``(flops, bytes)`` of a backward launch (the scan and the finish): dt
    and x read and ddt, dx written (B·S·D each, in their dtype), dy read in
    fp32, B and C read and dB, dC written (B·S·N each), A read and dA
    written (D·N), h0 read and dh0 written (B·D·N) in fp32, each once; per
    (b, t, channel) 20·N + 4 operations (the state recomputed: dt·A, exp,
    a·h, dx·B, +; its gradient: dy·C and +, dy·h, g·dx, g·B and +, g·h·a,
    e·dt and +, e·A and +, g·a)."""
    nbytes = itemsize * (4 * B * S * D + 4 * B * S * N) + 4 * (B * S * D + 2 * D * N + 2 * B * D * N)
    return B * S * D * (20 * N + 4), nbytes
