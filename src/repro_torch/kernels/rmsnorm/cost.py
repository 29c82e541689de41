"""What one launch of the norm kernels costs: the FLOPs they do and the
bytes they must move (each input read once, each output written once),
from the shapes.  ``chip_smoke.py`` divides them by the card's rates for
each kernel's bound; counters (:mod:`repro_torch.kernels._cost`) add them
up per launch."""
from __future__ import annotations


def rmsnorm_cost(rows: int, d: int, itemsize: int = 4) -> tuple[int, int]:
    """``(flops, bytes)``: x read and the output written, the gain read once
    in fp32; 4 flops per element."""
    return rows * d * 4, 2 * rows * d * itemsize + d * 4


def add_rmsnorm_cost(rows: int, d: int, itemsize: int = 4) -> tuple[int, int]:
    """``(flops, bytes)``: x and delta read, s and h written, the gain read
    once in fp32; 5 flops per element (the add, the square-and-sum, two
    scalings)."""
    return rows * d * 5, 4 * rows * d * itemsize + d * 4


def norm_backward_cost(rows: int, d: int, fused: bool, itemsize: int = 4) -> tuple[int, int]:
    """``(flops, bytes)`` of a backward launch (both of its kernels): x, dy
    (and the residual gradient, ``fused``) read and dx written once, the
    gain read and its gradient written once in fp32; about 8 flops per
    element (two row sums, dx, the gain's partial)."""
    return rows * d * 8, (4 if fused else 3) * rows * d * itemsize + 2 * d * 4
