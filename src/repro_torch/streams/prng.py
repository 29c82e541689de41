"""The reference simulator's noise, drawn in torch: JAX's threefry2x32
generator as jax 0.9.0 runs it with ``jax_threefry_partitionable=True``.

The reference draws, for tick ``t`` of a run seeded with ``seed``,
``jax.random.normal(k_t, (n_inst,))`` with ``k_t = jax.random.split(
jax.random.PRNGKey(seed), n_ticks)[t]``.  Under the partitionable scheme
both steps hash a counter with the key: ``split`` gives key ``t`` as the
two words of ``threefry2x32(key, (0, t))``, and element ``i`` of the random
bits is the xor of the two words of ``threefry2x32(k_t, (0, i))``.  So a
tick's noise does not depend on ``n_ticks`` and instance ``i``'s noise does
not depend on how far the instance axis is padded.

Everything here is integer tensor math on int64 tensors that hold uint32
values (masked to 32 bits after each add and shift), so it runs the same
on the CPU and on the card and gives jax's bits exactly.  The normal is
``sqrt(2)·erfinv(u)`` with ``u`` uniform in ``[nextafter(-1, 0), 1)`` from
the top 23 bits, as ``jax.random.normal`` builds it in float32.  torch's
``erfinv`` and the one XLA compiles into ``jax.random.normal`` round
differently, so the normals agree to a few float32 ulps, furthest apart in
the tails (``tests/test_torch_prng.py`` states the bound).
"""
from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
#: Threefry-2x32's rotation schedule and key-schedule parity constant.
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
KS_PARITY = 0x1BD11BDA
#: ``jax.random.normal``'s float32 uniform range, ``[nextafter(-1, 0), 1)``.
UNIFORM_LO = np.nextafter(np.float32(-1.0), np.float32(0.0))
UNIFORM_HI = np.float32(1.0)


def threefry2x32(k1, k2, x1, x2):
    """The 20-round Threefry-2x32 hash of the counter words ``(x1, x2)``
    under the key ``(k1, k2)``; all four are int64 tensors (or ints) of
    uint32 values and broadcast together.  Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ KS_PARITY)
    x0 = (x1 + ks[0]) & MASK32
    x1 = (x2 + ks[1]) & MASK32
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = ((x1 << r) & MASK32) | (x1 >> (32 - r))
            x1 = x0 ^ x1
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x0, x1


def prng_key(seeds, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for each seed: an int64 (B, 2) tensor
    of the key words.  With x64 off JAX takes 32-bit seeds, so a seed must
    lie in ``[-2**31, 2**32)``; a negative one is taken modulo 2**32."""
    seeds = [int(s) for s in seeds]
    for s in seeds:
        if not -(2**31) <= s < 2**32:
            raise ValueError(f"seed {s} is outside the 32-bit range jax.random.PRNGKey takes")
    k2 = torch.tensor([s & MASK32 for s in seeds], dtype=torch.int64, device=device)
    return torch.stack([torch.zeros_like(k2), k2], dim=-1)


def split(keys: torch.Tensor, start: int, count: int) -> torch.Tensor:
    """Keys ``start .. start + count - 1`` of ``jax.random.split(key, n)``
    for each key of ``keys`` (..., 2), for any ``n >= start + count``:
    shape (..., count, 2)."""
    t = torch.arange(start, start + count, dtype=torch.int64, device=keys.device)
    a, b = threefry2x32(keys[..., 0, None], keys[..., 1, None], t >> 32, t & MASK32)
    return torch.stack([a, b], dim=-1)


def random_bits(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.bits(key, (n,))`` (uint32) for each key of ``keys``
    (..., 2), as int64 values: shape (..., n)."""
    i = torch.arange(n, dtype=torch.int64, device=keys.device)
    a, b = threefry2x32(keys[..., 0, None], keys[..., 1, None], i >> 32, i & MASK32)
    return a ^ b


def uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """jax's float32 uniform on ``[nextafter(-1, 0), 1)`` from 32 random
    bits: the top 23 as the mantissa of a float in [1, 2), shifted and
    scaled in float32."""
    mantissa = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = mantissa.view(torch.float32) - 1.0
    lo = torch.tensor(UNIFORM_LO, device=bits.device)
    span = torch.tensor(UNIFORM_HI, device=bits.device) - lo
    return torch.maximum(lo, floats * span + lo)


def normal(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.normal(key, (n,))`` in float32 for each key of ``keys``
    (..., 2): shape (..., n)."""
    u = uniform_from_bits(random_bits(keys, n))
    return torch.erfinv(u) * torch.tensor(np.float32(np.sqrt(2.0)), device=u.device)
