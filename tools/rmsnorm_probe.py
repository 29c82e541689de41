#!/usr/bin/env python3
"""Device time of the RMSNorm kernels on the card, beside the unfused pair
and, in turns, other builds of the kernel.

At the serving paths' shapes ((4, 1, d) decode and (1, 168, d) prefill for
d = 4096 and 8192, fp32 and bf16) it times, from CUDA-graph replay over the
same input sets as ``chip_smoke.py`` (one at decode; at prefill enough that
each call reads from HBM): ``rmsnorm``, ``add_rmsnorm`` and the pair the
fused kernel replaces (``x + delta``, then the tree's ``rmsnorm``).  Two
options add a build of another source, timed in turns with the tree's
(other, tree, tree, other) after its result is checked:

- ``--variant``: a ``rmsnorm.cu`` with the tree's C entry point
  ``rmsnorm_launch(x, delta, gain, s, h, rows, d, eps, dtype, stream)``,
  say the tree's source with another ``kThreads``; both kernels are timed;
- ``--parent``: an earlier ``rmsnorm.cu`` whose entry point is
  ``rmsnorm_launch(x, gain, out, rows, d, eps, dtype, stream)``; the norm
  alone is timed.

Run from the root of the repository on a machine with the card:
    python3 tools/rmsnorm_probe.py [--variant path/to/rmsnorm.cu] [--parent path/to/rmsnorm.cu]
"""
from __future__ import annotations

import argparse
import ctypes
import math
import os
import sys
from pathlib import Path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

SHAPES = ((4, 1, 4096), (1, 168, 4096), (4, 1, 8192), (1, 168, 8192))


def _bind_parent(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.rmsnorm_launch.argtypes = [ptr, ptr, ptr, i32, i32, ctypes.c_float, i32, ptr]
    lib.rmsnorm_launch.restype = ctypes.c_int


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--variant", help="a rmsnorm.cu with the tree's entry point, in turns")
    parser.add_argument("--parent", help="an earlier rmsnorm.cu (norm alone), in turns")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("rmsnorm_probe: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels._build import KernelLibrary
    from repro_torch.kernels.rmsnorm import add_rmsnorm, add_rmsnorm_reference, ops, rmsnorm

    print(cs.card_line(), flush=True)
    libraries = [ops.LIBRARY]
    variant = parent = None
    if args.variant:
        variant = KernelLibrary("rmsnorm-variant", Path(args.variant), ops._bind)
        libraries.append(variant)
    if args.parent:
        parent = KernelLibrary("rmsnorm-parent", Path(args.parent), _bind_parent)
        libraries.append(parent)
    cs.build_all(libraries)
    stream = torch.cuda.current_stream

    def variant_add(x, delta, gain):
        s, h = torch.empty_like(x), torch.empty_like(x)
        rc = variant.load().rmsnorm_launch(
            x.data_ptr(), delta.data_ptr(), gain.data_ptr(), s.data_ptr(), h.data_ptr(),
            x.numel() // x.shape[-1], x.shape[-1], 1e-5, ops.DTYPES[x.dtype],
            stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"variant add_rmsnorm launch failed: CUDA error {rc}")
        return s, h

    def variant_norm(x, gain):
        h = torch.empty_like(x)
        rc = variant.load().rmsnorm_launch(
            x.data_ptr(), None, gain.data_ptr(), None, h.data_ptr(), x.numel() // x.shape[-1],
            x.shape[-1], 1e-5, ops.DTYPES[x.dtype], stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"variant rmsnorm launch failed: CUDA error {rc}")
        return h

    def parent_norm(x, gain):
        out = torch.empty_like(x)
        rc = parent.load().rmsnorm_launch(
            x.data_ptr(), gain.data_ptr(), out.data_ptr(), x.numel() // x.shape[-1],
            x.shape[-1], 1e-5, ops.DTYPES[x.dtype], stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"parent rmsnorm launch failed: CUDA error {rc}")
        return out

    def check_close(name, got, want):
        err = (got.float() - want.float()).abs()
        tol = (cs.RMS_FP32_TOL * (1 + want.float().abs()) if got.dtype == torch.float32
               else cs.bf16_ulp(want))
        if not bool((err <= tol).all()):
            raise AssertionError(f"{name}: off its plain version by {float(err.max()):.3e}")

    def in_turns(label, other, tree, sets):
        turns = []
        for which, fn in (("other", other), ("tree", tree), ("tree", tree), ("other", other)):
            turns.append(f"{which} {cs.graph_ms(cs.cycling(fn, sets), iters=200):.5f}")
        print(f"  {label} in turns (ms): {', '.join(turns)}", flush=True)

    device = torch.device("cuda")
    for dtype in (torch.float32, torch.bfloat16):
        for shape in SHAPES:
            g = torch.Generator(device=device).manual_seed(shape[1] + shape[2])
            gain = 1.0 + 0.1 * torch.randn(shape[-1], generator=g, device=device)
            d, rows = shape[-1], math.prod(shape[:-1])
            size = torch.finfo(dtype).bits // 8
            sets = cs.input_ring(
                lambda i: (torch.randn(shape, generator=g, device=device).to(dtype),
                           (0.5 * torch.randn(shape, generator=g, device=device)).to(dtype)),
                4 * rows * d * size)
            x, delta = sets[0]
            want_s, want_h = add_rmsnorm_reference(x, delta, gain)
            s, h = add_rmsnorm(x, delta, gain)
            torch.cuda.synchronize()
            if not (torch.equal(s, want_s) and torch.equal(h, rmsnorm(s, gain))):
                raise AssertionError(f"add_rmsnorm {shape} {dtype}: not x + delta, rmsnorm(s)")
            err = float((h.float() - want_h.float()).abs().max())
            norm_b, _ = cs.rmsnorm_bound(rows, d)
            add_b, _ = cs.add_rmsnorm_bound(rows, d)
            print(f"{tuple(shape)} {str(dtype)[6:]}: {len(sets)} input sets in turn, "
                  f"max|h-plain| {err:.3e}, fp32 bound rmsnorm {norm_b:.6f} add_rmsnorm "
                  f"{add_b:.6f} ms", flush=True)
            t_norm = cs.graph_ms(cs.cycling(lambda x, dl: rmsnorm(x, gain), sets), iters=200)
            t_add = cs.graph_ms(cs.cycling(lambda x, dl: add_rmsnorm(x, dl, gain), sets),
                                iters=200)
            pair = cs.graph_ms(cs.cycling(lambda x, dl: rmsnorm(x + dl, gain), sets), iters=200)
            print(f"  rmsnorm {t_norm:.5f} ms  add_rmsnorm {t_add:.5f} ms  pair x + delta, "
                  f"rmsnorm {pair:.5f} ms", flush=True)
            if variant is not None:
                vs, vh = variant_add(x, delta, gain)
                if not torch.equal(vs, s):
                    raise AssertionError(f"variant {shape} {dtype}: s is not x + delta")
                check_close(f"variant {shape} {dtype}", vh, want_h)
                in_turns("add_rmsnorm, variant", lambda x, dl: variant_add(x, dl, gain),
                         lambda x, dl: add_rmsnorm(x, dl, gain), sets)
                in_turns("rmsnorm, variant", lambda x, dl: variant_norm(x, gain),
                         lambda x, dl: rmsnorm(x, gain), sets)
            if parent is not None:
                check_close(f"parent {shape} {dtype}", parent_norm(x, gain),
                            add_rmsnorm_reference(x, None, gain)[1])
                in_turns("rmsnorm, parent", lambda x, dl: parent_norm(x, gain),
                         lambda x, dl: rmsnorm(x, gain), sets)
    return 0


if __name__ == "__main__":
    sys.exit(main())
