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

``--backward-parent`` times the backward kernels (and the forward ones
only when ``--variant`` or ``--parent`` is given too): an earlier
``rmsnorm_bwd.cu`` with the entry points ``rmsnorm_bwd_blocks(rows)`` and
``rmsnorm_bwd_launch`` (the
partial-row buffer sized by the first, ``dgain`` zero-filled as that
version's wrapper did), held to the plain backward and then timed in turns
with the tree's (parent, tree, tree, parent) at training's shapes (4, 256,
2048), (4, 256, 2732) and (2, 256, 2048) in fp32 and bf16 and at (4, 256,
4096) and (4, 256, 8192) in fp32, both forms; each build's device time is
split by kernel (the rows pass, the finish, a memset) from the profiler;
autograd's ``F.rms_norm`` backward is timed beside the fp32 cases.
``--backward-variant`` adds a ``rmsnorm_bwd.cu`` with the tree's entry
points (another ``kMaxBlocks`` or ring depth, say) to the turns.  Get the
parent with ``git show <commit>:src/repro_torch/kernels/rmsnorm/csrc/rmsnorm_bwd.cu``
into a git-ignored directory such as ``build/``.

Run from the root of the repository on a machine with the card:
    python3 tools/rmsnorm_probe.py [--variant path/to/rmsnorm.cu] [--parent path/to/rmsnorm.cu]
    python3 tools/rmsnorm_probe.py --backward-parent build/rmsnorm_bwd_parent.cu
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
BACKWARD_SHAPES = ((4, 256, 2048), (4, 256, 2732), (2, 256, 2048))
BACKWARD_WIDE = ((4, 256, 4096), (4, 256, 8192))      # fp32 only


def _bind_parent(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.rmsnorm_launch.argtypes = [ptr, ptr, ptr, i32, i32, ctypes.c_float, i32, ptr]
    lib.rmsnorm_launch.restype = ctypes.c_int


def _bind_parent_backward(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.rmsnorm_bwd_blocks.argtypes = [i32]
    lib.rmsnorm_bwd_blocks.restype = i32
    lib.rmsnorm_bwd_launch.argtypes = [ptr] * 7 + [i32, i32, ctypes.c_float, i32, ptr]
    lib.rmsnorm_bwd_launch.restype = ctypes.c_int


def kernel_split(fn, sets, calls: int = 24) -> str:
    """Device time per call of each kernel ``fn`` runs (the profiler's
    device events over ``calls`` eager calls, cycling ``sets``)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    step = cs.cycling(fn, sets)
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            step()
        torch.cuda.synchronize()
    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = e.name.replace("(anonymous namespace)::", "").replace("void ", "")
            name = name.split("(")[0].strip()
            by_name[name] = by_name.get(name, 0.0) + e.time_range.elapsed_us() / calls
    if not by_name:
        return "split not measured (the profiler recorded no device time)"
    return ", ".join(f"{n[:48]} {us:.2f} us" for n, us in sorted(by_name.items()))


def backward_probe(parent_path: str, variant_path: str | None) -> None:
    """The backward kernels of the tree, an earlier source and a variant,
    each checked and then timed in turns (see the module's docstring)."""
    import torch

    import chip_smoke as cs
    from repro_torch.kernels._build import KernelLibrary
    from repro_torch.kernels.rmsnorm import (
        add_rmsnorm_backward, ops, rmsnorm_backward, rmsnorm_backward_reference,
    )

    parent = KernelLibrary("rmsnorm_bwd-parent", Path(parent_path), _bind_parent_backward)
    libraries = [ops.BACKWARD_LIBRARY, parent]
    variant = None
    if variant_path:
        variant = KernelLibrary("rmsnorm_bwd-variant", Path(variant_path), ops._bind_backward)
        libraries.append(variant)
    cs.build_all(libraries)
    stream = torch.cuda.current_stream

    def parent_call(x, dy, dres, gain):
        lib = parent.load()
        rows, d = x.numel() // x.shape[-1], x.shape[-1]
        partial = torch.empty((lib.rmsnorm_bwd_blocks(rows), d), dtype=torch.float32,
                              device=x.device)
        dgain = torch.zeros(d, dtype=torch.float32, device=x.device)
        dx = torch.empty_like(x)
        rc = lib.rmsnorm_bwd_launch(
            x.data_ptr(), dy.data_ptr(), None if dres is None else dres.data_ptr(),
            gain.data_ptr(), dx.data_ptr(), partial.data_ptr(), dgain.data_ptr(), rows, d, 1e-5,
            ops.DTYPES[x.dtype], stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"parent backward launch failed: CUDA error {rc}")
        return dx, dgain

    def variant_call(x, dy, dres, gain):
        lib = variant.load()
        rows, d = x.numel() // x.shape[-1], x.shape[-1]
        scratch = torch.empty(lib.rmsnorm_bwd_scratch(rows, d), dtype=torch.float32,
                              device=x.device)
        dgain = torch.empty(d, dtype=torch.float32, device=x.device)
        dx = torch.empty_like(x)
        rc = lib.rmsnorm_bwd_launch(
            x.data_ptr(), dy.data_ptr(), None if dres is None else dres.data_ptr(),
            gain.data_ptr(), dx.data_ptr(), scratch.data_ptr(), dgain.data_ptr(), rows, d, 1e-5,
            ops.DTYPES[x.dtype], stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"variant backward launch failed: CUDA error {rc}")
        return dx, dgain

    def tree_call(x, dy, dres, gain):
        if dres is None:
            return rmsnorm_backward(x, dy, gain, 1e-5)
        return add_rmsnorm_backward(x, dres, dy, gain, 1e-5)

    builds = [("parent", parent_call), ("tree", tree_call)]
    if variant is not None:
        builds.append(("variant", variant_call))
    device = torch.device("cuda")
    cases = [(sh, dt) for sh in BACKWARD_SHAPES for dt in (torch.float32, torch.bfloat16)]
    cases += [(sh, torch.float32) for sh in BACKWARD_WIDE]
    for shape, dtype in cases:
        rows, d = math.prod(shape[:-1]), shape[-1]
        size = torch.finfo(dtype).bits // 8
        for fused in (False, True):
            n_in = 3 if fused else 2
            g = torch.Generator(device=device).manual_seed(rows + d + n_in)
            gain = 1.0 + 0.1 * torch.randn(d, generator=g, device=device)
            sets = cs.input_ring(
                lambda i: tuple(torch.randn(shape, generator=g, device=device).to(dtype)
                                for _ in range(n_in)), (n_in + 1) * rows * d * size)
            x, dy = sets[0][:2]
            dres = sets[0][2] if fused else None
            want_dx, want_dg = rmsnorm_backward_reference(x, dy, gain, 1e-5, dres=dres)
            part = rmsnorm_backward_reference(x, dy, gain, 1e-5)[0] if fused else None
            name = "add_rmsnorm_backward" if fused else "rmsnorm_backward"
            label = f"{name} {shape} {str(dtype)[6:]}"
            for which, fn in builds:
                dx, dg = fn(x, dy, dres, gain)
                again = fn(x, dy, dres, gain)
                torch.cuda.synchronize()
                cs.check_backward(f"{which} {label} dx", dx, want_dx, part)
                cs.check_backward(f"{which} {label} dgain", dg, want_dg)
                if not (torch.equal(again[0], dx) and torch.equal(again[1], dg)):
                    raise AssertionError(f"{which} {label}: a second run differs")
            bound, by = cs._bytes_or_flops(n_in * rows * d * size + rows * d * size + 2 * d * 4,
                                           rows * d * 8)
            print(f"{label}: {len(sets)} input sets in turn, each build within the plain "
                  f"version, second runs bit-equal; bound {bound:.6f} ms ({by})", flush=True)
            call = (lambda fn: (lambda *t: fn(t[0], t[1], t[2] if fused else None, gain)))
            order = [builds[0], builds[1], builds[1], builds[0]]
            if variant is not None:
                order = [builds[2], builds[1], builds[1], builds[2]] + order
            turns = [f"{which} {cs.graph_ms(cs.cycling(call(fn), sets), iters=100):.5f}"
                     for which, fn in order]
            print(f"  in turns (ms): {', '.join(turns)}", flush=True)
            for which, fn in builds:
                print(f"  {which} split: {kernel_split(call(fn), sets)}", flush=True)
        if dtype == torch.float32:
            for fused in (False, True):
                cs.time_norm_backward(device, shape, fused)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--variant", help="a rmsnorm.cu with the tree's entry point, in turns")
    parser.add_argument("--parent", help="an earlier rmsnorm.cu (norm alone), in turns")
    parser.add_argument("--backward-parent",
                        help="an earlier rmsnorm_bwd.cu: time the backward kernels in turns")
    parser.add_argument("--backward-variant",
                        help="a rmsnorm_bwd.cu with the tree's entry points, in turns too")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("rmsnorm_probe: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels._build import KernelLibrary
    from repro_torch.kernels.rmsnorm import add_rmsnorm, add_rmsnorm_reference, ops, rmsnorm

    print(cs.card_line(), flush=True)
    if args.backward_parent:
        backward_probe(args.backward_parent, args.backward_variant)
        if not (args.variant or args.parent):
            return 0
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
