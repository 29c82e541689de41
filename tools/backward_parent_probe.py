#!/usr/bin/env python3
"""The flash-attention and selective-scan backward kernels against earlier
builds of themselves on the card.

``--flash-parent`` is an earlier ``flash_attention_bwd.cu`` and
``--scan-parent`` an earlier ``ssm_scan_bwd.cu`` whose entry points find
the row statistics and range-start states themselves:
``flash_attention_bwd_launch(q, k, v, out, dout, dq, dk, dv, lse_ws,
delta_ws, B, S, Sk, H, KV, hd, scale, causal, window, dtype, stream)``
with both workspaces scratch, and ``ssm_scan_bwd_workspace(B, S, D, N)``,
``ssm_scan_bwd_launch(dt, x, bm, cm, a, h0, dy, dhT, ddt, dx, dB, dC, dA,
dh0, work, B, S, D, N, bm_sb, bm_ss, cm_sb, cm_ss, dtype, stream)``.  At the training
shapes of ``chip_smoke.py``'s phase 21 (b) (stablelm-1.6b's attention, (4,
256, 32 heads, hd 64), causal) and 21 (c) (the jamba pair's attention, (4,
256, 64 heads over 8, hd 128), causal, and its scan, (4, 256, 16384, 16))
it holds each build, parent and tree, to the plain version (each gradient
within 1e-4 of its largest entry, a second launch bit for bit the first),
then times both from CUDA-graph replay in turns (parent, tree, tree,
parent), fp32, beside the bound ``chip_smoke.py`` computes and, for flash,
autograd's backward of ``F.scaled_dot_product_attention`` on the same
inputs.  Each build runs as training runs it: the tree's backward takes
the forward's row statistics (flash) or range-start states (the scan), as
the autograd Functions pass them; the tree's backward without them is
held to the plain version too, and the forward's time with and without
them is printed beside.  ``--scan-forward-parent``, an earlier
``ssm_scan.cu`` with the tree's ``ssm_scan_launch``, holds serving's scan
(y and hT) bit for bit to it and times both in turns at the training,
prefill and decode shapes, the tree's forward with the states beside.  The
last line is a JSON object of the times.

Run from the root of the repository on a machine with the card:
    mkdir -p build/parent
    git show <commit>:src/repro_torch/kernels/flash_attention/csrc/flash_attention_bwd.cu \\
        > build/parent/flash_attention_bwd.cu
    git show <commit>:src/repro_torch/kernels/ssm_scan/csrc/ssm_scan_bwd.cu \\
        > build/parent/ssm_scan_bwd.cu
    python3 tools/backward_parent_probe.py --flash-parent build/parent/flash_attention_bwd.cu \\
        --scan-parent build/parent/ssm_scan_bwd.cu
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

#: (label, B, S, H, KV, hd): phase 21's attention training shapes, causal.
FLASH_SHAPES = (("21 (b) stablelm-1.6b", 4, 256, 32, 32, 64),
                ("21 (c) jamba pair", 4, 256, 64, 8, 128))
#: (label, B, S, D, N): phase 21 (c)'s scan training shape.
SCAN_SHAPES = (("21 (c) jamba pair", 4, 256, 16384, 16),)
#: (B, S, D, N): the scan forward's training, longest prefill and decode shapes.
SCAN_FORWARD_SHAPES = ((4, 256, 16384, 16), (1, 168, 16384, 16), (4, 1, 16384, 16))


def _bind_flash_parent(lib) -> None:
    """The backward entry points an earlier ``flash_attention_bwd.cu`` has."""
    import ctypes
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_bwd_launch.argtypes = [ptr] * 10 + [i32] * 6 + [ctypes.c_float] + [
        i32] * 3 + [ptr]
    lib.flash_attention_bwd_launch.restype = ctypes.c_int
    lib.flash_attention_bwd_smem_bytes.argtypes = [i32]
    lib.flash_attention_bwd_smem_bytes.restype = ctypes.c_size_t


def _bind_scan_forward_parent(lib) -> None:
    """The forward entry point an earlier ``ssm_scan.cu`` has."""
    import ctypes
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ssm_scan_launch.argtypes = [ptr] * 8 + [i32] * 4 + [i64] * 4 + [i32, ptr]
    lib.ssm_scan_launch.restype = ctypes.c_int


def _bind_scan_parent(lib) -> None:
    """The backward entry points an earlier ``ssm_scan_bwd.cu`` has."""
    import ctypes
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ssm_scan_bwd_workspace.argtypes = [i32] * 4
    lib.ssm_scan_bwd_workspace.restype = i64
    lib.ssm_scan_bwd_launch.argtypes = [ptr] * 15 + [i32] * 4 + [i64] * 4 + [i32, ptr]
    lib.ssm_scan_bwd_launch.restype = ctypes.c_int


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--flash-parent", help="an earlier flash_attention_bwd.cu")
    parser.add_argument("--scan-parent", help="an earlier ssm_scan_bwd.cu")
    parser.add_argument("--scan-forward-parent", help="an earlier ssm_scan.cu")
    parser.add_argument("--iters", type=int, default=20, help="calls per captured graph")
    parser.add_argument("--profile", action="store_true",
                        help="also split each build's device time by kernel (torch.profiler)")
    args = parser.parse_args()
    if not (args.flash_parent or args.scan_parent or args.scan_forward_parent):
        parser.error("give --flash-parent, --scan-parent or --scan-forward-parent")

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("backward_parent_probe: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels._build import KernelLibrary
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.ssm_scan import ops as sops

    card = cs.card_line()
    print(card, flush=True)
    flash_parent = scan_parent = forward_parent = None
    if args.flash_parent:
        flash_parent = KernelLibrary("flash_attention_bwd-parent", Path(args.flash_parent),
                                     _bind_flash_parent)
    if args.scan_parent:
        scan_parent = KernelLibrary("ssm_scan_bwd-parent", Path(args.scan_parent),
                                    _bind_scan_parent)
    if args.scan_forward_parent:
        forward_parent = KernelLibrary("ssm_scan-parent", Path(args.scan_forward_parent),
                                       _bind_scan_forward_parent)
    parents = [lib for lib in (flash_parent, scan_parent, forward_parent) if lib is not None]
    cs.build_all([fops.LIBRARY, fops.BACKWARD_LIBRARY, sops.LIBRARY, sops.BACKWARD_LIBRARY]
                 + parents)
    for which, lib in (("tree", fops.BACKWARD_LIBRARY), ("tree", sops.BACKWARD_LIBRARY),
                       ("parent", flash_parent), ("parent", scan_parent)):
        handle = None if lib is None else lib.load()   # blocks an SM, where the build says
        if handle is not None and hasattr(handle, "flash_attention_bwd_blocks_per_sm"):
            fn = handle.flash_attention_bwd_blocks_per_sm
            print(f"  {which} flash backward blocks an SM (dq, dk/dv): hd 64 "
                  f"{fn(64, 0)}, {fn(64, 1)}; hd 128 {fn(128, 0)}, {fn(128, 1)}", flush=True)
        if handle is not None and hasattr(handle, "ssm_scan_bwd_blocks_per_sm"):
            print(f"  {which} scan backward blocks an SM at N = 16: "
                  f"{handle.ssm_scan_bwd_blocks_per_sm()}", flush=True)
    device = torch.device("cuda")
    results = {"card": card}

    def parent_flash_backward(q, k, v, out, dout, causal, window, scale):
        """The earlier flash backward as its wrapper ran it: both
        workspaces scratch, the row statistics found by its dq kernel."""
        B, S, H, hd = q.shape
        Sk, KV = k.shape[1], k.shape[2]
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
        delta = torch.empty_like(lse)
        rc = flash_parent.load().flash_attention_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            B, S, Sk, H, KV, hd, float(scale), int(causal), 0 if window is None else int(window),
            fops.DTYPES[q.dtype], torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"parent flash backward launch failed: CUDA error {rc}")
        return dq, dk, dv

    def parent_scan_backward(dt, x, bmat, cmat, a, h0, dy):
        """The earlier scan backward as its wrapper ran it (no dhT), its
        range-start states found by its own walk."""
        B, S, D = dt.shape
        N = a.shape[1]
        dtp, xp, bp, cp, a32, h32 = sops._operands(dt, x, bmat, cmat, a, h0)
        ddt, dx = torch.empty_like(dtp), torch.empty_like(xp)
        db = torch.empty((B, S, N), dtype=dt.dtype, device=dt.device)
        dc = torch.empty_like(db)
        da = torch.empty((D, N), dtype=torch.float32, device=dt.device)
        dh0 = torch.empty((B, D, N), dtype=torch.float32, device=dt.device)
        lib = scan_parent.load()
        work = torch.empty(lib.ssm_scan_bwd_workspace(B, S, D, N), dtype=torch.float32,
                           device=dt.device)
        rc = lib.ssm_scan_bwd_launch(
            dtp.data_ptr(), xp.data_ptr(), bp.data_ptr(), cp.data_ptr(), a32.data_ptr(),
            h32.data_ptr(), dy.data_ptr(), None, ddt.data_ptr(), dx.data_ptr(), db.data_ptr(),
            dc.data_ptr(), da.data_ptr(), dh0.data_ptr(), work.data_ptr(), B, S, D, N,
            bp.stride(0), bp.stride(1), cp.stride(0), cp.stride(1), sops.DTYPES[dt.dtype],
            torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"parent scan backward launch failed: CUDA error {rc}")
        return ddt, dx, db, dc, da, dh0

    def checked_in_turns(calls, label, want, names):
        """Each call held to the plain version (a second launch bit for bit
        the first), then "parent" and "tree" timed in turns; (times,
        errors).  "tree (alone)", the tree's call without the forward's
        outputs, is held to the plain version but not timed."""
        errs = {}
        for which, call in calls.items():
            got, again = call(), call()
            torch.cuda.synchronize()
            errs[which] = cs.check_grads(f"{which} {label}", got, want, names)
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"{which} {label}: a second launch differs")
        times = [cs.graph_ms(calls[w], iters=args.iters)
                 for w in ("parent", "tree", "tree", "parent")]
        if args.profile:
            for which in ("parent", "tree"):
                print(f"  {which} {label}: device us a call by kernel: "
                      f"{by_kernel(calls[which])}", flush=True)
        return times, errs

    def by_kernel(call, calls=5):
        """Device microseconds a call of each kernel ``call`` launches."""
        from torch.profiler import ProfilerActivity, profile
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                call()
            torch.cuda.synchronize()
        out = {}
        for e in prof.key_averages():
            us = getattr(e, "device_time_total", None)
            if us is None:
                us = getattr(e, "cuda_time_total", 0.0)
            if us > 0:
                out[e.key[:60]] = round(us / calls, 2)
        return out

    if flash_parent is not None:
        for label, B, S, H, KV, hd in FLASH_SHAPES:
            q, k, v, dout = cs.flash_backward_inputs(device, B, S, S, H, KV, hd, torch.float32,
                                                     seed=S + H)
            kw = dict(causal=True, window=None, scale=1.0 / hd ** 0.5)
            with torch.no_grad():
                out = fops.flash_attention(q, k, v, **kw)
                out_lse, lse = fops.flash_attention_with_lse(q, k, v, **kw)
            if not torch.equal(out, out_lse):
                raise AssertionError(f"{label}: the forward with statistics differs from serving's")
            want = fops.flash_attention_backward_reference(q, k, v, out, dout, **kw)
            fwd_ms = [cs.graph_ms(fn, iters=args.iters) for fn in (
                lambda: fops.flash_attention(q, k, v, **kw),
                lambda: fops.flash_attention_with_lse(q, k, v, **kw))]
            times, errs = checked_in_turns({
                "parent": lambda: parent_flash_backward(q, k, v, out, dout, **kw),
                "tree": lambda: fops.flash_attention_backward(q, k, v, out, dout, lse=lse, **kw),
                "tree (alone)": lambda: fops.flash_attention_backward(q, k, v, out, dout, **kw),
            }, label, want, ("dq", "dk", "dv"))
            leaves = [t.transpose(1, 2).contiguous().requires_grad_(True) for t in (q, k, v)]
            dout_t = dout.transpose(1, 2).contiguous()
            sdpa = lambda: F.scaled_dot_product_attention(*leaves, is_causal=True,
                                                          scale=kw["scale"], enable_gqa=True)
            fwd_bwd = cs.graph_ms(lambda: torch.autograd.grad(sdpa(), leaves, dout_t), iters=10)
            fwd = cs.graph_ms(lambda: sdpa().detach(), iters=10)
            bound_ms, bound_by, products = cs.flash_backward_bound(B, S, S, H, KV, hd, True, None)
            print(f"flash_attention_backward {label} ({B}, {S}, {H} over {KV}, hd {hd}) causal: "
                  f"max|kernel-plain| parent {errs['parent']:.3e}, tree {errs['tree']:.3e} "
                  f"(without the forward's statistics {errs['tree (alone)']:.3e}); "
                  f"forward graph ms serving {fwd_ms[0]:.5f}, with statistics {fwd_ms[1]:.5f}; "
                  f"second launches bit for bit; graph ms in turns parent, tree, tree, parent: "
                  + ", ".join(f"{t:.5f}" for t in times)
                  + f"; autograd of SDPA {fwd_bwd - fwd:.5f} ms (forward and backward "
                  f"{fwd_bwd:.5f} less forward {fwd:.5f}); bound {bound_ms:.6f} ms ({bound_by}; "
                  f"products at {products})",
                  flush=True)
            results[f"flash {label}"] = dict(turns=times, sdpa_backward=fwd_bwd - fwd,
                                             bound=bound_ms, bound_by=bound_by, err=errs,
                                             forward=fwd_ms)
            torch.cuda.empty_cache()

    if scan_parent is not None:
        for label, B, S, D, N in SCAN_SHAPES:
            inputs = cs.scan_inputs(device, B, S, D, N, torch.float32, seed=B * 7 + S)
            dy = torch.randn(B, S, D, generator=torch.Generator(device=device).manual_seed(S),
                             device=device)
            want = sops.ssm_scan_backward_reference(*inputs, dy, None)
            served = sops.ssm_scan(*inputs)
            *trained, ckpt = sops.ssm_scan_with_checkpoints(*inputs)
            if not all(torch.equal(a, b) for a, b in zip(served, trained)):
                raise AssertionError(f"{label}: the forward with states differs from serving's")
            fwd_ms = [cs.graph_ms(fn, iters=args.iters) for fn in (
                lambda: sops.ssm_scan(*inputs), lambda: sops.ssm_scan_with_checkpoints(*inputs))]
            times, errs = checked_in_turns({
                "parent": lambda: parent_scan_backward(*inputs, dy),
                "tree": lambda: sops.ssm_scan_backward(*inputs, dy, None, ckpt=ckpt),
                "tree (alone)": lambda: sops.ssm_scan_backward(*inputs, dy, None),
            }, label, want, ("ddt", "dx", "dB", "dC", "dA", "dh0"))
            bound_ms, bound_by, sfu_ms = cs.scan_backward_bound(B, S, D, N)
            print(f"ssm_scan_backward {label} ({B}, {S}, {D}, {N}): max|kernel-plain| parent "
                  f"{errs['parent']:.3e}, tree {errs['tree']:.3e} (without the forward's states "
                  f"{errs['tree (alone)']:.3e}); second launches bit for bit; forward graph ms "
                  f"serving {fwd_ms[0]:.5f}, with states {fwd_ms[1]:.5f}; "
                  f"graph ms in turns parent, tree, tree, parent: "
                  + ", ".join(f"{t:.5f}" for t in times)
                  + f"; bound {bound_ms:.6f} ms ({bound_by})", flush=True)
            results[f"scan {label}"] = dict(turns=times, bound=bound_ms, bound_by=bound_by,
                                            err=errs, forward=fwd_ms)
            torch.cuda.empty_cache()
    if forward_parent is not None:
        for B, S, D, N in SCAN_FORWARD_SHAPES:
            inputs = cs.scan_inputs(device, B, S, D, N, torch.float32, seed=B + S)

            def parent_scan():
                dt, x, bm, cm, a, h0 = inputs
                y = torch.empty((B, S, D), dtype=torch.float32, device=device)
                hT = torch.empty((B, D, N), dtype=torch.float32, device=device)
                rc = forward_parent.load().ssm_scan_launch(
                    dt.data_ptr(), x.data_ptr(), bm.data_ptr(), cm.data_ptr(), a.data_ptr(),
                    h0.data_ptr(), y.data_ptr(), hT.data_ptr(), B, S, D, N, bm.stride(0),
                    bm.stride(1), cm.stride(0), cm.stride(1), 0,
                    torch.cuda.current_stream().cuda_stream)
                if rc != 0:
                    raise RuntimeError(f"parent ssm_scan launch failed: CUDA error {rc}")
                return y, hT

            tree = lambda: sops.ssm_scan(*inputs)
            states = lambda: sops.ssm_scan_with_checkpoints(*inputs)
            want = parent_scan()
            for got in (tree(), states()[:2]):
                if not all(torch.equal(a, b) for a, b in zip(got, want)):
                    raise AssertionError(f"scan forward {(B, S, D, N)}: the tree's y, hT differ "
                                         f"from the parent's")
            times = [cs.graph_ms(fn, iters=20)
                     for fn in (parent_scan, tree, states, states, tree, parent_scan)]
            print(f"ssm_scan forward ({B}, {S}, {D}, {N}): serving and with the states bit for "
                  f"bit the parent's; graph ms in turns parent, tree, tree with states, tree with "
                  f"states, tree, parent: " + ", ".join(f"{t:.5f}" for t in times), flush=True)
            results[f"scan forward {(B, S, D, N)}"] = times
    print(json.dumps(results), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
