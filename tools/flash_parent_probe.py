#!/usr/bin/env python3
"""The flash-attention kernel against an earlier build of itself on the
card: the same bits and the same time on every call the earlier source
took (S_k = S), and the tree's calls with keys of their own length against
the plain version.

``--parent`` is an earlier ``flash_attention.cu`` whose C entry point is
``flash_attention_launch(q, k, v, out, B, S, H, KV, hd, scale, causal,
window, dtype, heads, stream)`` (no key length), or with ``--parent-sk``
``flash_attention_launch(q, k, v, out, B, S, Sk, H, KV, hd, ...)`` (the
key length after S, as the tree's).  For llama3-8b's,
jamba's, seamless-m4t-large-v2's and internvl2-26b's prefill shapes,
causal, windowed and non-causal, fp32 and bf16, aligned and not, at one
and two heads per block, it requires the tree's output to equal the
parent's bit for bit (and the tree's wrapper to count one launch a call),
then times both at the serving shapes from CUDA-graph replay in turns
(parent, tree, tree, parent), and at the training shapes of
``chip_smoke.py``'s phase 21 the tree's forward with the row statistics
(``flash_attention_with_lse``, as training runs it) beside serving's, its
output checked bit for bit.

Run from the root of the repository on a machine with the card:
    git show <commit>:src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu \\
        > build/parent/flash_attention.cu
    python3 tools/flash_parent_probe.py --parent build/parent/flash_attention.cu
"""
from __future__ import annotations

import argparse
import ctypes
import os
import sys
from pathlib import Path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

#: (S, H, KV, hd, causal, window): the serving paths' prefill shapes and
#: the masks and widths the earlier kernel took.
CASES = (
    [(S, 32, 8, 128, True, None) for S in (1, 7, 34, 75, 130, 168, 192)]    # llama3-8b
    + [(S, 64, 8, 128, True, None) for S in (34, 168)]                       # the jamba period
    + [(S, 16, 16, 64, True, None) for S in (34, 168)]                       # seamless decoder
    + [(512, 16, 16, 64, False, None)]                                       # seamless encoder
    + [(256 + S, 48, 8, 128, True, None) for S in (34, 168)]                 # internvl2-26b
    + [(130, 32, 8, 128, True, 32), (130, 32, 8, 128, False, None), (7, 32, 8, 128, False, None),
       (130, 32, 8, 120, True, None), (45, 3, 1, 64, True, None), (50, 4, 2, 18, True, None)]
)
TIMED = ((168, 32, 8, 128, True), (512, 16, 16, 64, False), (424, 48, 8, 128, True))
#: (B, S, H, KV, hd): phase 21's training shapes, causal.
TRAINING = ((4, 256, 32, 32, 64), (4, 256, 64, 8, 128))


def _bind_parent(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_launch.argtypes = (
        [ptr] * 4 + [i32] * 5 + [ctypes.c_float] + [i32] * 4 + [ptr])
    lib.flash_attention_launch.restype = ctypes.c_int


def _bind_parent_sk(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_launch.argtypes = (
        [ptr] * 4 + [i32] * 6 + [ctypes.c_float] + [i32] * 4 + [ptr])
    lib.flash_attention_launch.restype = ctypes.c_int


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", required=True, help="an earlier flash_attention.cu")
    parser.add_argument("--parent-sk", action="store_true",
                        help="the parent's entry point takes the key length after S")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("flash_parent_probe: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels._build import KernelLibrary
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_reference, flash_attention_with_lse, ops,
    )

    print(cs.card_line(), flush=True)
    parent = KernelLibrary("flash_attention-parent", Path(args.parent),
                           _bind_parent_sk if args.parent_sk else _bind_parent)
    cs.build_all([ops.LIBRARY, parent])
    device = torch.device("cuda")

    def parent_flash(q, k, v, causal, window, heads):
        out = torch.empty_like(q)
        B, S, H, hd = q.shape
        lengths = (S, k.shape[1]) if args.parent_sk else (S,)
        rc = parent.load().flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, *lengths, H,
            k.shape[2], hd, float(hd ** -0.5), int(causal), 0 if window is None else int(window),
            ops.DTYPES[q.dtype], heads, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"parent flash launch failed: CUDA error {rc}")
        return out

    checked = 0
    for S, H, KV, hd, causal, window in CASES:
        q, k, v = cs.flash_inputs(device, S, H, KV, hd, seed=S * 3 + H + hd)
        buf = torch.empty(q.numel() + 1, device=device)
        unaligned = buf[1:].view(q.shape)
        unaligned.copy_(q)
        for dtype in (torch.float32, torch.bfloat16):
            for qq in ((q, unaligned) if dtype == torch.float32 else (q,)):
                inputs = [t.to(dtype) for t in (qq, k, v)]
                for heads in (1, 2):
                    before = flash_attention.launches
                    got = flash_attention(*inputs, causal=causal, window=window,
                                          heads_per_block=heads)
                    want = parent_flash(*inputs, causal, window, heads)
                    torch.cuda.synchronize()
                    if flash_attention.launches != before + 1:
                        raise AssertionError("the tree's wrapper did not count one launch")
                    if not torch.equal(got, want):
                        raise AssertionError(
                            f"S={S} H={H} KV={KV} hd={hd} causal={causal} window={window} "
                            f"{dtype} heads={heads}: the tree's bits differ from the parent's")
                    checked += 1
        print(f"  S={S} H={H} KV={KV} hd={hd} causal={causal} window={window}: tree = parent "
              f"bit for bit (fp32 aligned and unaligned, bf16; 1 and 2 heads per block)",
              flush=True)
    print(f"{checked} calls bit for bit the parent's", flush=True)

    for Sk in (34, 512):
        q, k, v = cs.flash_inputs(device, 168, 16, 16, 64, seed=Sk, Sk=Sk)
        got = flash_attention(q, k, v, causal=False)
        want = flash_attention_reference(q, k, v, causal=False)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=cs.FLASH_TOL, atol=cs.FLASH_TOL)
        print(f"  S=168 Sk={Sk} non-causal: max|kernel-plain| "
              f"{float((got - want).abs().max()):.3e}", flush=True)

    for S, H, KV, hd, causal in TIMED:
        q, k, v = cs.flash_inputs(device, S, H, KV, hd, seed=S + H)
        heads = ops.LIBRARY.load().flash_attention_heads_per_block(
            1, S, H, KV, torch.cuda.get_device_properties(0).multi_processor_count)
        tree = lambda: flash_attention(q, k, v, causal=causal, scale=hd ** -0.5)
        old = lambda: parent_flash(q, k, v, causal, None, heads)
        times = [cs.graph_ms(fn, iters=50) for fn in (old, tree, tree, old)]
        print(f"  S={S} H={H} KV={KV} hd={hd} causal={causal}, {heads} head(s)/block (graph, "
              f"in turns parent, tree, tree, parent): "
              + ", ".join(f"{t:.5f}" for t in times) + " ms", flush=True)

    for B, S, H, KV, hd in TRAINING:
        q, k, v, _ = cs.flash_backward_inputs(device, B, S, S, H, KV, hd, torch.float32,
                                              seed=S + H)
        heads = ops.LIBRARY.load().flash_attention_heads_per_block(
            B, S, H, KV, torch.cuda.get_device_properties(0).multi_processor_count)
        old = lambda: parent_flash(q, k, v, True, None, heads)
        tree = lambda: flash_attention(q, k, v, causal=True, scale=hd ** -0.5)
        stats = lambda: flash_attention_with_lse(q, k, v, causal=True, scale=hd ** -0.5)
        if not (torch.equal(tree(), old()) and torch.equal(stats()[0], old())):
            raise AssertionError(f"training shape {(B, S, H, KV, hd)}: the tree's outputs differ "
                                 f"from the parent's")
        times = [cs.graph_ms(fn, iters=20) for fn in (old, tree, stats, stats, tree, old)]
        print(f"  training shape B={B} S={S} H={H} KV={KV} hd={hd} causal: serving and with the "
              f"row statistics bit for bit the parent's; graph ms in turns parent, tree, tree "
              f"with statistics, tree with statistics, tree, parent: "
              + ", ".join(f"{t:.5f}" for t in times), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
