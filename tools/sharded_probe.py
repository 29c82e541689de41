"""The smoke run's phase 22 on its own: the sharded train, prefill and
decode bundles of stablelm-1.6b on a (1, 1) mesh over a NCCL process group
of one rank, held to ``make_step`` and the unsharded forwards, then the
sequence-sharded decode and the compressed all-reduce on that group, then
the same bundles for olmoe-1b-7b at 2 layers, the jamba Mamba + attention
pair, one xlstm-1.3b period, minicpm3-4b at 2 layers, seamless-m4t-large-v2
whole and internvl2-26b at 2 layers (``chip_smoke.phase_sharded``); then
phase 23, the dry run of 22 (b)'s cell against its counted step on the
card and the production-mesh cell (``chip_smoke.phase_dry_run``).
``--blocks h,i`` keeps only those of the sub-phases (e)-(j) (``--blocks
none``: none of them).  Prints the torch and CUDA versions first.

Needs a CUDA card (about 4 minutes of command time) and builds the
rmsnorm, flash-attention and selective-scan libraries, forward and
backward, from the checkout.

Run from the repository root:  python3 tools/sharded_probe.py [--blocks h,i,j|none]
"""
from __future__ import annotations

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--blocks", default="", help="letters of the sub-phases (e)-(j) to keep")
    args = ap.parse_args()
    import torch

    import chip_smoke as cs

    if args.blocks:
        blocks = {label: cfg for label, cfg in cs.sharded_blocks_configs().items()
                  if label[-2] in args.blocks.split(",")}
        cs.sharded_blocks_configs = lambda: blocks
    from repro_torch import resolve_device
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.rmsnorm import ops as rmsnorm_ops
    from repro_torch.kernels.ssm_scan import ops as ssm_ops

    device = resolve_device(None)
    cs.log(cs.card_line())
    cs.log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    timings = {"build": cs.build_all([rmsnorm_ops.LIBRARY, rmsnorm_ops.BACKWARD_LIBRARY,
                                      flash_ops.LIBRARY, flash_ops.BACKWARD_LIBRARY,
                                      ssm_ops.LIBRARY, ssm_ops.BACKWARD_LIBRARY])}
    t0 = time.perf_counter()
    sharded = cs.phase_sharded(device, 0, timings)
    cs.phase_dry_run(device, sharded, timings)
    timings["total"] = time.perf_counter() - t0
    cs.log("walls: " + " ".join(f"{k} {v:.1f}s" for k, v in timings.items()))


if __name__ == "__main__":
    main()
