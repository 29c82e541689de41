"""The smoke run's MoE and MLA part on its own: phase 4's checks at the
olmoe, mixtral and minicpm3 shapes, phases 14-17 (card vs host at 2
layers with the routing tie rule; olmoe-1b-7b, mixtral-8x7b's 8-layer cut
and minicpm3-4b behind ``BatchedServer``, launch counts asserted), the
new kernel shapes timed with their bounds and library calls, and the LM
bridge's one-card rate beside each measured one.

Needs a CUDA card (about 3 min of command time) and builds the rmsnorm,
flash-attention and selective-scan libraries from the checkout.

Run from the repository root:  python3 tools/moe_mla_probe.py
"""
from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]


def main() -> None:
    import numpy as np

    import chip_smoke as cs
    from repro_torch import resolve_device
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.rmsnorm import ops as rmsnorm_ops
    from repro_torch.kernels.ssm_scan import ops as ssm_ops

    device = resolve_device(None)
    cs.log(cs.card_line())
    walls = {"build": cs.build_all([rmsnorm_ops.LIBRARY, flash_ops.LIBRARY, ssm_ops.LIBRARY])}
    serve_rng = np.random.default_rng(0)
    prompt_lengths = sorted({int(n) for n in serve_rng.integers(32, 193, size=8)})
    t0 = time.perf_counter()
    errs = cs.check_moe_mla_kernels(device, prompt_lengths)
    walls["phase4"] = time.perf_counter() - t0
    cs.log(f"phase 4 at the MoE and MLA shapes: max|kernel-plain| flash {errs[0]:.3e}, "
           f"rmsnorm {errs[1]:.3e}, add_rmsnorm {errs[2]:.3e}")
    out = cs.phases_moe_mla(device, 0, serve_rng, walls)
    excess = {}
    lengths = next(iter(out["served"].values()))["lengths"]
    t0 = time.perf_counter()
    cs.time_moe_mla(device, lengths, out["served"], excess)
    walls["timing"] = time.perf_counter() - t0
    for run in out["served"].values():
        fig = run["fig"]
        predicted = cs.bridge_workload(fig).tokens_per_second(fig["slots"], 1)
        measured = fig["slots"] / (fig["decode_tick_ms"] / 1e3)
        cs.log(f"bridge {fig['name']}: predicted {predicted:.1f} tok/s on 1 card, measured "
               f"{measured:.1f}, error {(predicted / measured - 1) * 100:+.1f}%")
        cs.log(f"figures {json.dumps(fig)}")
    cs.log("launches x (time - bound) by kernel and path, largest first:")
    for label, ms in sorted(excess.items(), key=lambda kv: -kv[1]):
        cs.log(f"  {ms:10.3f} ms  {label}")
    cs.log(f"card vs host, max|logit difference|: {json.dumps(out['card_vs_host'])}")
    cs.log("walls: " + " ".join(f"{k} {v:.1f}s" for k, v in walls.items()))


if __name__ == "__main__":
    main()
