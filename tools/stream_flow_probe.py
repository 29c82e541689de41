#!/usr/bin/env python3
"""Where the flow-step kernel's time goes, on the card.

Times ``stream_flow_ell`` (device time from CUDA-graph replay) on the
padded arrays of the 20,000-ktps ``deep_pipeline`` allocation (oracle
models) alone and with 31 candidates around it, as ``chip_smoke.py``
builds them:

* at every cluster size 1-16 and at block sizes of up to 1024, 512 and
  256 threads;
* with the ELL rows by destination emptied (only the rows by source are
  walked, whose edge ids are contiguous), with the rows by source emptied
  (only the scattered rows by destination), and with every row emptied
  (what is left: the launch, the cluster barriers, the copies between
  CTAs and the per-container sums), which splits the time between the
  two kinds of gather and the rest;
* with the padded instances dealt over all containers instead of sitting
  in the last one (their partial sums are zero, so the results on the
  real containers do not change), which prices the one long member list
  that the padding makes.

Run from the root of the repository on a machine with the card:
    python3 tools/stream_flow_probe.py
"""
from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("stream_flow_probe: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.core import allocate, oracle_models
    from repro_torch.kernels.stream_flow import ops, stream_flow_ell
    from repro_torch.streams import SimParams, deep_pipeline

    print(cs.card_line(), flush=True)
    device = torch.device("cuda")
    params = SimParams()
    rng = np.random.default_rng(0)
    dag = deep_pipeline()
    alloc = allocate(dag, oracle_models(dag, params.sm_cost_per_ktuple), cs.TARGET_KTPS,
                     overprovision=1.1)
    problems = {
        1: cs.padded_flow_problem([alloc.config], params, rng, device),
        32: cs.padded_flow_problem(cs.candidate_configs(alloc, 32, rng), params, rng, device),
    }
    threads_for = ops.threads_for
    for B, p in problems.items():
        E = p["edge_src"].shape[1]
        args = [p[k] for k in cs.KERNEL_ARGS] + [*cs.members_of(p)]
        bound = cs.flow_bound(p)[0]
        print(f"B={B}: bound {bound:.6f} ms", flush=True)
        for cap in (1024, 512, 256):
            ops.threads_for = lambda I, n, cap=cap: min(cap, threads_for(I, n))
            row = []
            for n in (1, 2, 4, 8, 16):
                ms = cs.graph_ms(lambda: stream_flow_ell(*args, cluster_size=n), iters=50)
                row.append(f"{n}: {ms:.5f}")
            print(f"  threads <= {cap}, ms by cluster size  " + "  ".join(row), flush=True)
        ops.threads_for = threads_for
        for label, emptied in (("rows by source only", (7,)), ("rows by destination only", (6,)),
                               ("every row empty", (6, 7))):
            cut = list(args)
            for idx in emptied:
                cut[idx] = torch.full_like(args[idx], E)
            ms = cs.graph_ms(lambda: stream_flow_ell(*cut), iters=50)
            print(f"  {label}: {ms:.5f} ms", flush=True)
        K = p["sm_budget"].shape[1]
        padded = p["inst_mask"] == 0
        dealt = dict(p, cont_of=p["cont_of"].clone())
        dealt["cont_of"][padded] = (torch.arange(int(padded.sum()), device=device) % K).to(torch.int32)
        spread = args[:8] + [dealt["cont_of"]] + args[9:10] + list(cs.members_of(dealt))
        ms = cs.graph_ms(lambda: stream_flow_ell(*spread), iters=50)
        longest = int(torch.bincount(p["cont_of"][0].long()).max())
        print(f"  padded instances dealt over all {K} containers (longest member list "
              f"{longest} -> {int(torch.bincount(dealt['cont_of'][0].long()).max())}): {ms:.5f} ms",
              flush=True)
        ms = cs.graph_ms(lambda: stream_flow_ell(*args), iters=50)
        print(f"  both (the chosen cluster size {ops.cluster_size_for(B, args[0].shape[1])}): "
              f"{ms:.5f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
