#!/usr/bin/env python3
"""Device time of the simulator's per-container and fixed-order sums on the
card, for the tree's ``stream_flow`` library and for variant sources, in
turns.

Times ``container_sum`` (CUDA-graph replay) on the member lists of the
20,000-ktps ``deep_pipeline`` allocation (oracle models) alone (B=1) and
with 31 candidates around it (B=32), padded as ``chip_smoke.py`` pads them,
with values that are zero on padded instances as the tick's are, and on the
whole row as one container (the sources' capacity); and ``ordered_sum`` at
the dense tick's shape (1, 1024, 1024): row sums, column sums and masked
column sums.  Every result must equal the host's plain version bit for bit.

Each variant is a copy of ``csrc/stream_flow.cu`` with the same C entry
points, built like the tree's library into ``build/kernels/``; the tree's
library runs first and last.

Run from the root of the repository on a machine with the card:
    python3 tools/sum_probe.py [variant.cu ...]
"""
from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("variants", nargs="*", help="variant sources of csrc/stream_flow.cu")
    args = parser.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("sum_probe: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.core import allocate, oracle_models
    from repro_torch.kernels._build import KernelLibrary
    from repro_torch.kernels.stream_flow import (
        build, container_members, container_sum, container_sum_reference, ordered_sum,
        ordered_sum_reference,
    )
    from repro_torch.streams import SimParams, deep_pipeline

    print(cs.card_line(), flush=True)
    libraries = [("tree", build.LIBRARY)] + [
        (Path(v).stem, KernelLibrary(f"probe-{Path(v).stem}", Path(v), build._bind))
        for v in args.variants
    ]
    cs.build_all([lib for _, lib in libraries])

    device = torch.device("cuda")
    params = SimParams()
    rng = np.random.default_rng(0)
    dag = deep_pipeline()
    alloc = allocate(dag, oracle_models(dag, params.sm_cost_per_ktuple), cs.TARGET_KTPS,
                     overprovision=1.1)
    cases = {}
    for B, configs in ((1, [alloc.config]), (32, cs.candidate_configs(alloc, 32, rng))):
        arrays, _ = cs.padded_structures(configs, params)
        p = cs.stage_rows(arrays, device)
        K = p["sm_budget"].shape[1]
        cont_of = p["cont_of"]
        vals = torch.as_tensor(rng.uniform(0.0, 5.0, cont_of.shape).astype("float32"),
                               device=device) * p["inst_mask"]
        members = container_members(cont_of, K)
        cases[f"container_sum B={B} I={cont_of.shape[1]} K={K}"] = (
            lambda v=vals, c=cont_of, m=members: container_sum(v, c, *m),
            container_sum_reference(vals.cpu(), cont_of.cpu(), K),
        )
        whole = torch.zeros_like(cont_of)
        src_vals = vals * p["is_source"]
        whole_members = container_members(whole, 1)
        cases[f"container_sum B={B} I={cont_of.shape[1]} K=1 (sources)"] = (
            lambda v=src_vals, c=whole, m=whole_members: container_sum(v, c, *m),
            container_sum_reference(src_vals.cpu(), whole.cpu(), 1),
        )
    x = torch.as_tensor(rng.uniform(0.0, 5.0, (1, 1024, 1024)).astype("float32"), device=device)
    mask = torch.as_tensor(rng.random((1, 1024, 1024)) < 0.5, device=device)
    for dim, m, label in ((2, None, "row sums"), (1, None, "column sums"),
                          (1, mask, "masked column sums")):
        cases[f"ordered_sum (1, 1024, 1024) {label}"] = (
            lambda dim=dim, m=m: ordered_sum(x, dim, m),
            ordered_sum_reference(x.cpu(), dim, None if m is None else m.cpu()),
        )

    loaded = {name: lib.load() for name, lib in libraries}
    try:
        for name, _ in libraries + libraries[:1]:
            build.LIBRARY._lib = loaded[name]
            for label, (fn, want) in cases.items():
                got = fn()
                torch.cuda.synchronize()
                if not torch.equal(got.cpu(), want):
                    raise AssertionError(f"{name}: {label} differs from the host's plain version")
                ms = cs.graph_ms(fn, iters=200)
                print(f"{name:24s} {label:48s} {ms:.5f} ms", flush=True)
    finally:
        build.LIBRARY._lib = loaded["tree"]
    return 0


if __name__ == "__main__":
    sys.exit(main())
