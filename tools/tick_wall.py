#!/usr/bin/env python3
"""Wall time of the stream side's scoring batch on the card, as
``chip_smoke.py``'s phase 3 runs it: 32 candidate configurations around the
``deep_pipeline`` allocation for 20,000 ktps, scored with the sparse tick
in summary mode for 20 simulated seconds (2,000 ticks).

The port is imported from whatever ``src`` comes first on ``PYTHONPATH``,
so the same script times two commits: unpack each into a directory and run

    PYTHONPATH=<checkout>/src python3 tools/tick_wall.py --label <name>

in turns (parent, change, change, parent) in one session on the card.  The
candidates come from ``chip_smoke.candidate_configs`` with a fixed seed, so
every run scores the same configurations.  After one untimed run (kernel
build, warm-up) it prints one line per timed run: the wall and, where the
port has them, the host time spent inside the noise draw
(``streams/prng.py``'s ``split`` and ``normal``) and inside the
``container_sum`` and ``ordered_sum`` wrappers.  Nothing there waits on the
device, so that is the host's cost of issuing their launches.  ``--noise
off`` runs with ``noise_std=0``; ``--draw-elements N`` sets the normals the
simulator draws per pass (1: one sample window per draw).  ``--tick dense
--batch 1`` times the dense tick on the allocation alone, the shape phase
2's dense measurement runs.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class HostTimer:
    """Stands in for a function and adds up the host time spent inside its
    calls."""

    def __init__(self, fn):
        self.fn, self.seconds, self.calls = fn, 0.0, 0

    def __call__(self, *args, **kwargs):
        t0 = time.perf_counter()
        try:
            return self.fn(*args, **kwargs)
        finally:
            self.seconds += time.perf_counter() - t0
            self.calls += 1


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--label", default="tree")
    parser.add_argument("--runs", type=int, default=3)
    parser.add_argument("--seconds", type=float, default=20.0)
    parser.add_argument("--noise", choices=("on", "off"), default="on")
    parser.add_argument("--draw-elements", type=int, default=None)
    parser.add_argument("--tick", choices=("sparse", "dense"), default="sparse")
    parser.add_argument("--batch", type=int, default=32,
                        help="score the first N candidates (the allocation is the first)")
    args = parser.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("tick_wall: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(1, ROOT)            # chip_smoke, after the port's src
    import chip_smoke
    from repro_torch.core import allocate, oracle_models
    from repro_torch.streams import SimParams, deep_pipeline, simulate_batch, simulator

    params = SimParams()
    if args.noise == "off":
        params = dataclasses.replace(params, noise_std=0.0)
    if args.draw_elements is not None:
        simulator.NOISE_DRAW_ELEMENTS = args.draw_elements
    dag = deep_pipeline()
    alloc = allocate(dag, oracle_models(dag, params.sm_cost_per_ktuple),
                     chip_smoke.TARGET_KTPS, overprovision=1.1)
    configs = chip_smoke.candidate_configs(alloc, 32, np.random.default_rng(0))[: args.batch]
    n_ticks = int(args.seconds / params.dt)

    # the timed functions, where this port has them (older trees lack them)
    timed = {}
    prng = getattr(simulator, "prng", None)
    if prng is not None:
        timed["noise draw"] = [(prng, "split"), (prng, "normal")]
    for name in ("container_sum", "ordered_sum"):
        if hasattr(simulator, name):
            timed[f"{name} wrapper"] = [(simulator, name)]

    def run():
        timers = {}
        originals = []
        for name, targets in timed.items():
            for owner, attr in targets:
                originals.append((owner, attr, getattr(owner, attr)))
                timer = HostTimer(getattr(owner, attr))
                timers.setdefault(name, []).append(timer)
                setattr(owner, attr, timer)
        try:
            t0 = time.perf_counter()
            simulate_batch(configs, 1e6, duration_s=args.seconds, params=params,
                           tick_kernel=args.tick, samples="summary", device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            for owner, attr, fn in originals:
                setattr(owner, attr, fn)
        return wall, timers

    run()
    for i in range(args.runs):
        wall, timers = run()
        parts = [f"{args.label} {args.tick} B={len(configs)} run {i + 1}: {wall:.3f} s, "
                 f"{wall / n_ticks * 1e3:.4f} ms/tick"]
        for name, ts in timers.items():
            seconds = sum(t.seconds for t in ts)
            calls = ts[-1].calls
            parts.append(f"{name} {seconds / n_ticks * 1e3:.4f} ms/tick "
                         f"({calls} calls, {seconds / max(calls, 1) * 1e6:.1f} us/call)")
        print("; ".join(parts), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
