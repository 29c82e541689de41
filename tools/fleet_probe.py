"""The smoke run's phase 3d on its own: the fleet demo with its controller
crash, N+1 on the demo cluster, and the scaled fleet at any size and step
count, on the card, with the stream kernels' launches counted by shape and
each shape checked and timed afterwards.

``chip_smoke.py`` runs the scaled fleet at 333 copies of the demo's trio
for 2 steps; this probe runs it longer or at other sizes (each step logs
the scheduler's phase timings, the rows scored and the launch shapes).
Needs a CUDA card and builds the stream-flow library from the checkout.

Run from the repository root:  python3 tools/fleet_probe.py --copies 333 --steps 8
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--copies", type=int, default=333, help="copies of the demo's three tenants")
    ap.add_argument("--steps", type=int, default=8, help="steps of the scaled fleet")
    ap.add_argument("--skip-demo", action="store_true", help="run the scaled fleet only")
    args = ap.parse_args()

    import chip_smoke as cs
    from repro_torch import resolve_device
    from repro_torch.kernels.stream_flow import build, container_sum, ordered_sum, stream_flow_ell
    from repro_torch.streams import SimParams, simulator

    device = resolve_device(None)
    print(cs.card_line(), flush=True)
    t0 = time.perf_counter()
    build.LIBRARY.load()
    walls = {"build": time.perf_counter() - t0}
    params = SimParams()
    recs = (("stream_flow_ell", cs.LaunchRecorder(simulator.stream_flow_ell, cs.flow_key)),
            ("container_sum", cs.LaunchRecorder(simulator.container_sum, cs.sum_key)),
            ("ordered_sum", cs.LaunchRecorder(simulator.ordered_sum, cs.ordered_key)))
    simulator.stream_flow_ell, simulator.container_sum, simulator.ordered_sum = (r for _, r in recs)
    stream_flow_ell.launches = container_sum.launches = ordered_sum.launches = 0
    try:
        if not args.skip_demo:
            t0 = time.perf_counter()
            cs.phase_fleet_demo(device, params)
            walls["demo"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            cs.phase_fleet_n1(device, params)
            walls["n1"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        cs.phase_fleet_scale(device, params, args.copies, args.steps, recs)
        walls["fleet"] = time.perf_counter() - t0
    finally:
        simulator.stream_flow_ell, simulator.container_sum, simulator.ordered_sum = (
            r.fn for _, r in recs)
    print("launches " + json.dumps({fn.__name__: fn.launches
                                    for fn in (stream_flow_ell, container_sum, ordered_sum)}),
          flush=True)
    t0 = time.perf_counter()
    excess: dict = {}
    errs = cs.check_and_time(*(r for _, r in recs), "fleet", excess)
    walls["shapes"] = time.perf_counter() - t0
    print(json.dumps(dict(errors=errs, excess_ms=excess, walls_s=walls)), flush=True)


if __name__ == "__main__":
    main()
