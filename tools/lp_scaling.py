"""Host time of the flow LP (``core.solve_flow``, the dense numpy simplex)
on ``deep_pipeline`` allocations of growing size, with the LP's shape.

Predict-back calibration (``Calibrator.observe``, and through it a control
loop's calibration flush) solves this LP once per measured configuration,
so its scaling decides at which sizes a learning control loop can
calibrate.  Stops after the first size whose solve takes longer than
``--budget`` seconds.  Runs on the host only (numpy).

Run from the repository root:  PYTHONPATH=src python3 tools/lp_scaling.py
"""
from __future__ import annotations

import argparse
import json
import time

from repro_torch.core import ContainerDim, allocate, build_flow_problem, oracle_models, solve_flow
from repro_torch.streams import SimParams, deep_pipeline


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--targets", default="500,1000,2000,3000,4000",
                    help="allocation targets in ktps, comma-separated")
    ap.add_argument("--budget", type=float, default=20.0,
                    help="stop after the first solve longer than this (seconds)")
    args = ap.parse_args()
    dag = deep_pipeline()
    models = oracle_models(dag, SimParams().sm_cost_per_ktuple)
    dim = ContainerDim(cpus=3.0, mem_mb=4096.0)
    for target in (float(t) for t in args.targets.split(",")):
        cfg = allocate(dag, models, target, preferred_dim=dim).config
        problem = build_flow_problem(cfg, models)
        t0 = time.perf_counter()
        sol = solve_flow(cfg, models)
        seconds = time.perf_counter() - t0
        print(json.dumps(dict(
            target_ktps=target, instances=sum(len(p) for p in cfg.packing),
            containers=cfg.n_containers, lp_variables=int(problem.c.shape[0]),
            lp_rows=int(problem.A_ub.shape[0] + problem.A_eq.shape[0]),
            seconds=seconds, rate_ktps=sol.rate_ktps,
        )), flush=True)
        if seconds > args.budget:
            break


if __name__ == "__main__":
    main()
