"""``simulate_batch`` over four cards against one: the batch of phase 3 of
``chip_smoke.py`` (32 candidates around deep_pipeline's allocation for
20,000 ktps, 20 simulated seconds, load 1e6 ktps as phase 3 offers it) with
``devices=4`` (8 rows a card, shard k on ``cuda:k``) and with
``devices=None`` (all 32 rows on card 0), on both ticks (dense and
sparse) and in both modes (full and summary), in turns: one card, four,
four, one.

The candidates come from phase 1's allocation (``allocate`` over the
oracle node models, 1.1 overprovision) rather than phase 2's fitted one,
so the tool needs no profiling run.  Gates: every row's samples (full
mode) or summary (summary mode) and its achieved rate bit for bit across
the four runs of a (tick, mode): a row's run depends neither on its
batch's size nor on its buckets (phase 3b), so sharding moves no bit.
Prints each run's wall, the rows each card ran, and one JSON line.

    python3 tools/sim_multi_card.py                      # four CUDA cards
    PYTHONPATH=src python3 tools/sim_multi_card.py --device cpu --devices 1 \\
        --duration 2 --candidates 4                       # the comparison on the host
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]


def candidates(n: int):
    """Phase 3's candidate set around phase 1's allocation of deep_pipeline."""
    import numpy as np

    import chip_smoke as cs
    from repro_torch.core import allocate, oracle_models
    from repro_torch.streams import SimParams, deep_pipeline

    params = SimParams()
    oracle = oracle_models(deep_pipeline(), params.sm_cost_per_ktuple)
    alloc = allocate(deep_pipeline(), oracle, cs.TARGET_KTPS, overprovision=1.1)
    return cs.candidate_configs(alloc, n, np.random.default_rng(0)), params


def run_once(configs, params, args, tick, mode, devices) -> tuple[list, float]:
    import torch
    from repro_torch.streams import simulate_batch

    def sync():
        if args.device == "cuda":
            for k in range(torch.cuda.device_count()):
                torch.cuda.synchronize(k)

    sync()
    t0 = time.perf_counter()
    res = simulate_batch(configs, 1e6, duration_s=args.duration, params=params,
                         tick_kernel=tick, samples=mode, devices=devices, dedup=False,
                         device=args.device)
    rows = [dict(r.samples if mode == "full" else r.summary) for r in res]
    for row, r in zip(rows, res):
        row["achieved_ktps"] = r.achieved_ktps
    sync()
    return rows, time.perf_counter() - t0


def same(a: list, b: list) -> bool:
    import numpy as np

    return len(a) == len(b) and all(
        set(x) == set(y) and all(np.array_equal(np.asarray(x[k]), np.asarray(y[k])) for k in x)
        for x, y in zip(a, b))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--devices", type=int, default=4, help="the sharded runs' card count")
    ap.add_argument("--duration", type=float, default=20.0, help="simulated seconds")
    ap.add_argument("--candidates", type=int, default=32)
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from repro_torch.streams.simulator import shard_count

    if args.device == "cuda":
        from repro_torch import resolve_device
        from repro_torch.kernels.stream_flow import build

        resolve_device("cuda")
        if torch.cuda.device_count() < args.devices:
            raise SystemExit(f"needs {args.devices} CUDA cards, found {torch.cuda.device_count()}")
        cs.build_all([build.LIBRARY])
    configs, params = candidates(args.candidates)
    n = shard_count(len(configs), args.devices, args.device)
    per = -(-len(configs) // n)
    spans = [[k * per, min(len(configs), (k + 1) * per)] for k in range(n)]
    fig = {"device": args.device, "devices": args.devices, "rows": len(configs),
           "duration_s": args.duration, "card_spans": spans, "runs": {}}
    if args.device == "cuda":
        fig["card"] = cs.card_line()
        fig["cards"] = [torch.cuda.get_device_name(k) for k in range(torch.cuda.device_count())]
    failures = []
    for tick in ("sparse", "dense"):
        for mode in ("summary", "full"):
            walls, runs = [], []
            for devices in (None, args.devices, args.devices, None):
                rows, wall = run_once(configs, params, args, tick, mode, devices)
                runs.append(rows)
                walls.append(wall)
            equal = all(same(runs[0], r) for r in runs[1:])
            key = f"{tick}/{mode}"
            fig["runs"][key] = {"bit_equal": equal, "wall_s_one_card": [walls[0], walls[3]],
                                "wall_s_sharded": [walls[1], walls[2]],
                                "achieved_ktps_min": min(r["achieved_ktps"] for r in runs[0]),
                                "achieved_ktps_max": max(r["achieved_ktps"] for r in runs[0])}
            print(f"{key}: one card {walls[0]:.3f} / {walls[3]:.3f} s, {n} cards "
                  f"{walls[1]:.3f} / {walls[2]:.3f} s, rows and summaries "
                  f"{'bit-equal' if equal else 'DIFFER'}", flush=True)
            if not equal:
                failures.append(key)
    print(json.dumps(fig), flush=True)
    if failures:
        raise SystemExit(f"devices={args.devices} differs from one card in {failures}")
    print("ok", flush=True)


if __name__ == "__main__":
    main()
