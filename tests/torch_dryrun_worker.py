"""The rank side of ``tests/test_torch_dryrun.py``: four gloo ranks on the
CPU run one counted step of each case's (2, 2) bundle on seeded data
(``repro_torch.launch.counting.StepCounter``), then rank 0, its gloo group
destroyed, dry-runs the same cells on a fake group of four ranks
(``repro_torch.launch.dryrun.count_step``) and writes both.

    python tests/torch_dryrun_worker.py <workdir>

``<workdir>/meta.json`` names the cases (arch, step kind, batch, sequence
length); the ranks meet through a ``FileStore`` in ``<workdir>`` (no TCP
port), the group timing out after the test's limit (``meta["limit_s"]``),
and rank 0 writes
``<workdir>/results.json``: per case each rank's counts and the dry run's.
``torch.multiprocessing.spawn`` ends every rank when one fails.  Nothing
here imports JAX or the reference package.
"""
from __future__ import annotations

import datetime
import json
import os
import sys
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 4
KEYS = ("flops", "bytes", "collectives", "kernels")


def _cell(case):
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch.sharding import PlanConfig

    return (get_config(case["arch"]), ShapeConfig(case["kind"], case["seq"], case["batch"],
                                                   case["kind"]), PlanConfig(tp=2, dp=2))


def _maker(seed: int):
    """Whole tensors from one seeded generator, the same on every rank when
    called in the same order: small token ids, positive floats."""
    g = torch.Generator().manual_seed(seed)

    def full(t):
        if t.dtype.is_floating_point:
            return (0.02 * torch.rand(t.shape, generator=g)).to(t.dtype)
        return torch.randint(0, 8, t.shape, generator=g, dtype=t.dtype)
    return full


def real_counts(case) -> dict:
    from repro_torch.launch.counting import StepCounter
    from repro_torch.launch.dryrun import placed_args
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.steps import make_bundle

    cfg, shape, plan = _cell(case)
    mesh = make_debug_mesh(2, 2, device_type="cpu")
    bundle = make_bundle(cfg, shape, mesh, plan, device_type="cpu", param_dtype=torch.float32)
    args = placed_args(bundle, _maker(case["seed"]))
    with StepCounter() as counter:
        bundle.step_fn(*args)
    fig = counter.figures()
    return {k: fig[k] for k in KEYS}


def dry_counts(case) -> dict:
    from repro_torch.launch.dryrun import count_step
    from repro_torch.launch.mesh import make_debug_mesh

    cfg, shape, plan = _cell(case)
    fig = count_step(cfg, shape, make_debug_mesh(2, 2, device_type="cpu"), plan,
                     param_dtype=torch.float32)
    return {k: fig[k] for k in KEYS + ("peak_bytes", "argument_bytes", "output_bytes")}


def run(rank: int, workdir: str) -> None:
    torch.set_num_threads(1)
    with open(os.path.join(workdir, "meta.json")) as f:
        meta = json.load(f)
    cases = meta["cases"]
    dist.init_process_group("gloo", init_method=f"file://{workdir}/store", rank=rank,
                            world_size=WORLD,
                            timeout=datetime.timedelta(seconds=meta["limit_s"]))
    real, walls = {}, {}
    for name, case in cases.items():
        t0 = time.perf_counter()
        mine = real_counts(case)
        per_rank = [None] * WORLD
        dist.all_gather_object(per_rank, mine)
        real[name] = per_rank
        walls[name] = time.perf_counter() - t0
    dist.barrier()
    dist.destroy_process_group()
    if rank != 0:
        return
    from repro_torch.launch.dryrun import fake_process_group

    dry = {}
    with fake_process_group(WORLD):
        for name, case in cases.items():
            t0 = time.perf_counter()
            dry[name] = dry_counts(case)
            walls["dry/" + name] = time.perf_counter() - t0
    with open(os.path.join(workdir, "results.json"), "w") as f:
        json.dump({"real": real, "dry": dry, "walls": walls}, f)


if __name__ == "__main__":
    mp.spawn(run, args=(sys.argv[1],), nprocs=WORLD, join=True)
