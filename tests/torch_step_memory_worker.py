"""The rank side of ``tests/test_torch_step_memory.py``'s gloo case: four
gloo ranks on the CPU run the train bundle's loss and gradients for
llama3-8b@smoke and jamba@smoke on a (2, 2) and a (1, 4) ("data",
"model") mesh, once as the blocks now hand on their updates (reduce-
scattered at each block's end) and once with that reduce-scatter left to
the next norm, as before; rank 0 writes each case's largest difference.

    python tests/torch_step_memory_worker.py <workdir>

The ranks meet through a ``FileStore`` in ``<workdir>``, each process
group timing out after ``meta.json``'s ``limit_s``; rank 0 writes
``<workdir>/results.json``.  Nothing here imports JAX or the reference.
"""
from __future__ import annotations

import datetime
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

WORLD = 4
ARCHS = ("llama3-8b@smoke", "jamba-1.5-large-398b@smoke")
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
B, S = 4, 32


def _update_left_to_the_next_norm(shard_act):
    """``transformer.shard_act`` as the blocks ran it before their updates
    were reduced at their ends: a partial sum (only a block's update is
    one) goes on as it is, for the next norm to reduce."""
    from torch.distributed.tensor import DTensor, Partial

    def patched(x, axes):
        if isinstance(x, DTensor) and any(isinstance(p, Partial) for p in x.placements):
            return x
        return shard_act(x, axes)

    return patched


def run(rank: int, workdir: str) -> None:
    from torch_dist_worker import _loss_and_grads

    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.sharding import PlanConfig
    from repro_torch.launch.steps import make_train_bundle
    from repro_torch.models import build_model, transformer

    torch.set_num_threads(1)
    with open(os.path.join(workdir, "meta.json")) as f:
        meta = json.load(f)
    dist.init_process_group("gloo", init_method=f"file://{workdir}/store", rank=rank,
                            world_size=WORLD,
                            timeout=datetime.timedelta(seconds=meta["limit_s"]))
    out = {}
    shard_act = transformer.shard_act
    for arch in ARCHS:
        cfg = get_config(arch)
        state = {n: p.detach().clone()
                 for n, p in build_model(cfg, device="cpu", seed=0).named_parameters()}
        rng = np.random.default_rng(0)
        batch = {k: rng.integers(0, cfg.vocab, (B, S)) for k in ("tokens", "labels")}
        for name, (dp, tp) in MESHES.items():
            mesh = make_debug_mesh(dp, tp, device_type="cpu")
            bundle = make_train_bundle(cfg, ShapeConfig("train", S, B, "train"), mesh,
                                       PlanConfig(tp=tp, dp=dp), param_dtype=torch.float32,
                                       device_type="cpu")
            params = bundle.place_params(state)
            runs = {}
            for how in ("at the block's end", "at the next norm"):
                if how == "at the next norm":
                    transformer.shard_act = _update_left_to_the_next_norm(shard_act)
                try:
                    runs[how] = _loss_and_grads(bundle, params, batch, mesh)
                finally:
                    transformer.shard_act = shard_act
            (loss, grads), (loss0, grads0) = runs.values()
            out[f"{arch}/{name}"] = {
                "loss": [loss, loss0],
                "grad_max_abs_diff": max(float(np.abs(g - grads0[n]).max())
                                         for n, g in grads.items()),
                "grads_bitwise": all(np.array_equal(g, grads0[n]) for n, g in grads.items()),
                "n_grads": len(grads)}
    dist.barrier()
    if rank == 0:
        with open(os.path.join(workdir, "results.json"), "w") as f:
            json.dump(out, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    mp.spawn(run, args=(sys.argv[1],), nprocs=WORLD, join=True)
