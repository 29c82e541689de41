"""The rank side of ``tests/test_torch_distributed_blocks.py``: four gloo
ranks on the CPU run the port's sharded MoE, Mamba and xLSTM paths on the
inputs that the test wrote, and rank 0 writes what they gave.

    python tests/torch_dist_blocks_worker.py <workdir>

``<workdir>/inputs.npz`` holds the inputs (``meta.json`` the shapes and
settings); the ranks meet through a ``FileStore`` in ``<workdir>`` (no
TCP port), each process group timing out after the test's limit on the
ranks (``meta["limit_s"]``, so a rank that waits on a slow peer under load
waits as long as the test does), and rank 0 writes
``<workdir>/results.npz`` and ``results.json``.  ``torch.multiprocessing.
spawn`` ends every rank when one fails.  Nothing here imports JAX or the
reference package: the test compares the results with them.
"""
from __future__ import annotations

import dataclasses
import datetime
import json
import os
import sys
import time
import types

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

WORLD = 4


def _full(t):
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


def _np(t) -> np.ndarray:
    return _full(t).detach().to(torch.float32).numpy()


def _mesh():
    from repro_torch.launch.mesh import make_debug_mesh

    return make_debug_mesh(2, 2, device_type="cpu")


def _plan(ep):
    from repro_torch.launch.sharding import PlanConfig

    return PlanConfig(tp=2, dp=2, ep=ep)


def _state(inp, meta, arch):
    return {n: torch.from_numpy(inp[f"param/{arch}/{n}"]) for n in meta["names"][arch]}


def case_moe(inp, meta, out):
    """``moe_ffn`` alone on the (2, 2) mesh, x's batch over 'data', under EP
    and under expert-TP (``ep=False``), and under EP with one dispatch
    group, which the two 'data' ranks split unevenly (the first runs it,
    the second none)."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch.sharding import make_rules, placements
    from repro_torch.models.common import axis_rules, logical_to_spec
    from repro_torch.models.moe import moe_defs, moe_ffn

    cfg = dataclasses.replace(get_config(meta["moe_arch"]),
                              capacity_factor=meta["moe_capacity_factor"])
    x = torch.from_numpy(inp["moe_x"])
    B, S, _ = x.shape
    mesh = _mesh()
    defs = moe_defs(cfg, 1)
    one_group = dataclasses.replace(cfg, moe_groups=1)
    for label, ep, cfg in (("ep", None, cfg), ("expert_tp", False, cfg),
                           ("ep_one_group", None, one_group)):
        rules = make_rules(cfg, ShapeConfig("prefill", S, B, "prefill"), _plan(ep))
        p = {}
        for n, pd in defs.items():
            spec = logical_to_spec(pd.axes[1:], rules)
            p[n] = distribute_tensor(torch.from_numpy(inp["moe_" + n]), mesh,
                                     placements(spec, mesh))
        with axis_rules(rules):
            y, aux = moe_ffn(types.SimpleNamespace(**p), distribute_tensor(
                x, mesh, [Shard(0), Replicate()]), cfg)
        out[f"moe/{label}/y"] = _np(y)
        out[f"moe/{label}/aux"] = {k: float(_full(v)) for k, v in aux.items()}
        out[f"moe/{label}/w1_local"] = list(p["w1"].to_local().shape)


def case_train(inp, meta, out):
    """The (2, 2) train bundle of each trained arch under its plan's
    ``ep``, two steps from the reference's parameters (remat "full"), and
    the first step's gradients as the update receives them."""
    from chip_smoke import first_step_grads, optimizer_steps_replayed
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.launch import steps
    from repro_torch.launch.steps import make_train_bundle
    from repro_torch.optim import AdamWConfig, init_opt_state

    mesh = _mesh()
    opt_cfg = AdamWConfig(**meta["opt"])
    for arch, ep in meta["train"].items():
        cfg = get_config(arch)
        B, S = inp["train_tokens/" + arch].shape[1:]
        bundle = make_train_bundle(cfg, ShapeConfig("train", S, B, "train"), mesh, _plan(ep),
                                   opt_cfg, param_dtype=torch.float32, device_type="cpu")
        params = bundle.place_params(_state(inp, meta, arch))
        opt = init_opt_state(opt_cfg, params)
        losses = []
        with first_step_grads(steps) as grads0, optimizer_steps_replayed(
                steps, keep=dist.get_rank() == 0) as replayed:
            for step in range(inp["train_tokens/" + arch].shape[0]):
                batch = {"tokens": inp["train_tokens/" + arch][step],
                         "labels": inp["train_labels/" + arch][step], "step": step}
                params, opt, m = bundle.step_fn(params, opt, shard_batch(batch, mesh))
                losses.append(float(m["loss"]))
        for n, g in grads0.items():
            out[f"{arch}/train_grad0/{n}"] = g.numpy()
        out[f"{arch}/adamw_replay_err"] = replayed
        out[f"{arch}/train_loss"] = np.asarray(losses)
        for n, p in params.items():
            out[f"{arch}/train_param/{n}"] = _np(p)
        out[f"{arch}/param_local"] = {n: [list(p.to_local().shape), [str(q) for q in p.placements]]
                                      for n, p in params.items()}


def case_serve(inp, meta, out):
    """For each served arch: the (2, 2) prefill bundle, the prompt's caches
    padded into a decode bundle's, then greedy decode steps."""
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch.steps import make_decode_bundle, make_prefill_bundle

    mesh = _mesh()
    for arch, ep in meta["serve"].items():
        cfg = get_config(arch)
        tokens = torch.from_numpy(inp["prompt/" + arch])
        B, S = tokens.shape
        ctx = meta["ctx"]
        state = _state(inp, meta, arch)
        pre = make_prefill_bundle(cfg, ShapeConfig("prefill", S, B, "prefill"), mesh, _plan(ep),
                                  param_dtype=torch.float32, device_type="cpu")
        dec = make_decode_bundle(cfg, ShapeConfig("decode", ctx, B, "decode"), mesh, _plan(ep),
                                 param_dtype=torch.float32, device_type="cpu")
        logits, caches = pre.step_fn(pre.place_params(state), {"tokens": tokens})
        out[f"{arch}/prefill_logits"] = _np(logits)
        full = dec.model.cache_struct(B, ctx, dtype=torch.float32)
        full = {k: {n: torch.zeros(t.shape) for n, t in v.items()} for k, v in full.items()}
        for key, per in caches.items():
            for n, t in per.items():
                out[f"{arch}/prefill_cache/{key}/{n}"] = _np(t)
                if n in ("k", "v"):            # attention: the prompt's positions
                    full[key][n][:, :, :S] = _full(t)
                else:                          # a recurrent block's state, whole
                    full[key][n].copy_(_full(t))
        caches = full
        params = dec.place_params(state)
        token = _full(logits).argmax(-1)
        steps = []
        for i in range(meta["decode_steps"]):
            out[f"{arch}/decode_token/{i}"] = token.numpy()
            logits, caches = dec.step_fn(params, caches, token, S + i)
            steps.append(_np(logits))
            token = _full(logits).argmax(-1)
        out[f"{arch}/decode_logits"] = np.stack(steps)
        out[f"{arch}/cache_local"] = {
            f"{k}/{n}": [list(t.to_local().shape), [str(p) for p in t.placements]]
            for k, v in caches.items() for n, t in v.items()}
        out[f"{arch}/serve_param_local"] = {
            n: [list(p.to_local().shape), [str(q) for q in p.placements]]
            for n, p in params.items()}
        for key, per in caches.items():
            for n, t in per.items():
                out[f"{arch}/decode_cache/{key}/{n}"] = _np(t)


CASES = (case_moe, case_train, case_serve)


def run(rank: int, workdir: str) -> None:
    torch.set_num_threads(1)
    with open(os.path.join(workdir, "meta.json")) as f:
        meta = json.load(f)
    dist.init_process_group("gloo", init_method=f"file://{workdir}/store", rank=rank,
                            world_size=WORLD,
                            timeout=datetime.timedelta(seconds=meta["limit_s"]))
    inp = dict(np.load(os.path.join(workdir, "inputs.npz")))
    out: dict = {}
    walls = {}
    for case in CASES:
        t0 = time.perf_counter()
        case(inp, meta, out)
        walls[case.__name__] = time.perf_counter() - t0
    dist.barrier()
    if rank == 0:
        arrays = {k: v for k, v in out.items() if isinstance(v, np.ndarray)}
        rest = {k: v for k, v in out.items() if not isinstance(v, np.ndarray)}
        np.savez(os.path.join(workdir, "results.npz"), **arrays)
        with open(os.path.join(workdir, "results.json"), "w") as f:
            json.dump({**rest, "walls": walls}, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    mp.spawn(run, args=(sys.argv[1],), nprocs=WORLD, join=True)
