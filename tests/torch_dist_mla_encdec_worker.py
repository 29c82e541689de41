"""The rank side of ``tests/test_torch_distributed_mla_encdec.py``: four gloo
ranks on the CPU run the port's sharded train, prefill and decode bundles
of MLA, encoder-decoder and frontend models on the inputs that the test
wrote, and rank 0 writes what they gave.

    python tests/torch_dist_mla_encdec_worker.py <workdir>

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

import contextlib
import dataclasses
import datetime
import json
import os
import sys
import time

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


def _local(t) -> list:
    """A DTensor's local shape and placements, as the test reads them."""
    return [list(t.to_local().shape), [str(p) for p in t.placements]]


def _mesh():
    from repro_torch.launch.mesh import make_debug_mesh

    return make_debug_mesh(2, 2, device_type="cpu")


def _plan():
    from repro_torch.launch.sharding import PlanConfig

    return PlanConfig(tp=2, dp=2)


def _config(meta, name):
    """A case's config: its arch's @smoke config with the case's overrides
    (``frontend_tokens`` for frames that do not divide tp)."""
    from repro_torch.configs import get_config

    arch, overrides = meta["cases"][name]
    return arch, dataclasses.replace(get_config(arch), **overrides)


def _state(inp, meta, name):
    """A case's parameters: its arch's, or its own where its overrides
    change their shapes (``meta["weights"]``)."""
    key = meta["weights"][name]
    return {n: torch.from_numpy(inp[f"param/{key}/{n}"]) for n in meta["names"][key]}


@contextlib.contextmanager
def _key_shard_calls():
    """The mesh dims of each call of MLA prefill's attention split over the
    keys (``models.attention.key_shard_attention``) inside."""
    from repro_torch.models import attention

    real, calls = attention.key_shard_attention, []

    def counted(q, k, v, dims, *args, **kwargs):
        calls.append(list(dims))
        return real(q, k, v, dims, *args, **kwargs)

    attention.key_shard_attention = counted
    try:
        yield calls
    finally:
        attention.key_shard_attention = real


def case_train(inp, meta, out):
    """The (2, 2) train bundle of each trained case, two steps from the
    reference's parameters (remat "full"), and the first step's gradients
    as the update receives them."""
    from chip_smoke import first_step_grads, optimizer_steps_replayed
    from repro_torch.configs import ShapeConfig
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.launch import steps
    from repro_torch.launch.steps import make_train_bundle
    from repro_torch.optim import AdamWConfig, init_opt_state

    mesh = _mesh()
    opt_cfg = AdamWConfig(**meta["opt"])
    for name in meta["train"]:
        _, cfg = _config(meta, name)
        B, S = inp["train_tokens/" + name].shape[1:]
        if cfg.frontend is not None and not cfg.is_encdec:
            S += cfg.frontend_tokens
        bundle = make_train_bundle(cfg, ShapeConfig("train", S, B, "train"), mesh, _plan(),
                                   opt_cfg, param_dtype=torch.float32, device_type="cpu")
        params = bundle.place_params(_state(inp, meta, name))
        opt = init_opt_state(opt_cfg, params)
        losses = []
        with first_step_grads(steps) as grads0, optimizer_steps_replayed(
                steps, keep=dist.get_rank() == 0) as replayed, _key_shard_calls() as split:
            for step in range(inp["train_tokens/" + name].shape[0]):
                batch = {"tokens": inp["train_tokens/" + name][step],
                         "labels": inp["train_labels/" + name][step]}
                if cfg.frontend is not None:
                    batch["frontend"] = inp["train_frontend/" + name][step]
                params, opt, m = bundle.step_fn(params, opt, shard_batch(batch, mesh))
                losses.append(float(m["loss"]))
        for n, g in grads0.items():
            out[f"{name}/train_grad0/{n}"] = g.numpy()
        out[f"{name}/adamw_replay_err"] = replayed
        out[f"{name}/train_key_shard_calls"] = split
        out[f"{name}/train_loss"] = np.asarray(losses)
        for n, p in params.items():
            out[f"{name}/train_param/{n}"] = _np(p)
        out[f"{name}/param_local"] = {n: _local(p) for n, p in params.items()}


def case_serve(inp, meta, out):
    """For each served case: the (2, 2) prefill bundle, the prompt's caches
    padded into a decode bundle's (the sequence caches over the prefill's
    positions, ``cross_kv`` whole), then greedy decode steps."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.serve import SEQUENCE_CACHES
    from repro_torch.launch.steps import make_decode_bundle, make_prefill_bundle

    mesh = _mesh()
    for name in meta["serve"]:
        _, cfg = _config(meta, name)
        tokens = torch.from_numpy(inp["prompt/" + name])
        B = tokens.shape[0]
        filled, ctx = meta["filled"][name], meta["ctx"][name]
        state = _state(inp, meta, name)
        batch = {"tokens": tokens}
        if cfg.frontend is not None:
            batch["frontend"] = torch.from_numpy(inp["frontend/" + name])
        pre = make_prefill_bundle(cfg, ShapeConfig("prefill", filled, B, "prefill"), mesh,
                                  _plan(), param_dtype=torch.float32, device_type="cpu")
        dec = make_decode_bundle(cfg, ShapeConfig("decode", ctx, B, "decode"), mesh, _plan(),
                                 param_dtype=torch.float32, device_type="cpu")
        with _key_shard_calls() as split:
            logits, caches = pre.step_fn(pre.place_params(state), batch)
        out[f"{name}/prefill_key_shard_calls"] = split
        out[f"{name}/prefill_logits"] = _np(logits)
        full = dec.model.cache_struct(B, ctx, dtype=torch.float32)
        full = {k: {n: torch.zeros(t.shape) for n, t in v.items()} for k, v in full.items()}
        for key, per in caches.items():
            for n, t in per.items():
                out[f"{name}/prefill_cache/{key}/{n}"] = _np(t)
                if n in SEQUENCE_CACHES and key != "cross_kv":
                    full[key][n][:, :, :filled] = _full(t)
                else:
                    full[key][n].copy_(_full(t))
        caches = full
        params = dec.place_params(state)
        token = _full(logits).argmax(-1)
        steps = []
        for i in range(meta["decode_steps"]):
            out[f"{name}/decode_token/{i}"] = token.numpy()
            logits, caches = dec.step_fn(params, caches, token, filled + i)
            steps.append(_np(logits))
            token = _full(logits).argmax(-1)
        out[f"{name}/decode_logits"] = np.stack(steps)
        out[f"{name}/cache_local"] = {f"{k}/{n}": _local(t)
                                      for k, v in caches.items() for n, t in v.items()}
        out[f"{name}/serve_param_local"] = {n: _local(p) for n, p in params.items()}
        for key, per in caches.items():
            for n, t in per.items():
                out[f"{name}/decode_cache/{key}/{n}"] = _np(t)


CASES = (case_train, case_serve)


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
