"""The rank side of ``tests/test_torch_distributed.py``: four gloo ranks on
the CPU run the port's sharded steps and collectives on the inputs that the
test wrote, and rank 0 writes what they gave.

    python tests/torch_dist_worker.py <workdir>

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

WORLD = 4


def _full(t):
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


def _np(t) -> np.ndarray:
    return _full(t).detach().to(torch.float32).numpy()


def case_train(inp, meta, out):
    """The (2, 2) train bundle, ``meta["train_steps"]`` steps from the
    reference's parameters."""
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.sharding import PlanConfig
    from repro_torch.launch.steps import make_train_bundle
    from repro_torch.optim import AdamWConfig, init_opt_state

    cfg = get_config(meta["arch"])
    B, S = inp["train_tokens"].shape[1:]
    mesh = make_debug_mesh(2, 2, device_type="cpu")
    opt_cfg = AdamWConfig(**meta["opt"])
    bundle = make_train_bundle(cfg, ShapeConfig("train", S, B, "train"), mesh,
                               PlanConfig(tp=2, dp=2), opt_cfg, param_dtype=torch.float32,
                               device_type="cpu")
    params = bundle.place_params({n: torch.from_numpy(inp[f"param/{meta['arch']}/{n}"])
                                  for n in meta["names"][meta["arch"]]})
    opt = init_opt_state(opt_cfg, params)
    losses, norms = [], []
    for step in range(inp["train_tokens"].shape[0]):
        batch = {"tokens": inp["train_tokens"][step], "labels": inp["train_labels"][step],
                 "step": step}
        params, opt, m = bundle.step_fn(params, opt, shard_batch(batch, mesh))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    out["train_loss"] = np.asarray(losses)
    out["train_grad_norm"] = np.asarray(norms)
    for n, p in params.items():
        out["train_param/" + n] = _np(p)
    out["train_placements"] = {n: [str(pl) for pl in p.placements] for n, p in params.items()}


def case_serve(inp, meta, out):
    """For each served arch: the (2, 2) prefill bundle, the prompt's caches
    padded into a decode bundle's, then greedy decode steps."""
    for arch, ctx in meta["serve"].items():
        _serve(arch, ctx, inp, meta, out)


def _serve(arch, ctx, inp, meta, out):
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.sharding import PlanConfig
    from repro_torch.launch.steps import make_decode_bundle, make_prefill_bundle

    cfg = get_config(arch)
    tokens = torch.from_numpy(inp["prompt/" + arch])
    B, S = tokens.shape
    mesh = make_debug_mesh(2, 2, device_type="cpu")
    plan = PlanConfig(tp=2, dp=2)
    state = {n: torch.from_numpy(inp[f"param/{arch}/{n}"]) for n in meta["names"][arch]}
    pre = make_prefill_bundle(cfg, ShapeConfig("prefill", S, B, "prefill"), mesh, plan,
                              param_dtype=torch.float32, device_type="cpu")
    dec = make_decode_bundle(cfg, ShapeConfig("decode", ctx, B, "decode"), mesh, plan,
                             param_dtype=torch.float32, device_type="cpu")
    logits, caches = pre.step_fn(pre.place_params(state), {"tokens": tokens})
    out[f"{arch}/prefill_logits"] = _np(logits)
    full = dec.model.cache_struct(B, ctx, dtype=torch.float32)
    full = {k: {n: torch.zeros(t.shape) for n, t in v.items()} for k, v in full.items()}
    for key, per in caches.items():
        for n, t in per.items():
            out[f"{arch}/prefill_cache/{key}/{n}"] = _np(t)
            full[key][n][:, :, :S] = _full(t)
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
    out[f"{arch}/cache_placements"] = {f"{k}/{n}": [str(p) for p in t.placements]
                                       for k, v in caches.items() for n, t in v.items()}
    for key, per in caches.items():
        for n, t in per.items():
            out[f"{arch}/decode_cache/{key}/{n}"] = _np(t)


def case_seqsharded(inp, meta, out):
    """``gqa_decode_seqsharded`` on a (4, 1) mesh: rank r holds the r-th
    quarter of the cache's time axis."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.attention import gqa_decode_seqsharded

    cfg = get_config(meta["arch"])
    mesh = make_debug_mesh(4, 1, device_type="cpu")
    group = mesh.get_group("data")
    r = dist.get_rank(group)
    T = inp["sq_k"].shape[1]
    Tl = T // 4
    cache = {n: torch.from_numpy(inp["sq_" + n][:, r * Tl:(r + 1) * Tl]).clone() for n in "kv"}
    p = types.SimpleNamespace(**{w: torch.from_numpy(inp["sq_" + w]) for w in
                                 ("wq", "wk", "wv", "wo")})
    y, cache = gqa_decode_seqsharded(p, torch.from_numpy(inp["sq_x"]), cfg, cache,
                                     int(meta["sq_pos"]), group)
    out["seqsharded_out"] = y.numpy()
    for n in "kv":
        parts = [torch.empty_like(cache[n]) for _ in range(4)]
        dist.all_gather(parts, cache[n].contiguous(), group=group)
        out["seqsharded_cache_" + n] = torch.cat(parts, dim=1).numpy()


def case_compression(inp, meta, out):
    """``topk_allreduce`` and ``compressed_mean_tree`` over the four ranks,
    each with its own gradient."""
    from repro_torch.optim.compression import TopKConfig, compressed_mean_tree, topk_allreduce

    r = dist.get_rank()
    cfg = TopKConfig(density=meta["topk_density"])
    g = torch.from_numpy(inp["cmp_g"][r])
    mean, err = topk_allreduce(g, torch.zeros_like(g), cfg)
    out["topk_mean"] = mean.numpy()
    errs = [torch.empty_like(err) for _ in range(WORLD)]
    dist.all_gather(errs, err)
    out["topk_err"] = torch.stack(errs).numpy()
    tree = {"a": torch.from_numpy(inp["cmp_g"][r]),
            "b": {"c": torch.from_numpy(inp["cmp_h"][r])}}
    zeros = {"a": torch.zeros_like(tree["a"]), "b": {"c": torch.zeros_like(tree["b"]["c"])}}
    means, _ = compressed_mean_tree(tree, zeros, cfg)
    out["tree_a"] = means["a"].numpy()
    out["tree_c"] = means["b"]["c"].numpy()


def case_layout(inp, meta, out):
    """Rows of an (8, 3) tensor that each rank holds under
    ``P(("pod", "data"), None)`` on a (2, 2, 1) pod/data/model mesh."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.sharding import P, placements

    mesh = make_debug_mesh(2, 1, multi_pod=True, device_type="cpu")
    t = torch.arange(24, dtype=torch.float32).reshape(8, 3)
    local = distribute_tensor(t, mesh, placements(P(("pod", "data"), None), mesh)).to_local()
    rows = [None] * WORLD
    dist.all_gather_object(rows, (local[:, 0] / 3).long().tolist())
    out["layout_rows"] = rows


def case_local_kernels(inp, meta, out):
    """The scan and the norm on local shards (``call_scan``, ``call_norm``)
    against the same call on whole tensors: outputs and every gradient,
    with the scan's channels and then its batch sharded over 'model', and
    the norm's rows over both mesh dims."""
    from torch.distributed.tensor import Shard, distribute_tensor

    from repro_torch.kernels.rmsnorm import rmsnorm
    from repro_torch.kernels.ssm_scan import ssm_scan
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.common import call_norm
    from repro_torch.models.ssm import call_scan

    mesh = make_debug_mesh(2, 2, device_type="cpu")
    g = torch.Generator().manual_seed(3)
    B, S, D, N = 4, 6, 8, 4
    full = {
        "dt": torch.rand(B, S, D, generator=g) * 0.5,
        "x": torch.randn(B, S, D, generator=g),
        "b": torch.randn(B, S, N, generator=g),
        "c": torch.randn(B, S, N, generator=g),
        "a": -torch.rand(D, N, generator=g) - 0.5,
        "h0": torch.randn(B, D, N, generator=g),
    }
    errs = {}

    def grads_of(fn, tensors):
        leaves = {k: v.clone().requires_grad_(True) for k, v in tensors.items()}
        outs = fn(leaves)
        loss = sum((o * (i + 1)).sum() for i, o in enumerate(outs))
        loss = _full(loss) if not isinstance(loss, float) else loss
        loss.backward()
        return [_full(o).detach() for o in outs], {k: _full(v.grad) for k, v in leaves.items()}

    want_out, want_grad = grads_of(lambda t: ssm_scan(t["dt"], t["x"], t["b"], t["c"],
                                                      t["a"], t["h0"]), full)
    for name, dim in (("channels", 2), ("batch", 0)):
        pl = {"dt": [Shard(0), Shard(dim)], "x": [Shard(0), Shard(dim)],
              "b": [Shard(0), Shard(0) if dim == 0 else Shard(1)],
              "c": [Shard(0), Shard(0) if dim == 0 else Shard(1)],
              "a": [Shard(1), Shard(1)], "h0": [Shard(0), Shard(1) if dim == 2 else Shard(0)]}
        sharded = {k: distribute_tensor(v, mesh, pl[k]) for k, v in full.items()}
        got_out, got_grad = grads_of(lambda t: call_scan(ssm_scan, t["dt"], t["x"], t["b"],
                                                         t["c"], t["a"], t["h0"]), sharded)
        errs[f"scan/{name}"] = max(
            [float((a - b).abs().max()) for a, b in zip(got_out, want_out)]
            + [float((got_grad[k] - want_grad[k]).abs().max()) for k in full])
    x = torch.randn(4, 6, 16, generator=g)
    gain = torch.rand(16, generator=g) + 0.5
    want_out, want_grad = grads_of(lambda t: [rmsnorm(t["x"], t["gain"])], {"x": x, "gain": gain})
    sharded = {"x": distribute_tensor(x, mesh, [Shard(0), Shard(1)]),
               "gain": distribute_tensor(gain, mesh, [Shard(0), Shard(0)])}
    got_out, got_grad = grads_of(lambda t: [call_norm(rmsnorm, t["x"], t["gain"], 1e-5)], sharded)
    errs["norm/rows"] = max([float((got_out[0] - want_out[0]).abs().max())]
                            + [float((got_grad[k] - want_grad[k]).abs().max()) for k in want_grad])
    out["local_kernel_err"] = errs


def _vocab_case_config(case: str, meta):
    """The config of a vocabulary-loss case: its arch, its vocabulary cut
    where the case names one (a padded vocabulary)."""
    import dataclasses

    from repro_torch.configs import get_config

    arch, vocab = meta["vocab_cases"][case]
    cfg = get_config(arch)
    return cfg if vocab is None else dataclasses.replace(cfg, vocab=vocab)


def _loss_and_grads(bundle, params, batch, mesh):
    """The train bundle's loss and every parameter's gradient, whole, for
    ``batch`` placed as the step places it (no optimizer step)."""
    from repro_torch.launch import sharding as shlib
    from repro_torch.launch import steps
    from repro_torch.models.common import axis_rules

    bspecs = shlib.batch_specs(bundle.args[2], bundle.rules)
    placed = steps._long({k: steps._place(torch.from_numpy(v), bspecs[k], mesh)
                          for k, v in batch.items()})
    for p in params.values():
        p.grad = None

    def run(m):
        loss, _ = m.loss_fn(placed)
        loss = _full(loss)
        loss.backward()
        return loss

    with axis_rules(bundle.rules):
        loss = steps._call(bundle.model, params, run)
    return float(loss), {n: _np(p.grad) for n, p in params.items()}


def case_vocab_loss(inp, meta, out):
    """The train bundle's loss and gradients with the vocabulary split over
    'model' (tp 2 on the (2, 2) mesh, tp 4 on a (1, 4) mesh of the same
    ranks) through the vocabulary-parallel cross-entropy, and again with
    the vocabulary gathered whole (the loss a one-rank 'model' dim runs);
    the split loss's calls are counted."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.sharding import PlanConfig
    from repro_torch.launch.steps import make_train_bundle
    from repro_torch.models import common
    from repro_torch.models import model as model_module

    calls = [0]
    split_ce = model_module.vocab_parallel_cross_entropy

    def counted(*args):
        calls[0] += 1
        return split_ce(*args)

    model_module.vocab_parallel_cross_entropy = counted
    try:
        for case, (arch, _) in meta["vocab_cases"].items():
            cfg = _vocab_case_config(case, meta)
            state = {n: torch.from_numpy(inp[f"param/{arch}/{n}"]) for n in meta["names"][arch]}
            batch = {k: inp[f"vocab/{case}/{k}"] for k in meta["vocab_batch_keys"][case]}
            B, S = batch["tokens"].shape
            for mesh_name, (dp, tp) in meta["vocab_meshes"].items():
                mesh = make_debug_mesh(dp, tp, device_type="cpu")
                bundle = make_train_bundle(cfg, ShapeConfig("train", S, B, "train"), mesh,
                                           PlanConfig(tp=tp, dp=dp), param_dtype=torch.float32,
                                           device_type="cpu")
                params = bundle.place_params(state)
                for loss_kind in ("split", "gathered"):
                    before = calls[0]
                    if loss_kind == "gathered":
                        model_module.vocab_split = lambda logits: False
                    try:
                        loss, grads = _loss_and_grads(bundle, params, batch, mesh)
                    finally:
                        model_module.vocab_split = common.vocab_split
                    key = f"vocab/{case}/{mesh_name}/{loss_kind}"
                    out[key + "/loss"] = np.asarray(loss)
                    out[key + "/calls"] = calls[0] - before
                    for n, g in grads.items():
                        out[f"{key}/grad/{n}"] = g
    finally:
        model_module.vocab_parallel_cross_entropy = split_ce


CASES = (case_train, case_serve, case_seqsharded, case_compression, case_layout,
         case_local_kernels, case_vocab_loss)


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
