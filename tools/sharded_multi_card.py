"""The sharded steps across four ranks: the (2, 2) ``("data", "model")``
train bundle of stablelm-1.6b whole (fp32, remat "none") on four cards over
NCCL, with the hand-written kernels on each rank's local shards, against
``make_step`` on one card from the same seed-0 parameters and batches
(phase 21 (b)'s first batches, 4 x 256); then ``gqa_decode_seqsharded`` on
a (4, 1) mesh against ``gqa_decode``, and ``topk_allreduce`` over the four
ranks against the mean of each rank's decompressed payload.

Gates: losses within rel 1e-5; the sharded optimizer step alone: each
step's update equal to ``adamw_update`` on card 0 applied to that step's
gathered parameters, gradients and state, within 1e-6 of each leaf's
largest entry (``chip_smoke.optimizer_steps_replayed``); the parameters
against ``make_step``'s by the size of each entry's clipped first-step
gradient (:func:`classify_entries`): at least 10 Adam eps in both runs,
within 1e-4 of the leaf's largest entry; under that in either run (where
Adam's first update g/(|g|+eps) follows the gradient's rounding: faults 2
and 3), apart by at most the steps' summed learning rate, the entries that
moved opposite ways counted and printed, not held; each rank's kernel launches those of the steps on
its shards (the single card's counts); a dry run of the same cell on a
fake group of four ranks (``repro_torch.launch.dryrun.count_step``) equal
to one more real step counted on every rank (``launch/counting.py``), in
FLOPs and in collective bytes by kind; the sequence-sharded decode within
1e-5 of the largest entry; the all-reduce within rel 1e-6.  Prints the
step walls of both, each rank's peak memory (the whole run, and one
counted step's memory above its arguments beside the dry run's peak), the
first step's gradients' largest difference (reported), how many entries fall in each class with
the largest gap in each, and one JSON line.  The ranks meet through a ``FileStore`` in a temporary directory (no
TCP port), each process group with a 60 s timeout;
``torch.multiprocessing.spawn`` ends every rank when one fails.

``--layers N`` cuts the model to its first N layers at full width
(olmoe-1b-7b at 4 of 16: experts over 'model' across cards, and a
single-card reference that fits).  ``--dump-row R`` follows row R of the
embedding through both runs: each step's gradient as the update receives
it, each rank's partial sum of it before the reduction (the lookup's
``Partial`` gradient), Adam's ``m`` and ``v`` after the step and the
row's update; it prints where the row's parameters differ most and why,
and writes the vectors to ``build/dump_row.npz``.

    python3 tools/sharded_multi_card.py                  # four CUDA cards, NCCL
    python3 tools/sharded_multi_card.py --dump-row 34514
    python3 tools/sharded_multi_card.py --arch olmoe-1b-7b --layers 4
    PYTHONPATH=src python3 tools/sharded_multi_card.py --device cpu \\
        --arch stablelm-1.6b@smoke --seq 32              # four gloo ranks on the host
"""
from __future__ import annotations

import argparse
import dataclasses
import datetime
import gc
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

WORLD = 4
LOSS_RTOL, PARAM_ATOL_REL, SEQ_TOL, TOPK_RTOL = 1e-5, 1e-4, 1e-5, 1e-6
REPLAY_ATOL_REL = 1e-6  # the sharded update vs adamw_update on its own inputs, of leaf max
ADAM_EPS_CLASS = 10     # clipped first-step gradients from this many Adam eps are held to PARAM_ATOL_REL


def log(rank: int, msg: str) -> None:
    if rank == 0:
        print(msg, flush=True)


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


class RowDump:
    """One embedding row through a run: per step the gradient as the
    update receives it, Adam's ``m`` and ``v`` after the step, and the row
    before and after it (``steps``); on local shards also this rank's
    partial sum of the gradient before the reduction (``partials``)."""

    def __init__(self, row: int):
        self.row = row
        self.steps: list[dict] = []
        self.partials: list = []

    def take(self, t):
        """Row ``row`` of a (possibly sharded) table, on the host in fp32."""
        import torch

        full = t.full_tensor() if hasattr(t, "full_tensor") else t
        return full[self.row].detach().to("cpu", torch.float32, copy=True)

    def spy(self, module):
        """Wraps ``module.adamw_update`` to record the row; returns an undo."""
        update = module.adamw_update

        def recorded(cfg, params, grads, state):
            before = self.take(params["embed"])
            params, state, om = update(cfg, params, grads, state)
            self.steps.append(dict(grad=self.take(grads["embed"]), before=before,
                                   m=self.take(state["m"]["embed"]),
                                   v=self.take(state["v"]["embed"]),
                                   after=self.take(params["embed"])))
            return params, state, om

        module.adamw_update = recorded
        return lambda: setattr(module, "adamw_update", update)

    def tap_lookup(self):
        """Replaces the model's ``embed_lookup`` with one that records the
        row of each rank's local table gradient (its partial sum, zero on
        a rank whose tokens miss the row); returns an undo."""
        import torch
        from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

        from repro_torch.models import common, model

        dump = self

        class Tap(torch.autograd.Function):
            @staticmethod
            def forward(ctx, t):
                return t.view_as(t)

            @staticmethod
            def backward(ctx, g):
                dump.partials.append(g[dump.row].detach().to("cpu", copy=True))
                return g

        def lookup(table, tokens):
            if not isinstance(table, DTensor):
                return common.embed_lookup(table, tokens)
            tokens = common.replicated_like(tokens, table)
            pl = list(tokens.placements)
            grad = [Partial() if isinstance(p, Shard) else Replicate() for p in pl]
            return common.on_shards(lambda t, i: Tap.apply(t)[i], (table, tokens),
                                    ([Replicate()] * len(pl), pl), pl, (grad, pl))

        inner = model.embed_lookup
        model.embed_lookup = lookup
        return lambda: setattr(model, "embed_lookup", inner)


def row_summary(row, single, sharded, partials, leaf_max, batches) -> dict:
    """Fault 2's measurement: per step, the sharded gradient of the row
    against the single card's (absolute, relative to the row's largest
    entry, and in units of the fp32 spacing at that entry), and whether the
    ranks' partial sums add up to the reduced row bit for bit with every
    rank but the token's holder at exact zero; then, at the column where the
    two runs' parameters differ most, each step's gradient, ``m``, ``v`` and
    update in both runs."""
    import torch

    where = [[int(b), int(p)] for s, batch in enumerate(batches)
             for b, p in (batch["tokens"] == row).nonzero().tolist()]
    seen = {s: int((batch["tokens"] == row).sum()) for s, batch in enumerate(batches)}
    out = {"row": row, "token_count_by_step": seen, "positions_step0": where[:8], "steps": []}
    for s, (a, b) in enumerate(zip(single.steps, sharded)):
        diff = (b["grad"] - a["grad"]).abs()
        top = float(a["grad"].abs().max())
        ulp = float(torch.finfo(torch.float32).eps) * 2.0 ** float(torch.floor(torch.log2(
            torch.tensor(max(top, 1e-38)))))
        # the tokens split over 'data' and repeat over 'model': the
        # reduction adds the data ranks' partials, each model replica alike
        parts = {tuple(coord): p[s] for coord, p in partials}
        total = None
        for coord in sorted(c for c in parts if c[1] == 0):
            total = parts[coord].clone() if total is None else total + parts[coord]
        out["steps"].append(dict(
            grad_row_max=top, grad_max_abs_diff=float(diff.max()),
            grad_rel_diff=float(diff.max()) / max(top, 1e-38),
            grad_diff_in_ulps_of_row_max=float(diff.max()) / ulp,
            partials_sum_bitwise_reduced=bool(torch.equal(total, b["grad"])),
            model_replicas_bitwise=all(torch.equal(p, parts[(c[0], 0)]) for c, p in parts.items()),
            ranks_with_nonzero_partial=[list(c) for c, p in sorted(parts.items())
                                        if bool(p.ne(0).any())]))
    gap = (sharded[-1]["after"] - single.steps[-1]["after"]).abs()
    col = int(gap.argmax())
    out["column"] = col
    out["param_gap"] = float(gap[col])
    out["param_gap_rel_leaf_max"] = float(gap[col]) / leaf_max
    out["at_column"] = [
        {run: {k: float(st[k][col]) for k in ("grad", "m", "v")}
         | {"update": float(st["after"][col] - st["before"][col])}
         for run, st in (("make_step", a), ("bundle", b))}
        for a, b in zip(single.steps, sharded)]
    return out


def single_card_reference(cfg, opt_cfg, batches, device, dump=None) -> dict:
    """``make_step`` on one device: losses, learning rates, step walls, and
    the parameters before and after the steps, on the host (``dump``, a
    :class:`RowDump`, records its row)."""
    import torch

    import chip_smoke as cs
    from repro_torch.launch import train
    from repro_torch.launch.train import make_step
    from repro_torch.models import build_model
    from repro_torch.optim import init_opt_state

    model = build_model(cfg, device=device, seed=0).trainable()
    params = dict(model.named_parameters())
    start = {n: p.detach().to("cpu", copy=True) for n, p in params.items()}
    opt = init_opt_state(opt_cfg, params)
    step_fn = make_step(model, opt_cfg)
    losses, lrs, ms, norms = [], [], [], []
    with cs.first_step_grads(train) as grads0:
        undo = dump.spy(train) if dump else None
        for b in batches:
            sync(device)
            t0 = time.perf_counter()
            params, opt, m = step_fn(params, opt, {k: v.to(device) for k, v in b.items()})
            losses.append(float(m["loss"]))
            ms.append((time.perf_counter() - t0) * 1e3)
            lrs.append(float(m["lr"]))
            norms.append(float(m["grad_norm"]))
        if undo:
            undo()
    out = dict(losses=losses, lrs=lrs, step_ms=ms, grad_norms=norms, start=start, grads0=grads0,
               params={n: p.detach().to("cpu") for n, p in params.items()})
    del model, params, opt, step_fn
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def sharded_train(rank, cfg, opt_cfg, batches, device, ref, dump=None) -> dict:
    """The (2, 2) train bundle for the same steps; its parameters gathered
    leaf by leaf and held to ``ref`` on rank 0 (``dump``, a
    :class:`RowDump`, records its row on every rank)."""
    import torch
    import torch.distributed as dist

    import chip_smoke as cs
    from repro_torch.configs import ShapeConfig
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.sharding import PlanConfig
    from repro_torch.launch.steps import make_train_bundle
    from repro_torch.models import build_model
    from repro_torch.optim import init_opt_state

    mesh = make_debug_mesh(2, 2, device_type=device.type)
    B, S = batches[0]["tokens"].shape
    bundle = make_train_bundle(cfg, ShapeConfig("train", S + cs.front_tokens(cfg), B, "train"),
                               mesh,
                               PlanConfig(tp=2, dp=2), opt_cfg, param_dtype=torch.float32,
                               remat="none", device_type=device.type)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    model = build_model(cfg, device=device, seed=0)
    params = bundle.place_params(dict(model.named_parameters()))
    del model
    gc.collect()
    opt = init_opt_state(opt_cfg, params)
    cs.zero_launches()
    losses, ms, norms = [], [], []
    with cs.first_step_grads(steps, keep=rank == 0) as grads0, cs.optimizer_steps_replayed(
            steps, keep=rank == 0, device=device) as replayed:
        undo = [dump.spy(steps), dump.tap_lookup()] if dump else []
        for b in batches:
            dist.barrier()
            sync(device)
            t0 = time.perf_counter()
            params, opt, m = bundle.step_fn(params, opt, shard_batch(b, mesh))
            losses.append(float(m["loss"]))
            ms.append((time.perf_counter() - t0) * 1e3)
            norms.append(float(m["grad_norm"]))
        for u in undo:
            u()
    launches = cs.kernel_launches()
    grad_errs = {n: float((grads0[n] - w).abs().max()) / max(float(w.abs().max()), 1e-30)
                 for n, w in ref["grads0"].items()} if rank == 0 else {}
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    errs, over, shares, classes = {}, {}, {}, {}
    lr_sum = sum(ref["lrs"]) if rank == 0 else 0.0
    for n, p in params.items():
        full = p.full_tensor().detach().to("cpu")
        if rank == 0:
            want = ref["params"][n]
            scale = max(float(want.abs().max()), 1e-30)
            diff = (full - want).abs()
            errs[n] = float(diff.max()) / scale
            shares[n] = float(diff.max()) / lr_sum
            grads = (grads0[n], ref["grads0"][n])
            firsts = (norms[0], ref["grad_norms"][0])
            classes[n], failed = classify_entries(full, want, ref["start"][n], grads, firsts,
                                                  opt_cfg, lr_sum)
            if not classes[n]["ok"]:
                over[n] = _offenders(full, want, ref["start"][n], diff, failed, grads, firsts,
                                     opt_cfg)
    del grads0
    counted = count_real_step(bundle, params, opt, shard_batch(batches[0], mesh), device)
    per_rank = [None] * WORLD
    dist.all_gather_object(per_rank, {"launches": launches, "peak_bytes": peak,
                                      "counted": counted})
    worst_name = max(errs, key=errs.get) if errs else None
    row = None
    if dump:
        partials = [None] * WORLD
        dist.all_gather_object(partials, (mesh.get_coordinate(), dump.partials))
        if rank == 0:
            row = row_summary(dump.row, ref["dump"], dump.steps, partials,
                              float(ref["params"]["embed"].abs().max()), batches)
            save_row(ref["dump"], dump.steps, partials)
    grad_worst = max(grad_errs, key=grad_errs.get) if grad_errs else None
    replay = {n: max(step[n] for step in replayed) for n in replayed[0]} if replayed else {}
    return dict(row_dump=row, param_max_err_of_lr_sum=max(shares.values(), default=0.0),
                classes=class_totals(classes), replay_max_rel_err=max(replay.values(), default=0.0),
                replay_worst_leaf=max(replay, key=replay.get) if replay else None,
                grad0_max_rel_err=grad_errs.get(grad_worst, 0.0), grad0_worst_leaf=grad_worst,
                losses=losses, step_ms=ms, param_max_rel_err=errs.get(worst_name, 0.0),
                worst_leaf=worst_name, leaf_errs=sorted(errs.items(), key=lambda kv: -kv[1])[:5],
                offenders=over, per_rank=per_rank,
                placements=sorted({str(tuple(p.placements)) for p in params.values()}))


def classify_entries(got, want, start, grads0, norms, opt_cfg, lr_sum) -> dict:
    """The parameter gate of one leaf: the sharded run's parameters ``got``
    against ``make_step``'s ``want`` (both from ``start``), each entry
    classed by its clipped first-step gradient in both runs (``grads0``:
    bundle's, make_step's; ``norms``: each run's first gradient norm).

    - ``above``: at least ``ADAM_EPS_CLASS`` Adam eps in both runs.  Adam's
      update there is the gradient's sign to within eps/|g|, so both runs
      land within ``PARAM_ATOL_REL`` of the leaf's largest entry.
    - ``below``: under that in either run.  Adam's first update g/(|g|+eps)
      then follows the gradient's own rounding (up to 1/eps of it), so no
      share of the step bounds two correct runs apart; such an entry must
      land at most the steps' summed learning rate ``lr_sum`` apart.  The
      direction of its move is not held: such a gradient lies within the
      backward's fp32 rounding of zero (fault 2's measurement), so its
      sign, and with it the move's, is the rounding's, not the port's (on
      four H100s 367, 1,337 and 106 such entries of stablelm, seamless and
      minicpm3 moved the opposite ways by a few fp32 ulps).  They are
      counted (``opposite_moves``).  The optimizer replay and the
      gradients' agreement pin these entries: each run's parameters are
      AdamW of its own gradients.

    Returns ``(summary, failed)``: each class's entry count and largest
    gap, the opposite moves under ten eps, the failures' count and
    whether the leaf passes; and the mask of the failing entries."""
    import torch

    scale = max(float(want.abs().max()), 1e-30)
    clipped = [g.abs() * min(1.0, opt_cfg.clip_norm / max(n, 1e-30)) for g, n in zip(grads0, norms)]
    above = (clipped[0] >= ADAM_EPS_CLASS * opt_cfg.eps) & (clipped[1] >= ADAM_EPS_CLASS * opt_cfg.eps)
    gap = (got - want).abs()
    opposite = torch.sign(got - start) != torch.sign(want - start)
    failed = (above & (gap > PARAM_ATOL_REL * scale)) | (~above & (gap > lr_sum))
    out = {}
    for name, mask in (("above", above), ("below", ~above)):
        n = int(mask.sum())
        out[name] = {"entries": n, "max_gap": float(gap[mask].max()) if n else 0.0,
                     "max_gap_of_leaf_max": float(gap[mask].max()) / scale if n else 0.0}
    out["below"]["max_gap_of_lr_sum"] = out["below"]["max_gap"] / lr_sum
    out["below"]["opposite_moves"] = int((~above & opposite).sum())
    out["failed"] = int(failed.sum())
    out["ok"] = out["failed"] == 0
    return out, failed


def class_totals(classes: dict) -> dict:
    """:func:`classify_entries`' summaries over every leaf: each class's
    entries, its largest gap (the leaf it is in) and the failures."""
    out = {}
    for name in ("above", "below"):
        n = sum(c[name]["entries"] for c in classes.values())
        key = "max_gap_of_leaf_max" if name == "above" else "max_gap_of_lr_sum"
        worst = max(classes, key=lambda k: classes[k][name][key], default=None)
        out[name] = {"entries": n, key: classes[worst][name][key] if worst else 0.0,
                     "max_gap": classes[worst][name]["max_gap"] if worst else 0.0,
                     "worst_leaf": worst}
    out["below"]["opposite_moves"] = sum(c["below"]["opposite_moves"] for c in classes.values())
    out["failed"] = sum(c["failed"] for c in classes.values())
    return out


def count_real_step(bundle, params, opt, batch, device) -> dict:
    """One more step of the train bundle on this rank under
    ``launch/counting.py``'s counter (the batch placed before it, as a dry
    run places it): its FLOPs, bytes, collective bytes by kind and kernel
    launches, for the dry run's gate; its counted peak and, on a card, the
    memory it allocated above what was allocated before it (the dry run's
    peak is the same quantity)."""
    import torch

    from repro_torch.launch.counting import StepCounter

    sync(device)
    if device.type == "cuda":
        before = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    with StepCounter() as counter:
        bundle.step_fn(params, opt, batch)
    sync(device)
    fig = counter.figures()
    out = {k: fig[k] for k in ("flops", "bytes", "collectives", "kernels", "peak_bytes")}
    if device.type == "cuda":
        out["peak_above_args_bytes"] = torch.cuda.max_memory_allocated(device) - before
    return out


def dry_run(cfg, opt_cfg, batches, device) -> dict:
    """The same (2, 2) train cell dry-run on a fake process group of four
    ranks (``repro_torch.launch.dryrun.count_step``: fake tensors, nothing
    launched); call with no process group held."""
    import torch

    import chip_smoke as cs
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.dryrun import count_step, fake_process_group
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.sharding import PlanConfig

    B, S = batches[0]["tokens"].shape
    t0 = time.perf_counter()
    with fake_process_group(WORLD):
        mesh = make_debug_mesh(2, 2, device_type=device.type)
        fig = count_step(cfg, ShapeConfig("train", S + cs.front_tokens(cfg), B, "train"), mesh,
                         PlanConfig(tp=2, dp=2), opt_cfg=opt_cfg, param_dtype=torch.float32,
                         remat="none")
    fig["wall_s"] = time.perf_counter() - t0
    return fig


def _offenders(got, want, start, diff, bad, grads0, norms, opt_cfg, shown=8) -> dict:
    """Where a leaf misses its gate (``bad``, the failing entries' mask):
    how many entries, how far each
    run moved them from the start, and whether the moves agree in sign
    (AdamW's step is the gradient's sign where it is far above ``eps``, so
    a flip marks a gradient at the level of its own rounding); and, at the
    ``shown`` entries furthest apart, each run's first-step gradient
    (``grads0``: bundle's, make_step's) before and after the global-norm
    clip (``norms``: each run's first gradient norm), the clipped one in
    units of Adam's ``eps``, and each run's move."""
    import torch

    d_got, d_want = (got - start)[bad], (want - start)[bad]
    worst = torch.where(bad, diff, -1.0).flatten().topk(min(shown, int(bad.sum()))).indices
    entries = []
    for i in worst.tolist():
        at = []
        for g, norm in zip(grads0, norms):
            raw = float(g.flatten()[i])
            clipped = raw * min(1.0, opt_cfg.clip_norm / max(norm, 1e-30))
            at.append({"grad": raw, "clipped_in_eps": clipped / opt_cfg.eps})
        entries.append({"index": [int(j) for j in torch.unravel_index(torch.tensor(i), got.shape)],
                        "bundle": at[0] | {"move": float((got - start).flatten()[i])},
                        "make_step": at[1] | {"move": float((want - start).flatten()[i])},
                        "grad_leaf_max": float(grads0[1].abs().max())})
    return {"entries": int(bad.sum()), "of": got.numel(),
            "max_move_ref": float(d_want.abs().max()), "min_move_ref": float(d_want.abs().min()),
            "sign_flips": int((torch.sign(d_got) != torch.sign(d_want)).sum()),
            "rows": sorted({int(i) for i in bad.nonzero()[:, 0].tolist()})[:20],
            "worst": entries}


def save_row(single, sharded, partials) -> None:
    """The dumped vectors, by run, step and rank, in ``build/dump_row.npz``."""
    import numpy as np

    arrays = {}
    for s, (a, b) in enumerate(zip(single.steps, sharded)):
        for k in ("grad", "m", "v", "before", "after"):
            arrays[f"make_step/{s}/{k}"] = a[k].numpy()
            arrays[f"bundle/{s}/{k}"] = b[k].numpy()
        for coord, p in partials:
            arrays[f"bundle/{s}/partial/data{coord[0]}_model{coord[1]}"] = p[s].numpy()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    np.savez(os.path.join(ROOT, "build", "dump_row.npz"), **arrays)


def collectives(rank, cfg, device) -> dict:
    """``gqa_decode_seqsharded`` on a (4, 1) mesh and ``topk_allreduce``
    over the four ranks, each against its single-device result."""
    import types

    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.attention import gqa_decode, gqa_decode_seqsharded, gqa_defs
    from repro_torch.models.common import init_params
    from repro_torch.optim.compression import (
        TopKConfig, topk_allreduce, topk_compress, topk_decompress,
    )

    g = torch.Generator().manual_seed(22)
    layer = {k: v[0].to(device) for k, v in init_params(gqa_defs(cfg, 1), g).items()}
    p = types.SimpleNamespace(**layer)
    B, T, pos = 4, 512, 300
    shape = (B, T, cfg.n_kv_heads, cfg.head_dim)
    cache = {n: torch.randn(shape, generator=g).to(device) for n in "kv"}
    x = (0.3 * torch.randn((B, 1, cfg.d_model), generator=g)).to(device)
    mesh = make_debug_mesh(4, 1, device_type=device.type)
    group = mesh.get_group("data")
    r, Tl = dist.get_rank(group), T // 4
    local = {n: t[:, r * Tl:(r + 1) * Tl].clone() for n, t in cache.items()}
    with torch.no_grad():
        got, _ = gqa_decode_seqsharded(p, x, cfg, local, pos, group)
        want, _ = gqa_decode(p, x, cfg, {n: t.clone() for n, t in cache.items()}, pos)
    seq_err = float((got - want).abs().max()) / float(want.abs().max())

    grads = torch.randn((WORLD, cfg.d_model, cfg.d_ff), generator=g)
    tcfg = TopKConfig(density=0.01)
    mean, _ = topk_allreduce(grads[dist.get_rank()].to(device), torch.zeros_like(grads[0]).to(device),
                             tcfg)
    expect = sum(topk_decompress(topk_compress(grads[w], torch.zeros_like(grads[w]), tcfg)[0],
                                 grads[w].shape) for w in range(WORLD)) / WORLD
    topk_err = float((mean.to("cpu") - expect).abs().max()) / float(expect.abs().max())
    return dict(seqsharded_rel_err=seq_err, topk_rel_err=topk_err)


def run(rank: int, args, store_dir: str) -> None:
    import torch
    import torch.distributed as dist

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLMStream
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.sharding import PlanConfig
    from repro_torch.launch.train import TrainConfig, frontend_noise

    if args.device == "cuda":
        from repro_torch import resolve_device

        resolve_device("cuda")      # fp32 matmuls at full precision
        torch.cuda.set_device(rank)
        device = torch.device("cuda", rank)
        backend = "nccl"
    else:
        torch.set_num_threads(1)
        device = torch.device("cpu")
        backend = "gloo"
    store = dist.FileStore(os.path.join(store_dir, "store"), WORLD)
    dist.init_process_group(backend, store=store, rank=rank, world_size=WORLD,
                            timeout=datetime.timedelta(seconds=60))
    try:
        cfg = get_config(args.arch)
        if args.layers:
            cfg = dataclasses.replace(cfg, n_layers=args.layers,
                                      name=f"{cfg.name}/{args.layers}-layers")
        opt_cfg = TrainConfig().opt
        stream = SyntheticLMStream(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                              global_batch=args.batch, seed=0))
        batches = [{k: torch.as_tensor(v).long() for k, v in stream.batch_at(s).items()}
                   for s in range(args.steps)]
        if cfg.frontend is not None:
            for s, b in enumerate(batches):
                b["frontend"] = frontend_noise(cfg, args.batch, s, "cpu")
        ref = None
        if rank == 0:
            log(rank, f"make_step on one device ({device}): {cfg.name}, {args.steps} steps of "
                      f"{args.batch} x {args.seq}")
            dump = RowDump(args.dump_row) if args.dump_row is not None else None
            ref = single_card_reference(cfg, opt_cfg, batches, device, dump)
            ref["dump"] = dump
        dist.barrier()
        log(rank, "the (2, 2) train bundle on four ranks")
        dump = RowDump(args.dump_row) if args.dump_row is not None else None
        train = sharded_train(rank, cfg, opt_cfg, batches, device, ref, dump)
        serve = None
        if cfg.attention == "mla" or cfg.frontend is not None:
            log(rank, "the (2, 2) prefill and decode bundles on four ranks against the "
                      "unsharded forwards on each rank's card")
            serve = cs.sharded_serve(device, 0, make_debug_mesh(2, 2, device_type=device.type),
                                     cfg, "serve", PlanConfig(tp=2, dp=2))
        log(rank, "gqa_decode_seqsharded on a (4, 1) mesh and topk_allreduce over four ranks")
        coll = collectives(rank, cfg, device)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    if rank == 0:
        log(rank, "the same train cell dry-run on a fake group of four ranks")
        dry = dry_run(cfg, TrainConfig().opt, batches, device)
        check(args, cfg, ref, train, coll, serve, dry)


def check(args, cfg, ref, train, coll, serve, dry) -> None:
    """Prints the figures and every gate's verdict; raises once, after all
    of them are weighed (and every rank has left the process group), if
    any failed."""
    import chip_smoke as cs

    fig = {"arch": cfg.name, "device": args.device, "ranks": WORLD,
           "losses_bundle": train["losses"], "losses_make_step": ref["losses"],
           "step_ms_bundle": train["step_ms"], "step_ms_make_step": ref["step_ms"],
           "param_max_rel_err": train["param_max_rel_err"], "worst_leaf": train["worst_leaf"],
           "param_max_err_of_lr_sum": train["param_max_err_of_lr_sum"],
           "grad0_max_rel_err": train["grad0_max_rel_err"],
           "grad0_worst_leaf": train["grad0_worst_leaf"],
           "leaf_errs": train["leaf_errs"], "offenders": train["offenders"], "lr": ref["lrs"],
           "per_rank": train["per_rank"], "placements": train["placements"],
           "row_dump": train["row_dump"], "serve": serve, **coll,
           "replay_max_rel_err": train["replay_max_rel_err"],
           "replay_worst_leaf": train["replay_worst_leaf"], "param_classes": train["classes"],
           "dry_run": {k: dry[k] for k in ("flops", "bytes", "collectives", "kernels",
                                           "peak_bytes", "argument_bytes", "wall_s")}}
    if args.device == "cuda":
        fig["card"] = cs.card_line()
        print(f"card (each of the {WORLD}): {fig['card']}", flush=True)
    for r, rank_fig in enumerate(train["per_rank"]):
        real = rank_fig["counted"]
        above = real.get("peak_above_args_bytes")
        print(f"rank {r}: max_memory_allocated {rank_fig['peak_bytes'] / 2**30:.3f} GiB over the "
              f"run (parameters, optimizer state and two steps); the counted step's "
              f"temporaries {real['peak_bytes'] / 2**30:.3f} GiB counted"
              + (f", {above / 2**30:.3f} GiB allocated above its arguments" if above is not None
                 else "")
              + f"; the dry run's peak {dry['peak_bytes'] / 2**30:.3f} GiB", flush=True)
    failed = {}
    if any(abs(a - b) > LOSS_RTOL * abs(b) for a, b in zip(train["losses"], ref["losses"])):
        failed["losses"] = f"{train['losses']} vs make_step's {ref['losses']}"
    if train["replay_max_rel_err"] > REPLAY_ATOL_REL:
        failed["optimizer step"] = (
            f"the sharded update of {train['replay_worst_leaf']} differs from adamw_update on "
            f"its own inputs by {train['replay_max_rel_err']:.3e} of its largest entry")
    if train["offenders"]:
        failed["parameters"] = (
            f"outside their class's gate (>= {ADAM_EPS_CLASS} eps: {PARAM_ATOL_REL:g} of the "
            f"leaf's largest entry; below: the same move, within the summed lr): "
            f"{train['offenders']}")
    for r, rank_fig in enumerate(train["per_rank"]):
        real = rank_fig["counted"]
        if (abs(real["flops"] - dry["flops"]) > 1e-9 * dry["flops"]
                or set(real["collectives"]) != set(dry["collectives"])
                or any(abs(real["collectives"][k] - v) > 1e-9 * v
                       for k, v in dry["collectives"].items())):
            failed.setdefault("dry run", []).append(
                f"rank {r}'s counted step {real['flops']} flops, collectives "
                f"{real['collectives']}; the dry run's {dry['flops']}, {dry['collectives']}")
    if args.device == "cuda":
        want = cs.training_launches(cfg, args.steps)
        for r, rank_fig in enumerate(train["per_rank"]):
            if rank_fig["launches"] != want:
                failed.setdefault("launches", []).append(
                    f"rank {r} launched {rank_fig['launches']}, expected {want}")
    if coll["seqsharded_rel_err"] > SEQ_TOL or coll["topk_rel_err"] > TOPK_RTOL:
        failed["collectives"] = str(coll)
    gates = ["losses", "optimizer step", "parameters", "dry run", "collectives"]
    fig["gates"] = {g: "missed" if g in failed else "met"
                    for g in gates + (["launches"] if args.device == "cuda" else [])}
    print(json.dumps(fig), flush=True)
    if failed:
        raise AssertionError("; ".join(f"{g}: {why}" for g, why in failed.items()))
    print("ok", flush=True)


def main() -> None:
    import torch.multiprocessing as mp

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--layers", type=int, default=0, help="cut to the first N layers")
    ap.add_argument("--dump-row", type=int, default=None, help="follow this embedding row")
    args = ap.parse_args()
    if args.device == "cuda":
        import torch

        if torch.cuda.device_count() < WORLD:
            raise SystemExit(f"needs {WORLD} CUDA cards, found {torch.cuda.device_count()}")
        from repro_torch.kernels.flash_attention import ops as flash_ops
        from repro_torch.kernels.rmsnorm import ops as rmsnorm_ops

        import chip_smoke as cs

        cs.build_all([rmsnorm_ops.LIBRARY, rmsnorm_ops.BACKWARD_LIBRARY, flash_ops.LIBRARY,
                      flash_ops.BACKWARD_LIBRARY])
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(run, args=(args, tmp), nprocs=WORLD, join=True)


if __name__ == "__main__":
    main()
