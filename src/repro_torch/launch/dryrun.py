"""Multi-pod dry run: build and run every (architecture × input shape) cell
on the production meshes without a card, and write its FLOPs, bytes,
memory and collective bytes per device (the reference's
``launch/dryrun.py``).

This is the proof that the distribution plan is coherent without the
cards: a sharding mismatch, an op DTensor cannot shard or a collective it
cannot make fails here.  The reference lowers and compiles each cell for
512 forced host devices and reads XLA's analyses; the port has no compiler
to ask, so each cell is run, eagerly, on data that does not exist:

- a fake process group (``torch.testing._internal.distributed.fake_pg``)
  of 256 or 512 ranks, this process rank 0, carries the production mesh
  (:func:`~.mesh.make_production_mesh`); its collectives do nothing;
- the bundle's meta arguments become ``FakeTensor``\\ s under
  ``FakeTensorMode``, placed as the step's plan places them (parameters,
  optimizer state, batch, caches), so nothing is allocated;
- ``step_fn`` runs once under :class:`~.counting.StepCounter`, which counts
  this rank's local ops, the hand-written kernels' own FLOPs and bytes (the
  wrappers' stand-ins on fake inputs launch nothing) and the collectives'
  output bytes.

The batch is placed before the counted call, as the reference's compiled
step takes its inputs already sharded, so the count holds no scatter or
broadcast of the batch.  A decode cell runs at position ``seq_len - 1``.
Figures (per device, as the reference's):

- ``flops``, ``hlo_bytes``, ``collectives``, ``peak_bytes_per_device``:
  :mod:`.counting`'s (``hlo_bytes`` every op's inputs and outputs,
  unfused: an upper bound beside XLA's ``bytes accessed``;
  ``peak_bytes_per_device`` the step's temporaries above its arguments,
  as XLA's ``temp_size_in_bytes``);
- ``argument_bytes``, ``output_bytes``: the local shards of the step's
  arguments and of its outputs (a train step's updated parameters and
  optimizer state are its arguments, updated in place);
- ``compile_seconds``: the wall time of building and running the cell.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod both \\
        --out results/dryrun_torch

``--device-type cpu`` makes the fake tensors CPU tensors, for a host
without CUDA (the tests); the default, ``cuda``, needs a CUDA build of
torch but no free card.  :mod:`.roofline` reads the JSON this writes.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import os
import time
import traceback
from fractions import Fraction

import torch

from ..configs import SHAPES, cell_is_supported, get_config
from ..configs.base import ModelConfig, ShapeConfig
from . import sharding as shlib
from .counting import COLLECTIVE_KINDS, StepCounter
from .mesh import make_production_mesh
from .steps import make_bundle

__all__ = ["COLLECTIVE_KINDS", "CellReport", "count_cell", "count_step", "extrapolate",
           "fake_process_group", "main", "run_cell"]


@dataclasses.dataclass
class CellReport:
    arch: str
    shape: str
    mesh: str
    ok: bool
    error: str = ""
    compile_seconds: float = 0.0
    flops: float = 0.0
    hlo_bytes: float = 0.0
    peak_bytes_per_device: float = 0.0
    argument_bytes: float = 0.0
    output_bytes: float = 0.0
    collectives: dict = dataclasses.field(default_factory=dict)
    n_params: int = 0
    notes: str = ""

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


@contextlib.contextmanager
def fake_process_group(world_size: int):
    """A fake default process group of ``world_size`` ranks with this process
    as rank 0, destroyed on leaving: a mesh of that size builds on it and
    its collectives do nothing.  One process holds one default group at a
    time."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _local_bytes(tree) -> int:
    """Bytes of the distinct local storages in ``tree`` (a DTensor counts its
    local shard)."""
    from torch.distributed.tensor import DTensor
    from torch.utils._pytree import tree_leaves

    seen, total = set(), 0
    for t in tree_leaves(tree):
        if not isinstance(t, torch.Tensor):
            continue
        local = t.to_local() if isinstance(t, DTensor) else t
        st = local.untyped_storage()
        if id(st) not in seen:
            seen.add(id(st))
            total += st.nbytes()
    return total


def _placed(full: torch.Tensor, spec, mesh):
    """``full`` as a DTensor placed by ``spec`` on ``mesh``: each rank's shard
    cut from its own ``full`` (every rank holds the same), no collective."""
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(full, mesh, shlib.placements(spec, mesh), src_data_rank=None)


def _map2(fn, tree: dict, specs: dict) -> dict:
    return {k: _map2(fn, v, specs[k]) if isinstance(v, dict) else fn(v, specs[k])
            for k, v in tree.items()}


def placed_args(bundle, full=None) -> tuple:
    """The step's arguments placed as the plan places them: parameters (with
    gradients on in a train step), the optimizer state sharded as its
    parameters, the batch, a decode step's caches and its position
    (``seq_len - 1``).  ``full(meta)`` makes each leaf's whole tensor from
    its meta stand-in (by default an empty one on the mesh's device type:
    fake under ``FakeTensorMode``)."""
    mesh, pspecs = bundle.mesh, bundle.param_specs
    if full is None:
        def full(t):
            return torch.empty(t.shape, dtype=t.dtype, device=mesh.device_type)

    def place(t, spec):
        return _placed(full(t), spec, mesh)

    params = {n: place(t, pspecs[n]) for n, t in bundle.args[0].items()}
    if bundle.kind == "train":
        for p in params.values():
            p.requires_grad_(True)
        opt_abs, batch_abs = bundle.args[1], bundle.args[2]
        opt = {"step": place(opt_abs["step"], shlib.P())}
        for k in ("m", "v", "master"):
            if k in opt_abs:
                opt[k] = {n: place(t, pspecs[n]) for n, t in opt_abs[k].items()}
        bspecs = shlib.batch_specs(batch_abs, bundle.rules)
        return params, opt, {k: place(v, bspecs[k]) for k, v in batch_abs.items()}
    if bundle.kind == "prefill":
        bspecs = shlib.batch_specs(bundle.args[1], bundle.rules)
        return params, {k: place(v, bspecs[k]) for k, v in bundle.args[1].items()}
    _, cache_abs, token_abs, _ = bundle.args
    crules = shlib.cache_rules(bundle.cfg, bundle.shape, bundle.plan)
    cspecs = shlib.cache_specs(cache_abs, bundle.cfg, bundle.rules, crules)
    tspec = shlib.batch_specs({"token": token_abs}, bundle.rules)["token"]
    return (params, _map2(place, cache_abs, cspecs), place(token_abs, tspec),
            bundle.shape.seq_len - 1)


def count_step(cfg: ModelConfig, shape: ShapeConfig, mesh, plan: shlib.PlanConfig,
               **bundle_kw) -> dict:
    """Builds the cell's bundle on ``mesh`` (whose process group the caller
    holds), runs its step once on fake arguments and returns the counts:
    ``flops``, ``bytes``, ``collectives``, ``peak_bytes``, ``kernels``
    (:meth:`~.counting.StepCounter.figures`), ``argument_bytes``,
    ``output_bytes``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode(allow_non_fake_inputs=True):
        bundle = make_bundle(cfg, shape, mesh, plan, device_type=mesh.device_type, **bundle_kw)
        args = placed_args(bundle)
        with StepCounter() as counter:
            outputs = bundle.step_fn(*args)
        fig = counter.figures()
        fig["argument_bytes"] = _local_bytes(args)
        fig["output_bytes"] = _local_bytes(outputs)
    return fig


def extrapolate(counts: list, xs: tuple, x: int):
    """The counts taken at the two points ``xs`` carried to ``x`` on the
    line through them, number by number (nested dicts key by key, a key
    missing at a point taken as 0), in exact rational arithmetic, so an
    integer count that is affine in ``x`` comes out exact.  The one depth
    extrapolation of the dry run (:func:`count_cell`) and the roofline
    (:func:`~.roofline.calibrated_totals`)."""
    a, b = counts
    if isinstance(a, dict) or isinstance(b, dict):
        a, b = a or {}, b or {}
        return {k: extrapolate([a.get(k, 0), b.get(k, 0)], xs, x) for k in {**a, **b}}
    (xa, xb), (fa, fb) = xs, (Fraction(a), Fraction(b))
    return float(fa + (fb - fa) * Fraction(x - xa, xb - xa))


def count_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, plan: shlib.PlanConfig,
               **bundle_kw) -> tuple[dict, str]:
    """:func:`count_step`'s counts of the cell and a note on how they were
    taken.  A train or prefill cell of a model with an sLSTM block runs
    its recurrence token by token (about 20 ops a token a layer: some
    900,000 fake ops a period at 4,096 tokens), so it is counted at 1 and
    2 periods and carried to its periods on a line (:func:`extrapolate`).
    Every count is affine in the periods: each adds the same ops, as
    DTensor lays each op out by its shapes, which a period does not
    change.  (Not so in the tokens: counted at shorter sequences, the
    layouts DTensor picks change with the tensors' sizes.)  The totals are
    the full cell's; the peak is carried the same way, an estimate."""
    nper = cfg.n_periods()
    if "slstm" not in cfg.pattern() or shape.kind == "decode" or nper < 3:
        return count_step(cfg, shape, mesh, plan, **bundle_kw), ""
    figs = [count_step(dataclasses.replace(cfg, n_layers=len(cfg.pattern()) * p), shape, mesh,
                       plan, **bundle_kw) for p in (1, 2)]
    return extrapolate(figs, (1, 2), nper), (f"sLSTM token loop: counted at 1 and 2 periods and "
                                          f"carried to {nper}; peak estimated")


def _plan_and_kw(cfg: ModelConfig, shape: ShapeConfig, multi_pod: bool,
                 plan_overrides: dict | None) -> tuple[shlib.PlanConfig, dict]:
    """The reference's plan for a production cell: ZeRO over the pods and
    bf16 moments without fp32 masters for the 398B class."""
    huge = cfg.param_count()[0] > 100e9
    plan = shlib.PlanConfig(multi_pod=multi_pod, fsdp_over_pod=huge, **(plan_overrides or {}))
    kw = {}
    if shape.kind == "train" and huge:
        from ..optim.optimizer import AdamWConfig

        kw["opt_cfg"] = AdamWConfig(use_master=False, moments_dtype="bfloat16")
    return plan, kw


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             plan_overrides: dict | None = None, verbose: bool = True,
             device_type: str = "cuda") -> CellReport:
    """One cell on the production mesh (16x16, or 2x16x16 with
    ``multi_pod``) over the caller's fake process group of 256 or 512 ranks
    (:func:`fake_process_group`); a failure is reported, not raised."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    mesh_name = "2x16x16" if multi_pod else "16x16"
    rep = CellReport(arch=arch, shape=shape_name, mesh=mesh_name, ok=False)

    supported, why = cell_is_supported(cfg, shape)
    if not supported:
        rep.error = f"skipped: {why}"
        rep.notes = "skip"
        return rep

    try:
        t0 = time.perf_counter()
        mesh = make_production_mesh(multi_pod=multi_pod, device_type=device_type)
        plan, kw = _plan_and_kw(cfg, shape, multi_pod, plan_overrides)
        fig, note = count_cell(cfg, shape, mesh, plan, **kw)
        rep.compile_seconds = time.perf_counter() - t0
        rep.flops = float(fig["flops"])
        rep.hlo_bytes = float(fig["bytes"])
        rep.peak_bytes_per_device = float(fig["peak_bytes"])
        rep.argument_bytes = float(fig["argument_bytes"])
        rep.output_bytes = float(fig["output_bytes"])
        rep.collectives = fig["collectives"]
        rep.n_params = cfg.param_count()[0]
        launches = {k: round(v["launches"]) for k, v in fig["kernels"].items()}
        rep.notes = "; ".join(n for n in (
            f"eager count on a fake process group ({device_type} fake tensors)", note,
            f"kernel launches {json.dumps(launches)}") if n)
        rep.ok = True
        if verbose:
            print(
                f"[OK] {arch} × {shape_name} × {mesh_name}: "
                f"dry run {rep.compile_seconds:.1f}s  "
                f"GFLOPs {rep.flops/1e9:.1f}  "
                f"temp/device {rep.peak_bytes_per_device/2**30:.2f} GiB  "
                f"args/device {rep.argument_bytes/2**30:.2f} GiB  "
                f"coll {sum(rep.collectives.values())/2**30:.2f} GiB",
                flush=True,
            )
    except Exception as e:  # noqa: BLE001 — report every failure kind
        rep.error = f"{type(e).__name__}: {e}"
        if verbose:
            print(f"[FAIL] {arch} × {shape_name} × {mesh_name}: {rep.error}", flush=True)
            traceback.print_exc()
    finally:
        gc.collect()
    return rep


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", choices=["off", "on", "both"], default="off")
    ap.add_argument("--out", default=None, help="write JSON reports to this dir")
    ap.add_argument("--device-type", choices=["cuda", "cpu"], default="cuda",
                    help="the fake tensors' device type (cpu: a host without CUDA)")
    args = ap.parse_args()

    from ..configs import list_archs

    archs = list_archs() if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    pods = {"off": [False], "on": [True], "both": [False, True]}[args.multi_pod]

    reports = []
    for mp in pods:
        with fake_process_group(512 if mp else 256):
            for arch in archs:
                for shape in shapes:
                    reports.append(run_cell(arch, shape, mp, device_type=args.device_type))

    n_ok = sum(r.ok for r in reports)
    n_skip = sum(r.notes == "skip" for r in reports)
    n_fail = len(reports) - n_ok - n_skip
    print(f"\n=== dry-run summary: {n_ok} ok, {n_skip} skipped (documented), {n_fail} FAILED ===")
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        for r in reports:
            path = os.path.join(args.out, f"{r.arch}__{r.shape}__{r.mesh}.json")
            with open(path, "w") as f:
                json.dump(r.to_json(), f, indent=2)
        print(f"wrote {len(reports)} reports to {args.out}")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
