"""Roofline analysis over the dry run (the reference's ``launch/roofline.py``).

The reference calibrates because XLA's ``cost_analysis`` counts a
``while``-loop body (its scan over layers) once: it lowers each cell at
1-period and 2-period depth and extrapolates::

    F_total = F(1) + (n_periods - 1) * (F(2) - F(1))

The port's dry run (:mod:`.dryrun`) counts every op it runs, so its counts
are exact at any depth: ``main`` takes the reports' counts as they are.
The extrapolation is kept, with the reference's formula
(:func:`~.dryrun.extrapolate`, the dry run's own for its token-loop
cells), as ``main --calibrate`` and ``analyze_cell(calibrate=True)``: the
quicker way to a deep cell's totals (1 and 2 periods run in the time of
3), held by a test to a full-depth count.

Hardware constants: one H100 SXM (NVIDIA's data sheet, the port's
``core/lm_bridge.py``): 989 TFLOP/s dense BF16, 3.35 TB/s HBM3, 450 GB/s
NVLink a direction (in the ICI's place), 80 GB of HBM (``fits_hbm``).  The
reference's TPU figures (197e12, 819e9, 50e9, 16 GiB) do not apply to the
port.

Terms (seconds, per step, whole machine):
  compute    = F_total / (chips * 989e12)
  memory     = B_total / (chips * 3.35e12)
  collective = C_total / (chips * 450e9)

``B_total`` is the dry run's unfused bytes (every op's inputs and outputs),
an upper bound beside XLA's fused count, so the memory term is one too.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os

from ..core.lm_bridge import HBM_BW, ICI_BW, PEAK_FLOPS

#: Device memory of one H100 SXM, bytes (the data sheet's 80 GB).
HBM_BYTES = 80e9

__all__ = ["HBM_BW", "HBM_BYTES", "ICI_BW", "PEAK_FLOPS", "RooflineRow", "analyze_cell",
           "calibrated_totals", "main"]


@dataclasses.dataclass
class RooflineRow:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_total: float
    bytes_total: float
    coll_bytes_total: float
    t_compute: float
    t_memory: float
    t_collective: float
    bottleneck: str
    model_flops: float
    useful_ratio: float           # MODEL_FLOPS / HLO_FLOPS
    peak_temp_gib: float
    args_gib: float
    fits_hbm: bool
    collectives: dict
    notes: str = ""

    def headline(self) -> str:
        return (
            f"{self.arch:26s} {self.shape:12s} {self.mesh:8s} "
            f"comp {self.t_compute*1e3:9.2f}ms  mem {self.t_memory*1e3:9.2f}ms  "
            f"coll {self.t_collective*1e3:9.2f}ms  -> {self.bottleneck:10s} "
            f"useful {self.useful_ratio:5.2f}  temp {self.peak_temp_gib:7.1f}GiB "
            f"{'FITS' if self.fits_hbm else 'OVER'}"
        )


def _measure_depth(arch: str, shape_name: str, multi_pod: bool, n_periods: int,
                   plan_overrides: dict | None = None, device_type: str = "cuda"):
    """The dry run's per-device counts of the cell with the layer stack cut
    to ``n_periods``, on the production mesh of the caller's fake process
    group (:func:`~.dryrun.fake_process_group`)."""
    from ..configs import SHAPES, get_config
    from .dryrun import _plan_and_kw, count_cell
    from .mesh import make_production_mesh

    cfg = get_config(arch)
    cfg_small = dataclasses.replace(cfg, n_layers=len(cfg.pattern()) * n_periods)
    shape = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod, device_type=device_type)
    plan, kw = _plan_and_kw(cfg, shape, multi_pod, plan_overrides)
    fig = count_cell(cfg_small, shape, mesh, plan, **kw)[0]
    return {"flops": float(fig["flops"]), "bytes": float(fig["bytes"]),
            "coll": dict(fig["collectives"])}


def calibrated_totals(arch: str, shape_name: str, multi_pod: bool,
                      plan_overrides: dict | None = None, device_type: str = "cuda") -> dict:
    """Extrapolate per-device flops/bytes/collectives to full depth from the
    1- and 2-period counts (:func:`~.dryrun.extrapolate`)."""
    from ..configs import get_config
    from .dryrun import extrapolate

    nper = get_config(arch).n_periods()
    one = _measure_depth(arch, shape_name, multi_pod, 1, plan_overrides, device_type)
    if nper == 1:
        return one
    two = _measure_depth(arch, shape_name, multi_pod, 2, plan_overrides, device_type)
    return extrapolate([one, two], (1, 2), nper)


def mesh_chips(mesh: str) -> int:
    """The cards of a mesh named like ``"16x16"`` or ``"2x16x16"``."""
    return math.prod(int(n) for n in mesh.split("x"))


def analyze_cell(report: dict, calibrate: bool = True,
                 plan_overrides: dict | None = None, shape=None,
                 device_type: str = "cuda") -> RooflineRow:
    """Build the roofline row from a dry-run JSON report (+ calibration).
    ``shape`` (a ``ShapeConfig``) stands for a report whose shape is not one
    of ``SHAPES`` (a cell of the caller's own); it cannot be calibrated."""
    from ..configs import SHAPES, get_config

    arch, shape_name, mesh = report["arch"], report["shape"], report["mesh"]
    chips = mesh_chips(mesh)
    cfg = get_config(arch)
    shape = shape or SHAPES[shape_name]

    if calibrate:
        totals = calibrated_totals(arch, shape_name, mesh == "2x16x16",
                                   plan_overrides, device_type)
    else:
        totals = {"flops": report["flops"], "bytes": report["hlo_bytes"],
                  "coll": report["collectives"]}

    # the dry run's numbers are per-device; scale to the whole machine
    flops_total = totals["flops"] * chips
    bytes_total = totals["bytes"] * chips
    coll_total = sum(totals["coll"].values()) * chips

    t_compute = flops_total / (chips * PEAK_FLOPS)
    t_memory = bytes_total / (chips * HBM_BW)
    t_coll = coll_total / (chips * ICI_BW)
    terms = {"compute": t_compute, "memory": t_memory, "collective": t_coll}
    bottleneck = max(terms, key=terms.get)

    total, active = cfg.param_count()
    n = active if cfg.is_moe else total
    if shape.kind == "train":
        tokens = shape.tokens
        model_flops = 6.0 * n * tokens
    elif shape.kind == "prefill":
        tokens = shape.tokens
        model_flops = 2.0 * n * tokens
    else:  # decode: one token per sequence
        tokens = shape.global_batch
        model_flops = 2.0 * n * tokens

    return RooflineRow(
        arch=arch,
        shape=shape_name,
        mesh=mesh,
        chips=chips,
        flops_total=flops_total,
        bytes_total=bytes_total,
        coll_bytes_total=coll_total,
        t_compute=t_compute,
        t_memory=t_memory,
        t_collective=t_coll,
        bottleneck=bottleneck,
        model_flops=model_flops,
        useful_ratio=model_flops / max(flops_total, 1.0),
        peak_temp_gib=report["peak_bytes_per_device"] / 2**30,
        args_gib=report["argument_bytes"] / 2**30,
        fits_hbm=(report["peak_bytes_per_device"] + report["argument_bytes"]) < HBM_BYTES,
        collectives={k: v * chips for k, v in totals["coll"].items()},
        notes=report.get("notes", ""),
    )


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dryrun-dir", default="results/dryrun_torch")
    ap.add_argument("--out", default="results/roofline_torch.json")
    ap.add_argument("--calibrate", action="store_true",
                    help="recount each cell at 1 and 2 periods and extrapolate, in place of "
                         "the reports' full-depth counts (which are exact)")
    ap.add_argument("--device-type", choices=["cuda", "cpu"], default="cuda",
                    help="the calibration's fake tensors' device type")
    args = ap.parse_args()

    reports = []
    for fname in sorted(os.listdir(args.dryrun_dir)):
        if not fname.endswith(".json"):
            continue
        with open(os.path.join(args.dryrun_dir, fname)) as f:
            rep = json.load(f)
        if not rep.get("ok"):
            continue
        if rep.get("mesh") != "16x16":
            continue  # the roofline table is single-pod (the multi-pod pass
                      # proves the 'pod' axis shards)
        reports.append(rep)

    with contextlib.ExitStack() as stack:
        if args.calibrate:
            from .dryrun import fake_process_group

            stack.enter_context(fake_process_group(256))
        rows = []
        for rep in reports:
            rows.append(analyze_cell(rep, calibrate=args.calibrate, device_type=args.device_type))
            print(rows[-1].headline())

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump([dataclasses.asdict(r) for r in rows], f, indent=2)
    print(f"wrote {len(rows)} rows to {args.out}")


if __name__ == "__main__":
    main()
