"""What holds a dry-run cell's peak: one production cell counted as
``launch/dryrun.py`` counts it, with a record of the storages live at the
step's peak, grouped by the op that made them, shape, dtype and device
(the model frame that made each group, for storages of 64 MiB or more),
and what the counter leaves out as DTensor's sharding-propagation scratch
(``launch/counting.py``): the bytes of storage it made, by the path that
made it, and the step's peak and unfused bytes as the counter before the
repair of fault 14 counted them (the decompositions' scratch with the
step's; the tensor-meta probe's was left out then too).

    PYTHONPATH=src python tools/dryrun_peak_probe.py --arch jamba-1.5-large-398b \\
        --shape train_4k [--multi-pod] [--device-type cpu] [--top 12]

Needs no card (``--device-type cuda``, the default, needs a CUDA build of
torch).  Prints the torch version, the breakdown, then one JSON line.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src")]

BIG = 64 << 20          # storages this large carry the model frame that made them


def _frame() -> str:
    """The innermost frame in the port's models, launch or optim code."""
    for f in reversed(traceback.extract_stack()):
        if "repro_torch" in f.filename and "counting.py" not in f.filename:
            return f"{f.filename.split('repro_torch/')[-1]}:{f.lineno} {f.name}"
    return ""


def probe_counter():
    """A :class:`~repro_torch.launch.counting.StepCounter` that keeps what
    each counted storage is and snapshots the live set within 1% of the
    step's peak; and, apart, the scratch it leaves out: what DTensor's
    tensor-meta probe makes (left out before fault 14's repair too), the
    rest of its propagation (the decompositions' meta tensors, the fake
    mesh) and any op on meta tensors outside propagation, whose storages
    and bytes the counter before that repair counted with the step's
    (``parent_peak_bytes``, ``parent_bytes``)."""
    import weakref

    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    from repro_torch.launch import counting

    class Probe(counting.StepCounter):
        def __init__(self):
            super().__init__()
            self.info: dict[int, tuple] = {}
            self.snapshot: list = []
            self._snap_bytes = 0
            self._op = ""
            self._in_meta_probe = 0
            self.scratch = {"tensor-meta probe": 0, "other propagation": 0,
                            "meta, outside propagation": 0}
            self.parent_bytes = 0.0
            self._parent_live = 0
            self.parent_peak_bytes = 0
            self._parent: dict[int, weakref.ref] = {}

        def __enter__(self):
            out = super().__enter__()
            hidden = vars(ShardingPropagator)["_propagate_tensor_meta_non_cached"]
            self._hidden_probe = hidden

            def flagged(prop, schema):
                self._in_meta_probe += 1
                try:
                    return hidden.__get__(prop)(schema)
                finally:
                    self._in_meta_probe -= 1

            ShardingPropagator._propagate_tensor_meta_non_cached = flagged
            return out

        def __exit__(self, *exc):
            ShardingPropagator._propagate_tensor_meta_non_cached = self._hidden_probe
            return super().__exit__(*exc)

        def _as_parent(self, outs) -> None:
            """The ledger of the counter before fault 14's repair."""
            for t in outs:
                st = t.untyped_storage()
                key = id(st)
                if key in self._parent and self._parent[key]() is st:
                    continue
                n = st.nbytes()

                def gone(ref, key=key, n=n):
                    self._parent_live -= n
                    if self._parent.get(key) is ref:
                        del self._parent[key]

                self._parent[key] = weakref.ref(st, gone)
                self._parent_live += n
                self.parent_peak_bytes = max(self.parent_peak_bytes, self._parent_live)

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self._op = func._opname
            out = super().__torch_dispatch__(func, types, args, kwargs)
            if out is NotImplemented or func.namespace == "prim":
                return out
            outs = counting._tensors(out)
            fresh = self._makes_storage(func)
            scratch = bool(counting._HIDDEN[0]) or any(
                t.device.type == "meta" for t in outs or counting._tensors((args, kwargs)))
            # (the counter counts an op on meta tensors outside propagation;
            # none should come, and the tally says whether one did)
            if not scratch:
                if fresh:
                    self._as_parent(outs)
                return out
            kind = ("tensor-meta probe" if self._in_meta_probe else
                    "other propagation" if counting._HIDDEN[0] else "meta, outside propagation")
            if fresh:
                self.scratch[kind] += sum(t.untyped_storage().nbytes() for t in outs)
            if kind != "tensor-meta probe":
                if fresh:
                    self._as_parent(outs)
                if not (func.is_view or "empty" in func._opname):
                    self.parent_bytes += sum(counting._nbytes(t) for t in outs) + sum(
                        counting._nbytes(t) for t in counting._tensors((args, kwargs)))
            return out

        def _track(self, outs: list) -> None:
            for t in outs:
                st = t.untyped_storage()
                n = st.nbytes()
                self.info[id(st)] = (self._op, tuple(t.shape), str(t.dtype).replace("torch.", ""),
                                     t.device.type, _frame() if n >= BIG else "", n)
            super()._track(outs)
            if self.live_bytes > 1.01 * self._snap_bytes:
                self._snap_bytes = self.live_bytes
                self.snapshot = [self.info[k] for k, ref in self._storages.items()
                                 if ref() is not None and k in self.info]

    return Probe()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--device-type", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args()

    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.steps import make_bundle

    print(f"torch {torch.__version__}", flush=True)
    cfg, shape = get_config(args.arch), SHAPES[args.shape]
    t0 = time.perf_counter()
    with dryrun.fake_process_group(512 if args.multi_pod else 256):
        mesh = make_production_mesh(multi_pod=args.multi_pod, device_type=args.device_type)
        plan, kw = dryrun._plan_and_kw(cfg, shape, args.multi_pod, None)
        with FakeTensorMode(allow_non_fake_inputs=True):
            bundle = make_bundle(cfg, shape, mesh, plan, device_type=mesh.device_type, **kw)
            placed = dryrun.placed_args(bundle)
            counter = probe_counter()
            with counter:
                bundle.step_fn(*placed)
    groups: dict = collections.defaultdict(lambda: [0, 0, ""])
    for op, shp, dtype, dev, frame, n in counter.snapshot:
        g = groups[(op, shp, dtype, dev)]
        g[0] += 1
        g[1] += n
        g[2] = g[2] or frame
    top = sorted(groups.items(), key=lambda kv: -kv[1][1])[:args.top]
    gib = 2 ** 30
    print(f"{args.arch} x {args.shape} x {'2x16x16' if args.multi_pod else '16x16'}: peak "
          f"{counter.peak_bytes / gib:.2f} GiB ({counter.peak_bytes} bytes), "
          f"{counter.bytes / 1e12:.4f} TB unfused, {counter.flops / 1e12:.2f} TFLOP; "
          f"propagation scratch left out, GiB made: "
          + ", ".join(f"{k} {v / gib:.2f}" for k, v in counter.scratch.items())
          + f"; as the counter before fault 14's repair counted: peak "
          f"{counter.parent_peak_bytes / gib:.2f} GiB, "
          f"{(counter.bytes + counter.parent_bytes) / 1e12:.4f} TB unfused; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for (op, shp, dtype, dev), (count, n, frame) in top:
        print(f"  {n / gib:9.3f} GiB  {count:4d} x {op} {list(shp)} {dtype} {dev}  {frame}")
    print(json.dumps({"arch": args.arch, "shape": args.shape, "multi_pod": args.multi_pod,
                      "torch": torch.__version__, "peak_bytes": counter.peak_bytes,
                      "bytes": counter.bytes, "flops": counter.flops,
                      "collectives": counter.collectives,
                      "scratch_bytes": counter.scratch,
                      "parent_peak_bytes": counter.parent_peak_bytes,
                      "parent_bytes": counter.bytes + counter.parent_bytes,
                      "top": [[op, list(shp), dtype, dev, count, n, frame]
                              for (op, shp, dtype, dev), (count, n, frame) in top]}))


if __name__ == "__main__":
    main()
