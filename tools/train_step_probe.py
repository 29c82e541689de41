"""One training step of a whole model on the card, profiled, for each of
several source trees in turn: by default xlstm-1.3b with phase 20 (b)'s
batch (4 x 256 tokens, AdamW, fp32), ``--steps`` steps of which the last
runs under the profiler (device events only).  Each tree runs in a
subprocess of its own, importing ``repro_torch`` from ``TREE/src`` and
building its kernels under ``TREE/build``; a tree named twice runs twice,
so ``--tree parent --tree . --tree . --tree parent`` compares two versions
in turns on one card.  Prints for each run the step walls, the profiled
step's wall, the device's busy time in it and its largest kernels by
device time, ``torch.cuda.max_memory_allocated`` over the run, the card,
and one JSON line.

Needs a CUDA card (about 40 s a run for xlstm-1.3b, its build included).

Run from the repository root:
    python3 tools/train_step_probe.py [--arch xlstm-1.3b] [--tree DIR ...]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def child(tree: str, arch: str, steps: int, batch: int, seq: int) -> dict:
    """The run in ``tree``: ``steps`` steps from seed-0 weights, the last
    one profiled."""
    sys.path.insert(0, os.path.join(tree, "src"))
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import resolve_device
    from repro_torch.data import DataConfig, SyntheticLMStream
    from repro_torch.launch.train import TrainConfig, build_state, make_step

    device = resolve_device(None)
    tc = TrainConfig(arch=arch, seq_len=seq, global_batch=batch, seed=0)
    cfg, model, params, opt_state = build_state(tc, device)
    step_fn = make_step(model, tc.opt)
    stream = SyntheticLMStream(DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch,
                                          seed=0))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls, losses = [], []
    prof = profile(activities=[ProfilerActivity.CUDA])
    for step in range(steps):
        b = {k: torch.as_tensor(v, device=device).long()
             for k, v in stream.batch_at(step).items()}
        torch.cuda.synchronize()
        last = step == steps - 1
        if last:
            prof.__enter__()
        t0 = time.perf_counter()
        params, opt_state, m = step_fn(params, opt_state, b)
        losses.append(float(m["loss"]))
        walls.append((time.perf_counter() - t0) * 1e3)
        if last:
            torch.cuda.synchronize()
            prof.__exit__(None, None, None)
    peak = torch.cuda.max_memory_allocated()
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            row = by_name.setdefault(e.name, [0.0, 0])
            row[0] += e.time_range.elapsed_us() / 1e3
            row[1] += 1
    busy = sum(ms for ms, _ in by_name.values()) if by_name else None
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    return {"tree": tree, "arch": arch, "step_ms": walls, "profiled_step_ms": walls[-1],
            "device_busy_ms": busy, "device_events": sum(n for _, n in by_name.values()),
            "top_kernels": [(name[:60], ms, n) for name, (ms, n) in top],
            "peak_bytes": peak, "losses": losses}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="xlstm-1.3b")
    ap.add_argument("--tree", action="append", default=None,
                    help="a source tree to run (repeatable; default: this checkout)")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print("RESULT " + json.dumps(child(args.child, args.arch, args.steps, args.batch,
                                           args.seq)), flush=True)
        return
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip(), flush=True)
    results = []
    for tree in args.tree or [ROOT]:
        tree = os.path.abspath(tree)
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", tree,
                               "--arch", args.arch, "--steps", str(args.steps), "--batch",
                               str(args.batch), "--seq", str(args.seq)],
                              capture_output=True, text=True, cwd=tree)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
        if proc.returncode != 0 or not lines:
            print(proc.stdout[-3000:], proc.stderr[-6000:], flush=True)
            raise SystemExit(f"{tree}: exit {proc.returncode}")
        res = json.loads(lines[-1][len("RESULT "):])
        res["run_s"] = time.perf_counter() - t0
        results.append(res)
        busy = res["device_busy_ms"]
        print(f"{tree}: {args.arch} steps {[round(w, 1) for w in res['step_ms']]} ms; profiled "
              f"step {res['profiled_step_ms']:.1f} ms, device busy "
              + (f"{busy:.1f} ms ({res['device_events']} device events)" if busy is not None
                 else "not measured (no device events)")
              + f"; max_memory_allocated {res['peak_bytes'] / 2**30:.3f} GiB "
              f"({res['peak_bytes']} bytes); losses {res['losses']}; {res['run_s']:.1f} s",
              flush=True)
        for name, ms, n in res["top_kernels"]:
            print(f"    {ms:9.3f} ms  {n:6d}  {name}", flush=True)
    print(json.dumps({"card": card.strip(), "runs": results}), flush=True)


if __name__ == "__main__":
    main()
