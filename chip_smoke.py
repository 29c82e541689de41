#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``src/repro_torch``).

Builds the CUDA flow-step kernel from ``src/repro_torch/kernels/stream_flow``
into ``build/kernels/``, then:

1. holds the kernel against its plain PyTorch version on the card, on
   seeded random problems and on the padded arrays of a 20,000-ktps
   ``deep_pipeline`` allocation;
2. drives the paper's workflow on ``deep_pipeline`` through the port's
   entry points: profile a test deployment (``training_sweep``), fit node
   models, predict three unseen packings and measure them, allocate for
   20,000 ktps, and measure the allocation with the dense and the sparse
   tick (which must agree);
3. scores a batch of 32 candidate configurations around the allocation
   with the sparse tick in summary mode;

and times the kernel, its plain version and the index_add_ segment-sum
formulation at the main path's shapes.  Any failed phase raises and the
script exits non-zero.  The last line is a JSON object with ``"ok": true``
and the device; the line before it lists each kernel with its launches on
the main path, its error against the plain version, its times and its
bound.

Run from the root of the repository:  python3 chip_smoke.py
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

#: H100 SXM device-memory rate and fp32 (non-tensor-core) peak, from
#: NVIDIA's data sheet, for the kernel's bound.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

TARGET_KTPS = 20000.0
RTOL, ATOL_REL = 1e-5, 1e-6          # kernel vs plain: rtol, atol = ATOL_REL * max|plain|
SEGMENT_RTOL, SEGMENT_ATOL = 1e-5, 1e-5   # kernel vs the segment-sum contract


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


# ----------------------------------------------------------- flow problems

def random_flow_problem(rng, batch, n_inst, n_cont, n_edges, device):
    """A batch of seeded random flow steps laid out as the simulator lays
    them out: real edges first, the last tenth padded (zero share, pointing
    at the last instance/container), ELL rows over the real edges only."""
    import numpy as np
    from repro_torch.interop import stage_padded
    from repro_torch.kernels.stream_flow import ell_rows
    from repro_torch.streams import degree_bucket_size

    n_real = n_edges - n_edges // 10
    rows = []
    for _ in range(batch):
        src = np.sort(rng.integers(0, n_inst, n_real)).astype(np.int32)
        dst = rng.integers(0, n_inst, n_real).astype(np.int32)
        cont_of = rng.integers(0, n_cont, n_inst).astype(np.int32)
        rows.append((src, dst, cont_of))
    d_out = degree_bucket_size(max(np.bincount(r[0]).max() for r in rows))
    d_in = degree_bucket_size(max(np.bincount(r[1]).max() for r in rows))

    def pad(x, fill, dtype):
        out = np.full(n_edges, fill, dtype)
        out[: x.shape[0]] = x
        return out

    arrays = []
    for src, dst, cont_of in rows:
        remote = (cont_of[src] != cont_of[dst]).astype(np.float32)
        arrays.append(dict(
            qout=rng.uniform(0.0, 5.0, n_inst).astype(np.float32),
            edge_src=pad(src, n_inst - 1, np.int32),
            edge_dst=pad(dst, n_inst - 1, np.int32),
            edge_share=pad(rng.uniform(0.0, 1.0, n_real).astype(np.float32), 0.0, np.float32),
            edge_remote=pad(remote, 0.0, np.float32),
            edge_src_cont=pad(cont_of[src], n_cont - 1, np.int32),
            edge_dst_cont=pad(cont_of[dst], n_cont - 1, np.int32),
            ell_src=ell_rows(src, n_inst, d_out, n_edges),
            ell_dst=ell_rows(dst, n_inst, d_in, n_edges),
            cont_of=cont_of,
            sm_budget=rng.uniform(0.5, 4.0, n_cont).astype(np.float32),
        ))
    stacked = {k: np.stack([a[k] for a in arrays]) for k in arrays[0]}
    return stage_padded(stacked, device)


def padded_flow_problem(configs, params, rng, device):
    """The flow-step inputs of a batch of configurations, padded as the
    sparse tick pads them, with a seeded random ``qout``."""
    import numpy as np
    from repro_torch.interop import stage_padded
    from repro_torch.streams import (
        bucket_size, degree_bucket_size, edge_bucket_size, pad_structure,
        structure_for,
    )

    sts = [structure_for(c, params) for c in configs]
    I = bucket_size(max(s.n_inst for s in sts))
    K = bucket_size(max(s.n_cont for s in sts))
    E = edge_bucket_size(max(s.n_edges for s in sts))
    d_out = degree_bucket_size(max(s.d_out for s in sts))
    d_in = degree_bucket_size(max(s.d_in for s in sts))
    arrays = []
    for s in sts:
        a = pad_structure(s, I, K, E, d_out, d_in)
        a["qout"] = (rng.uniform(0.0, 5.0, I) * a["inst_mask"]).astype(np.float32)
        a["sm_budget"] = (params.dt / np.maximum(a["sm_cost_eff"], 1e-9)).astype(np.float32)
        arrays.append(a)
    stacked = {k: np.stack([a[k] for a in arrays]) for k in arrays[0]}
    return stage_padded(stacked, device)


KERNEL_ARGS = (
    "qout", "edge_src", "edge_share", "edge_remote", "edge_src_cont",
    "edge_dst_cont", "ell_src", "ell_dst", "cont_of", "sm_budget",
)
SEGMENT_ARGS = (
    "qout", "edge_src", "edge_dst", "edge_share", "edge_remote",
    "edge_src_cont", "edge_dst_cont", "sm_budget",
)


def check_kernel(name, p) -> float:
    """Kernel vs plain version (and vs the segment-sum contract) on the same
    inputs; returns the largest absolute difference to the plain version."""
    import torch
    from repro_torch.kernels.stream_flow import (
        stream_flow_ell, stream_flow_ell_reference, stream_flow_reference,
    )

    args = [p[k] for k in KERNEL_ARGS]
    got = stream_flow_ell(*args)
    plain = stream_flow_ell_reference(*args)
    seg = stream_flow_reference(
        *[p[k] for k in SEGMENT_ARGS],
        n_inst=p["qout"].shape[1], n_cont=p["sm_budget"].shape[1],
    )
    if got[0].is_cuda:
        torch.cuda.synchronize()
    worst = 0.0
    for out, ref, sref, label in zip(got, plain, seg, ("delivered", "arrivals", "trav_c")):
        if not torch.isfinite(out).all():
            raise AssertionError(f"{name}: {label} has non-finite values")
        err = (out - ref).abs()
        bound = RTOL * ref.abs() + ATOL_REL * float(ref.abs().max())
        if bool((err > bound).any()):
            raise AssertionError(
                f"{name}: {label} differs from the plain version by up to "
                f"{float(err.max()):.3e} (rtol {RTOL}, atol {ATOL_REL}*max|x|)"
            )
        torch.testing.assert_close(out, sref, rtol=SEGMENT_RTOL, atol=SEGMENT_ATOL)
        worst = max(worst, float(err.max()))
    log(f"  {name}: B={p['qout'].shape[0]} I={p['qout'].shape[1]} "
        f"K={p['sm_budget'].shape[1]} E={p['edge_src'].shape[1]} "
        f"D=({p['ell_src'].shape[2]},{p['ell_dst'].shape[2]}) max|kernel-plain|={worst:.3e}")
    return worst


# ------------------------------------------------------------------ timing

def cuda_ms(fn, iters: int, warmup: int = 5) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def flow_bound(p) -> tuple[float, str, int, int]:
    """Least time the card could take for one flow step on these inputs:
    each needed input byte read once, each output byte written once (real
    edges only: padded edges and ELL padding carry no work), against the
    fp32 operations the step does."""
    B, I = p["qout"].shape
    K = p["sm_budget"].shape[1]
    E = p["edge_src"].shape[1]
    real = int((p["ell_src"] < E).sum())           # real edges in the batch
    per_edge = 2 * 4 + 5 * 4                       # two ELL ids + src, share, remote, src/dst container
    nbytes = B * (I * 4 + I * 4 + K * 4) + real * per_edge + B * (2 * I + K) * 4
    flops = real * 16 + B * I * 6
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    if t_bytes >= t_ops:
        return t_bytes, "bytes", nbytes, flops
    return t_ops, "operations", nbytes, flops


def time_flow(label, p, C):
    from repro_torch.kernels.stream_flow import (
        stream_flow_ell, stream_flow_ell_reference, stream_flow_reference,
    )
    args = [p[k] for k in KERNEL_ARGS]
    seg_args = [p[k] for k in SEGMENT_ARGS]
    n_inst, n_cont = p["qout"].shape[1], p["sm_budget"].shape[1]
    ms = cuda_ms(lambda: stream_flow_ell(*args), iters=100)
    plain_ms = cuda_ms(lambda: stream_flow_ell_reference(*args, C), iters=50)
    library_ms = cuda_ms(
        lambda: stream_flow_reference(*seg_args, n_inst=n_inst, n_cont=n_cont),
        iters=50,
    )
    bound_ms, bound_by, nbytes, flops = flow_bound(p)
    log(f"  {label}: kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
        f"index_add_ {library_ms:.4f} ms  bound {bound_ms:.5f} ms ({bound_by}: "
        f"{nbytes} B, {flops} flop)")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def profile_ticks(device, params, configs, duration_s):
    """Device busy share and kernel time by name over a short sparse
    summary run of ``configs``, from ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.streams import simulate_batch

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        simulate_batch(configs, 1e6, duration_s=duration_s, params=params,
                       tick_kernel="sparse", samples="summary", device=device)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    n_ticks = int(duration_s / params.dt)
    rows = [
        (getattr(e, "self_device_time_total", 0.0) / 1e3, e.count, e.key)
        for e in prof.key_averages()
    ]
    rows = sorted((r for r in rows if r[0] > 0), reverse=True)
    busy_ms = sum(r[0] for r in rows)
    if not rows:
        log("  profiler: no device time recorded (device busy share not measured)")
        return
    log(f"  profiler over {n_ticks} ticks x {len(configs)} rows: wall {wall_ms:.1f} ms "
        f"({wall_ms / n_ticks:.3f} ms/tick), device busy {busy_ms:.1f} ms "
        f"({busy_ms / wall_ms:.1%}), idle {1 - busy_ms / wall_ms:.1%}")
    for dev_ms, count, key in rows[:6]:
        log(f"    {dev_ms:9.3f} ms  {count:6d} calls  {key[:70]}")


# ------------------------------------------------------------------ phases

def phase_kernel(device, rng, alloc_config, params, sizes):
    errs = []
    for batch, n_inst, n_cont, n_edges in sizes:
        p = random_flow_problem(rng, batch, n_inst, n_cont, n_edges, device)
        errs.append(check_kernel(f"random({n_inst},{n_cont},{n_edges})", p))
    p = padded_flow_problem([alloc_config], params, rng, device)
    errs.append(check_kernel(f"deep_pipeline@{TARGET_KTPS:.0f}", p))
    return max(errs)


def phase_main_path(device, params, dim, target, sweep_s, measure_s):
    import numpy as np
    from repro_torch.core import (
        allocate, fit_workload, round_robin_configuration, solve_flow,
    )
    from repro_torch.streams import (
        deep_pipeline, measure_capacity, structure_for, training_sweep,
    )

    dag = deep_pipeline()
    test_cfg = round_robin_configuration(dag, {n: 1 for n in dag.node_names}, 2, dim)
    store = training_sweep(test_cfg, np.linspace(25, 150, 6), params,
                           seconds_per_rate=sweep_s, device=device)
    log(f"  profiled {test_cfg.describe()}: {len(store)} timeseries")
    models = fit_workload(store)
    for name, m in sorted(models.items()):
        log(f"    {name:20s} peak {m.peak_rate_ktps:8.1f} ktps  gamma {m.gamma:.2f}")
    hot = ("transform", "aggregate")
    packings = [
        round_robin_configuration(dag, {n: 1 for n in dag.node_names}, 4, dim),
        round_robin_configuration(dag, {n: 2 for n in dag.node_names}, 4, dim),
        round_robin_configuration(
            dag, {n: 2 if n in hot else 1 for n in dag.node_names}, 3, dim
        ),
    ]
    for cfg in packings:
        pred = solve_flow(cfg, models).rate_ktps
        meas = measure_capacity(cfg, params, duration_s=measure_s, device=device)
        err = abs(pred - meas) / meas
        log(f"    {cfg.describe()[:70]:70s} pred {pred:7.1f} measured {meas:7.1f} err {err * 100:4.1f}%")
        if not (np.isfinite(pred) and np.isfinite(meas) and meas > 0):
            raise AssertionError("prediction or measurement is not a positive number")
        if err > 0.25:
            raise AssertionError(f"prediction off by {err:.1%} (> 25%)")
    result = allocate(dag, models, target, overprovision=1.1)
    st = structure_for(result.config, params)
    log(f"  allocation for {target:.0f} ktps: {st.n_inst} instances, "
        f"{st.n_cont} containers, {st.n_edges} edges, {result.total_cpus:.1f} cpus")
    dense = measure_capacity(result.config, params, tick_kernel="dense", device=device)
    sparse = measure_capacity(result.config, params, tick_kernel="sparse", device=device)
    rel = abs(sparse - dense) / dense
    log(f"  measured: dense {dense:.3f} ktps  sparse {sparse:.3f} ktps  rel {rel:.2e}")
    if not (np.isfinite(dense) and dense > 0):
        raise AssertionError("dense capacity is not a positive number")
    if rel > 1e-4:
        raise AssertionError(f"sparse and dense capacities differ by {rel:.2e} (> 1e-4)")
    return result


def candidate_configs(result, n, rng):
    """``n`` configurations around an allocation: its replica counts ±1 per
    node, dealt round-robin over its container count."""
    from repro_torch.core import ContainerDim, round_robin_configuration
    cfg = result.config
    dag = cfg.dag
    par = cfg.parallelism_map()
    dim = ContainerDim(
        cpus=max(d.cpus for d in cfg.dims), mem_mb=max(d.mem_mb for d in cfg.dims)
    )
    out = [round_robin_configuration(dag, par, cfg.n_containers, dim)]
    while len(out) < n:
        delta = rng.integers(-1, 2, len(dag.node_names))
        p = {nm: max(1, par[nm] + int(d)) for nm, d in zip(dag.node_names, delta)}
        out.append(round_robin_configuration(dag, p, cfg.n_containers, dim))
    return out


def phase_batch(device, params, configs, duration_s):
    import numpy as np
    from repro_torch.streams import simulate_batch
    res = simulate_batch(configs, 1e6, duration_s=duration_s, params=params,
                         tick_kernel="sparse", samples="summary", device=device)
    caps = np.array([r.achieved_ktps for r in res])
    if not (np.isfinite(caps).all() and (caps > 0).all()):
        raise AssertionError(f"candidate capacities not all positive: {caps}")
    best = int(np.argmax(caps))
    log(f"  {len(configs)} candidates: capacity min {caps.min():.1f} max {caps.max():.1f} "
        f"ktps (best #{best}: {configs[best].n_containers} containers, "
        f"bottleneck {res[best].bottleneck_node()})")
    return caps


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: {SRC}/repro_torch not found", file=sys.stderr)
        return 1
    sys.path.insert(0, SRC)
    import numpy as np
    from repro_torch import resolve_device
    from repro_torch.core import ContainerDim, allocate, oracle_models
    from repro_torch.kernels.stream_flow import build, stream_flow_ell
    from repro_torch.streams import SimParams, deep_pipeline

    device = resolve_device("cuda")
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    params = SimParams()
    dim = ContainerDim(cpus=3.0, mem_mb=4096.0)
    rng = np.random.default_rng(0)
    timings = {}

    t0 = time.perf_counter()
    build.load()
    timings["build"] = time.perf_counter() - t0
    log(f"build: {timings['build']:.1f} s -> {build.library_path().relative_to(ROOT)}")
    for line in build.build_log.splitlines():
        if "registers" in line or "smem" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    t0 = time.perf_counter()
    log("phase 1: kernel vs plain")
    oracle = oracle_models(deep_pipeline(), params.sm_cost_per_ktuple)
    oracle_alloc = allocate(deep_pipeline(), oracle, TARGET_KTPS, overprovision=1.1)
    max_err = phase_kernel(
        device, rng, oracle_alloc.config, params,
        sizes=[(8, 32, 8, 100), (8, 1024, 512, 49152)],
    )
    timings["phase1"] = time.perf_counter() - t0

    stream_flow_ell.launches = 0
    t0 = time.perf_counter()
    log("phase 2: main path on deep_pipeline")
    result = phase_main_path(device, params, dim, TARGET_KTPS, sweep_s=8.0, measure_s=10.0)
    torch.cuda.synchronize()
    timings["phase2"] = time.perf_counter() - t0
    launches_main = stream_flow_ell.launches
    log(f"  stream_flow_ell launches in phase 2: {launches_main}")

    t0 = time.perf_counter()
    log("phase 3: 32 candidates around the allocation (sparse, summary)")
    candidates = candidate_configs(result, 32, rng)
    phase_batch(device, params, candidates, duration_s=20.0)
    torch.cuda.synchronize()
    timings["phase3"] = time.perf_counter() - t0
    launches = stream_flow_ell.launches
    log(f"  stream_flow_ell launches in phase 3: {launches - launches_main}")
    log(f"stream_flow_ell.launches after phases 2-3: {launches}")
    if launches <= 0:
        raise AssertionError("the main path never launched the stream_flow kernel")

    t0 = time.perf_counter()
    log("timing at the main path's shapes (CUDA events)")
    p1 = padded_flow_problem([result.config], params, rng, device)
    C1 = torch.nn.functional.one_hot(p1["cont_of"].long(), p1["sm_budget"].shape[1]).float()
    t_b1 = time_flow("batch 1 (allocation)", p1, C1)
    p32 = padded_flow_problem(candidates, params, rng, device)
    C32 = torch.nn.functional.one_hot(p32["cont_of"].long(), p32["sm_budget"].shape[1]).float()
    t_b32 = time_flow("batch 32 (candidates)", p32, C32)
    max_err = max(max_err, check_kernel("batch 32 (candidates)", p32))
    log("profile: where a tick's time goes (32 candidates, sparse, summary)")
    profile_ticks(device, params, candidates, duration_s=1.0)
    timings["timing"] = time.perf_counter() - t0
    log("phase wall times: " + " ".join(f"{k} {v:.1f}s" for k, v in timings.items()))
    log(f"batch 1: {json.dumps(t_b1)}")

    kernels = [dict(
        name="stream_flow_ell",
        route="cuda",
        source="src/repro_torch/kernels/stream_flow/csrc/stream_flow.cu",
        replaces="src/repro/kernels/stream_flow/stream_flow.py:94",
        launches=launches,
        max_abs_err=max_err,
        **t_b32,
    )]
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
