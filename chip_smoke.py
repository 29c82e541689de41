#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``src/repro_torch``).

Builds the four CUDA kernels from ``src/repro_torch/kernels/*/csrc`` into
``build/kernels/`` (one ``nvcc`` per source, all at once), then:

1. holds the flow-step kernel against its plain PyTorch version on the
   card, on seeded random problems and on the padded arrays of a
   20,000-ktps ``deep_pipeline`` allocation;
2. drives the paper's workflow on ``deep_pipeline`` through the port's
   entry points: profile a test deployment (``training_sweep``), fit node
   models, predict three unseen packings and measure them, allocate for
   20,000 ktps, and measure the allocation with the dense and the sparse
   tick (which must agree);
3. scores a batch of 32 candidate configurations around the allocation
   with the sparse tick in summary mode;
4. holds the RMSNorm and flash-attention kernels against their plain
   versions at llama3-8b's shapes (fp32 and bf16 RMSNorm; causal, windowed
   and non-causal attention, head_dim 128 and 120);
5. runs a 2-layer llama3-8b at full width with the same seeded weights on
   the card and on the host, one prefill and 4 decode steps, and compares
   the logits;
6. serves 8 seeded requests (32-192-token prompts, 16 new tokens each)
   with the full 32-layer llama3-8b behind ``BatchedServer`` on the card,
   and holds the kernels' launch counts to one flash launch per layer per
   prefill and 2 x 32 + 1 RMSNorm launches per forward;
7. holds the selective-scan kernel against its plain version at
   jamba-1.5-large's shapes (16,384 channels, state 16: each serving prompt
   length, S = 1, 7, 130 and batch-4 decode; non-zero h0, B and C strided
   as the Mamba block passes them, one bf16 case);
8. runs one Mamba and one attention block of jamba-1.5-large at full width
   (dense MLPs) on the card and on the host, one prefill and 4 decode
   steps, and compares logits, Mamba states and greedy tokens;
9. serves the same 8 seeded prompt lengths with one full-width period of
   jamba-1.5-large with dense MLPs (8 layers: 7 Mamba, 1 attention;
   9,116,360,704 parameters) behind ``BatchedServer``, and holds the launch
   counts to 7 selective scans and 17 RMSNorms per forward and one flash
   launch per prefill;

and times each kernel, its plain version and, where there is one, the
PyTorch call that computes the same function at the main paths' shapes.
Any failed phase raises and the script exits non-zero.  The last line is a
JSON object with ``"ok": true`` and the device; the line before it lists
each kernel with its launches on the main paths, its error against the
plain version, its times and its bound.

Run from the root of the repository:  python3 chip_smoke.py
"""
from __future__ import annotations

import functools
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
#: expf throughput of the special-function units (16 per clock per SM,
#: 132 SMs, 1.98 GHz boost), logged beside the selective scan's bound.
SFU_PER_S = 16 * 132 * 1.98e9

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


@functools.lru_cache(maxsize=1)
def side_stream():
    """The one stream graph captures warm up on: cuBLAS keeps a workspace
    for every stream it has run on, so a new stream per timing would hold
    32 MiB more each time."""
    import torch
    return torch.cuda.Stream()


def graph_ms(fn, iters: int, replays: int = 5) -> float:
    """Device time per call of ``fn``: ``iters`` calls captured in one CUDA
    graph and replayed back to back, so the host's per-call launch cost
    (Python, ctypes, argument checks) is left out."""
    import torch
    side = side_stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (replays * iters)
    del graph
    return ms


def time_both(fn, iters: int) -> tuple[float, float]:
    """(device ms per call from graph replay, eager ms per call from CUDA
    events around back-to-back calls, host launch cost included)."""
    return graph_ms(fn, iters), cuda_ms(fn, iters)


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


def log_device_time(prof, wall_ms: float, header: str, top: int) -> None:
    """Device busy share and device time by name over a profiler window:
    the device's own events (kernels, copies, memsets), each counted once.
    The host-side operator rows that launched them carry the same device
    time and are left out, so nothing is counted twice."""
    from torch.autograd import DeviceType

    by_name: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            row = by_name.setdefault(e.name, [0.0, 0])
            row[0] += e.time_range.elapsed_us() / 1e3
            row[1] += 1
    if not by_name:
        log("  profiler: no device time recorded (device busy share not measured)")
        return
    busy_ms = sum(ms for ms, _ in by_name.values())
    log(f"  {header}: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
        f"({busy_ms / wall_ms:.1%}), idle {1 - busy_ms / wall_ms:.1%}")
    for name, (ms, count) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]:
        log(f"    {ms:9.3f} ms  {count:6d} calls  {name[:70]}")


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
    log_device_time(prof, wall_ms, f"profiler over {n_ticks} ticks x {len(configs)} rows "
                    f"({wall_ms / n_ticks:.3f} ms/tick)", top=6)


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


# ------------------------------------------------------------ LM kernels

LLAMA = dict(d=4096, H=32, KV=8, hd=128)
RMS_FP32_TOL = 1e-6                 # rtol and atol, kernel vs plain
FLASH_TOL = 2e-5                    # rtol and atol, kernel vs plain
LOGIT_RTOL, LOGIT_ATOL_REL = 1e-4, 1e-4   # card vs host logits


def bf16_ulp(ref):
    import torch
    a = ref.float().abs().clamp_min(torch.finfo(torch.bfloat16).tiny)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def check_rmsnorm(device, rows_shapes) -> float:
    """The RMSNorm kernel against its plain version on seeded inputs, fp32
    within 1e-6 and bf16 within one bf16 ulp; returns the largest fp32
    absolute difference."""
    import torch
    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_reference

    g = torch.Generator(device=device).manual_seed(12)
    worst = 0.0
    for shape in rows_shapes:
        x32 = torch.randn(shape, generator=g, device=device)
        gain = 1.0 + 0.1 * torch.randn(shape[-1], generator=g, device=device)
        for x in (x32, x32.bfloat16()):
            got = rmsnorm(x, gain, 1e-5)
            want = rmsnorm_reference(x, gain, 1e-5)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs()
            if not torch.isfinite(got).all():
                raise AssertionError(f"rmsnorm {shape} {x.dtype}: non-finite output")
            if x.dtype == torch.float32:
                torch.testing.assert_close(got, want, rtol=RMS_FP32_TOL, atol=RMS_FP32_TOL)
                worst = max(worst, float(err.max()))
            elif not bool((err <= bf16_ulp(want)).all()):
                raise AssertionError(f"rmsnorm {shape} bf16: off by more than one bf16 ulp")
            log(f"  rmsnorm {tuple(shape)} {str(x.dtype)[6:]}: max|kernel-plain|={float(err.max()):.3e}")
    return worst


def flash_inputs(device, S, H, KV, hd, seed):
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    return (torch.randn(1, S, H, hd, generator=g, device=device),
            torch.randn(1, S, KV, hd, generator=g, device=device),
            torch.randn(1, S, KV, hd, generator=g, device=device))


def check_flash(device, cases) -> float:
    """The flash kernel against its plain version (``attention_reference``'s
    semantics: keys masked by the real length) within 2e-5; returns the
    largest absolute difference."""
    import torch
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_reference

    worst = 0.0
    for S, H, KV, hd, causal, window in cases:
        q, k, v = flash_inputs(device, S, H, KV, hd, seed=S * 7 + hd)
        scale = 1.0 / hd ** 0.5
        got = flash_attention(q, k, v, causal=causal, window=window, scale=scale)
        want = flash_attention_reference(q, k, v, causal=causal, window=window, scale=scale)
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            raise AssertionError(f"flash S={S} hd={hd}: non-finite output")
        torch.testing.assert_close(got, want, rtol=FLASH_TOL, atol=FLASH_TOL)
        err = float((got - want).abs().max())
        worst = max(worst, err)
        log(f"  flash S={S} H={H} KV={KV} hd={hd} causal={causal} window={window}: "
            f"max|kernel-plain|={err:.3e}")
    return worst


def rmsnorm_bound(rows, d) -> tuple[float, str]:
    nbytes = 2 * rows * d * 4 + d * 4               # x read, out written, gain read
    flops = rows * d * 4
    return max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S) * 1e3, (
        "bytes" if nbytes / HBM_BYTES_PER_S >= flops / FP32_FLOPS_PER_S else "operations")


def flash_bound(S, H, KV, hd) -> tuple[float, str]:
    """Causal attention over S positions: S(S+1)/2 scored pairs per head,
    each 2·hd flops for q·k, 2·hd for p·v and about 4 for the softmax; q, k,
    v read once and the output written once."""
    pairs = S * (S + 1) // 2
    flops = H * pairs * (4 * hd + 4)
    nbytes = 4 * S * hd * (2 * H + 2 * KV)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def excess_ms(runs) -> float:
    """Sum of launches x (device time - bound) over (launches, timing)
    pairs: the time a kernel spends above its bound on a path."""
    return sum(n * (t["ms"] - t["bound_ms"]) for n, t in runs)


def time_rmsnorm(device, shape) -> dict:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_reference

    g = torch.Generator(device=device).manual_seed(5)
    x = torch.randn(shape, generator=g, device=device)
    gain = 1.0 + 0.1 * torch.randn(shape[-1], generator=g, device=device)
    ms, eager_ms = time_both(lambda: rmsnorm(x, gain, 1e-5), iters=200)
    plain_ms, plain_eager = time_both(lambda: rmsnorm_reference(x, gain, 1e-5), iters=200)
    library_ms, library_eager = time_both(lambda: F.rms_norm(x, (shape[-1],), gain, 1e-5), iters=200)
    rows = x.numel() // shape[-1]
    bound_ms, bound_by = rmsnorm_bound(rows, shape[-1])
    log(f"  rmsnorm {tuple(shape)} device (graph): kernel {ms:.5f} ms  plain {plain_ms:.5f} ms  "
        f"F.rms_norm {library_ms:.5f} ms  bound {bound_ms:.6f} ms ({bound_by}); "
        f"eager with launch cost: kernel {eager_ms:.5f}  plain {plain_eager:.5f}  "
        f"F.rms_norm {library_eager:.5f} ms")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def time_flash(device, S) -> dict:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_reference

    H, KV, hd = LLAMA["H"], LLAMA["KV"], LLAMA["hd"]
    q, k, v = flash_inputs(device, S, H, KV, hd, seed=S)
    scale = 1.0 / hd ** 0.5
    ms, eager_ms = time_both(lambda: flash_attention(q, k, v, causal=True, scale=scale), iters=50)
    out = flash_attention(q, k, v, causal=True, scale=scale)
    plain_ms, plain_eager = time_both(
        lambda: flash_attention_reference(q, k, v, causal=True, scale=scale), iters=50)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, scale=scale,
                                                  enable_gqa=True)
    library_ms, library_eager = time_both(sdpa, iters=50)
    lib_err = float((sdpa().transpose(1, 2) - out).abs().max())
    bound_ms, bound_by = flash_bound(S, H, KV, hd)
    log(f"  flash S={S} device (graph): kernel {ms:.5f} ms  plain {plain_ms:.5f} ms  "
        f"sdpa {library_ms:.5f} ms (max|sdpa-kernel|={lib_err:.2e})  bound {bound_ms:.6f} ms "
        f"({bound_by}); eager with launch cost: kernel {eager_ms:.5f}  plain {plain_eager:.5f}  "
        f"sdpa {library_eager:.5f} ms")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def block_counts(cfg) -> dict:
    """Blocks of each kind over the whole depth."""
    return {kind: cfg.n_periods() * cfg.pattern().count(kind) for kind in ("attn", "mamba")}


def expected_launches(cfg, forwards, prefills) -> dict:
    """Kernel launches of ``forwards`` forward passes, ``prefills`` of them
    prefills: two RMSNorms per block (every block has an MLP) and the final
    one each forward, one selective scan per Mamba block each forward (the
    decode step runs the kernel with S = 1), one flash launch per attention
    block each prefill (decode attention is plain torch)."""
    n = block_counts(cfg)
    return dict(rmsnorm=(2 * cfg.n_layers + 1) * forwards,
                flash_attention=n["attn"] * prefills,
                ssm_scan=n["mamba"] * forwards)


def kernel_launches() -> dict:
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rmsnorm import rmsnorm
    from repro_torch.kernels.ssm_scan import ssm_scan
    return dict(rmsnorm=rmsnorm.launches, flash_attention=flash_attention.launches,
                ssm_scan=ssm_scan.launches)


def zero_launches() -> None:
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rmsnorm import rmsnorm
    from repro_torch.kernels.ssm_scan import ssm_scan
    rmsnorm.launches = flash_attention.launches = ssm_scan.launches = 0


# ------------------------------------------------------------ selective scan

JAMBA = dict(D=16384, N=16)         # jamba-1.5-large: d_inner 2 x 8192, d_state 16
SCAN_RTOL, SCAN_ATOL_REL = 1e-5, 1e-5     # fp32: rtol, atol = ATOL_REL * max|y|
SCAN_BF16_TOL = 3e-2                       # bf16 inputs: rtol and atol


def scan_inputs(device, B, S, D, N, dtype, seed):
    """Seeded inputs in the Mamba block's ranges: softplus'd step sizes, a
    negative decay, a non-zero h0, and B and C as strided slices of one
    projection, as the block passes them."""
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    r = lambda *shape: torch.randn(*shape, generator=g, device=device)
    dt = torch.nn.functional.softplus(r(B, S, D) - 1.0)
    x = r(B, S, D)
    proj = r(B, S, 64 + 2 * N) * 0.5
    _, bm, cm = proj.split([64, N, N], dim=-1)
    a = -torch.exp(r(D, N) * 0.5)
    h0 = r(B, D, N) * 0.1
    return dt.to(dtype), x.to(dtype), bm.to(dtype), cm.to(dtype), a, h0


def check_ssm_scan(device, cases) -> float:
    """The selective-scan kernel against its plain version: fp32 within
    rtol 1e-5, atol 1e-5·max|y| (and the same for hT), bf16 inputs within
    3e-2; returns the largest fp32 absolute difference."""
    import torch
    from repro_torch.kernels.ssm_scan import ssm_scan, ssm_scan_reference

    worst = 0.0
    for B, S, D, N, dtype in cases:
        args = scan_inputs(device, B, S, D, N, dtype, seed=S * 17 + B)
        got = ssm_scan(*args)
        want = ssm_scan_reference(*args)
        torch.cuda.synchronize()
        errs = []
        for label, g, w in zip(("y", "hT"), got, want):
            if not torch.isfinite(g).all():
                raise AssertionError(f"ssm_scan {(B, S, D, N)}: non-finite {label}")
            if dtype == torch.float32:
                torch.testing.assert_close(g, w, rtol=SCAN_RTOL,
                                           atol=SCAN_ATOL_REL * float(w.abs().max()))
            else:
                torch.testing.assert_close(g, w, rtol=SCAN_BF16_TOL, atol=SCAN_BF16_TOL)
            errs.append(float((g - w).abs().max()))
        if dtype == torch.float32:
            worst = max(worst, *errs)
        log(f"  ssm_scan B={B} S={S} D={D} N={N} {str(dtype)[6:]}: "
            f"max|kernel-plain| y {errs[0]:.3e} hT {errs[1]:.3e}")
    return worst


def ssm_bound(B, S, D, N) -> tuple[float, str, float]:
    """fp32 inputs: dt and x read and y written once (B·S·D each), B and C
    read once (B·S·N each), a, h0 and hT once; 1 + 7·N fp32 operations per
    (b, t, channel) (dt·x; per state: dt·A, exp, a·h, dx·B, +, h·C, +).
    Returns (bound ms, what bounds it, the expf time on the SFUs in ms)."""
    nbytes = 4 * (3 * B * S * D + 2 * B * S * N + D * N + 2 * B * D * N)
    flops = B * S * D * (1 + 7 * N)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    sfu_ms = B * S * D * N / SFU_PER_S * 1e3
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations", sfu_ms


def time_ssm_scan(device, B, S) -> dict:
    import torch
    from repro_torch.kernels.ssm_scan import ssm_scan, ssm_scan_reference

    D, N = JAMBA["D"], JAMBA["N"]
    args = scan_inputs(device, B, S, D, N, torch.float32, seed=B * 1000 + S)
    ms, eager_ms = time_both(lambda: ssm_scan(*args), iters=50)
    plain_iters = max(2, 200 // S)
    plain_ms = graph_ms(lambda: ssm_scan_reference(*args), iters=plain_iters, replays=2)
    plain_eager = cuda_ms(lambda: ssm_scan_reference(*args), iters=plain_iters, warmup=1)
    bound_ms, bound_by, sfu_ms = ssm_bound(B, S, D, N)
    log(f"  ssm_scan ({B}, {S}, {D}, {N}) device (graph): kernel {ms:.5f} ms  plain {plain_ms:.5f} ms  "
        f"bound {bound_ms:.6f} ms ({bound_by}; expf on the SFUs {sfu_ms:.6f} ms); "
        f"eager with launch cost: kernel {eager_ms:.5f}  plain {plain_eager:.5f} ms; "
        f"no single PyTorch call computes a selective scan")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=None,
                bound_ms=bound_ms, bound_by=bound_by)


def phase_card_vs_host(device, cfg, prompt_len, decode_steps, seed):
    """The model ``cfg`` with the same seeded weights on the card and the
    host: one prefill and ``decode_steps`` decode steps on each (the host's
    greedy tokens fed to both), logits and Mamba states compared within
    rtol 1e-4, atol 1e-4·max|x|, and the greedy tokens equal."""
    import numpy as np
    import torch
    from repro_torch.models import build_model

    n_layers = cfg.n_layers
    t0 = time.perf_counter()
    host = build_model(cfg, device="cpu", seed=seed)
    card = build_model(cfg, device=device, seed=seed)
    card.load_state_dict(host.state_dict())
    log(f"  built {n_layers}-layer {cfg.name} on host and card ({host.n_params():,} params) "
        f"in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(seed)
    prompt = torch.as_tensor(rng.integers(4, cfg.vocab, size=(1, prompt_len)))
    zero_launches()
    worst = 0.0

    def close(label, got, want):
        got = got.cpu()
        if not torch.isfinite(got).all():
            raise AssertionError(f"{label}: non-finite values on the card")
        atol = LOGIT_ATOL_REL * float(want.abs().max())
        torch.testing.assert_close(got, want, rtol=LOGIT_RTOL, atol=atol)
        return float((got - want).abs().max()), atol

    def compare(label, got, want):
        nonlocal worst
        err, atol = close(label, got, want)
        worst = max(worst, err)
        token, card_token = int(want[0, -1].argmax()), int(got[0, -1].argmax())
        log(f"  {label}: max|card-host| {err:.3e} (atol {atol:.3e}), "
            f"argmax card {card_token} host {token}")
        if card_token != token:
            raise AssertionError(f"{label}: greedy token {card_token} on the card, {token} on the host")
        return token

    caches = {}
    for name, model in (("host", host), ("card", card)):
        logits, c1 = model.forward_prefill(prompt.to(model.embed.device))
        big = model.cache_struct(1, prompt_len + decode_steps + 1)
        for key, layer in c1.items():
            for n, t in layer.items():
                if n in ("k", "v"):
                    big[key][n][:, :, :prompt_len] = t
                else:                                    # a Mamba state, whole
                    big[key][n].copy_(t)
        caches[name] = (logits, big)
    token = compare("prefill", caches["card"][0], caches["host"][0])
    for step in range(decode_steps):
        pos = prompt_len + step
        tok = torch.tensor([[token]])
        hl, _ = host.forward_decode(tok, caches["host"][1], pos)
        cl, _ = card.forward_decode(tok.to(device), caches["card"][1], pos)
        token = compare(f"decode {step}", cl, hl)
    for key, layer in caches["host"][1].items():
        for n, want in layer.items():
            if n not in ("k", "v"):
                err, atol = close(f"state {key}.{n}", caches["card"][1][key][n], want)
                log(f"  state {key}.{n} after decode: max|card-host| {err:.3e} (atol {atol:.3e})")
    torch.cuda.synchronize()
    want = expected_launches(cfg, forwards=1 + decode_steps, prefills=1)   # card only
    got = kernel_launches()
    if got != want:
        raise AssertionError(f"card launches {got}, expected {want}")
    del host, card, caches
    return worst


def phase_serve(device, arch, seed, n_requests, slots, max_ctx, max_new):
    """``arch`` (a name or a config) behind ``BatchedServer`` on the card:
    seeded prompts of 32-192 tokens, greedy decoding, with the kernels'
    launch counts held to :func:`expected_launches`."""
    import numpy as np
    import torch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.serve import BatchedServer, Request

    t0 = time.perf_counter()
    before = torch.cuda.memory_allocated()
    server = BatchedServer(arch, batch_slots=slots, max_ctx=max_ctx, seed=seed,
                           device=device)
    torch.cuda.synchronize()
    log(f"  built {server.cfg.name} ({server.model.n_params():,} params, "
        f"{server.cfg.n_layers} layers) in {time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card, "
        f"{before / 2**30:.2f} GiB of it allocated before the build")
    rng = np.random.default_rng(seed)
    lengths = rng.integers(32, 193, size=n_requests)
    requests = [Request(rid, rng.integers(4, server.cfg.vocab, size=int(n)).astype(np.int32), max_new)
                for rid, n in enumerate(lengths)]
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    t0 = time.perf_counter()
    for r in requests:
        server.submit(r)
    decode_ms = []
    while server.queue or any(s is not None for s in server.slots):
        prefills = flash_attention.launches
        t = time.perf_counter()
        server.step()
        torch.cuda.synchronize()
        if flash_attention.launches == prefills:      # a tick with no admission
            decode_ms.append((time.perf_counter() - t) * 1e3)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel_launches()
    peak = torch.cuda.max_memory_allocated()

    n_prefills = len(requests)
    want = expected_launches(server.cfg, forwards=n_prefills + server.decode_steps,
                             prefills=n_prefills)
    if launches != want:
        raise AssertionError(f"serving launches {launches}, expected {want}")
    if len(server.completed) != n_requests:
        raise AssertionError(f"{len(server.completed)} of {n_requests} requests completed")
    for r in server.completed:
        toks = np.asarray(r.tokens_out)
        if len(toks) != max_new or toks.min() < 0 or toks.max() >= server.cfg.vocab:
            raise AssertionError(f"request {r.rid}: tokens {r.tokens_out}")
    n_tokens = sum(len(r.tokens_out) for r in server.completed)
    ttft = sorted(r.first_token_s * 1e3 for r in server.completed)
    log(f"  prompt lengths {lengths.tolist()}, {max_new} new tokens each, {slots} slots, "
        f"max_ctx {max_ctx}")
    log(f"  served {n_requests} requests, {n_tokens} tokens in {wall:.3f} s "
        f"({n_tokens / wall:.1f} tok/s), {server.decode_steps} decode steps")
    log(f"  time to first token ms: min {ttft[0]:.1f} median {float(np.median(ttft)):.1f} "
        f"max {ttft[-1]:.1f} (from submission; all {n_requests} submitted at once)")
    log(f"  decode-only ticks: {len(decode_ms)}, median {float(np.median(decode_ms)):.3f} ms, "
        f"min {min(decode_ms):.3f} ms")
    log(f"  peak memory {peak / 2**30:.2f} GiB ({peak} bytes)")
    log(f"  launches: {json.dumps(launches)} (expected {json.dumps(want)})")
    log(f"  first request's tokens: {server.completed[0].tokens_out}")
    return server, launches, [int(n) for n in lengths]


def profile_serving(server, rng, n_requests, prompt_len, max_new):
    """Device busy share and kernel time by name over a short serving run
    (prefills and decode steps), from ``torch.profiler``."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.serve import Request

    for rid in range(n_requests):
        prompt = rng.integers(4, server.cfg.vocab, size=prompt_len).astype(np.int32)
        server.submit(Request(1000 + rid, prompt, max_new))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        server.drain()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    log_device_time(prof, wall_ms, f"profiler over {n_requests} requests x {max_new} tokens "
                    f"({prompt_len}-token prompts)", top=8)


def build_all(libraries) -> float:
    """Build every kernel library at once (one nvcc per source, all started
    together); print each one's register and shared-memory use."""
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libraries)) as pool:
        futures = [pool.submit(lib.load) for lib in libraries]
        for f in futures:
            f.result()
    elapsed = time.perf_counter() - t0
    for lib in libraries:
        log(f"build: {lib.library_path().relative_to(ROOT)}")
        for line in lib.build_log.splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                log(f"  ptxas: {line.strip()}")
    return elapsed


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
    import dataclasses

    import numpy as np
    from repro_torch import resolve_device
    from repro_torch.configs import get_config
    from repro_torch.core import ContainerDim, allocate, oracle_models
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.rmsnorm import ops as rmsnorm_ops
    from repro_torch.kernels.ssm_scan import ops as ssm_ops
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

    timings["build"] = build_all([build.LIBRARY, rmsnorm_ops.LIBRARY, flash_ops.LIBRARY,
                                  ssm_ops.LIBRARY])
    log(f"build: {timings['build']:.1f} s for 4 libraries")

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
    log(f"batch 1: {json.dumps(t_b1)}")

    seed = 0
    serve_rng = np.random.default_rng(seed)
    prompt_lengths = sorted({int(n) for n in serve_rng.integers(32, 193, size=8)})
    t0 = time.perf_counter()
    log("phase 4: rmsnorm and flash_attention kernels vs plain at llama3-8b's shapes")
    d = LLAMA["d"]
    rms_err = check_rmsnorm(device, [(1, S, d) for S in prompt_lengths] + [(4, 1, d), (300, d)])
    flash_err = check_flash(
        device,
        [(S, LLAMA["H"], LLAMA["KV"], LLAMA["hd"], True, None) for S in (1, 7, 128, 130, 192)]
        + [(S, LLAMA["H"], LLAMA["KV"], LLAMA["hd"], True, None) for S in prompt_lengths]
        + [(130, LLAMA["H"], LLAMA["KV"], LLAMA["hd"], True, 32),
           (130, LLAMA["H"], LLAMA["KV"], LLAMA["hd"], False, None),
           (7, LLAMA["H"], LLAMA["KV"], LLAMA["hd"], False, None),
           (130, 32, 8, 120, True, None)],
    )
    timings["phase4"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    log("phase 5: card vs host, llama3-8b at full width, 2 layers")
    two_layers = dataclasses.replace(get_config("llama3-8b"), n_layers=2)
    logit_err = phase_card_vs_host(device, two_layers, prompt_len=48, decode_steps=4, seed=seed)
    torch.cuda.empty_cache()
    timings["phase5"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    log("phase 6: serve llama3-8b at full depth (BatchedServer, 4 slots, max_ctx 256)")
    server, lm_launches, lengths = phase_serve(device, "llama3-8b", seed, n_requests=8, slots=4,
                                               max_ctx=256, max_new=16)
    timings["phase6"] = time.perf_counter() - t0
    log("profile: where serving time goes (4 requests x 16 tokens, 128-token prompts)")
    profile_serving(server, serve_rng, n_requests=4, prompt_len=128, max_new=16)
    del server
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    log("timing rmsnorm and flash_attention at the serving path's shapes "
        "(device time from CUDA-graph replay; eager time from CUDA events)")
    t_rms_prefill = time_rmsnorm(device, (1, max(lengths), d))
    t_rms = time_rmsnorm(device, (4, 1, d))
    t_flash_at = {S: time_flash(device, S) for S in sorted(set(lengths))}
    t_flash = t_flash_at[max(lengths)]
    timings["lm_timing"] = time.perf_counter() - t0
    n_attn = block_counts(get_config("llama3-8b"))["attn"]
    log("flash launches x (time - bound) in phase 6: "
        f"{excess_ms([(n_attn, t_flash_at[S]) for S in lengths]):.3f} ms")
    log(f"rmsnorm at the longest prefill (1, {max(lengths)}, {d}): {json.dumps(t_rms_prefill)}")

    t0 = time.perf_counter()
    log("phase 7: ssm_scan kernel vs plain at jamba-1.5-large's shapes")
    D, N = JAMBA["D"], JAMBA["N"]
    scan_err = check_ssm_scan(
        device,
        [(1, S, D, N, torch.float32) for S in sorted(set(lengths)) + [1, 7, 130]]
        + [(4, 1, D, N, torch.float32), (1, 130, D, N, torch.bfloat16)],
    )
    timings["phase7"] = time.perf_counter() - t0

    # one full-width period of jamba-1.5-large with its MoE layers made
    # dense (each a SwiGLU of the expert's width), built with replace and
    # never registered as an arch
    cut = dataclasses.replace(get_config("jamba-1.5-large-398b"), n_experts=0,
                              experts_per_token=0, n_layers=8,
                              name="jamba-1.5-large-398b/1-period-dense")
    t0 = time.perf_counter()
    log("phase 8: card vs host, jamba-1.5-large at full width, one Mamba and one attention block")
    pair = dataclasses.replace(cut, n_layers=2, block_pattern=("mamba", "attn"),
                               name="jamba-1.5-large-398b/mamba+attn-dense")
    hybrid_err = phase_card_vs_host(device, pair, prompt_len=48, decode_steps=4, seed=seed)
    timings["phase8"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    log("phase 9: serve one full-width period of jamba-1.5-large with dense MLPs "
        "(BatchedServer, 4 slots, max_ctx 256)")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    server, jamba_launches, _ = phase_serve(device, cut, seed, n_requests=8, slots=4,
                                            max_ctx=256, max_new=16)
    jamba_ticks = server.decode_steps
    timings["phase9"] = time.perf_counter() - t0
    log("profile: where serving time goes (4 requests x 16 tokens, 128-token prompts)")
    profile_serving(server, serve_rng, n_requests=4, prompt_len=128, max_new=16)
    del server
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    log("timing ssm_scan at the serving path's shapes "
        "(device time from CUDA-graph replay; eager time from CUDA events)")
    t_scan_at = {S: time_ssm_scan(device, 1, S) for S in sorted(set(lengths))}
    t_scan_prefill = t_scan_at[max(lengths)]
    t_scan = time_ssm_scan(device, 4, 1)
    timings["ssm_timing"] = time.perf_counter() - t0
    n_mamba = block_counts(cut)["mamba"]
    prefill_excess = excess_ms([(n_mamba, t_scan_at[S]) for S in lengths])
    decode_excess = excess_ms([(n_mamba * jamba_ticks, t_scan)])
    log(f"ssm_scan launches x (time - bound) in phase 9: prefills {prefill_excess:.3f} ms, "
        f"decode ticks {decode_excess:.3f} ms, total {prefill_excess + decode_excess:.3f} ms")
    log(f"ssm_scan at the longest prefill (1, {max(lengths)}, {D}, {N}): {json.dumps(t_scan_prefill)}")
    log("phase wall times: " + " ".join(f"{k} {v:.1f}s" for k, v in timings.items()))
    log(f"card vs host: max|logit difference| llama3-8b {logit_err:.3e}, "
        f"jamba mamba+attn {hybrid_err:.3e}")

    kernels = [
        dict(name="stream_flow_ell", route="cuda",
             source="src/repro_torch/kernels/stream_flow/csrc/stream_flow.cu",
             replaces="src/repro/kernels/stream_flow/stream_flow.py:94",
             launches=launches, max_abs_err=max_err, **t_b32),
        dict(name="rmsnorm", route="cuda",
             source="src/repro_torch/kernels/rmsnorm/csrc/rmsnorm.cu",
             replaces="src/repro/kernels/rmsnorm/rmsnorm.py:23",
             launches=lm_launches["rmsnorm"], max_abs_err=rms_err, **t_rms),
        dict(name="flash_attention", route="cuda",
             source="src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention/flash_attention.py:89",
             launches=lm_launches["flash_attention"], max_abs_err=flash_err, **t_flash),
        dict(name="ssm_scan", route="cuda",
             source="src/repro_torch/kernels/ssm_scan/csrc/ssm_scan.cu",
             replaces="src/repro/kernels/ssm_scan/ssm_scan.py:63",
             launches=jamba_launches["ssm_scan"], max_abs_err=scan_err, **t_scan),
    ]
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
