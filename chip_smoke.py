#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``src/repro_torch``).

Builds the seven CUDA kernel libraries from ``src/repro_torch/kernels/*/csrc``
into ``build/kernels/``, with an empty kernel of its own beside them (one
``nvcc`` per source, all at once), then:

1. holds the flow-step kernel against its plain PyTorch version on the
   card, on seeded random problems (up to I = 4096, K = 2048, over the 48
   KB a block gets without opting in) and on the padded arrays of a
   20,000-ktps ``deep_pipeline`` allocation, and checks that the
   allocation's row gives bit-equal results alone, inside a batch of 32,
   padded to larger I/K/E/D and at two forced cluster sizes; holds the
   per-container sum kernel to its plain version, bit for bit on the host
   and across padding; and holds the fixed-order axis sums (the dense
   tick's and the summary's) to theirs, bit for bit at the dense tick's
   shape and padded beyond it;
2. drives the paper's workflow on ``deep_pipeline`` through the port's
   entry points: profile a test deployment (``training_sweep``), fit node
   models, predict three unseen packings and measure them, allocate for
   20,000 ktps, and measure the allocation with the dense and the sparse
   tick (which must agree);
3. scores a batch of 32 candidate configurations around the allocation
   with the sparse tick in summary mode;
3b. runs the allocation at two bucket settings on each tick, in full and
   in summary mode, and requires its samples and its summary to be bit for
   bit equal on both ticks;
3c. submits phase 3's candidates, duplicates mixed in, through
   ``SimulatorEvaluator`` on the sparse tick and requires its dedup, result
   cache, resident batches and trajectory refetch to be bit for bit the
   uncached path; then drives a 24-step diurnal day of ``deep_pipeline``
   (6,700 ktps base, about 20,000 at the peak) through ``ControlLoop`` with
   ``HybridPolicy`` and with a learning ``PredictivePolicy`` on that
   evaluator, and requires every step to deploy a configuration and the
   flow kernel to run; then a 24-step diurnal day of ``adanalytics``, whose
   flow LPs take milliseconds, through a ``PredictivePolicy`` learning with
   the default calibration batch on a simulator whose stream managers cost
   2.5x what the models assume, and requires the loop's own calibration
   flushes to raise the version that keys the result cache and some steps
   after it not to breach.  Phase 3c's launches of the three stream
   kernels are counted by input shape apart from phases 2-3's, each kernel
   is held against its plain version and timed at every one of those
   shapes, and the engine's caches are emptied before phase 3d;
3d. drives the fleet on ``SimulatorEvaluator`` on the card: the three
   tenants of ``examples/fleet_demo.py`` for its 24 steps through
   ``FleetLoop`` (the guaranteed tenant meets its SLA on every step, the
   best-effort one is shed on every squeezed step, a replan is proactive,
   warm replans move fewer containers than cold ones would restart), then
   the same day with the controller crashed after step 12 and restarted
   from its checkpoint, whose events must equal the uninterrupted run's;
   N+1 on the demo cluster through a host failure with no guaranteed
   breach; and 999 tenants (333 copies of the trio at seeded rates) on
   1,998 hosts for 1 step with N+1 for the guaranteed tier, each step's
   measurement one call with one row per admitted tenant, 64 of its rows
   equal on the host (rel 1e-5) and uncached on the card (bit for bit).
   Its stream-kernel launches are counted by shape on recorders of their
   own, and each kernel is held to its plain version and timed at each
   shape;
3e. runs the real operators on the card: ``run_dag`` on wordcount,
   adanalytics and mobile_analytics at the reference's defaults and with
   their sources at 2^20 tuples a batch (per-node microseconds per tuple
   logged), and each DAG on card and host with one source of the same
   seeded batches (ints and bools bit for bit, floats to rel 1e-5);
   ``ExecutorEvaluator()`` over the fleet demo trio's candidates (each DAG
   calibrated once, a resubmission served from the result cache, a model
   version bump a miss) and ``fold_executor_timings`` into a card
   ``SimulatorEvaluator``, whose stream-kernel launches are counted on
   recorders of their own and checked and timed by shape; and the batched
   simplex ``torch_linprog`` against numpy's ``linprog`` (the seeded suite,
   a 24 x 16 LP batched 256 ways, deep_pipeline's flow LPs at 500-3,000
   ktps at B = 1 and 32 in float64 and float32, ``maxiter`` stepped to
   optimal) and ``fit_many_torch`` against numpy's least squares;
4. holds the RMSNorm kernels (the norm alone, and fused with the residual
   add before it) and the flash-attention kernel against their plain
   versions at llama3-8b's and jamba's shapes (fp32 and bf16 RMSNorm, an
   odd width and an unaligned view; the fused norm bit for bit the norm of
   ``x + delta``; causal, windowed and non-causal attention, head_dim 128
   and 120), and flash at the shapes of phases 11 and 12: seamless's
   encoder (512 frames, non-causal), its decoder's causal prefill and its
   cross-attention (each prompt length against the 512 frames as keys),
   and internvl2's causal prefill at 256 + each prompt length; and the
   MoE and MLA models' shapes: flash at olmoe's (16/16 heads), mixtral's
   (32/8, window 4096) and minicpm3's prefills (40 heads, q and k at 96, v
   at 64 zero-padded to 96: the padded columns exactly zero, the rest
   attention with v at its own width) and minicpm3's attention split over
   the keys of 16 'model' ranks as its sharded prefill and training run it
   (each rank's two key chunks through the flash kernel at their key
   offsets, the partial softmaxes combined, each rank's backward with the
   combined statistics) against the flash kernels over the whole keys,
   rmsnorm at MLA's latent widths 768
   and 256, add_rmsnorm at d 2048 and 2560; xlstm-1.3b's: rmsnorm at d 2048
   and mLSTM's inner 2732 (serving's and training's rows), add_rmsnorm at
   2048, and both RMSNorm backward kernels (the norm alone, and after the
   residual add) against autograd through the plain versions at training's
   shapes, serving's, one bf16 case and an odd width, and at a few rows of
   every width their register path takes (256, 768, 1024, 2560, 3840,
   4096, 6144 and 8192 in fp32, 8192 in bf16);
5. runs a 2-layer llama3-8b at full width with the same seeded weights on
   the card and on the host, one prefill and 4 decode steps, and compares
   the logits;
6. serves 8 seeded requests (32-192-token prompts, 16 new tokens each)
   with the full 32-layer llama3-8b behind ``BatchedServer`` on the card,
   and holds the kernels' launch counts to one flash launch per layer per
   prefill and, per forward, one RMSNorm launch and 2 x 32 fused
   add-and-RMSNorm launches;
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
   counts to 7 selective scans, 1 RMSNorm and 16 fused add-and-RMSNorms
   per forward and one flash launch per prefill;
10. runs 2 encoder and 2 decoder layers of seamless-m4t-large-v2 at full
   width on the card and on the host with seeded non-zero frame
   embeddings, one prefill and 4 decode steps, and compares logits,
   ``cross_kv`` and greedy tokens;
11. serves phase 6's prompt lengths with seamless-m4t-large-v2 at full
   width and depth (24 + 24 layers, 2,035,935,232 parameters) behind
   ``BatchedServer`` (zero frames, as the server feeds), and holds the
   launch counts to 24 encoder, 24 causal and 24 cross flash launches,
   2 RMSNorm and 120 fused add-and-RMSNorm launches per prefill and 1 and
   72 per decode step;
12. serves the same prompts with 8 of internvl2-26b's 48 layers at full
   width behind its 256 zero frontend tokens, with 8 causal flash
   launches per prefill at 256 + the prompt's length;
14. runs 2 layers at full width of olmoe-1b-7b, mixtral-8x7b and
   minicpm3-4b on the card and on the host, one prefill and 4 decode steps
   each, and compares logits, every cache (K/V, MLA's ``c_kv`` and
   ``k_rope``) and greedy tokens; an MoE model's expert ids must be equal
   wherever the host's router margin (the k-th minus the (k+1)-th
   probability) is above 1e-5 (the tie rule: ``check_routing``);
15. serves phase 6's prompt lengths with olmoe-1b-7b at full width and
   depth (16 layers, 64 experts top-8, 6,919,096,320 parameters), with 16
   flash launches per prefill and 1 RMSNorm and 32 fused add-and-RMSNorm
   launches per forward, logging each prefill's dropped share;
16. serves them with 8 of mixtral-8x7b's 32 layers at full width (8
   experts top-2, window 4096; 11,872,309,248 parameters), 8 flash
   launches per prefill;
17. serves them with minicpm3-4b at full width and depth (62 MLA layers;
   4,262,025,728 parameters), 62 flash launches per prefill and, per
   forward, 1 + 2 x 62 RMSNorm launches (the latent norms) and 124 fused
   add-and-RMSNorm launches;
18. (run after 17) runs one full-width period of xlstm-1.3b (8 layers: 7
   mLSTM, 1 sLSTM; 395,082,532 parameters) on the card and on the host, a
   48-token and a 256-token prefill (two mLSTM chunks) with 4 decode steps
   each, and compares logits, every state (``C``, ``n``; ``h``, ``c``,
   ``n``, ``m``) and greedy tokens;
19. serves phase 6's prompt lengths with xlstm-1.3b at full width and depth
   (48 layers, 1,340,259,032 parameters), 49 RMSNorm and 48 fused
   add-and-RMSNorm launches per forward, no flash, no scan;
20. (a) one training forward and backward of that period on the card and
   on the host from the same weights and one synthetic batch (2 x 256):
   the loss within rel 1e-5 and every gradient within 1e-4 of its leaf's
   largest host entry, the backward through both backward kernels; (b)
   trains xlstm-1.3b whole on the card for 6 steps (4 x 256 tokens a
   step) with finite losses and gradient norms and the norms' forward and
   backward launches per step held to 49 and 48 each, printing the step
   walls, the device busy time of the last step (under the profiler) and
   the peak memory, then the same run
   checkpointed every 4 steps under ``build/``, crashed after step 5 and
   restarted under ``run_with_restarts``, its losses equal to the
   uninterrupted run's within rel 1e-5; (c) requires the card-training
   guard to refuse, with ``ValueError`` and before anything is built,
   256-wide attention heads (a 2-layer llama3-8b at d_model 8192, an MLA
   head of 160) and a 32-wide SSM state, and every registered
   architecture to pass it;
21. (run after 20) holds the flash-attention and selective-scan backward
   kernels to their plain versions (each gradient within 1e-4 of its
   largest entry, bf16 plus one ulp of it; a second launch bit for bit the
   first) at the training shapes below, a window narrower than S,
   seamless's cross-attention (S 168, Sk 512), MLA's padded v (40 heads,
   width 96), a masked channel tail and bf16, each both as training runs
   it (from the forward's row statistics or range-start states, the
   forward that writes them bit for bit serving's) and without them (the
   wrapper runs that forward first; the same bits), and times each as training
   runs it beside its plain version, its bound (flash: the faster of fp32
   and 3xTF32 products, against the bytes) and (flash) autograd's
   backward of SDPA; (a)
   one training forward and backward card vs host from the same weights
   of stablelm-1.6b cut to 2 layers (2 x 256) and, right after phase 8 on
   its two models, of the jamba pair (1 x 128): the loss within rel 1e-5,
   every gradient within 1e-4 of its leaf's largest host entry; (b) trains
   stablelm-1.6b whole (1,644,267,520 parameters) through ``train()`` for
   4 steps of 4 x 256, twice, and (c) the jamba pair (2,869,829,632
   parameters) through
   ``build_model``, ``init_opt_state`` and ``make_step`` likewise: finite
   losses and gradient norms, the second run bit for bit the first, and
   per step one backward launch for each forward launch of the norms,
   flash (24 a step for stablelm) and the scan;
22. (run after 21) drives the sharded steps (``repro_torch.launch.steps``)
   on a (1, 1) ``("data", "model")`` mesh over a NCCL process group of one
   rank (a ``FileStore`` in a temporary directory): (b) stablelm-1.6b
   whole in fp32, ``make_step`` for 2 steps of 21 (b)'s first two batches,
   its parameters copied to the host, then the train bundle (remat "none")
   for the same 2 steps from the same seed-0 parameters: losses within rel
   1e-6 (bit for bit reported), every parameter within 1e-5 of its leaf's
   largest entry, both runs' launches those of 2 training steps (24 flash
   forward and 24 backward a step, the norms and their backward kernels:
   the kernels ran on the local shards through ``local_map``), each peak
   under 75 GiB; (c) the prefill and decode bundles against the unsharded
   ``forward_prefill`` and ``forward_decode`` on 4 of phase 6's seeded
   prompts and 8 greedy steps: logits over the real vocabulary and caches
   within rtol 1e-4, atol 1e-4 x max, the padded vocabulary's masked
   logits bit for bit, tokens equal; (d) ``gqa_decode_seqsharded`` at
   stablelm's widths against ``gqa_decode`` (1e-5 of the largest entry)
   and ``topk_allreduce`` against ``topk_decompress(topk_compress(...))``
   bit for bit; (e)-(j) the checks of (b) and (c), the first step's
   gradients within 1e-5 of each leaf's largest entry too, for olmoe-1b-7b
   at 2 layers, the jamba pair, an xlstm-1.3b period, minicpm3-4b at 2
   layers (MLA), seamless-m4t-large-v2 at 8 + 8 layers (encoder-decoder,
   512 frames) and internvl2-26b at 2 layers (256 patch tokens before the
   text), the frontend models with ``train.frontend_noise`` embeddings,
   and for (i) the train bundle again with remat "full" (each decoder
   block and encoder layer recomputed in the backward): losses and
   first-step gradients bit for bit the remat "none" run's, both peaks
   printed;
   it prints the step walls of both, the DTensor path's host overhead, the
   peaks and the launches.  One card shows the DTensor path and its
   kernels, not the collectives of several ranks; (b) and (f) also count
   one more step (``launch/counting.py``) for phase 23;
23. (run after 22, its NCCL group destroyed) dry-runs 22 (b)'s cell on a
   fake process group of one rank (``launch/dryrun.py``: fake CUDA
   tensors, the kernels' stand-ins, nothing launched) and holds its FLOPs
   to that counted step's (rel 1e-6), printing the dry run's peak beside
   the card step's, counted and by ``max_memory_allocated`` less the
   memory before it, the roofline's terms beside the measured step and the
   LM bridge's tokens/s beside the measured; dry-runs 22 (f)'s cell (the
   jamba pair) the same way, its FLOPs reported beside the card's and its
   three peaks printed; then dry-runs llama3-8b x
   decode_32k on the 16x16 production mesh of a fake group of 256 ranks,
   which must report ok;
13. (run after 22) builds the LM bridge's workload model of each served
   model (2N FLOPs and the fp32 parameter bytes over the slots per token)
   and prints its predicted one-card decode rate beside the measured one
   for phases 6, 9, 11, 12, 15-17 and 19; runs
   ``allocate_chips`` at 1e4, 1e5 and 1e6 tok/s, ``ElasticController``
   over ``examples/serve_lm.py``'s spike day, and ``FleetElasticController``
   over the fleet demo's trio on a card ``SimulatorEvaluator`` for 6
   steps, whose events must equal a ``FleetLoop``'s driven directly;

and times each kernel, its plain version and, where there is one, the
PyTorch call that computes the same function at the main paths' shapes,
beside the empty kernel's launch (the floor of any kernel's time); the
norms at prefill shapes over input sets that miss L2, as in serving.  The
three stream kernels' launches in phases 2-3 are counted by input shape, and
each is timed at every one of those shapes (phase 3c's likewise, on their
own); every kernel's launches x (time - bound) over its paths is printed,
largest first.  After phases 6, 9, 11, 12, 15-17 and 19 the profiler counts
the kernel launches of one decode forward; each serving phase logs its decode
floor (the weights and caches a decode step reads, over 3.35 TB/s).
Any failed phase raises and the script exits non-zero.  The last line is a
JSON object with ``"ok": true`` and the device; the line before it lists
each kernel with its launches on the main paths, its error against the
plain version, its times and its bound.

Needs one CUDA card and about 45 GB of free disk under ``build/`` (phase
20 (b)'s two checkpoints of about 21.4 GB, removed when the phase ends).
Phase 21 (c) holds about 57.4 GB of training state on the card.
Run from the root of the repository:  python3 chip_smoke.py
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import itertools
import json
import math
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
#: H100 SXM dense TF32 tensor-core peak (data sheet), for flash's 3xTF32 bound.
TF32_FLOPS_PER_S = 495e12
#: expf throughput of the special-function units (16 per clock per SM,
#: 132 SMs, 1.98 GHz boost), logged beside the selective scan's bound.
SFU_PER_S = 16 * 132 * 1.98e9
#: H100 SXM L2 (data sheet).  A norm's timing at prefill cycles through
#: input sets that move three L2s between two calls on one set, so each
#: call reads its inputs from HBM as in serving, where the projections
#: before a norm stream far more than L2 of weights.
L2_BYTES = 50 * 2**20

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


def padded_structures(configs, params, buckets=None):
    """Each configuration's structure padded as the sparse tick pads a batch
    of them, or to ``buckets`` = (I, K, E, D_out, D_in), with its stream
    managers' budget per tick; and the structures."""
    import numpy as np
    from repro_torch.streams import (
        bucket_size, degree_bucket_size, edge_bucket_size, pad_structure,
        structure_for,
    )

    sts = [structure_for(c, params) for c in configs]
    if buckets is None:
        buckets = (
            bucket_size(max(s.n_inst for s in sts)),
            bucket_size(max(s.n_cont for s in sts)),
            edge_bucket_size(max(s.n_edges for s in sts)),
            degree_bucket_size(max(s.d_out for s in sts)),
            degree_bucket_size(max(s.d_in for s in sts)),
        )
    arrays = []
    for s in sts:
        a = pad_structure(s, *buckets)
        a["sm_budget"] = (params.dt / np.maximum(a["sm_cost_eff"], 1e-9)).astype(np.float32)
        arrays.append(a)
    return arrays, sts


def stage_rows(arrays, device):
    import numpy as np
    from repro_torch.interop import stage_padded
    return stage_padded({k: np.stack([a[k] for a in arrays]) for k in arrays[0]}, device)


def padded_flow_problem(configs, params, rng, device):
    """The flow-step inputs of a batch of configurations, padded as the
    sparse tick pads them, with a seeded random ``qout``."""
    import numpy as np

    arrays, _ = padded_structures(configs, params)
    for a in arrays:
        a["qout"] = (rng.uniform(0.0, 5.0, a["inst_mask"].shape[0]) * a["inst_mask"]).astype(np.float32)
    return stage_rows(arrays, device)


KERNEL_ARGS = (
    "qout", "edge_src", "edge_share", "edge_remote", "edge_src_cont",
    "edge_dst_cont", "ell_src", "ell_dst", "cont_of", "sm_budget",
)
SEGMENT_ARGS = (
    "qout", "edge_src", "edge_dst", "edge_share", "edge_remote",
    "edge_src_cont", "edge_dst_cont", "sm_budget",
)


def check_kernel(name, p) -> float:
    """Kernel vs plain version (and vs the segment-sum contract, where ``p``
    holds the edge list it needs) on the same inputs; returns the largest
    absolute difference to the plain version."""
    import torch
    from repro_torch.kernels.stream_flow import (
        stream_flow_ell, stream_flow_ell_reference, stream_flow_reference,
    )

    args = [p[k] for k in KERNEL_ARGS]
    got = stream_flow_ell(*args)
    plain = stream_flow_ell_reference(*args)
    seg = (None,) * 3
    if all(k in p for k in SEGMENT_ARGS):
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
        if sref is not None:
            torch.testing.assert_close(out, sref, rtol=SEGMENT_RTOL, atol=SEGMENT_ATOL)
        worst = max(worst, float(err.max()))
    log(f"  {name}: B={p['qout'].shape[0]} I={p['qout'].shape[1]} "
        f"K={p['sm_budget'].shape[1]} E={p['edge_src'].shape[1]} "
        f"D=({p['ell_src'].shape[2]},{p['ell_dst'].shape[2]}) max|kernel-plain|={worst:.3e}")
    return worst


def members_of(p):
    """The container member lists of a staged problem, built once, as the
    simulator builds them once per run."""
    from repro_torch.kernels.stream_flow import container_members
    return container_members(p["cont_of"], p["sm_budget"].shape[1])


def phase_bitwise(device, params, alloc_config, others, rng) -> None:
    """One allocation row alone, the same row inside a batch of 32, the same
    row padded to larger I/K/E/D, and the row alone at two forced cluster
    sizes: the kernel's delivered, arrivals and trav_c must be bit-equal
    over the real instances and containers."""
    import numpy as np
    import torch
    from repro_torch.kernels.stream_flow import stream_flow_ell

    configs = [alloc_config] + list(others)
    arrays, sts = padded_structures(configs, params)
    qouts = [rng.uniform(0.0, 5.0, s.n_inst).astype(np.float32) for s in sts]

    def with_qout(arrays, qouts):
        for a, q in zip(arrays, qouts):
            a["qout"] = np.zeros(a["inst_mask"].shape[0], np.float32)
            a["qout"][: q.shape[0]] = q
        return stage_rows(arrays, device)

    def run(p, **kw):
        return stream_flow_ell(*[p[k] for k in KERNEL_ARGS], *members_of(p), **kw)

    single_arrays, _ = padded_structures(configs[:1], params)
    single = with_qout(single_arrays, qouts[:1])
    I, K, E = single["qout"].shape[1], single["sm_budget"].shape[1], single["edge_src"].shape[1]
    bigger = (I + 512, K + 512, E + 8192, 2 * single["ell_src"].shape[2], 2 * single["ell_dst"].shape[2])
    padded_arrays, _ = padded_structures(configs[:1], params, buckets=bigger)
    padded = with_qout(padded_arrays, qouts[:1])
    batch = with_qout(arrays, qouts)
    alone = run(single)
    runs = {
        f"in the batch of {len(configs)} (I={batch['qout'].shape[1]})": run(batch),
        "padded to (I, K, E, D_out, D_in) = " + str(bigger): run(padded),
        "at cluster size 1": run(single, cluster_size=1),
        "at cluster size 4": run(single, cluster_size=4),
    }
    torch.cuda.synchronize()
    n_inst, n_cont = sts[0].n_inst, sts[0].n_cont
    for label, outs in runs.items():
        for got, want, n, name in zip(outs, alone, (n_inst, n_inst, n_cont),
                                      ("delivered", "arrivals", "trav_c")):
            if not torch.equal(got[0, :n], want[0, :n]):
                diff = float((got[0, :n] - want[0, :n]).abs().max())
                raise AssertionError(f"bitwise: {name} {label} differs from the row alone by up to {diff:.3e}")
        log(f"  bitwise: the allocation row {label}: equal to the row alone")


def recorder_key(p) -> tuple:
    B, I = p["qout"].shape
    return (B, I, p["sm_budget"].shape[1], p["edge_src"].shape[1],
            p["ell_src"].shape[2], p["ell_dst"].shape[2])


def flow_key(args) -> tuple:
    """(B, I, K, E, D_out, D_in) of a ``stream_flow_ell`` call."""
    return recorder_key(dict(zip(KERNEL_ARGS, args)))


def sum_key(args) -> tuple:
    """(B, I, K) of a ``container_sum`` call (vals, cont_of, cont_ptr, ...)."""
    return (*args[0].shape, args[2].shape[1] - 1)


def ordered_key(args) -> tuple:
    """(B, R, L, dim, masked) of an ``ordered_sum`` call (x, dim[, mask])."""
    masked = len(args) > 2 and args[2] is not None
    return (*args[0].shape, args[1], masked)


class LaunchRecorder:
    """Stands in for one of the simulator's kernel wrappers during the main
    path: counts the kernel's launches by input shape (``key_of(args)``)
    and keeps each shape's first inputs for timing afterwards.  The count
    itself is the wrapper's, read from ``.launches``."""

    def __init__(self, fn, key_of):
        self.fn = fn
        self.key_of = key_of
        self.counts: dict[tuple, int] = {}
        self.inputs: dict[tuple, list] = {}

    def __call__(self, *args, **kwargs):
        before = self.fn.launches
        out = self.fn(*args, **kwargs)
        if self.fn.launches > before:
            key = self.key_of(args)
            self.counts[key] = self.counts.get(key, 0) + 1
            if key not in self.inputs:
                self.inputs[key] = [a.clone() if hasattr(a, "clone") else a for a in args]
        return out


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


def time_flow(label, p) -> dict:
    """The kernel (with the member lists built once, as the tick passes
    them), its plain version and the ``index_add_`` segment sums on one
    problem: device time from CUDA-graph replay, eager time beside it."""
    from repro_torch.kernels.stream_flow import (
        stream_flow_ell, stream_flow_ell_reference, stream_flow_reference,
    )
    args = [p[k] for k in KERNEL_ARGS]
    kernel_args = args + [*members_of(p)]
    seg_args = [p[k] for k in SEGMENT_ARGS]
    n_inst, n_cont = p["qout"].shape[1], p["sm_budget"].shape[1]
    ms, eager_ms = time_both(lambda: stream_flow_ell(*kernel_args), iters=100)
    plain_ms, plain_eager = time_both(lambda: stream_flow_ell_reference(*args), iters=20)
    library_ms, library_eager = time_both(
        lambda: stream_flow_reference(*seg_args, n_inst=n_inst, n_cont=n_cont), iters=20,
    )
    bound_ms, bound_by, nbytes, flops = flow_bound(p)
    log(f"  {label} device (graph): kernel {ms:.5f} ms  plain {plain_ms:.5f} ms  "
        f"index_add_ {library_ms:.5f} ms  bound {bound_ms:.6f} ms ({bound_by}: "
        f"{nbytes} B, {flops} flop); eager with launch cost: kernel {eager_ms:.5f}  "
        f"plain {plain_eager:.5f}  index_add_ {library_eager:.5f} ms")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by, eager_ms=eager_ms)


def time_recorded(key, inputs) -> dict:
    """The kernel and its plain version on the first inputs the main path
    gave it at one of its smaller shapes."""
    from repro_torch.kernels.stream_flow import stream_flow_ell, stream_flow_ell_reference
    p = dict(zip(KERNEL_ARGS, inputs))
    ms, eager_ms = time_both(lambda: stream_flow_ell(*inputs), iters=100)
    plain_ms, plain_eager = time_both(lambda: stream_flow_ell_reference(*inputs), iters=20)
    bound_ms, bound_by, _, _ = flow_bound(p)
    log(f"  B={key[0]} I={key[1]} K={key[2]} E={key[3]} D=({key[4]},{key[5]}) device (graph): "
        f"kernel {ms:.5f} ms  plain {plain_ms:.5f} ms  bound {bound_ms:.6f} ms ({bound_by}); "
        f"eager with launch cost: kernel {eager_ms:.5f}  plain {plain_eager:.5f} ms")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, eager_ms=eager_ms)


def sum_inputs(p, rng):
    """Per-instance values (zero on padded instances, as the tick's are) and
    the container lists of a staged problem."""
    import torch
    vals = torch.as_tensor(rng.uniform(0.0, 5.0, p["qout"].shape).astype("float32"),
                           device=p["qout"].device)
    return vals, p["cont_of"], *members_of(p)


def check_container_sum(name, args) -> float:
    """The per-container sum kernel against its plain version: bit for bit
    the plain version on the host (both add members in instance order
    from 0), and within rtol 1e-6 of the plain version on the card, whose
    ``index_add_`` adds in the order its atomics land.  Returns the largest
    difference to the plain version on the card."""
    import torch
    from repro_torch.kernels.stream_flow import container_sum, container_sum_reference

    vals, cont_of, cont_ptr, _ = args
    K = cont_ptr.shape[1] - 1
    got = container_sum(*args)
    plain = container_sum_reference(vals, cont_of, K)
    torch.cuda.synchronize()
    host = container_sum_reference(vals.cpu(), cont_of.cpu(), K)
    if not torch.equal(got.cpu(), host):
        diff = float((got.cpu() - host).abs().max())
        raise AssertionError(f"container_sum {name}: differs from the host's plain version by {diff:.3e}")
    torch.testing.assert_close(got, plain, rtol=1e-6, atol=1e-6 * float(plain.abs().max()))
    err = float((got - plain).abs().max())
    log(f"  container_sum {name}: B={vals.shape[0]} I={vals.shape[1]} K={K}: bit-equal to the "
        f"host's plain version; max|kernel-plain on the card|={err:.3e}")
    return err


def sum_bound(B, I, K) -> tuple[float, str]:
    """What the function must move: the values and one membership word per
    instance read once (B·I each), the sums (B·K) written once; B·I fp32
    additions.  The kernel's offsets into its member lists are its own
    choice of layout and are not counted."""
    nbytes = 4 * (2 * B * I + B * K)
    flops = B * I
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def time_container_sum(args) -> dict:
    """The kernel, its plain version and ``scatter_add_`` (one PyTorch call
    for the same sums, in the order its atomics land) on the same inputs."""
    import torch
    from repro_torch.kernels.stream_flow import container_sum, container_sum_reference

    vals, cont_of, cont_ptr, _ = args
    B, I = vals.shape
    K = cont_ptr.shape[1] - 1
    index = cont_of.long()
    out = torch.zeros(B, K, device=vals.device)
    ms, eager_ms = time_both(lambda: container_sum(*args), iters=200)
    plain_ms, plain_eager = time_both(lambda: container_sum_reference(vals, cont_of, K), iters=200)
    library_ms, library_eager = time_both(lambda: out.zero_().scatter_add_(1, index, vals), iters=200)
    bound_ms, bound_by = sum_bound(B, I, K)
    log(f"  container_sum B={B} I={I} K={K} device (graph): kernel {ms:.5f} ms  plain {plain_ms:.5f} ms  "
        f"scatter_add_ {library_ms:.5f} ms  bound {bound_ms:.6f} ms ({bound_by}); eager with launch "
        f"cost: kernel {eager_ms:.5f}  plain {plain_eager:.5f}  scatter_add_ {library_eager:.5f} ms")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                bound_by=bound_by)


def check_ordered_sum(name, args) -> float:
    """The fixed-order sum kernel against its plain version, bit for bit on
    the card and on the host (both add the same lanes in the same order with
    elementwise float32 adds).  Returns the largest difference (0.0)."""
    import torch
    from repro_torch.kernels.stream_flow import ordered_sum, ordered_sum_reference

    x, dim, mask = (list(args) + [None])[:3]
    got = ordered_sum(x, dim, mask)
    plain = ordered_sum_reference(x, dim, mask)
    torch.cuda.synchronize()
    host = ordered_sum_reference(x.cpu(), dim, None if mask is None else mask.cpu())
    for label, want in (("the plain version on the card", plain), ("the host's plain version", host)):
        if not torch.equal(got.cpu(), want.cpu()):
            diff = float((got.cpu() - want.cpu()).abs().max())
            raise AssertionError(f"ordered_sum {name}: differs from {label} by {diff:.3e}")
    log(f"  ordered_sum {name}: {tuple(x.shape)} dim {dim} {'masked' if mask is not None else 'unmasked'}: "
        f"bit-equal to the plain version on the card and on the host")
    return float((got - plain).abs().max())


def check_ordered_padding(name, x, dim, mask, pad) -> None:
    """``x`` (and ``mask``) with ``pad`` = (B, R, L) zeros appended: the sums
    of the real entries must be bit for bit those of ``x`` alone."""
    import torch
    from repro_torch.kernels.stream_flow import ordered_sum

    B, R, L = x.shape
    big = torch.zeros(B + pad[0], R + pad[1], L + pad[2], device=x.device)
    big[:B, :R, :L] = x
    big_mask = None
    if mask is not None:
        big_mask = torch.zeros(big.shape, dtype=torch.bool, device=x.device)
        big_mask[:B, :R, :L] = mask
    n = R if dim == 2 else L
    got = ordered_sum(big, dim, big_mask)[:B, :n]
    want = ordered_sum(x, dim, mask)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"ordered_sum {name}: padding by {pad} moved the sums by up to "
                             f"{float((got - want).abs().max()):.3e}")
    log(f"  ordered_sum {name}: padded by (B, R, L) = {pad}: bit-equal")


def ordered_bound(B, R, L, dim, masked) -> tuple[float, str]:
    """What the function must move: the tensor (and its one-byte mask) read
    once, the sums written once; one fp32 add per element (and one multiply
    when masked)."""
    n = B * R * L
    nbytes = 4 * n + (n if masked else 0) + 4 * B * (R if dim == 2 else L)
    flops = n * (2 if masked else 1)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def time_ordered_sum(args) -> dict:
    """The kernel, its plain version and ``torch.sum`` (the PyTorch calls
    for the same sums, in the order its reduction picks: one unmasked, the
    two ``torch.sum(x * mask, dim)`` masked) on the same inputs."""
    import torch

    from repro_torch.kernels.stream_flow import ordered_sum, ordered_sum_reference

    x, dim, mask = (list(args) + [None])[:3]
    ms, eager_ms = time_both(lambda: ordered_sum(x, dim, mask), iters=200)
    plain_ms, plain_eager = time_both(lambda: ordered_sum_reference(x, dim, mask), iters=20)
    if mask is None:
        library_ms, library_eager = time_both(lambda: x.sum(dim=dim), iters=200)
    else:
        library_ms, library_eager = time_both(lambda: torch.sum(x * mask, dim), iters=200)
    bound_ms, bound_by = ordered_bound(*x.shape, dim, mask is not None)
    lib = "torch.sum(x * mask)" if mask is not None else "torch.sum"
    log(f"  ordered_sum {tuple(x.shape)} dim {dim} {'masked' if mask is not None else 'unmasked'} "
        f"device (graph): kernel {ms:.5f} ms  plain {plain_ms:.5f} ms  {lib} {library_ms:.5f} ms  "
        f"bound {bound_ms:.6f} ms ({bound_by}); eager with launch cost: kernel {eager_ms:.5f}  "
        f"plain {plain_eager:.5f}  {lib} {library_eager:.5f} ms")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                bound_by=bound_by)


def phase_ordered_sum(device, rng) -> float:
    """The fixed-order sums at the dense tick's shape on the allocation
    (B = 1, I = 1024) and the summary's at phase 3's (32 rows, 80 samples,
    1024 instances), each with and without the mask, and padded beyond
    them (as phase 3b pads the allocation)."""
    import torch

    worst = 0.0
    for shape in ((1, 1024, 1024), (32, 80, 1024)):
        x = torch.as_tensor(rng.uniform(0.0, 5.0, shape).astype("float32"), device=device)
        mask = torch.as_tensor(rng.random(shape) < 0.5, device=device)
        for dim in (1, 2):
            for m in (None, mask):
                worst = max(worst, check_ordered_sum("random", [x, dim, m]))
        check_ordered_padding("random", x, 1, mask, (2, 512, 512))
        check_ordered_padding("random", x, 2, None, (1, 512, 512))
    return worst


EMPTY_SOURCE = """\
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int empty_kernel_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
"""


def empty_library():
    """A kernel that does nothing, built like the port's kernels: its
    device time under graph replay is the floor any kernel's time can
    approach.  Its source is written into the git-ignored build directory;
    it is a measuring stick of this script, not part of the port."""
    import ctypes
    from pathlib import Path
    from repro_torch.kernels._build import BUILD_DIR, KernelLibrary

    source = Path(BUILD_DIR) / "empty_kernel.cu"
    source.parent.mkdir(parents=True, exist_ok=True)
    if not source.is_file() or source.read_text() != EMPTY_SOURCE:
        source.write_text(EMPTY_SOURCE)

    def bind(lib):
        lib.empty_kernel_launch.argtypes = [ctypes.c_void_p]
        lib.empty_kernel_launch.restype = ctypes.c_int

    return KernelLibrary("empty_kernel", source, bind)


def time_empty_kernel(library) -> float:
    """Device time of a launch that does nothing, from CUDA-graph replay."""
    import torch
    lib = library.load()

    def empty_kernel():
        rc = lib.empty_kernel_launch(torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"empty kernel launch failed: CUDA error {rc}")

    ms, eager_ms = time_both(empty_kernel, iters=200)
    log(f"  empty kernel device (graph): {ms:.5f} ms; eager with launch cost {eager_ms:.5f} ms")
    return ms


def profiled_busy_ms(prof) -> float | None:
    """The device's busy time over a profiler window: its own events
    (kernels, copies, memsets), each counted once; None where the profiler
    recorded none."""
    from torch.autograd import DeviceType

    spans = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    return sum(spans) if spans else None


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

    import torch

    walls = {}
    t0 = time.perf_counter()

    def lap(name):
        nonlocal t0
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        t0 = time.perf_counter()

    dag = deep_pipeline()
    test_cfg = round_robin_configuration(dag, {n: 1 for n in dag.node_names}, 2, dim)
    store = training_sweep(test_cfg, np.linspace(25, 150, 6), params,
                           seconds_per_rate=sweep_s, device=device)
    lap("profile")
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
    lap("predict and measure 3 packings")
    result = allocate(dag, models, target, overprovision=1.1)
    st = structure_for(result.config, params)
    log(f"  allocation for {target:.0f} ktps: {st.n_inst} instances, "
        f"{st.n_cont} containers, {st.n_edges} edges, {result.total_cpus:.1f} cpus")
    lap("allocate")
    dense = measure_capacity(result.config, params, tick_kernel="dense", device=device)
    lap("measure dense")
    sparse = measure_capacity(result.config, params, tick_kernel="sparse", device=device)
    lap("measure sparse")
    log("  phase 2 walls: " + ", ".join(f"{k} {v:.3f} s" for k, v in walls.items()))
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


def phase_buckets(device, params, config, duration_s):
    """The allocation alone in its own buckets and padded to I = 1536,
    K = 1024 (and, on the sparse tick, E = 65,536, D = 512), in full and in
    summary mode: on both ticks the samples and the summary must be bit for
    bit equal.  Returns {(tick, mode): largest |difference|} (all 0.0)."""
    import numpy as np
    from repro_torch.streams import simulate_batch

    padded = dict(min_inst_bucket=1536, min_cont_bucket=1024)
    worst = {}
    for kernel, extra in (("sparse", dict(min_edge_bucket=65536, min_degree_bucket=512)),
                          ("dense", {})):
        for mode in ("full", "summary"):
            runs = [simulate_batch([config], 1e6, duration_s=duration_s, params=params,
                                   tick_kernel=kernel, samples=mode, device=device, **kw)[0]
                    for kw in ({}, {**padded, **extra})]
            base, pad = ((r.samples if mode == "full" else r.summary) for r in runs)
            diff = max(float(np.abs(np.asarray(pad[k]) - np.asarray(base[k])).max()) for k in base)
            equal = all(np.array_equal(pad[k], base[k]) for k in base)
            worst[(kernel, mode)] = diff
            log(f"  {kernel} tick, {mode}, {int(duration_s / params.dt)} ticks: achieved "
                f"{runs[0].achieved_ktps!r} vs {runs[1].achieved_ktps!r} ktps padded; "
                f"{'samples' if mode == 'full' else 'summary'} "
                f"{'bit-equal' if equal else 'differ'} (max |diff| {diff:.3e})")
            if not equal:
                raise AssertionError(f"the {kernel} tick's {mode} results moved with the buckets")
    return worst


def _same_rows(got, want, label):
    """Bit-equal achieved rates and summaries, row by row."""
    import numpy as np
    for i, (a, b) in enumerate(zip(got, want)):
        if a.achieved_ktps != b.achieved_ktps or a.bottleneck != b.bottleneck:
            raise AssertionError(f"{label}: row {i} achieved {a.achieved_ktps!r} "
                                 f"({a.bottleneck}) against {b.achieved_ktps!r} ({b.bottleneck})")
        for k, v in b.sim.summary.items():
            if not np.array_equal(a.sim.summary[k], v):
                raise AssertionError(f"{label}: row {i} summary {k} differs")


def phase_engine(device, params, candidates, duration_s, n_repeats=8):
    """Phase 3c (a): the candidates, with ``n_repeats`` of them submitted
    twice, through ``SimulatorEvaluator`` on the sparse tick: bit for bit
    the escape hatch (no dedup, no result cache, no resident batches); an
    identical resubmission runs no row; with the result cache cleared a
    third call takes the resident batch; a summary row's refetched
    trajectory is bit for bit a full-mode run.  Returns the evaluator."""
    import numpy as np
    from repro_torch.streams import (
        SimulatorEvaluator, cache_stats, dedup_info, resident_cache_info, simulate_batch,
        transfer_info,
    )

    def evaluator(**kw):
        return SimulatorEvaluator(params=params, duration_s=duration_s, tick_kernel="sparse",
                                  device=device, **kw)

    # overload and the target, alternating; every third candidate repeated
    # at its own load
    loads = [1e6 if i % 2 else TARGET_KTPS for i in range(len(candidates))]
    repeats = range(0, 3 * n_repeats, 3)
    configs = candidates + [candidates[i] for i in repeats]
    loads = loads + [loads[i] for i in repeats]
    n_unique = len(set(zip(configs, loads)))
    ev, plain = evaluator(), evaluator(dedup=False, cache=False, resident_batches=False)
    walls = {}
    t0 = time.perf_counter()
    want = plain.evaluate_batch(configs, loads)
    walls["escape hatch"] = time.perf_counter() - t0
    executed0 = dedup_info()["rows_executed"]
    t0 = time.perf_counter()
    first = ev.evaluate_batch(configs, loads)
    walls["first"] = time.perf_counter() - t0
    _same_rows(first, want, "dedup + result cache + resident")
    executed = dedup_info()["rows_executed"]
    if executed - executed0 != n_unique:
        raise AssertionError(f"{executed - executed0} rows ran for {n_unique} unique rows")
    hits = ev.result_cache.info()["hits"]
    t0 = time.perf_counter()
    again = ev.evaluate_batch(configs, loads)
    walls["resubmission"] = time.perf_counter() - t0
    _same_rows(again, want, "resubmission")
    if dedup_info()["rows_executed"] != executed:
        raise AssertionError("an identical resubmission ran rows")
    if ev.result_cache.info()["hits"] - hits != n_unique:
        raise AssertionError(f"{ev.result_cache.info()['hits'] - hits} result-cache hits "
                             f"for {n_unique} unique rows")
    ev.result_cache.clear()
    resident_hits = resident_cache_info()["hits"]
    t0 = time.perf_counter()
    third = ev.evaluate_batch(configs, loads)
    walls["resident"] = time.perf_counter() - t0
    _same_rows(third, want, "resident batch")
    if resident_cache_info()["hits"] <= resident_hits:
        raise AssertionError("the third call did not take the resident batch")
    row = 3
    refetches = transfer_info()["refetches"]
    t0 = time.perf_counter()
    samples = third[row].sim.samples
    walls["refetch"] = time.perf_counter() - t0
    full = simulate_batch([configs[row]], loads[row], duration_s=duration_s, params=params,
                          tick_kernel="sparse", samples="full", device=device)[0]
    if transfer_info()["refetches"] != refetches + 1:
        raise AssertionError("the refetch was not counted")
    for k, v in full.samples.items():
        if not np.array_equal(samples[k], v):
            raise AssertionError(f"refetched {k} differs from a full-mode run")
    log(f"  {len(configs)} rows ({n_unique} unique) at {int(duration_s / params.dt)} "
        f"ticks: bit-equal to the escape hatch; resubmission ran 0 rows "
        f"({n_unique} result-cache hits); third call took the resident batch; "
        f"row {row}'s refetch is bit for bit a full-mode run")
    log("  walls: " + ", ".join(f"{k} {v:.3f} s" for k, v in walls.items()))
    log(f"  cache_stats: {json.dumps(cache_stats())}")
    return ev


def phase_control(device, params, ev, dag, trace, dim, season, launch_fns):
    """Phase 3c (b): a diurnal day of ``dag`` through ``ControlLoop`` on the
    evaluator of part (a), once with ``HybridPolicy`` (no learner, as the
    example runs it) and once with ``PredictivePolicy`` (Holt-Winters,
    horizon 4) learning into its ``ModelStore``: every saturated step pools
    the row's trajectory (a refetch), and after the day the store retrains
    from the pool, which must make the evaluator's cached results
    unreachable.  The predictive loop's calibration batch is longer than
    the day, so no predict-back calibration runs: it solves the flow LP of
    each measured configuration, minutes apiece at these sizes
    (``tools/lp_scaling.py``); :func:`phase_learning` runs the loop's own
    flushes at a size where they take milliseconds.  Returns per-policy
    figures, the stream kernels' launches among them."""
    import numpy as np
    import torch
    from repro_torch.control import (
        ControlLoop, GuardBands, HoltWintersForecaster, HybridPolicy, ModelStore,
        PredictivePolicy,
    )
    from repro_torch.core import oracle_models
    from repro_torch.streams import dedup_info, transfer_info

    thr = 0.95
    guards = GuardBands(headroom=1.0, deadband=0.2)
    models = oracle_models(dag, params.sm_cost_per_ktuple)
    out = {}
    for name in ("hybrid", "predictive"):
        store = ModelStore(models)
        if name == "hybrid":
            loop = ControlLoop(HybridPolicy(dag, store, preferred_dim=dim), guards=guards,
                               evaluator=ev, saturation_threshold=thr)
        else:
            loop = ControlLoop(PredictivePolicy(dag, store, preferred_dim=dim), guards=guards,
                               evaluator=ev, learner=store,
                               forecaster=HoltWintersForecaster(season=season), horizon=4,
                               saturation_threshold=thr, calibration_batch=len(trace) + 1)
        launches0 = [fn.launches for fn in launch_fns]
        dedup0, transfer0 = dedup_info(), transfer_info()
        hits0 = ev.result_cache.info()["hits"]
        version0 = store.version
        t0 = time.perf_counter()
        for load in trace:
            step = loop.step(float(load))
            if loop.action is None or loop.action.config is None:
                raise AssertionError(f"{name}: step {step.step} logged no configuration")
        if device.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        retrain_s = None
        if name == "predictive" and len(store.metrics):
            t1 = time.perf_counter()
            store.retrain()                   # from the pooled trajectories
            retrain_s = time.perf_counter() - t1
            misses = ev.result_cache.info()["misses"]
            ev.evaluate(loop.action.config, float(trace[-1]))
            if ev.result_cache.info()["misses"] != misses + 1:
                raise AssertionError("the retrain's version bump left the cached result reachable")
        dedup, transfer = dedup_info(), transfer_info()
        fig = dict(
            steps=len(loop.events),
            breach_steps=sum(e.achieved < thr * e.load for e in loop.events),
            proactive_replans=sum(e.cause == "forecast" for e in loop.events),
            acted=sum(e.acted for e in loop.events),
            wall_s=wall,
            wall_per_step_s=wall / max(len(loop.events), 1),
            rows={k: dedup[k] - dedup0[k] for k in ("rows_in", "rows_unique", "rows_executed")},
            result_cache_hits=ev.result_cache.info()["hits"] - hits0,
            transfer={k: transfer[k] - transfer0[k]
                      for k in ("batches", "bytes_full", "bytes_summary", "refetches")},
            launches={fn.__name__: fn.launches - n for fn, n in zip(launch_fns, launches0)},
            version=(version0, store.version),
            pooled_series=len(store.metrics),
            pending_calibration=len(loop._pending_configs),
            retrain_s=retrain_s,
            achieved_mean_ktps=float(np.mean([e.achieved for e in loop.events])),
            load_mean_ktps=float(np.mean([e.load for e in loop.events])),
        )
        log(f"  {name}: {json.dumps(fig)}")
        if name == "predictive" and fig["breach_steps"]:
            if fig["transfer"]["refetches"] <= 0:
                raise AssertionError("saturated predictive steps refetched no trajectory")
            if ev.version_source is not store or store.version <= version0:
                raise AssertionError("the learner's version did not reach the evaluator")
        if fig["launches"]["stream_flow_ell"] <= 0:
            raise AssertionError(f"{name}: the control path never launched the stream_flow_ell kernel")
        out[name] = fig
    return out


def phase_learning(device, params, dim, launch_fns, steps=24, drift=2.5):
    """Phase 3c (c): the paper's online refinement on the card, at a size
    where the flow LP of a calibration takes milliseconds: a diurnal
    ``adanalytics`` day through ``ControlLoop(PredictivePolicy)`` learning
    into its ``ModelStore`` with the default calibration batch, on a
    simulator whose stream managers cost ``drift`` times what the oracle
    models assume.  The day saturates until the loop's own flush calibrates
    the store; the version that keys the result cache must rise inside the
    loop, every saturated step must refetch its row's trajectory, and some
    steps after the first rise must not breach.  Returns the figures."""
    import dataclasses

    from repro_torch.control import (
        ControlLoop, GuardBands, HoltWintersForecaster, ModelStore, PredictivePolicy, make_trace,
    )
    from repro_torch.core import oracle_models
    from repro_torch.streams import SimulatorEvaluator, adanalytics, dedup_info, transfer_info

    thr = 0.95
    dag = adanalytics()
    store = ModelStore(oracle_models(dag, params.sm_cost_per_ktuple))
    drifted = dataclasses.replace(params, sm_cost_per_ktuple=drift * params.sm_cost_per_ktuple)
    ev = SimulatorEvaluator(params=drifted, duration_s=2.0, tick_kernel="sparse", device=device)
    loop = ControlLoop(PredictivePolicy(dag, store, preferred_dim=dim),
                       guards=GuardBands(headroom=1.0, deadband=0.2), evaluator=ev, learner=store,
                       forecaster=HoltWintersForecaster(season=steps // 2), horizon=4,
                       saturation_threshold=thr)
    launches0 = [fn.launches for fn in launch_fns]
    dedup0, refetches0 = dedup_info(), transfer_info()["refetches"]
    versions = []
    t0 = time.perf_counter()
    for load in make_trace("diurnal", steps, base_ktps=600.0, seed=3):
        step = loop.step(float(load))
        if loop.action is None or loop.action.config is None:
            raise AssertionError(f"learning: step {step.step} logged no configuration")
        versions.append(store.version)
    wall = time.perf_counter() - t0
    breach = [e.achieved < thr * e.load for e in loop.events]
    first = next((i for i, v in enumerate(versions) if v > 0), None)
    fig = dict(
        steps=len(loop.events),
        breach_steps=sum(breach),
        breach_at=[i for i, b in enumerate(breach) if b],
        proactive_replans=sum(e.cause == "forecast" for e in loop.events),
        retrains=sum(e.retrained for e in loop.events),
        versions=versions,
        first_version_rise_step=first,
        containers=[e.containers for e in loop.events],
        wall_s=wall,
        wall_per_step_s=wall / max(len(loop.events), 1),
        rows={k: dedup_info()[k] - dedup0[k] for k in ("rows_in", "rows_unique", "rows_executed")},
        refetches=transfer_info()["refetches"] - refetches0,
        launches={fn.__name__: fn.launches - n for fn, n in zip(launch_fns, launches0)},
    )
    log(f"  learning: {json.dumps(fig)}")
    if ev.version_source is not store:
        raise AssertionError("learning: the evaluator's version source is not the learner")
    if first is None:
        raise AssertionError("learning: the loop's own calibration flushes never raised the version")
    if fig["refetches"] < sum(breach):
        raise AssertionError(f"learning: {fig['refetches']} refetches for {sum(breach)} saturated steps")
    if all(breach[first + 1:]):
        raise AssertionError("learning: every step after the store learned still breached")
    return fig


# ------------------------------------------------------------------- fleet

DEMO_STEPS = 24
#: Phase 3c (b)'s diurnal day of deep_pipeline (one Holt-Winters season).
CONTROL_DAY_STEPS = 24
#: phase 3d (c): copies of the demo's trio (999 tenants) and steps.  Eight
#: steps took 566 s (``tools/fleet_probe.py``; NVIDIA H100 80GB HBM3, 700 W),
#: almost all of it the scheduler's host-side allocation under the squeeze,
#: and four took 367 s of a 917 s smoke run beside the MoE and MLA phases
#: (the same card), so two run here: the bootstrap and the first guard
#: replan.
FLEET_COPIES, FLEET_STEPS = 333, 1


def demo_fleet(params, copies=1, factors=None):
    """``examples/fleet_demo.py``'s setup built from the port: its three
    tenants (l. 66-71), its cluster (l. 74-79) and its traces (l. 81-88).
    With ``copies`` > 1 the trio is repeated under the names ``ads000``,
    ``clicks000``, ``wc000``, ...; copy ``c`` scales its targets and trace
    bases by ``factors[c]`` and adds ``10 c`` to its trace seeds, and the
    cluster holds the demo's machine classes ``copies`` times over.
    Returns ``(tenants, traces, cluster)``."""
    from repro_torch.control import GuardBands, HoltWintersForecaster, make_trace
    from repro_torch.core import ContainerDim, oracle_models
    from repro_torch.fleet import Cluster, MachineClass, QosTier, TenantSpec
    from repro_torch.streams import adanalytics, diamond, wordcount

    dim = ContainerDim(cpus=3.0, mem_mb=4096.0)
    trio = (
        ("ads", "ads", adanalytics, QosTier.GUARANTEED, 400.0, "diurnal", 260.0, 3,
         dict(peak_ratio=3.0)),
        ("clicks", "clicks", diamond, QosTier.STANDARD, 250.0, "sawtooth", 140.0, 5,
         dict(ratio=2.0)),
        ("wordcount", "wc", wordcount, QosTier.BEST_EFFORT, 1000.0, "bursty", 900.0, 7,
         dict(burst_ratio=3.0)),
    )
    tenants, traces = [], {}
    for c in range(copies):
        f = 1.0 if factors is None else float(factors[c])
        for name, short, dag_fn, qos, target, scenario, base, seed, kw in trio:
            if copies > 1:
                name = f"{short}{c:03d}"
            dag = dag_fn()
            forecaster = (HoltWintersForecaster(season=DEMO_STEPS // 2)
                          if qos == QosTier.GUARANTEED else None)
            tenants.append(TenantSpec(
                name=name, dag=dag, target_ktps=target * f, qos=qos,
                models=oracle_models(dag, params.sm_cost_per_ktuple),
                guards=GuardBands.for_scenario(scenario), preferred_dim=dim,
                forecaster=forecaster, horizon=4,
            ))
            traces[name] = make_trace(scenario, DEMO_STEPS, base_ktps=base * f,
                                      seed=seed + 10 * c, **kw)
    cluster = Cluster([
        MachineClass("std", count=5 * copies, cores=4.0, mem_mb=16384.0),
        MachineClass("big", count=copies, cores=8.0, mem_mb=32768.0, speed=1.05),
    ])
    return tenants, traces, cluster


def loads_at(traces, i) -> dict:
    return {n: float(t[i]) for n, t in traces.items()}


def check_packing(cluster, plan, label) -> None:
    """No container on a failed host, none unplaced in an admitted plan,
    and no host holding more cores or memory than it has."""
    failed = cluster.failed_hosts()
    cap = {h.name: (h.cores, h.mem_mb) for h in cluster.inventory()}
    used: dict = {}
    for a in plan.allocations:
        if a.config is None or a.placement is None:
            continue
        for d, h in zip(a.config.dims, a.placement.host_names):
            if not h or h in failed:
                raise AssertionError(f"{label}: {a.tenant} has a container on {h!r}")
            c, m = used.get(h, (0.0, 0.0))
            used[h] = (c + d.cpus, m + d.mem_mb)
    for h, (c, m) in used.items():
        if c > cap[h][0] + 1e-9 or m > cap[h][1] + 1e-9:
            raise AssertionError(f"{label}: host {h} holds {c} cores, {m} MB of {cap[h]}")


def first_difference(got, want) -> str:
    """The first event (and field) where two fleet event logs differ."""
    import dataclasses
    if len(got) != len(want):
        return f"{len(got)} events against {len(want)}"
    for a, b in zip(got, want):
        da, db = dataclasses.asdict(a), dataclasses.asdict(b)
        for k in db:
            if da[k] != db[k]:
                return f"step {b.step}: {k} {da[k]!r} against {db[k]!r}"
    return ""


def phase_fleet_demo(device, params):
    """Phase 3d (a): the demo's 24 steps through the port's ``FleetLoop``
    on a ``SimulatorEvaluator(duration_s=4.0)`` on the card, held to the
    example's contract; then the same day with the controller crashed after
    step 12 (``FailurePlan``, ``run_with_restarts``).  The controller
    checkpoints every step through the port's ``Checkpointer``; the restart
    builds a fresh loop and evaluator, restores the learned state
    (``FleetLoop.restore``) and takes over the deployment the cluster still
    runs (the plan, which by design is not checkpointed).  Its events must
    equal the uninterrupted run's field for field.  Returns the figures."""
    import dataclasses
    import tempfile

    import torch
    from repro_torch.checkpoint import Checkpointer, controller_state
    from repro_torch.fleet import FleetLoop
    from repro_torch.runtime import FailurePlan, run_with_restarts
    from repro_torch.streams import SimulatorEvaluator, dedup_info

    def evaluator():
        return SimulatorEvaluator(params=params, duration_s=4.0, device=device)

    tenants, traces, cluster = demo_fleet(params)
    ev = evaluator()
    loop = FleetLoop(tenants, cluster, ev)
    containers = []
    dedup0 = dedup_info()
    t0 = time.perf_counter()
    for i in range(DEMO_STEPS):
        e = loop.step(loads_at(traces, i))
        check_packing(cluster, loop.plan, f"demo step {i}")
        if e.replanned:
            containers.append(sum(len(a.config.dims) for a in loop.plan.allocations if a.config))
    if device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    events = loop.events
    gold, be = "ads", "wordcount"
    squeeze = [e.step for e in events if any(t.degraded for t in e.tenants)]
    fig = dict(
        steps=len(events), wall_s=wall, backend=ev._backend,
        replans=sum(e.replanned for e in events),
        causes=[e.cause if e.replanned else "-" for e in events],
        squeeze_steps=squeeze,
        gold_breach_steps=[e.step for e in events if not e.tenant(gold).sla_met],
        be_kept_on_squeeze=[s for s in squeeze
                            if not events[s].tenant(be).degraded and events[s].tenant(be).admitted],
        forecast_replans=[e.step for e in events if e.replanned and e.cause == "forecast"],
        moves=sum(e.moves for e in events if e.replanned),
        evicted=sum(e.evicted for e in events),
        cold_restarts=sum(containers),
        rows={k: dedup_info()[k] - dedup0[k] for k in ("rows_in", "rows_unique", "rows_executed")},
        achieved={t.tenant: [round(e.tenant(t.tenant).achieved_ktps, 3) for e in events]
                  for t in events[0].tenants},
    )
    log(f"  demo: {json.dumps(fig)}")
    if fig["gold_breach_steps"]:
        raise AssertionError(f"demo: the guaranteed tenant missed its SLA at {fig['gold_breach_steps']}")
    if not squeeze or fig["be_kept_on_squeeze"]:
        raise AssertionError(f"demo: squeeze steps {squeeze}, best-effort untouched at "
                             f"{fig['be_kept_on_squeeze']}")
    if not fig["forecast_replans"]:
        raise AssertionError("demo: no replan had cause 'forecast'")
    if not fig["moves"] < fig["cold_restarts"]:
        raise AssertionError(f"demo: replans moved {fig['moves']} containers, a cold repack "
                             f"restarts {fig['cold_restarts']}")

    crash_after = 12
    tenants_r, _, cluster_r = demo_fleet(params)
    failures = FailurePlan(fail_after_steps=(crash_after,))
    deployed = {}          # what the cluster runs: it outlives the controller
    rerun, starts, backends = [], [], []
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = Checkpointer(tmp, keep=3)

        def attempt(n):
            fresh = tenants_r if n == 0 else demo_fleet(params)[0]
            ev_r = evaluator()
            loop_r = FleetLoop(fresh, cluster_r, ev_r)
            start = 0
            if n:
                start = loop_r.restore(ckpt)
                loop_r.plan = deployed["plan"]
            starts.append(start)
            for i in range(start, DEMO_STEPS):
                e = loop_r.step(loads_at(traces, i))
                rerun.append(dataclasses.replace(e, step=start + e.step))
                deployed["plan"] = loop_r.plan
                # the checkpoint names the day's step, which a restored loop
                # (its event log empty) cannot count for itself
                state = controller_state(loop_r)
                state["step"] = i + 1
                ckpt.save(i + 1, state, blocking=True)
                failures.maybe_fail(i)
            backends.append(ev_r._backend)
            return start

        _, restarts = run_with_restarts(attempt)
        kept = ckpt.list_steps()
    if device.type == "cuda":
        torch.cuda.synchronize()
    crash_wall = time.perf_counter() - t0
    diff = first_difference(rerun, events)
    log(f"  crash after step {crash_after}: {restarts} restart, resumed at step {starts[-1]} "
        f"(backends {backends}), checkpoints kept {kept}, wall {crash_wall:.3f} s; events "
        f"{'equal to the uninterrupted run, field for field' if not diff else 'differ: ' + diff}")
    if restarts != 1 or starts != [0, crash_after + 1]:
        raise AssertionError(f"demo crash: {restarts} restarts, starts {starts}")
    if diff:
        raise AssertionError(f"demo crash: the restarted run differs from the uninterrupted one: {diff}")
    fig.update(crash_wall_s=crash_wall, restarts=restarts, resumed_at=starts[-1],
               crash_backends=backends)
    return fig


def phase_fleet_n1(device, params):
    """Phase 3d (b): N+1 on the demo cluster (racks r1 and r2), the port of
    ``tests/test_fleet_failure.py``'s headline on the card: a host of the
    guaranteed tenant fails at step 2, the replan is a failover that moves
    its containers off the dead host, and the guaranteed tenant books no
    breach step.  Returns the figures."""
    from repro_torch.control import GuardBands
    from repro_torch.core import ContainerDim, oracle_models
    from repro_torch.fleet import Cluster, FleetLoop, MachineClass, QosTier, TenantSpec
    from repro_torch.streams import SimulatorEvaluator, adanalytics, diamond, wordcount

    dim = ContainerDim(cpus=3.0, mem_mb=4096.0)

    def tenant(name, qos, target, dag):
        return TenantSpec(name=name, dag=dag, target_ktps=target, qos=qos,
                          models=oracle_models(dag, params.sm_cost_per_ktuple),
                          guards=GuardBands(headroom=1.2, deadband=0.15), preferred_dim=dim)

    ev = SimulatorEvaluator(params=params, duration_s=2.0, sticky_batch=True, device=device)
    tenants = [tenant("ads", QosTier.GUARANTEED, 300.0, adanalytics()),
               tenant("clicks", QosTier.STANDARD, 150.0, diamond()),
               tenant("wc", QosTier.BEST_EFFORT, 200.0, wordcount())]
    cluster = Cluster([
        MachineClass("std", count=5, cores=4.0, mem_mb=16384.0, rack="r1"),
        MachineClass("alt", count=5, cores=4.0, mem_mb=16384.0, rack="r2"),
        MachineClass("big", count=1, cores=8.0, mem_mb=32768.0, speed=1.05, rack="r1"),
    ])
    loop = FleetLoop(tenants, cluster, ev, anti_affinity=True, n1_tiers=(QosTier.GUARANTEED,))
    traces = {"ads": [260.0, 300.0, 300.0, 300.0], "clicks": [120.0, 150.0, 150.0, 150.0],
              "wc": [200.0, 260.0, 200.0, 200.0]}
    t0 = time.perf_counter()
    loop.step(loads_at(traces, 0))
    loop.step(loads_at(traces, 1))
    n1 = loop.plan.allocation("ads").n1_feasible
    victim = loop.plan.allocation("ads").placement.host_names[0]
    e2 = loop.step(loads_at(traces, 2), failures=[("fail", victim)])
    after = loop.plan.allocation("ads").placement.host_names
    loop.step(loads_at(traces, 3))
    wall = time.perf_counter() - t0
    breach = [e.step for e in loop.events if not e.tenant("ads").sla_met]
    fig = dict(wall_s=wall, backend=ev._backend, n1_feasible=n1, victim=victim,
               cause=e2.cause, failover=list(e2.failover), ads_failover=e2.tenant("ads").failover,
               ads_hosts_after=list(after), ads_breach_steps=breach,
               achieved={n: [round(e.tenant(n).achieved_ktps, 3) for e in loop.events]
                         for n in traces})
    log(f"  n+1: {json.dumps(fig)}")
    if n1 is not True:
        raise AssertionError(f"n+1: the guaranteed allocation is not n1_feasible ({n1})")
    if not (e2.replanned and e2.cause == "failover" and e2.tenant("ads").failover >= 1):
        raise AssertionError(f"n+1: step 2 replanned={e2.replanned} cause={e2.cause!r}")
    if victim in after:
        raise AssertionError(f"n+1: the failed host {victim} is still in the new placement")
    if breach:
        raise AssertionError(f"n+1: the guaranteed tenant breached at steps {breach}")
    check_packing(cluster, loop.plan, "n+1")
    return fig


def phase_fleet_scale(device, params, copies, steps, recs, sample=64):
    """Phase 3d (c): ``copies`` copies of the demo's trio (rate factors
    log-uniform in [0.5, 2] from ``default_rng(0)``) on the demo's machine
    classes ``copies`` times over, ``steps`` steps through ``FleetLoop``
    with N+1 for the guaranteed tier on a ``SimulatorEvaluator(duration_s=
    4.0)`` on the card.  Every guaranteed tenant must be admitted and meet
    its SLA on every step, no host may be overcommitted, and each step's
    act measurement must be one call with one row per admitted tenant.
    Then ``sample`` rows of step 0's measurement run on the host (rel 1e-5
    of the card) and uncached on the card (bit for bit the engine's).
    Returns the figures."""
    import numpy as np
    import torch
    import repro_torch.fleet.loop as fleet_loop
    import repro_torch.fleet.scheduler as fleet_scheduler
    from repro_torch.fleet import FleetLoop, QosTier
    from repro_torch.streams import SimulatorEvaluator, dedup_info, simulate_batch

    rng = np.random.default_rng(0)
    factors = np.exp(rng.uniform(np.log(0.5), np.log(2.0), copies))
    t0 = time.perf_counter()
    tenants, traces, cluster = demo_fleet(params, copies, factors)
    ev = SimulatorEvaluator(params=params, duration_s=4.0, device=device)
    loop = FleetLoop(tenants, cluster, ev, n1_tiers=(QosTier.GUARANTEED,))
    build_s = time.perf_counter() - t0
    n_gold = sum(t.qos == QosTier.GUARANTEED for t in tenants)
    tiers = {q.name: [t.name for t in tenants if t.qos == q] for q in QosTier}
    calls = {"act": [], "score": []}

    def recorded(fn, kind):
        def call(evaluator, groups, offered):
            d0 = dedup_info()
            out = fn(evaluator, groups, offered)
            d1 = dedup_info()
            calls[kind].append(dict(
                groups=[list(g) for g in groups] if kind == "act" else None,
                offered=list(offered) if kind == "act" else None, out=out if kind == "act" else None,
                rows=sum(len(g) for g in groups),
                **{k: d1[k] - d0[k] for k in ("rows_unique", "rows_executed")}))
            return out
        return call

    saved = (fleet_loop.evaluate_jobs_with, fleet_scheduler.evaluate_jobs_with)
    fleet_loop.evaluate_jobs_with = recorded(saved[0], "act")
    fleet_scheduler.evaluate_jobs_with = recorded(saved[1], "score")
    per_step, step0_act = [], None
    try:
        for i in range(steps):
            counts0 = [dict(r.counts) for _name, r in recs]
            d0 = dedup_info()
            n_act, n_score = len(calls["act"]), len(calls["score"])
            t0 = time.perf_counter()
            e = loop.step(loads_at(traces, i))
            if device.type == "cuda":
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            d1 = dedup_info()
            check_packing(cluster, loop.plan, f"fleet step {i}")
            acts = calls["act"][n_act:]
            by = {t.tenant: t for t in e.tenants}
            admitted = sum(t.admitted for t in e.tenants)
            shapes = {name: {str(k): n - c0.get(k, 0) for k, n in r.counts.items() if n > c0.get(k, 0)}
                      for (name, r), c0 in zip(recs, counts0)}
            fig = dict(
                step=i, wall_s=wall, replanned=e.replanned, cause=e.cause,
                timings=({k: loop.plan.timings.get(k) for k in
                          ("restore", "allocate", "pack", "score", "repair", "total")}
                         if e.replanned else None),
                touched=len(loop.plan.touched) if e.replanned else 0,
                eval_rows=loop.plan.eval_rows if e.replanned else 0,
                score_calls=[{k: c[k] for k in ("rows", "rows_unique", "rows_executed")}
                             for c in calls["score"][n_score:]],
                act_calls=[{k: c[k] for k in ("rows", "rows_unique", "rows_executed")} for c in acts],
                rows={k: d1[k] - d0[k] for k in ("rows_in", "rows_unique", "rows_executed")},
                backend=ev._backend, launch_shapes=shapes,
                moves=e.moves, evicted=e.evicted, admitted=admitted,
                degraded=sum(t.degraded for t in e.tenants), cores_used=e.cores_used,
                sla_met={q: f"{sum(by[n].sla_met for n in names)}/{len(names)}"
                         for q, names in tiers.items()},
            )
            log(f"  fleet step {i}: {json.dumps(fig)}")
            per_step.append(fig)
            bad = [n for n in tiers["GUARANTEED"]
                   if not (by[n].admitted and by[n].sla_met)]
            if bad:
                raise AssertionError(f"fleet step {i}: guaranteed tenants {bad[:8]} "
                                     f"({len(bad)}) not admitted or below their SLA")
            if len(acts) != 1 or len(acts[0]["groups"]) != admitted or acts[0]["rows"] != admitted:
                raise AssertionError(f"fleet step {i}: act calls {fig['act_calls']} for {admitted} "
                                     f"admitted tenants")
            if admitted < n_gold:
                raise AssertionError(f"fleet step {i}: {admitted} admitted, {n_gold} guaranteed")
            if i == 0:
                step0_act = dict(acts[0])
            for c in acts:
                c["groups"] = c["out"] = c["offered"] = None
    finally:
        fleet_loop.evaluate_jobs_with, fleet_scheduler.evaluate_jobs_with = saved
    backend = ev._backend

    # a seeded sample of step 0's measurement: on the host, and uncached on the card
    pick = np.sort(np.random.default_rng(1).choice(len(step0_act["groups"]), size=sample, replace=False))
    cfgs = [step0_act["groups"][j][0] for j in pick]
    offered = [float(step0_act["offered"][j]) for j in pick]
    engine = [step0_act["out"][j][0] for j in pick]
    t0 = time.perf_counter()
    host = simulate_batch(cfgs, offered, duration_s=4.0, params=params, tick_kernel=backend,
                          samples="summary", device="cpu")
    host_s = time.perf_counter() - t0
    uncached = simulate_batch(cfgs, offered, duration_s=4.0, params=params, tick_kernel=backend,
                              samples="summary", dedup=False, cache=None, resident=False,
                              device=device)
    card = np.array([r.achieved_ktps for r in engine], dtype=np.float64)
    host_k = np.array([r.achieved_ktps for r in host], dtype=np.float64)
    rel = float(np.max(np.abs(host_k - card) / np.maximum(np.abs(card), 1e-30)))
    log(f"  {sample} rows of step 0's measurement (seeded): host vs card max rel "
        f"{rel:.3e} (host run {host_s:.3f} s); uncached on the card: "
        f"{'bit for bit the engine' if all(u.achieved_ktps == r.achieved_ktps for u, r in zip(uncached, engine)) else 'differs'}")
    if not rel <= 1e-5:
        raise AssertionError(f"fleet: host and card differ by rel {rel:.3e} > 1e-5")
    for j, (u, r) in enumerate(zip(uncached, engine)):
        if u.achieved_ktps != r.achieved_ktps or u.bottleneck_node(0.8) != r.bottleneck:
            raise AssertionError(f"fleet: sampled row {j} achieved {u.achieved_ktps!r} "
                                 f"({u.bottleneck_node(0.8)}) uncached against "
                                 f"{r.achieved_ktps!r} ({r.bottleneck}) through the engine")
        for k, v in r.sim.summary.items():
            if not np.array_equal(u.summary[k], v):
                raise AssertionError(f"fleet: sampled row {j} summary {k} differs uncached: "
                                     f"{u.summary[k]!r} against {v!r}")
    return dict(tenants=len(tenants), hosts=cluster.n_hosts, build_s=build_s, backend=backend,
                steps=per_step, sample_rel=rel)


def check_and_time(flow, sums, ords, label, excess):
    """Each stream kernel against its plain version, and timed, at every
    input shape its recorder saw; adds each kernel's launches x (time -
    bound) to ``excess`` under ``label``.  Returns the largest error of
    each kernel."""
    errs = {"stream_flow_ell": 0.0, "container_sum": 0.0, "ordered_sum": 0.0}
    at = {"stream_flow_ell": {}, "container_sum": {}, "ordered_sum": {}}
    for key in sorted(flow.counts):
        inputs = flow.inputs[key]
        errs["stream_flow_ell"] = max(errs["stream_flow_ell"],
                                      check_kernel(f"{label} {key}", dict(zip(KERNEL_ARGS, inputs))))
        at["stream_flow_ell"][key] = time_recorded(key, inputs)
    for key in sorted(sums.counts):
        args = sums.inputs[key]
        errs["container_sum"] = max(errs["container_sum"], check_container_sum(f"{label} {key}", args))
        at["container_sum"][key] = time_container_sum(args)
    for key in sorted(ords.counts):
        args = ords.inputs[key]
        errs["ordered_sum"] = max(errs["ordered_sum"], check_ordered_sum(f"{label} {key}", args))
        at["ordered_sum"][key] = time_ordered_sum(args)
    for name, rec in (("stream_flow_ell", flow), ("container_sum", sums), ("ordered_sum", ords)):
        for key, t in at[name].items():
            n = rec.counts[key]
            log(f"  {name} launches x (time - bound) at {key}: {n} x "
                f"({t['ms']:.5f} - {t['bound_ms']:.6f}) ms = {n * (t['ms'] - t['bound_ms']):.3f} ms")
        excess[f"{name}, {label}"] = excess_ms([(rec.counts[k], t) for k, t in at[name].items()])
    return errs


def log_shapes(recs, totals, label):
    """Each recorder's launches by input shape; their sum must be the
    wrapper's own count."""
    for (name, rec), total in zip(recs, totals):
        for key, n in sorted(rec.counts.items()):
            log(f"  {name} launches at {key}: {n}")
        if total <= 0:
            raise AssertionError(f"{label} never launched the {name} kernel")
        if sum(rec.counts.values()) != total:
            raise AssertionError(f"{label}: {name} launches by shape {rec.counts} do not add up to {total}")


# ------------------------------------------------- executor and batched LP

EXEC_DAGS = ("wordcount", "adanalytics", "mobile_analytics")
#: phase 3e (a): the sources' batch where the card is not launch-bound, and
#: the batch of the card-against-host comparison
EXEC_BIG_BATCH, EXEC_CMP_BATCH = 1 << 20, 1 << 16
EXEC_RTOL = 1e-5                    # card vs host float columns and anomaly state
ANOMALY_Z_BAND = 1e-4               # flags compared except where |z - 3| < this
LP_REL, LP_ABS = 2e-4, 1e-5         # float32 simplex vs numpy (tests/test_lp.py)
LP_TARGETS = (500.0, 1000.0, 2000.0, 3000.0)   # tools/lp_scaling.py's targets
LP_MAXITERS = (1024, 4096, 16384)
LP_BATCH = 32
LP_MAX_TABLEAU_BYTES = 8 * 2**30
LP_MAX_SOLVE_S = 30.0


def _default(device):
    """``None`` where ``device`` is the card, so the entry points resolve
    their own default; the device itself in a rehearsal on the host."""
    return None if device.type == "cuda" else device


def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize()


def source_factory(name):
    from repro_torch.streams import operators as ops
    return {"wordcount": ops.make_word_producer, "adanalytics": ops.make_ad_source,
            "mobile_analytics": ops.make_mobile_source}[name]


def with_source(dag, fn):
    """``dag`` with its source node's operator body replaced by ``fn``."""
    import dataclasses
    return dataclasses.replace(dag, nodes=tuple(
        dataclasses.replace(n, fn=fn) if n.is_source else n for n in dag.nodes))


def numpy_source_batches(name, n, size, seed):
    """Seeded numpy batches with the columns, dtypes and ranges of ``name``'s
    source at its default sizes (vocabulary 4,096; 1,000 ads; 100,000
    users; 3,000 cells)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        if name == "wordcount":
            b = {"key": rng.integers(0, 4096, size).astype(np.int32),
                 "value": np.ones(size, np.int32)}
        elif name == "adanalytics":
            b = {"ad_id": rng.integers(0, 1000, size).astype(np.int32),
                 "event_type": rng.integers(0, 3, size).astype(np.int32),
                 "ts": (rng.random(size) * 1e6).astype(np.float32)}
        else:
            b = {"user": rng.integers(0, 100_000, size).astype(np.int32),
                 "cell": rng.integers(0, 3000, size).astype(np.int32),
                 "bytes": (rng.exponential(size=size) * 1500.0).astype(np.float32),
                 "latency_ms": (rng.gamma(2.0, size=size) * 10.0).astype(np.float32)}
        out.append(b)
    return out


def _replay(batches):
    """A source that hands out ``batches`` in turn, on its generator's device."""
    import torch
    it = iter(batches)
    return lambda gen, _=None: (gen, {k: torch.as_tensor(v, device=gen.device)
                                      for k, v in next(it).items()})


def _recording_anomaly(seen):
    """``anomaly_detector`` that keeps the state it returns in ``seen``."""
    from repro_torch.streams.operators import anomaly_detector

    def step(state, batch):
        st, out = anomaly_detector(state, batch)
        seen["state"] = st
        return st, out
    return step


def card_vs_host_outputs(name, card, size, seed):
    """Phase 3e (a)'s comparison: ``name`` run on the card and on the host
    with one source of the same seeded batches; every node's last-batch
    columns must agree (ints and bools bit for bit, ``cell_kpi``'s
    last-writer values too; floats to rel 1e-5; the anomaly flags except
    within 1e-4 of the threshold, and the detector's state to rel 1e-5)."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.streams import WORKLOADS
    from repro_torch.streams.executor import run_dag

    batches = numpy_source_batches(name, 3, size, seed)
    seen = {"card": {}, "host": {}}
    out = {}
    for side, dev in (("card", card), ("host", torch.device("cpu"))):
        dag = with_source(WORKLOADS[name](), _replay(batches))
        dag = dataclasses.replace(dag, nodes=tuple(
            dataclasses.replace(n, fn=_recording_anomaly(seen[side]))
            if n.name == "anomaly_detector" else n for n in dag.nodes))
        out[side] = run_dag(dag, n_batches=2, warmup=1, device=dev).outputs
    worst, excluded, compared = 0.0, 0, 0
    for node, cols in out["host"].items():
        if sorted(out["card"][node]) != sorted(cols):
            raise AssertionError(f"{name}.{node}: columns {sorted(out['card'][node])} "
                                 f"against {sorted(cols)}")
        for k, want in cols.items():
            got, want = out["card"][node][k].cpu().numpy(), want.numpy()
            if got.dtype != want.dtype:
                raise AssertionError(f"{name}.{node}.{k}: {got.dtype} against {want.dtype}")
            if k == "anomaly":
                mean, var, n = (float(t) for t in seen["host"]["state"])
                x = out["host"][node]["session_kb"].numpy().astype(np.float64)
                z = (x - mean) / np.sqrt(max(var / n, 1e-6))
                keep = np.abs(z - 3.0) >= ANOMALY_Z_BAND
                excluded += int((~keep).sum())
                if not np.array_equal(got[keep], want[keep]):
                    raise AssertionError(f"{name}.{node}.anomaly: "
                                         f"{int((got[keep] != want[keep]).sum())} flags differ "
                                         "away from the threshold")
            elif np.issubdtype(want.dtype, np.floating):
                np.testing.assert_allclose(got, want, rtol=EXEC_RTOL, atol=0,
                                           err_msg=f"{name}.{node}.{k}")
                nz = want != 0
                if nz.any():
                    worst = max(worst, float(np.max(np.abs(got[nz] - want[nz]) / np.abs(want[nz]))))
            elif not np.array_equal(got, want):
                raise AssertionError(f"{name}.{node}.{k}: {int((got != want).sum())} of "
                                     f"{want.size} differ")
            compared += 1
    if seen["host"]:
        for g, w in zip(seen["card"]["state"], seen["host"]["state"]):
            np.testing.assert_allclose(float(g), float(w), rtol=EXEC_RTOL, err_msg="anomaly state")
    return dict(columns=compared, max_rel_float=worst, anomaly_excluded=excluded)


def phase_executor(device):
    """Phase 3e (a): ``run_dag`` on the three paper DAGs at the reference's
    defaults (batch 2,048, 20 batches after 3 warmups) and with their
    sources rebuilt at 2^20 tuples a batch, per-node microseconds per tuple
    logged; then each DAG on card and host against one source of the same
    batches."""
    from repro_torch.streams import WORKLOADS
    from repro_torch.streams.executor import run_dag

    fig = {}
    for name in EXEC_DAGS:
        for batch in (2048, EXEC_BIG_BATCH):
            dag = WORKLOADS[name]()
            if batch != 2048:
                dag = with_source(dag, source_factory(name)(batch=batch))
            t0 = time.perf_counter()
            report = run_dag(dag, device=_default(device))
            _sync(device)
            wall = time.perf_counter() - t0
            timed = [n.name for n in dag.nodes if n.fn is not None]
            if sorted(report.per_node_us_per_tuple) != sorted(timed):
                raise AssertionError(f"{name} at {batch}: timed "
                                     f"{sorted(report.per_node_us_per_tuple)}, operators {sorted(timed)}")
            if report.tuples_processed != 20 * batch:
                raise AssertionError(f"{name} at {batch}: {report.tuples_processed} tuples")
            src = report.outputs[dag.sources()[0].name]
            if next(iter(src.values())).device.type != device.type:
                raise AssertionError(f"{name}: the source's batch is not on {device}")
            row = dict(tuples_processed=report.tuples_processed, wall_s=wall,
                       us_per_tuple=report.per_node_us_per_tuple)
            log(f"  run_dag {name} batch {batch}: {json.dumps(row)}")
            fig[f"{name}@{batch}"] = row
    for i, name in enumerate(EXEC_DAGS):
        t0 = time.perf_counter()
        cmp = card_vs_host_outputs(name, device, EXEC_CMP_BATCH, seed=30 + i)
        cmp["s"] = time.perf_counter() - t0
        log(f"  card = host, {name} at batch {EXEC_CMP_BATCH}: {json.dumps(cmp)}")
        fig[f"{name} card=host"] = cmp
    return fig


def trio_candidates(params):
    """Candidate configurations of the fleet demo's three tenants (as phase
    3d (a) builds them): each tenant's allocation at 0.5-1.5x its target.
    Returns ``(tenants, groups)``."""
    from repro_torch.core import allocate
    tenants, _, _ = demo_fleet(params)
    groups = [[allocate(t.dag, t.models, t.target_ktps * f, preferred_dim=t.preferred_dim).config
               for f in (0.5, 0.75, 1.0, 1.25, 1.5)] for t in tenants]
    return tenants, groups


def phase_executor_evaluator(device, params, dim):
    """Phase 3e (b): ``ExecutorEvaluator()`` on the card scores the demo
    trio's candidates with ``evaluate_jobs``: each distinct DAG calibrated
    once, a resubmission served from the result cache, a ``ModelStore``
    version bump a miss; then ``fold_executor_timings(adanalytics(), ev)``
    re-parameterizes a card ``SimulatorEvaluator`` that scores a round-robin
    configuration of the calibrated DAG."""
    import numpy as np
    from repro_torch.control import ModelStore, fold_executor_timings
    from repro_torch.core import round_robin_configuration
    from repro_torch.streams import ExecutorEvaluator, SimulatorEvaluator, adanalytics
    from repro_torch.streams import executor

    tenants, groups = trio_candidates(params)
    n = sum(len(g) for g in groups)
    loads = [t.target_ktps for t in tenants]
    store = ModelStore(tenants[0].models)
    calls = []
    calibrate = executor.calibrate_dag

    def counting(dag, **kw):
        calls.append(dag.name)
        return calibrate(dag, **kw)

    executor.calibrate_dag = counting
    try:
        ev = ExecutorEvaluator(version_source=store, device=_default(device))
        if ev.device.type != device.type:
            raise AssertionError(f"ExecutorEvaluator() resolved to {ev.device}")
        fig = {}
        t0 = time.perf_counter()
        first = ev.evaluate_jobs(groups, loads)
        fig["first_s"] = time.perf_counter() - t0
        if sorted(calls) != sorted(t.dag.name for t in tenants):
            raise AssertionError(f"calibrations {calls} for the trio's three DAGs")
        info0 = ev.result_cache.info()
        t0 = time.perf_counter()
        again = ev.evaluate_jobs(groups, loads)
        fig["resubmit_s"] = time.perf_counter() - t0
        info1 = ev.result_cache.info()
        if (info1["hits"] - info0["hits"], info1["misses"] - info0["misses"]) != (n, 0):
            raise AssertionError(f"resubmission: {info0} -> {info1} for {n} configurations")
        if ([[r.achieved_ktps for r in g] for g in again]
                != [[r.achieved_ktps for r in g] for g in first]):
            raise AssertionError("resubmission changed a result")
        ads = first[0][2]
        store.observe(ads.config, 0.9 * ads.achieved_ktps)
        if store.version == 0:
            raise AssertionError("observe did not bump the store's version")
        ev.evaluate_jobs(groups, loads)
        info2 = ev.result_cache.info()
        # every distinct (configuration, load) of the first call misses again
        if info2["misses"] - info1["misses"] != info0["misses"] or len(calls) != 3:
            raise AssertionError(f"after the version bump: {info1} -> {info2}, calibrations {calls}")
        fig["configurations"], fig["distinct"] = n, info0["misses"]
        fig["achieved"] = {t.name: [round(r.achieved_ktps, 3) for r in g]
                           for t, g in zip(tenants, first)}
        fig["bottlenecks"] = {t.name: [r.bottleneck for r in g] for t, g in zip(tenants, first)}
        if not all(r.achieved_ktps > 0 for g in first for r in g):
            raise AssertionError(f"a candidate scored 0: {fig['achieved']}")
        cal, cal_params = fold_executor_timings(adanalytics(), ev)
        if len(calls) != 4:
            raise AssertionError(f"fold_executor_timings: calibrations {calls}")
    finally:
        executor.calibrate_dag = calibrate
    fig["calibrated_s_per_ktuple"] = {n.name: n.cpu_cost_per_ktuple for n in cal.nodes}
    fig["sm_cost_scale"] = cal_params.sm_cost_per_ktuple / params.sm_cost_per_ktuple
    sim = SimulatorEvaluator(params=cal_params, duration_s=2.0, device=device)
    cfg = round_robin_configuration(cal, {n: 2 for n in cal.node_names}, 4, dim)
    t0 = time.perf_counter()
    res = sim.evaluate(cfg)
    _sync(device)
    fig["folded_sim"] = dict(achieved_ktps=res.achieved_ktps, bottleneck=res.bottleneck,
                             backend=sim._backend, s=time.perf_counter() - t0)
    if not (res.achieved_ktps > 0 and np.isfinite(res.achieved_ktps)):
        raise AssertionError(f"the folded simulator scored {res.achieved_ktps}")
    log(f"  executor evaluator: {json.dumps(fig)}")
    return fig


def _lp_seeded(seed):
    """``tests/test_lp.py``'s seeded problem ``100 + seed``."""
    import numpy as np
    rng = np.random.default_rng(100 + seed)
    n = int(rng.integers(2, 7))
    m_ub = int(rng.integers(1, 5))
    m_eq = int(rng.integers(0, 3))
    c = rng.normal(size=n)
    A_ub = rng.normal(size=(m_ub, n))
    b_ub = rng.uniform(0.5, 3.0, size=m_ub)
    A_eq, b_eq = np.zeros((0, n)), np.zeros(0)
    if m_eq:
        A_eq = rng.normal(size=(m_eq, n))
        x0 = rng.uniform(0, 1, size=n)
        b_eq = A_eq @ x0
        b_ub = np.maximum(b_ub, A_ub @ x0 + 0.1)
    return c, A_ub, b_ub, A_eq, b_eq


def _lp_check(label, status, fun, ref):
    if status != ref.status:
        raise AssertionError(f"{label}: status {status}, numpy {ref.status}")
    if ref.status == 0 and not math.isclose(fun, ref.fun, rel_tol=LP_REL, abs_tol=LP_ABS):
        raise AssertionError(f"{label}: fun {fun}, numpy {ref.fun}")


def solve_flow_lp(prob, b_ub, dtype, device):
    """One flow LP (or a batch of them) with ``maxiter`` stepped through
    ``LP_MAXITERS`` until every row is optimal.  Returns ``(rates, statuses,
    attempts)``."""
    from repro_torch.core import lp
    attempts = []
    for maxiter in LP_MAXITERS:
        _sync(device)
        t0 = time.perf_counter()
        _, fun, status = lp.torch_linprog(-prob.c, prob.A_ub, b_ub, prob.A_eq, prob.b_eq,
                                          maxiter=maxiter, dtype=dtype, device=_default(device))
        status = status.reshape(-1).cpu().numpy()
        rates = -fun.reshape(-1).double().cpu().numpy()
        attempts.append(dict(maxiter=maxiter, s=time.perf_counter() - t0,
                             optimal=int((status == 0).sum())))
        if (status == 0).all() or attempts[-1]["s"] > LP_MAX_SOLVE_S:
            break
    return rates, status, attempts


def phase_flow_lps(device, params, dim):
    """Phase 3e (c), the flow LPs: ``build_flow_problem`` of deep_pipeline
    allocations at ``LP_TARGETS``, each solved at B = 1 and at B = 32 with
    ``b_ub`` scaled by seeded factors in [0.9, 1.1] (row 0 unscaled), in
    float64 and float32, against numpy's ``linprog``.  Gated: float64 at B =
    1 optimal and at numpy's rate to rel 1e-6 up to 1,000 ktps.  Stops at the
    first size whose B = 32 float64 tableau would pass 8 GiB or one of whose
    solves takes more than 30 s."""
    import numpy as np
    import torch
    from repro_torch.core import allocate, build_flow_problem, lp, oracle_models
    from repro_torch.streams import deep_pipeline

    dag = deep_pipeline()
    models = oracle_models(dag, params.sm_cost_per_ktuple)
    rows_out = []
    for target in LP_TARGETS:
        cfg = allocate(dag, models, target, preferred_dim=dim).config
        prob = build_flow_problem(cfg, models)
        nv, m = prob.c.shape[0], prob.A_ub.shape[0] + prob.A_eq.shape[0]
        cells = (m + 1) * (nv + prob.A_ub.shape[0] + m + 1)
        if cells * 8 * LP_BATCH > LP_MAX_TABLEAU_BYTES:
            log(f"  flow LP at {target} ktps: a B = {LP_BATCH} float64 tableau passes 8 GiB; stop")
            break
        t0 = time.perf_counter()
        ref = lp.linprog_maximize(prob.c, A_ub=prob.A_ub, b_ub=prob.b_ub, A_eq=prob.A_eq,
                                  b_eq=prob.b_eq)
        numpy_s = time.perf_counter() - t0
        scale = np.random.default_rng(int(target)).uniform(0.9, 1.1, size=(LP_BATCH, 1))
        scale[0] = 1.0
        # numpy checks as many scaled rows as its solve time allows
        n_check = LP_BATCH if numpy_s < 0.1 else (4 if numpy_s < 2.0 else 1)
        refs = [ref.fun] + [lp.linprog_maximize(prob.c, A_ub=prob.A_ub,
                                                b_ub=prob.b_ub * scale[i, 0], A_eq=prob.A_eq,
                                                b_eq=prob.b_eq).fun
                            for i in range(1, n_check)]
        slow = False
        for dtype in (torch.float64, torch.float32):
            for B in (1, LP_BATCH):
                rates, status, attempts = solve_flow_lp(
                    prob, prob.b_ub if B == 1 else prob.b_ub[None] * scale, dtype, device)
                optimal = bool((status == 0).all())
                checked = min(B, n_check)
                errs = [abs(rates[i] - refs[i]) / refs[i] for i in range(checked) if status[i] == 0]
                row = dict(target_ktps=target, instances=sum(len(p) for p in cfg.packing),
                           variables=nv, rows=m, B=B, dtype=str(dtype).replace("torch.", ""),
                           tableau_bytes=cells * dtype.itemsize * B,
                           status=sorted({int(s) for s in status}),
                           least_maxiter=attempts[-1]["maxiter"] if optimal else None,
                           s=attempts[-1]["s"], attempts=attempts,
                           rate_rel_err=max(errs) if errs else None, rows_checked=checked,
                           numpy_s=numpy_s, numpy_rate=ref.fun)
                log(f"  flow LP: {json.dumps(row)}")
                rows_out.append(row)
                if dtype == torch.float64 and B == 1 and target <= 1000.0 and (
                        not optimal or row["rate_rel_err"] > 1e-6):
                    raise AssertionError(f"float64 flow LP at {target} ktps: {row}")
                slow = slow or any(a["s"] > LP_MAX_SOLVE_S for a in attempts)
        if slow:
            log(f"  flow LP at {target} ktps: a solve took more than {LP_MAX_SOLVE_S} s; stop")
            break
    return rows_out


def phase_batched_lp(device, params, dim):
    """Phase 3e (c): ``torch_linprog`` on the card against numpy's
    ``linprog`` (the seeded suite of ``tests/test_lp.py`` and
    ``benchmarks/bench_speed.py``'s 24 x 16 problem batched 256 ways), the
    flow LPs (``phase_flow_lps``), and ``fit_many_torch`` against numpy's
    float64 least squares on (700, 64) seeded samples."""
    import numpy as np
    from repro_torch.core import lp
    from repro_torch.core.node_model import fit_many_torch

    dev = _default(device)
    fig = {}
    for seed in range(10):
        c, A_ub, b_ub, A_eq, b_eq = _lp_seeded(seed)
        x, fun, status = lp.torch_linprog(c, A_ub, b_ub, A_eq, b_eq, device=dev)
        if x.device.type != device.type:
            raise AssertionError(f"torch_linprog ran on {x.device}")
        _lp_check(f"seeded {seed}", int(status), float(fun),
                  lp.linprog(c, A_ub=A_ub, b_ub=b_ub, A_eq=A_eq, b_eq=b_eq))
    rng = np.random.default_rng(0)
    n, m = 24, 16
    c = rng.normal(size=n)
    A = np.abs(rng.normal(size=(m, n))) + 0.05
    b = rng.uniform(1, 4, size=m)
    bs = np.tile(b, (256, 1)) * rng.uniform(0.8, 1.2, size=(256, 1))
    A_eq, b_eq = np.zeros((0, n)), np.zeros((256, 0))
    lp.torch_linprog(c, A, bs, A_eq, b_eq, device=dev)        # warm up
    _sync(device)
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        _, funs, statuses = lp.torch_linprog(c, A, bs, A_eq, b_eq, device=dev)
    _sync(device)
    batch_s = (time.perf_counter() - t0) / reps
    t0 = time.perf_counter()
    refs = [lp.linprog(c, A_ub=A, b_ub=bb) for bb in bs]
    numpy_s = (time.perf_counter() - t0) / len(bs)
    for i, r in enumerate(refs):
        _lp_check(f"24 x 16 row {i}", int(statuses[i]), float(funs[i]), r)
    fig["bench_256"] = dict(batch_s=batch_s, per_lp_us=batch_s / 256 * 1e6,
                            numpy_single_us=numpy_s * 1e6)
    log(f"  24 x 16 LP batched 256 ways: {json.dumps(fig['bench_256'])}")
    fig["flow"] = phase_flow_lps(device, params, dim)

    rng = np.random.default_rng(7)
    rate = rng.uniform(10.0, 900.0, size=(700, 64))
    y = (rng.uniform(1e-3, 3e-3, size=(700, 1)) * rate + rng.uniform(0.05, 0.3, size=(700, 1))
         + rng.normal(scale=0.01, size=(700, 64)))
    slope, intercept, r2 = (t.cpu().numpy().astype(np.float64)
                            for t in fit_many_torch(rate, y, device=dev))
    want = np.array([np.linalg.lstsq(np.stack([rate[i], np.ones(64)], 1), y[i], rcond=None)[0]
                     for i in range(700)])
    resid = y - (want[:, :1] * rate + want[:, 1:])
    yc = y - y.mean(1, keepdims=True)
    r2_want = 1.0 - (resid ** 2).sum(1) / (yc ** 2).sum(1)
    fit_err = max(float(np.max(np.abs(got - w) / np.abs(w)))
                  for got, w in ((slope, want[:, 0]), (intercept, want[:, 1]), (r2, r2_want)))
    if fit_err > 1e-4:
        raise AssertionError(f"fit_many_torch against numpy's least squares: rel {fit_err}")
    fig["fit_rel_err"] = fit_err
    log(f"  fit_many_torch (700, 64) against numpy float64 least squares: max rel {fit_err:.3e}")
    return fig


# ------------------------------------------------------------ LM kernels

LLAMA = dict(d=4096, H=32, KV=8, hd=128)
SEAMLESS_PARAMS = 2_035_935_232     # seamless-m4t-large-v2, the reference's n_params()
INTERNVL_LAYERS = 8                 # internvl2-26b's cut: 8 of its 48 layers, full width
OLMOE_PARAMS = 6_919_096_320        # olmoe-1b-7b, the reference's n_params()
MIXTRAL_LAYERS = 8                  # mixtral-8x7b's cut: 8 of its 32 layers, full width
MIXTRAL_CUT_PARAMS = 11_872_309_248 # the cut's parameters, as the reference counts them
MINICPM_PARAMS = 4_262_025_728      # minicpm3-4b, the reference's n_params()
ROUTER_MARGIN = 1e-5                # expert ids gated where the k-th minus the (k+1)-th
                                    # router probability is above this
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


def check_add_rmsnorm(device, shapes) -> float:
    """The fused add-and-RMSNorm kernel against its plain version on seeded
    inputs, fp32 and bf16: ``s`` bit for bit ``x + delta``, ``h`` bit for
    bit the RMSNorm kernel on ``x + delta`` and within 1e-6 (fp32) or one
    bf16 ulp of the plain version.  Beside ``shapes``, an odd width and an
    unaligned view (one element into a buffer) take the generic path.
    Returns the largest fp32 absolute difference of ``h``."""
    import torch
    from repro_torch.kernels.rmsnorm import add_rmsnorm, add_rmsnorm_reference, rmsnorm

    g = torch.Generator(device=device).manual_seed(13)
    cases = []
    for shape in shapes:
        d = shape[-1]
        x = torch.randn(shape, generator=g, device=device)
        delta = 0.5 * torch.randn(shape, generator=g, device=device)
        cases.append((f"{tuple(shape)}", x, delta, d))
    d = 4096
    buf = torch.randn(2, 6 * d + 1, generator=g, device=device)
    cases.append((f"(6, {d}) unaligned view", buf[0, 1:].view(6, d), buf[1, 1:].view(6, d), d))
    x = torch.randn(4, 1, 4097, generator=g, device=device)
    cases.append(("(4, 1, 4097)", x, 0.5 * torch.randn(x.shape, generator=g, device=device), 4097))
    worst = 0.0
    for label, x32, delta32, d in cases:
        gain = 1.0 + 0.1 * torch.randn(d, generator=g, device=device)
        for x, delta in ((x32, delta32), (x32.bfloat16(), delta32.bfloat16())):
            s, h = add_rmsnorm(x, delta, gain, 1e-5)
            want_s, want_h = add_rmsnorm_reference(x, delta, gain, 1e-5)
            norm_of_sum = rmsnorm(x + delta, gain, 1e-5)
            torch.cuda.synchronize()
            name = f"add_rmsnorm {label} {str(x.dtype)[6:]}"
            if not torch.isfinite(h).all():
                raise AssertionError(f"{name}: non-finite output")
            if not torch.equal(s, want_s):
                raise AssertionError(f"{name}: s is not x + delta bit for bit")
            if not torch.equal(h, norm_of_sum):
                raise AssertionError(f"{name}: h is not rmsnorm(x + delta) bit for bit")
            err = (h.float() - want_h.float()).abs()
            if x.dtype == torch.float32:
                torch.testing.assert_close(h, want_h, rtol=RMS_FP32_TOL, atol=RMS_FP32_TOL)
                worst = max(worst, float(err.max()))
            elif not bool((err <= bf16_ulp(want_h)).all()):
                raise AssertionError(f"{name}: off by more than one bf16 ulp")
            log(f"  {name}: max|kernel-plain|={float(err.max()):.3e}, s and h bit-equal "
                f"to x + delta and rmsnorm(x + delta)")
    return worst


def flash_inputs(device, S, H, KV, hd, seed, Sk=None):
    """Seeded q (1, S, H, hd) and k, v (1, Sk, KV, hd), Sk = S by default."""
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    Sk = S if Sk is None else Sk
    return (torch.randn(1, S, H, hd, generator=g, device=device),
            torch.randn(1, Sk, KV, hd, generator=g, device=device),
            torch.randn(1, Sk, KV, hd, generator=g, device=device))


def check_flash(device, cases) -> float:
    """The flash kernel against its plain version (``attention_reference``'s
    semantics: keys masked by the real length) within 2e-5; returns the
    largest absolute difference.  A case is (S, H, KV, hd, causal, window)
    or, with keys of their own length (non-causal), (..., Sk)."""
    import torch
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_reference

    worst = 0.0
    for S, H, KV, hd, causal, window, *rest in cases:
        Sk = rest[0] if rest else S
        q, k, v = flash_inputs(device, S, H, KV, hd, seed=S * 7 + hd + (Sk if rest else 0),
                               Sk=Sk)
        scale = 1.0 / hd ** 0.5
        got = flash_attention(q, k, v, causal=causal, window=window, scale=scale)
        want = flash_attention_reference(q, k, v, causal=causal, window=window, scale=scale)
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            raise AssertionError(f"flash S={S} Sk={Sk} hd={hd}: non-finite output")
        torch.testing.assert_close(got, want, rtol=FLASH_TOL, atol=FLASH_TOL)
        err = float((got - want).abs().max())
        worst = max(worst, err)
        log(f"  flash S={S} Sk={Sk} H={H} KV={KV} hd={hd} causal={causal} window={window}: "
            f"max|kernel-plain|={err:.3e}")
    return worst


def mla_flash_inputs(device, S, H, qk, v_width, seed):
    """MLA's prefill call: seeded q and k (1, S, H, qk) and v at its own
    width, and v zero-padded to qk as the model passes it to the kernel."""
    import torch.nn.functional as F
    q, k, v = flash_inputs(device, S, H, H, qk, seed)
    v = v[..., :v_width].contiguous()
    return q, k, v, F.pad(v, (0, qk - v_width)).contiguous()


def check_flash_mla(device, lengths, H, qk, v_width) -> float:
    """The flash kernel at MLA's prefill (``mla_prefill``: H heads, q and k
    ``[nope ‖ rope]`` at ``qk``, v zero-padded from ``v_width`` to ``qk``,
    scale 1/sqrt(qk), causal) against its plain version on the padded
    inputs within 2e-5; the padded output columns exactly zero, and the
    rest within 2e-5 of attention with v at its own width.  Returns the
    largest absolute difference from the plain version."""
    import torch
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_reference

    worst = 0.0
    for S in lengths:
        q, k, v, vpad = mla_flash_inputs(device, S, H, qk, v_width, seed=S * 7 + qk)
        scale = 1.0 / qk ** 0.5
        got = flash_attention(q, k, vpad, causal=True, scale=scale)
        want = flash_attention_reference(q, k, vpad, causal=True, scale=scale)
        scores = torch.einsum("bshd,bthd->bhst", q, k) * scale
        mask = torch.ones(S, S, dtype=torch.bool, device=device).tril()
        narrow = torch.einsum("bhst,bthd->bshd",
                              torch.softmax(torch.where(mask, scores, -1e30), dim=-1), v)
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            raise AssertionError(f"flash MLA S={S}: non-finite output")
        torch.testing.assert_close(got, want, rtol=FLASH_TOL, atol=FLASH_TOL)
        if not torch.equal(got[..., v_width:], torch.zeros_like(got[..., v_width:])):
            raise AssertionError(f"flash MLA S={S}: padded output columns are not zero")
        torch.testing.assert_close(got[..., :v_width], narrow, rtol=FLASH_TOL, atol=FLASH_TOL)
        err = float((got - want).abs().max())
        worst = max(worst, err)
        log(f"  flash MLA S={S} H={H} qk={qk} v {v_width} padded to {qk}: "
            f"max|kernel-plain|={err:.3e}, "
            f"max|kernel-narrow v|={float((got[..., :v_width] - narrow).abs().max()):.3e}")
    return worst


KEY_SHARDS = 16                     # minicpm3-4b's 40 heads over tp 16: keys split instead


def check_flash_key_split(device, lengths, H, qk, v_width, shards=KEY_SHARDS) -> float:
    """Attention split over the keys as MLA's sharded prefill and training
    run it where the heads do not divide the 'model' ranks (minicpm3-4b's
    40 heads at tp 16): for each of ``shards`` ranks, its local function
    (``models.attention.key_shard_forward``: the flash kernel on the
    rank's two key chunks at their key offsets), the partial results
    combined (``combine_partials``), then each rank's backward
    (``key_shard_backward``: the backward kernel on its chunks with the
    combined row statistics) summed; against the flash kernel and its
    backward over the whole keys, at MLA's widths (q and k ``qk``, v
    zero-padded from ``v_width``, scale 1/sqrt(qk), causal): the output
    and row log-sum-exps within the flash gate (2e-5), each gradient
    within 1e-4 of its largest entry.  Returns the largest output
    difference."""
    import torch
    from repro_torch.kernels.flash_attention import flash_attention_backward, flash_attention_with_lse
    from repro_torch.models.attention import (
        combine_partials, key_shard_backward, key_shard_forward,
    )

    worst = 0.0
    for S in lengths:
        q, k, _, v = mla_flash_inputs(device, S, H, qk, v_width, seed=S * 11 + qk)
        g = torch.Generator(device=device).manual_seed(S)
        dout = torch.randn(q.shape, generator=g, device=device)
        scale = 1.0 / qk ** 0.5
        out_w, lse_w = flash_attention_with_lse(q, k, v, causal=True, scale=scale)
        grads_w = flash_attention_backward(q, k, v, out_w, dout, causal=True, scale=scale,
                                           lse=lse_w)
        parts = [p for r in range(shards) for p in key_shard_forward(q, k, v, r, shards, scale)]
        out, lse = combine_partials(parts)
        grads = [torch.zeros_like(t) for t in (q, k, v)]
        for r in range(shards):
            for acc, part in zip(grads, key_shard_backward(q, k, v, out, dout, lse, r, shards,
                                                           scale)):
                acc += part
        torch.cuda.synchronize()
        if not all(bool(torch.isfinite(t).all()) for t in (out, lse, *grads)):
            raise AssertionError(f"flash key split S={S}: non-finite output or gradient")
        torch.testing.assert_close(out, out_w, rtol=FLASH_TOL, atol=FLASH_TOL)
        torch.testing.assert_close(lse, lse_w, rtol=FLASH_TOL, atol=FLASH_TOL)
        rel = {}
        for name, got, want in zip(("dq", "dk", "dv"), grads, grads_w):
            rel[name] = float((got - want).abs().max()) / float(want.abs().max())
            if rel[name] > 1e-4:
                raise AssertionError(f"flash key split S={S}: {name} {rel[name]:.3e} of its "
                                     f"largest entry from the whole keys' backward (gate 1e-4)")
        err = float((out - out_w).abs().max())
        worst = max(worst, err)
        log(f"  flash split over the keys, {shards} shards x 2 chunks, S={S} H={H} qk={qk} "
            f"(v {v_width} padded): max|out - whole keys| {err:.3e}, lse "
            f"{float((lse - lse_w).abs().max()):.3e}; gradients of their largest entry "
            + ", ".join(f"{n} {v:.3e}" for n, v in rel.items()))
    return worst


def _bytes_or_flops(nbytes, flops) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def rmsnorm_bound(rows, d) -> tuple[float, str]:
    """fp32, ``kernels/rmsnorm/cost.py::rmsnorm_cost``."""
    from repro_torch.kernels.rmsnorm.cost import rmsnorm_cost

    flops, nbytes = rmsnorm_cost(rows, d)
    return _bytes_or_flops(nbytes, flops)


def add_rmsnorm_bound(rows, d) -> tuple[float, str]:
    """fp32, ``kernels/rmsnorm/cost.py::add_rmsnorm_cost``."""
    from repro_torch.kernels.rmsnorm.cost import add_rmsnorm_cost

    flops, nbytes = add_rmsnorm_cost(rows, d)
    return _bytes_or_flops(nbytes, flops)


def flash_bound(S, H, KV, hd, Sk=None, causal=True, v_width=None) -> tuple[float, str]:
    """Attention of S queries of one batch row, fp32
    (``kernels/flash_attention/cost.py::flash_cost``): causal over S
    positions, non-causal over Sk keys (S by default); v's width
    ``v_width`` (hd by default: MLA's v is narrower than q and k, and the
    work counted is the function's, not the zero-padded columns the kernel
    runs).  Two ways to do the products: fp32 on CUDA cores (all flops at
    67 TFLOP/s), or 3xTF32 on the tensor cores (three tf32 products per
    product at 495 TFLOP/s, the softmax on CUDA cores); each is held
    against the bytes, and the bound is the faster of the two."""
    from repro_torch.kernels.flash_attention.cost import flash_cost

    Sk = S if Sk is None else Sk
    mm_flops, soft_flops, nbytes = flash_cost(1, S, Sk, H, KV, hd, v_width, causal)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_fp32 = (mm_flops + soft_flops) / FP32_FLOPS_PER_S
    t_tc = 3 * mm_flops / TF32_FLOPS_PER_S + soft_flops / FP32_FLOPS_PER_S
    t_ops = min(t_fp32, t_tc)
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def excess_ms(runs) -> float:
    """Sum of launches x (device time - bound) over (launches, timing)
    pairs: the time a kernel spends above its bound on a path."""
    return sum(n * (t["ms"] - t["bound_ms"]) for n, t in runs)


def input_ring(make, call_bytes: int) -> list:
    """The input sets a norm's timing cycles through: one at decode (4
    rows, under 1 MiB a call, where launch and latency set the time), else
    enough that three L2s of traffic pass between two calls on one set.
    ``make(i)`` builds set i."""
    n = 1 if call_bytes < 2**20 else -(-3 * L2_BYTES // call_bytes)
    return [make(i) for i in range(n)]


def cycling(fn, sets):
    """``fn`` called on the next input set at each call."""
    it = itertools.cycle(sets)
    return lambda: fn(*next(it))


def time_rmsnorm(device, shape) -> dict:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_reference

    g = torch.Generator(device=device).manual_seed(5)
    gain = 1.0 + 0.1 * torch.randn(shape[-1], generator=g, device=device)
    rows = math.prod(shape[:-1])
    sets = input_ring(lambda i: (torch.randn(shape, generator=g, device=device),),
                      2 * rows * shape[-1] * 4)
    ms, eager_ms = time_both(cycling(lambda x: rmsnorm(x, gain, 1e-5), sets), iters=200)
    plain_ms, plain_eager = time_both(
        cycling(lambda x: rmsnorm_reference(x, gain, 1e-5), sets), iters=200)
    library_ms, library_eager = time_both(
        cycling(lambda x: F.rms_norm(x, (shape[-1],), gain, 1e-5), sets), iters=200)
    bound_ms, bound_by = rmsnorm_bound(rows, shape[-1])
    log(f"  rmsnorm {tuple(shape)} device (graph, {len(sets)} input sets in turn): kernel "
        f"{ms:.5f} ms  plain {plain_ms:.5f} ms  F.rms_norm {library_ms:.5f} ms  bound "
        f"{bound_ms:.6f} ms ({bound_by}); eager with launch cost: kernel {eager_ms:.5f}  "
        f"plain {plain_eager:.5f}  F.rms_norm {library_eager:.5f} ms")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def time_add_rmsnorm(device, shape) -> dict:
    """The fused kernel, its plain version and, as the yardstick, the two
    calls it replaces (``x + delta``, then ``F.rms_norm``); no single
    PyTorch call computes the fused function, so ``library_ms`` is None."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.rmsnorm import add_rmsnorm, add_rmsnorm_reference

    g = torch.Generator(device=device).manual_seed(6)
    gain = 1.0 + 0.1 * torch.randn(shape[-1], generator=g, device=device)
    rows = math.prod(shape[:-1])
    sets = input_ring(lambda i: (torch.randn(shape, generator=g, device=device),
                                 0.5 * torch.randn(shape, generator=g, device=device)),
                      4 * rows * shape[-1] * 4)
    ms, eager_ms = time_both(
        cycling(lambda x, delta: add_rmsnorm(x, delta, gain, 1e-5), sets), iters=200)
    plain_ms, plain_eager = time_both(
        cycling(lambda x, delta: add_rmsnorm_reference(x, delta, gain, 1e-5), sets), iters=200)
    pair_ms, pair_eager = time_both(
        cycling(lambda x, delta: F.rms_norm(x + delta, (shape[-1],), gain, 1e-5), sets),
        iters=200)
    bound_ms, bound_by = add_rmsnorm_bound(rows, shape[-1])
    log(f"  add_rmsnorm {tuple(shape)} device (graph, {len(sets)} input sets in turn): kernel "
        f"{ms:.5f} ms  plain {plain_ms:.5f} ms  two calls x + delta, F.rms_norm {pair_ms:.5f} ms  "
        f"bound {bound_ms:.6f} ms ({bound_by}); eager with launch cost: kernel {eager_ms:.5f}  "
        f"plain {plain_eager:.5f}  two calls {pair_eager:.5f} ms")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms,
                bound_by=bound_by, pair_ms=pair_ms)


def time_flash(device, S, H=LLAMA["H"], KV=LLAMA["KV"], hd=LLAMA["hd"], Sk=None,
               causal=True, window=None, v_width=None) -> dict:
    """The flash kernel, its plain version and SDPA at (S, H, KV, hd),
    causal (within ``window``) or over Sk keys, beside its bound.  With
    ``v_width`` (MLA's prefill) v is that wide and zero-padded to hd for
    the kernel and its plain version, as the model passes it; SDPA takes v
    at its own width, and the kernel's output is compared to it up to that
    width.  SDPA takes no window: at S within the window it computes the
    same function causal."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_reference

    if v_width is None:
        q, k, v = flash_inputs(device, S, H, KV, hd, seed=S + H + (Sk or 0), Sk=Sk)
        v_lib = v
    else:
        q, k, v_lib, v = mla_flash_inputs(device, S, H, hd, v_width, seed=S + H)
    if window is not None and S > window:
        raise ValueError(f"SDPA has no window: S={S} over the window {window}")
    scale = 1.0 / hd ** 0.5
    kernel = lambda **kw: flash_attention(q, k, v, causal=causal, window=window, scale=scale,
                                          **kw)
    ms, eager_ms = time_both(kernel, iters=50)
    out = kernel()[..., :v_lib.shape[-1]]
    plain_ms, plain_eager = time_both(
        lambda: flash_attention_reference(q, k, v, causal=causal, window=window, scale=scale),
        iters=50)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v_lib))
    sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal, scale=scale,
                                                  enable_gqa=True)
    library_ms, library_eager = time_both(sdpa, iters=50)
    lib_err = float((sdpa().transpose(1, 2) - out).abs().max())
    bound_ms, bound_by = flash_bound(S, H, KV, hd, Sk=Sk, causal=causal, v_width=v_width)
    # the two block layouts, forced, beside the one the wrapper picks
    layouts = []
    for heads in (1, 2):
        blocks = -(-S // 16) * KV * -(-(H // KV) // heads)
        forced = graph_ms(lambda: kernel(heads_per_block=heads), iters=20)
        layouts.append(f"{heads} head(s)/block {blocks} blocks {forced:.5f} ms")
    shape = (f"S={S}" + ("" if causal else f" Sk={Sk or S} non-causal")
             + ("" if window is None else f" window={window}")
             + ("" if v_width is None else f" v {v_width} padded to {hd}"))
    log(f"  flash {shape} H={H} KV={KV} hd={hd} device (graph): kernel {ms:.5f} ms  "
        f"plain {plain_ms:.5f} ms  "
        f"sdpa {library_ms:.5f} ms (max|sdpa-kernel|={lib_err:.2e})  bound {bound_ms:.6f} ms "
        f"({bound_by}); eager with launch cost: kernel {eager_ms:.5f}  plain {plain_eager:.5f}  "
        f"sdpa {library_eager:.5f} ms; forced: {', '.join(layouts)}")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def block_counts(cfg) -> dict:
    """Blocks of each kind over the whole depth."""
    return {kind: cfg.n_periods() * cfg.pattern().count(kind)
            for kind in ("attn", "mamba", "mlstm", "slstm")}


def inner_norms(cfg) -> int:
    """xLSTM blocks' own norms of one forward: mLSTM's over its inner
    width, sLSTM's after its recurrence (``rmsnorm`` launches beside the
    residual stream's)."""
    n = block_counts(cfg)
    return n["mlstm"] + n["slstm"]


def moe_layers(cfg) -> int:
    """Blocks whose feed-forward is an MoE layer (``idx % moe_every ==
    moe_every - 1`` within the period) over the whole depth."""
    per = sum(1 for i in range(len(cfg.pattern())) if i % cfg.moe_every == cfg.moe_every - 1)
    return cfg.n_periods() * per if cfg.is_moe else 0


def ffn_blocks(cfg) -> int:
    """Blocks with a feed-forward half (a dense MLP or an MoE layer) over
    the whole depth."""
    return cfg.n_layers if cfg.d_ff > 0 else moe_layers(cfg)


def latent_norms(cfg) -> int:
    """MLA's latent norms of one forward: q's and kv's in every attention
    block (``rmsnorm`` launches beside the residual stream's)."""
    return 2 * block_counts(cfg)["attn"] if cfg.attention == "mla" else 0


def norms_per_forward(cfg) -> int:
    """Residual-stream RMSNorms of one decoder forward: one before each
    block's mixer, one before each feed-forward (dense or MoE), one before
    each cross-attention sub-block of an encoder-decoder model, and the
    final one."""
    cross = cfg.n_layers if cfg.is_encdec else 0
    return cfg.n_layers + ffn_blocks(cfg) + cross + 1


def expected_launches(cfg, forwards, prefills) -> dict:
    """Kernel launches of ``forwards`` forward passes, ``prefills`` of them
    prefills: per forward, the first norm (on the embedding) alone and every
    other norm fused with the residual add before it, and one selective scan
    per Mamba block (the decode step runs the kernel with S = 1); one flash
    launch per attention block each prefill (decode attention is plain
    torch).  An encoder-decoder model's prefill adds its encoder (E layers:
    one ``rmsnorm``, 2E ``add_rmsnorm``, E non-causal flash launches) and
    one non-causal flash launch per cross-attention sub-block (its decode
    step reads the cached cross K/V with plain torch).  An MLA model adds
    its two latent norms per attention block to every forward's
    ``rmsnorm`` launches, an xLSTM model its blocks' inner norms.  Serving
    launches no backward kernel."""
    n = block_counts(cfg)
    E = cfg.enc_layers if cfg.is_encdec else 0
    cross = cfg.n_layers if cfg.is_encdec else 0
    return dict(rmsnorm=forwards * (1 + latent_norms(cfg) + inner_norms(cfg))
                + (prefills if E else 0),
                add_rmsnorm=(norms_per_forward(cfg) - 1) * forwards + 2 * E * prefills,
                flash_attention=(n["attn"] + cross + E) * prefills,
                ssm_scan=n["mamba"] * forwards, rmsnorm_backward=0, add_rmsnorm_backward=0,
                flash_attention_backward=0, ssm_scan_backward=0)


def decode_floor(model, caches) -> tuple[float, int, int]:
    """The least time of one decode forward: the bytes it must read once
    over the card's memory rate.  Weights: every parameter a decode step
    reads (not the encoder or ``frontend_proj``, which run at prefill; not
    the cross-attention's ``wk``/``wv``, whose K/V are cached; not the
    embedding table, of which it gathers one row a slot, unless it is also
    the head); caches: every K/V, Mamba state and cross K/V tensor, which
    decode attention and the scan read whole.  Returns (ms, weight bytes,
    cache bytes)."""
    def read(name):
        if name.startswith(("encoder.", "frontend_proj")):
            return False
        if name.startswith("cross.") and name.endswith((".wk", ".wv")):
            return False
        return name != "embed" or not hasattr(model, "lm_head")

    weights = sum(p.numel() * p.element_size() for n, p in model.named_parameters() if read(n))
    cache = sum(t.numel() * t.element_size() for layer in caches.values() for t in layer.values())
    return (weights + cache) / HBM_BYTES_PER_S * 1e3, weights, cache


def model_kernels() -> dict:
    """The LM kernels' wrappers by name, forward and backward."""
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_backward
    from repro_torch.kernels.rmsnorm import (
        add_rmsnorm, add_rmsnorm_backward, rmsnorm, rmsnorm_backward,
    )
    from repro_torch.kernels.ssm_scan import ssm_scan, ssm_scan_backward
    return dict(rmsnorm=rmsnorm, add_rmsnorm=add_rmsnorm, flash_attention=flash_attention,
                ssm_scan=ssm_scan, rmsnorm_backward=rmsnorm_backward,
                add_rmsnorm_backward=add_rmsnorm_backward,
                flash_attention_backward=flash_attention_backward,
                ssm_scan_backward=ssm_scan_backward)


def kernel_launches() -> dict:
    return {name: fn.launches for name, fn in model_kernels().items()}


def zero_launches() -> None:
    for fn in model_kernels().values():
        fn.launches = 0


@contextlib.contextmanager
def first_step_grads(module, keep: bool = True):
    """For the ``with`` block, wraps ``module.adamw_update`` (the train
    loop's or the bundles' name for it) so that the first step's gradients,
    as the update receives them, are made whole and copied to the host
    into the yielded dict of name -> tensor.  ``keep=False`` makes them
    whole (a collective that every rank of a sharded step joins) and keeps
    none."""
    update, grads0, taken = module.adamw_update, {}, []

    def recorded(cfg, params, grads, state):
        if not taken:
            taken.append(True)
            for n, g in grads.items():
                full = (g.full_tensor() if hasattr(g, "full_tensor") else g).detach()
                if keep:
                    grads0[n] = full.to("cpu", copy=True)
        return update(cfg, params, grads, state)

    module.adamw_update = recorded
    try:
        yield grads0
    finally:
        module.adamw_update = update


@contextlib.contextmanager
def optimizer_steps_replayed(module, keep: bool = True, device="cpu"):
    """For the ``with`` block, wraps ``module.adamw_update`` (the bundles'
    name for it) so that each step's update is replayed on one device: the
    parameters, gradients and optimizer state as the update receives them
    are made whole, ``adamw_update`` runs on those copies on ``device``,
    and each leaf's largest difference from the sharded update's result,
    over that result's largest entry, is appended to the yielded list (a
    dict name -> error per step).  This holds the sharded update alone,
    whatever its gradients' rounding.  ``keep=False`` makes every tensor
    whole (a collective that every rank of a sharded step joins) and keeps
    none."""
    from repro_torch.optim.optimizer import adamw_update

    update, errors = module.adamw_update, []

    def whole(t):
        return (t.full_tensor() if hasattr(t, "full_tensor") else t).detach()

    def copies(tree):
        out = {}
        for n, t in tree.items():
            if isinstance(t, dict):
                out[n] = copies(t)
            else:
                full = whole(t)
                if keep:
                    out[n] = full.to(device, copy=True)
                del full
        return out

    def recorded(cfg, params, grads, state):
        before = copies({"params": params, "grads": grads, "state": state})
        params, state, om = update(cfg, params, grads, state)
        replayed = adamw_update(cfg, *before.values())[0] if keep else None
        del before
        step = {}
        for n, p in params.items():
            got = whole(p)
            if keep:
                got = got.to(device)
                step[n] = float((replayed[n] - got).abs().max()) / max(float(got.abs().max()),
                                                                        1e-30)
            del got
        if keep:
            errors.append(step)
        return params, state, om

    module.adamw_update = recorded
    try:
        yield errors
    finally:
        module.adamw_update = update


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
    """fp32 inputs (``kernels/ssm_scan/cost.py::ssm_scan_cost``).  Returns
    (bound ms, what bounds it, the expf time on the SFUs in ms)."""
    from repro_torch.kernels.ssm_scan.cost import ssm_scan_cost

    flops, nbytes = ssm_scan_cost(B, S, D, N)
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


class RouterLog:
    """While active, records every MoE layer's routing under the side named
    by ``side`` ("host" or "card"): the expert ids (T, k) and the router's
    margin, the k-th minus the (k+1)-th probability (T,), per token.  It
    wraps the transformer's ``moe_ffn`` with a second call of the same
    router on the same input (a DTensor's gathered whole), so the layer's
    own computation is untouched."""

    def __init__(self):
        self.calls = {"host": [], "card": []}
        self.side = "host"

    def __enter__(self):
        import types

        import torch
        from repro_torch.models import moe, transformer

        inner = self._inner = transformer.moe_ffn

        def recorded(p, x, cfg, need_aux=True):
            B, S, d = x.shape
            k = cfg.experts_per_token
            x_, router = (t.full_tensor() if hasattr(t, "full_tensor") else t
                          for t in (x, p.router))
            _, probs, _, ids = moe.route(types.SimpleNamespace(router=router),
                                         x_.reshape(moe._moe_groups(cfg, B * S), -1, d), cfg)
            top = torch.topk(probs, k + 1, dim=-1).values
            self.calls[self.side].append(
                (ids.reshape(-1, k).cpu(), (top[..., k - 1] - top[..., k]).reshape(-1).cpu()))
            return inner(p, x, cfg, need_aux)

        transformer.moe_ffn = recorded
        return self

    def __exit__(self, *exc):
        from repro_torch.models import transformer
        transformer.moe_ffn = self._inner


def check_routing(label, host_calls, card_calls):
    """The tie rule: layer by layer in the order the forwards ran, the card's
    set of experts equals the host's at every token whose host margin is
    above ``ROUTER_MARGIN``.  Their order within the top k is not compared:
    a near-tie inside it swaps two choices with their gates, and a
    choice's capacity position counts earlier tokens, not ranks, so the
    dispatch and the output are the same.  At the first layer where ids differ, every differing
    token must be within the margin (a near-tie flipped by float rounding),
    else this raises; from there on the two runs route different tokens,
    so nothing after it is compared.  Returns (tokens compared, smallest
    margin, tokens within the margin, the flip as (layer, token, margin) or
    None)."""
    if len(host_calls) != len(card_calls):
        raise AssertionError(f"{label}: {len(card_calls)} MoE calls on the card, "
                             f"{len(host_calls)} on the host")
    n, smallest, near = 0, float("inf"), 0
    for layer, ((hid, hm), (cid, _)) in enumerate(zip(host_calls, card_calls)):
        smallest = min(smallest, float(hm.min()))
        near += int((hm <= ROUTER_MARGIN).sum())
        differ = (hid.sort(dim=1).values != cid.sort(dim=1).values).any(dim=1)
        if bool(differ.any()):
            over = differ & (hm > ROUTER_MARGIN)
            if bool(over.any()):
                t = int(over.nonzero()[0])
                raise AssertionError(
                    f"{label}: MoE call {layer}, token {t}: experts {cid[t].tolist()} on the "
                    f"card, {hid[t].tolist()} on the host at margin {float(hm[t]):.3e}")
            t = int(differ.nonzero()[0])
            return n, smallest, near, (layer, t, float(hm[t]))
        n += hid.shape[0]
    return n, smallest, near, None


def phase_card_vs_host(device, cfg, prompt_len, decode_steps, seed, keep=None):
    """The model ``cfg`` with the same seeded weights on the card and the
    host: one prefill and ``decode_steps`` decode steps on each (the host's
    greedy tokens fed to both), logits and every cache (K/V, MLA latents,
    Mamba states, an encoder-decoder model's ``cross_kv``) compared within
    rtol 1e-4, atol 1e-4·max|x|, and the greedy tokens equal.  A model
    with a frontend gets seeded non-zero frame embeddings (zeros, as the
    server feeds, would make the encoder's output and every cross-attention
    zero).

    An MoE model's routing is held to the tie rule (:func:`check_routing`)
    after each forward, before its logits.  If a near-tie flips, that
    forward's and later logits and the caches are logged, not gated: the
    two runs then compute different (both valid) functions.

    With ``keep`` (a dict) the two models are left in it as "host" and
    "card" for a later phase instead of being freed."""
    import numpy as np
    import torch
    from repro_torch.launch.serve import SEQUENCE_CACHES
    from repro_torch.models import build_model
    from repro_torch.models.frontends import frontend_embed_shape

    n_layers = cfg.n_layers
    t0 = time.perf_counter()
    host = build_model(cfg, device="cpu", seed=seed)
    card = build_model(cfg, device=device, seed=seed)
    card.load_state_dict(host.state_dict())
    log(f"  built {n_layers}-layer {cfg.name} on host and card ({host.n_params():,} params) "
        f"in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(seed)
    prompt = torch.as_tensor(rng.integers(4, cfg.vocab, size=(1, prompt_len)))
    frames = None
    if cfg.frontend is not None:
        frames = torch.as_tensor(
            rng.standard_normal(frontend_embed_shape(cfg, 1)).astype(np.float32))
    # positions the prefill fills: a decoder-only frontend's tokens come first
    filled = prompt_len + (cfg.frontend_tokens if frames is not None and not cfg.is_encdec else 0)
    zero_launches()
    worst = 0.0
    flipped = None

    def close(label, got, want):
        got = got.cpu()
        if not torch.isfinite(got).all():
            raise AssertionError(f"{label}: non-finite values on the card")
        atol = LOGIT_ATOL_REL * float(want.abs().max())
        if flipped is None:
            torch.testing.assert_close(got, want, rtol=LOGIT_RTOL, atol=atol)
        return float((got - want).abs().max()), atol

    def compare(label, got, want):
        """Logits over the real vocabulary within the tolerance (the padded
        rows are masked to -1e9, which would set atol); the masked tail
        bit for bit."""
        nonlocal worst
        V = cfg.vocab
        if not torch.equal(got[..., V:].cpu(), want[..., V:]):
            raise AssertionError(f"{label}: the padded vocabulary's masked logits differ")
        err, atol = close(label, got[..., :V], want[..., :V])
        if flipped is None:
            worst = max(worst, err)
        token, card_token = int(want[0, -1].argmax()), int(got[0, -1].argmax())
        log(f"  {label}: max|card-host| {err:.3e} (atol {atol:.3e}), "
            f"argmax card {card_token} host {token}"
            + ("" if flipped is None else " (after a router tie flipped: not gated)"))
        if card_token != token and flipped is None:
            raise AssertionError(f"{label}: greedy token {card_token} on the card, {token} on the host")
        return token

    routed = {"tokens": 0, "smallest": float("inf"), "near": 0}

    def routing(label, router, start):
        """The tie rule over the MoE calls of one forward on each side."""
        nonlocal flipped
        if flipped is not None:
            return
        n, smallest, near, flip = check_routing(label, router.calls["host"][start[0]:],
                                                router.calls["card"][start[1]:])
        routed["tokens"] += n
        routed["smallest"] = min(routed["smallest"], smallest)
        routed["near"] += near
        if flip is not None:
            flipped = (label, *flip)
            log(f"  {label}: a router tie flipped at MoE call {flip[0]}, token {flip[1]} "
                f"(host margin {flip[2]:.3e} <= {ROUTER_MARGIN}); later outputs not gated")

    with RouterLog() as router:                  # records nothing without MoE layers
        caches = {}
        for name, model in (("host", host), ("card", card)):
            dev = model.embed.device
            args = (prompt.to(dev),) if frames is None else (prompt.to(dev), frames.to(dev))
            router.side = name
            logits, c1 = model.forward_prefill(*args)
            big = model.cache_struct(1, filled + decode_steps + 1)
            for key, layer in c1.items():
                for n, t in layer.items():
                    if n in SEQUENCE_CACHES:             # K/V, cross K/V, MLA latents: padded
                        big[key][n][:, :, :t.shape[2]] = t
                    else:                                # a Mamba state, whole
                        big[key][n].copy_(t)
            caches[name] = (logits, big)
        routing("prefill", router, (0, 0))
        token = compare("prefill", caches["card"][0], caches["host"][0])
        for n, want in caches["host"][1].get("cross_kv", {}).items():
            err, atol = close(f"cross_kv {n}", caches["card"][1]["cross_kv"][n], want)
            log(f"  cross_kv {n} {tuple(want.shape)}: max|card-host| {err:.3e} "
                f"(atol {atol:.3e}), max|x| {float(want.abs().max()):.3e}")
        for step in range(decode_steps):
            pos = filled + step
            tok = torch.tensor([[token]])
            start = tuple(len(router.calls[side]) for side in ("host", "card"))
            router.side = "host"
            hl, _ = host.forward_decode(tok, caches["host"][1], pos)
            router.side = "card"
            cl, _ = card.forward_decode(tok.to(device), caches["card"][1], pos)
            routing(f"decode {step}", router, start)
            token = compare(f"decode {step}", cl, hl)
    for key, layer in caches["host"][1].items():
        for n, want in layer.items():
            err, atol = close(f"cache {key}.{n}", caches["card"][1][key][n], want)
            log(f"  cache {key}.{n} after decode: max|card-host| {err:.3e} (atol {atol:.3e})")
    if cfg.is_moe:
        log(f"  routing: {routed['tokens']} token-layers compared, expert sets equal; smallest "
            f"router margin {routed['smallest']:.3e}, {routed['near']} within {ROUTER_MARGIN}; "
            + ("no tie flipped" if flipped is None else f"a tie flipped at {flipped}"))
    torch.cuda.synchronize()
    want = expected_launches(cfg, forwards=1 + decode_steps, prefills=1)   # card only
    got = kernel_launches()
    if got != want:
        raise AssertionError(f"card launches {got}, expected {want}")
    if keep is not None:
        keep.update(host=host, card=card)
    del host, card, caches
    return worst


class MoEAuxLog:
    """While active, sums every MoE layer's aux values (``lb_loss``,
    ``z_loss``, ``dropped_frac``) into ``aux``: it wraps the transformer's
    ``moe_ffn`` and asks it for the aux that the serving path skips."""

    def __enter__(self):
        from repro_torch.models import transformer

        inner = self._inner = transformer.moe_ffn
        self.aux = {}

        def recorded(p, x, cfg, need_aux=True):
            y, aux = inner(p, x, cfg, need_aux=True)
            for k, v in aux.items():
                self.aux[k] = self.aux.get(k, 0.0) + float(v)
            return y, aux if need_aux else None

        transformer.moe_ffn = recorded
        return self

    def __exit__(self, *exc):
        from repro_torch.models import transformer
        transformer.moe_ffn = self._inner


def log_prefill_aux(server, requests) -> list[float]:
    """Each request's prompt prefilled once more, outside the timed
    serving run, with its MoE aux values logged as means over the MoE
    layers; returns the dropped shares."""
    import torch

    layers = moe_layers(server.cfg)
    dropped = []
    for r in requests:
        tokens = torch.as_tensor(r.prompt[None, :].astype("int64"), device=server.device)
        with MoEAuxLog() as aux_log:
            server.model.forward_prefill(tokens)
        a = {k: v / layers for k, v in aux_log.aux.items()}
        log(f"  prefill S={tokens.shape[1]}: dropped_frac {a['dropped_frac']:.4f} (mean of "
            f"{layers} MoE layers), lb_loss {a['lb_loss']:.4f}, z_loss {a['z_loss']:.4f} "
            f"(means; an untimed prefill of the prompt)")
        dropped.append(a["dropped_frac"])
    return dropped


def phase_serve(device, arch, seed, n_requests, slots, max_ctx, max_new):
    """``arch`` (a name or a config) behind ``BatchedServer`` on the card:
    seeded prompts of 32-192 tokens, greedy decoding, with the kernels'
    launch counts held to :func:`expected_launches`.  Returns the server,
    the launches, the prompt lengths and the serving figures (median
    decode tick beside its floor, tokens/s, TTFT, peak memory; an MoE
    model's dropped shares, from its prompts prefilled once more after
    the timed run)."""
    import numpy as np
    import torch
    from repro_torch.launch.serve import BatchedServer, Request

    t0 = time.perf_counter()
    before = torch.cuda.memory_allocated()
    server = BatchedServer(arch, batch_slots=slots, max_ctx=max_ctx, seed=seed,
                           device=device)
    torch.cuda.synchronize()
    log(f"  built {server.cfg.name} ({server.model.n_params():,} params, "
        f"{server.cfg.n_layers} layers"
        + (f" + {server.cfg.enc_layers} encoder layers" if server.cfg.is_encdec else "")
        + f") in {time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card, "
        f"{before / 2**30:.2f} GiB of it allocated before the build")
    floor_ms, floor_w, floor_c = decode_floor(server.model, server.caches)
    log(f"  decode floor {floor_ms:.4f} ms: {floor_w:,} bytes of weights a decode step reads "
        f"and {floor_c:,} bytes of caches ({slots} slots, max_ctx {max_ctx}) at "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s")
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
        queued = len(server.queue)
        t = time.perf_counter()
        server.step()
        torch.cuda.synchronize()
        if len(server.queue) == queued:              # a tick with no admission
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
    tick = float(np.median(decode_ms))
    log(f"  decode-only ticks: {len(decode_ms)}, median {tick:.3f} ms, "
        f"min {min(decode_ms):.3f} ms (floor {floor_ms:.4f} ms)")
    log(f"  peak memory {peak / 2**30:.2f} GiB ({peak} bytes)")
    log(f"  launches: {json.dumps(launches)} (expected {json.dumps(want)})")
    log(f"  first request's tokens: {server.completed[0].tokens_out}")
    figures = dict(name=server.cfg.name, n_params=server.model.n_params(), slots=slots,
                   decode_tick_ms=tick, decode_floor_ms=floor_ms, tok_s=n_tokens / wall,
                   ttft_median_ms=float(np.median(ttft)), peak_bytes=peak, wall_s=wall)
    if server.cfg.is_moe:
        figures["dropped_frac"] = log_prefill_aux(server, requests)
    return server, launches, [int(n) for n in lengths], figures


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
    decode_forward_launches(server, rng, prompt_len)


def decode_forward_launches(server, rng, prompt_len, steps=2):
    """Device launches of one decode forward under the profiler, for
    ``steps`` steps: every slot holds a request admitted beforehand, so each
    profiled step is one forward of the whole batch.  The profiler may drop
    events; the launch counters of phases 6 and 9 are the exact count."""
    import collections

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.serve import Request

    for rid in range(len(server.slots)):
        prompt = rng.integers(4, server.cfg.vocab, size=prompt_len).astype(np.int32)
        server.submit(Request(2000 + rid, prompt, 2 + steps))
    server.step()                                   # admits every slot, one decode
    for _ in range(steps):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            server.step()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
        kernels = [n for n in names if not n.startswith(("Memcpy", "Memset"))]
        norms = collections.Counter(n for n in kernels if "rmsnorm" in n)
        log(f"  one decode forward (profiler): {len(kernels)} kernel launches, "
            f"{len(names) - len(kernels)} copies/memsets; rmsnorm.cu's: "
            + ", ".join(f"{n} x {name[:90]}" for name, n in sorted(norms.items())))
    server.drain()


# ------------------------------------------------------------ MoE and MLA serving

def moe_mla_configs():
    """olmoe-1b-7b and minicpm3-4b whole, and mixtral-8x7b's 8-layer cut at
    full width (all 32 layers, 187 GB in fp32, do not fit one card)."""
    from repro_torch.configs import get_config
    mixtral = get_config("mixtral-8x7b")
    cut = dataclasses.replace(mixtral, n_layers=MIXTRAL_LAYERS,
                              name=f"mixtral-8x7b/{MIXTRAL_LAYERS}-of-32-layers")
    return get_config("olmoe-1b-7b"), cut, get_config("minicpm3-4b")


def check_moe_mla_kernels(device, prompt_lengths) -> tuple[float, float, float]:
    """Phase 4's checks at the MoE and MLA models' shapes: flash at
    olmoe's prefills (16/16 heads, hd 128), mixtral's (32/8, window 4096)
    and minicpm3's (40 heads, q/k 96, v 64 padded), and minicpm3's split
    over the keys of 16 ranks, forward and backward, against the whole
    keys (S = 512, 4096); rmsnorm at olmoe's and
    minicpm3's d (2048, 2560: block 0's first norm) and MLA's latent
    widths (768 and 256); add_rmsnorm at olmoe's and minicpm3's d;
    prefill rows and batch-4 decode rows.  Mixtral's d is llama3-8b's
    4096, checked at the same rows above.  Returns the
    largest flash, rmsnorm and add_rmsnorm differences from the plain
    versions."""
    olmoe, mixtral, minicpm = moe_mla_configs()
    m = minicpm.mla
    flash_err = check_flash(
        device,
        [(S, olmoe.n_heads, olmoe.n_kv_heads, olmoe.head_dim, True, None)
         for S in prompt_lengths]
        + [(S, mixtral.n_heads, mixtral.n_kv_heads, mixtral.head_dim, True,
            mixtral.sliding_window) for S in prompt_lengths])
    flash_err = max(flash_err, check_flash_mla(
        device, prompt_lengths, minicpm.n_heads, m.qk_nope_head_dim + m.qk_rope_head_dim,
        m.v_head_dim))
    flash_err = max(flash_err, check_flash_key_split(
        device, (512, 4096), minicpm.n_heads, m.qk_nope_head_dim + m.qk_rope_head_dim,
        m.v_head_dim))
    widths = (olmoe.d_model, minicpm.d_model, m.q_lora_rank, m.kv_lora_rank)
    rms_err = check_rmsnorm(device, [(1, S, w) for w in widths for S in prompt_lengths]
                            + [(4, 1, w) for w in widths])
    add_err = check_add_rmsnorm(device, [(1, S, w) for w in (olmoe.d_model, minicpm.d_model)
                                         for S in prompt_lengths]
                                + [(4, 1, olmoe.d_model), (4, 1, minicpm.d_model)])
    return flash_err, rms_err, add_err


def phases_moe_mla(device, seed, serve_rng, timings) -> dict:
    """Phases 14-17.  14: card vs host, 2 layers at full width of each of
    olmoe-1b-7b, mixtral-8x7b and minicpm3-4b (logits, every cache, greedy
    tokens, routing under the tie rule).  15-17: olmoe whole, mixtral's
    8-layer cut and minicpm3 whole behind ``BatchedServer`` (phase 6's
    prompts, 4 slots, max_ctx 256), each with its launch counts asserted,
    its parameter count held to the reference's and a profiled decode
    forward after it.  Each model is freed before the next is built."""
    import torch

    olmoe, mixtral, minicpm = moe_mla_configs()
    out = dict(card_vs_host={}, served={})
    t0 = time.perf_counter()
    log("phase 14: card vs host at full width, 2 layers each of olmoe-1b-7b, mixtral-8x7b and "
        "minicpm3-4b, one prefill and 4 decode steps")
    for cfg in (olmoe, mixtral, minicpm):
        two = dataclasses.replace(cfg, n_layers=2, name=f"{cfg.name.split('/')[0]}/2-layers")
        log(f" {two.name}")
        out["card_vs_host"][cfg.name] = phase_card_vs_host(device, two, prompt_len=48,
                                                           decode_steps=4, seed=seed)
        torch.cuda.empty_cache()
    timings["phase14"] = time.perf_counter() - t0

    for phase, cfg, n_params, what in (
            (15, olmoe, OLMOE_PARAMS, "olmoe-1b-7b at full width and depth (16 layers, 64 "
                                      "experts top-8)"),
            (16, mixtral, MIXTRAL_CUT_PARAMS, f"{MIXTRAL_LAYERS} of mixtral-8x7b's 32 layers at "
                                              "full width (8 experts top-2, window 4096)"),
            (17, minicpm, MINICPM_PARAMS, "minicpm3-4b at full width and depth (62 layers, MLA "
                                          "ranks 768 and 256)")):
        t0 = time.perf_counter()
        log(f"phase {phase}: serve {what} (BatchedServer, 4 slots, max_ctx 256)")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        server, launches, lengths, fig = phase_serve(device, cfg, seed, n_requests=8, slots=4,
                                                     max_ctx=256, max_new=16)
        if server.model.n_params() != n_params:
            raise AssertionError(f"{cfg.name} has {server.model.n_params():,} parameters, "
                                 f"the reference counts {n_params:,}")
        timings[f"phase{phase}"] = time.perf_counter() - t0
        log("profile: where serving time goes (4 requests x 16 tokens, 128-token prompts)")
        profile_serving(server, serve_rng, n_requests=4, prompt_len=128, max_new=16)
        out["served"][cfg.name] = dict(cfg=cfg, launches=launches, ticks=server.decode_steps,
                                       lengths=lengths, fig=fig)
        del server
        torch.cuda.empty_cache()
    return out


def time_moe_mla(device, lengths, served, excess) -> dict:
    """Each new kernel shape of phases 15-17 timed with its plain version,
    its library call and its bound (flash at each prompt length; the norms
    at batch-4 decode rows and at the longest prefill's rows), and each
    kernel's launches x (time - bound) on each of those paths added to
    ``excess``.  A path's prefill norms are timed at the longest prompt's
    rows, an upper estimate.  Returns the timings."""
    olmoe, mixtral, minicpm = moe_mla_configs()
    m = minicpm.mla
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    Ls = sorted(set(lengths))
    flash_at = {
        olmoe.name: {S: time_flash(device, S, H=olmoe.n_heads, KV=olmoe.n_kv_heads,
                                   hd=olmoe.head_dim) for S in Ls},
        mixtral.name: {S: time_flash(device, S, H=mixtral.n_heads, KV=mixtral.n_kv_heads,
                                     hd=mixtral.head_dim, window=mixtral.sliding_window)
                       for S in Ls},
        minicpm.name: {S: time_flash(device, S, H=minicpm.n_heads, KV=minicpm.n_kv_heads, hd=qk,
                                     v_width=m.v_head_dim) for S in Ls},
    }
    norms = {}
    for w in sorted({c.d_model for c in (olmoe, mixtral, minicpm)} | {m.q_lora_rank,
                                                                       m.kv_lora_rank}):
        norms[w] = dict(rms=time_rmsnorm(device, (4, 1, w)),
                        rms_prefill=time_rmsnorm(device, (1, max(lengths), w)))
    for w in sorted({c.d_model for c in (olmoe, mixtral, minicpm)}):
        norms[w].update(add=time_add_rmsnorm(device, (4, 1, w)),
                        add_prefill=time_add_rmsnorm(device, (1, max(lengths), w)))
    n = len(lengths)
    for phase, cfg in ((15, olmoe), (16, mixtral), (17, minicpm)):
        run = served[cfg.name]
        attn = block_counts(cfg)["attn"]
        excess[f"flash_attention, phase {phase}"] = excess_ms(
            [(attn, flash_at[cfg.name][S]) for S in run["lengths"]])
        t = norms[cfg.d_model]
        forwards = n + run["ticks"]
        rms = [(n, t["rms_prefill"]), (run["ticks"], t["rms"])]
        if cfg.attention == "mla":
            for w in (m.q_lora_rank, m.kv_lora_rank):
                rms += [(n * attn, norms[w]["rms_prefill"]), (run["ticks"] * attn, norms[w]["rms"])]
        excess[f"rmsnorm, phase {phase}"] = excess_ms(rms)
        n_add = norms_per_forward(cfg) - 1
        excess[f"add_rmsnorm, phase {phase}"] = excess_ms(
            [(n_add * n, t["add_prefill"]), (n_add * run["ticks"], t["add"])])
        log(f"phase {phase}: {forwards} forwards ({n} prefills); flash at the longest prefill "
            f"S={max(lengths)}: {json.dumps(flash_at[cfg.name][max(lengths)])}")
    return dict(flash=flash_at, norms=norms)


# ------------------------------------------------------------ xLSTM serving and training

XLSTM_PARAMS = 1_340_259_032        # xlstm-1.3b, the reference's n_params()
XLSTM_PERIOD_PARAMS = 395_082_532   # one period (8 layers: 7 mLSTM, 1 sLSTM) at full width
XLSTM_PERIOD = 8
BWD_FP32_TOL = 1e-5                 # backward kernel vs autograd through the plain versions
# Widths the backward kernels' register path takes besides xlstm-1.3b's
# 2048 and 2732: MLA's latents, olmoe's and minicpm3's d, and the widths the
# next training slices normalise.
BACKWARD_REGISTER_WIDTHS = (256, 768, 1024, 2560, 3840, 4096, 6144, 8192)
TRAIN_LOSS_RTOL = 1e-5              # card vs host loss, and a restart vs the uninterrupted run
TRAIN_GRAD_ATOL_REL = 1e-4          # card vs host gradient, of its leaf's largest host entry
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_CKPT_EVERY, TRAIN_FAIL_AFTER = 6, 4, 256, 4, 5
# phase 20 (b)'s restart runs 2 of xlstm-1.3b's 6 periods: its checkpoints
# (9.3 GB, not the whole model's 21.4) are written twice and read once on
# the host's disk, which took 130 s at the whole depth on an H100 host
TRAIN_RESTART_LAYERS = 16
GRAD_BATCH, GRAD_SEQ = 2, 256       # phase 20 (a)'s one batch


def xlstm_configs():
    """xlstm-1.3b whole and its one-period cut at full width."""
    from repro_torch.configs import get_config
    full = get_config("xlstm-1.3b")
    return full, dataclasses.replace(full, n_layers=XLSTM_PERIOD,
                                     name=f"xlstm-1.3b/{XLSTM_PERIOD}-layers")


def grads_through_plain(fn, inputs, grads):
    """Autograd's gradients of ``fn`` (a plain version) at ``inputs``, given
    the gradients of its outputs (None for an output left unused)."""
    import torch
    leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    pairs = [(o, g) for o, g in zip(outs, grads) if g is not None]
    return torch.autograd.grad([o for o, _ in pairs], leaves, [g for _, g in pairs])


def check_backward(name, got, want, norm_part=None) -> float:
    """fp32 within rtol and atol·max of 1e-5; bf16 within one bf16 ulp
    plus atol 1e-5·max (dx's two terms are fp32 and can nearly cancel, so
    their rounding can move the bf16 rounding of a small result by more
    than its ulp), plus one ulp of the norm's rounded part in the fused
    form (both sides round it before adding the residual gradient).
    Returns the largest absolute difference."""
    import torch
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite gradient")
    err = (got.float() - want.float()).abs()
    if got.dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=BWD_FP32_TOL,
                                   atol=BWD_FP32_TOL * float(want.abs().max()))
    else:
        tol = (bf16_ulp(want) + BWD_FP32_TOL * float(want.float().abs().max())
               + (0 if norm_part is None else bf16_ulp(norm_part)))
        if not bool((err <= tol).all()):
            raise AssertionError(f"{name}: off by more than the bf16 tolerance")
    return float(err.max())


def check_norm_backwards(device, shapes) -> tuple[float, float]:
    """Both backward kernels against autograd through their plain versions
    at ``shapes`` in fp32, at the first shape in bf16, at an odd width (4,
    1, 2049) in fp32, and at 2-4 rows of each width of
    ``BACKWARD_REGISTER_WIDTHS`` in fp32 and (2, 8192) in bf16: dx (for the
    fused form, of x and delta alike) and dgain, each twice, the second run
    bit for bit the first (no atomics).  Returns the largest fp32
    differences of the two kernels."""
    import torch
    from repro_torch.kernels.rmsnorm import (
        add_rmsnorm_backward, add_rmsnorm_reference, rmsnorm_backward, rmsnorm_backward_reference,
        rmsnorm_reference,
    )

    g = torch.Generator(device=device).manual_seed(26)
    cases = [(tuple(sh), torch.float32) for sh in shapes]
    cases += [(tuple(shapes[0]), torch.bfloat16), ((4, 1, 2049), torch.float32)]
    cases += [((2 + i % 3, w), torch.float32) for i, w in enumerate(BACKWARD_REGISTER_WIDTHS)]
    cases += [((2, 8192), torch.bfloat16)]
    worst = {"rmsnorm_backward": 0.0, "add_rmsnorm_backward": 0.0}
    for shape, dtype in cases:
        x, delta, dy, ds = (torch.randn(shape, generator=g, device=device).to(dtype)
                            for _ in range(4))
        gain = 1.0 + 0.1 * torch.randn(shape[-1], generator=g, device=device)
        label = f"{shape} {str(dtype)[6:]}"
        dx, dgain = rmsnorm_backward(x, dy, gain, 1e-5)
        again = rmsnorm_backward(x, dy, gain, 1e-5)
        want_dx, want_dg = grads_through_plain(lambda x, g_: rmsnorm_reference(x, g_, 1e-5),
                                               (x, gain), (dy,))
        torch.cuda.synchronize()
        e = check_backward(f"rmsnorm_backward {label} dx", dx, want_dx)
        e_g = check_backward(f"rmsnorm_backward {label} dgain", dgain, want_dg)
        if not (torch.equal(again[0], dx) and torch.equal(again[1], dgain)):
            raise AssertionError(f"rmsnorm_backward {label}: a second run differs")
        s = x + delta
        fx, fgain = add_rmsnorm_backward(s, ds, dy, gain, 1e-5)
        want_x, want_d, want_fg = grads_through_plain(
            lambda x, d, g_: add_rmsnorm_reference(x, d, g_, 1e-5), (x, delta, gain), (ds, dy))
        part = rmsnorm_backward_reference(s, dy, gain, 1e-5)[0]
        torch.cuda.synchronize()
        f = check_backward(f"add_rmsnorm_backward {label} dx", fx, want_x, part)
        check_backward(f"add_rmsnorm_backward {label} ddelta", fx, want_d, part)
        f_g = check_backward(f"add_rmsnorm_backward {label} dgain", fgain, want_fg)
        if dtype == torch.float32:
            worst["rmsnorm_backward"] = max(worst["rmsnorm_backward"], e, e_g)
            worst["add_rmsnorm_backward"] = max(worst["add_rmsnorm_backward"], f, f_g)
        log(f"  backward {label}: rmsnorm max|kernel-autograd| dx {e:.3e} dgain {e_g:.3e}; "
            f"add_rmsnorm dx {f:.3e} dgain {f_g:.3e}; second runs bit-equal")
    return worst["rmsnorm_backward"], worst["add_rmsnorm_backward"]


def norm_backward_bound(rows, d, fused) -> tuple[float, str]:
    """fp32, ``kernels/rmsnorm/cost.py::norm_backward_cost``."""
    from repro_torch.kernels.rmsnorm.cost import norm_backward_cost

    flops, nbytes = norm_backward_cost(rows, d, fused)
    return _bytes_or_flops(nbytes, flops)


def time_norm_backward(device, shape, fused) -> dict:
    """A backward kernel, its plain version and, as the library yardstick,
    autograd's backward of ``F.rms_norm`` (fused: of ``x + delta`` then
    ``F.rms_norm``): the forward and backward captured together, less the
    forward alone, since a graph cannot replay a backward whose forward
    ran outside it."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.rmsnorm import (
        add_rmsnorm_backward, add_rmsnorm_backward_reference, rmsnorm_backward,
        rmsnorm_backward_reference,
    )

    g = torch.Generator(device=device).manual_seed(27)
    d = shape[-1]
    rows = math.prod(shape[:-1])
    gain = 1.0 + 0.1 * torch.randn(d, generator=g, device=device)
    n_in = 3 if fused else 2
    sets = input_ring(lambda i: tuple(torch.randn(shape, generator=g, device=device)
                                      for _ in range(n_in)), (n_in + 1) * rows * d * 4)
    if fused:
        kernel = lambda s, dh, ds: add_rmsnorm_backward(s, ds, dh, gain, 1e-5)
        plain = lambda s, dh, ds: add_rmsnorm_backward_reference(s, ds, dh, gain, 1e-5)
    else:
        kernel = lambda x, dy: rmsnorm_backward(x, dy, gain, 1e-5)
        plain = lambda x, dy: rmsnorm_backward_reference(x, dy, gain, 1e-5)
    ms, eager_ms = time_both(cycling(kernel, sets), iters=100)
    plain_ms, _ = time_both(cycling(plain, sets), iters=100)
    lib_sets = [tuple(t.clone().requires_grad_(True) for t in st[:1]) + st[1:] for st in sets]
    w = gain.clone().requires_grad_(True)

    def forward(x, *rest):
        xin = x + rest[1] if fused else x
        return F.rms_norm(xin, (d,), w, 1e-5)

    def both(x, dy, *rest):
        return torch.autograd.grad(forward(x, dy, *rest), (x, w), dy)

    fwd_bwd = graph_ms(cycling(both, lib_sets), iters=50)
    fwd = graph_ms(cycling(lambda *a: forward(*a).detach(), lib_sets), iters=50)
    bound_ms, bound_by = norm_backward_bound(rows, d, fused)
    name = "add_rmsnorm_backward" if fused else "rmsnorm_backward"
    log(f"  {name} {tuple(shape)} device (graph, {len(sets)} input sets in turn): kernel "
        f"{ms:.5f} ms  plain {plain_ms:.5f} ms  autograd of "
        f"{'x + delta, ' if fused else ''}F.rms_norm {fwd_bwd - fwd:.5f} ms (forward and "
        f"backward {fwd_bwd:.5f} less forward {fwd:.5f})  bound {bound_ms:.6f} ms "
        f"({bound_by}); eager kernel with launch cost {eager_ms:.5f} ms")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=fwd_bwd - fwd, bound_ms=bound_ms,
                bound_by=bound_by)


def host_batch(cfg, batch, seq, seed):
    """One ``SyntheticLMStream`` batch as int64 host tensors."""
    import torch
    from repro_torch.data import DataConfig, SyntheticLMStream
    b = SyntheticLMStream(DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch,
                                     seed=seed)).batch_at(0)
    return {k: torch.as_tensor(v).long() for k, v in b.items()}


def phase_train_card_vs_host(device, cfg, seed, batch_size=GRAD_BATCH, seq=GRAD_SEQ,
                             models=None) -> dict:
    """Phases 20 (a) and 21 (a): one training forward and backward of
    ``cfg`` on the card and on the host from the same seeded weights and
    one synthetic batch (``batch_size`` x ``seq``): the loss within rel
    1e-5, every gradient within 1e-4 of its leaf's largest host entry, and
    the card's launches (each forward kernel's and one backward launch for
    each).  ``models`` ({"host", "card"}, built from ``seed`` with the
    card's weights loaded from the host's) are used instead of building
    them.  Returns the largest differences."""
    import torch
    from repro_torch.models import build_model

    t0 = time.perf_counter()
    if models is None:
        host = build_model(cfg, device="cpu", seed=seed)
        card = build_model(cfg, device=device, seed=seed)
        card.load_state_dict(host.state_dict())
    else:
        host, card = models["host"], models["card"]
    batch = host_batch(cfg, batch_size, seq, seed)
    log(f"  built {cfg.name} on host and card ({host.n_params():,} params) in "
        f"{time.perf_counter() - t0:.1f} s; batch {batch_size} x {seq}")
    losses = {}
    zero_launches()
    for name, model in (("host", host), ("card", card)):
        t0 = time.perf_counter()
        model.trainable()
        loss, _ = model.loss_fn({k: v.to(model.embed.device) for k, v in batch.items()})
        loss.backward()
        losses[name] = float(loss.detach())
        log(f"  {name}: loss {losses[name]:.7f}, forward and backward "
            f"{time.perf_counter() - t0:.2f} s")
    torch.cuda.synchronize()
    rel = abs(losses["card"] - losses["host"]) / abs(losses["host"])
    if not math.isfinite(losses["card"]) or rel > TRAIN_LOSS_RTOL:
        raise AssertionError(f"loss card {losses['card']} host {losses['host']} (rel {rel:.3e})")
    host_p = dict(host.named_parameters())
    worst, worst_name = 0.0, ""
    for n, p in card.named_parameters():
        want = host_p[n].grad
        got = p.grad.cpu()
        if not torch.isfinite(got).all():
            raise AssertionError(f"d{n}: non-finite on the card")
        scale = float(want.abs().max())
        err = float((got - want).abs().max())
        if err > TRAIN_GRAD_ATOL_REL * scale:
            raise AssertionError(f"d{n}: max|card-host| {err:.3e} over "
                                 f"{TRAIN_GRAD_ATOL_REL} x {scale:.3e}")
        if scale and err / scale > worst:
            worst, worst_name = err / scale, n
    n = {kind: c for kind, c in block_counts(cfg).items() if c}
    want = training_launches(cfg, 1)
    got = kernel_launches()
    if got != want:
        raise AssertionError(f"training launches {got}, expected {want}")
    log(f"  loss card {losses['card']:.7f} host {losses['host']:.7f} (rel {rel:.3e}); every "
        f"gradient within {TRAIN_GRAD_ATOL_REL} of its leaf's largest host entry, largest "
        f"share {worst:.3e} (d{worst_name}); blocks {json.dumps(n)}; "
        f"card launches {json.dumps(got)}")
    del host, card
    return dict(loss_rel=rel, grad_rel=worst)


def phase_train(device, seed) -> dict:
    """Phase 20 (b): xlstm-1.3b whole trained on the card for 6 steps (batch
    4 x 256 positions), uninterrupted, with every loss and gradient norm
    finite and the launches per step held to the norms' forward and
    backward counts; then its first ``TRAIN_RESTART_LAYERS`` layers (2
    periods) trained the same way, uninterrupted and again with
    checkpoints every 4 steps under ``build/``, crashed after step 5 and
    restarted under ``run_with_restarts``, whose losses must equal the
    uninterrupted cut's to rel 1e-5.  The step times are ``train()``'s own,
    passed to its ``on_step``.  The restarted run needs about 19 GB of free
    disk under ``build/`` for two checkpoints, removed afterwards.  Returns
    the figures."""
    import gc
    import shutil

    import numpy as np
    import torch
    from repro_torch.launch.train import TrainConfig, train
    from repro_torch.runtime import FailurePlan, run_with_restarts

    from torch.profiler import ProfilerActivity, profile

    full, _ = xlstm_configs()
    base = dict(arch=full.name, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH, steps=TRAIN_STEPS,
                ckpt_every=TRAIN_CKPT_EVERY, seed=seed, log_every=0)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    t0 = time.perf_counter()
    steps = []
    # the last step runs under the profiler (device events only), started
    # when the step before it has returned and stopped when it has
    prof = profile(activities=[ProfilerActivity.CUDA])

    def record(step, loss, metrics, dt):
        steps.append(dict(loss=loss, grad_norm=float(metrics["grad_norm"]),
                          lr=float(metrics["lr"]), ms=dt * 1e3))
        if step == TRAIN_STEPS - 2:
            torch.cuda.synchronize()
            prof.__enter__()
        elif step == TRAIN_STEPS - 1:
            torch.cuda.synchronize()
            prof.__exit__(None, None, None)

    out = train(TrainConfig(**base), on_step=record, device=device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel_launches()
    peak = torch.cuda.max_memory_allocated()
    del out["params"]
    torch.cuda.empty_cache()
    losses = out["losses"]
    for i, st in enumerate(steps):
        log(f"  step {i}: loss {st['loss']:.6f}  grad_norm {st['grad_norm']:.6f}  "
            f"lr {st['lr']:.3e}  {st['ms']:.1f} ms" + ("  (profiled)" if i == TRAIN_STEPS - 1
                                                      else ""))
    busy_ms = profiled_busy_ms(prof)
    log_device_time(prof, steps[-1]["ms"], f"profiler over step {TRAIN_STEPS - 1}", top=8)
    del prof
    if len(losses) != TRAIN_STEPS or not all(
            math.isfinite(st["loss"]) and math.isfinite(st["grad_norm"]) for st in steps):
        raise AssertionError(f"losses or gradient norms not finite: {steps}")
    n_rms = 1 + inner_norms(full)
    n_add = norms_per_forward(full) - 1
    want = training_launches(full, TRAIN_STEPS)
    if launches != want:
        raise AssertionError(f"training launches {launches}, expected {want}")
    step_ms = sorted(st["ms"] for st in steps)
    unprofiled = [st["ms"] for st in steps[:-1]]
    log(f"  uninterrupted: {TRAIN_STEPS} steps in {wall:.1f} s (build included); step median "
        f"{float(np.median(step_ms)):.1f} ms, min {step_ms[0]:.1f} ms (median of the "
        f"{TRAIN_STEPS - 1} unprofiled {float(np.median(unprofiled)):.1f} ms); device busy "
        f"over the profiled step "
        + (f"{busy_ms:.1f} ms of {steps[-1]['ms']:.1f}" if busy_ms is not None
           else "not measured")
        + f"; peak memory {peak / 2**30:.2f} GiB ({peak} bytes); launches "
        f"{json.dumps(launches)} ({n_rms} rmsnorm, {n_add} add_rmsnorm and as many backward "
        "launches each a step)")

    cut = dict(base, n_layers=TRAIN_RESTART_LAYERS)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cut_losses = train(TrainConfig(**cut), device=device)["losses"]
    torch.cuda.synchronize()
    cut_wall = time.perf_counter() - t0
    log(f"  the first {TRAIN_RESTART_LAYERS} layers uninterrupted: {TRAIN_STEPS} steps in "
        f"{cut_wall:.1f} s; losses {[round(v, 6) for v in cut_losses]}")
    ckpt_dir = os.path.join(ROOT, "build", "phase20_ckpt")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    restarted: dict[int, float] = {}
    starts = []
    plan = FailurePlan(fail_after_steps=(TRAIN_FAIL_AFTER,))
    t0 = time.perf_counter()

    def run(attempt: int) -> int:
        gc.collect()                  # the crashed attempt's state, before the next builds
        torch.cuda.empty_cache()
        res = train(TrainConfig(**cut, ckpt_dir=ckpt_dir), failure_plan=plan,
                    on_step=lambda step, loss, m, dt: restarted.__setitem__(step, loss),
                    device=device)
        starts.append(res["start_step"])
        return res["start_step"]

    try:
        _, restarts = run_with_restarts(run)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    restart_wall = time.perf_counter() - t0
    if restarts != 1 or starts != [TRAIN_CKPT_EVERY] or sorted(restarted) != list(
            range(TRAIN_STEPS)):
        raise AssertionError(f"restarts {restarts}, starts {starts}, steps {sorted(restarted)}")
    worst = max(abs(restarted[s] - cut_losses[s]) / abs(cut_losses[s])
                for s in range(TRAIN_STEPS))
    bitwise = all(restarted[s] == cut_losses[s] for s in range(TRAIN_STEPS))
    if worst > TRAIN_LOSS_RTOL:
        raise AssertionError(f"restarted losses {restarted} against {cut_losses}: "
                             f"rel {worst:.3e}")
    log(f"  restarted after step {TRAIN_FAIL_AFTER} from step {starts[0]}'s checkpoint: "
        f"{restarts} restart, {restart_wall:.1f} s with checkpoints; losses equal the "
        f"uninterrupted run's within rel {worst:.3e} ("
        + ("bit for bit" if bitwise else "not bit for bit") + ")")
    log(f"  loss curve: {[round(v, 6) for v in losses]}")
    return dict(losses=losses, step_ms=float(np.median(step_ms)),
                step_ms_unprofiled=float(np.median(unprofiled)),
                profiled_step_ms=steps[-1]["ms"], device_busy_ms=busy_ms, peak_bytes=peak,
                launches=launches, restart_rel=worst, bitwise=bitwise, wall_s=wall,
                restart_wall_s=restart_wall)


def phase_train_guard(device) -> None:
    """Phase 20 (c): the card-training guard refuses, with ``ValueError``
    naming the limit and before anything is built, what the kernels do not
    take: ``build_state`` for a 2-layer llama3-8b at d_model 8192 (head
    width 256), ``make_step`` for a model whose config has a 256-wide head,
    an MLA head of max(qk, v) = 160 or a 32-wide SSM state; the card's
    allocated memory does not move.  Every registered architecture passes
    it."""
    import types

    import torch
    from repro_torch.configs import get_config, list_archs
    from repro_torch.configs.base import MLAConfig, SSMConfig
    from repro_torch.launch.train import TrainConfig, build_state, check_trainable, make_step
    from repro_torch.optim import AdamWConfig

    def on_card(cfg):
        return types.SimpleNamespace(cfg=cfg, embed=types.SimpleNamespace(device=device))

    llama, jamba, mla = (get_config(a) for a in ("llama3-8b", "jamba-1.5-large-398b",
                                                 "minicpm3-4b"))
    cases = (
        ("build_state, llama3-8b at d_model 8192", "128",
         lambda: build_state(TrainConfig(arch="llama3-8b", n_layers=2, d_model=8192),
                             device=device)),
        ("make_step, head_dim 256", "128",
         lambda: make_step(on_card(dataclasses.replace(llama, head_dim=256)), AdamWConfig())),
        ("make_step, MLA qk 128 + 32", "128",
         lambda: make_step(on_card(dataclasses.replace(
             mla, mla=MLAConfig(qk_nope_head_dim=128, qk_rope_head_dim=32))), AdamWConfig())),
        ("make_step, d_state 32", "16",
         lambda: make_step(on_card(dataclasses.replace(jamba, ssm=SSMConfig(d_state=32))),
                           AdamWConfig())),
    )
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    for what, limit, call in cases:
        try:
            call()
        except ValueError as e:
            if limit not in str(e):
                raise AssertionError(f"{what}: the guard's message names no limit {limit}: {e}")
            log(f"  {what} raised: {e}")
        else:
            raise AssertionError(f"{what}: the guard let it through")
    if torch.cuda.memory_allocated() != before:
        raise AssertionError("the guard built something on the card before it raised")
    for arch in list_archs():
        check_trainable(get_config(arch), "cuda")
    log(f"  every registered architecture passes the guard on the card ({len(list_archs())})")


def phases_xlstm(device, seed, serve_rng, timings) -> dict:
    """Phases 18-20: card = host at one full-width xlstm-1.3b period; the
    whole model served; the whole model trained, restarted, and the
    guard.  Returns the figures."""
    import torch

    full, cut = xlstm_configs()
    out = {}
    t0 = time.perf_counter()
    log(f"phase 18: card vs host, one full-width period of xlstm-1.3b ({XLSTM_PERIOD} layers: 7 "
        "mLSTM, 1 sLSTM), a 48-token and a 256-token prefill (two mLSTM chunks), 4 decode "
        "steps each")
    out["card_vs_host"] = {S: phase_card_vs_host(device, cut, prompt_len=S, decode_steps=4,
                                                 seed=seed) for S in (48, 256)}
    torch.cuda.empty_cache()
    timings["phase18"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    log("phase 19: serve xlstm-1.3b at full width and depth (48 layers; BatchedServer, 4 slots, "
        "max_ctx 256)")
    torch.cuda.reset_peak_memory_stats()
    server, launches, lengths, fig = phase_serve(device, full, seed, n_requests=8, slots=4,
                                                 max_ctx=256, max_new=16)
    if server.model.n_params() != XLSTM_PARAMS:
        raise AssertionError(f"xlstm-1.3b has {server.model.n_params():,} parameters")
    timings["phase19"] = time.perf_counter() - t0
    log("profile: where serving time goes (4 requests x 16 tokens, 128-token prompts)")
    profile_serving(server, serve_rng, n_requests=4, prompt_len=128, max_new=16)
    out["served"] = dict(cfg=full, launches=launches, ticks=server.decode_steps,
                         lengths=lengths, fig=fig)
    del server
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    log(f"phase 20 (a): card vs host training gradients, one full-width period of xlstm-1.3b "
        f"({XLSTM_PERIOD_PARAMS:,} params), one synthetic batch of {GRAD_BATCH} x {GRAD_SEQ}")
    out["train_card_vs_host"] = phase_train_card_vs_host(device, cut, seed)
    torch.cuda.empty_cache()
    timings["phase20a"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    log(f"phase 20 (b): train xlstm-1.3b whole on the card, {TRAIN_STEPS} steps of "
        f"{TRAIN_BATCH} x {TRAIN_SEQ}, then its first {TRAIN_RESTART_LAYERS} layers, "
        f"uninterrupted and again checkpointed every {TRAIN_CKPT_EVERY} steps, crashed after "
        f"step {TRAIN_FAIL_AFTER} and restarted")
    out["train"] = phase_train(device, seed)
    timings["phase20b"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    log("phase 20 (c): the card-training guard refuses the widths the kernels do not take")
    phase_train_guard(device)
    timings["phase20c"] = time.perf_counter() - t0
    return out


def check_xlstm_kernels(device, prompt_lengths) -> tuple[float, float, float, float]:
    """Phase 4's checks at xlstm-1.3b's shapes: rmsnorm at d 2048 and
    mLSTM's inner 2732 at serving's decode and prefill rows (phase 18's
    256-token prefill too) and training's (4 x 256 and 2 x 256 rows);
    add_rmsnorm at d 2048 (olmoe's d, whose serving rows phase 4 checks
    already) at training's rows; both backward kernels against autograd
    through their plain versions (:func:`check_norm_backwards`).  Returns
    the largest rmsnorm, add_rmsnorm and backward differences."""
    xd, xdi = 2048, 2732
    train_shapes = [(TRAIN_BATCH, TRAIN_SEQ, xd), (TRAIN_BATCH, TRAIN_SEQ, xdi),
                    (GRAD_BATCH, GRAD_SEQ, xd), (GRAD_BATCH, GRAD_SEQ, xdi)]
    rms_err = check_rmsnorm(device, [(1, S, w) for w in (xd, xdi) for S in prompt_lengths + [256]]
                            + [(4, 1, xd), (4, 1, xdi)] + train_shapes)
    add_err = check_add_rmsnorm(device, [(1, 256, xd)] + train_shapes[::2])
    rms_bwd_err, add_bwd_err = check_norm_backwards(device, train_shapes
                                                    + [(4, 1, xd), (1, 168, xdi)])
    return rms_err, add_err, rms_bwd_err, add_bwd_err


def time_xlstm(device, lengths, xlstm, excess) -> tuple[dict, dict]:
    """The norms at phase 19's shapes (d 2048 and 2732, decode rows and the
    longest prefill's) and phase 20's training shape, and both backward
    kernels there, each with its plain version, library call and bound;
    each kernel's launches x (time - bound) on phases 19 and 20 added to
    ``excess`` (prefills timed at the longest prompt's rows, an upper
    estimate).  Returns the backward kernels' timings at (4, 256, 2048)."""
    xd, xdi = 2048, 2732
    run = xlstm["served"]
    cfg = run["cfg"]
    norms = {w: dict(rms=time_rmsnorm(device, (4, 1, w)),
                     rms_prefill=time_rmsnorm(device, (1, max(lengths), w)))
             for w in (xd, xdi)}
    norms[xd].update(add=time_add_rmsnorm(device, (4, 1, xd)),
                     add_prefill=time_add_rmsnorm(device, (1, max(lengths), xd)))
    shape, inner = (TRAIN_BATCH, TRAIN_SEQ, xd), (TRAIN_BATCH, TRAIN_SEQ, xdi)
    rms_bwd = time_norm_backward(device, shape, fused=False)
    rms_bwd_inner = time_norm_backward(device, inner, fused=False)
    add_bwd = time_norm_backward(device, shape, fused=True)
    rms_train, rms_train_inner = time_rmsnorm(device, shape), time_rmsnorm(device, inner)
    add_train = time_add_rmsnorm(device, shape)
    # phase 19: every forward's block-0 norm and sLSTM inner norms at d, the
    # mLSTM inner norms at 2732
    n, ticks = len(lengths), run["ticks"]
    nb = block_counts(cfg)
    rms = []
    for w, per in ((xd, 1 + nb["slstm"]), (xdi, nb["mlstm"])):
        rms += [(per * n, norms[w]["rms_prefill"]), (per * ticks, norms[w]["rms"])]
    excess["rmsnorm, phase 19"] = excess_ms(rms)
    n_add = norms_per_forward(cfg) - 1
    excess["add_rmsnorm, phase 19"] = excess_ms(
        [(n_add * n, norms[xd]["add_prefill"]), (n_add * ticks, norms[xd]["add"])])
    # phase 20 (b): the uninterrupted run's launches at the training shapes
    tl = xlstm["train"]["launches"]
    per_d, per_i = (1 + nb["slstm"]) * TRAIN_STEPS, nb["mlstm"] * TRAIN_STEPS
    excess["rmsnorm, phase 20"] = excess_ms([(per_d, rms_train), (per_i, rms_train_inner)])
    excess["add_rmsnorm, phase 20"] = excess_ms([(tl["add_rmsnorm"], add_train)])
    excess["rmsnorm_backward, phase 20"] = excess_ms([(per_d, rms_bwd), (per_i, rms_bwd_inner)])
    excess["add_rmsnorm_backward, phase 20"] = excess_ms([(tl["add_rmsnorm_backward"], add_bwd)])
    log(f"phase 20 training launches: {json.dumps(tl)}; rmsnorm_backward at {shape}: "
        f"{json.dumps(rms_bwd)}; at {inner}: {json.dumps(rms_bwd_inner)}; "
        f"add_rmsnorm_backward at {shape}: {json.dumps(add_bwd)}")
    return rms_bwd, add_bwd


# ------------------------------------- phase 21: attention and Mamba training

# n_params(), as both packages count them (the configs' param_count(),
# 1,644,167,168 and 2,869,772,288, leaves out the norms' gains)
STABLELM_PARAMS = 1_644_267_520     # stablelm-1.6b
JAMBA_PAIR_PARAMS = 2_869_829_632   # jamba-1.5-large's Mamba + attention pair, dense MLPs
STABLELM_CUT_LAYERS = 2             # 21 (a): stablelm-1.6b cut to 2 layers at full width
PAIR_GRAD_BATCH, PAIR_GRAD_SEQ = 1, 128   # 21 (a): the host runs the sequential plain scan
TRAIN21_STEPS, TRAIN21_BATCH, TRAIN21_SEQ = 4, 4, 256
TRAIN21_PEAK_LIMIT = 75 * 2**30     # 21 (c)'s peak device memory at 4 x 256 stays under this
BWD_ATOL_REL = 1e-4                 # flash and scan backward kernels vs plain, per gradient


def jamba_pair_config():
    """Phase 8's pair: one Mamba and one attention block of jamba-1.5-large
    at full width, dense MLPs (built with replace, never registered)."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("jamba-1.5-large-398b"), n_experts=0,
                               experts_per_token=0, n_layers=2, block_pattern=("mamba", "attn"),
                               name="jamba-1.5-large-398b/mamba+attn-dense")


def stablelm_config():
    """stablelm-1.6b, ``TrainConfig``'s own family, whole."""
    from repro_torch.configs import get_config
    return get_config("stablelm-1.6b")


def training_launches(cfg, steps) -> dict:
    """Kernel launches of ``steps`` training forwards and backwards: each
    forward's as a prefill launches them, and one backward launch for each
    forward launch of the norms, flash and the scan."""
    fwd = expected_launches(cfg, forwards=steps, prefills=steps)
    return dict(fwd, rmsnorm_backward=fwd["rmsnorm"], add_rmsnorm_backward=fwd["add_rmsnorm"],
                flash_attention_backward=fwd["flash_attention"],
                ssm_scan_backward=fwd["ssm_scan"])


def check_grads(label, got, want, names) -> float:
    """Each gradient within 1e-4 of the plain version's largest entry of
    that gradient (bf16: plus one bf16 ulp of it).  Returns the largest
    absolute difference."""
    import torch
    worst = 0.0
    for g, w, name in zip(got, want, names):
        if g.dtype != w.dtype or g.shape != w.shape:
            raise AssertionError(f"{label} {name}: {g.dtype} {tuple(g.shape)}, plain "
                                 f"{w.dtype} {tuple(w.shape)}")
        if not torch.isfinite(g).all():
            raise AssertionError(f"{label} {name}: non-finite gradient")
        top = w.float().abs().max()
        tol = BWD_ATOL_REL * float(top)
        if g.dtype == torch.bfloat16:
            tol += float(bf16_ulp(top))
        err = float((g.float() - w.float()).abs().max())
        if err > tol:
            raise AssertionError(f"{label} {name}: max|kernel-plain| {err:.3e} over {tol:.3e}")
        worst = max(worst, err)
    return worst


def flash_backward_inputs(device, B, S, Sk, H, KV, hd, dtype, seed, v_width=None):
    """Seeded q, k, v (v zero past ``v_width``: MLA's padded v) and the
    output's gradient, in ``dtype``."""
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    r = lambda *shape: torch.randn(*shape, generator=g, device=device)
    q, k, v, dout = r(B, S, H, hd), r(B, Sk, KV, hd), r(B, Sk, KV, hd), r(B, S, H, hd)
    if v_width is not None:
        v[..., v_width:] = 0.0
    return tuple(t.to(dtype) for t in (q, k, v, dout))


def check_flash_backward(device, cases) -> float:
    """The flash backward kernel against its plain version, each case
    (label, B, S, Sk, H, KV, hd, causal, window, v_width, dtype), both as
    training runs it (from the forward's row statistics) and recomputing
    them; a second launch bit for bit the first, and the forward under grad
    (through the autograd Function, and with the statistics) bit for bit
    serving's.  Returns the largest fp32 difference."""
    import torch
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_backward, flash_attention_backward_reference,
        flash_attention_with_lse,
    )

    worst = 0.0
    for label, B, S, Sk, H, KV, hd, causal, window, v_width, dtype in cases:
        q, k, v, dout = flash_backward_inputs(device, B, S, Sk, H, KV, hd, dtype,
                                              seed=S + Sk + H + hd, v_width=v_width)
        kw = dict(causal=causal, window=window, scale=1.0 / hd ** 0.5)
        with torch.no_grad():
            out = flash_attention(q, k, v, **kw)
        trained = flash_attention(*(t.clone().requires_grad_(True) for t in (q, k, v)), **kw)
        with torch.no_grad():
            out_lse, lse = flash_attention_with_lse(q, k, v, **kw)
        got = flash_attention_backward(q, k, v, out, dout, lse=lse, **kw)
        again = flash_attention_backward(q, k, v, out, dout, lse=lse, **kw)
        alone = flash_attention_backward(q, k, v, out, dout, **kw)
        want = flash_attention_backward_reference(q, k, v, out, dout, **kw)
        torch.cuda.synchronize()
        name = (f"flash_attention_backward {label} ({B}, {S}, {H}, {hd}) Sk={Sk} KV={KV} "
                f"causal={causal} window={window} {str(dtype)[6:]}")
        if trained.grad_fn is None or not torch.equal(trained.detach(), out):
            raise AssertionError(f"{name}: the forward under grad is not serving's, bit for bit")
        if not torch.equal(out_lse, out):
            raise AssertionError(f"{name}: the forward with statistics is not serving's, bit "
                                 f"for bit")
        err = check_grads(name, got, want, ("dq", "dk", "dv"))
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"{name}: a second launch differs")
        if not all(torch.equal(a, b) for a, b in zip(got, alone)):
            raise AssertionError(f"{name}: the wrapper without the statistics (the forward run "
                                 f"for them first) differs")
        if dtype == torch.float32:
            worst = max(worst, err)
        log(f"  {name}: max|kernel-plain| {err:.3e}; a second launch and the wrapper without "
            f"the statistics bit-equal; the forward under grad and with statistics bit for bit "
            f"serving's")
    return worst


def check_scan_backward(device, cases) -> float:
    """The selective-scan backward kernel against its plain version, each
    case (label, B, S, D, N, dtype, with_dhT) on :func:`scan_inputs` (B and C
    strided, as the block passes them); a second launch bit for bit the
    first, and the forward under grad bit for bit serving's.  Returns the
    largest fp32 difference."""
    import torch
    from repro_torch.kernels.ssm_scan import (
        ssm_scan, ssm_scan_backward, ssm_scan_backward_reference, ssm_scan_with_checkpoints,
    )

    worst = 0.0
    for label, B, S, D, N, dtype, with_dhT in cases:
        args = scan_inputs(device, B, S, D, N, dtype, seed=S * 3 + D + N)
        g = torch.Generator(device=device).manual_seed(S + D)
        dy = torch.randn(B, S, D, generator=g, device=device)
        dhT = torch.randn(B, D, N, generator=g, device=device) if with_dhT else None
        with torch.no_grad():
            served = ssm_scan(*args)
        trained = ssm_scan(args[0].clone().requires_grad_(True), *args[1:])
        with torch.no_grad():
            *with_states, ckpt = ssm_scan_with_checkpoints(*args)
        got = ssm_scan_backward(*args, dy, dhT, ckpt=ckpt)
        again = ssm_scan_backward(*args, dy, dhT, ckpt=ckpt)
        alone = ssm_scan_backward(*args, dy, dhT)
        want = ssm_scan_backward_reference(*args, dy, dhT)
        torch.cuda.synchronize()
        name = f"ssm_scan_backward {label} ({B}, {S}, {D}, {N}) {str(dtype)[6:]} dhT={with_dhT}"
        if trained[0].grad_fn is None or not all(
                torch.equal(a.detach(), b) for a, b in zip(trained, served)):
            raise AssertionError(f"{name}: the forward under grad is not serving's, bit for bit")
        if not all(torch.equal(a, b) for a, b in zip(with_states, served)):
            raise AssertionError(f"{name}: the forward with states is not serving's, bit for bit")
        err = check_grads(name, got, want, ("ddt", "dx", "dB", "dC", "dA", "dh0"))
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"{name}: a second launch differs")
        if not all(torch.equal(a, b) for a, b in zip(got, alone)):
            raise AssertionError(f"{name}: the wrapper without the states (the forward run for "
                                 f"them first) differs")
        if dtype == torch.float32:
            worst = max(worst, err)
        log(f"  {name}: max|kernel-plain| {err:.3e}; a second launch and the wrapper without "
            f"the states bit-equal; the forward under grad and with states bit for bit "
            f"serving's")
    return worst


def flash_backward_bound(B, S, Sk, H, KV, hd, causal, window) -> tuple[float, str, str]:
    """fp32 (``kernels/flash_attention/cost.py::flash_backward_cost``).
    Two ways to do the products, as :func:`flash_bound` counts them: fp32
    on CUDA cores (all flops at 67 TFLOP/s), or 3xTF32 on the tensor cores
    (three tf32 products per product at 495 TFLOP/s, the softmax on CUDA
    cores); the faster of the two is held against the bytes.  Returns
    (bound ms, "bytes" or "operations", which way of doing the products is
    the faster: "fp32" or "3xTF32")."""
    from repro_torch.kernels.flash_attention.cost import flash_backward_cost

    mm_flops, soft_flops, nbytes = flash_backward_cost(B, S, Sk, H, KV, hd, causal, window)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_fp32 = (mm_flops + soft_flops) / FP32_FLOPS_PER_S
    t_tc = 3 * mm_flops / TF32_FLOPS_PER_S + soft_flops / FP32_FLOPS_PER_S
    t_ops = min(t_fp32, t_tc)
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations",
            "fp32" if t_fp32 <= t_tc else "3xTF32")


def time_flash_backward(device, B, S, H, KV, hd, causal=True, window=None) -> dict:
    """The flash backward kernel (its two launches) as training runs it,
    from the forward's row statistics, its plain version and, as the
    library yardstick, autograd's backward of
    ``F.scaled_dot_product_attention`` on the same inputs (forward and
    backward captured together, less the forward alone), beside its
    bound; logged beside, the call without the statistics (the wrapper
    runs the forward for them first) and the forward's time with and
    without them."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_backward, flash_attention_backward_reference,
        flash_attention_with_lse,
    )

    q, k, v, dout = flash_backward_inputs(device, B, S, S, H, KV, hd, torch.float32, seed=S + H)
    kw = dict(causal=causal, window=window, scale=1.0 / hd ** 0.5)
    with torch.no_grad():
        out, lse = flash_attention_with_lse(q, k, v, **kw)
    # as training runs it: from the forward's row statistics
    ms, eager_ms = time_both(lambda: flash_attention_backward(q, k, v, out, dout, lse=lse, **kw),
                             iters=20)
    alone_ms = graph_ms(lambda: flash_attention_backward(q, k, v, out, dout, **kw), iters=20)
    serve_fwd = graph_ms(lambda: flash_attention(q, k, v, **kw), iters=20)
    stats_fwd = graph_ms(lambda: flash_attention_with_lse(q, k, v, **kw), iters=20)
    plain_ms = graph_ms(lambda: flash_attention_backward_reference(q, k, v, out, dout, **kw),
                        iters=5, replays=2)
    if window is not None and S > window:
        raise ValueError(f"SDPA has no window: S={S} over the window {window}")
    leaves = [t.transpose(1, 2).contiguous().requires_grad_(True) for t in (q, k, v)]
    dout_t = dout.transpose(1, 2).contiguous()

    def sdpa():
        return F.scaled_dot_product_attention(*leaves, is_causal=causal, scale=kw["scale"],
                                              enable_gqa=True)

    fwd_bwd = graph_ms(lambda: torch.autograd.grad(sdpa(), leaves, dout_t), iters=10)
    fwd = graph_ms(lambda: sdpa().detach(), iters=10)
    bound_ms, bound_by, products = flash_backward_bound(B, S, S, H, KV, hd, causal, window)
    log(f"  flash_attention_backward ({B}, {S}, {H}, {hd}) KV={KV} causal={causal} "
        f"window={window} device (graph): kernel {ms:.5f} ms  plain {plain_ms:.5f} ms  autograd "
        f"of SDPA {fwd_bwd - fwd:.5f} ms (forward and backward {fwd_bwd:.5f} less forward "
        f"{fwd:.5f})  bound {bound_ms:.6f} ms ({bound_by}; products at {products}); eager "
        f"kernel with launch cost {eager_ms:.5f} ms; without the statistics (the forward "
        f"with them first) {alone_ms:.5f} ms; the forward {serve_fwd:.5f} ms serving, "
        f"{stats_fwd:.5f} ms with the statistics")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=fwd_bwd - fwd, bound_ms=bound_ms,
                bound_by=bound_by)


def scan_backward_bound(B, S, D, N) -> tuple[float, str, float]:
    """fp32 (``kernels/ssm_scan/cost.py::ssm_scan_backward_cost``), and the
    expf on the SFUs beside.  Returns (bound ms, what bounds it, the expf
    time in ms)."""
    from repro_torch.kernels.ssm_scan.cost import ssm_scan_backward_cost

    flops, nbytes = ssm_scan_backward_cost(B, S, D, N)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    sfu_ms = B * S * D * N / SFU_PER_S * 1e3
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations", sfu_ms


def time_scan_backward(device, B, S) -> dict:
    """The selective-scan backward kernel (the scan and the finish) as
    training runs it, from the forward's range-start states, and its plain
    version at jamba's widths, beside its bound; logged beside, the call
    without the states (the wrapper runs the forward for them first) and
    the forward's time with and without storing them.  No PyTorch call
    computes a selective scan or its backward."""
    import torch
    from repro_torch.kernels.ssm_scan import (
        ssm_scan, ssm_scan_backward, ssm_scan_backward_reference, ssm_scan_with_checkpoints,
    )

    D, N = JAMBA["D"], JAMBA["N"]
    args = scan_inputs(device, B, S, D, N, torch.float32, seed=B * 7 + S)
    dy = torch.randn(B, S, D, generator=torch.Generator(device=device).manual_seed(S),
                     device=device)
    ckpt = ssm_scan_with_checkpoints(*args)[2]
    ms, eager_ms = time_both(lambda: ssm_scan_backward(*args, dy, None, ckpt=ckpt), iters=10)
    alone_ms = graph_ms(lambda: ssm_scan_backward(*args, dy, None), iters=10)
    serve_fwd = graph_ms(lambda: ssm_scan(*args), iters=10)
    states_fwd = graph_ms(lambda: ssm_scan_with_checkpoints(*args), iters=10)
    plain_ms = graph_ms(lambda: ssm_scan_backward_reference(*args, dy, None), iters=1,
                        replays=2)
    bound_ms, bound_by, sfu_ms = scan_backward_bound(B, S, D, N)
    log(f"  ssm_scan_backward ({B}, {S}, {D}, {N}) device (graph): kernel {ms:.5f} ms  plain "
        f"{plain_ms:.5f} ms  bound {bound_ms:.6f} ms ({bound_by}; one expf a state on the SFUs "
        f"{sfu_ms:.6f} ms); eager kernel with launch cost {eager_ms:.5f} ms; without the "
        f"states (the forward with them first) {alone_ms:.5f} ms; the forward {serve_fwd:.5f} ms serving, "
        f"{states_fwd:.5f} ms storing the states; no PyTorch call computes a selective scan's "
        f"backward")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms, bound_by=bound_by)


def phase_backward_kernels(device) -> dict:
    """Phase 21 (kernels): both backward kernels against their plain
    versions at every training shape of (a)-(c) and the small cases (a
    window narrower than S, seamless's cross-attention, MLA's padded v, a
    masked channel tail, bf16), then each timed at (b)'s and (c)'s
    training shape.  Returns the largest differences and the timings."""
    import torch

    stable, pair = stablelm_config(), jamba_pair_config()
    sH, sKV, shd = stable.n_heads, stable.n_kv_heads, stable.head_dim
    jH, jKV, jhd = pair.n_heads, pair.n_kv_heads, pair.head_dim
    f32, bf16 = torch.float32, torch.bfloat16
    flash_err = check_flash_backward(device, [
        ("21 (b)", TRAIN21_BATCH, TRAIN21_SEQ, TRAIN21_SEQ, sH, sKV, shd, True, None, None, f32),
        ("21 (a)", GRAD_BATCH, GRAD_SEQ, GRAD_SEQ, sH, sKV, shd, True, None, None, f32),
        ("21 (c)", TRAIN21_BATCH, TRAIN21_SEQ, TRAIN21_SEQ, jH, jKV, jhd, True, None, None, f32),
        ("21 (a) pair", PAIR_GRAD_BATCH, PAIR_GRAD_SEQ, PAIR_GRAD_SEQ, jH, jKV, jhd, True, None,
         None, f32),
        ("window", 2, 256, 256, 32, 8, 128, True, 64, None, f32),
        ("seamless cross", 1, 168, 512, 16, 16, 64, False, None, None, f32),
        ("MLA", 1, 168, 168, 40, 40, 96, True, None, 64, f32),
        ("21 (b) bf16", TRAIN21_BATCH, TRAIN21_SEQ, TRAIN21_SEQ, sH, sKV, shd, True, None, None,
         bf16),
    ])
    D, N = JAMBA["D"], JAMBA["N"]
    scan_err = check_scan_backward(device, [
        ("21 (c)", TRAIN21_BATCH, TRAIN21_SEQ, D, N, f32, False),
        ("21 (a)", PAIR_GRAD_BATCH, PAIR_GRAD_SEQ, D, N, f32, False),
        ("channel tail, dhT", 2, 100, D - 24, N, f32, True),
        ("bf16", 1, TRAIN21_SEQ, D, N, bf16, True),
    ])
    flash_t = time_flash_backward(device, TRAIN21_BATCH, TRAIN21_SEQ, sH, sKV, shd)
    flash_pair_t = time_flash_backward(device, TRAIN21_BATCH, TRAIN21_SEQ, jH, jKV, jhd)
    scan_t = time_scan_backward(device, TRAIN21_BATCH, TRAIN21_SEQ)
    torch.cuda.empty_cache()
    return dict(flash_err=flash_err, scan_err=scan_err, flash=flash_t, flash_pair=flash_pair_t,
                scan=scan_t)


def train_steps(device, cfg, seed, steps, batch, seq) -> dict:
    """``train()``'s loop, without checkpoints, for a config that is not a
    registered arch: ``build_model`` made trainable, ``init_opt_state`` and
    ``make_step`` with ``TrainConfig``'s default AdamW, and ``steps`` steps
    of the synthetic corpus.  Returns the losses, gradient norms, step
    times, launches, peak memory and parameter count."""
    import torch
    from repro_torch.data import DataConfig, SyntheticLMStream
    from repro_torch.launch.train import TrainConfig, make_step
    from repro_torch.models import build_model
    from repro_torch.optim import init_opt_state

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    opt_cfg = TrainConfig().opt
    model = build_model(cfg, device=device, seed=seed).trainable()
    params = dict(model.named_parameters())
    n_params = model.n_params()
    opt_state = init_opt_state(opt_cfg, params)
    step_fn = make_step(model, opt_cfg)
    stream = SyntheticLMStream(DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch,
                                          seed=seed))
    losses, norms, ms = [], [], []
    for step in range(steps):
        b = {k: torch.as_tensor(v, device=device).long() for k, v in stream.batch_at(step).items()}
        t0 = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, b)
        losses.append(float(metrics["loss"]))
        ms.append((time.perf_counter() - t0) * 1e3)
        norms.append(float(metrics["grad_norm"]))
    torch.cuda.synchronize()
    out = dict(losses=losses, grad_norms=norms, step_ms=ms, launches=kernel_launches(),
               peak_bytes=torch.cuda.max_memory_allocated(), n_params=n_params)
    del model, params, opt_state, step_fn
    gc.collect()
    torch.cuda.empty_cache()
    return out


def check_repeated_training(label, cfg, runs, steps) -> None:
    """Both runs: every loss and gradient norm finite, the launches those
    of ``steps`` training steps; the second run's losses and gradient norms
    bit for bit the first's."""
    want = training_launches(cfg, steps)
    for i, run in enumerate(runs):
        if not all(math.isfinite(v) for v in run["losses"] + run["grad_norms"]):
            raise AssertionError(f"{label} run {i}: non-finite loss or gradient norm: {run}")
        if run["launches"] != want:
            raise AssertionError(f"{label} run {i}: launches {run['launches']}, expected {want}")
    if runs[1]["losses"] != runs[0]["losses"] or runs[1]["grad_norms"] != runs[0]["grad_norms"]:
        raise AssertionError(f"{label}: the second run's losses {runs[1]['losses']} or gradient "
                             f"norms differ from the first's {runs[0]['losses']}")
    for i, run in enumerate(runs):
        step_ms = sorted(run["step_ms"])
        log(f"  {label} run {i}: losses {run['losses']}, grad norms {run['grad_norms']}, step "
            f"ms {[round(t, 1) for t in run['step_ms']]} (median "
            f"{step_ms[len(step_ms) // 2]:.1f}), peak memory {run['peak_bytes'] / 2**30:.2f} GiB "
            f"({run['peak_bytes']} bytes)")
    log(f"  {label}: second run bit for bit the first (losses and gradient norms); launches "
        f"{json.dumps(runs[0]['launches'])} ({json.dumps(training_launches(cfg, 1))} a step)")


def phase_train_stablelm(device, seed) -> list:
    """Phase 21 (b): stablelm-1.6b whole trained on the card through
    ``train()``, 4 steps of 4 x 256, twice."""
    import torch
    from repro_torch.launch.train import TrainConfig, train

    cfg = stablelm_config()
    runs = []
    for _ in range(2):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        zero_launches()
        steps = []
        out = train(TrainConfig(arch=cfg.name, seq_len=TRAIN21_SEQ, global_batch=TRAIN21_BATCH,
                                steps=TRAIN21_STEPS, seed=seed, log_every=0),
                    on_step=lambda step, loss, m, dt: steps.append(
                        (loss, float(m["grad_norm"]), dt * 1e3)),
                    device=device)
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in out["params"].values())
        runs.append(dict(losses=[s[0] for s in steps], grad_norms=[s[1] for s in steps],
                         step_ms=[s[2] for s in steps], launches=kernel_launches(),
                         peak_bytes=torch.cuda.max_memory_allocated(), n_params=n_params))
        del out
    gc.collect()
    torch.cuda.empty_cache()
    if runs[0]["n_params"] != STABLELM_PARAMS:
        raise AssertionError(f"stablelm-1.6b has {runs[0]['n_params']:,} parameters")
    check_repeated_training("stablelm-1.6b", cfg, runs, TRAIN21_STEPS)
    return runs


def phase_train_jamba_pair(device, seed) -> list:
    """Phase 21 (c): the jamba pair at full width trained on the card, 4
    steps of 4 x 256, twice, its peak memory under 75 GiB."""
    cfg = jamba_pair_config()
    runs = [train_steps(device, cfg, seed, TRAIN21_STEPS, TRAIN21_BATCH, TRAIN21_SEQ)
            for _ in range(2)]
    if runs[0]["n_params"] != JAMBA_PAIR_PARAMS:
        raise AssertionError(f"the jamba pair has {runs[0]['n_params']:,} parameters")
    if max(run["peak_bytes"] for run in runs) > TRAIN21_PEAK_LIMIT:
        raise AssertionError(f"the jamba pair's peak passes {TRAIN21_PEAK_LIMIT / 2**30:.0f} GiB")
    check_repeated_training(cfg.name, cfg, runs, TRAIN21_STEPS)
    return runs


def phases_train_attention_mamba(device, seed, timings, pair_grads) -> dict:
    """Phase 21: the flash and scan backward kernels against their plain
    versions and timed; card = host training gradients at full width of
    stablelm-1.6b cut to 2 layers (the jamba pair's, ``pair_grads``, ran
    on phase 8's models); stablelm-1.6b whole and the jamba pair trained on
    the card, each twice, bit for bit."""
    import torch

    out = {}
    t0 = time.perf_counter()
    log("phase 21 (kernels): flash_attention_backward and ssm_scan_backward against their plain "
        "versions at the training shapes and small cases, then timed (device time from "
        "CUDA-graph replay)")
    out["kernels"] = phase_backward_kernels(device)
    timings["phase21_kernels"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    cut = dataclasses.replace(stablelm_config(), n_layers=STABLELM_CUT_LAYERS,
                              name=f"stablelm-1.6b/{STABLELM_CUT_LAYERS}-layers")
    log(f"phase 21 (a): card vs host training gradients, {cut.name} at full width "
        f"({GRAD_BATCH} x {GRAD_SEQ}; the jamba pair's ran after phase 8)")
    out["grads"] = {cut.name: phase_train_card_vs_host(device, cut, seed, GRAD_BATCH, GRAD_SEQ),
                    "jamba pair": pair_grads}
    torch.cuda.empty_cache()
    timings["phase21a"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    log(f"phase 21 (b): train stablelm-1.6b whole on the card through train(), {TRAIN21_STEPS} "
        f"steps of {TRAIN21_BATCH} x {TRAIN21_SEQ}, twice")
    out["stablelm"] = phase_train_stablelm(device, seed)
    timings["phase21b"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    log(f"phase 21 (c): train {jamba_pair_config().name} ({JAMBA_PAIR_PARAMS:,} params) on the "
        f"card, {TRAIN21_STEPS} steps, twice")
    out["pair"] = phase_train_jamba_pair(device, seed)
    timings["phase21c"] = time.perf_counter() - t0
    return out


# ------------------------------------- phase 22: sharded steps on a 1x1 mesh

SHARDED_TRAIN_STEPS = 2               # 22 (b): steps of 21 (b)'s batches (4 x 256)
SHARDED_PROMPTS, SHARDED_DECODE_STEPS = 4, 8   # 22 (c)
SHARDED_LOSS_RTOL = 1e-6              # 22 (b): bundle's losses vs make_step's
SHARDED_PARAM_ATOL_REL = 1e-5         # 22 (b): each parameter vs its leaf's largest entry
SHARDED_GRAD_ATOL_REL = 1e-5          # the first step's gradients vs its leaf's largest entry
SHARDED_SERVE_TOL = 1e-4              # 22 (c): rtol, and atol = 1e-4 x max|unsharded|
SHARDED_SEQ_TOL = 1e-5                # 22 (d): seqsharded decode vs gqa_decode, x max|out|
SHARDED_PEAK_LIMIT = 75 * 2**30


def nccl_world_of_one(tmp_dir):
    """A NCCL process group of world size 1 from a ``FileStore`` in
    ``tmp_dir`` (no network), and the (1, 1) ``("data", "model")`` mesh on
    it."""
    import datetime

    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_debug_mesh

    torch.cuda.set_device(0)
    store = dist.FileStore(os.path.join(tmp_dir, "store"), 1)
    dist.init_process_group("nccl", store=store, rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60),
                            device_id=torch.device("cuda", 0))
    return make_debug_mesh(1, 1, device_type="cuda")


def sharded_batches(cfg, device, seed) -> tuple[list, int]:
    """22 (b)'s two training batches of 21 (b)'s corpus (4 x 256 text
    tokens) for ``cfg``, each with ``train()``'s stand-in frontend
    embeddings of its step where the model takes them (a decoder-only
    model's in front of the text, an encoder-decoder's into its encoder);
    and the train shape's sequence length, which counts a decoder-only
    model's frontend tokens."""
    import torch
    from repro_torch.data import DataConfig, SyntheticLMStream
    from repro_torch.launch.train import frontend_noise

    stream = SyntheticLMStream(DataConfig(vocab=cfg.vocab, seq_len=TRAIN21_SEQ,
                                          global_batch=TRAIN21_BATCH, seed=seed))
    batches = []
    for s in range(SHARDED_TRAIN_STEPS):
        b = {k: torch.as_tensor(v, device=device).long() for k, v in stream.batch_at(s).items()}
        if cfg.frontend is not None:
            b["frontend"] = frontend_noise(cfg, TRAIN21_BATCH, s, device)
        batches.append(b)
    return batches, TRAIN21_SEQ + front_tokens(cfg)


def front_tokens(cfg) -> int:
    """The frontend tokens in front of a decoder-only model's text (none
    for an encoder-decoder model, whose frames go to its encoder)."""
    return cfg.frontend_tokens if cfg.frontend is not None and not cfg.is_encdec else 0


def sharded_train(device, seed, mesh, cfg=None, label="22 (b)", count=False,
                  remat_full=False) -> dict:
    """22 (b): stablelm-1.6b whole in fp32 (or ``cfg``), ``make_step`` for
    two steps of 21 (b)'s first two batches (:func:`sharded_batches`) and
    then the train bundle for the same two steps from the same seed-0
    parameters (remat "none").
    The first run's parameters and first-step gradients go to the host
    leaf by leaf before the second is built, so the card never holds both
    states.  Gates: the first step's gradients within 1e-5 of each leaf's
    largest entry; each parameter after the steps within 1e-5 of its
    leaf's largest entry; losses rel 1e-6; each run's launches those of
    two training steps; peaks under 75 GiB.  ``count``: then one more step
    of the bundle (not timed as a step, the batch placed before it) under
    ``launch/counting.py``'s counter, for phase 23 (a): its counts, its
    wall and the memory it allocated above what was allocated before it,
    in ``runs["bundle"]["counted"]``.  ``remat_full``: then the train
    bundle once more with remat "full" (each decoder block and encoder
    layer recomputed in the backward), whose losses and first-step
    gradients must be bit for bit the remat "none" bundle's, in
    ``runs["bundle_full"]`` with its peak."""
    import torch
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import steps as steps_module
    from repro_torch.launch import train as train_module
    from repro_torch.launch.sharding import PlanConfig
    from repro_torch.launch.steps import make_train_bundle
    from repro_torch.launch.train import TrainConfig, make_step
    from repro_torch.models import build_model
    from repro_torch.optim import init_opt_state

    cfg = cfg or stablelm_config()
    opt_cfg = TrainConfig().opt
    batches, seq = sharded_batches(cfg, device, seed)
    runs = {}
    for kind in ("make_step", "bundle") + (("bundle_full",) if remat_full else ()):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model = build_model(cfg, device=device, seed=seed)
        if kind == "make_step":
            model.trainable()
            params = dict(model.named_parameters())
            step_fn = make_step(model, opt_cfg)
        else:
            bundle = make_train_bundle(cfg, ShapeConfig("train", seq, TRAIN21_BATCH, "train"),
                                       mesh,
                                       PlanConfig(tp=1, dp=1), opt_cfg,
                                       param_dtype=torch.float32,
                                       remat="full" if kind == "bundle_full" else "none",
                                       device_type=device.type)
            params = bundle.place_params(dict(model.named_parameters()))
            del model
            gc.collect()
            torch.cuda.empty_cache()
            step_fn = bundle.step_fn
        opt_state = init_opt_state(opt_cfg, params)
        module = train_module if kind == "make_step" else steps_module
        zero_launches()
        losses, norms, lrs, ms = [], [], [], []
        with first_step_grads(module) as grads0:
            for b in batches:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                params, opt_state, metrics = step_fn(params, opt_state, b)
                losses.append(float(metrics["loss"]))
                ms.append((time.perf_counter() - t0) * 1e3)
                norms.append(float(metrics["grad_norm"]))
                lrs.append(float(metrics["lr"]))
        torch.cuda.synchronize()
        run = dict(losses=losses, grad_norms=norms, step_ms=ms, launches=kernel_launches(),
                   peak_bytes=torch.cuda.max_memory_allocated())
        if kind == "make_step":
            run["params"] = {n: p.detach().to("cpu") for n, p in params.items()}
            run["grads0"] = grads0
        elif kind == "bundle_full":
            none_run = runs["bundle"]
            run["losses_bitwise"] = losses == none_run["losses"]
            run["grads0_bitwise"] = all(torch.equal(g, none_run["grads0"][n])
                                        for n, g in grads0.items())
            if not (run["losses_bitwise"] and run["grads0_bitwise"]):
                raise AssertionError(
                    f"{label}: remat 'full' losses {losses} vs 'none' {none_run['losses']}, "
                    f"first-step gradients bit for bit: {run['grads0_bitwise']}")
            del none_run["grads0"]
        else:
            ref_run = runs["make_step"]
            worst, worst_grad = 0.0, 0.0
            for n, p in params.items():
                got = p.to_local().detach()
                want = ref_run["params"][n].to(device)
                top = max(float(want.abs().max()), 1e-30)
                err = float((got - want).abs().max()) / top
                worst = max(worst, err)
                if err > SHARDED_PARAM_ATOL_REL:
                    raise AssertionError(f"{label}: {n} after {SHARDED_TRAIN_STEPS} steps differs "
                                         f"from make_step's by {err:.3e} of its largest entry")
                g_want = ref_run["grads0"][n]
                g_err = float((grads0[n] - g_want).abs().max()) / max(
                    float(g_want.abs().max()), 1e-30)
                worst_grad = max(worst_grad, g_err)
                if g_err > SHARDED_GRAD_ATOL_REL:
                    raise AssertionError(f"{label}: {n}'s first-step gradient differs from "
                                         f"make_step's by {g_err:.3e} of its largest entry")
                del want
            run["param_err"] = worst
            run["grad0_err"] = worst_grad
            if remat_full:
                run["grads0"] = grads0
            run["param_bitwise"] = worst == 0.0
            run["placements"] = sorted({str(tuple(p.placements)) for p in params.values()})
            if count:
                run["counted"] = dict(counted_step(step_fn, params, opt_state, batches[0], mesh),
                                      seq=seq)
        runs[kind] = run
        del params, opt_state, step_fn
        gc.collect()
        torch.cuda.empty_cache()
    ref, got = runs["make_step"], runs["bundle"]
    for a, b in zip(got["losses"], ref["losses"]):
        if not (math.isfinite(a) and abs(a - b) <= SHARDED_LOSS_RTOL * abs(b)):
            raise AssertionError(f"{label}: bundle losses {got['losses']} vs make_step's "
                                 f"{ref['losses']}")
    want = training_launches(cfg, SHARDED_TRAIN_STEPS)
    for kind, run in runs.items():
        if kind == "bundle_full":
            # the recompute launches the forward kernels again; the
            # backward kernels launch as often as without it
            more = {k: n - want[k] for k, n in run["launches"].items()}
            if any(n < 0 or (n and k.endswith("_backward")) for k, n in more.items()):
                raise AssertionError(f"{label}: {kind} launched {run['launches']}, expected "
                                     f"{want} and forward recomputes")
        elif run["launches"] != want:
            raise AssertionError(f"{label}: {kind} launched {run['launches']}, expected {want}")
        if run["peak_bytes"] > SHARDED_PEAK_LIMIT:
            raise AssertionError(f"{label}: {kind}'s peak {run['peak_bytes']} bytes passes "
                                 f"{SHARDED_PEAK_LIMIT / 2**30:.0f} GiB")
    del ref["params"], ref["grads0"]
    got["losses_bitwise"] = got["losses"] == ref["losses"]
    return runs


def counted_step(step_fn, params, opt_state, batch, mesh) -> dict:
    """One train step under ``launch/counting.py``'s counter on the card,
    the batch placed on the mesh before it (as a dry run's): its FLOPs,
    bytes, collective bytes and kernel launches, its wall (counting
    included), and ``torch.cuda.max_memory_allocated`` over the step less
    the memory allocated before it."""
    import torch
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.launch.counting import StepCounter

    placed = shard_batch(batch, mesh)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with StepCounter() as counter:
        step_fn(params, opt_state, placed)
    torch.cuda.synchronize()
    fig = counter.figures()
    fig["wall_ms"] = (time.perf_counter() - t0) * 1e3
    fig["peak_above_args_bytes"] = torch.cuda.max_memory_allocated() - before
    return fig


def sharded_serve(device, seed, mesh, cfg=None, label="22 (c)", plan=None) -> dict:
    """22 (c): stablelm-1.6b's (or ``cfg``'s) prefill and decode bundles
    against the unsharded ``forward_prefill`` and ``forward_decode``: the
    first 4 of phase 6's seeded prompts (its generator and seed, the
    model's vocab), each cut to the shortest of them (75 tokens), behind
    or beside ``train()``'s stand-in frontend embeddings where the model
    takes them, then 8 greedy decode steps against caches padded to the
    prefill's positions plus the steps (attention's K/V and MLA's latents
    over the prefill's positions; recurrent states and an encoder-decoder
    model's cross K/V whole).  Each side's
    kernel launches are counted and must be equal; an MoE model's expert
    ids are compared under the tie rule (:func:`check_routing`), a flip
    within the margin un-gating the comparisons that follow it (routing
    moves no hand-written kernel's count, so the launches stay gated).

    ``plan`` (the (1, 1) plan by default) may split the caches' time axis
    over 'model' (``tools/sharded_multi_card.py`` runs this on every rank
    of a (2, 2) mesh, each holding the unsharded model on its own card):
    the context is then tp x (prefill + 4) positions, so that the 'model'
    ranks' first time shard ends at the fourth decode step and the slots
    of the steps fall on both of tp = 2's ranks."""
    import numpy as np
    import torch
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.sharding import PlanConfig
    from repro_torch.launch.serve import SEQUENCE_CACHES
    from repro_torch.launch.steps import make_decode_bundle, make_prefill_bundle
    from repro_torch.launch.train import frontend_noise
    from repro_torch.models import build_model

    cfg = cfg or stablelm_config()
    rng = np.random.default_rng(seed)
    lengths = rng.integers(32, 193, size=8)
    prompts = [rng.integers(4, cfg.vocab, size=int(n)).astype(np.int32) for n in lengths]
    S = int(min(lengths[:SHARDED_PROMPTS]))
    tokens = torch.as_tensor(np.stack([p[:S] for p in prompts[:SHARDED_PROMPTS]]),
                             device=device).long()
    B = SHARDED_PROMPTS
    frames = frontend_noise(cfg, B, seed, device) if cfg.frontend is not None else None
    filled = S + front_tokens(cfg)
    plan = plan or PlanConfig(tp=1, dp=1)
    ctx = (filled + SHARDED_DECODE_STEPS if plan.tp == 1
           else plan.tp * (filled + SHARDED_DECODE_STEPS // 2))
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, device=device, seed=seed)
    pre = make_prefill_bundle(cfg, ShapeConfig("prefill", filled, B, "prefill"), mesh, plan,
                              param_dtype=torch.float32, device_type=device.type)
    dec = make_decode_bundle(cfg, ShapeConfig("decode", ctx, B, "decode"), mesh, plan,
                             param_dtype=torch.float32, device_type=device.type)
    params = pre.place_params(dict(model.named_parameters()))

    def padded(caches):
        full = model.cache_struct(B, ctx)
        for key, per in caches.items():
            for n, t in per.items():
                t = t.full_tensor() if hasattr(t, "full_tensor") else t
                if n in SEQUENCE_CACHES and key != "cross_kv":
                    full[key][n][:, :, :filled] = t
                else:
                    full[key][n].copy_(t)
        return full

    worst = {"logits": 0.0, "caches": 0.0}

    def check(what, got, want):
        got = got.full_tensor() if hasattr(got, "full_tensor") else got
        if "logits" in what:
            # the padded vocabulary's rows are masked to -1e9, which would
            # set the scale: they must agree bit for bit, the rest within it
            if not torch.equal(got[..., cfg.vocab:], want[..., cfg.vocab:]):
                raise AssertionError(f"{label}: {what}: the padded vocabulary's masked logits "
                                     "differ")
            got, want = got[..., :cfg.vocab], want[..., :cfg.vocab]
        scale = float(want.abs().max())
        excess = ((got - want).abs() - SHARDED_SERVE_TOL * want.abs()).max()
        err = float((got - want).abs().max()) / max(scale, 1e-30)
        if float(excess) > SHARDED_SERVE_TOL * scale:
            raise AssertionError(f"{label}: {what} differs from the unsharded run by {err:.3e} "
                                 f"of its largest entry")
        kind = "logits" if "logits" in what else "caches"
        worst[kind] = max(worst[kind], err)

    walls = {"unsharded": [], "bundle": []}
    launches = {"unsharded": dict.fromkeys(kernel_launches(), 0),
                "bundle": dict.fromkeys(kernel_launches(), 0)}

    def run(side, fn, *args):
        before = kernel_launches()
        sync()
        t0 = time.perf_counter()
        out = fn(*args)
        sync()
        walls[side].append((time.perf_counter() - t0) * 1e3)
        for k, n in kernel_launches().items():
            launches[side][k] += n - before[k]
        return out

    router = RouterLog() if cfg.is_moe else None
    tokens_out, flip, full = [], None, {}
    with router or contextlib.nullcontext():
        try:
            if router:
                router.side = "host"
            want_logits, want_caches = run("unsharded", model.forward_prefill, tokens, frames)
            if router:
                router.side = "card"
            batch = {"tokens": tokens} if frames is None else {"tokens": tokens, "frontend": frames}
            logits, caches = run("bundle", pre.step_fn, params, batch)
            check("prefill logits", logits, want_logits)
            for key, per in want_caches.items():
                for n, t in per.items():
                    check(f"prefill cache {key}/{n}", caches[key][n], t)
            want_full, full = padded(want_caches), padded(caches)
            del want_caches, caches
            want_tok = want_logits.argmax(-1)
            tok = logits.full_tensor().argmax(-1)
            for i in range(SHARDED_DECODE_STEPS):
                if not torch.equal(tok, want_tok):
                    raise AssertionError(f"{label}: greedy tokens differ at step {i}: "
                                         f"{tok.tolist()} vs {want_tok.tolist()}")
                tokens_out.append(tok[:, 0].tolist())
                if router:
                    router.side = "host"
                want_logits, want_full = run("unsharded", model.forward_decode, want_tok,
                                             want_full, filled + i)
                if router:
                    router.side = "card"
                logits, full = run("bundle", dec.step_fn, params, full, tok, filled + i)
                check(f"decode {i} logits", logits, want_logits)
                want_tok, tok = want_logits.argmax(-1), logits.full_tensor().argmax(-1)
            for key, per in want_full.items():
                for n, t in per.items():
                    check(f"decode cache {key}/{n}", full[key][n], t)
        except AssertionError as err:
            # a near-tie flipped by rounding routes the two runs apart;
            # anything else (or a flip past the margin) fails the phase
            flip = check_routing(label, router.calls["host"], router.calls["card"])[3] \
                if router else None
            if flip is None:
                raise
            log(f"  {label}: {err}: after a flip within the router margin at MoE call {flip[0]}, "
                f"token {flip[1]} (margin {flip[2]:.3e}) the two runs route differently; not "
                "gated from there")
    routing = None
    if router:
        n, smallest, near, flip = check_routing(label, router.calls["host"], router.calls["card"])
        routing = dict(tokens_compared=n, smallest_margin=smallest, within_margin=near,
                       flip=flip)
    if launches["bundle"] != launches["unsharded"]:
        raise AssertionError(f"{label}: the bundles launched {launches['bundle']}, the unsharded "
                             f"forwards {launches['unsharded']}")
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    del model, params
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    placed = {f"{key}/{n}": [list(t.to_local().shape), [str(p) for p in t.placements]]
              for key, per in full.items() for n, t in per.items()}
    return dict(prompt_len=S, ctx=ctx, tokens=tokens_out, max_rel_err=worst, wall_ms=walls,
                launches=launches["bundle"], peak_bytes=peak, routing=routing,
                cache_local=placed)


def sharded_collectives(device, seed, mesh) -> dict:
    """22 (d): ``gqa_decode_seqsharded`` at stablelm-1.6b's widths over the
    mesh's 'data' group (one rank: the whole cache) against ``gqa_decode``,
    and ``topk_allreduce`` against ``topk_decompress(topk_compress(...))``
    bit for bit."""
    import types

    import torch
    from repro_torch.models.attention import gqa_decode, gqa_decode_seqsharded, gqa_defs
    from repro_torch.models.common import init_params
    from repro_torch.optim.compression import (
        TopKConfig, topk_allreduce, topk_compress, topk_decompress,
    )

    cfg = stablelm_config()
    g = torch.Generator(device=device).manual_seed(seed + 22)
    layer = {k: v[0] for k, v in init_params(gqa_defs(cfg, 1), g, device=device).items()}
    p = types.SimpleNamespace(**layer)
    B, T, pos = 4, 512, 300
    shape = (B, T, cfg.n_kv_heads, cfg.head_dim)
    cache = {n: torch.randn(shape, generator=g, device=device) for n in "kv"}
    x = 0.3 * torch.randn((B, 1, cfg.d_model), generator=g, device=device)
    with torch.no_grad():
        want, _ = gqa_decode(p, x, cfg, {n: t.clone() for n, t in cache.items()}, pos)
        got, _ = gqa_decode_seqsharded(p, x, cfg, {n: t.clone() for n, t in cache.items()}, pos,
                                       mesh.get_group("data"))
    seq_err = float((got - want).abs().max()) / float(want.abs().max())
    if seq_err > SHARDED_SEQ_TOL:
        raise AssertionError(f"22 (d): gqa_decode_seqsharded differs from gqa_decode by "
                             f"{seq_err:.3e} of the largest entry")
    grad = torch.randn((cfg.d_model, cfg.d_ff), generator=g, device=device)
    err = 0.1 * torch.randn(grad.shape, generator=g, device=device)
    tcfg = TopKConfig(density=0.01)
    mean, new_err = topk_allreduce(grad, err, tcfg, mesh.get_group("data"))
    payload, want_err = topk_compress(grad, err, tcfg)
    if not (torch.equal(mean, topk_decompress(payload, grad.shape))
            and torch.equal(new_err, want_err)):
        raise AssertionError("22 (d): topk_allreduce at world size 1 is not topk_decompress("
                             "topk_compress(...)) bit for bit")
    return dict(seqsharded_rel_err=seq_err, topk_bitwise=True)


SHARDED_OLMOE_LAYERS = 2             # 22 (e): olmoe-1b-7b cut to 2 of its 16 layers
SHARDED_MINICPM_LAYERS = 2           # 22 (h): minicpm3-4b cut to 2 of its 62 layers
SHARDED_INTERNVL_LAYERS = 2          # 22 (j): internvl2-26b cut to 2 of its 48 layers
SHARDED_SEAMLESS_LAYERS = 8          # 22 (i): seamless cut to 8 + 8 of its 24 + 24 layers
PAIR_COUNTED = "22 (f)"              # its bundle counts one more step, for phase 23 (a)


def sharded_blocks_configs():
    """22 (e)-(j): olmoe-1b-7b cut to 2 of 16 layers, the jamba pair of
    21 (c) (Mamba + attention, d 8192), one xlstm-1.3b period (7 mLSTM + 1
    sLSTM), minicpm3-4b (MLA) cut to 2 of 62 layers, seamless-m4t-large-v2
    cut to 8 of its 24 encoder and 8 of its 24 decoder layers over 512
    frames (whole on four cards in ``tools/sharded_multi_card.py``; cut
    here to keep the smoke inside its limit) and internvl2-26b cut to 2 of
    48 layers behind its 256 frontend tokens, each at full width."""
    from repro_torch.configs import get_config

    def cut(arch, layers):
        return dataclasses.replace(get_config(arch), n_layers=layers,
                                   name=f"{arch}/{layers}-layers")

    return {"22 (e)": cut("olmoe-1b-7b", SHARDED_OLMOE_LAYERS),
            "22 (f)": jamba_pair_config(), "22 (g)": xlstm_configs()[1],
            "22 (h)": cut("minicpm3-4b", SHARDED_MINICPM_LAYERS),
            "22 (i)": dataclasses.replace(
                get_config("seamless-m4t-large-v2"), n_layers=SHARDED_SEAMLESS_LAYERS,
                enc_layers=SHARDED_SEAMLESS_LAYERS,
                name=f"seamless-m4t-large-v2/{SHARDED_SEAMLESS_LAYERS}+"
                     f"{SHARDED_SEAMLESS_LAYERS}-layers"),
            "22 (j)": cut("internvl2-26b", SHARDED_INTERNVL_LAYERS)}


def train_figures(runs) -> dict:
    """A train comparison's figures: losses, parameter error, walls, the
    DTensor host overhead (the bundle's step wall less make_step's), peaks
    and launches."""
    ref, got = runs["make_step"], runs["bundle"]
    full = {}
    if "bundle_full" in runs:
        rf = runs["bundle_full"]
        full = {"remat_full": {"losses_bitwise": rf["losses_bitwise"],
                               "grads0_bitwise": rf["grads0_bitwise"],
                               "step_ms": rf["step_ms"], "peak_bytes": rf["peak_bytes"],
                               "launches": rf["launches"]}}
    return {**full, "losses_bundle": got["losses"], "losses_make_step": ref["losses"],
            "losses_bitwise": got["losses_bitwise"],
            "param_max_rel_err": got["param_err"], "params_bitwise": got["param_bitwise"],
            "grad0_max_rel_err": got["grad0_err"], "grad_norms": got["grad_norms"],
            "step_ms_bundle": got["step_ms"], "step_ms_make_step": ref["step_ms"],
            "dtensor_host_overhead_ms": [a - b for a, b in zip(got["step_ms"], ref["step_ms"])],
            "peak_bytes_bundle": got["peak_bytes"], "peak_bytes_make_step": ref["peak_bytes"],
            "launches": got["launches"], "placements": got["placements"]}


def phase_sharded(device, seed, timings) -> dict:
    """Phase 22: the sharded train, prefill and decode bundles of
    stablelm-1.6b on a (1, 1) mesh over a NCCL group of one rank, every
    hand-written kernel on the local shards; the sequence-sharded decode
    and the compressed all-reduce on that group; then the same bundles
    for an MoE model, the Mamba + attention pair, an xLSTM period, an MLA
    model, an encoder-decoder model and a decoder behind frontend tokens
    (:func:`sharded_blocks_configs`).  One card shows the DTensor path and
    its kernels, not the collectives of several ranks."""
    import tempfile

    import torch
    import torch.distributed as dist

    t0 = time.perf_counter()
    log("phase 22 (a): NCCL process group of one rank (FileStore), a (1, 1) "
        "('data', 'model') mesh")
    blocks, pair_counted = {}, None
    with tempfile.TemporaryDirectory() as tmp:
        mesh = nccl_world_of_one(tmp)
        try:
            log(f"phase 22 (b): stablelm-1.6b whole, fp32, the train bundle vs make_step, "
                f"{SHARDED_TRAIN_STEPS} steps of {TRAIN21_BATCH} x {TRAIN21_SEQ}")
            train = sharded_train(device, seed, mesh, count=True)
            timings["phase22b"] = time.perf_counter() - t0
            t1 = time.perf_counter()
            log(f"phase 22 (c): stablelm-1.6b prefill and decode bundles vs the unsharded "
                f"forwards, {SHARDED_PROMPTS} prompts, {SHARDED_DECODE_STEPS} decode steps")
            serve = sharded_serve(device, seed, mesh)
            timings["phase22c"] = time.perf_counter() - t1
            t1 = time.perf_counter()
            log("phase 22 (d): gqa_decode_seqsharded and topk_allreduce on the one-rank group")
            coll = sharded_collectives(device, seed, mesh)
            timings["phase22d"] = time.perf_counter() - t1
            for label, cfg in sharded_blocks_configs().items():
                t1 = time.perf_counter()
                log(f"phase {label}: {cfg.name} at full width, fp32: the train bundle vs "
                    f"make_step, {SHARDED_TRAIN_STEPS} steps of {TRAIN21_BATCH} x "
                    f"{TRAIN21_SEQ + front_tokens(cfg)}, then the prefill and decode bundles vs "
                    f"the unsharded forwards")
                runs = sharded_train(device, seed, mesh, cfg, label,
                                     remat_full=label == "22 (i)", count=label == PAIR_COUNTED)
                if label == PAIR_COUNTED:
                    pair_counted = dict(runs["bundle"].pop("counted"), cfg=cfg)
                fig = {"train": train_figures(runs),
                       "serve": sharded_serve(device, seed, mesh, cfg, label),
                       "wall_s": time.perf_counter() - t1}
                blocks[cfg.name] = fig
                log(f"  {label}: steps {fig['train']['step_ms_bundle']} ms vs make_step's "
                    f"{fig['train']['step_ms_make_step']} ms, param err "
                    f"{fig['train']['param_max_rel_err']:.3e}, serve err "
                    f"{fig['serve']['max_rel_err']}, {fig['wall_s']:.1f} s")
                if "remat_full" in fig["train"]:
                    rf = fig["train"]["remat_full"]
                    log(f"  {label} remat 'full': losses and first-step gradients bit for bit "
                        f"remat 'none''s; steps {rf['step_ms']} ms; peak "
                        f"{rf['peak_bytes'] / 2**30:.2f} GiB ({rf['peak_bytes']} bytes) against "
                        f"remat 'none''s {fig['train']['peak_bytes_bundle'] / 2**30:.2f} GiB "
                        f"({fig['train']['peak_bytes_bundle']} bytes); launches "
                        f"{json.dumps(rf['launches'])}")
                timings["phase" + label.split()[0] + label[-2]] = fig["wall_s"]
        finally:
            dist.destroy_process_group()
    fig = {
        "phase": 22, "card": card_line(), "train": train_figures(train),
        "serve": serve, "collectives": coll, "blocks": blocks,
        "wall_s": time.perf_counter() - t0,
    }
    counted = train["bundle"]["counted"]
    log(json.dumps(fig))
    fig["counted_step"] = counted
    fig["counted_pair"] = pair_counted
    timings["phase22"] = time.perf_counter() - t0
    return fig


# ------------------------------- phase 23: the dry run against the card's step

DRY_FLOPS_RTOL = 1e-6                 # 23 (a): the dry run's FLOPs vs the card step's
DRY_CELL = ("llama3-8b", "decode_32k")   # 23 (b): on the 16x16 production mesh


def phase_dry_run(device, sharded, timings) -> dict:
    """Phase 23, after phase 22 has destroyed its NCCL group: (a) the cell
    of 22 (b) (stablelm-1.6b whole, fp32, train, 4 x 256 tokens, a (1, 1)
    mesh, remat "none") dry-run on a fake group of one rank
    (``launch/dryrun.py``: fake CUDA tensors, the kernels' stand-ins, nothing
    launched), its FLOPs, kernels' counts included, held to those of the
    step that 22 (b) counted on the card (rel 1e-6); reported beside the
    card: the dry run's peak against the card step's memory above its
    arguments, the roofline's compute term (BF16 peak and fp32's 67
    TFLOP/s) and memory term against the measured second step, and
    ``LMWorkloadModel.from_roofline``'s tokens/s against the measured; and
    the same for 22 (f)'s cell (the jamba pair), its FLOPs reported, not
    held.  Each cell's peaks: the dry run's, the card step's counted by
    the same counter, and ``max_memory_allocated`` over that step less the
    memory allocated before it; (b)
    llama3-8b x decode_32k dry-run on the 16x16 production mesh of a fake
    group of 256 ranks, which must report ok."""
    import torch
    from repro_torch.configs import ShapeConfig
    from repro_torch.core.lm_bridge import LMWorkloadModel
    from repro_torch.launch.dryrun import count_step, fake_process_group, run_cell
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.roofline import analyze_cell
    from repro_torch.launch.sharding import PlanConfig
    from repro_torch.launch.train import TrainConfig

    t0 = time.perf_counter()
    cfg = stablelm_config()
    shape = ShapeConfig("train_4x256", TRAIN21_SEQ, TRAIN21_BATCH, "train")
    log(f"phase 23 (a): {cfg.name} {shape.global_batch} x {shape.seq_len} train, (1, 1) mesh, "
        f"dry-run on a fake group of one rank, against 22 (b)'s counted step on the card")
    with fake_process_group(1):
        mesh = make_debug_mesh(1, 1, device_type=device.type)
        dry = count_step(cfg, shape, mesh, PlanConfig(tp=1, dp=1), opt_cfg=TrainConfig().opt,
                         param_dtype=torch.float32, remat="none")
    wall_a = time.perf_counter() - t0
    card = sharded["counted_step"]
    flops_err = abs(dry["flops"] - card["flops"]) / card["flops"]
    if flops_err > DRY_FLOPS_RTOL:
        raise AssertionError(f"23 (a): the dry run counts {dry['flops']} FLOPs, the card step "
                             f"{card['flops']} (rel {flops_err:.3e}); kernels {dry['kernels']} vs "
                             f"{card['kernels']}")
    step_s = sharded["train"]["step_ms_bundle"][-1] / 1e3
    report = {"arch": cfg.name, "shape": shape.name, "mesh": "1x1", "flops": dry["flops"],
              "hlo_bytes": dry["bytes"], "collectives": dry["collectives"],
              "peak_bytes_per_device": dry["peak_bytes"], "argument_bytes": dry["argument_bytes"]}
    row = analyze_cell(report, calibrate=False, shape=shape)
    bridge = LMWorkloadModel.from_roofline(row, shape=shape)
    predicted_tps = bridge.tokens_per_second(shape.tokens, 1)
    fig_a = {
        "flops_dry": dry["flops"], "flops_card": card["flops"], "flops_rel_err": flops_err,
        "kernels_equal": dry["kernels"] == card["kernels"],
        "bytes_dry": dry["bytes"], "bytes_card": card["bytes"],
        "collectives_dry": dry["collectives"], "collectives_card": card["collectives"],
        "peak_dry_bytes": dry["peak_bytes"], "peak_card_bytes": card["peak_above_args_bytes"],
        "peak_counted_card_bytes": card["peak_bytes"],
        "argument_bytes_dry": dry["argument_bytes"],
        "step_s_measured": step_s, "counted_step_wall_s": card["wall_ms"] / 1e3,
        "t_compute_bf16_s": row.t_compute, "t_compute_fp32_s": dry["flops"] / FP32_FLOPS_PER_S,
        "t_memory_s": row.t_memory, "t_collective_s": row.t_collective,
        "bottleneck": row.bottleneck, "useful_ratio": row.useful_ratio,
        "tokens_per_s_bridge": predicted_tps, "tokens_per_s_measured": shape.tokens / step_s,
        "dry_run_wall_s": wall_a}
    log(f"  23 (a): FLOPs dry {dry['flops']:.6e} card {card['flops']:.6e} (rel {flops_err:.2e}); "
        f"{peaks_line(dry, card)}; step {step_s:.4f} s against compute {row.t_compute:.4f} s "
        f"(BF16) / {fig_a['t_compute_fp32_s']:.4f} s (fp32), memory {row.t_memory:.4f} s; bridge "
        f"{predicted_tps:.1f} tok/s against {fig_a['tokens_per_s_measured']:.1f}; "
        f"{wall_a:.1f} s")
    pair = sharded["counted_pair"]
    pair_shape = ShapeConfig("train_4x256", pair["seq"], TRAIN21_BATCH, "train")
    t1 = time.perf_counter()
    log(f"phase 23 (a): {pair['cfg'].name} {pair_shape.global_batch} x {pair_shape.seq_len} train, "
        f"(1, 1) mesh, dry-run against {PAIR_COUNTED}'s counted step on the card")
    with fake_process_group(1):
        mesh = make_debug_mesh(1, 1, device_type=device.type)
        pair_dry = count_step(pair["cfg"], pair_shape, mesh, PlanConfig(tp=1, dp=1),
                              opt_cfg=TrainConfig().opt, param_dtype=torch.float32,
                              remat="none")
    fig_a["pair"] = {
        "arch": pair["cfg"].name, "flops_dry": pair_dry["flops"], "flops_card": pair["flops"],
        "flops_rel_err": abs(pair_dry["flops"] - pair["flops"]) / pair["flops"],
        "peak_dry_bytes": pair_dry["peak_bytes"], "peak_card_bytes": pair["peak_above_args_bytes"],
        "peak_counted_card_bytes": pair["peak_bytes"],
        "argument_bytes_dry": pair_dry["argument_bytes"],
        "dry_run_wall_s": time.perf_counter() - t1}
    log(f"  23 (a) {PAIR_COUNTED}'s cell: FLOPs dry {pair_dry['flops']:.6e} card "
        f"{pair['flops']:.6e} (rel {fig_a['pair']['flops_rel_err']:.2e}, reported); "
        f"{peaks_line(pair_dry, pair)}; {fig_a['pair']['dry_run_wall_s']:.1f} s")
    t1 = time.perf_counter()
    arch, shape_name = DRY_CELL
    log(f"phase 23 (b): {arch} x {shape_name} dry-run on the 16x16 mesh of a fake group of "
        f"256 ranks, full depth")
    with fake_process_group(256):
        rep = run_cell(arch, shape_name, False, verbose=False, device_type=device.type)
    if not rep.ok:
        raise AssertionError(f"23 (b): {arch} x {shape_name} failed: {rep.error}")
    fig_b = rep.to_json()
    log(f"  23 (b): ok, {rep.flops / 1e9:.1f} GFLOP a device, temp {rep.peak_bytes_per_device / 2**30:.2f} "
        f"GiB, args {rep.argument_bytes / 2**30:.2f} GiB, collectives {json.dumps(rep.collectives)}, "
        f"{time.perf_counter() - t1:.1f} s")
    fig = {"phase": 23, "card": card_line(), "a": fig_a, "b": fig_b,
           "wall_s": time.perf_counter() - t0}
    log(json.dumps(fig))
    timings["phase23"] = fig["wall_s"]
    return fig


def peaks_line(dry, card) -> str:
    """A train cell's three peaks above its arguments, in GiB and bytes: the
    dry run's, the card step's as the counter counts it, and
    ``max_memory_allocated`` over that step less the memory before it."""
    return "; ".join(f"{name} {b / 2**30:.3f} GiB ({b} bytes)" for name, b in (
        ("peak dry", dry["peak_bytes"]), ("card counted", card["peak_bytes"]),
        ("card max_memory_allocated less before", card["peak_above_args_bytes"])))


BRIDGE_TARGETS = (1e4, 1e5, 1e6)     # tok/s, as examples/serve_lm.py asks
BRIDGE_FLEET_STEPS = 6


def bridge_workload(fig):
    """An ``LMWorkloadModel`` of one served model's decode step, built as
    ``examples/serve_lm.py`` (l. 37-42) builds one: 2N FLOPs per token, the
    parameter bytes (fp32 here) over the batch slots, and no collective on
    one card."""
    from repro_torch.core.lm_bridge import LMWorkloadModel, StageCost

    N, slots = fig["n_params"], fig["slots"]
    stage = StageCost("decode_step", flops_per_token=2.0 * N,
                      hbm_bytes_per_token=4.0 * N / slots, coll_bytes_per_token=0.0)
    return LMWorkloadModel(arch=fig["name"], shape="decode", stages=[stage], chips_measured=1)


def phase_lm_bridge(device, params, served):
    """Phase 13: the LM bridge on the card's own numbers.  For each served
    model, the bridge's predicted decode tokens/s on one card (the port's
    H100 constants) beside the rate measured in its serving phase, all
    slots decoding each median decode tick (reported, not gated); then
    ``allocate_chips`` at 1e4, 1e5 and 1e6 tok/s, ``ElasticController``
    over ``examples/serve_lm.py``'s spike day (l. 47-52) on llama3-8b's
    model, and ``FleetElasticController`` over the fleet demo's trio on a
    card ``SimulatorEvaluator``, whose events must equal a ``FleetLoop``'s
    driven directly with the same loads.  Returns the figures."""
    from repro_torch.core.lm_bridge import HBM_BW, ICI_BW, PEAK_FLOPS, allocate_chips
    from repro_torch.fleet import FleetLoop
    from repro_torch.runtime import ElasticController, FleetElasticController
    from repro_torch.streams import SimulatorEvaluator, sources

    log(f"  lm_bridge constants: PEAK_FLOPS {PEAK_FLOPS:.4g} FLOP/s, HBM_BW {HBM_BW:.4g} B/s, "
        f"ICI_BW (NVLink) {ICI_BW:.4g} B/s")
    fig = dict(models={})
    for served_fig in served:
        wl = bridge_workload(served_fig)
        slots = served_fig["slots"]
        predicted = wl.tokens_per_second(slots, 1)
        measured = slots / (served_fig["decode_tick_ms"] / 1e3)
        fig["models"][served_fig["name"]] = dict(
            predicted_tok_s=predicted, measured_decode_tok_s=measured,
            served_tok_s=served_fig["tok_s"], error=predicted / measured - 1.0,
            bottleneck=wl.bottleneck(),
            chips={f"{t:.0e}": allocate_chips(wl, t, tokens_per_step=slots).chips
                   for t in BRIDGE_TARGETS})
        log(f"  {served_fig['name']} ({served_fig['n_params']:,} params, {slots} slots): "
            f"predicted {predicted:.1f} tok/s on 1 card ({wl.bottleneck()}-bound, step "
            f"{wl.step_seconds(slots, 1) * 1e3:.4f} ms), measured {measured:.1f} tok/s "
            f"({slots} / median decode tick {served_fig['decode_tick_ms']:.3f} ms; "
            f"{served_fig['tok_s']:.1f} tok/s over the serving wall), error "
            f"{(predicted / measured - 1.0) * 100:+.1f}%")
        for t in BRIDGE_TARGETS:
            a = allocate_chips(wl, t, tokens_per_step=slots)
            log(f"    allocate_chips {t:9.0f} tok/s -> {a.chips:6d} cards (predicted "
                f"{a.predicted_tokens_per_s:.0f} tok/s, step {a.predicted_step_s * 1e3:.4f} ms, "
                f"{a.bottleneck})")
            if a.chips & (a.chips - 1) or not a.meets_target:
                raise AssertionError(f"{served_fig['name']}: allocation {a}")

    llama = next(f for f in served if f["name"] == "llama3-8b")
    trace = sources.spike(96, base_ktps=30.0, spike_ratio=15.0, seed=3) * 1e3
    ctl = ElasticController(bridge_workload(llama), tokens_per_step=llama["slots"],
                            min_chips=8, max_chips=2048)
    for load in trace:
        ctl.observe(float(load))
    log(f"  ElasticController over the spike day ({len(trace)} steps, {trace.min():.0f}-"
        f"{trace.max():.0f} tok/s) on llama3-8b's card model: {len(ctl.events)} re-meshes")
    for e in ctl.events:
        log(f"    {e.load_tokens_per_s:10.0f} tok/s: {e.chips_before:5d} -> {e.chips_after:5d} "
            f"cards ({e.reason})")
    if not ctl.events or max(e.chips_after for e in ctl.events) <= 8:
        raise AssertionError("the spike day re-meshed no card count up")
    fig["remeshes"] = [(e.chips_before, e.chips_after) for e in ctl.events]

    def evaluator():
        return SimulatorEvaluator(params=params, duration_s=4.0, device=device)

    tenants, traces, cluster = demo_fleet(params)
    replans = []
    fctl = FleetElasticController(tenants, cluster, evaluator(), on_reschedule=replans.append)
    t0 = time.perf_counter()
    plans = [fctl.observe(loads_at(traces, i)) for i in range(BRIDGE_FLEET_STEPS)]
    wall = time.perf_counter() - t0
    tenants, traces, cluster = demo_fleet(params)
    loop = FleetLoop(tenants, cluster, evaluator())
    for i in range(BRIDGE_FLEET_STEPS):
        loop.step(loads_at(traces, i))
    diff = first_difference(fctl.events, loop.events)
    if diff:
        raise AssertionError(f"FleetElasticController against FleetLoop: {diff}")
    if [p is not None for p in plans] != [e.replanned for e in fctl.events] or \
            replans != [e for e in fctl.events if e.replanned]:
        raise AssertionError("FleetElasticController returned plans off its replans")
    log(f"  FleetElasticController, the demo's trio, {BRIDGE_FLEET_STEPS} steps in {wall:.3f} s: "
        f"{len(replans)} reschedules ({', '.join(e.cause for e in replans)}), moves "
        f"{[e.moves for e in fctl.events]}; events equal a FleetLoop's driven directly")
    fig["fleet"] = dict(steps=BRIDGE_FLEET_STEPS, reschedules=len(replans), wall_s=wall)
    return fig


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
    t_main = time.perf_counter()
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
    from repro_torch.control import make_trace
    from repro_torch.streams import (
        cache_stats, clear_resident_cache, clear_result_caches, clear_structure_cache,
    )
    from repro_torch.kernels.stream_flow import build, container_sum, ordered_sum, stream_flow_ell
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

    empty = empty_library()
    timings["build"] = build_all([build.LIBRARY, rmsnorm_ops.LIBRARY,
                                  rmsnorm_ops.BACKWARD_LIBRARY, flash_ops.LIBRARY,
                                  flash_ops.BACKWARD_LIBRARY, ssm_ops.LIBRARY,
                                  ssm_ops.BACKWARD_LIBRARY, empty])
    log(f"build: {timings['build']:.1f} s for 7 libraries and the empty kernel")

    t0 = time.perf_counter()
    log("phase 1: kernel vs plain")
    oracle = oracle_models(deep_pipeline(), params.sm_cost_per_ktuple)
    oracle_alloc = allocate(deep_pipeline(), oracle, TARGET_KTPS, overprovision=1.1)
    max_err = phase_kernel(
        device, rng, oracle_alloc.config, params,
        sizes=[(8, 32, 8, 100), (8, 1024, 512, 49152)],
    )
    # a separate generator, so the one phase 3's candidates come from is
    # where it was before these checks
    check_rng = np.random.default_rng(15)
    big = random_flow_problem(check_rng, 2, 4096, 2048, 196608, device)
    max_err = max(max_err, check_kernel("random(4096,2048,196608)", big))
    sum_err = check_container_sum("random(4096,2048)", sum_inputs(big, check_rng))
    del big
    ord_err = phase_ordered_sum(device, check_rng)
    phase_bitwise(device, params, oracle_alloc.config,
                  candidate_configs(oracle_alloc, 32, check_rng)[1:], check_rng)
    timings["phase1"] = time.perf_counter() - t0

    from repro_torch.streams import simulator
    flow_rec = LaunchRecorder(simulator.stream_flow_ell, flow_key)
    sum_rec = LaunchRecorder(simulator.container_sum, sum_key)
    ord_rec = LaunchRecorder(simulator.ordered_sum, ordered_key)
    simulator.stream_flow_ell, simulator.container_sum = flow_rec, sum_rec
    simulator.ordered_sum = ord_rec
    stream_flow_ell.launches = container_sum.launches = ordered_sum.launches = 0
    try:
        t0 = time.perf_counter()
        log("phase 2: main path on deep_pipeline")
        result = phase_main_path(device, params, dim, TARGET_KTPS, sweep_s=8.0, measure_s=10.0)
        torch.cuda.synchronize()
        timings["phase2"] = time.perf_counter() - t0
        launches_main = stream_flow_ell.launches
        sums_main = container_sum.launches
        ordered_main = ordered_sum.launches
        log(f"  launches in phase 2: stream_flow_ell {launches_main}, container_sum {sums_main}, "
            f"ordered_sum {ordered_main}")

        t0 = time.perf_counter()
        log("phase 3: 32 candidates around the allocation (sparse, summary)")
        candidates = candidate_configs(result, 32, rng)
        phase_batch(device, params, candidates, duration_s=20.0)
        torch.cuda.synchronize()
        timings["phase3"] = time.perf_counter() - t0
        launches = stream_flow_ell.launches
        sum_launches = container_sum.launches
        ordered_launches = ordered_sum.launches
    finally:
        simulator.stream_flow_ell, simulator.container_sum = flow_rec.fn, sum_rec.fn
        simulator.ordered_sum = ord_rec.fn
    log(f"  launches in phase 3: stream_flow_ell {launches - launches_main}, "
        f"container_sum {sum_launches - sums_main}, ordered_sum {ordered_launches - ordered_main}; "
        f"wall {timings['phase3']:.3f} s for "
        f"{int(20.0 / params.dt)} ticks ({timings['phase3'] / (20.0 / params.dt) * 1e3:.3f} ms/tick, "
        f"threefry noise included)")
    log(f"launches after phases 2-3: stream_flow_ell {launches}, container_sum {sum_launches}, "
        f"ordered_sum {ordered_launches}")
    stream_fns = (stream_flow_ell, container_sum, ordered_sum)
    log_shapes((("stream_flow_ell", flow_rec), ("container_sum", sum_rec), ("ordered_sum", ord_rec)),
               (launches, sum_launches, ordered_launches), "the main path")

    t0 = time.perf_counter()
    log("phase 3b: bucket invariance of the allocation on both ticks")
    bucket_diff = phase_buckets(device, params, result.config, duration_s=4.0)
    timings["phase3b"] = time.perf_counter() - t0

    # phase 3c counts its launches by shape on recorders of its own, so
    # phases 2-3's counts (the kernel table's launch column) stay as they were
    flow_c = LaunchRecorder(flow_rec.fn, flow_key)
    sum_c = LaunchRecorder(sum_rec.fn, sum_key)
    ord_c = LaunchRecorder(ord_rec.fn, ordered_key)
    simulator.stream_flow_ell, simulator.container_sum = flow_c, sum_c
    simulator.ordered_sum = ord_c
    stream_flow_ell.launches = container_sum.launches = ordered_sum.launches = 0
    try:
        t0 = time.perf_counter()
        log("phase 3c (a): the candidates through SimulatorEvaluator (sparse, 2 s): dedup, "
            "result cache, resident batches and refetch against the escape hatch")
        evaluator = phase_engine(device, params, candidates, duration_s=2.0)
        timings["phase3c_engine"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        day = make_trace("diurnal", CONTROL_DAY_STEPS, base_ktps=6700.0, seed=3)
        log(f"phase 3c (b): a diurnal day of deep_pipeline ({len(day)} steps, "
            f"{day.min():.0f}-{day.max():.0f} ktps) through ControlLoop, HybridPolicy and "
            f"PredictivePolicy (Holt-Winters, season 24, horizon 4) on that evaluator")
        phase_control(device, params, evaluator, deep_pipeline(), day, dim, season=24,
                      launch_fns=stream_fns)
        torch.cuda.synchronize()
        timings["phase3c_control"] = time.perf_counter() - t0
        log(f"  cache_stats after the day: {json.dumps(cache_stats())}")
        t0 = time.perf_counter()
        log("phase 3c (c): a diurnal day of adanalytics (24 steps, 600 ktps base) through "
            "ControlLoop and PredictivePolicy learning with the default calibration batch, "
            "stream managers costing 2.5x what the models assume")
        phase_learning(device, params, dim, launch_fns=stream_fns)
        torch.cuda.synchronize()
        timings["phase3c_learning"] = time.perf_counter() - t0
    finally:
        simulator.stream_flow_ell, simulator.container_sum = flow_c.fn, sum_c.fn
        simulator.ordered_sum = ord_c.fn
    launches_3c = {fn.__name__: fn.launches for fn in stream_fns}
    log(f"launches in phase 3c: {json.dumps(launches_3c)}")
    log_shapes((("stream_flow_ell", flow_c), ("container_sum", sum_c), ("ordered_sum", ord_c)),
               tuple(launches_3c.values()), "phase 3c")
    del evaluator
    # the engine's caches hold staged device tensors (the resident batches)
    # and host memos; empty them, so phase 3d starts, and phases 4-9 read
    # their peak memory, as they did before phase 3c
    clear_resident_cache()
    clear_structure_cache()
    clear_result_caches()
    torch.cuda.empty_cache()

    # phase 3d, the fleet, counts its launches by shape on recorders of its own too
    flow_d = LaunchRecorder(flow_rec.fn, flow_key)
    sum_d = LaunchRecorder(sum_rec.fn, sum_key)
    ord_d = LaunchRecorder(ord_rec.fn, ordered_key)
    simulator.stream_flow_ell, simulator.container_sum = flow_d, sum_d
    simulator.ordered_sum = ord_d
    stream_flow_ell.launches = container_sum.launches = ordered_sum.launches = 0
    recs_3d = (("stream_flow_ell", flow_d), ("container_sum", sum_d), ("ordered_sum", ord_d))
    try:
        t0 = time.perf_counter()
        log(f"phase 3d (a): examples/fleet_demo.py's three tenants, {DEMO_STEPS} steps through "
            "FleetLoop on SimulatorEvaluator(duration_s=4.0), then again with the controller "
            "crashed after step 12 and restored from its checkpoint")
        fleet_demo = phase_fleet_demo(device, params)
        timings["phase3d_demo"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        log("phase 3d (b): N+1 on the demo cluster, a host of the guaranteed tenant failed at step 2")
        fleet_n1 = phase_fleet_n1(device, params)
        timings["phase3d_n1"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        log(f"phase 3d (c): {FLEET_COPIES * 3} tenants ({FLEET_COPIES} copies of the demo's trio), "
            f"{FLEET_STEPS} steps through FleetLoop with N+1 for the guaranteed tier")
        fleet_scale = phase_fleet_scale(device, params, FLEET_COPIES, FLEET_STEPS, recs_3d)
        timings["phase3d_fleet"] = time.perf_counter() - t0
    finally:
        simulator.stream_flow_ell, simulator.container_sum = flow_d.fn, sum_d.fn
        simulator.ordered_sum = ord_d.fn
    launches_3d = {fn.__name__: fn.launches for fn in stream_fns}
    backends_3d = {fleet_demo["backend"], *fleet_demo["crash_backends"], fleet_n1["backend"],
                   fleet_scale["backend"]}
    log(f"launches in phase 3d: {json.dumps(launches_3d)}; backends {sorted(backends_3d)}")
    # the flow kernel runs only where an evaluator's "auto" resolved to the sparse tick
    must_3d = [i for i, (name, _) in enumerate(recs_3d)
               if name != "stream_flow_ell" or "sparse" in backends_3d]
    if "sparse" not in backends_3d and launches_3d["stream_flow_ell"]:
        raise AssertionError("phase 3d ran the dense tick only, yet launched the flow kernel")
    log_shapes([recs_3d[i] for i in must_3d], [list(launches_3d.values())[i] for i in must_3d],
               "phase 3d")
    clear_resident_cache()
    clear_structure_cache()
    clear_result_caches()
    torch.cuda.empty_cache()

    # phase 3e, the executor and the batched LP, counts the stream kernels'
    # launches (its folded simulator's) on recorders of its own too
    flow_e = LaunchRecorder(flow_rec.fn, flow_key)
    sum_e = LaunchRecorder(sum_rec.fn, sum_key)
    ord_e = LaunchRecorder(ord_rec.fn, ordered_key)
    simulator.stream_flow_ell, simulator.container_sum = flow_e, sum_e
    simulator.ordered_sum = ord_e
    stream_flow_ell.launches = container_sum.launches = ordered_sum.launches = 0
    recs_3e = (("stream_flow_ell", flow_e), ("container_sum", sum_e), ("ordered_sum", ord_e))
    t_3e = time.perf_counter()
    try:
        t0 = time.perf_counter()
        log("phase 3e (a): run_dag on wordcount, adanalytics and mobile_analytics on the card at "
            f"batch 2,048 and {EXEC_BIG_BATCH:,}, then card against host on one source of the "
            f"same batches ({EXEC_CMP_BATCH:,} tuples)")
        exec_fig = phase_executor(device)
        timings["phase3e_executor"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        log("phase 3e (b): ExecutorEvaluator() on the card over the fleet demo trio's candidates, "
            "then fold_executor_timings(adanalytics()) into a card SimulatorEvaluator")
        exec_eval_fig = phase_executor_evaluator(device, params, dim)
        timings["phase3e_evaluator"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        log("phase 3e (c): torch_linprog on the card against numpy's linprog (seeded suite, "
            "24 x 16 batched 256 ways, deep_pipeline flow LPs at "
            f"{', '.join(f'{t:,.0f}' for t in LP_TARGETS)} ktps) and fit_many_torch")
        lp_fig = phase_batched_lp(device, params, dim)
        timings["phase3e_lp"] = time.perf_counter() - t0
    finally:
        simulator.stream_flow_ell, simulator.container_sum = flow_e.fn, sum_e.fn
        simulator.ordered_sum = ord_e.fn
    timings["phase3e"] = time.perf_counter() - t_3e
    launches_3e = {fn.__name__: fn.launches for fn in stream_fns}
    backend_3e = exec_eval_fig["folded_sim"]["backend"]
    log(f"launches in phase 3e: {json.dumps(launches_3e)}; backend {backend_3e}; "
        f"{timings['phase3e']:.1f} s")
    must_3e = [i for i, (name, _) in enumerate(recs_3e)
               if name != "stream_flow_ell" or backend_3e == "sparse"]
    if backend_3e != "sparse" and launches_3e["stream_flow_ell"]:
        raise AssertionError("phase 3e ran the dense tick only, yet launched the flow kernel")
    log_shapes([recs_3e[i] for i in must_3e], [list(launches_3e.values())[i] for i in must_3e],
               "phase 3e")
    del exec_fig, exec_eval_fig, lp_fig
    clear_resident_cache()
    clear_structure_cache()
    clear_result_caches()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    log("phase 3c: each stream kernel against its plain version, and timed, at every shape "
        "phase 3c launched it at (device time from CUDA-graph replay; eager time from CUDA events)")
    excess = {}
    errs_3c = check_and_time(flow_c, sum_c, ord_c, "phase 3c", excess)
    del flow_c, sum_c, ord_c
    torch.cuda.empty_cache()
    timings["phase3c_shapes"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    log("phase 3d: each stream kernel against its plain version, and timed, at every shape "
        "phase 3d launched it at")
    errs_3d = check_and_time(flow_d, sum_d, ord_d, "phase 3d", excess)
    del flow_d, sum_d, ord_d, recs_3d
    torch.cuda.empty_cache()
    timings["phase3d_shapes"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    log("phase 3e: each stream kernel against its plain version, and timed, at every shape "
        "phase 3e launched it at")
    errs_3e = check_and_time(flow_e, sum_e, ord_e, "phase 3e", excess)
    del flow_e, sum_e, ord_e, recs_3e
    torch.cuda.empty_cache()
    timings["phase3e_shapes"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    log("timing the stream kernels at the main path's shapes "
        "(device time from CUDA-graph replay; eager time from CUDA events)")
    empty_ms = time_empty_kernel(empty)
    p1 = padded_flow_problem([result.config], params, rng, device)
    t_b1 = time_flow("batch 1 (allocation)", p1)
    p32 = padded_flow_problem(candidates, params, rng, device)
    t_b32 = time_flow("batch 32 (candidates)", p32)
    max_err = max(max_err, check_kernel("batch 32 (candidates)", p32))
    flow_at = {}
    for key in sorted(flow_rec.counts):
        if key == recorder_key(p1):
            flow_at[key] = t_b1
        elif key == recorder_key(p32):
            flow_at[key] = t_b32
        else:
            flow_at[key] = time_recorded(key, flow_rec.inputs[key])
    sum_at = {}
    for key in sorted(sum_rec.counts):
        args = sum_rec.inputs[key]
        sum_err = max(sum_err, check_container_sum(f"main path {key}", args))
        sum_at[key] = time_container_sum(args)
    ord_at = {}
    for key in sorted(ord_rec.counts):
        args = ord_rec.inputs[key]
        ord_err = max(ord_err, check_ordered_sum(f"main path {key}", args))
        ord_at[key] = time_ordered_sum(args)
    max_err = max(max_err, *(e["stream_flow_ell"] for e in (errs_3c, errs_3d, errs_3e)))
    sum_err = max(sum_err, *(e["container_sum"] for e in (errs_3c, errs_3d, errs_3e)))
    ord_err = max(ord_err, *(e["ordered_sum"] for e in (errs_3c, errs_3d, errs_3e)))
    for name, rec, at in (("stream_flow_ell", flow_rec, flow_at), ("container_sum", sum_rec, sum_at),
                          ("ordered_sum", ord_rec, ord_at)):
        for key, t in at.items():
            n = rec.counts[key]
            log(f"  {name} launches x (time - bound) at {key}: {n} x "
                f"({t['ms']:.5f} - {t['bound_ms']:.6f}) ms = {n * (t['ms'] - t['bound_ms']):.3f} ms")
        excess[f"{name}, phases 2-3"] = excess_ms([(rec.counts[k], t) for k, t in at.items()])
    t_sum32 = sum_at[max(sum_at)]            # the largest batch: the candidates
    ord_main = max(ord_rec.counts, key=lambda k: (ord_rec.counts[k], k))   # the most launched shape
    log(f"ordered_sum at its most launched shape {ord_main} ({ord_rec.counts[ord_main]} launches): "
        f"{json.dumps(ord_at[ord_main])}")
    log("profile: where a tick's time goes (32 candidates, sparse, summary)")
    profile_ticks(device, params, candidates, duration_s=1.0)
    timings["timing"] = time.perf_counter() - t0
    log(f"batch 1: {json.dumps(t_b1)}")

    seed = 0
    serve_rng = np.random.default_rng(seed)
    prompt_lengths = sorted({int(n) for n in serve_rng.integers(32, 193, size=8)})
    t0 = time.perf_counter()
    log("phase 4: rmsnorm, add_rmsnorm and flash_attention kernels vs plain at llama3-8b's "
        "and jamba's shapes, flash at seamless's and internvl2's, and all three at olmoe's, "
        "mixtral's and minicpm3's")
    d = LLAMA["d"]
    norm_shapes = ([(1, S, d) for S in prompt_lengths] + [(4, 1, d), (300, d)]
                   + [(1, max(prompt_lengths), 2 * d), (4, 1, 2 * d)])
    rms_err = check_rmsnorm(device, norm_shapes)
    add_err = check_add_rmsnorm(device, norm_shapes)
    H, KV, hd = LLAMA["H"], LLAMA["KV"], LLAMA["hd"]
    # beside llama3-8b's and jamba's: seamless-m4t-large-v2's encoder over
    # its 512 frames, its decoder's causal prefill and its cross-attention
    # over the frames (keys of their own length), and internvl2-26b's
    # causal prefill behind its 256 frontend tokens
    seam, intern = get_config("seamless-m4t-large-v2"), get_config("internvl2-26b")
    sH, sKV, shd, sT = seam.n_heads, seam.n_kv_heads, seam.head_dim, seam.frontend_tokens
    iH, iKV, ihd, iT = intern.n_heads, intern.n_kv_heads, intern.head_dim, intern.frontend_tokens
    flash_err = check_flash(
        device,
        [(S, H, KV, hd, True, None) for S in (1, 7, 128, 130, 192)]
        + [(S, H, KV, hd, True, None) for S in prompt_lengths]
        + [(S, 2 * H, KV, hd, True, None) for S in prompt_lengths]
        + [(130, H, KV, hd, True, 32),
           (130, H, KV, hd, False, None),
           (7, H, KV, hd, False, None),
           (130, 32, 8, 120, True, None)]
        + [(sT, sH, sKV, shd, False, None)]
        + [(S, sH, sKV, shd, True, None) for S in prompt_lengths]
        + [(S, sH, sKV, shd, False, None, sT) for S in [1, 7] + prompt_lengths]
        + [(iT + S, iH, iKV, ihd, True, None) for S in prompt_lengths],
    )
    moe_flash_err, moe_rms_err, moe_add_err = check_moe_mla_kernels(device, prompt_lengths)
    flash_err, rms_err = max(flash_err, moe_flash_err), max(rms_err, moe_rms_err)
    add_err = max(add_err, moe_add_err)
    x_rms_err, x_add_err, rms_bwd_err, add_bwd_err = check_xlstm_kernels(device, prompt_lengths)
    rms_err, add_err = max(rms_err, x_rms_err), max(add_err, x_add_err)
    timings["phase4"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    log("phase 5: card vs host, llama3-8b at full width, 2 layers")
    two_layers = dataclasses.replace(get_config("llama3-8b"), n_layers=2)
    logit_err = phase_card_vs_host(device, two_layers, prompt_len=48, decode_steps=4, seed=seed)
    torch.cuda.empty_cache()
    timings["phase5"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    log("phase 6: serve llama3-8b at full depth (BatchedServer, 4 slots, max_ctx 256)")
    server, lm_launches, lengths, lm_fig = phase_serve(device, "llama3-8b", seed, n_requests=8,
                                                       slots=4, max_ctx=256, max_new=16)
    lm_ticks = server.decode_steps
    timings["phase6"] = time.perf_counter() - t0
    log("profile: where serving time goes (4 requests x 16 tokens, 128-token prompts)")
    profile_serving(server, serve_rng, n_requests=4, prompt_len=128, max_new=16)
    del server
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    log("timing rmsnorm, add_rmsnorm and flash_attention at the serving paths' shapes "
        "(device time from CUDA-graph replay; eager time from CUDA events)")
    rms_at = {(S, w): time_rmsnorm(device, (1, S, w)) for w in (d, 2 * d) for S in sorted(set(lengths))}
    t_rms = time_rmsnorm(device, (4, 1, d))
    t_rms_wide = time_rmsnorm(device, (4, 1, 2 * d))
    add_at = {(S, w): time_add_rmsnorm(device, (1, S, w))
              for w in (d, 2 * d) for S in sorted(set(lengths))}
    t_add = time_add_rmsnorm(device, (4, 1, d))
    t_add_wide = time_add_rmsnorm(device, (4, 1, 2 * d))
    flash_at = {S: time_flash(device, S) for S in sorted(set(lengths))}
    flash_wide_at = {S: time_flash(device, S, H=2 * H) for S in sorted(set(lengths))}
    t_flash = flash_at[max(lengths)]
    timings["lm_timing"] = time.perf_counter() - t0
    llama, cut_cfg = get_config("llama3-8b"), get_config("jamba-1.5-large-398b")
    n_add = norms_per_forward(llama) - 1
    excess["flash_attention, phase 6"] = excess_ms(
        [(block_counts(llama)["attn"], flash_at[S]) for S in lengths])
    excess["rmsnorm, phase 6"] = excess_ms(
        [(1, rms_at[(S, d)]) for S in lengths] + [(lm_ticks, t_rms)])
    excess["add_rmsnorm, phase 6"] = excess_ms(
        [(n_add, add_at[(S, d)]) for S in lengths] + [(n_add * lm_ticks, t_add)])
    log(f"rmsnorm at the longest prefill (1, {max(lengths)}, {d}): "
        f"{json.dumps(rms_at[(max(lengths), d)])}")
    log(f"add_rmsnorm at the longest prefill (1, {max(lengths)}, {d}): "
        f"{json.dumps(add_at[(max(lengths), d)])}")

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
    cut = dataclasses.replace(cut_cfg, n_experts=0, experts_per_token=0, n_layers=8,
                              name="jamba-1.5-large-398b/1-period-dense")
    t0 = time.perf_counter()
    log("phase 8: card vs host, jamba-1.5-large at full width, one Mamba and one attention block")
    pair, pair_models = jamba_pair_config(), {}
    hybrid_err = phase_card_vs_host(device, pair, prompt_len=48, decode_steps=4, seed=seed,
                                    keep=pair_models)
    timings["phase8"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    log(f"phase 21 (a), on phase 8's models: card vs host training gradients, {pair.name} "
        f"({PAIR_GRAD_BATCH} x {PAIR_GRAD_SEQ})")
    pair_grads = phase_train_card_vs_host(device, pair, seed, PAIR_GRAD_BATCH, PAIR_GRAD_SEQ,
                                          models=pair_models)
    pair_models.clear()
    gc.collect()
    torch.cuda.empty_cache()
    timings["phase21a_pair"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    log("phase 9: serve one full-width period of jamba-1.5-large with dense MLPs "
        "(BatchedServer, 4 slots, max_ctx 256)")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    server, jamba_launches, _, jamba_fig = phase_serve(device, cut, seed, n_requests=8, slots=4,
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
    scan_at = {S: time_ssm_scan(device, 1, S) for S in sorted(set(lengths))}
    t_scan_prefill = scan_at[max(lengths)]
    t_scan = time_ssm_scan(device, 4, 1)
    timings["ssm_timing"] = time.perf_counter() - t0
    n_mamba, n_add9 = block_counts(cut)["mamba"], norms_per_forward(cut) - 1

    t0 = time.perf_counter()
    log("phase 10: card vs host, seamless-m4t-large-v2 at full width, 2 encoder and 2 decoder "
        "layers, seeded non-zero frame embeddings")
    seam_pair = dataclasses.replace(seam, n_layers=2, enc_layers=2,
                                    name="seamless-m4t-large-v2/2+2-layers")
    encdec_err = phase_card_vs_host(device, seam_pair, prompt_len=48, decode_steps=4, seed=seed)
    torch.cuda.empty_cache()
    timings["phase10"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    log("phase 11: serve seamless-m4t-large-v2 at full width and depth (24 encoder and 24 "
        "decoder layers; BatchedServer, 4 slots, max_ctx 256, zero frame embeddings)")
    torch.cuda.reset_peak_memory_stats()
    server, seam_launches, _, seam_fig = phase_serve(device, "seamless-m4t-large-v2", seed,
                                                     n_requests=8, slots=4, max_ctx=256,
                                                     max_new=16)
    if server.model.n_params() != SEAMLESS_PARAMS:
        raise AssertionError(f"seamless has {server.model.n_params():,} parameters")
    seam_ticks = server.decode_steps
    timings["phase11"] = time.perf_counter() - t0
    log("profile: where serving time goes (4 requests x 16 tokens, 128-token prompts)")
    profile_serving(server, serve_rng, n_requests=4, prompt_len=128, max_new=16)
    del server
    torch.cuda.empty_cache()

    # 8 of internvl2-26b's 48 layers at full width: all 48 (79.6 GB in
    # fp32) do not fit beside the caches on one card
    intern_cut = dataclasses.replace(intern, n_layers=INTERNVL_LAYERS,
                                     name=f"internvl2-26b/{INTERNVL_LAYERS}-of-48-layers")
    t0 = time.perf_counter()
    log(f"phase 12: serve {INTERNVL_LAYERS} of internvl2-26b's 48 layers at full width behind "
        f"its {iT} frontend tokens (BatchedServer, 4 slots, max_ctx 512, zero patch embeddings)")
    torch.cuda.reset_peak_memory_stats()
    server, intern_launches, _, intern_fig = phase_serve(device, intern_cut, seed, n_requests=8,
                                                         slots=4, max_ctx=512, max_new=16)
    intern_ticks = server.decode_steps
    timings["phase12"] = time.perf_counter() - t0
    log("profile: where serving time goes (4 requests x 16 tokens, 128-token prompts)")
    profile_serving(server, serve_rng, n_requests=4, prompt_len=128, max_new=16)
    del server
    torch.cuda.empty_cache()

    moe_mla = phases_moe_mla(device, seed, serve_rng, timings)
    xlstm = phases_xlstm(device, seed, serve_rng, timings)
    new_served = list(moe_mla["served"].values()) + [xlstm["served"]]
    trained = phases_train_attention_mamba(device, seed, timings, pair_grads)
    sharded = phase_sharded(device, seed, timings)
    phase_dry_run(device, sharded, timings)

    t0 = time.perf_counter()
    log("phase 13: the LM bridge on the card's own numbers (phases 6, 9, 11, 12, 15-17 and 19), "
        "then allocate_chips, ElasticController over the spike day and FleetElasticController "
        "over the fleet demo")
    bridge_fig = phase_lm_bridge(device, params, [lm_fig, jamba_fig, seam_fig, intern_fig]
                                 + [run["fig"] for run in new_served])
    timings["phase13"] = time.perf_counter() - t0
    clear_resident_cache()
    clear_structure_cache()
    clear_result_caches()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    log("timing flash_attention, rmsnorm and add_rmsnorm at phases 11 and 12's shapes "
        "(device time from CUDA-graph replay; eager time from CUDA events)")
    t_enc = time_flash(device, sT, H=sH, KV=sKV, hd=shd, causal=False)
    seam_causal_at = {S: time_flash(device, S, H=sH, KV=sKV, hd=shd)
                      for S in sorted(set(lengths))}
    seam_cross_at = {S: time_flash(device, S, H=sH, KV=sKV, hd=shd, Sk=sT, causal=False)
                     for S in sorted(set(lengths))}
    intern_at = {S: time_flash(device, iT + S, H=iH, KV=iKV, hd=ihd)
                 for S in sorted(set(lengths))}
    norm_at = {}
    for label, w, prefill_rows in (("seamless", seam.d_model, sT),
                                   ("internvl2", intern.d_model, iT + max(lengths))):
        norm_at[label] = dict(
            rms=time_rmsnorm(device, (4, 1, w)), add=time_add_rmsnorm(device, (4, 1, w)),
            rms_prefill=time_rmsnorm(device, (1, prefill_rows, w)),
            add_prefill=time_add_rmsnorm(device, (1, prefill_rows, w)))
    timings["lm_timing_11_12"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    log("timing flash_attention, rmsnorm and add_rmsnorm at phases 15-17's shapes "
        "(device time from CUDA-graph replay; eager time from CUDA events)")
    time_moe_mla(device, lengths, moe_mla["served"], excess)
    timings["lm_timing_15_17"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    log("timing rmsnorm and add_rmsnorm at phase 19's shapes and both backward kernels at "
        "phase 20's (device time from CUDA-graph replay; eager time from CUDA events)")
    t_rms_bwd, t_add_bwd = time_xlstm(device, lengths, xlstm, excess)
    tl = xlstm["train"]["launches"]
    timings["lm_timing_19_20"] = time.perf_counter() - t0
    L11, E11 = seam.n_layers, seam.enc_layers
    excess["flash_attention, phase 11"] = excess_ms(
        [(E11 * len(lengths), t_enc)] + [(L11, seam_causal_at[S]) for S in lengths]
        + [(L11, seam_cross_at[S]) for S in lengths])
    excess["flash_attention, phase 12"] = excess_ms(
        [(INTERNVL_LAYERS, intern_at[S]) for S in lengths])
    # norms: every prefill's timed at the longest prefill's rows (an upper
    # estimate), every decode forward's at (4, 1, d)
    n = len(lengths)
    for phase, ticks, cfg_, t in (("phase 11", seam_ticks, seam, norm_at["seamless"]),
                                  ("phase 12", intern_ticks, intern_cut, norm_at["internvl2"])):
        pre = expected_launches(cfg_, forwards=n, prefills=n)
        dec = expected_launches(cfg_, forwards=ticks, prefills=0)
        excess[f"rmsnorm, {phase}"] = excess_ms(
            [(pre["rmsnorm"], t["rms_prefill"]), (dec["rmsnorm"], t["rms"])])
        excess[f"add_rmsnorm, {phase}"] = excess_ms(
            [(pre["add_rmsnorm"], t["add_prefill"]), (dec["add_rmsnorm"], t["add"])])
    log(f"flash at the seamless encoder (1, {sT}, {sH}, {shd}) non-causal: {json.dumps(t_enc)}")
    log(f"flash at seamless cross-attention prefill S={max(lengths)}, Sk={sT}: "
        f"{json.dumps(seam_cross_at[max(lengths)])}")
    log(f"flash at internvl2's longest prefill S={iT + max(lengths)}: "
        f"{json.dumps(intern_at[max(lengths)])}")
    excess["ssm_scan, phase 9 prefills"] = excess_ms([(n_mamba, scan_at[S]) for S in lengths])
    excess["ssm_scan, phase 9 decode"] = excess_ms([(n_mamba * jamba_ticks, t_scan)])
    excess["flash_attention, phase 9"] = excess_ms(
        [(block_counts(cut)["attn"], flash_wide_at[S]) for S in lengths])
    excess["rmsnorm, phase 9"] = excess_ms(
        [(1, rms_at[(S, 2 * d)]) for S in lengths] + [(jamba_ticks, t_rms_wide)])
    excess["add_rmsnorm, phase 9"] = excess_ms(
        [(n_add9, add_at[(S, 2 * d)]) for S in lengths] + [(n_add9 * jamba_ticks, t_add_wide)])
    log(f"ssm_scan at the longest prefill (1, {max(lengths)}, {D}, {N}): {json.dumps(t_scan_prefill)}")
    bwd = trained["kernels"]
    stable_run, pair_run = trained["stablelm"][0], trained["pair"][0]
    excess["flash_attention_backward, phase 21 (b)"] = excess_ms(
        [(stable_run["launches"]["flash_attention_backward"], bwd["flash"])])
    excess["flash_attention_backward, phase 21 (c)"] = excess_ms(
        [(pair_run["launches"]["flash_attention_backward"], bwd["flash_pair"])])
    excess["ssm_scan_backward, phase 21 (c)"] = excess_ms(
        [(pair_run["launches"]["ssm_scan_backward"], bwd["scan"])])
    log(f"launches x (time - bound) by kernel and path, largest first (empty kernel "
        f"{empty_ms:.5f} ms per launch):")
    for label, ms in sorted(excess.items(), key=lambda kv: -kv[1]):
        log(f"  {ms:10.3f} ms  {label}")
    log("phase wall times: " + " ".join(f"{k} {v:.1f}s" for k, v in timings.items())
        + f"; since main began {time.perf_counter() - t_main:.1f}s")
    log(f"card vs host: max|logit difference| llama3-8b {logit_err:.3e}, "
        f"jamba mamba+attn {hybrid_err:.3e}, seamless 2+2 layers {encdec_err:.3e}, "
        + ", ".join(f"{k} 2 layers {v:.3e}" for k, v in moe_mla["card_vs_host"].items())
        + ", " + ", ".join(f"xlstm-1.3b period S={S} {v:.3e}"
                           for S, v in xlstm["card_vs_host"].items())
        + f"; training loss rel {xlstm['train_card_vs_host']['loss_rel']:.3e}, gradients "
        f"{xlstm['train_card_vs_host']['grad_rel']:.3e} of their leaves' largest; "
        + "; ".join(f"{name} training loss rel {g['loss_rel']:.3e}, gradients "
                    f"{g['grad_rel']:.3e}" for name, g in trained["grads"].items())
        + "; "
        f"bucket phase max|diff| "
        + ", ".join(f"{k} {m} {v:.3e}" for (k, m), v in bucket_diff.items()))

    # the serving paths each kernel runs on: phases 6, 9, 11, 12, 15-17 and 19
    serving = (lm_launches, jamba_launches, seam_launches, intern_launches,
               *(run["launches"] for run in new_served))
    serve_total = {k: sum(s[k] for s in serving) for k in lm_launches}
    log("serving launches, phases 6 / 9 / 11 / 12 / 15 / 16 / 17 / 19: " + "; ".join(
        f"{k} {' / '.join(str(s[k]) for s in serving)} = {serve_total[k]}" for k in serve_total))
    log(f"lm bridge: {json.dumps(bridge_fig)}")
    kernels = [
        dict(name="stream_flow_ell", route="cuda",
             source="src/repro_torch/kernels/stream_flow/csrc/stream_flow.cu",
             replaces="src/repro/kernels/stream_flow/stream_flow.py:94",
             launches=launches, max_abs_err=max_err,
             **{k: t_b32[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}),
        dict(name="container_sum", route="cuda",
             source="src/repro_torch/kernels/stream_flow/csrc/stream_flow.cu",
             replaces="src/repro/streams/simulator.py:701",
             launches=sum_launches, max_abs_err=sum_err, **t_sum32),
        dict(name="ordered_sum", route="cuda",
             source="src/repro_torch/kernels/stream_flow/csrc/stream_flow.cu",
             replaces="src/repro/streams/simulator.py:716",
             launches=ordered_launches, max_abs_err=ord_err, **ord_at[ord_main]),
        dict(name="rmsnorm", route="cuda",
             source="src/repro_torch/kernels/rmsnorm/csrc/rmsnorm.cu",
             replaces="src/repro/kernels/rmsnorm/rmsnorm.py:23",
             launches=serve_total["rmsnorm"], max_abs_err=rms_err, **t_rms),
        dict(name="add_rmsnorm", route="cuda",
             source="src/repro_torch/kernels/rmsnorm/csrc/rmsnorm.cu",
             replaces="src/repro/kernels/rmsnorm/rmsnorm.py:23 with the residual adds at "
                      "src/repro/models/transformer.py:122, :173",
             launches=serve_total["add_rmsnorm"], max_abs_err=add_err,
             **{k: t_add[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}),
        dict(name="flash_attention", route="cuda",
             source="src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention/flash_attention.py:89",
             launches=serve_total["flash_attention"], max_abs_err=flash_err, **t_flash),
        dict(name="ssm_scan", route="cuda",
             source="src/repro_torch/kernels/ssm_scan/csrc/ssm_scan.cu",
             replaces="src/repro/kernels/ssm_scan/ssm_scan.py:63",
             launches=jamba_launches["ssm_scan"], max_abs_err=scan_err, **t_scan),
        dict(name="rmsnorm_backward", route="cuda",
             source="src/repro_torch/kernels/rmsnorm/csrc/rmsnorm_bwd.cu",
             replaces="src/repro/models/common.py:154 (rms_norm under jax.grad; no Pallas "
                      "backward)",
             launches=tl["rmsnorm_backward"], max_abs_err=rms_bwd_err, **t_rms_bwd),
        dict(name="add_rmsnorm_backward", route="cuda",
             source="src/repro_torch/kernels/rmsnorm/csrc/rmsnorm_bwd.cu",
             replaces="src/repro/models/common.py:154 with the residual adds at "
                      "src/repro/models/transformer.py:122, :173 (under jax.grad; no Pallas "
                      "backward)",
             launches=tl["add_rmsnorm_backward"], max_abs_err=add_bwd_err, **t_add_bwd),
        dict(name="flash_attention_backward", route="cuda",
             source="src/repro_torch/kernels/flash_attention/csrc/flash_attention_bwd.cu",
             replaces="src/repro/models/attention.py:94 (the attention core under jax.grad; "
                      "no Pallas backward of src/repro/kernels/flash_attention/"
                      "flash_attention.py:89)",
             launches=stable_run["launches"]["flash_attention_backward"],
             max_abs_err=bwd["flash_err"], **bwd["flash"]),
        dict(name="ssm_scan_backward", route="cuda",
             source="src/repro_torch/kernels/ssm_scan/csrc/ssm_scan_bwd.cu",
             replaces="src/repro/models/ssm.py:43 (_mamba_inner's scan under jax.grad; no "
                      "Pallas backward of src/repro/kernels/ssm_scan/ssm_scan.py:63)",
             launches=pair_run["launches"]["ssm_scan_backward"],
             max_abs_err=bwd["scan_err"], **bwd["scan"]),
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
