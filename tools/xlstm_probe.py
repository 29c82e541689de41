"""The smoke run's xLSTM and training part on its own: phase 4's checks at
xlstm-1.3b's shapes (the norms forward, and both RMSNorm backward kernels
against autograd through their plain versions), phases 18-20 (card vs
host at one full-width period; xlstm-1.3b whole behind ``BatchedServer``
with its launch counts asserted; card vs host training gradients, 8
training steps of the whole model, a crash and restart from a checkpoint,
the card-training guard), one training step of the whole model under the
profiler (which the smoke run leaves out for its cost: about 80 s), the
norms and backward kernels timed
with their bounds and library calls, and the LM bridge's one-card rate
beside the measured one.

Needs a CUDA card (about 6 min of command time; the restarted run writes
two checkpoints of about 21 GB each under ``build/``, removed afterwards)
and builds the rmsnorm and rmsnorm backward libraries from the checkout.

Run from the repository root:  python3 tools/xlstm_probe.py
"""
from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]


def profile_train_step(device, seed: int, warmup: int = 2) -> None:
    """One training step of xlstm-1.3b whole (phase 20 (b)'s batch) under
    the profiler, after ``warmup`` steps without it: the step's wall, its
    device busy share, device time by kernel, and its device events."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from repro_torch.data import DataConfig, SyntheticLMStream
    from repro_torch.launch.train import TrainConfig, build_state, make_step

    tc = TrainConfig(arch=cs.xlstm_configs()[0].name, seq_len=cs.TRAIN_SEQ,
                     global_batch=cs.TRAIN_BATCH, seed=seed)
    cfg, model, params, opt_state = build_state(tc, device)
    step_fn = make_step(model, tc.opt)
    stream = SyntheticLMStream(DataConfig(vocab=cfg.vocab, seq_len=tc.seq_len,
                                          global_batch=tc.global_batch, seed=seed))
    for step in range(warmup + 1):
        batch = {k: torch.as_tensor(v, device=device).long()
                 for k, v in stream.batch_at(step).items()}
        torch.cuda.synchronize()
        if step < warmup:
            params, opt_state, _ = step_fn(params, opt_state, batch)
            continue
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            params, opt_state, m = step_fn(params, opt_state, batch)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t) * 1e3
    cs.log_device_time(prof, wall_ms, f"profiler over training step {warmup} (loss "
                       f"{float(m['loss']):.6f})", top=10)
    n = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)
    cs.log(f"  training step {warmup} (profiler): {n} device events (kernels, copies, "
           "memsets; the profiler may drop some)")
    del model, params, opt_state, prof
    torch.cuda.empty_cache()


def main() -> None:
    import numpy as np

    import chip_smoke as cs
    from repro_torch import resolve_device
    from repro_torch.kernels.rmsnorm import ops as rmsnorm_ops

    device = resolve_device(None)
    cs.log(cs.card_line())
    walls = {"build": cs.build_all([rmsnorm_ops.LIBRARY, rmsnorm_ops.BACKWARD_LIBRARY])}
    serve_rng = np.random.default_rng(0)
    prompt_lengths = sorted({int(n) for n in serve_rng.integers(32, 193, size=8)})
    t0 = time.perf_counter()
    errs = cs.check_xlstm_kernels(device, prompt_lengths)
    walls["phase4"] = time.perf_counter() - t0
    cs.log("phase 4 at xlstm-1.3b's shapes: max|kernel-plain| rmsnorm {:.3e}, add_rmsnorm "
           "{:.3e}; max|kernel-autograd| rmsnorm_backward {:.3e}, add_rmsnorm_backward "
           "{:.3e}".format(*errs))
    out = cs.phases_xlstm(device, 0, serve_rng, walls)
    t0 = time.perf_counter()
    cs.log("profile: one training step of xlstm-1.3b whole")
    profile_train_step(device, 0)
    walls["train_profile"] = time.perf_counter() - t0
    excess = {}
    t0 = time.perf_counter()
    cs.time_xlstm(device, out["served"]["lengths"], out, excess)
    walls["timing"] = time.perf_counter() - t0
    fig = out["served"]["fig"]
    predicted = cs.bridge_workload(fig).tokens_per_second(fig["slots"], 1)
    measured = fig["slots"] / (fig["decode_tick_ms"] / 1e3)
    cs.log(f"bridge {fig['name']}: predicted {predicted:.1f} tok/s on 1 card, measured "
           f"{measured:.1f}, error {(predicted / measured - 1) * 100:+.1f}%")
    cs.log(f"figures {json.dumps(fig)}")
    cs.log(f"training {json.dumps(out['train'])}")
    cs.log("launches x (time - bound) by kernel and path, largest first:")
    for label, ms in sorted(excess.items(), key=lambda kv: -kv[1]):
        cs.log(f"  {ms:10.3f} ms  {label}")
    cs.log(f"card vs host, max|logit difference|: {json.dumps(out['card_vs_host'])}; training "
           f"{json.dumps(out['train_card_vs_host'])}")
    cs.log("walls: " + " ".join(f"{k} {v:.1f}s" for k, v in walls.items()))


if __name__ == "__main__":
    main()
