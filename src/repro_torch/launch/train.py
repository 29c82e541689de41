"""The training loop: data pipeline, the training step, checkpointing and
fault tolerance, on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-1.3b@smoke \\
        --steps 20 --device cpu

Without ``--device`` it trains on the CUDA card and raises where there is
none.  It keeps the reference loop's semantics
(``repro/launch/train.py``): a batch is a pure function of the seed and
the step, a checkpoint holds the parameters and the whole optimizer state,
and a run restarted from one reproduces the uninterrupted run's losses.
Four departures:

- the weights come from the port's seeded ``torch.Generator``
  (:func:`repro_torch.models.build_model`), not ``jax.random``; tests that
  compare the two packages load the reference's weights into the port;
- a model with a frontend gets its stand-in frontend embeddings from a
  ``torch.Generator`` seeded with the step, where the reference draws
  them from ``jax.random.PRNGKey(step)``: the same distribution, other
  numbers;
- when the last step falls on ``ckpt_every``, the periodic save of that
  step is left to the final save, which writes the same step and tree
  (the reference writes it twice); a 1.3B-parameter model's checkpoint
  is about 21 GB;
- a run that raises (an injected failure) first waits for the checkpoint
  write it handed off, where the reference leaves the writer running: a
  restart in the same process then resumes from that checkpoint whatever
  the disk's speed, and its own write of a step never meets a writer of
  the failed run in the same directory.

The step runs on one device; :mod:`repro_torch.launch.steps` builds the
same step on a device mesh for every architecture.  On the card
every kernel the forward launches has a backward kernel (the RMSNorm
pair, flash attention, the selective scan), so every registered
architecture trains there; :func:`check_trainable` refuses, before
anything is built, only the widths those kernels do not take.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any

import torch

from ..checkpoint.checkpointer import Checkpointer
from ..configs import get_config
from ..configs.base import MLAConfig, ModelConfig, SSMConfig
from ..data.pipeline import DataConfig, SyntheticLMStream
from ..device import resolve_device
from ..kernels.flash_attention.ops import MAX_HEAD_DIM
from ..kernels.ssm_scan.ops import MAX_STATE
from ..models import Model, build_model
from ..models.frontends import frontend_embed_shape
from ..optim.optimizer import AdamWConfig, adamw_update, init_opt_state
from ..runtime.fault import FailurePlan, StragglerMonitor


@dataclasses.dataclass
class TrainConfig:
    arch: str = "stablelm-1.6b@smoke"
    steps: int = 100
    seq_len: int = 128
    global_batch: int = 8
    ckpt_dir: str | None = None
    ckpt_every: int = 25
    seed: int = 0
    log_every: int = 10
    opt: AdamWConfig = dataclasses.field(
        default_factory=lambda: AdamWConfig(peak_lr=1e-3, warmup_steps=20,
                                            total_steps=1000)
    )
    # model overrides for a small example without a dedicated config
    d_model: int | None = None
    n_layers: int | None = None


def check_trainable(cfg: ModelConfig, device_type: str) -> None:
    """Raises ``ValueError`` if training ``cfg`` on a device of type
    ``device_type`` would hand a kernel a width it does not take: on
    "cuda", an attention head over flash attention's 128 columns (MLA's
    kernel width is ``max(qk_nope + qk_rope, v)``) or an SSM state over the
    selective scan's 16.  Training on the CPU runs the plain versions,
    which take any width."""
    if device_type != "cuda":
        return
    pattern = cfg.pattern()
    if "attn" in pattern or cfg.is_encdec:
        if cfg.attention == "mla":
            m = cfg.mla or MLAConfig()
            width = max(m.qk_nope_head_dim + m.qk_rope_head_dim, m.v_head_dim)
        else:
            width = cfg.head_dim
        if width > MAX_HEAD_DIM:
            raise ValueError(
                f"{cfg.name}: attention head width {width} is over the flash kernels' "
                f"{MAX_HEAD_DIM}; train it with device='cpu'")
    if "mamba" in pattern:
        state = (cfg.ssm or SSMConfig()).d_state
        if state > MAX_STATE:
            raise ValueError(
                f"{cfg.name}: SSM state width {state} is over the selective-scan kernels' "
                f"{MAX_STATE}; train it with device='cpu'")


def model_config(tc: TrainConfig) -> ModelConfig:
    """The architecture's config with ``tc``'s width and depth overrides."""
    cfg = get_config(tc.arch)
    overrides = {}
    if tc.d_model:
        overrides["d_model"] = tc.d_model
        overrides["head_dim"] = tc.d_model // cfg.n_heads
        overrides["d_ff"] = tc.d_model * 3 if cfg.d_ff else 0
    if tc.n_layers:
        overrides["n_layers"] = tc.n_layers
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def build_state(tc: TrainConfig, device=None):
    """(cfg, model, params, opt_state) for ``tc`` on ``device`` (``None``
    means the card): the model's parameters made trainable in place,
    ``params`` the dict of them by name, and a fresh optimizer state."""
    cfg = model_config(tc)
    device = resolve_device(device)
    check_trainable(cfg, device.type)
    model = build_model(cfg, device=device, seed=tc.seed).trainable()
    params = dict(model.named_parameters())
    return cfg, model, params, init_opt_state(tc.opt, params)


def make_step(model: Model, opt_cfg: AdamWConfig):
    """The single-device training step ``step(params, opt_state, batch) ->
    (params, opt_state, metrics)``: the loss, its gradients by autograd,
    and the AdamW update in place.  ``batch`` holds tensors on the
    model's device; ``metrics`` ``loss``, ``ce``, the MoE aux values,
    ``lr`` and ``grad_norm`` as 0-d tensors."""
    check_trainable(model.cfg, model.embed.device.type)

    def train_step(params: dict, opt_state: dict, batch: dict):
        for p in params.values():
            p.grad = None
        loss, metrics = model.loss_fn(batch)
        loss.backward()
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in params.items()}
        params, opt_state, om = adamw_update(opt_cfg, params, grads, opt_state)
        for p in params.values():
            p.grad = None
        metrics = {k: v.detach() for k, v in metrics.items()}
        return params, opt_state, {"loss": loss.detach(), **metrics, **om}

    return train_step


def frontend_noise(cfg: ModelConfig, batch: int, step: int, device) -> torch.Tensor:
    """The stand-in frontend embeddings of ``step``: 0.02 × standard normals
    from a ``torch.Generator`` on ``device`` seeded with the step."""
    g = torch.Generator(device=device).manual_seed(step)
    return 0.02 * torch.randn(frontend_embed_shape(cfg, batch), generator=g, device=device)


@torch.no_grad()
def _restore(tree: dict, params: dict, opt_state: dict) -> None:
    """Copies a checkpoint's ``params`` and ``opt`` leaves (host arrays) into
    the live tensors, in place, one leaf at a time, so the device never
    holds a second copy of the state."""
    for name, p in params.items():
        p.copy_(torch.as_tensor(tree["params"][name]))

    def copy(dst, src):
        for k, v in dst.items():
            copy(v, src[k]) if isinstance(v, dict) else v.copy_(torch.as_tensor(src[k]))

    copy(opt_state, tree["opt"])


def train(tc: TrainConfig, failure_plan: FailurePlan | None = None, on_step: Any = None,
          device=None) -> dict:
    """Run (or resume, from ``tc.ckpt_dir``'s newest checkpoint) training on
    ``device`` (``None`` means the card); returns summary metrics.

    ``on_step(step, loss, metrics, dt)``, if given, is called after every
    step with its loss (a float), the step's metrics (0-d tensors:
    ``loss``, ``ce``, ``lr``, ``grad_norm`` and any MoE aux values) and
    its wall time in seconds, up to the loss read, which waits for the
    step's device work."""
    cfg, model, params, opt_state = build_state(tc, device)
    dev = model.embed.device
    stream = SyntheticLMStream(
        DataConfig(vocab=cfg.vocab, seq_len=tc.seq_len, global_batch=tc.global_batch,
                   seed=tc.seed))
    step_fn = make_step(model, tc.opt)

    start_step = 0
    ckpt = Checkpointer(tc.ckpt_dir) if tc.ckpt_dir else None
    if ckpt is not None:
        restored = ckpt.restore_latest()
        if restored is not None:
            start_step, tree = restored
            _restore(tree, params, opt_state)
            del tree

    monitor = StragglerMonitor()
    losses = []
    try:
        for step in range(start_step, tc.steps):
            batch = {k: torch.as_tensor(v, device=dev).long()
                     for k, v in stream.batch_at(step).items()}
            if cfg.frontend is not None:
                batch["frontend"] = frontend_noise(cfg, tc.global_batch, step, dev)
            t0 = time.perf_counter()
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            monitor.observe(step, dt)
            losses.append(loss)
            if on_step is not None:
                on_step(step, loss, metrics, dt)
            if tc.log_every and step % tc.log_every == 0:
                print(f"step {step:5d}  loss {loss:7.4f}  "
                      f"lr {float(metrics['lr']):.2e}  {dt*1000:6.1f} ms")
            if ckpt is not None and (step + 1) % tc.ckpt_every == 0 and step + 1 < tc.steps:
                ckpt.save(step + 1, {"params": params, "opt": opt_state})
            if failure_plan is not None:
                failure_plan.maybe_fail(step)
    finally:
        if ckpt is not None:
            # a failure leaves no writer behind: the restart reads the last
            # checkpoint handed off before it, and never shares its tmp dir
            ckpt.wait()

    if ckpt is not None:
        ckpt.save(tc.steps, {"params": params, "opt": opt_state}, blocking=True)
    return {
        "final_loss": losses[-1] if losses else float("nan"),
        "first_loss": losses[0] if losses else float("nan"),
        "losses": losses,
        "stragglers": monitor.stragglers,
        "params": params,
        "start_step": start_step,
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b@smoke")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--d-model", type=int, default=None)
    ap.add_argument("--n-layers", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' to run on the host)")
    args = ap.parse_args()
    tc = TrainConfig(
        arch=args.arch, steps=args.steps, seq_len=args.seq_len,
        global_batch=args.global_batch, ckpt_dir=args.ckpt_dir,
        d_model=args.d_model, n_layers=args.n_layers,
    )
    out = train(tc, device=args.device)
    print(f"done: loss {out['first_loss']:.4f} -> {out['final_loss']:.4f}")


if __name__ == "__main__":
    main()
