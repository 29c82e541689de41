"""The port's training stack against the reference's: AdamW (schedule,
clipping, moments, master weights) on a seeded tree, the synthetic data
bit for bit, three training steps from the same weights and batches, a
restarted run equal to an uninterrupted one, and the guard that keeps
models with kernels lacking a backward off the card.

Tolerances: AdamW's parameters and state rel 1e-6 (the update is
elementwise; only the clip's global norm and the fp32 schedule round in
other orders); the three steps' losses rel 1e-5 and final weights within
1e-5 of each leaf's largest entry plus 2% of the summed learning rate
(gradients of two autodiff systems, then Adam's per-element normalised
step, see the test); the restart rel 1e-5, the reference's own
tolerance for the same test (``tests/test_fault_tolerance.py``)."""
import dataclasses
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.data import DataConfig as JaxDataConfig
from repro.data import SyntheticLMStream as JaxStream
from repro.data.tokenizer import HashTokenizer as JaxTokenizer
from repro.launch.train import make_step as jax_make_step
from repro.models import build_model as jax_build_model
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import adamw_update as jax_adamw_update
from repro.optim import cosine_lr as jax_cosine_lr
from repro.optim import init_opt_state as jax_init_opt_state
from repro_torch.configs import get_config, list_archs
from repro_torch.configs.base import MLAConfig, SSMConfig
from repro_torch.data import DataConfig, HashTokenizer, PrefetchIterator, SyntheticLMStream
from repro_torch.interop import model_params_from_numpy
from repro_torch.launch.train import (
    TrainConfig,
    build_state,
    check_trainable,
    make_step,
    train,
)
from repro_torch.models import build_model
from repro_torch.optim import AdamWConfig, adamw_update, cosine_lr, global_norm, init_opt_state
from repro_torch.runtime import FailurePlan, run_with_restarts

# ------------------------------------------------------------------ optimizer

OPT_CASES = {
    "master": dict(peak_lr=1e-2, warmup_steps=2, total_steps=6, clip_norm=1.0),
    "no-master-no-clip": dict(peak_lr=3e-3, warmup_steps=0, total_steps=5, clip_norm=1e9,
                              use_master=False, weight_decay=0.0),
    "bf16-moments": dict(peak_lr=1e-2, warmup_steps=1, total_steps=4,
                         moments_dtype="bfloat16"),
}


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(size=(5, 7)).astype(np.float32),
            "b": {"c": rng.normal(size=(11,)).astype(np.float32),
                  "d": rng.normal(size=(3, 2, 4)).astype(np.float32)}}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}.") if isinstance(v, dict) else {prefix + k: v})
    return out


@pytest.mark.parametrize("case", sorted(OPT_CASES))
def test_adamw_matches_reference(case):
    """Six updates of a seeded tree with seeded gradients (large enough to
    clip where the case clips): parameters, moments, masters, the step and
    the metrics."""
    kw = OPT_CASES[case]
    jcfg, cfg = JaxAdamWConfig(**kw), AdamWConfig(**kw)
    jparams = jax.tree_util.tree_map(jnp.asarray, _tree(0))
    params = {k: torch.from_numpy(v.copy()) for k, v in _flat(_tree(0)).items()}
    jstate, state = jax_init_opt_state(jcfg, jparams), init_opt_state(cfg, params)
    for step in range(6):
        grads = _tree(10 + step)
        grads = jax.tree_util.tree_map(lambda g: g * (3.0 if step % 2 else 0.2), grads)
        jparams, jstate, jm = jax_adamw_update(jcfg, jparams, jax.tree_util.tree_map(
            jnp.asarray, grads), jstate)
        params, state, m = adamw_update(cfg, params, {k: torch.from_numpy(v) for k, v in
                                                      _flat(grads).items()}, state)
        assert float(m["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
        assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-6)
    assert int(state["step"]) == int(jstate["step"]) == 6
    for name in ("m", "v") + (("master",) if cfg.use_master else ()):
        want = _flat(jax.tree_util.tree_map(np.asarray, jstate[name]))
        for k, t in state[name].items():
            assert str(t.dtype).split(".")[1] == str(want[k].dtype), (name, k)
            torch.testing.assert_close(t.float(), torch.from_numpy(want[k].astype(np.float32)),
                                       rtol=1e-6, atol=1e-7, msg=lambda s: f"{name}.{k}: {s}")
    assert sorted(state) == sorted(jstate)
    want = _flat(jax.tree_util.tree_map(np.asarray, jparams))
    for k, t in params.items():
        torch.testing.assert_close(t, torch.from_numpy(want[k].copy()), rtol=1e-6, atol=1e-7)


def test_schedule_and_global_norm_match_reference():
    kw = dict(peak_lr=2e-3, min_lr_frac=0.05, warmup_steps=7, total_steps=40)
    for step in (0, 1, 6, 7, 8, 23, 40, 55):
        got = float(cosine_lr(AdamWConfig(**kw), torch.tensor(step, dtype=torch.int32)))
        want = float(jax_cosine_lr(JaxAdamWConfig(**kw), jnp.asarray(step, jnp.int32)))
        assert got == pytest.approx(want, rel=1e-6), step
    tree = _flat(_tree(3))
    want = float(np.sqrt(sum(float((v.astype(np.float64) ** 2).sum()) for v in tree.values())))
    assert float(global_norm({k: torch.from_numpy(v) for k, v in tree.items()})) == \
        pytest.approx(want, rel=1e-6)


# ------------------------------------------------------------------ data

@pytest.mark.parametrize("cfg", [dict(vocab=512, seq_len=64, global_batch=4, seed=3),
                                 dict(vocab=50304, seq_len=256, global_batch=2, seed=0)])
def test_synthetic_batches_equal_the_reference_bit_for_bit(cfg):
    port, ref = SyntheticLMStream(DataConfig(**cfg)), JaxStream(JaxDataConfig(**cfg))
    for step in (0, 1, 17):
        got, want = port.batch_at(step), ref.batch_at(step)
        assert sorted(got) == sorted(want) == ["labels", "tokens"]
        for k in got:
            assert got[k].dtype == want[k].dtype == np.int32
            assert np.array_equal(got[k], want[k]), (step, k)
    it = PrefetchIterator(port, start_step=5)
    try:
        b = next(it)
    finally:
        it.close()
    assert b["step"] == 5 and np.array_equal(b["tokens"], ref.batch_at(5)["tokens"])
    text = "stream processing pipelines scale with load"
    assert HashTokenizer(1000).encode(text) == JaxTokenizer(1000).encode(text)


# ------------------------------------------------------------------ steps

def _stepped_pair(arch, opt_kw):
    jcfg = jax_get_config(arch)
    jm = jax_build_model(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    jopt = JaxAdamWConfig(**opt_kw)
    tm = build_model(get_config(arch), device="cpu", seed=1)
    tm.load_state_dict(model_params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                               tm.cfg))
    tm.trainable()
    return jm, jparams, jopt, tm


@pytest.mark.parametrize("arch", ["xlstm-1.3b@smoke", "stablelm-1.6b@smoke"])
def test_three_training_steps_match_reference(arch):
    """``make_step`` three times from the reference's initial weights on the
    same synthetic batches (32 positions, batch 2): each step's loss (rel
    1e-5) and gradient norm (rel 1e-4), and the weights after the third."""
    opt_kw = dict(peak_lr=1e-3, warmup_steps=1, total_steps=10)
    jm, jparams, jopt, tm = _stepped_pair(arch, opt_kw)
    jstep = jax_make_step(jm, jopt)
    jstate = jax_init_opt_state(jopt, jparams)
    params = dict(tm.named_parameters())
    start = {n: p.detach().clone() for n, p in params.items()}
    state = init_opt_state(AdamWConfig(**opt_kw), params)
    step_fn = make_step(tm, AdamWConfig(**opt_kw))
    stream = SyntheticLMStream(DataConfig(vocab=tm.cfg.vocab, seq_len=32, global_batch=2))
    for step in range(3):
        batch = stream.batch_at(step)
        jparams, jstate, jm_ = jstep(jparams, jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        params, state, m = step_fn(params, state, {k: torch.from_numpy(v).long()
                                                   for k, v in batch.items()})
        assert float(m["loss"]) == pytest.approx(float(jm_["loss"]), rel=1e-5), step
        assert float(m["grad_norm"]) == pytest.approx(float(jm_["grad_norm"]), rel=1e-4), step
    # Adam divides each element's first moment by the root of its second:
    # where a gradient's steps nearly cancel, that ratio turns the
    # gradients' float32 rounding (rel ~1e-5) into a larger share of the
    # step, so each weight is held within 2% of the summed learning rate
    # (the most three steps can move it, weight decay aside) beside 1e-5 of
    # its leaf's largest entry
    lr_sum = sum(float(cosine_lr(AdamWConfig(**opt_kw), torch.tensor(s))) for s in (1, 2, 3))
    want = model_params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), tm.cfg)
    moved = 0.0
    for name, p in params.items():
        assert p.grad is None
        w = want[name]
        torch.testing.assert_close(p.detach(), w, rtol=0.0,
                                   atol=1e-5 * float(w.abs().max()) + 0.02 * lr_sum,
                                   msg=lambda s: f"{name}: {s}")
        moved = max(moved, float((w - start[name]).abs().max()))
    assert moved > 0.5 * lr_sum


def test_train_restarted_after_a_failure_reproduces_the_uninterrupted_run(tmp_path):
    """The port's ``train()`` crashed after step 5 and restarted from its
    step-4 checkpoint under ``run_with_restarts`` gives the uninterrupted
    run's loss at every step, as the reference's test requires of the
    reference."""
    base = dict(arch="xlstm-1.3b@smoke", steps=12, seq_len=32, global_batch=2, ckpt_every=4,
                log_every=0)
    ref = train(TrainConfig(**base), device="cpu")
    losses: dict[int, float] = {}
    starts = []
    plan = FailurePlan(fail_after_steps=(5,))

    def run(attempt: int) -> int:
        out = train(TrainConfig(**base, ckpt_dir=str(tmp_path / "ck")), failure_plan=plan,
                    on_step=lambda s, l, m, dt: losses.__setitem__(s, l),
                    device="cpu")
        starts.append(out["start_step"])
        return out["start_step"]

    _, restarts = run_with_restarts(run)
    assert restarts == 1 and starts == [4]
    assert sorted(losses) == list(range(12))
    for s, l in losses.items():
        assert l == pytest.approx(ref["losses"][s], rel=1e-5), s
    assert all(np.isfinite(ref["losses"]))


def test_a_failure_right_after_a_checkpoint_restarts_from_it(tmp_path, monkeypatch):
    """The failure comes as soon as step 4's checkpoint is handed to the
    writer, and every file the writer saves takes 20 ms: the failed run
    waits for that write, so the restart resumes from step 4 (not step 2)
    and reproduces the uninterrupted run's losses."""
    import repro_torch.checkpoint.checkpointer as ck

    class SlowDisk:
        def __getattr__(self, name):
            return getattr(np, name)

        @staticmethod
        def save(*args, **kw):
            time.sleep(0.02)
            return np.save(*args, **kw)

    base = dict(arch="xlstm-1.3b@smoke", steps=6, seq_len=16, global_batch=2, ckpt_every=2,
                log_every=0)
    ref = train(TrainConfig(**base), device="cpu")
    monkeypatch.setattr(ck, "np", SlowDisk())
    losses: dict[int, float] = {}
    starts = []
    plan = FailurePlan(fail_after_steps=(3,))

    def run(attempt: int) -> int:
        out = train(TrainConfig(**base, ckpt_dir=str(tmp_path / "ck")), failure_plan=plan,
                    on_step=lambda s, l, m, dt: losses.__setitem__(s, l), device="cpu")
        starts.append(out["start_step"])
        return out["start_step"]

    _, restarts = run_with_restarts(run)
    assert restarts == 1 and starts == [4]
    assert [losses[s] for s in range(6)] == pytest.approx(ref["losses"], rel=1e-5)


def test_train_on_step_gets_the_step_metrics_and_wall_time():
    """``on_step`` gets each step's loss as returned in ``losses``, its
    metric tensors (the schedule's learning rate at the optimizer's
    count after the update, ``step + 1``, and a finite gradient norm) and
    a positive wall time."""
    tc = TrainConfig(arch="xlstm-1.3b@smoke", steps=3, seq_len=16, global_batch=2, log_every=0)
    seen = []
    out = train(tc, on_step=lambda *a: seen.append(a), device="cpu")
    assert [s for s, *_ in seen] == [0, 1, 2]
    assert [l for _, l, _, _ in seen] == out["losses"]
    for step, loss, metrics, dt in seen:
        assert {"loss", "ce", "lr", "grad_norm"} <= set(metrics)
        assert float(metrics["loss"]) == loss and dt > 0
        assert np.isfinite(float(metrics["grad_norm"]))
        assert float(metrics["lr"]) == pytest.approx(
            float(cosine_lr(tc.opt, torch.tensor(step + 1, dtype=torch.int32))), rel=1e-6)


def test_frontend_archs_train_with_generated_frontend_embeddings():
    """A decoder-only model behind a frontend and an encoder-decoder model
    take their stand-in embeddings from the step's generator: two steps
    each, finite losses, and the same losses run again."""
    for arch in ("internvl2-26b@smoke", "seamless-m4t-large-v2@smoke"):
        tc = TrainConfig(arch=arch, steps=2, seq_len=16, global_batch=2, log_every=0)
        a, b = train(tc, device="cpu"), train(tc, device="cpu")
        assert np.isfinite(a["losses"]).all() and a["losses"] == b["losses"], arch


# ------------------------------------------------------------------ the guard

@pytest.mark.parametrize("arch", list_archs())
def test_check_trainable_refuses_kernels_without_a_backward_on_the_card(arch):
    """Every kernel the forward launches has a backward on the card, so
    each architecture, whole and @smoke, passes the guard on "cuda" and on
    "cpu".  What the guard still refuses on "cuda" is a width the kernels
    do not take, with ``ValueError`` naming the limit: a copy with
    head_dim 256 (MLA: a 256-wide nope part) if it has attention, and a
    copy with d_state 32 if it has Mamba blocks; the CPU takes both."""
    for name in (arch, arch + "@smoke"):
        cfg = get_config(name)
        check_trainable(cfg, "cpu")
        check_trainable(cfg, "cuda")
        pattern = set(cfg.pattern())
        if "attn" in pattern or cfg.is_encdec:
            wide = (dataclasses.replace(cfg, mla=MLAConfig(qk_nope_head_dim=256))
                    if cfg.attention == "mla" else dataclasses.replace(cfg, head_dim=256))
            check_trainable(wide, "cpu")
            with pytest.raises(ValueError, match="128"):
                check_trainable(wide, "cuda")
        if "mamba" in pattern:
            wide = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm or SSMConfig(),
                                                                    d_state=32))
            check_trainable(wide, "cpu")
            with pytest.raises(ValueError, match="16"):
                check_trainable(wide, "cuda")


def test_build_state_and_make_step_call_the_guard(monkeypatch):
    """``build_state`` checks before building anything (a llama3-8b whose
    d_model override makes its heads 256 wide raises for the card before a
    model is built), and ``make_step`` checks the model it is given."""
    import repro_torch.launch.train as train_mod

    seen = []
    monkeypatch.setattr(train_mod, "resolve_device",
                        lambda device: seen.append(device) or torch.device("cuda"))
    monkeypatch.setattr(train_mod, "build_model", lambda *a, **k: pytest.fail("built"))
    with pytest.raises(ValueError, match="head width 256"):
        build_state(TrainConfig(arch="llama3-8b", n_layers=2, d_model=8192))
    assert seen == [None]
    cfg = get_config("jamba-1.5-large-398b@smoke")
    on_card = types.SimpleNamespace(
        cfg=dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm, d_state=32)),
        embed=types.SimpleNamespace(device=torch.device("cuda")))
    with pytest.raises(ValueError, match="SSM state width 32"):
        make_step(on_card, AdamWConfig())


def test_trainable_keeps_the_stacked_storage():
    """``Model.trainable`` turns gradients on in place: each period's
    parameter stays a view of its stacked tensor (no copy), and an update
    through one is seen through the stacked tensor."""
    from repro_torch.models.common import init_params
    from repro_torch.models.model import Model
    from repro_torch.models.transformer import decoder_defs

    cfg = get_config("xlstm-1.3b@smoke")
    tree = init_params(decoder_defs(cfg), torch.Generator().manual_seed(0))
    stacked = tree["blocks"]["b0_mlstm"]["mlstm"]["up"]
    model = Model(cfg, tree).trainable()
    p = dict(model.named_parameters())["blocks.0.b0_mlstm.mlstm.up"]
    assert p.requires_grad and p.data_ptr() == stacked.data_ptr()
    with torch.no_grad():
        p.add_(1.0)
    assert torch.equal(stacked[0], p.detach())
    _, _, params, opt = build_state(TrainConfig(arch="xlstm-1.3b@smoke"), device="cpu")
    assert all(t.requires_grad for t in params.values())
    assert sorted(opt) == ["m", "master", "step", "v"]
