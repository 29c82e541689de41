"""The port's sharded MoE, Mamba and xLSTM paths on four gloo ranks on the
CPU, against the reference's single-device outputs.

One spawned group of four ranks (``tests/torch_dist_blocks_worker.py``,
under a 450 s limit that is also its process group's timeout, meeting through a
``FileStore`` in a temporary directory) runs every case on a (2, 2)
``("data", "model")`` mesh in fp32; this process computes the references
with JAX meanwhile and holds the ranks' results to them:

- ``moe_ffn`` on the inputs of the reference's expert-parallel test
  (olmoe-1b-7b@smoke, ``capacity_factor=8.0``, x (2, 16, d) from
  ``PRNGKey(1)``) under EP, under expert-TP (``ep=False``) and under EP
  with one dispatch group (``moe_groups=1``), which the two 'data' ranks
  split unevenly as GSPMD pads: y within 1e-5 of the largest entry, aux
  rel 1e-5;
- the train bundle on jamba-1.5-large-398b@smoke (Mamba, attention and
  MoE under EP), xlstm-1.3b@smoke and mixtral-8x7b@smoke with ``ep=False``
  (expert-TP), two steps from the reference's parameters
  (remat "full"): the first step's gradients within 2e-5 of each leaf's
  largest entry of the single device's; losses rel 1e-5 and every
  parameter within 1e-4 of its leaf's largest entry plus 2% of the summed
  learning rate (Adam near its eps, see the test), against the
  reference's ``jax.value_and_grad`` + AdamW and against the port's
  single-device ``make_step``;
- the prefill and decode bundles on the same two models and on
  mixtral-8x7b@smoke with ``ep=False``: logits and caches or states
  within rtol 1e-4, atol 1e-4·max|reference|, greedy tokens equal;
- each rank's local shapes of the expert weights (E/2 under EP, ff/2
  under expert-TP) and of Mamba's ``in_proj``, ``conv_w`` and decode
  state, as the plan's specs give them.
"""
import dataclasses
import json
import os
import pathlib
import signal
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.launch.train import make_step as jax_make_step
from repro.models import build_model as jax_build_model
from repro.models.common import init_params as jax_init_params
from repro.models.moe import moe_defs as jax_moe_defs
from repro.models.moe import moe_ffn as jax_moe_ffn
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import init_opt_state as jax_init_opt_state
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, SyntheticLMStream
from repro_torch.interop import model_params_from_numpy
from repro_torch.launch.train import make_step
from repro_torch.models import build_model
from repro_torch.models.ssm import mlstm_inner_dim
from repro_torch.optim import AdamWConfig, cosine_lr, init_opt_state

ROOT = pathlib.Path(__file__).resolve().parents[1]
MOE_ARCH, MOE_CF = "olmoe-1b-7b@smoke", 8.0
#: moe_ffn's layouts on the ranks and their dispatch groups (None: the
#: config's); one group is split unevenly over the two 'data' ranks
MOE_LAYOUTS = {"ep": None, "expert_tp": None, "ep_one_group": 1}
#: trained and served archs and their plan's ``ep`` (None: by divisibility,
#: EP here; False: expert-TP)
TRAIN = {"jamba-1.5-large-398b@smoke": None, "xlstm-1.3b@smoke": None,
         "mixtral-8x7b@smoke": False}
SERVE = {"jamba-1.5-large-398b@smoke": None, "xlstm-1.3b@smoke": None,
         "mixtral-8x7b@smoke": False}
OPT = dict(peak_lr=1e-3, warmup_steps=1, total_steps=10)
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 2, 4, 32
PROMPT_BATCH, PROMPT_LEN, CTX, DECODE_STEPS = 4, 16, 32, 8
#: The ranks' limit and their process groups' timeout: at least three times
#: the fixture's wall under the suite's own load (``-n 6 --dist loadfile``,
#: 136-146 s), so a slow run finishes and a hang still fails.
LIMIT_S = 450


def _np_tree(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _reference_model(arch):
    jm = jax_build_model(jax_get_config(arch))
    jparams = jm.init(jax.random.PRNGKey(0))
    return jm, jparams, model_params_from_numpy(_np_tree(jparams), get_config(arch))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Writes the inputs, runs the four ranks, and computes the
    single-device references meanwhile."""
    work = tmp_path_factory.mktemp("block_ranks")
    models = {arch: _reference_model(arch) for arch in sorted(set(TRAIN) | set(SERVE))}
    batches = {}
    for arch in TRAIN:
        stream = SyntheticLMStream(DataConfig(vocab=get_config(arch).vocab, seq_len=TRAIN_SEQ,
                                              global_batch=TRAIN_BATCH))
        batches[arch] = [stream.batch_at(s) for s in range(TRAIN_STEPS)]
    rng = np.random.default_rng(31)
    prompts = {arch: rng.integers(4, get_config(arch).vocab, size=(PROMPT_BATCH, PROMPT_LEN)
                                  ).astype(np.int32) for arch in SERVE}
    jcfg = dataclasses.replace(jax_get_config(MOE_ARCH), capacity_factor=MOE_CF)
    moe_p = jax.tree_util.tree_map(lambda a: a[0], jax_init_params(
        {"moe": jax_moe_defs(jcfg, 1)}, jax.random.PRNGKey(0))["moe"])
    moe_x = jax.random.normal(jax.random.PRNGKey(1), (2, 16, jcfg.d_model))
    np.savez(work / "inputs.npz",
             **{f"param/{arch}/{n}": t.numpy() for arch, (_, _, state) in models.items()
                for n, t in state.items()},
             **{"prompt/" + arch: p for arch, p in prompts.items()},
             **{f"train_tokens/{a}": np.stack([b["tokens"] for b in bs]) for a, bs in batches.items()},
             **{f"train_labels/{a}": np.stack([b["labels"] for b in bs]) for a, bs in batches.items()},
             **{"moe_" + n: np.asarray(v) for n, v in moe_p.items()}, moe_x=np.asarray(moe_x))
    (work / "meta.json").write_text(json.dumps({
        "names": {arch: list(m[2]) for arch, m in models.items()}, "opt": OPT,
        "train": TRAIN, "serve": SERVE, "ctx": CTX, "decode_steps": DECODE_STEPS,
        "moe_arch": MOE_ARCH, "moe_capacity_factor": MOE_CF, "limit_s": LIMIT_S}))

    started = time.monotonic()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    ranks = subprocess.Popen([sys.executable, str(ROOT / "tests" / "torch_dist_blocks_worker.py"),
                              str(work)], env=env, cwd=ROOT, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True, start_new_session=True)
    threads = torch.get_num_threads()
    try:
        torch.set_num_threads(1)    # smoke-size ops; the ranks have the cores
        ref = {}
        for layout, groups in MOE_LAYOUTS.items():
            y, aux = jax_moe_ffn(moe_p, moe_x, dataclasses.replace(jcfg, moe_groups=groups)
                                 if groups else jcfg)
            ref[f"moe/{layout}"] = (np.asarray(y), {k: float(v) for k, v in aux.items()})
        for arch in TRAIN:
            ref[arch] = _train_references(arch, *models[arch], batches[arch])
        for arch in SERVE:
            ref.setdefault(arch, {}).update(
                _serve_references(*models[arch][:2], prompts[arch]))
        torch.set_num_threads(threads)
        try:
            log, _ = ranks.communicate(timeout=max(1.0, LIMIT_S - (time.monotonic() - started)))
        except subprocess.TimeoutExpired:
            os.killpg(ranks.pid, signal.SIGKILL)
            log, _ = ranks.communicate()
            pytest.fail(f"the ranks did not finish within {LIMIT_S} s:\n{log[-4000:]}")
    finally:
        torch.set_num_threads(threads)
        if ranks.poll() is None:
            os.killpg(ranks.pid, signal.SIGKILL)
    assert ranks.returncode == 0, log[-6000:]
    got = dict(np.load(work / "results.npz"))
    got.update(json.loads((work / "results.json").read_text()))
    return got, ref, {arch: m[2] for arch, m in models.items()}


def _train_references(arch, jm, jparams, state, batches) -> dict:
    """The reference's single-device training steps, and the port's
    ``make_step`` from the same parameters."""
    ref = {}
    jopt = JaxAdamWConfig(**OPT)
    jstep = jax_make_step(jm, jopt)
    jp = jax.tree_util.tree_map(jnp.copy, jparams)    # the step donates its arguments
    js = jax_init_opt_state(jopt, jp)
    ref["loss"] = []
    for b in batches:
        jp, js, m = jstep(jp, js, {k: jnp.asarray(v) for k, v in b.items()})
        ref["loss"].append(float(m["loss"]))
    cfg = get_config(arch)
    ref["params"] = model_params_from_numpy(_np_tree(jp), cfg)
    tm = build_model(cfg, device="cpu", seed=1)
    tm.load_state_dict(state)
    tm.trainable()
    params = dict(tm.named_parameters())
    opt = init_opt_state(AdamWConfig(**OPT), params)
    step = make_step(tm, AdamWConfig(**OPT))
    ref["port_loss"] = []
    for b in batches:
        params, opt, m = step(params, opt, {k: torch.from_numpy(v).long() for k, v in b.items()})
        ref["port_loss"].append(float(m["loss"]))
    ref["port_params"] = {n: p.detach().clone() for n, p in params.items()}
    tm.load_state_dict(state)
    loss, _ = tm.loss_fn({k: torch.from_numpy(v).long() for k, v in batches[0].items()})
    loss.backward()
    ref["port_grad0"] = {n: p.grad.clone() for n, p in tm.named_parameters()}
    return ref


def _serve_references(jm, jparams, prompt) -> dict:
    """The reference's prefill, then greedy decode against the prompt's
    caches: attention K/V padded to ``CTX`` positions, recurrent states
    as the prefill left them."""
    ref = {}
    B, S = prompt.shape
    logits, caches = jm.forward_prefill(jparams, {"tokens": jnp.asarray(prompt)})
    ref["prefill_logits"] = np.asarray(logits)
    ref["prefill_caches"] = _np_tree(caches)
    full = _np_tree(jm.cache_struct(B, CTX, abstract=False, dtype=jnp.float32))
    for key, per in ref["prefill_caches"].items():
        for n, t in per.items():
            if n in ("k", "v"):
                full[key][n][:, :, :S] = t
            else:
                full[key][n] = t
    decode = jax.jit(jm.forward_decode)
    caches = jax.tree_util.tree_map(jnp.asarray, full)
    token = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    ref["tokens"], steps = [], []
    for i in range(DECODE_STEPS):
        ref["tokens"].append(np.asarray(token))
        logits, caches = decode(jparams, token, caches, jnp.asarray(S + i, jnp.int32))
        steps.append(np.asarray(logits))
        token = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    ref["decode_logits"] = np.stack(steps)
    ref["decode_caches"] = _np_tree(caches)
    return ref


def _close(got, want, rtol=0.0, atol_rel=1e-4, msg=""):
    want = np.asarray(want, dtype=np.float32)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=atol_rel * float(np.abs(want).max()), err_msg=msg)


# ------------------------------------------------------------------------ MoE


@pytest.mark.parametrize("layout", list(MOE_LAYOUTS))
def test_sharded_moe_matches_reference(run, layout):
    got, ref, _ = run
    y, aux = ref[f"moe/{layout}"]
    _close(got[f"moe/{layout}/y"], y, atol_rel=1e-5)
    for k, want in aux.items():
        assert got[f"moe/{layout}/aux"][k] == pytest.approx(want, rel=1e-5), k


@pytest.mark.parametrize("layout", ["ep", "expert_tp"])
def test_sharded_moe_splits_the_expert_weights(run, layout):
    """Each rank holds half the experts under EP, half of every expert's
    ff under expert-TP; the d axis is split over 'data' (FSDP)."""
    got, _, _ = run
    cfg = get_config(MOE_ARCH)
    E, d, ff = cfg.n_experts, cfg.d_model, cfg.expert_ff
    want = [E // 2, d // 2, ff] if layout == "ep" else [E, d // 2, ff // 2]
    assert got[f"moe/{layout}/w1_local"] == want


# ---------------------------------------------------------------------- train


@pytest.mark.parametrize("arch", list(TRAIN))
@pytest.mark.parametrize("against", ["reference", "make_step"])
def test_sharded_train_losses(run, arch, against):
    got, ref, _ = run
    want = ref[arch]["loss"] if against == "reference" else ref[arch]["port_loss"]
    np.testing.assert_allclose(got[f"{arch}/train_loss"], want, rtol=1e-5)


@pytest.mark.parametrize("arch", list(TRAIN))
def test_sharded_train_gradients_agree_to_rounding(run, arch):
    """The first step's gradients, as the update receives them (reduced
    over the shards), within 2e-5 of each leaf's largest entry of the
    single-device gradients."""
    got, ref, _ = run
    for name, g in ref[arch]["port_grad0"].items():
        _close(got[f"{arch}/train_grad0/{name}"], g.numpy(), atol_rel=2e-5, msg=name)


@pytest.mark.parametrize("arch", list(TRAIN))
@pytest.mark.parametrize("against", ["reference", "make_step"])
def test_sharded_train_parameters(run, arch, against):
    """Every parameter within 1e-4 of its leaf's largest entry, plus 2% of
    the two steps' summed learning rate: where an entry's gradient sits
    at Adam's eps (1e-8) or below, the first steps divide it by its own
    size, so gradients equal to rounding (the test above) move it by
    different shares of a step (up to 0.13 of a step, measured on these
    models), as ``test_torch_train.py`` holds the single device to the
    reference."""
    got, ref, states = run
    want_all = ref[arch]["params"] if against == "reference" else ref[arch]["port_params"]
    lr_sum = sum(float(cosine_lr(AdamWConfig(**OPT), torch.tensor(s)))
                 for s in range(1, TRAIN_STEPS + 1))
    moved = 0.0
    for name, w in want_all.items():
        w = w.numpy() if torch.is_tensor(w) else np.asarray(w)
        np.testing.assert_allclose(got[f"{arch}/train_param/{name}"], w, rtol=0.0,
                                   atol=1e-4 * float(np.abs(w).max()) + 0.02 * lr_sum,
                                   err_msg=name)
        moved = max(moved, float(np.abs(w - states[arch][name].numpy()).max()))
    assert moved > 0.5 * lr_sum    # the steps moved the weights past the tolerance


@pytest.mark.parametrize("arch", TRAIN)
def test_sharded_optimizer_step_alone(run, arch):
    """Each step's sharded AdamW update equals ``adamw_update`` run on one
    device on that step's gathered parameters, gradients and optimizer
    state, within 1e-6 of each leaf's largest entry: the update alone,
    whatever its gradients' rounding (``chip_smoke.optimizer_steps_replayed``)."""
    got, _, _ = run
    steps = got[f"{arch}/adamw_replay_err"]
    assert len(steps) == TRAIN_STEPS
    for errs in steps:
        worst = max(errs, key=errs.get)
        assert errs[worst] <= 1e-6, (worst, errs[worst])


# -------------------------------------------------------------------- serving


@pytest.mark.parametrize("arch", list(SERVE))
def test_sharded_prefill_matches_reference(run, arch):
    got, ref, _ = run
    ref = ref[arch]
    _close(got[f"{arch}/prefill_logits"], ref["prefill_logits"], rtol=1e-4, msg="logits")
    for key, per in ref["prefill_caches"].items():
        for n, t in per.items():
            _close(got[f"{arch}/prefill_cache/{key}/{n}"], t, rtol=1e-4, msg=f"{key}/{n}")


@pytest.mark.parametrize("arch", list(SERVE))
def test_sharded_decode_matches_reference(run, arch):
    got, ref, _ = run
    ref = ref[arch]
    _close(got[f"{arch}/decode_logits"], ref["decode_logits"], rtol=1e-4, msg="logits")
    for key, per in ref["decode_caches"].items():
        for n, t in per.items():
            _close(got[f"{arch}/decode_cache/{key}/{n}"], t, rtol=1e-4, msg=f"{key}/{n}")


@pytest.mark.parametrize("arch", list(SERVE))
def test_sharded_greedy_tokens_equal_the_reference(run, arch):
    got, ref, _ = run
    for i, want in enumerate(ref[arch]["tokens"]):
        np.testing.assert_array_equal(got[f"{arch}/decode_token/{i}"], want, err_msg=str(i))


# ------------------------------------------------------------ local placements


def test_mamba_local_shapes_follow_the_specs(run):
    """jamba@smoke's Mamba leaves on one rank: ``in_proj`` (d/2, 2·di/2)
    (FSDP over 'data', inner over 'model'), ``conv_w`` (d_conv, di/2),
    and the decode state ``h`` (P, B/2, di/2, N) and ``conv`` (P, B/2,
    d_conv-1, di/2) as the cache specs lay them out."""
    got, _, _ = run
    arch = "jamba-1.5-large-398b@smoke"
    cfg = get_config(arch)
    d, s = cfg.d_model, cfg.ssm
    di = s.expand * d
    params = got[f"{arch}/param_local"]
    assert params["blocks.0.b0_mamba.mamba.in_proj"] == [[d // 2, di], ["S(0)", "S(1)"]]
    assert params["blocks.0.b0_mamba.mamba.conv_w"] == [[s.d_conv, di // 2], ["R", "S(1)"]]
    caches = got[f"{arch}/cache_local"]
    P, B = cfg.n_periods(), PROMPT_BATCH
    assert caches["b0_mamba/h"] == [[P, B // 2, di // 2, s.d_state], ["S(1)", "S(2)"]]
    assert caches["b0_mamba/conv"] == [[P, B // 2, s.d_conv - 1, di // 2], ["S(1)", "S(3)"]]


@pytest.mark.parametrize("arch, layout", [("jamba-1.5-large-398b@smoke", "ep"),
                                          ("mixtral-8x7b@smoke", "expert_tp")])
def test_bundle_expert_weights_follow_the_plan(run, arch, layout):
    got, _, _ = run
    cfg = get_config(arch)
    E, d, ff = cfg.n_experts, cfg.d_model, cfg.expert_ff
    key = "blocks.0.b1_attn.moe.w2" if arch.startswith("jamba") else "blocks.0.moe.w2"
    want = ([[E // 2, ff, d // 2], ["S(2)", "S(0)"]] if layout == "ep"
            else [[E, ff // 2, d // 2], ["S(2)", "S(1)"]])
    assert got[f"{arch}/serve_param_local"][key] == want


@pytest.mark.parametrize("leaf", ["w1", "w2"])
def test_trained_expert_tp_weights_split_the_ff_axis(run, leaf):
    """mixtral@smoke's train bundle under ``ep=False``: each rank holds all
    E experts, half of every expert's ff (over 'model') and half of d
    (over 'data'), and its parameters stay so after the steps."""
    got, _, _ = run
    cfg = get_config("mixtral-8x7b@smoke")
    E, d, ff = cfg.n_experts, cfg.d_model, cfg.expert_ff
    want = {"w1": [[E, d // 2, ff // 2], ["S(1)", "S(2)"]],
            "w2": [[E, ff // 2, d // 2], ["S(2)", "S(1)"]]}[leaf]
    assert got["mixtral-8x7b@smoke/param_local"][f"blocks.0.moe.{leaf}"] == want


def test_xlstm_local_shapes_follow_the_specs(run):
    """xlstm@smoke's heads split over 'model' (2 heads, tp 2): ``wq`` (1,
    dh, dh) and the mLSTM state ``C`` (P, B/2, 1, dh, dh); the gate maps
    (di, H) keep 'model' on the inner axis, which the rules name for both
    of their dims."""
    got, _, _ = run
    arch = "xlstm-1.3b@smoke"
    cfg = get_config(arch)
    di = mlstm_inner_dim(cfg)
    dh = di // cfg.n_heads
    params = got[f"{arch}/param_local"]
    assert params["blocks.0.b0_mlstm.mlstm.wq"] == [[1, dh, dh], ["R", "S(0)"]]
    assert params["blocks.0.b0_mlstm.mlstm.w_i"] == [[di // 2, cfg.n_heads], ["R", "S(0)"]]
    caches = got[f"{arch}/cache_local"]
    assert caches["b0_mlstm/C"] == [[cfg.n_periods(), PROMPT_BATCH // 2, 1, dh, dh],
                                    ["S(1)", "S(2)"]]
