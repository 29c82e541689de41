"""The port's sharded MLA, encoder-decoder and frontend paths on four gloo
ranks on the CPU, against the reference's single-device outputs.

One spawned group of four ranks (``tests/torch_dist_mla_encdec_worker.py``,
under a 450 s limit that is also its process group's timeout, meeting through a
``FileStore`` in a temporary directory) runs every case on a (2, 2)
``("data", "model")`` mesh in fp32; this process computes the references
with JAX meanwhile and holds the ranks' results to them:

- the train bundle on minicpm3-4b@smoke (MLA), the same with 3 heads
  (which tp = 2 does not divide, so its attention is split over the keys
  across 'model', as the reference splits its score tensors),
  seamless-m4t-large-v2@smoke
  (an encoder over the frontend's frames, cross-attention in every
  decoder layer) and internvl2-26b@smoke (a decoder behind the frontend's
  tokens), two steps from the reference's parameters (remat "full") with
  seeded frontend embeddings: losses rel 1e-5 against the reference's
  ``jax.value_and_grad`` + AdamW and against the port's single-device
  ``make_step``; the first step's gradients within 2e-5 of each leaf's
  largest entry of the single device's; every parameter within 1e-4 of
  its leaf's largest entry plus 2% of the summed learning rate (Adam near
  its eps, as ``test_torch_distributed_blocks.py`` states it);
- the prefill and decode bundles on the same three models and on
  seamless with 15 frames, which tp = 2 splits 8 + 7 where GSPMD pads:
  logits and every cache (``c_kv``, ``k_rope``, the decoder's K/V,
  ``cross_kv``) within rtol 1e-4, atol 1e-4·max|reference|, greedy tokens
  equal.  The decode context is twice (prefill + 4) positions, so the
  caches' time axis splits over 'model' with the first four steps' slots
  on the first 'model' rank and the last four's on the second;
- each rank's local shapes of MLA's ``wq_up``, ``wk_up``, ``c_kv`` and
  ``k_rope``, of ``cross_kv["k"]`` (even and uneven frames) and of
  ``frontend_proj``, as the plan's specs give them.
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
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import init_opt_state as jax_init_opt_state
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, SyntheticLMStream
from repro_torch.interop import model_params_from_numpy
from repro_torch.launch.train import make_step
from repro_torch.models import build_model
from repro_torch.optim import AdamWConfig, cosine_lr, init_opt_state

ROOT = pathlib.Path(__file__).resolve().parents[1]
MLA, SEAMLESS, INTERNVL = ("minicpm3-4b@smoke", "seamless-m4t-large-v2@smoke",
                           "internvl2-26b@smoke")
UNEVEN = SEAMLESS + "/15-frames"
#: MLA whose 3 heads tp = 2 does not divide: attention split over the keys
KEY_SPLIT = MLA + "/3-heads"
#: each case: its arch and the overrides of both packages' configs
CASES = {MLA: (MLA, {}), SEAMLESS: (SEAMLESS, {}), INTERNVL: (INTERNVL, {}),
         UNEVEN: (SEAMLESS, {"frontend_tokens": 15}),
         KEY_SPLIT: (MLA, {"n_heads": 3, "n_kv_heads": 3})}
#: the parameters each case runs with: its arch's, or its own where its
#: overrides change their shapes
WEIGHTS = {c: c if c == KEY_SPLIT else arch for c, (arch, _) in CASES.items()}
TRAIN = [MLA, KEY_SPLIT, SEAMLESS, INTERNVL]
SERVE = [MLA, KEY_SPLIT, SEAMLESS, INTERNVL, UNEVEN]
OPT = dict(peak_lr=1e-3, warmup_steps=1, total_steps=10)
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 2, 4, 32
PROMPT_BATCH, PROMPT_LEN, DECODE_STEPS = 4, 12, 8
#: The ranks' limit and their process groups' timeout: at least three times
#: the fixture's wall under the suite's own load (``-n 6 --dist loadfile``,
#: 100-128 s), so a slow run finishes and a hang still fails.
LIMIT_S = 450


def _np_tree(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _configs(case):
    arch, overrides = CASES[case]
    return (dataclasses.replace(jax_get_config(arch), **overrides),
            dataclasses.replace(get_config(arch), **overrides))


def _filled(cfg) -> int:
    """The positions a prefill fills: a decoder-only model's frontend
    tokens come before the prompt."""
    return PROMPT_LEN + (cfg.frontend_tokens if cfg.frontend and not cfg.is_encdec else 0)


def _ctx(cfg) -> int:
    return 2 * (_filled(cfg) + DECODE_STEPS // 2)


def _frontend(rng, cfg, *lead):
    return rng.standard_normal((*lead, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Writes the inputs, runs the four ranks, and computes the
    single-device references meanwhile."""
    work = tmp_path_factory.mktemp("mla_encdec_ranks")
    models = {}
    for key in sorted(set(WEIGHTS.values())):
        jcfg, cfg = _configs(next(c for c, w in WEIGHTS.items() if w == key))
        jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
        models[key] = (jparams, model_params_from_numpy(_np_tree(jparams), cfg))
    rng = np.random.default_rng(32)
    inputs, batches, prompts = {}, {}, {}
    for case in TRAIN:
        _, cfg = _configs(case)
        stream = SyntheticLMStream(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                              global_batch=TRAIN_BATCH))
        batches[case] = [stream.batch_at(s) for s in range(TRAIN_STEPS)]
        if cfg.frontend is not None:
            frames = _frontend(rng, cfg, TRAIN_STEPS, TRAIN_BATCH)
            for s, b in enumerate(batches[case]):
                b["frontend"] = frames[s]
        for k in batches[case][0]:
            inputs[f"train_{k}/{case}"] = np.stack([b[k] for b in batches[case]])
    for case in SERVE:
        _, cfg = _configs(case)
        prompts[case] = {
            "tokens": rng.integers(4, cfg.vocab, size=(PROMPT_BATCH, PROMPT_LEN)).astype(np.int32)}
        if cfg.frontend is not None:
            prompts[case]["frontend"] = _frontend(rng, cfg, PROMPT_BATCH)
        for k, v in prompts[case].items():
            inputs[("prompt/" if k == "tokens" else "frontend/") + case] = v
    np.savez(work / "inputs.npz",
             **{f"param/{arch}/{n}": t.numpy() for arch, (_, state) in models.items()
                for n, t in state.items()}, **inputs)
    (work / "meta.json").write_text(json.dumps({
        "names": {arch: list(m[1]) for arch, m in models.items()}, "opt": OPT,
        "cases": CASES, "weights": WEIGHTS, "train": TRAIN, "serve": SERVE,
        "decode_steps": DECODE_STEPS,
        "filled": {c: _filled(_configs(c)[1]) for c in SERVE},
        "ctx": {c: _ctx(_configs(c)[1]) for c in SERVE}, "limit_s": LIMIT_S}))

    started = time.monotonic()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    ranks = subprocess.Popen([sys.executable, str(ROOT / "tests" / "torch_dist_mla_encdec_worker.py"),
                              str(work)], env=env, cwd=ROOT, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True, start_new_session=True)
    threads = torch.get_num_threads()
    try:
        torch.set_num_threads(1)    # smoke-size ops; the ranks have the cores
        ref = {}
        for case in TRAIN:
            ref[case] = _train_references(case, *models[WEIGHTS[case]], batches[case])
        for case in SERVE:
            ref.setdefault(case, {}).update(
                _serve_references(case, models[WEIGHTS[case]][0], prompts[case]))
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
    return got, ref, {arch: m[1] for arch, m in models.items()}


def _train_references(case, jparams, state, batches) -> dict:
    """The reference's single-device training steps, and the port's
    ``make_step`` from the same parameters."""
    jcfg, cfg = _configs(case)
    ref = {}
    jopt = JaxAdamWConfig(**OPT)
    jstep = jax_make_step(jax_build_model(jcfg), jopt)
    jp = jax.tree_util.tree_map(jnp.copy, jparams)    # the step donates its arguments
    js = jax_init_opt_state(jopt, jp)
    ref["loss"] = []
    for b in batches:
        jp, js, m = jstep(jp, js, {k: jnp.asarray(v) for k, v in b.items()})
        ref["loss"].append(float(m["loss"]))
    ref["params"] = model_params_from_numpy(_np_tree(jp), cfg)

    def port_batch(b):
        return {k: torch.from_numpy(v) if k == "frontend" else torch.from_numpy(v).long()
                for k, v in b.items()}

    tm = build_model(cfg, device="cpu", seed=1)
    tm.load_state_dict(state)
    tm.trainable()
    params = dict(tm.named_parameters())
    opt = init_opt_state(AdamWConfig(**OPT), params)
    step = make_step(tm, AdamWConfig(**OPT))
    ref["port_loss"] = []
    for b in batches:
        params, opt, m = step(params, opt, port_batch(b))
        ref["port_loss"].append(float(m["loss"]))
    ref["port_params"] = {n: p.detach().clone() for n, p in params.items()}
    tm.load_state_dict(state)
    loss, _ = tm.loss_fn(port_batch(batches[0]))
    loss.backward()
    ref["port_grad0"] = {n: p.grad.clone() for n, p in tm.named_parameters()}
    return ref


def _serve_references(case, jparams, prompt) -> dict:
    """The reference's prefill, then greedy decode against the prompt's
    caches: the sequence caches padded to the decode context, ``cross_kv``
    as the prefill left it."""
    jcfg, cfg = _configs(case)
    jm = jax_build_model(jcfg)
    ref = {}
    filled = _filled(cfg)
    logits, caches = jm.forward_prefill(jparams, {k: jnp.asarray(v) for k, v in prompt.items()})
    ref["prefill_logits"] = np.asarray(logits)
    ref["prefill_caches"] = _np_tree(caches)
    full = _np_tree(jm.cache_struct(PROMPT_BATCH, _ctx(cfg), abstract=False, dtype=jnp.float32))
    for key, per in ref["prefill_caches"].items():
        for n, t in per.items():
            if key == "cross_kv":
                full[key][n] = t
            else:
                full[key][n][:, :, :filled] = t
    decode = jax.jit(jm.forward_decode)
    caches = jax.tree_util.tree_map(jnp.asarray, full)
    token = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    ref["tokens"], steps = [], []
    for i in range(DECODE_STEPS):
        ref["tokens"].append(np.asarray(token))
        logits, caches = decode(jparams, token, caches, jnp.asarray(filled + i, jnp.int32))
        steps.append(np.asarray(logits))
        token = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    ref["decode_logits"] = np.stack(steps)
    ref["decode_caches"] = _np_tree(caches)
    return ref


def _close(got, want, rtol=0.0, atol_rel=1e-4, msg=""):
    want = np.asarray(want, dtype=np.float32)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=atol_rel * float(np.abs(want).max()), err_msg=msg)


# ---------------------------------------------------------------------- train


@pytest.mark.parametrize("case", TRAIN)
@pytest.mark.parametrize("against", ["reference", "make_step"])
def test_sharded_train_losses(run, case, against):
    got, ref, _ = run
    want = ref[case]["loss"] if against == "reference" else ref[case]["port_loss"]
    np.testing.assert_allclose(got[f"{case}/train_loss"], want, rtol=1e-5)


@pytest.mark.parametrize("case", TRAIN)
def test_sharded_train_gradients_agree_to_rounding(run, case):
    """The first step's gradients, as the update receives them (reduced
    over the shards), within 2e-5 of each leaf's largest entry of the
    single-device gradients: the encoder's and the cross sub-blocks'
    stacked leaves and ``frontend_proj`` included."""
    got, ref, _ = run
    for name, g in ref[case]["port_grad0"].items():
        _close(got[f"{case}/train_grad0/{name}"], g.numpy(), atol_rel=2e-5, msg=name)


@pytest.mark.parametrize("case", TRAIN)
@pytest.mark.parametrize("against", ["reference", "make_step"])
def test_sharded_train_parameters(run, case, against):
    """Every parameter within 1e-4 of its leaf's largest entry, plus 2% of
    the two steps' summed learning rate (Adam near its eps, as in
    ``test_torch_distributed_blocks.py``)."""
    got, ref, states = run
    want_all = ref[case]["params"] if against == "reference" else ref[case]["port_params"]
    lr_sum = sum(float(cosine_lr(AdamWConfig(**OPT), torch.tensor(s)))
                 for s in range(1, TRAIN_STEPS + 1))
    moved = 0.0
    for name, w in want_all.items():
        w = w.numpy() if torch.is_tensor(w) else np.asarray(w)
        np.testing.assert_allclose(got[f"{case}/train_param/{name}"], w, rtol=0.0,
                                   atol=1e-4 * float(np.abs(w).max()) + 0.02 * lr_sum,
                                   err_msg=name)
        moved = max(moved, float(np.abs(w - states[WEIGHTS[case]][name].numpy()).max()))
    assert moved > 0.5 * lr_sum    # the steps moved the weights past the tolerance


@pytest.mark.parametrize("case", TRAIN)
def test_sharded_optimizer_step_alone(run, case):
    """Each step's sharded AdamW update equals ``adamw_update`` run on one
    device on that step's gathered parameters, gradients and optimizer
    state, within 1e-6 of each leaf's largest entry: the update alone,
    whatever its gradients' rounding (``chip_smoke.optimizer_steps_replayed``)."""
    got, _, _ = run
    steps = got[f"{case}/adamw_replay_err"]
    assert len(steps) == TRAIN_STEPS
    for errs in steps:
        worst = max(errs, key=errs.get)
        assert errs[worst] <= 1e-6, (worst, errs[worst])


# -------------------------------------------------------------------- serving


@pytest.mark.parametrize("case", SERVE)
def test_sharded_prefill_matches_reference(run, case):
    got, ref, _ = run
    ref = ref[case]
    _close(got[f"{case}/prefill_logits"], ref["prefill_logits"], rtol=1e-4, msg="logits")
    for key, per in ref["prefill_caches"].items():
        for n, t in per.items():
            _close(got[f"{case}/prefill_cache/{key}/{n}"], t, rtol=1e-4, msg=f"{key}/{n}")


@pytest.mark.parametrize("case", SERVE)
def test_sharded_decode_matches_reference(run, case):
    got, ref, _ = run
    ref = ref[case]
    _close(got[f"{case}/decode_logits"], ref["decode_logits"], rtol=1e-4, msg="logits")
    for key, per in ref["decode_caches"].items():
        for n, t in per.items():
            _close(got[f"{case}/decode_cache/{key}/{n}"], t, rtol=1e-4, msg=f"{key}/{n}")


@pytest.mark.parametrize("case", SERVE)
def test_sharded_greedy_tokens_equal_the_reference(run, case):
    got, ref, _ = run
    for i, want in enumerate(ref[case]["tokens"]):
        np.testing.assert_array_equal(got[f"{case}/decode_token/{i}"], want, err_msg=str(i))


@pytest.mark.parametrize("case", SERVE)
def test_decode_writes_land_on_both_model_ranks(run, case):
    """The self-attention caches' time axis is split over 'model' in two
    halves of ``ctx / 2`` positions, and the eight decode steps wrote
    their slots into both: positions ``filled`` ... ``filled + 7`` are
    non-zero and straddle the halves, every later position is still
    zero."""
    got, _, _ = run
    _, cfg = _configs(case)
    filled, ctx = _filled(cfg), _ctx(cfg)
    half = ctx // 2
    assert filled < half < filled + DECODE_STEPS
    names = ("c_kv", "k_rope") if cfg.attention == "mla" else ("k", "v")
    for n in names:
        shape, placements = got[f"{case}/cache_local"][f"b0_attn/{n}"]
        assert shape[2] == half and placements == ["S(1)", "S(2)"], (n, shape, placements)
        cache = got[f"{case}/decode_cache/b0_attn/{n}"]
        written = np.abs(cache[:, :, filled:filled + DECODE_STEPS]).reshape(
            *cache.shape[:2], DECODE_STEPS, -1).max(axis=-1)
        assert (written > 0).all(), n
        assert not cache[:, :, filled + DECODE_STEPS:].any(), n


@pytest.mark.parametrize("case", [MLA, KEY_SPLIT])
def test_mla_attention_splits_the_keys_where_the_heads_do_not_divide(run, case):
    """MLA's train and prefill steps split the attention over the keys
    across 'model' (mesh dim 1) where tp = 2 does not divide the heads
    (3), every layer and the remat's recompute; with 4 heads they keep the
    head shard and split nothing."""
    got, _, _ = run
    split = case == KEY_SPLIT
    layers = get_config(MLA).n_layers
    assert got[f"{case}/prefill_key_shard_calls"] == ([[1]] * layers if split else [])
    train = got[f"{case}/train_key_shard_calls"]
    assert (len(train) >= 2 * TRAIN_STEPS * layers and set(map(tuple, train)) == {(1,)}
            if split else train == [])


# ------------------------------------------------------------ local placements


@pytest.mark.parametrize("leaf", ["wq_up", "wk_up"])
def test_mla_up_projections_split_on_head_boundaries(run, leaf):
    """minicpm3@smoke's up-projections (rank, H·w) keep the rank axis
    whole and split the heads' columns over 'model' (4 heads, 2 a rank),
    after the steps as before them."""
    got, _, _ = run
    cfg = get_config(MLA)
    m = cfg.mla
    width = {"wq_up": m.qk_nope_head_dim + m.qk_rope_head_dim, "wk_up": m.qk_nope_head_dim}[leaf]
    rank = {"wq_up": m.q_lora_rank, "wk_up": m.kv_lora_rank}[leaf]
    want = [[rank, cfg.n_heads // 2 * width], ["R", "S(1)"]]
    assert got[f"{MLA}/param_local"][f"blocks.0.attn.{leaf}"] == want
    assert got[f"{MLA}/serve_param_local"][f"blocks.0.attn.{leaf}"] == want


@pytest.mark.parametrize("leaf", ["c_kv", "k_rope"])
def test_compressed_cache_splits_time_over_model(run, leaf):
    """The compressed cache (P, B, T, r): batch over 'data', time over
    'model', the latent whole."""
    got, _, _ = run
    cfg = get_config(MLA)
    width = {"c_kv": cfg.mla.kv_lora_rank, "k_rope": cfg.mla.qk_rope_head_dim}[leaf]
    assert got[f"{MLA}/cache_local"][f"b0_attn/{leaf}"] == [
        [cfg.n_periods(), PROMPT_BATCH // 2, _ctx(cfg) // 2, width], ["S(1)", "S(2)"]]


@pytest.mark.parametrize("case, frames", [(SEAMLESS, 8), (UNEVEN, 8)])
def test_cross_kv_splits_the_frames_over_model(run, case, frames):
    """``cross_kv["k"]`` (P, B, F, KV, hd) splits its frames over 'model'
    by the decode shape's ``cache_t``: 16 frames 8 + 8; 15 frames 8 on
    the first 'model' rank (rank 0's shard)."""
    got, _, _ = run
    cfg = get_config(SEAMLESS)
    assert got[f"{case}/cache_local"]["cross_kv/k"] == [
        [cfg.n_periods(), PROMPT_BATCH // 2, frames, cfg.n_kv_heads, cfg.head_dim],
        ["S(1)", "S(2)"]]


def test_frontend_projection_is_split_over_data(run):
    """``frontend_proj`` ("embed_w", None): its input axis over 'data'
    (FSDP), replicated over 'model'."""
    got, _, _ = run
    d = get_config(INTERNVL).d_model
    assert got[f"{INTERNVL}/param_local"]["frontend_proj"] == [[d // 2, d], ["S(0)", "R"]]
