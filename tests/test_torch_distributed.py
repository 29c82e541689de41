"""The port's multi-device stack on four gloo ranks on the CPU, against the
reference's single-device outputs and its own sharded decode.

One spawned group of four ranks (``tests/torch_dist_worker.py``, under a
400 s limit that is also its process group's timeout, meeting through a
``FileStore`` in a temporary directory) runs every case; this process
computes the references with JAX and holds the ranks' results to them:

- the (2, 2) ``("data", "model")`` train bundle on llama3-8b@smoke in
  fp32, two steps from the reference's parameters (remat "full"): losses
  rel 1e-5 and every parameter within 1e-4 of its leaf's largest entry,
  against the reference's ``jax.value_and_grad(loss_fn)`` + AdamW and
  against the port's single-device ``make_step``;
- the prefill and decode bundles on the same model and on
  h2o-danube-3-4b@smoke, whose 32-token window the decode steps wrap
  (sequence-parallel prefill, the decode cache's time axis split over
  'model'): logits and caches within rtol 1e-4, atol 1e-4·max|reference|,
  greedy tokens equal;
- ``gqa_decode_seqsharded`` on a (4, 1) mesh: within 1e-5 of the largest
  entry of the reference's ``gqa_decode`` and of its own
  ``gqa_decode_seqsharded`` under ``shard_map`` (run in a subprocess with
  four forced host devices, as the reference's passing test runs it);
- ``topk_allreduce`` and ``compressed_mean_tree`` on four ranks: rel 1e-6
  of the mean of each worker's payload decompressed through the
  reference's ``topk_compress``;
- a tuple spec entry's layout on a (2, 2, 1) pod/data/model mesh equal to
  JAX's, and the scan and norm kernels on local shards equal to the whole
  calls;
- the vocabulary-parallel loss (the vocabulary over 'model' 2 on the (2, 2)
  mesh and 4 on a (1, 4) mesh of the same ranks) on llama3-8b@smoke, with
  its own and with a padded vocabulary, and seamless-m4t-large-v2@smoke:
  the loss and every gradient against the same step with the vocabulary
  gathered whole and against the reference's single-device ``loss_fn``.
"""
import json
import os
import pathlib
import signal
import subprocess
import sys
import textwrap
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.launch.train import make_step as jax_make_step
from repro.models import build_model as jax_build_model
from repro.models.attention import gqa_decode as jax_gqa_decode
from repro.models.attention import gqa_defs as jax_gqa_defs
from repro.models.common import init_params as jax_init_params
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import init_opt_state as jax_init_opt_state
from repro.optim.compression import TopKConfig as JaxTopKConfig
from repro.optim.compression import topk_compress as jax_topk_compress
from repro.optim.compression import topk_decompress as jax_topk_decompress
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, SyntheticLMStream
from repro_torch.interop import model_params_from_numpy
from repro_torch.launch.train import make_step
from repro_torch.models import build_model
from repro_torch.optim import AdamWConfig, init_opt_state

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH = "llama3-8b@smoke"
#: served archs and their decode caches' length: h2o-danube's 32-token
#: window makes its cache a circular buffer that the decode steps wrap
SERVE = {"llama3-8b@smoke": 32, "h2o-danube-3-4b@smoke": 36}
PROMPT_LEN = {"llama3-8b@smoke": 16, "h2o-danube-3-4b@smoke": 28}
OPT = dict(peak_lr=1e-3, warmup_steps=1, total_steps=10)
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 2, 4, 32
PROMPT_BATCH, DECODE_STEPS = 4, 8
SQ_B, SQ_T, SQ_POS = 2, 64, 37
TOPK_DENSITY = 0.1
#: The vocabulary-parallel loss's cases: (arch, the vocabulary cut to, None
#: the config's own).  llama3-8b@smoke's 256 tokens cut to 250 pad the
#: table by 6 rows, which the head masks, on the last 'model' rank.
VOCAB_CASES = {"llama3-8b": ("llama3-8b@smoke", None),
               "llama3-8b/padded": ("llama3-8b@smoke", 250),
               "seamless": ("seamless-m4t-large-v2@smoke", None)}
#: (data, model) meshes of the four ranks: the vocabulary over 2 and 4 ranks
VOCAB_MESHES = {"tp2": (2, 2), "tp4": (1, 4)}
VOCAB_BATCH, VOCAB_SEQ = 4, 16
VOCAB_LOSS_RTOL = 1e-6
#: gradients' gates, of each leaf's largest entry: the split loss against
#: the gathered one in the same sharded step (measured up to 4.7e-7), and
#: against the reference's single device, which the gathered loss itself
#: misses at 1e-6 (1.3e-6 to 2.2e-6: the sharded matmuls' fp32 rounding)
VOCAB_GRAD_ATOL_REL = {"gathered": 1e-6, "reference": 1e-5}
#: The ranks' limit and their process groups' timeout: at least three times
#: the fixture's wall under the suite's own load (``-n 6 --dist loadfile``:
#: 45-89 s before the vocabulary-loss cases, 61 s alone with them), so a
#: slow run finishes and a hang still fails.
LIMIT_S = 400

_SHARD_MAP_REFERENCE = """
import json, sys
from functools import partial
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax.experimental.shard_map import shard_map
from repro.configs import get_config
from repro.models.attention import gqa_decode_seqsharded

d = np.load(sys.argv[1])
cfg = get_config(sys.argv[2])
devs = np.array(jax.devices()[:4])
mesh = Mesh(devs.reshape(4, 1), ("data", "model"))
p = {w: jnp.asarray(d["sq_" + w]) for w in ("wq", "wk", "wv", "wo")}
cache = {n: jnp.asarray(d["sq_" + n]) for n in "kv"}

@partial(shard_map, mesh=mesh,
         in_specs=(P(), P(None, None, None), {"k": P(None, "data", None, None),
                                              "v": P(None, "data", None, None)}, P()),
         out_specs=P(None, None, None), check_rep=False)
def sharded(p, x, cache, pos):
    out, _ = gqa_decode_seqsharded(p, x, cfg, cache, pos, axis_name="data")
    return out

out = sharded(p, jnp.asarray(d["sq_x"]), cache, jnp.asarray(int(sys.argv[3]), jnp.int32))
np.save(sys.argv[4], np.asarray(out))
mesh3 = Mesh(devs.reshape(2, 2, 1), ("pod", "data", "model"))
index = NamedSharding(mesh3, P(("pod", "data"), None)).devices_indices_map((8, 3))
print(json.dumps([list(range(8))[index[dev][0]] for dev in devs]))
"""


def _np_tree(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _start_ranks(workdir: pathlib.Path) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    return subprocess.Popen([sys.executable, str(ROOT / "tests" / "torch_dist_worker.py"),
                             str(workdir)], env=env, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, start_new_session=True)


def _wait_ranks(proc: subprocess.Popen, started: float) -> None:
    """Waits for the ranks until ``LIMIT_S`` after ``started``, then ends
    them all (their session) and fails."""
    try:
        log, _ = proc.communicate(timeout=max(1.0, LIMIT_S - (time.monotonic() - started)))
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        log, _ = proc.communicate()
        pytest.fail(f"the ranks did not finish within {LIMIT_S} s:\n{log[-4000:]}")
    assert proc.returncode == 0, log[-6000:]


def _reference_model(arch):
    """The reference model of ``arch`` with its seed-0 parameters, and them
    as the port's state dict."""
    jm = jax_build_model(jax_get_config(arch))
    jparams = jm.init(jax.random.PRNGKey(0))
    return jm, jparams, model_params_from_numpy(_np_tree(jparams), get_config(arch))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Writes the inputs, starts the JAX shard_map reference, runs the four
    ranks, and computes the single-device references meanwhile."""
    work = tmp_path_factory.mktemp("ranks")
    models = {arch: _reference_model(arch) for arch in SERVE}
    vocab_models = {arch: models.get(arch) or _reference_model(arch)
                    for arch, _ in VOCAB_CASES.values()}
    cfg = get_config(ARCH)
    stream = SyntheticLMStream(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                          global_batch=TRAIN_BATCH))
    batches = [stream.batch_at(s) for s in range(TRAIN_STEPS)]
    rng = np.random.default_rng(11)
    prompts = {arch: rng.integers(4, get_config(arch).vocab, size=(PROMPT_BATCH, PROMPT_LEN[arch])
                                  ).astype(np.int32) for arch in SERVE}

    jcfg = jax_get_config(ARCH)
    attn = jax.tree_util.tree_map(lambda a: a[0], jax_init_params(
        {"a": jax_gqa_defs(jcfg, 1)}, jax.random.PRNGKey(5))["a"])
    kv_shape = (SQ_B, SQ_T, cfg.n_kv_heads, cfg.head_dim)
    sq = {"sq_" + w: np.asarray(attn[w]) for w in ("wq", "wk", "wv", "wo")}
    sq["sq_k"] = rng.standard_normal(kv_shape).astype(np.float32)
    sq["sq_v"] = rng.standard_normal(kv_shape).astype(np.float32)
    sq["sq_x"] = (0.3 * rng.standard_normal((SQ_B, 1, cfg.d_model))).astype(np.float32)
    cmp = {"cmp_g": rng.standard_normal((4, 64, 32)).astype(np.float32),
           "cmp_h": rng.standard_normal((4, 100)).astype(np.float32)}
    vocab_batches = {case: _vocab_batch(case, rng) for case in VOCAB_CASES}
    np.savez(work / "inputs.npz",
             **{f"param/{arch}/{n}": t.numpy()
                for arch, (_, _, state) in {**models, **vocab_models}.items()
                for n, t in state.items()},
             **{f"vocab/{case}/{k}": v for case, b in vocab_batches.items()
                for k, v in b.items()},
             **{"prompt/" + arch: p for arch, p in prompts.items()},
             train_tokens=np.stack([b["tokens"] for b in batches]),
             train_labels=np.stack([b["labels"] for b in batches]), **sq, **cmp)
    (work / "meta.json").write_text(json.dumps({
        "arch": ARCH, "names": {arch: list(m[2]) for arch, m in {**models, **vocab_models}.items()},
        "opt": OPT, "serve": SERVE, "decode_steps": DECODE_STEPS, "sq_pos": SQ_POS,
        "topk_density": TOPK_DENSITY, "limit_s": LIMIT_S, "vocab_cases": VOCAB_CASES,
        "vocab_meshes": VOCAB_MESHES,
        "vocab_batch_keys": {case: sorted(b) for case, b in vocab_batches.items()}}))

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    shard_map_ref = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_SHARD_MAP_REFERENCE), str(work / "inputs.npz"),
         ARCH, str(SQ_POS), str(work / "shard_map_out.npy")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    started = time.monotonic()
    ranks = _start_ranks(work)
    threads = torch.get_num_threads()
    try:
        torch.set_num_threads(1)    # smoke-size ops; the ranks have the cores
        ref = _train_references(*models[ARCH], batches)
        for arch, (jm, jparams, _) in models.items():
            ref[arch] = _serve_references(jm, jparams, prompts[arch], SERVE[arch])
        ref.update(_collective_references(jcfg, attn, sq, cmp))
        for case, (arch, vocab) in VOCAB_CASES.items():
            ref["vocab/" + case] = _loss_reference(vocab_models[arch][1], arch, vocab,
                                                   vocab_batches[case])
        torch.set_num_threads(threads)
        _wait_ranks(ranks, started)
        out, err = shard_map_ref.communicate(timeout=LIMIT_S)
    finally:
        torch.set_num_threads(threads)
        for proc in (ranks, shard_map_ref):
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL) if proc is ranks else proc.kill()
    assert shard_map_ref.returncode == 0, err[-4000:]
    ref["shard_map_out"] = np.load(work / "shard_map_out.npy")
    ref["jax_layout"] = json.loads(out.strip().splitlines()[-1])
    got = dict(np.load(work / "results.npz"))
    got.update(json.loads((work / "results.json").read_text()))
    return got, ref, models[ARCH][2]


def _vocab_batch(case, rng) -> dict:
    """A seeded batch of a vocabulary-loss case: tokens and labels under its
    vocabulary, and an encoder-decoder model's frames."""
    arch, vocab = VOCAB_CASES[case]
    cfg = get_config(arch)
    shape = (VOCAB_BATCH, VOCAB_SEQ)
    out = {k: rng.integers(0, vocab or cfg.vocab, size=shape).astype(np.int32)
           for k in ("tokens", "labels")}
    if cfg.frontend is not None:
        out["frontend"] = (0.02 * rng.standard_normal(
            (VOCAB_BATCH, cfg.frontend_tokens, cfg.d_model))).astype(np.float32)
    return out


def _loss_reference(jparams, arch, vocab, batch) -> dict:
    """The reference's single-device loss and gradients of ``batch``, the
    gradients by the port's parameter names."""
    import dataclasses

    jcfg = jax_get_config(arch)
    if vocab is not None:
        jcfg = dataclasses.replace(jcfg, vocab=vocab)
    jm = jax_build_model(jcfg)
    (loss, _), grads = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    return {"loss": float(loss),
            "grads": model_params_from_numpy(_np_tree(grads), get_config(arch))}


def _train_references(jm, jparams, state, batches) -> dict:
    """The reference's single-device training steps, and the port's
    ``make_step`` from the same parameters."""
    ref = {}
    jopt = JaxAdamWConfig(**OPT)
    jstep = jax_make_step(jm, jopt)
    # the step donates its arguments: step copies, keeping jparams
    jp = jax.tree_util.tree_map(jnp.copy, jparams)
    js = jax_init_opt_state(jopt, jp)
    ref["loss"] = []
    for b in batches:
        jp, js, m = jstep(jp, js, {k: jnp.asarray(v) for k, v in b.items()})
        ref["loss"].append(float(m["loss"]))
    cfg = get_config(ARCH)
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
    return ref


def _serve_references(jm, jparams, prompt, ctx) -> dict:
    """The reference's prefill, then greedy decode against the prompt's
    caches padded to ``ctx`` positions."""
    ref = {}
    B, S = prompt.shape
    logits, caches = jm.forward_prefill(jparams, {"tokens": jnp.asarray(prompt)})
    ref["prefill_logits"] = np.asarray(logits)
    ref["prefill_caches"] = _np_tree(caches)
    full = _np_tree(jm.cache_struct(B, ctx, abstract=False, dtype=jnp.float32))
    for key, per in ref["prefill_caches"].items():
        for n, t in per.items():
            full[key][n][:, :, :S] = t
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


def _collective_references(jcfg, attn, sq, cmp) -> dict:
    """The reference's dense decode on the sequence-sharded case's inputs,
    and each worker's top-k payload through the reference, averaged."""
    ref = {}
    cache = {n: jnp.asarray(sq["sq_" + n]) for n in "kv"}
    out, new = jax_gqa_decode(attn, jnp.asarray(sq["sq_x"]), jcfg, cache,
                              jnp.asarray(SQ_POS, jnp.int32))
    ref["seqsharded_out"] = np.asarray(out)
    ref["seqsharded_cache"] = _np_tree(new)
    tcfg = JaxTopKConfig(density=TOPK_DENSITY)

    def mean_of(g):
        parts, errs = [], []
        for w in range(4):
            payload, err = jax_topk_compress(jnp.asarray(g[w]), jnp.zeros(g[w].shape), tcfg)
            parts.append(np.asarray(jax_topk_decompress(payload, g[w].shape)))
            errs.append(np.asarray(err))
        return np.mean(parts, axis=0), np.stack(errs)

    ref["topk_mean"], ref["topk_err"] = mean_of(cmp["cmp_g"])
    ref["tree_c"], _ = mean_of(cmp["cmp_h"])
    return ref


def _close(got, want, rtol=0.0, atol_rel=1e-4, msg=""):
    want = np.asarray(want, dtype=np.float32)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=atol_rel * float(np.abs(want).max()), err_msg=msg)


# ---------------------------------------------------------------------- train


@pytest.mark.parametrize("against", ["reference", "make_step"])
def test_sharded_train_losses(run, against):
    got, ref, _ = run
    want = ref["loss"] if against == "reference" else ref["port_loss"]
    np.testing.assert_allclose(got["train_loss"], want, rtol=1e-5)


@pytest.mark.parametrize("against", ["reference", "make_step"])
def test_sharded_train_parameters(run, against, request):
    got, ref, state = run
    want = ref["params"] if against == "reference" else ref["port_params"]
    moved = 0.0
    for name, w in want.items():
        w = w.numpy() if torch.is_tensor(w) else np.asarray(w)
        _close(got["train_param/" + name], w, msg=name)
        moved = max(moved, float(np.abs(w - state[name].numpy()).max()))
    assert moved > 1e-4    # two steps moved the weights past the tolerance


def test_sharded_train_keeps_the_plan_placements(run):
    """The parameters after the steps keep the plan's placements on the
    (data, model) mesh: wq's (d, H·hd) FSDP over data and heads over model,
    the embedding's vocab over model and d over data, the gains' d over
    data."""
    got, _, _ = run
    pl = got["train_placements"]
    assert pl["blocks.0.attn.wq"] == ["S(0)", "S(1)"]
    assert pl["blocks.0.attn.wo"] == ["S(1)", "S(0)"]
    assert pl["embed"] == ["S(1)", "S(0)"]
    assert pl["final_norm"] == ["S(0)", "R"]


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
    # the caches' time axis was split over 'model', the batch over 'data'
    assert got[f"{arch}/cache_placements"]["b0_attn/k"] == ["S(1)", "S(2)"]


@pytest.mark.parametrize("arch", list(SERVE))
def test_sharded_greedy_tokens_equal_the_reference(run, arch):
    got, ref, _ = run
    for i, want in enumerate(ref[arch]["tokens"]):
        np.testing.assert_array_equal(got[f"{arch}/decode_token/{i}"], want, err_msg=str(i))


# -------------------------------------------------- sequence-sharded decode


@pytest.mark.parametrize("against", ["gqa_decode", "shard_map"])
def test_seqsharded_decode(run, against):
    got, ref, _ = run
    want = ref["seqsharded_out"] if against == "gqa_decode" else ref["shard_map_out"]
    _close(got["seqsharded_out"], want, atol_rel=1e-5)


def test_seqsharded_decode_writes_the_new_token_on_its_owner(run):
    """The gathered cache is the reference's updated one: slot 37 written
    (on rank 2, which holds 32..47), every other slot untouched."""
    got, ref, _ = run
    for n in "kv":
        _close(got["seqsharded_cache_" + n], ref["seqsharded_cache"][n], atol_rel=1e-5, msg=n)


# ---------------------------------------------------------------- compression


def test_topk_allreduce_is_the_mean_of_decompressed_payloads(run):
    got, ref, _ = run
    np.testing.assert_allclose(got["topk_mean"], ref["topk_mean"], rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(got["topk_err"], ref["topk_err"])


def test_compressed_mean_tree(run):
    got, ref, _ = run
    np.testing.assert_allclose(got["tree_a"], ref["topk_mean"], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got["tree_c"], ref["tree_c"], rtol=1e-6, atol=1e-7)


# ------------------------------------------------- vocabulary-parallel loss


def _vocab_run(got, case, mesh, kind):
    key = f"vocab/{case}/{mesh}/{kind}"
    names = [k[len(key) + 6:] for k in got if k.startswith(key + "/grad/")]
    return float(got[key + "/loss"]), {n: got[f"{key}/grad/{n}"] for n in names}


@pytest.mark.parametrize("against", ["gathered", "reference"])
@pytest.mark.parametrize("mesh", list(VOCAB_MESHES))
@pytest.mark.parametrize("case", list(VOCAB_CASES))
def test_vocab_parallel_loss_and_gradients(run, case, mesh, against):
    """The train bundle's loss with the vocabulary split over 'model' (2 or
    4 ranks; each rank reduces its own columns) and every parameter's
    gradient against the same bundle's loss with the vocabulary gathered
    whole, and against the reference's single-device ``loss_fn``: loss rel
    1e-6, each gradient within 1e-6 (gathered) or 1e-5 (reference) of its
    leaf's largest entry."""
    got, ref, _ = run
    loss, grads = _vocab_run(got, case, mesh, "split")
    if against == "gathered":
        want_loss, want = _vocab_run(got, case, mesh, "gathered")
    else:
        want_loss = ref["vocab/" + case]["loss"]
        want = {n: g.numpy() for n, g in ref["vocab/" + case]["grads"].items()}
    assert loss == pytest.approx(want_loss, rel=VOCAB_LOSS_RTOL)
    assert sorted(grads) == sorted(want)
    for name, w in want.items():
        _close(grads[name], w, atol_rel=VOCAB_GRAD_ATOL_REL[against], msg=name)


@pytest.mark.parametrize("mesh", list(VOCAB_MESHES))
@pytest.mark.parametrize("case", list(VOCAB_CASES))
def test_vocab_parallel_loss_runs_where_the_vocabulary_splits(run, case, mesh):
    """One vocabulary-parallel cross-entropy a step where 'model' splits
    the vocabulary, none on the gathered path."""
    got, _, _ = run
    assert int(got[f"vocab/{case}/{mesh}/split/calls"]) == 1
    assert int(got[f"vocab/{case}/{mesh}/gathered/calls"]) == 0


# ------------------------------------------------------------- layout, kernels


def test_tuple_entry_layout_equals_jax(run):
    got, ref, _ = run
    assert got["layout_rows"] == ref["jax_layout"]


@pytest.mark.parametrize("case", ["scan/channels", "scan/batch", "norm/rows"])
def test_kernels_on_local_shards_equal_the_whole_call(run, case):
    got, _, _ = run
    assert got["local_kernel_err"][case] < 1e-5, got["local_kernel_err"]
