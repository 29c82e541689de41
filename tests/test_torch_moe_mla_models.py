"""MoE and MLA models of the port against the reference's on the same
weights: olmoe (64 experts in full, 8 at smoke size), mixtral (GQA with a
sliding window and 8 experts top-2), minicpm3 (multi-head latent
attention) and jamba with its experts (Mamba and attention blocks, MoE
on every second layer).  The reference ``Model.init`` tree goes through
numpy and ``model_params_from_numpy`` into the port.

Tolerance on logits and caches: rtol 1e-4, atol 1e-4·max|x|, as in
``test_torch_models.py``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.launch.serve import BatchedServer as JaxServer
from repro.launch.serve import Request as JaxRequest
from repro.models import build_model as jax_build_model
from repro_torch.configs import get_config
from repro_torch.interop import model_params_from_numpy
from repro_torch.launch.serve import SEQUENCE_CACHES, BatchedServer, Request
from repro_torch.models import build_model, transformer
from repro_torch.models.common import count_params
from repro_torch.models.transformer import decoder_defs

ARCHS = ["olmoe-1b-7b@smoke", "mixtral-8x7b@smoke", "minicpm3-4b@smoke",
         "jamba-1.5-large-398b@smoke"]
RTOL, ATOL_REL = 1e-4, 1e-4
DECODE_STEPS = 4


def _close(got: torch.Tensor, want, what: str) -> None:
    want = torch.from_numpy(np.array(want))
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL_REL * float(want.abs().max()),
                               msg=lambda m: f"{what}: {m}")


def _pair(arch):
    jm = jax_build_model(jax_get_config(arch))
    params = jm.init(jax.random.PRNGKey(0))
    tm = build_model(get_config(arch), device="cpu", seed=1)
    tm.load_state_dict(model_params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                                               tm.cfg))
    return jm, params, tm


@pytest.mark.parametrize("arch", ARCHS)
def test_parameter_counts_and_names_match(arch):
    jm = jax_build_model(jax_get_config(arch))
    tm = build_model(get_config(arch), device="cpu")
    assert tm.n_params() == jm.n_params()
    assert sum(p.numel() for p in tm.parameters()) == jm.n_params()
    params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(3)))
    sd = model_params_from_numpy(params, tm.cfg)
    assert set(sd) == set(tm.state_dict())
    for name, t in tm.state_dict().items():
        assert tuple(sd[name].shape) == tuple(t.shape), name


@pytest.mark.parametrize("arch,cut", [("olmoe-1b-7b", None), ("mixtral-8x7b", None),
                                      ("minicpm3-4b", None), ("mixtral-8x7b", 8),
                                      ("jamba-1.5-large-398b", None)])
def test_full_configs_count_as_in_the_reference(arch, cut):
    """The served configurations' parameter trees, counted without
    building: olmoe and minicpm3 whole, mixtral whole and as its 8-layer
    cut, jamba with its experts."""
    changes = {} if cut is None else dict(n_layers=cut)
    tcfg = dataclasses.replace(get_config(arch), **changes)
    jcfg = dataclasses.replace(jax_get_config(arch), **changes)
    assert count_params(decoder_defs(tcfg)) == jax_build_model(jcfg).n_params()


def test_served_cuts_have_the_stated_sizes():
    """The sizes PERF.md states for the three served models."""
    olmoe, minicpm = get_config("olmoe-1b-7b"), get_config("minicpm3-4b")
    mixtral8 = dataclasses.replace(get_config("mixtral-8x7b"), n_layers=8)
    assert count_params(decoder_defs(olmoe)) == 6_919_096_320
    assert count_params(decoder_defs(mixtral8)) == 11_872_309_248
    assert count_params(decoder_defs(minicpm)) == 4_262_025_728


@pytest.mark.parametrize("arch,S", [(a, 12) for a in ARCHS] + [("mixtral-8x7b@smoke", 40),
                                                              ("olmoe-1b-7b@smoke", 33)])
def test_prefill_and_decode_match_reference(arch, S):
    """Logits and every cache over a prefill and 4 decode steps.  S = 40
    runs mixtral@smoke's 32-token window; S = 33 gives olmoe two dispatch
    groups of 33 tokens (16 halves to 2 before it divides 66), with
    capacity drops."""
    jm, params, tm = _pair(arch)
    cfg = tm.cfg
    rng = np.random.default_rng(S)
    prompt = rng.integers(0, cfg.vocab, size=(2, S)).astype(np.int32)

    jl, jc = jax.jit(jm.forward_prefill)(params, {"tokens": jnp.asarray(prompt)})
    tl, tc = tm.forward_prefill(torch.from_numpy(prompt).long())
    assert tl.shape == (2, 1, cfg.padded_vocab)
    _close(tl, jl, "prefill logits")
    assert sorted(tc) == sorted(jc)
    for key in tc:
        assert sorted(tc[key]) == sorted(jc[key])
        for name in tc[key]:
            _close(tc[key][name], jc[key][name], f"prefill {key} {name}")

    ctx = 64
    jbig = jm.cache_struct(2, ctx, abstract=False, dtype=jnp.float32)
    tbig = tm.cache_struct(2, ctx)
    for key in tc:
        for name in tc[key]:
            assert tuple(tbig[key][name].shape) == jbig[key][name].shape, (key, name)
            if name in SEQUENCE_CACHES:
                T = tc[key][name].shape[2]
                jbig[key][name] = jbig[key][name].at[:, :, :T].set(jc[key][name])
                tbig[key][name][:, :, :T] = tc[key][name]
            else:
                jbig[key][name] = jc[key][name]
                tbig[key][name].copy_(tc[key][name])
    jdecode = jax.jit(jm.forward_decode)
    for step in range(DECODE_STEPS):
        token = rng.integers(0, cfg.vocab, size=(2, 1)).astype(np.int32)
        pos = S + step
        jl, jbig = jdecode(params, jnp.asarray(token), jbig, jnp.asarray(pos, jnp.int32))
        tl, tbig = tm.forward_decode(torch.from_numpy(token).long(), tbig, pos)
        _close(tl, jl, f"decode step {step} logits")
    for key in tbig:
        for name in tbig[key]:
            _close(tbig[key][name], jbig[key][name], f"decode {key} {name}")


@pytest.mark.parametrize("arch", ["olmoe-1b-7b@smoke", "jamba-1.5-large-398b@smoke"])
def test_prefill_aux_matches_the_reference_forward(arch, monkeypatch):
    """The MoE aux values of the port's layers in a prefill, each layer's
    ``moe_ffn`` asked for them and their sum taken over the stack, equal
    the reference's ``forward_train`` aux on the same tokens (both
    packages' serving drops them; both run the same blocks)."""
    jm, params, tm = _pair(arch)
    prompt = np.random.default_rng(5).integers(0, tm.cfg.vocab, size=(2, 20)).astype(np.int32)
    _, jaux = jax.jit(jm.forward_train)(params, {"tokens": jnp.asarray(prompt)})
    aux = {}
    inner = transformer.moe_ffn

    def summed(p, x, cfg, need_aux=True):
        y, layer_aux = inner(p, x, cfg)
        for k, v in layer_aux.items():
            aux[k] = aux.get(k, 0.0) + float(v)
        return y, layer_aux if need_aux else None

    monkeypatch.setattr(transformer, "moe_ffn", summed)
    tm.forward_prefill(torch.from_numpy(prompt).long())
    assert sorted(aux) == sorted(jaux) == ["dropped_frac", "lb_loss", "z_loss"]
    for k, v in jaux.items():
        assert float(aux[k]) == pytest.approx(float(v), rel=1e-5), k


def _served_pair(arch):
    ref = JaxServer(arch, batch_slots=4, max_ctx=64, seed=0)
    port = BatchedServer(arch, batch_slots=4, max_ctx=64, device="cpu", seed=1)
    port.model.load_state_dict(model_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, ref.params), port.cfg))
    return ref, port


def _record_gaps(server, gaps, scale):
    """Wrap the port model's forward passes to record, for every row the
    server reads, the top-1 minus top-2 logit gap and the largest |logit|."""
    model = server.model
    prefill, decode = model.forward_prefill, model.forward_decode

    def record(logits, rows):
        top2 = torch.topk(logits[rows, -1, :], 2, dim=-1).values
        gaps.extend((top2[:, 0] - top2[:, 1]).tolist())
        scale.append(float(logits[rows].abs().max()))

    def prefill_and_record(tokens):
        logits, caches = prefill(tokens)
        record(logits, [0])
        return logits, caches

    def decode_and_record(token, caches, pos):
        active = [i for i, r in enumerate(server.slots) if r is not None]
        logits, caches = decode(token, caches, pos)
        record(logits, active)
        return logits, caches

    model.forward_prefill = prefill_and_record
    model.forward_decode = decode_and_record


@pytest.mark.parametrize("arch", ["minicpm3-4b@smoke", "olmoe-1b-7b@smoke"])
def test_servers_give_equal_greedy_tokens(arch):
    """Six requests through both servers: greedy tokens and decode steps
    equal, every token decided by a logit gap above the logit tolerance.
    The MLA server inserts each prefill's ``c_kv`` and ``k_rope`` into its
    slot padded along the sequence axis, as the reference does."""
    ref, port = _served_pair(arch)
    gaps, scale = [], []
    _record_gaps(port, gaps, scale)
    rng = np.random.default_rng(7)
    lengths, max_new = [9, 17, 5, 17, 30, 9], [6, 3, 8, 5, 4, 7]
    for rid, (n, m) in enumerate(zip(lengths, max_new)):
        prompt = rng.integers(4, port.cfg.vocab, size=n).astype(np.int32)
        ref.submit(JaxRequest(rid, prompt, m))
        port.submit(Request(rid, prompt, m))
    ref.drain()
    port.drain()
    assert port.decode_steps == ref.decode_steps
    assert {r.rid: r.tokens_out for r in port.completed} == {
        r.rid: r.tokens_out for r in ref.completed}
    assert min(gaps) > ATOL_REL * max(scale), (min(gaps), max(scale))
    for key, layer in port.caches.items():
        for name, t in layer.items():
            _close(t, ref.caches[key][name], f"server cache {key} {name}")
