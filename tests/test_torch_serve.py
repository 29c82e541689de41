"""The port's batched server against the reference server on the same
weights and the same requests: greedy tokens equal for every request, and
the same number of decode steps.

Greedy decoding compares argmaxes, so a near tie in the logits could let
float rounding decide the token.  The test records the gap between the
largest and second-largest logit at every token the port picks and holds
its smallest value above the logit tolerance of ``test_torch_models.py``
(atol 1e-4·max|logits|): the tokens are decided by the model, not by
rounding."""
import jax
import numpy as np
import torch

from repro.launch.serve import BatchedServer as JaxServer
from repro.launch.serve import Request as JaxRequest
from repro_torch.interop import model_params_from_numpy
from repro_torch.launch.serve import BatchedServer, Request

ARCH = "llama3-8b@smoke"
ATOL_REL = 1e-4


def _requests(vocab):
    rng = np.random.default_rng(7)
    lengths = [9, 17, 5, 17, 30, 9]          # six prompts, four lengths
    max_new = [6, 3, 8, 5, 4, 7]
    return [(rid, rng.integers(4, vocab, size=n).astype(np.int32), m)
            for rid, (n, m) in enumerate(zip(lengths, max_new))]


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


def test_servers_give_equal_greedy_tokens():
    ref = JaxServer(ARCH, batch_slots=4, max_ctx=64, seed=0)
    port = BatchedServer(ARCH, batch_slots=4, max_ctx=64, device="cpu", seed=1)
    port.model.load_state_dict(model_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, ref.params), port.cfg))
    gaps, scale = [], []
    _record_gaps(port, gaps, scale)
    for rid, prompt, max_new in _requests(port.cfg.vocab):
        ref.submit(JaxRequest(rid, prompt, max_new))
        port.submit(Request(rid, prompt, max_new))
    ref.drain()
    port.drain()

    assert port.decode_steps == ref.decode_steps
    want = {r.rid: r.tokens_out for r in ref.completed}
    got = {r.rid: r.tokens_out for r in port.completed}
    assert got == want
    assert all(len(got[rid]) == m for rid, _, m in _requests(port.cfg.vocab))
    assert min(gaps) > ATOL_REL * max(scale), (min(gaps), max(scale))


def test_context_limit_completes_requests_as_the_reference_does():
    """A request also completes when its position reaches max_ctx - 1."""
    ref = JaxServer(ARCH, batch_slots=2, max_ctx=24, seed=0)
    port = BatchedServer(ARCH, batch_slots=2, max_ctx=24, device="cpu")
    port.model.load_state_dict(model_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, ref.params), port.cfg))
    prompt = np.arange(4, 24, dtype=np.int32)             # 20 tokens
    for server, R in ((ref, JaxRequest), (port, Request)):
        server.submit(R(0, prompt, 50))
        server.submit(R(1, prompt[:6], 3))
        server.drain()
    assert port.decode_steps == ref.decode_steps
    assert {r.rid: r.tokens_out for r in port.completed} == {
        r.rid: r.tokens_out for r in ref.completed}
    assert len(next(r for r in port.completed if r.rid == 0).tokens_out) < 50


def test_servers_give_equal_greedy_tokens_on_the_dense_hybrid(monkeypatch):
    """jamba@smoke with dense MLPs (Mamba and attention blocks): the port
    serves the replaced config directly; the reference server resolves its
    arch name through its module's ``get_config``, patched here to return
    the same replaced config."""
    import dataclasses

    import repro.launch.serve as jax_serve
    from repro.configs import get_config as jax_get_config
    from repro_torch.configs import get_config

    arch, changes = "jamba-1.5-large-398b@smoke", dict(n_experts=0, experts_per_token=0)
    jcfg = dataclasses.replace(jax_get_config(arch), **changes)
    monkeypatch.setattr(jax_serve, "get_config", lambda name: jcfg)
    ref = JaxServer(arch, batch_slots=4, max_ctx=64, seed=0)
    port = BatchedServer(dataclasses.replace(get_config(arch), **changes), batch_slots=4,
                         max_ctx=64, device="cpu", seed=1)
    assert repr(port.cfg) == repr(ref.cfg)
    port.model.load_state_dict(model_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, ref.params), port.cfg))
    gaps, scale = [], []
    _record_gaps(port, gaps, scale)
    for rid, prompt, max_new in _requests(port.cfg.vocab):
        ref.submit(JaxRequest(rid, prompt, max_new))
        port.submit(Request(rid, prompt, max_new))
    ref.drain()
    port.drain()

    assert port.decode_steps == ref.decode_steps
    want = {r.rid: r.tokens_out for r in ref.completed}
    got = {r.rid: r.tokens_out for r in port.completed}
    assert got == want
    assert all(len(got[rid]) == m for rid, _, m in _requests(port.cfg.vocab))
    assert min(gaps) > ATOL_REL * max(scale), (min(gaps), max(scale))
