"""The decoder stack's residual adds fused into its norms: per forward, the
first norm (on the embedding) runs alone and every other norm takes the
residual add before it, so a stack of L blocks with MLPs makes 1
``rmsnorm`` call and 2L ``add_rmsnorm`` calls.  On the CPU the fused path
gives the same bits as the add followed by the norm, and a block without
an MLP hands its update on to the next norm as the reference adds it."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro_torch.configs import get_config
from repro_torch.interop import model_params_from_numpy
from repro_torch.kernels.rmsnorm import ops, rmsnorm
from repro_torch.models import build_model, common

JAMBA_DENSE = dict(n_experts=0, experts_per_token=0)
MODELS = [("llama3-8b@smoke", {}), ("jamba-1.5-large-398b@smoke", JAMBA_DENSE)]
PROMPT = 9


def _model(arch, changes):
    return build_model(dataclasses.replace(get_config(arch), **changes), device="cpu", seed=3)


def _prefill(model):
    """One prefill of two seeded rows; returns its logits and the decode
    caches it fills."""
    tokens = torch.arange(4, 4 + 2 * PROMPT).reshape(2, PROMPT) % model.cfg.vocab
    logits, caches = model.forward_prefill(tokens)
    big = model.cache_struct(2, PROMPT + 2)
    for key, layer in caches.items():
        for name, t in layer.items():
            if name in ("k", "v"):
                big[key][name][:, :, :PROMPT] = t
            else:
                big[key][name].copy_(t)
    return logits, big


def _forwards(model):
    """One prefill and one decode forward; returns both logits."""
    logits, caches = _prefill(model)
    step, _ = model.forward_decode(logits.argmax(-1), caches, PROMPT)
    return logits, step


class _Counter:
    """Counts the norms of the stack: plain ``rmsnorm`` calls (inside
    ``add_rmsnorm`` when there is no delta) and ``add_rmsnorm`` calls with
    a delta."""

    def __init__(self, monkeypatch):
        self.plain = self.fused = 0
        norm, add = ops.rmsnorm, common.add_rmsnorm

        def counted_norm(*args, **kwargs):
            self.plain += 1
            return norm(*args, **kwargs)

        def counted_add(x, delta, gain, eps=1e-5):
            self.fused += delta is not None
            return add(x, delta, gain, eps)

        monkeypatch.setattr(ops, "rmsnorm", counted_norm)
        monkeypatch.setattr(common, "add_rmsnorm", counted_add)


@pytest.mark.parametrize("arch,changes", MODELS)
def test_one_plain_norm_and_two_fused_per_block_each_forward(monkeypatch, arch, changes):
    model = _model(arch, changes)
    L = model.cfg.n_layers
    counter = _Counter(monkeypatch)
    logits, caches = _prefill(model)
    assert (counter.plain, counter.fused) == (1, 2 * L)
    model.forward_decode(logits.argmax(-1), caches, PROMPT)
    assert (counter.plain, counter.fused) == (2, 4 * L)


def _unfused(x, delta, gain, eps=1e-5):
    s = x if delta is None else x + delta
    return s, rmsnorm(s, gain, eps)


@pytest.mark.parametrize("arch,changes", MODELS)
def test_fused_stack_gives_the_bits_of_the_add_then_the_norm_on_cpu(monkeypatch, arch, changes):
    model = _model(arch, changes)
    fused = _forwards(model)
    monkeypatch.setattr(common, "add_rmsnorm", _unfused)
    unfused = _forwards(model)
    for got, want in zip(fused, unfused):
        assert torch.equal(got, want)


def test_block_without_mlp_hands_its_update_to_the_next_norm(monkeypatch):
    """With ``d_ff = 0`` a block has one norm, and its mixer's output is
    added by the next block's norm (or the final one): L fused norms and
    one plain norm per forward, and the reference's logits."""
    arch, changes = "llama3-8b@smoke", dict(d_ff=0)
    cfg = dataclasses.replace(jax_get_config(arch), **changes)
    jm = jax_build_model(cfg)
    params = jm.init(jax.random.PRNGKey(0))
    tm = _model(arch, changes)
    tm.load_state_dict(model_params_from_numpy(jax.tree_util.tree_map(np.asarray, params), tm.cfg))
    prompt = np.random.default_rng(0).integers(0, cfg.vocab, size=(2, 12)).astype(np.int32)
    want, _ = jax.jit(jm.forward_prefill)(params, {"tokens": jnp.asarray(prompt)})
    counter = _Counter(monkeypatch)
    got, _ = tm.forward_prefill(torch.from_numpy(prompt).long())
    assert (counter.plain, counter.fused) == (1, cfg.n_layers)
    want = torch.from_numpy(np.array(want))
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * float(want.abs().max()))
