"""The port's models against the reference package's on the same weights:
the reference ``Model.init`` tree goes through numpy and
``model_params_from_numpy`` into the port's state dict, and both run the
same seeded prompt.

Tolerance on logits and caches: rtol 1e-4, atol 1e-4·max|x|.  The port's
prefill core is the flash op's plain version (one fused softmax over the
whole row) where the reference runs its einsum core, and matrix products
sum in other orders: float32 rounding, compounded over two layers and a
few decode steps."""
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
from repro_torch.models import build_model

ARCHS = ["llama3-8b@smoke", "stablelm-1.6b@smoke", "h2o-danube-3-4b@smoke"]
RTOL, ATOL_REL = 1e-4, 1e-4
DECODE_STEPS = 4


def _close(got: torch.Tensor, want, what: str) -> None:
    want = torch.from_numpy(np.array(want))
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL_REL * float(want.abs().max()),
                               msg=lambda m: f"{what}: {m}")


def _pair(arch, **changes):
    jm = jax_build_model(dataclasses.replace(jax_get_config(arch), **changes))
    params = jm.init(jax.random.PRNGKey(0))
    tm = build_model(dataclasses.replace(get_config(arch), **changes), device="cpu", seed=1)
    tm.load_state_dict(model_params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                                               tm.cfg))
    return jm, params, tm


@pytest.mark.parametrize("arch", ARCHS)
def test_parameter_counts_match(arch):
    jm = jax_build_model(jax_get_config(arch))
    tm = build_model(get_config(arch), device="cpu")
    assert tm.n_params() == jm.n_params()
    assert sum(p.numel() for p in tm.parameters()) == jm.n_params()


@pytest.mark.parametrize("arch,S", [(a, 12) for a in ARCHS] + [("h2o-danube-3-4b@smoke", 40)])
def test_prefill_and_decode_match_reference(arch, S):
    """S = 40 runs h2o-danube's 32-token window through the windowed prefill,
    the cache cut to the window and the circular decode buffer."""
    jm, params, tm = _pair(arch)
    cfg = tm.cfg
    rng = np.random.default_rng(S)
    prompt = rng.integers(0, cfg.vocab, size=(2, S)).astype(np.int32)

    jl, jc = jax.jit(jm.forward_prefill)(params, {"tokens": jnp.asarray(prompt)})
    tl, tc = tm.forward_prefill(torch.from_numpy(prompt).long())
    assert tl.shape == (2, 1, cfg.padded_vocab)
    _close(tl, jl, "prefill logits")
    for name in ("k", "v"):
        _close(tc["b0_attn"][name], jc["b0_attn"][name], f"prefill cache {name}")

    # decode into a static cache as the server does: prefill caches padded
    # to the context length
    ctx = 64
    jbig = jm.cache_struct(2, ctx, abstract=False, dtype=jnp.float32)
    tbig = tm.cache_struct(2, ctx)
    T = jc["b0_attn"]["k"].shape[2]
    for name in ("k", "v"):
        jbig["b0_attn"][name] = jbig["b0_attn"][name].at[:, :, :T].set(jc["b0_attn"][name])
        tbig["b0_attn"][name][:, :, :T] = tc["b0_attn"][name]
    jdecode = jax.jit(jm.forward_decode)
    for step in range(DECODE_STEPS):
        token = rng.integers(0, cfg.vocab, size=(2, 1)).astype(np.int32)
        pos = S + step
        jl, jbig = jdecode(params, jnp.asarray(token), jbig, jnp.asarray(pos, jnp.int32))
        tl, tbig = tm.forward_decode(torch.from_numpy(token).long(), tbig, pos)
        _close(tl, jl, f"decode step {step} logits")
    for name in ("k", "v"):
        _close(tbig["b0_attn"][name], jbig["b0_attn"][name], f"decode cache {name}")


def test_padded_vocab_rows_are_masked_as_in_reference():
    """A vocab of 250 pads the tables to 256 rows; both packages set the
    padded logits to -1e9."""
    jm, params, tm = _pair("llama3-8b@smoke", vocab=250)
    prompt = np.random.default_rng(4).integers(0, 250, size=(1, 9)).astype(np.int32)
    jl, _ = jm.forward_prefill(params, {"tokens": jnp.asarray(prompt)})
    tl, _ = tm.forward_prefill(torch.from_numpy(prompt).long())
    assert tl.shape[-1] == 256
    assert torch.equal(tl[..., 250:], torch.full((1, 1, 6), -1e9))
    _close(tl, jl, "prefill logits")


@pytest.mark.parametrize("theta", [10_000.0, 500_000.0])
def test_numerics_helpers_match_reference(theta):
    """RoPE (half-split layout), the causal/window mask and SwiGLU."""
    from repro.models import common as jc
    from repro_torch.models import common as tc

    rng = np.random.default_rng(int(theta) % 97)
    x = rng.normal(size=(2, 9, 3, 16)).astype(np.float32)
    pos = np.tile(np.arange(30, 39, dtype=np.int32), (2, 1))
    want = np.array(jc.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))
    got = tc.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    torch.testing.assert_close(got, torch.from_numpy(want), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(tc.rope_freqs(16, theta),
                               torch.from_numpy(np.array(jc.rope_freqs(16, theta))))
    for window in (None, 3):
        want_mask = np.array(jc.causal_mask(5, 8, q_offset=2, window=window))
        assert np.array_equal(tc.causal_mask(5, 8, q_offset=2, window=window).numpy(), want_mask)
    h, w1, w3, w2 = (rng.normal(size=s).astype(np.float32) for s in ((4, 8), (8, 12), (8, 12), (12, 8)))
    want = np.array(jc.swiglu(*map(jnp.asarray, (h, w1, w3, w2))))
    got = tc.swiglu(*map(torch.from_numpy, (h, w1, w3, w2)))
    torch.testing.assert_close(got, torch.from_numpy(want), rtol=1e-5, atol=1e-5)


def test_state_dict_names_unstack_the_layer_axis():
    jm = jax_build_model(jax_get_config("llama3-8b@smoke"))
    params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(3)))
    sd = model_params_from_numpy(params, get_config("llama3-8b@smoke"))
    assert np.array_equal(sd["blocks.1.attn.wq"].numpy(), params["blocks"]["b0_attn"]["attn"]["wq"][1])
    assert np.array_equal(sd["blocks.0.mlp.w2"].numpy(), params["blocks"]["b0_attn"]["mlp"]["w2"][0])
    tm = build_model(get_config("llama3-8b@smoke"), device="cpu")
    assert set(sd) == set(tm.state_dict())


@pytest.mark.parametrize("arch", ["mixtral-8x7b@smoke", "jamba-1.5-large-398b@smoke",
                                  "minicpm3-4b@smoke"])
def test_build_model_raises_for_what_this_slice_leaves_out(arch):
    """Every block kind is ported, so these three configs build with the
    reference's parameter count (their serving parity is in
    ``test_torch_moe_mla_models.py``) and, since the flash and scan
    backward kernels exist, pass the card-training guard.  What the guard
    still refuses on the card is a width the kernels do not take: a copy
    with 256-wide heads (MLA: a 256-wide nope part) raises ``ValueError``."""
    from repro_torch.configs.base import MLAConfig
    from repro_torch.launch.train import check_trainable

    cfg = get_config(arch)
    assert build_model(cfg, device="cpu").n_params() == jax_build_model(
        jax_get_config(arch)).n_params()
    check_trainable(cfg, "cpu")
    check_trainable(cfg, "cuda")
    wide = (dataclasses.replace(cfg, mla=MLAConfig(qk_nope_head_dim=256))
            if cfg.attention == "mla" else dataclasses.replace(cfg, head_dim=256))
    with pytest.raises(ValueError, match="over the flash kernels' 128"):
        check_trainable(wide, "cuda")


def test_configs_resolve_the_same_in_both_packages():
    from repro.configs import list_archs as jax_list_archs
    from repro_torch.configs import list_archs

    assert list_archs() == jax_list_archs()
    for arch in list_archs():
        for name in (arch, arch + "@smoke"):
            assert repr(get_config(name)) == repr(jax_get_config(name))


# ------------------------------------------------------------------ hybrid
# jamba@smoke with its MoE layers made dense (n_experts=0): two periods of
# ("mamba", "attn"), each block with a dense SwiGLU MLP.  The config is
# built with dataclasses.replace in both packages, never registered.

HYBRID = ("jamba-1.5-large-398b@smoke", dict(n_experts=0, experts_per_token=0))


def test_hybrid_parameter_counts_match():
    arch, changes = HYBRID
    jm = jax_build_model(dataclasses.replace(jax_get_config(arch), **changes))
    tm = build_model(dataclasses.replace(get_config(arch), **changes), device="cpu")
    assert tm.n_params() == jm.n_params()
    assert sum(p.numel() for p in tm.parameters()) == jm.n_params()


def test_one_dense_period_of_jamba_counts_as_in_the_reference():
    """The served cut: one full-width period of jamba-1.5-large (8 layers,
    7 Mamba and 1 attention) with dense MLPs, counted without building."""
    from repro_torch.models.common import count_params
    from repro_torch.models.transformer import decoder_defs

    changes = dict(n_experts=0, experts_per_token=0, n_layers=8)
    cut = dataclasses.replace(get_config("jamba-1.5-large-398b"), **changes)
    jcut = dataclasses.replace(jax_get_config("jamba-1.5-large-398b"), **changes)
    assert count_params(decoder_defs(cut)) == jax_build_model(jcut).n_params() == 9_116_360_704
    assert cut.pattern().count("mamba") == 7 and cut.pattern().index("attn") == 3


@pytest.mark.parametrize("S", [12, 40])
def test_hybrid_prefill_and_decode_match_reference(S):
    """Logits and every cache (attention k, v; Mamba h, conv) over a
    prefill and 4 decode steps.  S = 40 is not a multiple of the
    reference's scan chunk (16)."""
    arch, changes = HYBRID
    jm, params, tm = _pair(arch, **changes)
    cfg = tm.cfg
    rng = np.random.default_rng(S)
    prompt = rng.integers(0, cfg.vocab, size=(2, S)).astype(np.int32)

    jl, jc = jax.jit(jm.forward_prefill)(params, {"tokens": jnp.asarray(prompt)})
    tl, tc = tm.forward_prefill(torch.from_numpy(prompt).long())
    _close(tl, jl, "prefill logits")
    assert sorted(tc) == sorted(jc) == ["b0_mamba", "b1_attn"]
    for key in tc:
        assert sorted(tc[key]) == sorted(jc[key])
        for name in tc[key]:
            _close(tc[key][name], jc[key][name], f"prefill {key} {name}")

    ctx = 64
    jbig = jm.cache_struct(2, ctx, abstract=False, dtype=jnp.float32)
    tbig = tm.cache_struct(2, ctx)
    for name in ("k", "v"):
        jbig["b1_attn"][name] = jbig["b1_attn"][name].at[:, :, :S].set(jc["b1_attn"][name])
        tbig["b1_attn"][name][:, :, :S] = tc["b1_attn"][name]
    jbig["b0_mamba"] = jc["b0_mamba"]
    for name in ("h", "conv"):
        tbig["b0_mamba"][name].copy_(tc["b0_mamba"][name])
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


def test_hybrid_state_dict_names_carry_the_block_key():
    arch, changes = HYBRID
    cfg = dataclasses.replace(get_config(arch), **changes)
    jm = jax_build_model(dataclasses.replace(jax_get_config(arch), **changes))
    params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(3)))
    sd = model_params_from_numpy(params, cfg)
    assert np.array_equal(sd["blocks.1.b0_mamba.mamba.in_proj"].numpy(),
                          params["blocks"]["b0_mamba"]["mamba"]["in_proj"][1])
    assert np.array_equal(sd["blocks.0.b1_attn.attn.wq"].numpy(),
                          params["blocks"]["b1_attn"]["attn"]["wq"][0])
    assert set(sd) == set(build_model(cfg, device="cpu").state_dict())


def test_state_dict_from_an_xlstm_tree_raises():
    """The xLSTM tree round-trips: its mLSTM and sLSTM leaves unstack along
    the period axis like any other, under the names the port's model
    holds, and equal the reference's.  A tree whose period count is not
    the config's still raises."""
    cfg = get_config("xlstm-1.3b@smoke")
    jm = jax_build_model(jax_get_config("xlstm-1.3b@smoke"))
    params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    sd = model_params_from_numpy(params, cfg)
    tm = build_model(cfg, device="cpu")
    assert set(sd) == set(tm.state_dict())
    tm.load_state_dict(sd)
    for key, kind in (("b0_mlstm", "mlstm"), ("b1_slstm", "slstm")):
        for name, leaf in params["blocks"][key][kind].items():
            for i in range(cfg.n_periods()):
                got = tm.state_dict()[f"blocks.{i}.{key}.{kind}.{name}"]
                assert np.array_equal(got.numpy(), leaf[i]), (key, name, i)
    assert np.array_equal(tm.state_dict()["embed"].numpy(), params["embed"])
    two = dataclasses.replace(cfg, n_layers=2 * cfg.n_layers)
    with pytest.raises(ValueError, match="layers"):
        model_params_from_numpy(params, two)
