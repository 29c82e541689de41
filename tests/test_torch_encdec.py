"""The port's encoder-decoder and frontend models against the reference
package's on the same weights: seamless-m4t-large-v2 (an encoder over the
audio frontend's frames, cross-attention in every decoder layer) and
internvl2-26b (a decoder-only backbone behind the vision frontend's patch
tokens), at their smoke widths.  The reference ``Model.init`` tree goes
through numpy and ``model_params_from_numpy`` into the port's state dict.

The frame and patch embeddings are seeded and non-zero: with zeros (what
both servers feed) ``frontend_proj`` gives zeros, the encoder's output is
zero and so is every cross-attention output, which would test nothing.

Tolerance on logits and caches: rtol 1e-4, atol 1e-4·max|x|, as
``test_torch_models.py`` states it (float32 sums in other orders: the
flash op's plain version against the reference's einsum core, compounded
over two encoder and two decoder layers and a few decode steps).  The flash
op's plain version with keys of their own length is held to the
reference's ``_gqa_core`` with an all-ones mask within 2e-5, as
``test_torch_flash_attention.py`` holds the plain version.  A train step
under ``remat="full"``, the encoder's layers recomputed too, is bit for
bit one under ``remat="none"``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.launch.serve import BatchedServer as JaxServer
from repro.launch.serve import Request as JaxRequest
from repro.models import attention as jax_attention
from repro.models import build_model as jax_build_model
from repro.models.transformer import run_encoder_stack as jax_run_encoder_stack
from repro_torch.configs import get_config
from repro_torch.interop import model_params_from_numpy
from repro_torch.kernels.flash_attention import (
    flash_attention,
    flash_attention_reference,
)
from repro_torch.kernels.rmsnorm import add_rmsnorm, rmsnorm
from repro_torch.launch.serve import BatchedServer, Request
from repro_torch.models import build_model
from repro_torch.models.attention import cross_attention, encoder_kv
from repro_torch.models.common import count_params
from repro_torch.models.frontends import apply_frontend_proj, frontend_embed_shape
from repro_torch.models.transformer import decoder_defs, run_encoder_stack

SEAMLESS, INTERNVL = "seamless-m4t-large-v2@smoke", "internvl2-26b@smoke"
ARCHS = [SEAMLESS, INTERNVL]
RTOL, ATOL_REL = 1e-4, 1e-4
FLASH_TOL = dict(rtol=2e-5, atol=2e-5)
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


def _frames(cfg, batch, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=frontend_embed_shape(cfg, batch)).astype(np.float32)


@pytest.mark.parametrize("arch", ARCHS + ["seamless-m4t-large-v2", "internvl2-26b"])
def test_parameter_counts_match(arch):
    """Full widths counted from the parameter tables alone: seamless is
    2,035,935,232 parameters in both packages."""
    cfg = get_config(arch)
    want = jax_build_model(jax_get_config(arch)).n_params()
    assert count_params(decoder_defs(cfg)) == want
    if arch == "seamless-m4t-large-v2":
        assert want == 2_035_935_232
    if arch.endswith("@smoke"):
        tm = build_model(cfg, device="cpu")
        assert tm.n_params() == sum(p.numel() for p in tm.parameters()) == want


@pytest.mark.parametrize("arch", ARCHS)
def test_state_dict_carries_encoder_cross_and_frontend(arch):
    jm = jax_build_model(jax_get_config(arch))
    params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(3)))
    cfg = get_config(arch)
    sd = model_params_from_numpy(params, cfg)
    tm = build_model(cfg, device="cpu")
    assert set(sd) == set(tm.state_dict())
    assert np.array_equal(sd["frontend_proj"].numpy(), params["frontend_proj"])
    if cfg.is_encdec:
        enc = params["encoder"]["blocks"]["b0_attn"]
        assert np.array_equal(sd["encoder.blocks.1.attn.wk"].numpy(), enc["attn"]["wk"][1])
        assert np.array_equal(sd["encoder.blocks.0.mlp.w2"].numpy(), enc["mlp"]["w2"][0])
        assert np.array_equal(sd["encoder.final_norm"].numpy(), params["encoder"]["final_norm"])
        assert np.array_equal(sd["cross.1.attn.wq"].numpy(), params["cross"]["attn"]["wq"][1])
        assert np.array_equal(sd["cross.0.norm"].numpy(), params["cross"]["norm"][0])
    else:
        assert not any(k.startswith(("encoder.", "cross.")) for k in sd)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    """Prefill logits and caches (``cross_kv`` included), then 4 decode
    steps into static caches as the server inserts them, with seeded
    non-zero frontend embeddings."""
    jm, params, tm = _pair(arch)
    cfg = tm.cfg
    rng = np.random.default_rng(11)
    S = 9
    prompt = rng.integers(0, cfg.vocab, size=(2, S)).astype(np.int32)
    frames = _frames(cfg, 2, seed=12)
    assert np.abs(frames).max() > 1.0

    jl, jc = jax.jit(jm.forward_prefill)(
        params, {"tokens": jnp.asarray(prompt), "frontend": jnp.asarray(frames)})
    tl, tc = tm.forward_prefill(torch.from_numpy(prompt).long(), torch.from_numpy(frames))
    assert tl.shape == (2, 1, cfg.padded_vocab)
    _close(tl, jl, "prefill logits")
    assert set(tc) == set(jc)
    for key in tc:
        for name in ("k", "v"):
            _close(tc[key][name], jc[key][name], f"prefill {key} {name}")
    if cfg.is_encdec:
        assert tuple(tc["cross_kv"]["k"].shape) == (cfg.n_periods(), 2, cfg.frontend_tokens,
                                                     cfg.n_kv_heads, cfg.head_dim)
        assert float(tc["cross_kv"]["k"].abs().max()) > 0.1     # the encoder saw real frames
    else:
        assert tc["b0_attn"]["k"].shape[2] == cfg.frontend_tokens + S

    ctx = 48
    jbig = jm.cache_struct(2, ctx, abstract=False, dtype=jnp.float32)
    tbig = tm.cache_struct(2, ctx)
    assert set(tbig) == set(jbig)
    T = jc["b0_attn"]["k"].shape[2]
    for name in ("k", "v"):
        jbig["b0_attn"][name] = jbig["b0_attn"][name].at[:, :, :T].set(jc["b0_attn"][name])
        tbig["b0_attn"][name][:, :, :T] = tc["b0_attn"][name]
        if cfg.is_encdec:
            jbig["cross_kv"][name] = jc["cross_kv"][name]
            tbig["cross_kv"][name].copy_(tc["cross_kv"][name])
    jdecode = jax.jit(jm.forward_decode)
    for step in range(DECODE_STEPS):
        token = rng.integers(0, cfg.vocab, size=(2, 1)).astype(np.int32)
        pos = T + step
        jl, jbig = jdecode(params, jnp.asarray(token), jbig, jnp.asarray(pos, jnp.int32))
        tl, tbig = tm.forward_decode(torch.from_numpy(token).long(), tbig, pos)
        _close(tl, jl, f"decode {step} logits")
    for key in tbig:
        for name in ("k", "v"):
            _close(tbig[key][name], jbig[key][name], f"decode cache {key} {name}")


def test_frontend_embeddings_are_required_and_only_taken_where_the_model_has_them():
    tokens = torch.arange(4, 10).reshape(1, 6)
    for arch in ARCHS:
        with pytest.raises(ValueError, match="required"):
            build_model(get_config(arch), device="cpu").forward_prefill(tokens)
    llama = build_model(get_config("llama3-8b@smoke"), device="cpu")
    with pytest.raises(ValueError, match="not taken"):
        llama.forward_prefill(tokens, torch.zeros(1, 4, llama.cfg.d_model))


def test_frontend_projection_matches_reference():
    from repro.models.frontends import apply_frontend_proj as jax_apply
    from repro.models.frontends import frontend_embed_shape as jax_shape

    for arch in ARCHS:
        assert frontend_embed_shape(get_config(arch), 3) == jax_shape(jax_get_config(arch), 3)
    rng = np.random.default_rng(4)
    emb = rng.normal(size=(2, 5, 16)).astype(np.float32)
    proj = rng.normal(size=(16, 16)).astype(np.float32)
    want = np.array(jax_apply({"frontend_proj": jnp.asarray(proj)}, jnp.asarray(emb)))
    got = apply_frontend_proj(torch.from_numpy(proj), torch.from_numpy(emb))
    torch.testing.assert_close(got, torch.from_numpy(want), rtol=1e-5, atol=1e-5)


def test_encoder_stack_and_cross_attention_match_reference():
    """The encoder's output, then one decoder layer's cross K/V and its
    cross-attention at prefill (flash, 9 queries over 16 frames) and at
    decode (the plain core, one query), on the same weights."""
    jm, params, tm = _pair(SEAMLESS)
    cfg = tm.cfg
    frames = _frames(cfg, 2, seed=21)
    enc_in = frames @ np.asarray(params["frontend_proj"])
    want_enc = jax_run_encoder_stack(params, jnp.asarray(enc_in), jax_get_config(SEAMLESS),
                                     remat="none")
    got_enc = run_encoder_stack(tm.encoder, torch.from_numpy(enc_in), cfg)
    _close(got_enc, want_enc, "encoder output")

    cross = jax.tree_util.tree_map(lambda a: a[1], params["cross"]["attn"])
    jkv = jax_attention.encoder_kv(cross, want_enc, jax_get_config(SEAMLESS))
    tkv = encoder_kv(tm.cross[1].attn, got_enc, cfg)
    for name in ("k", "v"):
        _close(tkv[name], jkv[name], f"cross {name}")
    rng = np.random.default_rng(22)
    for S, decode in ((9, False), (1, True)):
        x = rng.normal(size=(2, S, cfg.d_model)).astype(np.float32)
        want = jax_attention.cross_attention(cross, jnp.asarray(x), jkv, jax_get_config(SEAMLESS))
        got = cross_attention(tm.cross[1].attn, torch.from_numpy(x), tkv, cfg, decode=decode)
        _close(got, want, f"cross-attention S={S}")


@pytest.mark.parametrize("S,Sk,G", [(9, 16, 1), (1, 16, 2), (7, 130, 4), (130, 7, 2), (64, 512, 1)])
def test_flash_plain_with_keys_of_their_own_length_matches_gqa_core(S, Sk, G):
    """Non-causal, no window: the reference computes cross-attention with
    ``_gqa_core`` and an all-ones mask."""
    H, hd = 4, 16
    rng = np.random.default_rng(S * 1000 + Sk)
    q = rng.normal(size=(2, S, H, hd)).astype(np.float32)
    k = rng.normal(size=(2, Sk, H // G, hd)).astype(np.float32)
    v = rng.normal(size=(2, Sk, H // G, hd)).astype(np.float32)
    mask = jnp.ones((S, Sk), bool)
    want = np.array(jax_attention._gqa_core(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                            mask, 1.0 / hd ** 0.5))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = flash_attention_reference(tq, tk, tv, causal=False, scale=1.0 / hd ** 0.5)
    assert got.shape == (2, S, H, hd)
    torch.testing.assert_close(got, torch.from_numpy(want), **FLASH_TOL)
    before = flash_attention.launches
    assert torch.equal(flash_attention(tq, tk, tv, causal=False, scale=1.0 / hd ** 0.5), got)
    assert flash_attention.launches == before


@pytest.mark.parametrize("causal,window", [(True, None), (False, 4), (True, 4)])
def test_causal_or_windowed_call_with_keys_of_their_own_length_raises(causal, window):
    q = torch.zeros(1, 8, 4, 16)
    k = v = torch.zeros(1, 12, 2, 16)
    for fn in (flash_attention, flash_attention_reference):
        with pytest.raises(ValueError, match="as many keys as queries"):
            fn(q, k, v, causal=causal, window=window)
    # equal lengths keep working on every path
    kk = torch.zeros(1, 8, 2, 16)
    assert flash_attention(q, kk, kk, causal=causal, window=window).shape == q.shape


@pytest.mark.parametrize("arch", ARCHS)
def test_model_kernels_count_only_kernel_launches(arch):
    """The encoder, cross-attention and frontend paths take the plain
    versions on CPU tensors, which are not launches."""
    cfg = get_config(arch)
    model = build_model(cfg, device="cpu")
    before = (rmsnorm.launches, add_rmsnorm.launches, flash_attention.launches)
    frames = torch.from_numpy(_frames(cfg, 1, seed=5))
    logits, caches = model.forward_prefill(torch.arange(4, 12).reshape(1, 8), frames)
    big = model.cache_struct(1, cfg.frontend_tokens + 16)
    logits2, _ = model.forward_decode(torch.tensor([[5]]), big, 8)
    assert torch.isfinite(logits).all() and torch.isfinite(logits2).all()
    assert (rmsnorm.launches, add_rmsnorm.launches, flash_attention.launches) == before


def _record_gaps(server, gaps, scale):
    """The top-1 minus top-2 logit gap at every token the port's server
    reads (as ``test_torch_serve.py`` records it), frontend argument
    included."""
    model = server.model
    prefill, decode = model.forward_prefill, model.forward_decode

    def record(logits, rows):
        top2 = torch.topk(logits[rows, -1, :], 2, dim=-1).values
        gaps.extend((top2[:, 0] - top2[:, 1]).tolist())
        scale.append(float(logits[rows].abs().max()))

    def prefill_and_record(tokens, frontend=None):
        assert frontend is not None and not frontend.any()     # the servers' zero frames
        logits, caches = prefill(tokens, frontend)
        record(logits, [0])
        return logits, caches

    def decode_and_record(token, caches, pos):
        logits, caches = decode(token, caches, pos)
        record(logits, [i for i, r in enumerate(server.slots) if r is not None])
        return logits, caches

    model.forward_prefill = prefill_and_record
    model.forward_decode = decode_and_record


@pytest.mark.parametrize("arch", ARCHS)
def test_servers_give_equal_greedy_tokens(arch):
    """Both servers prefill behind zero frontend embeddings, insert
    ``cross_kv`` with the K/V caches, and place a decoder-only frontend
    model's prompt behind its frontend tokens: equal greedy tokens and
    decode steps, with every token decided by more than the logit
    tolerance."""
    ref = JaxServer(arch, batch_slots=3, max_ctx=64, seed=0)
    port = BatchedServer(arch, batch_slots=3, max_ctx=64, device="cpu", seed=1)
    port.model.load_state_dict(model_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, ref.params), port.cfg))
    gaps, scale = [], []
    _record_gaps(port, gaps, scale)
    rng = np.random.default_rng(7)
    requests = [(rid, rng.integers(4, port.cfg.vocab, size=n).astype(np.int32), m)
                for rid, (n, m) in enumerate(zip([9, 17, 5, 17, 30], [6, 3, 8, 5, 4]))]
    for rid, prompt, max_new in requests:
        ref.submit(JaxRequest(rid, prompt, max_new))
        port.submit(Request(rid, prompt, max_new))
    ref.drain()
    port.drain()
    assert port.decode_steps == ref.decode_steps
    got = {r.rid: r.tokens_out for r in port.completed}
    assert got == {r.rid: r.tokens_out for r in ref.completed}
    assert all(len(got[rid]) == m for rid, _, m in requests)
    assert min(gaps) > ATOL_REL * max(scale), (min(gaps), max(scale))
    offset = 0 if port.cfg.is_encdec else port.cfg.frontend_tokens
    assert int(port.positions.max()) >= offset + 30


def test_prompt_behind_frontend_tokens_must_fit_the_context():
    port = BatchedServer(INTERNVL, batch_slots=1, max_ctx=16, device="cpu")
    port.submit(Request(0, np.arange(4, 14, dtype=np.int32), 2))     # 8 + 10 > 16
    with pytest.raises(ValueError, match="frontend tokens"):
        port.drain()


def test_encoder_remat_gives_the_train_step_bit_for_bit(monkeypatch):
    """seamless@smoke's loss and every gradient with ``remat="full"`` are
    bit for bit those of ``remat="none"``: the encoder's layers are
    recomputed in the backward (each under ``torch.utils.checkpoint``, as
    the reference's ``jax.checkpoint`` wraps them) beside the decoder's
    periods, ``enc_layers`` + periods checkpoints a step, and a prefill
    under ``remat="full"`` checkpoints nothing."""
    from repro_torch.models import transformer

    calls = [0]
    real = transformer.checkpoint

    def counted(*args, **kwargs):
        calls[0] += 1
        return real(*args, **kwargs)

    monkeypatch.setattr(transformer, "checkpoint", counted)
    cfg = get_config(SEAMLESS)
    rng = np.random.default_rng(4)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, size=(2, 16))) for k in
             ("tokens", "labels")}
    batch["frontend"] = torch.from_numpy(_frames(cfg, 2, seed=5))
    runs = {}
    for remat in ("none", "full"):
        tm = build_model(cfg, device="cpu", seed=3).trainable()
        tm.remat = remat
        calls[0] = 0
        loss, _ = tm.loss_fn(batch)
        loss.backward()
        runs[remat] = (loss.detach(), {n: p.grad for n, p in tm.named_parameters()}, calls[0])
    assert runs["none"][2] == 0
    assert runs["full"][2] == cfg.enc_layers + cfg.n_periods()
    assert torch.equal(runs["full"][0], runs["none"][0])
    assert any(float(g.abs().max()) > 0 for n, g in runs["none"][1].items()
               if n.startswith("encoder."))
    for name, g in runs["none"][1].items():
        assert torch.equal(runs["full"][1][name], g), name
    calls[0] = 0
    tm.forward_prefill(batch["tokens"], batch["frontend"])
    assert calls[0] == 0
