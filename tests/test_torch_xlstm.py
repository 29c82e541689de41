"""The port's xLSTM blocks against the reference's at xlstm-1.3b@smoke
widths (d 64, 2 heads, mLSTM inner width 86 over heads of 43, chunk 16):
mLSTM's chunked prefill (``mlstm_block``) and sLSTM's token loop
(``slstm_block``), chains of single-token decode steps from their states,
their parameter tables and start states (sLSTM's stabiliser ``m`` at
-1e30); the whole smoke model's logits and states over a prefill and 4
decode steps, and both packages' servers' greedy tokens.

The reference runs mLSTM's prefill in chunks of 16 when 16 divides S and
as one chunk otherwise: S = 7 and 40 are one chunk, S = 16 one full
chunk, S = 32 two, so the carried ``C`` and ``n`` cross a chunk boundary.
Tolerance on outputs and states: rtol 1e-4, atol 1e-4·max|x| (float32
rounding of other summation orders).  Weights and inputs are seeded
numpy, the gate weights at the reference's init scale.

The recurrences' backward is held to copies of the forms that sliced
each token (sLSTM) or chunk (mLSTM) out of the sequence: gradients bit for
bit, and allocated bytes linear in S where those forms' grow as S²."""
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
from repro.models import ssm as jax_ssm
from repro_torch.configs import get_config
from repro_torch.interop import model_params_from_numpy
from repro_torch.kernels.rmsnorm import ops
from repro_torch.launch.serve import BatchedServer, Request
from repro_torch.models import build_model, common, ssm
from repro_torch.models.common import count_params
from repro_torch.models.transformer import ParamModule, decoder_defs

ARCH = "xlstm-1.3b@smoke"
RTOL, ATOL_REL = 1e-4, 1e-4
DECODE_STEPS = 4
DEFS = {"mlstm": ssm.mlstm_defs, "slstm": ssm.slstm_defs}
JAX_FNS = {"mlstm": (jax_ssm.mlstm_block, jax_ssm.mlstm_decode),
           "slstm": (jax_ssm.slstm_block, jax_ssm.slstm_decode)}
FNS = {"mlstm": (ssm.mlstm_block, ssm.mlstm_decode),
       "slstm": (ssm.slstm_block, ssm.slstm_decode)}


def _params(cfg, kind, seed=0):
    """One layer's weights as numpy, shaped by the port's defs without the
    period axis: the reference's init rules (normal at scale / sqrt(fan_in),
    ones, zeros), with the norm gains and sLSTM's gate bias perturbed so
    that they matter."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, pd in sorted(DEFS[kind](cfg, 1).items()):
        shape = pd.shape[1:]
        if pd.init in ("ones", "zeros"):
            base = 1.0 if pd.init == "ones" else 0.0
            v = base + 0.1 * rng.normal(size=shape)
        else:
            fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
            v = rng.normal(size=shape) * pd.scale / np.sqrt(fan_in)
        out[name] = v.astype(np.float32)
    return out


def _pair(kind, seed=0):
    cfg, jcfg = get_config(ARCH), jax_get_config(ARCH)
    p = _params(cfg, kind, seed)
    return cfg, jcfg, {k: jnp.asarray(v) for k, v in p.items()}, \
        ParamModule({k: torch.from_numpy(v) for k, v in p.items()})


def _close(got, want, what):
    want = torch.from_numpy(np.array(want))
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL_REL * float(want.abs().max()),
                               msg=lambda m: f"{what}: {m}")


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_param_defs_match_reference(kind):
    cfg, jcfg = get_config(ARCH), jax_get_config(ARCH)
    jdefs = {"mlstm": jax_ssm.mlstm_defs, "slstm": jax_ssm.slstm_defs}[kind]
    for stack in (1, 3):
        want, got = jdefs(jcfg, stack), DEFS[kind](cfg, stack)
        assert sorted(got) == sorted(want)
        for name in want:
            assert (got[name].shape, got[name].axes, got[name].init, got[name].scale) == (
                want[name].shape, want[name].axes, want[name].init, want[name].scale), name
    assert ssm.mlstm_inner_dim(cfg) == jax_ssm.mlstm_inner_dim(jcfg)
    full = "xlstm-1.3b"
    assert ssm.mlstm_inner_dim(get_config(full)) == jax_ssm.mlstm_inner_dim(
        jax_get_config(full)) == 2732


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_state_structs_match_reference(kind):
    """Shapes, fp32, and values: zeros, and sLSTM's ``m`` at -1e30 as the
    reference's ``slstm_state_struct(abstract=False)``."""
    cfg, jcfg = get_config(ARCH), jax_get_config(ARCH)
    jfn = {"mlstm": jax_ssm.mlstm_state_struct, "slstm": jax_ssm.slstm_state_struct}[kind]
    fn = {"mlstm": ssm.mlstm_state_struct, "slstm": ssm.slstm_state_struct}[kind]
    want = jfn(jcfg, 3, abstract=False)
    got = fn(cfg, 3, device="cpu")
    assert sorted(got) == sorted(want)
    for name, t in got.items():
        assert t.dtype == torch.float32
        assert np.array_equal(t.numpy(), np.array(want[name])), name
    if kind == "slstm":
        assert torch.equal(got["m"], torch.full_like(got["m"], -1e30))


def test_model_cache_struct_keeps_the_slstm_stabiliser():
    """The model's stacked start caches equal the reference's
    ``cache_struct(abstract=False)`` value for value: mLSTM and sLSTM
    states zero but ``m``, which is -1e30, so an idle server slot decodes
    from the reference's state."""
    jm = jax_build_model(jax_get_config(ARCH))
    want = jm.cache_struct(4, 64, abstract=False, dtype=jnp.float32)
    got = build_model(get_config(ARCH), device="cpu").cache_struct(4, 64)
    assert sorted(got) == sorted(want) == ["b0_mlstm", "b1_slstm"]
    for key in got:
        assert sorted(got[key]) == sorted(want[key])
        for name, t in got[key].items():
            assert np.array_equal(t.numpy(), np.array(want[key][name])), (key, name)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
@pytest.mark.parametrize("S", [7, 16, 32, 40])
def test_block_and_decode_chain_match_reference(kind, S):
    """The prefill block's output and state, then 4 decode steps from that
    state, each step's output and state."""
    cfg, jcfg, jp, tp = _pair(kind, seed=S)
    jblock, jdecode = JAX_FNS[kind]
    block, decode = FNS[kind]
    rng = np.random.default_rng(100 + S)
    x = rng.normal(size=(2, S, cfg.d_model)).astype(np.float32)
    jy, jstate = jax.jit(lambda p, x: jblock(p, x, jcfg))(jp, jnp.asarray(x))
    ty, tstate = block(tp, torch.from_numpy(x), cfg)
    _close(ty, jy, f"{kind} prefill output")
    assert sorted(tstate) == sorted(jstate)
    for name in tstate:
        _close(tstate[name], jstate[name], f"{kind} prefill state {name}")
    jstep = jax.jit(lambda p, x, s: jdecode(p, x, jcfg, s))
    for step in range(DECODE_STEPS):
        xt = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
        jy, jstate = jstep(jp, jnp.asarray(xt), jstate)
        ty, tstate = decode(tp, torch.from_numpy(xt), cfg, tstate)
        _close(ty, jy, f"{kind} decode {step} output")
        for name in tstate:
            _close(tstate[name], jstate[name], f"{kind} decode {step} state {name}")


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
@pytest.mark.parametrize("S", [16, 32])
def test_prefill_equals_a_chain_of_decode_steps(kind, S):
    """The same recurrence two ways in the port: the prefill (mLSTM's
    chunked parallel form; sLSTM's token loop) and S single-token decode
    steps from the start state give the same outputs and final state
    (rtol 1e-4, atol 1e-4·max: the chunked form sums in another order)."""
    cfg, _, _, tp = _pair(kind, seed=7 + S)
    block, decode = FNS[kind]
    x = torch.from_numpy(np.random.default_rng(S).normal(size=(2, S, cfg.d_model))
                         .astype(np.float32))
    y, state = block(tp, x, cfg)
    start = {"mlstm": ssm.mlstm_state_struct, "slstm": ssm.slstm_state_struct}[kind]
    chain = start(cfg, 2, device="cpu")
    ys = []
    for t in range(S):
        yt, chain = decode(tp, x[:, t:t + 1], cfg, chain)
        ys.append(yt)
    _close(torch.cat(ys, dim=1), y.numpy(), f"{kind} chain outputs")
    for name in state:
        _close(chain[name], state[name].numpy(), f"{kind} chain state {name}")


def _mamba_pair(seed):
    from repro.models.ssm import mamba_defs as jax_mamba_defs

    cfg = get_config("jamba-1.5-large-398b@smoke")
    jcfg = jax_get_config("jamba-1.5-large-398b@smoke")
    rng = np.random.default_rng(seed)
    p = {}
    for name, pd in sorted(jax_mamba_defs(jcfg, 1).items()):
        shape = pd.shape[1:]
        if name == "A_log":
            v = np.log(rng.uniform(1.0, 16.0, size=shape))
        elif pd.init == "ones":
            v = 1.0 + 0.1 * rng.normal(size=shape)
        else:
            fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
            v = rng.normal(size=shape) * pd.scale / np.sqrt(fan_in)
        p[name] = v.astype(np.float32)
    return cfg, jcfg, {k: jnp.asarray(v) for k, v in p.items()}, \
        ParamModule({k: torch.from_numpy(v) for k, v in p.items()})


@pytest.mark.parametrize("S", [7, 32])
def test_mamba_block_from_a_given_state_matches_reference(S):
    """``mamba_block(p, x, cfg, state)`` with a non-zero ``h`` and conv
    window, against the reference's ``mamba_block`` called with the same
    state (no reference caller passes one at prefill; this is the
    signature's meaning)."""
    cfg, jcfg, jp, tp = _mamba_pair(seed=S)
    di = cfg.ssm.expand * cfg.d_model
    rng = np.random.default_rng(200 + S)
    x = rng.normal(size=(2, S, cfg.d_model)).astype(np.float32)
    state = {"h": rng.normal(size=(2, di, cfg.ssm.d_state)).astype(np.float32),
             "conv": rng.normal(size=(2, cfg.ssm.d_conv - 1, di)).astype(np.float32)}
    jy, jstate = jax.jit(lambda p, x, s: jax_ssm.mamba_block(p, x, jcfg, s))(
        jp, jnp.asarray(x), {k: jnp.asarray(v) for k, v in state.items()})
    ty, tstate = ssm.mamba_block(tp, torch.from_numpy(x), cfg,
                                 {k: torch.from_numpy(v) for k, v in state.items()})
    _close(ty, jy, "mamba output")
    for name in ("h", "conv"):
        _close(tstate[name], jstate[name], f"mamba state {name}")
    zero_y, _ = ssm.mamba_block(tp, torch.from_numpy(x), cfg)
    assert not torch.allclose(zero_y, ty)


# ------------------------------------------------------------------ whole model

def _model_pair(arch=ARCH):
    jm = jax_build_model(jax_get_config(arch))
    params = jm.init(jax.random.PRNGKey(0))
    tm = build_model(get_config(arch), device="cpu", seed=1)
    tm.load_state_dict(model_params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                                               tm.cfg))
    return jm, params, tm


def test_parameter_counts_match():
    """The smoke model, xlstm-1.3b whole (1,340,259,032) and the one-period
    cut (8 layers, 7 mLSTM and 1 sLSTM: 395,082,532) counted as the
    reference counts them."""
    jm, _, tm = _model_pair()
    assert tm.n_params() == jm.n_params() == sum(p.numel() for p in tm.parameters())
    full, jfull = get_config("xlstm-1.3b"), jax_get_config("xlstm-1.3b")
    assert count_params(decoder_defs(full)) == jax_build_model(jfull).n_params() == 1_340_259_032
    cut = dataclasses.replace(full, n_layers=8)
    assert count_params(decoder_defs(cut)) == jax_build_model(
        dataclasses.replace(jfull, n_layers=8)).n_params() == 395_082_532
    assert cut.pattern() == ("mlstm",) * 7 + ("slstm",)


@pytest.mark.parametrize("S", [12, 32])
def test_prefill_and_decode_match_reference(S):
    """Logits and every state (mLSTM ``C``, ``n``; sLSTM ``h``, ``c``,
    ``n``, ``m``) over a prefill and 4 decode steps from the model's start
    caches with the prefill's states copied in, as the server does."""
    jm, params, tm = _model_pair()
    cfg = tm.cfg
    rng = np.random.default_rng(S)
    prompt = rng.integers(0, cfg.vocab, size=(2, S)).astype(np.int32)
    jl, jc = jax.jit(jm.forward_prefill)(params, {"tokens": jnp.asarray(prompt)})
    tl, tc = tm.forward_prefill(torch.from_numpy(prompt).long())
    _close(tl, jl, "prefill logits")
    assert sorted(tc) == sorted(jc)
    for key in tc:
        assert sorted(tc[key]) == sorted(jc[key])
        for name in tc[key]:
            _close(tc[key][name], jc[key][name], f"prefill {key} {name}")
    tbig = tm.cache_struct(2, 64)
    for key in tc:
        for name, t in tc[key].items():
            tbig[key][name].copy_(t)
    jbig = jc
    jdecode = jax.jit(jm.forward_decode)
    for step in range(DECODE_STEPS):
        token = rng.integers(0, cfg.vocab, size=(2, 1)).astype(np.int32)
        jl, jbig = jdecode(params, jnp.asarray(token), jbig, jnp.asarray(S + step, jnp.int32))
        tl, tbig = tm.forward_decode(torch.from_numpy(token).long(), tbig, S + step)
        _close(tl, jl, f"decode step {step} logits")
    for key in tbig:
        for name in tbig[key]:
            _close(tbig[key][name], jbig[key][name], f"decode {key} {name}")


def test_blocks_hand_their_update_to_the_next_norm(monkeypatch):
    """mLSTM and sLSTM blocks have no feed-forward half: per forward, block
    0's first norm runs alone, every other block's and the final norm take
    the previous block's output as their residual add (L fused norms), and
    each block's inner norm runs the plain norm kernel (L more)."""
    tm = build_model(get_config(ARCH), device="cpu", seed=2)
    L = tm.cfg.n_layers
    calls = {"plain": 0, "fused": 0, "inner": 0}
    norm, add, inner = ops.rmsnorm, common.add_rmsnorm, ssm.rmsnorm

    def counted(name, fn, *args, **kwargs):
        calls[name] += 1
        return fn(*args, **kwargs)

    monkeypatch.setattr(ops, "rmsnorm", lambda *a, **k: counted("plain", norm, *a, **k))
    monkeypatch.setattr(ssm, "rmsnorm", lambda *a, **k: counted("inner", inner, *a, **k))
    monkeypatch.setattr(common, "add_rmsnorm",
                        lambda x, d, g, eps=1e-5: (calls.__setitem__("fused", calls["fused"]
                                                                     + (d is not None)),
                                                   add(x, d, g, eps))[1])
    logits, _ = tm.forward_prefill(torch.arange(4, 14).reshape(1, 10))
    assert calls == {"plain": 1, "fused": L, "inner": L}
    assert logits.shape == (1, 1, tm.cfg.padded_vocab)


def _requests(vocab):
    """Seven prompts of 3-40 tokens, 3-30 new tokens: requests queue for
    the four slots, and decode runs past position 40."""
    rng = np.random.default_rng(11)
    lengths = [9, 40, 3, 17, 30, 5, 22]
    max_new = [6, 3, 30, 12, 8, 20, 4]
    return [(rid, rng.integers(4, vocab, size=n).astype(np.int32), m)
            for rid, (n, m) in enumerate(zip(lengths, max_new))]


def test_servers_give_equal_greedy_tokens():
    """Both packages' ``BatchedServer``s on the same weights: 7 requests, 4
    slots, max_ctx 64, equal greedy tokens and decode steps.  Idle slots
    decode too, from the start state (``m`` at -1e30) and then from their
    drifting states, as the reference's do; the smallest top-1 minus top-2
    logit gap the port met is held above the logit tolerance, so the
    tokens are decided by the model, not by rounding."""
    ref = JaxServer(ARCH, batch_slots=4, max_ctx=64, seed=0)
    port = BatchedServer(ARCH, batch_slots=4, max_ctx=64, device="cpu", seed=1)
    port.model.load_state_dict(model_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, ref.params), port.cfg))
    gaps, scale = [], []
    decode = port.model.forward_decode

    def decode_and_record(token, caches, pos):
        logits, caches = decode(token, caches, pos)
        active = [i for i, r in enumerate(port.slots) if r is not None]
        top2 = torch.topk(logits[active, -1, :], 2, dim=-1).values
        gaps.extend((top2[:, 0] - top2[:, 1]).tolist())
        scale.append(float(logits[active].abs().max()))
        return logits, caches

    port.model.forward_decode = decode_and_record
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
    for key, layer in port.caches.items():
        jlayer = ref.caches[key]
        for name, t in layer.items():
            _close(t, jlayer[name], f"server cache {key} {name}")


# ------------------------------------------ the recurrences' backward bytes


def _slstm_cells_per_token(wx, r_gates, b_gates, carry):
    """``ssm._slstm_cells`` as it read each token, ``wx[:, t]``: the form
    whose backward zero-fills a gradient of the whole ``wx`` a token."""
    B, S, d4 = wx.shape
    r_gates = r_gates.to(wx.dtype)
    if carry is None:
        zero = torch.zeros((B, d4 // 4), dtype=torch.float32)
        carry = (zero, zero, zero, torch.full_like(zero, ssm.SLSTM_M0))
    hs = []
    for t in range(S):
        carry = ssm._slstm_step(r_gates, b_gates, carry, wx[:, t])
        hs.append(carry[0])
    return torch.stack(hs, dim=1), carry


def _mlstm_cells_per_chunk(u, gi, gf, wq, wk, wv, C, n, chunk):
    """``ssm._mlstm_cells``' prefill as it sliced each chunk out of q, k, v
    and the gates: a zero-filled gradient of the whole sequence a chunk."""
    B, S, di = u.shape
    q, k, v, logi, logf = ssm._mlstm_heads(u, gi, gf, wq, wk, wv)
    Lc = min(chunk, S)
    if S % Lc != 0:
        Lc = S
    hs = []
    for c0 in range(0, S, Lc):
        c = slice(c0, c0 + Lc)
        h, C, n = ssm._mlstm_chunk(q[:, :, c], k[:, :, c], v[:, :, c], logf[..., c],
                                   logi[..., c], C, n)
        hs.append(h)
    return torch.cat(hs, dim=2).transpose(1, 2).reshape(B, S, di), C, n


def _recurrence(kind, S, seed=0):
    """(the tree's cells, the per-slice copy, their inputs) for ``kind`` at
    xlstm-1.3b@smoke's widths over S tokens, batch 2, with a carried state."""
    cfg = get_config(ARCH)
    g = torch.Generator().manual_seed(seed)
    H, d = cfg.n_heads, cfg.d_model
    if kind == "slstm":
        carry = (0.1 * torch.randn(2, d, generator=g), 0.1 * torch.randn(2, d, generator=g),
                 torch.rand(2, d, generator=g) + 0.5, 0.1 * torch.randn(2, d, generator=g))
        inputs = [torch.randn(2, S, 4 * d, generator=g),
                  0.3 * torch.randn(H, d // H, 4 * d // H, generator=g),
                  0.1 * torch.randn(4 * d, generator=g), *carry]
        return (lambda wx, r, b, *c: ssm._slstm_cells(wx, r, b, c),
                lambda wx, r, b, *c: _slstm_cells_per_token(wx, r, b, c), inputs)
    di = ssm.mlstm_inner_dim(cfg)
    dh, chunk = di // H, cfg.ssm.chunk
    inputs = [torch.randn(2, S, di, generator=g), torch.randn(2, S, H, generator=g),
              torch.randn(2, S, H, generator=g) + 2.0,
              *(torch.randn(H, dh, dh, generator=g) / dh ** 0.5 for _ in range(3)),
              0.1 * torch.randn(2, H, dh, dh, generator=g), 0.1 * torch.randn(2, H, dh, generator=g)]
    return (lambda *a: ssm._mlstm_cells(*a, chunk, False),
            lambda *a: _mlstm_cells_per_chunk(*a, chunk), inputs)


def _backward(fn, inputs, seed=1):
    """``fn``'s outputs and every input's gradient under a seeded weighting
    of all its outputs, and the bytes the backward's ops allocated."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    class Allocated(TorchDispatchMode):
        nbytes = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if not func.is_view and all(r.alias_info is None for r in func._schema.returns):
                self.nbytes += sum(t.untyped_storage().nbytes() for t in tree_leaves(out)
                                   if isinstance(t, torch.Tensor))
            return out

    leaves = [t.clone().requires_grad_(True) for t in inputs]
    outs = tree_leaves(fn(*leaves))
    g = torch.Generator().manual_seed(seed)
    loss = sum((o * torch.randn(o.shape, generator=g)).sum() for o in outs)
    mode = Allocated()
    with mode:
        loss.backward()
    return [o.detach() for o in outs], [t.grad for t in leaves], mode.nbytes


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_recurrences_give_the_per_slice_forms_gradients_bit_for_bit(kind):
    """The sLSTM loop over ``wx.unbind(1)`` and the mLSTM chunks from one
    ``split`` a tensor give the outputs, the last state and every input's
    gradient of the forms that sliced each token or chunk out, bit for bit
    (the slices' zero-filled gradients only added zeros), over three
    mLSTM chunks and a carried state."""
    cells, per_slice, inputs = _recurrence(kind, S=48)
    got_out, got_grads, _ = _backward(cells, inputs)
    want_out, want_grads, _ = _backward(per_slice, inputs)
    for i, (a, b) in enumerate(zip(got_out + got_grads, want_out + want_grads)):
        assert torch.equal(a, b), i


@pytest.mark.parametrize("kind,S", [("mlstm", 64), ("slstm", 32)])
def test_recurrences_backward_bytes_grow_linearly_in_the_tokens(kind, S):
    """The backward's allocated bytes at 2S are at most 2.2 times those at
    S (mLSTM from four chunks of 16 to eight); the per-slice forms' grow
    faster (their zero-filled gradients as S²), past the same bound."""
    ratios = {}
    for form in ("tree", "per_slice"):
        nbytes = []
        for tokens in (S, 2 * S):
            cells, per_slice, inputs = _recurrence(kind, tokens)
            nbytes.append(_backward(cells if form == "tree" else per_slice, inputs)[2])
        ratios[form] = nbytes[1] / nbytes[0]
    assert ratios["tree"] <= 2.2, ratios
    assert ratios["per_slice"] > 2.2, ratios
