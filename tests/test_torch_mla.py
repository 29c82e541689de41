"""The port's multi-head latent attention against the reference's on the
same weights and inputs: ``mla_prefill`` (its output and the compressed
cache ``c_kv``, ``k_rope``) and ``mla_decode`` over a few steps (output and
both caches), at minicpm3@smoke's widths and at minicpm3's own head
widths (qk 64 + 32, v 64) with few heads.  Tolerance rtol 1e-4, atol
1e-4·max|x|, as in ``test_torch_models.py``.

On the CPU the prefill's flash call takes the kernel's plain version with
v zero-padded to the q/k width; the reference runs ``_gqa_core`` with v
at its own width."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import attention as jattn
from repro.models.common import init_params as jax_init_params
from repro_torch.configs import get_config
from repro_torch.configs.base import MLAConfig
from repro_torch.models import attention as tattn
from repro_torch.models.transformer import ParamModule

RTOL, ATOL_REL = 1e-4, 1e-4

FULL_HEADS = dict(d_model=128, n_heads=4, n_kv_heads=4,
                  mla=MLAConfig(q_lora_rank=48, kv_lora_rank=32,
                                qk_nope_head_dim=64, qk_rope_head_dim=32, v_head_dim=64))
CASES = {"smoke": {}, "minicpm3-head-widths": FULL_HEADS}


def _close(got, want, what):
    want = torch.from_numpy(np.array(want))
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL_REL * float(want.abs().max()),
                               msg=lambda m: f"{what}: {m}")


def _layer(case, seed):
    """Both packages' configs and one MLA layer's weights from the
    reference's ``init_params``, the norm gains perturbed off ones."""
    changes = CASES[case]
    jcfg = dataclasses.replace(jax_get_config("minicpm3-4b@smoke"), **changes)
    tcfg = dataclasses.replace(get_config("minicpm3-4b@smoke"), **changes)
    tree = jax_init_params(jattn.mla_defs(jcfg, 1), jax.random.PRNGKey(seed))
    w = {k: np.array(v[0]) for k, v in tree.items()}
    rng = np.random.default_rng(seed)
    for k in ("q_norm", "kv_norm"):
        w[k] = (w[k] + 0.1 * rng.normal(size=w[k].shape)).astype(np.float32)
    return jcfg, tcfg, w, ParamModule({k: torch.from_numpy(v) for k, v in w.items()})


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("B,S", [(1, 9), (2, 24)])
def test_mla_prefill_matches_reference(case, B, S):
    jcfg, tcfg, w, p = _layer(case, seed=S)
    x = np.random.default_rng(S + 1).normal(size=(B, S, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    jout, jc = jax.jit(lambda w, x, pos: jattn.mla_prefill(w, x, jcfg, pos, True))(
        {k: jnp.asarray(v) for k, v in w.items()}, jnp.asarray(x), jnp.asarray(pos))
    tout, tc = tattn.mla_prefill(p, torch.from_numpy(x), tcfg, torch.from_numpy(pos.copy()),
                                 make_cache=True)
    _close(tout, jout, "prefill output")
    m = tcfg.mla
    assert tuple(tc["c_kv"].shape) == (B, S, m.kv_lora_rank)
    assert tuple(tc["k_rope"].shape) == (B, S, m.qk_rope_head_dim)
    for name in ("c_kv", "k_rope"):
        _close(tc[name], jc[name], f"prefill {name}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_mla_decode_matches_reference(case):
    """A 12-token prefill's cache padded into a 32-slot cache, then 4
    decode steps at positions 12-15: outputs and both caches after each."""
    jcfg, tcfg, w, p = _layer(case, seed=3)
    B, S, T = 2, 12, 32
    rng = np.random.default_rng(4)
    x = rng.normal(size=(B, S, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    jw = {k: jnp.asarray(v) for k, v in w.items()}
    _, jc = jattn.mla_prefill(jw, jnp.asarray(x), jcfg, jnp.asarray(pos), True)
    _, tc = tattn.mla_prefill(p, torch.from_numpy(x), tcfg, torch.from_numpy(pos.copy()), True)
    jbig = jattn.make_cache_struct(jcfg, B, T, jnp.float32, abstract=False)
    tbig = tattn.make_cache_struct(tcfg, B, T)
    assert sorted(tbig) == sorted(jbig) == ["c_kv", "k_rope"]
    for name in tbig:
        assert tuple(tbig[name].shape) == jbig[name].shape
        jbig[name] = jbig[name].at[:, :S].set(jc[name])
        tbig[name][:, :S] = tc[name]
    jdecode = jax.jit(lambda w, x, c, pos: jattn.mla_decode(w, x, jcfg, c, pos))
    for step in range(4):
        xt = rng.normal(size=(B, 1, jcfg.d_model)).astype(np.float32)
        jout, jbig = jdecode(jw, jnp.asarray(xt), jbig, jnp.asarray(S + step, jnp.int32))
        tout, tbig = tattn.mla_decode(p, torch.from_numpy(xt), tcfg, tbig, S + step)
        _close(tout, jout, f"decode {step} output")
        for name in tbig:
            _close(tbig[name], jbig[name], f"decode {step} {name}")


def test_mla_cache_struct_matches_reference_shapes():
    jcfg, tcfg = jax_get_config("minicpm3-4b"), get_config("minicpm3-4b")
    want = jattn.make_cache_struct(jcfg, 4, 256)
    got = tattn.make_cache_struct(tcfg, 4, 256, device="meta")
    assert {k: tuple(v.shape) for k, v in got.items()} == {k: v.shape for k, v in want.items()}
    assert {k: tuple(v.shape) for k, v in got.items()} == {"c_kv": (4, 256, 256),
                                                          "k_rope": (4, 256, 32)}
