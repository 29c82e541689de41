"""The port's Mamba block against the reference's at jamba@smoke widths
(d 64, d_inner 128, d_state 4, d_conv 2, chunk 16): the prefill block
(``mamba_block``), a chain of single-token decode steps from its state
(``mamba_decode``) and the zero state (``mamba_state_struct``).

The reference runs the prefill scan as ``lax.scan`` over chunks of 16 with
an associative scan inside each (S = 7 is one short chunk, S = 16 one
full chunk, S = 32 crosses a chunk boundary, and S = 40, not a multiple of
16, takes its one-chunk fallback); the port runs the sequential recurrence
of ``ssm_scan``.  Tolerance on outputs and
states: rtol 1e-4, atol 1e-4·max|x|, float32 rounding of two orders of
the same sums.  Weights and inputs are seeded numpy, in the ranges a
trained Mamba layer has (A_log = log 1..16, dt_bias around 0)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import ssm as jax_ssm
from repro_torch.configs import get_config
from repro_torch.models import ssm
from repro_torch.models.transformer import ParamModule

ARCH = "jamba-1.5-large-398b@smoke"
RTOL, ATOL_REL = 1e-4, 1e-4
DECODE_STEPS = 4


def _params(cfg, seed=0):
    """One Mamba layer's weights as numpy, shaped by the port's
    ``mamba_defs`` without the period axis."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, pd in sorted(ssm.mamba_defs(cfg, 1).items()):
        shape = pd.shape[1:]
        if name == "A_log":
            v = np.log(rng.uniform(1.0, 16.0, size=shape))
        elif name == "dt_bias":
            v = rng.normal(size=shape) * 0.5
        elif name == "D":
            v = 1.0 + 0.1 * rng.normal(size=shape)
        else:
            fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
            v = rng.normal(size=shape) * pd.scale / np.sqrt(fan_in)
        out[name] = v.astype(np.float32)
    return out


def _pair(seed=0):
    cfg, jcfg = get_config(ARCH), jax_get_config(ARCH)
    p = _params(cfg, seed)
    return cfg, jcfg, {k: jnp.asarray(v) for k, v in p.items()}, \
        ParamModule({k: torch.from_numpy(v) for k, v in p.items()})


def _close(got, want, what):
    want = torch.from_numpy(np.array(want))
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL_REL * float(want.abs().max()),
                               msg=lambda m: f"{what}: {m}")


def test_param_defs_match_reference():
    cfg, jcfg = get_config(ARCH), jax_get_config(ARCH)
    for stack in (1, 3):
        want = jax_ssm.mamba_defs(jcfg, stack)
        got = ssm.mamba_defs(cfg, stack)
        assert sorted(got) == sorted(want)
        for name in want:
            assert (got[name].shape, got[name].axes, got[name].init, got[name].scale) == (
                want[name].shape, want[name].axes, want[name].init, want[name].scale), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_state_struct_matches_reference(dtype):
    cfg, jcfg = get_config(ARCH), jax_get_config(ARCH)
    jdtype = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    want = jax_ssm.mamba_state_struct(jcfg, 3, jdtype, abstract=True)
    got = ssm.mamba_state_struct(cfg, 3, dtype, device="cpu")
    assert sorted(got) == sorted(want)
    for name, t in got.items():
        assert tuple(t.shape) == want[name].shape
        assert str(t.dtype).split(".")[1] == str(want[name].dtype)
        assert not t.any()


@pytest.mark.parametrize("S", [7, 16, 32, 40])
def test_block_and_decode_chain_match_reference(S):
    cfg, jcfg, jp, tp = _pair(seed=S)
    rng = np.random.default_rng(100 + S)
    x = rng.normal(size=(2, S, cfg.d_model)).astype(np.float32)

    jy, jstate = jax_ssm.mamba_block(jp, jnp.asarray(x), jcfg)
    ty, tstate = ssm.mamba_block(tp, torch.from_numpy(x), cfg)
    assert ty.shape == (2, S, cfg.d_model)
    _close(ty, jy, "prefill output")
    _close(tstate["h"], jstate["h"], "prefill h")
    _close(tstate["conv"], jstate["conv"], "prefill conv")

    jdecode = jax.jit(lambda p, x, s: jax_ssm.mamba_decode(p, x, jcfg, s))
    for step in range(DECODE_STEPS):
        xt = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
        jy, jstate = jdecode(jp, jnp.asarray(xt), jstate)
        ty, tstate = ssm.mamba_decode(tp, torch.from_numpy(xt), cfg, tstate)
        assert ty.shape == (2, 1, cfg.d_model)
        _close(ty, jy, f"decode step {step} output")
        _close(tstate["h"], jstate["h"], f"decode step {step} h")
        _close(tstate["conv"], jstate["conv"], f"decode step {step} conv")


def test_prefill_equals_a_chain_of_decode_steps():
    """The prefill's state after S tokens is the state S decode steps from
    zero reach: both run the same recurrence through ``ssm_scan``."""
    cfg, _, _, tp = _pair(seed=5)
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(2, 12, cfg.d_model)).astype(np.float32))
    y, state = ssm.mamba_block(tp, x, cfg)
    chain = ssm.mamba_state_struct(cfg, 2, device="cpu")
    ys = []
    for t in range(12):
        yt, chain = ssm.mamba_decode(tp, x[:, t : t + 1], cfg, chain)
        ys.append(yt)
    torch.testing.assert_close(torch.cat(ys, 1), y, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(chain["h"], state["h"], rtol=1e-5, atol=1e-6)
    # the conv state holds in_proj rows, multiplied one token at a time
    torch.testing.assert_close(chain["conv"], state["conv"], rtol=1e-5, atol=1e-6)
