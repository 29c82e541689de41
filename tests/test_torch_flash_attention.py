"""The port's flash attention: its plain version against the reference
package's jnp oracle and its Pallas kernel (interpret mode), in the model
layout (B, S, H, hd), and the wrapper's CPU path.  The CUDA kernel's own
tests are in ``test_torch_cuda_kernels.py``.

Tolerance: fp32 within 2e-5 (rtol and atol).  Scores, softmax and the
weighted sum of values run in other orders (einsum vs the online softmax
over tiles), a few ulp on outputs of order 1.

The Pallas wrapper pads S to its tile and passes the padded length as the
kernel's ``seq_len``, so in non-causal attention padded keys are not
masked: it is compared only where that cannot matter (causal, or S a tile
multiple).  The port masks keys by the real length, which
``test_non_causal_odd_length_follows_attention_reference`` pins."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash_attention
from repro.kernels.flash_attention import flash_attention_reference as jax_flash_reference
from repro.kernels.flash_attention.ref import attention_reference as jax_attention_reference
from repro_torch.kernels.flash_attention import (
    attention_reference,
    flash_attention,
    flash_attention_reference,
)

TOL = dict(rtol=2e-5, atol=2e-5)
H = 4


def _qkv(S, G, hd, seed, B=1):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, S, H, hd)).astype(np.float32)
    k = rng.normal(size=(B, S, H // G, hd)).astype(np.float32)
    v = rng.normal(size=(B, S, H // G, hd)).astype(np.float32)
    return q, k, v


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("S", [1, 7, 64, 130])
@pytest.mark.parametrize("G", [1, 2, 4])
@pytest.mark.parametrize("hd,window", [(16, None), (120, 5)])
def test_plain_matches_jax_oracle(S, G, hd, window):
    q, k, v = _qkv(S, G, hd, seed=S * 31 + G * 7 + hd)
    want = np.array(jax_flash_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                        causal=True, window=window))
    got = flash_attention_reference(*_t(q, k, v), causal=True, window=window)
    assert got.shape == (1, S, H, hd)
    torch.testing.assert_close(got, torch.from_numpy(want), **TOL)


@pytest.mark.parametrize("S,G,hd,window", [
    (1, 4, 16, None), (7, 2, 16, None), (64, 4, 120, None), (130, 1, 16, None),
    (130, 4, 16, 32), (64, 2, 120, 5),
])
def test_plain_matches_pallas_kernel_causal(S, G, hd, window):
    q, k, v = _qkv(S, G, hd, seed=S + hd)
    want = np.array(jax_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                        causal=True, window=window, interpret=True))
    got = flash_attention_reference(*_t(q, k, v), causal=True, window=window)
    torch.testing.assert_close(got, torch.from_numpy(want), **TOL)


@pytest.mark.parametrize("S,G,window", [(16, 2, None), (128, 4, None), (128, 1, 32)])
def test_plain_matches_pallas_kernel_non_causal_at_tile_multiples(S, G, window):
    q, k, v = _qkv(S, G, 16, seed=S + G)
    want = np.array(jax_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                        causal=False, window=window, interpret=True))
    got = flash_attention_reference(*_t(q, k, v), causal=False, window=window)
    torch.testing.assert_close(got, torch.from_numpy(want), **TOL)


@pytest.mark.parametrize("S", [7, 130])
def test_non_causal_odd_length_follows_attention_reference(S):
    """At S = 7 and 130 the reference wrapper lets padded keys into
    non-causal rows; the port follows ``attention_reference``, which has no
    padding."""
    q, k, v = _qkv(S, 2, 16, seed=S)
    tr = lambda a: jnp.asarray(a).transpose(0, 2, 1, 3)
    want = np.array(jax_attention_reference(tr(q), tr(k), tr(v), causal=False)).transpose(0, 2, 1, 3)
    got = flash_attention(*_t(q, k, v), causal=False)
    torch.testing.assert_close(got, torch.from_numpy(np.ascontiguousarray(want)), **TOL)
    padded = np.array(jax_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          causal=False, interpret=True))
    assert np.abs(padded - want).max() > 1e-2   # the reference wrapper's gap


def test_scale_is_passed_through():
    q, k, v = _qkv(9, 2, 16, seed=5)
    tq, tk, tv = _t(q, k, v)
    default = flash_attention_reference(tq, tk, tv)
    explicit = flash_attention_reference(tq, tk, tv, scale=16 ** -0.5)
    doubled = flash_attention_reference(tq, tk, tv, scale=2 * 16 ** -0.5)
    assert torch.equal(default, explicit)
    assert not torch.allclose(default, doubled)
    want = attention_reference(tq.transpose(1, 2), tk.transpose(1, 2), tv.transpose(1, 2),
                               scale=2 * 16 ** -0.5).transpose(1, 2)
    assert torch.equal(doubled, want)


def test_wrapper_takes_the_plain_version_on_cpu_without_a_launch():
    q, k, v = _t(*_qkv(20, 4, 16, seed=9))
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=True, window=8, scale=0.3)
    assert torch.equal(got, flash_attention_reference(q, k, v, causal=True, window=8, scale=0.3))
    assert flash_attention.launches == before
