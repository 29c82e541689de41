"""The plain backward of flash attention
(``ref.py::flash_attention_backward_reference``, the contract of the CUDA
backward kernel) against ``jax.vjp`` of the reference package's own oracle
(``repro.kernels.flash_attention.ref.attention_reference``; for keys of
their own length, the reference's non-causal path ``_gqa_core`` with an
all-ones mask, since the oracle takes as many keys as queries), against
autograd through the port's plain forward, and the wrapper's CPU path.

Tolerance: fp32 rtol 1e-5, atol 1e-5 times the largest entry of the
call's three gradients.  Both sides
compute in fp32; the written-out formula (row log-sum-exp, ``D = Σ dO·O``)
sums in another order than the chain rule through softmax."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.kernels.flash_attention.ref import attention_reference as jax_attention_reference
from repro.models import attention as jax_attention
from repro_torch.kernels.flash_attention import (
    flash_attention_backward,
    flash_attention_backward_reference,
    flash_attention_reference,
)

RTOL = ATOL_REL = 1e-5


def _inputs(B, S, Sk, H, KV, hd, seed, v_width=None):
    """Seeded numpy q (B, S, H, hd), k and v (B, Sk, KV, hd) and the output
    gradient; with ``v_width`` v's columns past it are zero (MLA's padded
    v)."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, S, H, hd)).astype(np.float32)
    k = rng.normal(size=(B, Sk, KV, hd)).astype(np.float32)
    v = rng.normal(size=(B, Sk, KV, hd)).astype(np.float32)
    if v_width is not None:
        v[..., v_width:] = 0.0
    dout = rng.normal(size=(B, S, H, hd)).astype(np.float32)
    return q, k, v, dout


def _close_all(got, want, what):
    """Each gradient within rtol 1e-5 and atol 1e-5 times the largest entry
    of the call's three gradients (at S = 1 dq and dk are zero: their own
    largest entry would leave no room for fp32 rounding)."""
    want = [torch.as_tensor(np.array(w)) for w in want]
    scale = max(float(w.abs().max()) for w in want)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert g.dtype == torch.float32 and g.shape == w.shape, f"{what} {name}"
        torch.testing.assert_close(g, w, rtol=RTOL, atol=ATOL_REL * scale,
                                   msg=lambda m: f"{what} {name}: {m}")


def _plain(q, k, v, dout, causal, window, scale):
    """The port's plain backward from numpy inputs, ``out`` from its plain
    forward."""
    q, k, v, dout = (torch.from_numpy(t) for t in (q, k, v, dout))
    out = flash_attention_reference(q, k, v, causal=causal, window=window, scale=scale)
    return flash_attention_backward_reference(q, k, v, out, dout, causal=causal, window=window,
                                              scale=scale)


def _jax_vjp(q, k, v, dout, causal, window, scale):
    """``jax.vjp`` of the reference's oracle (jitted), in the model layout."""
    if k.shape[1] == q.shape[1]:
        def fn(q_, k_, v_):
            t = lambda a: a.transpose(0, 2, 1, 3)        # (B, S, H, hd) <-> (B, H, S, hd)
            return t(jax_attention_reference(t(q_), t(k_), t(v_), causal=causal, window=window,
                                             scale=scale))
    else:
        mask = jnp.ones((q.shape[1], k.shape[1]), bool)
        fn = lambda q_, k_, v_: jax_attention._gqa_core(q_, k_, v_, mask, scale)
    grads = jax.jit(lambda q_, k_, v_, d_: jax.vjp(fn, q_, k_, v_)[1](d_))
    return grads(*(jnp.asarray(a) for a in (q, k, v, dout)))


CASES = {
    "causal": (2, 40, 40, 4, 4, 16, True, None, None),
    "causal-gqa": (1, 64, 64, 8, 2, 32, True, None, None),
    "window": (2, 50, 50, 4, 2, 16, True, 12, None),
    "window-noncausal": (1, 33, 33, 4, 4, 8, False, 5, None),
    "noncausal": (2, 32, 32, 6, 3, 16, False, None, None),
    "mla-padded-v": (1, 37, 37, 5, 5, 24, True, None, 16),
    "s1": (2, 1, 1, 4, 2, 16, True, None, None),
    "s-not-32": (1, 71, 71, 4, 1, 16, True, None, None),
    "keys-own-length": (2, 9, 40, 4, 2, 16, False, None, None),
    "keys-own-length-gqa": (1, 33, 7, 8, 2, 8, False, None, None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_backward_matches_jax_vjp_of_the_reference(case):
    B, S, Sk, H, KV, hd, causal, window, v_width = CASES[case]
    q, k, v, dout = _inputs(B, S, Sk, H, KV, hd, seed=len(case), v_width=v_width)
    scale = 1.0 / hd ** 0.5
    _close_all(_plain(q, k, v, dout, causal, window, scale),
               _jax_vjp(q, k, v, dout, causal, window, scale), case)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_backward_matches_autograd_through_the_plain_forward(case):
    B, S, Sk, H, KV, hd, causal, window, v_width = CASES[case]
    q, k, v, dout = _inputs(B, S, Sk, H, KV, hd, seed=len(case) + 1, v_width=v_width)
    leaves = [torch.from_numpy(t).requires_grad_(True) for t in (q, k, v)]
    flash_attention_reference(*leaves, causal=causal, window=window).backward(
        torch.from_numpy(dout))
    _close_all(_plain(q, k, v, dout, causal, window, hd ** -0.5),
               [leaf.grad for leaf in leaves], case)


def test_wrapper_runs_the_plain_backward_on_cpu_tensors():
    """On CPU tensors the wrapper is the plain backward, bit for bit, in
    fp32 and bf16 (gradients in the input's dtype), and counts no launch."""
    before = flash_attention_backward.launches
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, dout = (torch.from_numpy(t).to(dtype)
                         for t in _inputs(2, 19, 19, 4, 2, 16, seed=3))
        out = flash_attention_reference(q, k, v, causal=True, window=6)
        got = flash_attention_backward(q, k, v, out, dout, causal=True, window=6)
        want = flash_attention_backward_reference(q, k, v, out, dout, causal=True, window=6,
                                                  scale=16 ** -0.5)
        for g, w in zip(got, want):
            assert g.dtype == dtype and torch.equal(g, w)
    assert flash_attention_backward.launches == before


def test_plain_backward_refuses_keys_of_their_own_length_when_causal():
    q, k, v, dout = (torch.from_numpy(t) for t in _inputs(1, 8, 12, 2, 2, 8, seed=4))
    with pytest.raises(ValueError, match="as many keys as queries"):
        flash_attention_backward_reference(q, k, v, q, dout, causal=True)


@settings(max_examples=60, deadline=None)
@given(B=st.integers(1, 2), S=st.integers(1, 40), Sk=st.integers(1, 40),
       KV=st.integers(1, 3), G=st.integers(1, 3), hd=st.sampled_from([4, 8, 12, 16]),
       causal=st.booleans(), window=st.one_of(st.none(), st.integers(1, 48)),
       seed=st.integers(0, 2**16))
def test_plain_backward_matches_autograd_over_shapes_and_masks(B, S, Sk, KV, G, hd, causal,
                                                               window, seed):
    """Any batch, query and key length, head grouping, head_dim, causal
    flag and window (keys of their own length only where the kernel takes
    them: non-causal without a window), against autograd through the port's
    plain forward, which the cases above hold to the reference."""
    if causal or window is not None:
        Sk = S
    q, k, v, dout = _inputs(B, S, Sk, KV * G, KV, hd, seed=seed)
    leaves = [torch.from_numpy(t).requires_grad_(True) for t in (q, k, v)]
    flash_attention_reference(*leaves, causal=causal, window=window).backward(
        torch.from_numpy(dout))
    _close_all(_plain(q, k, v, dout, causal, window, hd ** -0.5), [t.grad for t in leaves],
               f"B={B} S={S} Sk={Sk} KV={KV} G={G} hd={hd} causal={causal} window={window}")


def test_backward_library_is_built_from_its_own_source():
    """The backward kernel is a library of its own, keyed by its source:
    ``build/kernels/flash_attention_bwd-<hash>.so`` beside the forward's,
    nothing built when the module is imported."""
    from repro_torch.kernels._build import BUILD_DIR
    from repro_torch.kernels.flash_attention.ops import BACKWARD_LIBRARY, LIBRARY

    path = BACKWARD_LIBRARY.library_path()
    assert path.parent == BUILD_DIR and path.name.startswith("flash_attention_bwd-")
    assert BACKWARD_LIBRARY.source.name == "flash_attention_bwd.cu"
    assert BACKWARD_LIBRARY.source.parent == LIBRARY.source.parent
    assert path != LIBRARY.library_path() and BACKWARD_LIBRARY._lib is None
