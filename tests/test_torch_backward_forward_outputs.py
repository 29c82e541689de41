"""The backward wrappers' forms that take the forward's outputs (flash
attention's row statistics ``lse``, the selective scan's range-start states
``ckpt``), on the CPU, and the flash backward's bound in ``chip_smoke.py``.

On CPU tensors both wrappers run their plain backward, which recomputes
what the forward's outputs hold, so a call that passes them is bit for bit
the call that does not and matches ``jax.vjp`` of the reference package's
oracle (fp32 rtol 1e-5, atol 1e-5 times the largest entry of the call's
gradients, as ``test_torch_flash_attention_backward.py`` and
``test_torch_ssm_scan_backward.py`` hold the plain backward).  The kernels
that read those outputs run only on the card (``-m cuda`` tests)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from repro.kernels.flash_attention.ref import attention_reference as jax_attention_reference
from repro.kernels.ssm_scan.ref import ssm_scan_reference as jax_ssm_scan_reference
from repro_torch.kernels.flash_attention import flash_attention_backward, flash_attention_reference
from repro_torch.kernels.ssm_scan import ssm_scan_backward

RTOL = ATOL_REL = 1e-5


def _close(got, want, names):
    want = [torch.as_tensor(np.array(w)) for w in want]
    scale = max(float(w.abs().max()) for w in want if w.numel())
    for g, w, name in zip(got, want, names):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        torch.testing.assert_close(g, w, rtol=RTOL, atol=ATOL_REL * scale,
                                   msg=lambda m: f"{name}: {m}")


@pytest.mark.parametrize("B,S,H,KV,hd,window", [
    (2, 37, 4, 2, 64, None),     # GQA, S off every tile
    (1, 50, 8, 1, 128, 20),      # G = 8, a window
    (2, 16, 2, 2, 32, None),
])
def test_flash_backward_with_the_forward_statistics_on_cpu(B, S, H, KV, hd, window):
    rng = np.random.default_rng(S + hd)
    q, dout = (rng.normal(size=(B, S, H, hd)).astype(np.float32) for _ in range(2))
    k, v = (rng.normal(size=(B, S, KV, hd)).astype(np.float32) for _ in range(2))
    scale = hd ** -0.5
    tq, tk, tv, td = (torch.from_numpy(a) for a in (q, k, v, dout))
    out = flash_attention_reference(tq, tk, tv, causal=True, window=window, scale=scale)
    scores = torch.einsum("bshd,bthd->bhst", tq, tk.repeat_interleave(H // KV, dim=2)) * scale
    mask = torch.ones(S, S, dtype=torch.bool).tril()
    if window is not None:
        mask &= ~torch.ones(S, S, dtype=torch.bool).tril(-window)
    lse = torch.logsumexp(torch.where(mask, scores, float("-inf")), dim=-1).contiguous()
    got = flash_attention_backward(tq, tk, tv, out, td, causal=True, window=window, scale=scale,
                                   lse=lse)
    alone = flash_attention_backward(tq, tk, tv, out, td, causal=True, window=window,
                                     scale=scale)
    assert all(torch.equal(a, b) for a, b in zip(got, alone))

    def fn(q_, k_, v_):
        t = lambda a: a.transpose(0, 2, 1, 3)
        return t(jax_attention_reference(t(q_), t(k_), t(v_), causal=True, window=window,
                                         scale=scale))
    want = jax.jit(lambda *a: jax.vjp(fn, *a[:3])[1](a[3]))(
        *(jnp.asarray(a) for a in (q, k, v, dout)))
    _close(got, want, ("dq", "dk", "dv"))


@pytest.mark.parametrize("B,S,D,N", [(2, 19, 24, 16), (1, 8, 10, 7), (3, 33, 5, 4)])
def test_scan_backward_with_the_forward_states_on_cpu(B, S, D, N):
    rng = np.random.default_rng(B * 100 + S)
    dt = (np.log1p(np.exp(rng.normal(size=(B, S, D)))) * 0.1).astype(np.float32)
    x = rng.normal(size=(B, S, D)).astype(np.float32)
    bm, cm = ((rng.normal(size=(B, S, N)) * 0.5).astype(np.float32) for _ in range(2))
    a = (-np.exp(rng.normal(size=(D, N)) * 0.3)).astype(np.float32)
    h0 = (rng.normal(size=(B, D, N)) * 0.1).astype(np.float32)
    dy = rng.normal(size=(B, S, D)).astype(np.float32)
    dhT = rng.normal(size=(B, D, N)).astype(np.float32)
    args = [torch.from_numpy(t) for t in (dt, x, bm, cm, a, h0, dy, dhT)]
    ckpt = torch.zeros(B, -(-S // 8), D, N)
    got = ssm_scan_backward(*args, ckpt=ckpt)
    alone = ssm_scan_backward(*args)
    assert all(torch.equal(p, q) for p, q in zip(got, alone))

    def fn(dt_, x_, bm_, cm_, a_, h0_):
        return jax_ssm_scan_reference(dt_, x_, bm_, cm_, a_, h0_)
    _, vjp = jax.vjp(fn, *(jnp.asarray(t) for t in (dt, x, bm, cm, a, h0)))
    want = vjp((jnp.asarray(dy), jnp.asarray(dhT)))
    _close(got, want, ("ddt", "dx", "dB", "dC", "dA", "dh0"))


@pytest.mark.parametrize("B,S,H,KV,hd,bound_by", [
    (4, 256, 32, 32, 64, "bytes"),          # stablelm-1.6b's training shape
    (4, 256, 64, 8, 128, "operations"),     # the jamba pair's
])
def test_flash_backward_bound_counts_the_tensor_cores(B, S, H, KV, hd, bound_by):
    """The bound holds the bytes against the faster way of doing the five
    products: 3xTF32 on the tensor cores (three tf32 products a product at
    495 TFLOP/s, the softmax at fp32's 67) beats fp32 on the CUDA cores."""
    ms, by, products = chip_smoke.flash_backward_bound(B, S, S, H, KV, hd, True, None)
    pairs = B * H * S * (S + 1) // 2
    t_bytes = 4 * B * hd * (4 * S * H + 4 * S * KV) / 3.35e12
    t_tc = 3 * pairs * 10 * hd / 495e12 + pairs * 4 / 67e12
    assert products == "3xTF32" and by == bound_by
    assert ms == pytest.approx(max(t_bytes, t_tc) * 1e3, rel=1e-12)
