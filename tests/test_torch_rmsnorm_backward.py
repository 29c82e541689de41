"""The plain backward of the RMSNorm kernels (``ref.py``'s
``rmsnorm_backward_reference`` and ``add_rmsnorm_backward_reference``, the
contract of the CUDA backward kernel) against autograd through the plain
forward versions, and the wrappers' CPU paths.

Tolerances: fp32 rtol 1e-5, atol 1e-5·max|autograd| (the written-out
formula sums the row's two reductions in another order than autograd's
chain); bf16 within one bf16 ulp of autograd's value (both compute in fp32
and round once to bf16), plus, in the fused form, one ulp of the norm's
rounded part (both round it before adding the residual gradient in bf16;
where the two nearly cancel, one ulp of the part is many of the sum), and
the gain's gradient, fp32 in both, rtol 1e-5."""
import numpy as np
import pytest
import torch

from repro_torch.kernels.rmsnorm import (
    add_rmsnorm,
    add_rmsnorm_backward,
    add_rmsnorm_backward_reference,
    add_rmsnorm_reference,
    rmsnorm,
    rmsnorm_backward,
    rmsnorm_backward_reference,
    rmsnorm_reference,
)

SHAPES = [(3, 64), (2, 5, 86), (4, 1, 37), (7, 256)]


def _inputs(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    t = lambda *s, scale=1.0: torch.from_numpy((scale * rng.standard_normal(s)).astype(np.float32))
    x, dy, ds = t(*shape).to(dtype), t(*shape).to(dtype), t(*shape, scale=0.5).to(dtype)
    delta = t(*shape, scale=0.5).to(dtype)
    gain = 1.0 + 0.1 * t(shape[-1])
    return x, delta, dy, ds, gain


def _bf16_ulp(ref):
    a = ref.float().abs().clamp_min(torch.finfo(torch.bfloat16).tiny)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def _close(got, want, what, norm_part=None):
    assert got.dtype == want.dtype, what
    if got.dtype == torch.bfloat16:
        err = (got.float() - want.float()).abs()
        tol = _bf16_ulp(want) + (0 if norm_part is None else _bf16_ulp(norm_part))
        assert bool((err <= tol).all()), f"{what}: {float(err.max())}"
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()),
                                   msg=lambda m: f"{what}: {m}")


def _autograd(fn, inputs, grads):
    leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    pairs = [(o, g) for o, g in zip(outs, grads) if g is not None]
    return torch.autograd.grad([o for o, _ in pairs], leaves, [g for _, g in pairs])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_norm_backward_matches_autograd(shape, dtype):
    x, _, dy, _, gain = _inputs(shape, dtype, seed=sum(shape))
    want_dx, want_dg = _autograd(lambda x, g: rmsnorm_reference(x, g, 1e-5), (x, gain), (dy,))
    dx, dg = rmsnorm_backward_reference(x, dy, gain, 1e-5)
    _close(dx, want_dx, "dx")
    assert dg.dtype == gain.dtype
    torch.testing.assert_close(dg, want_dg, rtol=1e-5, atol=1e-5 * float(want_dg.abs().max()))
    got = rmsnorm_backward(x, dy, gain, 1e-5)              # the wrapper's CPU path
    assert all(torch.equal(a, b) for a, b in zip(got, (dx, dg)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("with_ds", [True, False])
def test_fused_backward_matches_autograd(shape, dtype, with_ds):
    """Gradients of x and delta (equal) and of the gain, given the
    gradients of both outputs, or of the norm alone (the final norm's
    residual sum is not used further)."""
    x, delta, dh, ds, gain = _inputs(shape, dtype, seed=3 * sum(shape))
    ds = ds if with_ds else None
    want_dx, want_ddelta, want_dg = _autograd(
        lambda x, d, g: add_rmsnorm_reference(x, d, g, 1e-5), (x, delta, gain), (ds, dh))
    s = x + delta
    dx, dg = add_rmsnorm_backward_reference(s, ds, dh, gain, 1e-5)
    norm_part = rmsnorm_backward_reference(s, dh, gain, 1e-5)[0]
    _close(dx, want_dx, "dx", norm_part)
    _close(dx, want_ddelta, "ddelta", norm_part)
    torch.testing.assert_close(dg, want_dg, rtol=1e-5, atol=1e-5 * float(want_dg.abs().max()))
    got = add_rmsnorm_backward(s, ds, dh, gain, 1e-5)
    assert all(torch.equal(a, b) for a, b in zip(got, (dx, dg)))


def test_wrappers_are_differentiable_on_the_cpu():
    """On CPU tensors the wrappers are the plain versions, which autograd
    differentiates: gradients equal the written-out backward's."""
    x, delta, dh, ds, gain = _inputs((3, 9, 48), torch.float32, seed=5)
    gx, gg = _autograd(lambda x, g: rmsnorm(x, g, 1e-5), (x, gain), (dh,))
    want = rmsnorm_backward_reference(x, dh, gain, 1e-5)
    _close(gx, want[0], "rmsnorm dx")
    torch.testing.assert_close(gg, want[1], rtol=1e-5, atol=1e-6)
    gx, gd, gg = _autograd(lambda x, d, g: add_rmsnorm(x, d, g, 1e-5), (x, delta, gain), (ds, dh))
    want = add_rmsnorm_backward_reference(x + delta, ds, dh, gain, 1e-5)
    _close(gx, want[0], "add_rmsnorm dx")
    _close(gd, want[0], "add_rmsnorm ddelta")
    torch.testing.assert_close(gg, want[1], rtol=1e-5, atol=1e-6)
