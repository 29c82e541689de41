"""The port's RMSNorm, alone and after the residual add: the plain versions
against the reference package's jnp oracle and its Pallas kernel
(interpret mode), and the wrappers' CPU paths.  The CUDA kernel's own tests are in ``test_torch_cuda_kernels.py``.

Tolerances: fp32 within 1e-6 (rtol and atol; the sums of squares run in
different orders, a few ulp on outputs of order 1); bf16 within one bf16
ulp of the reference (both round the same fp32 value to nearest even, and
a last-ulp difference in that value can flip the rounding)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rmsnorm import rmsnorm as jax_rmsnorm
from repro.kernels.rmsnorm import rmsnorm_reference as jax_rmsnorm_reference
from repro_torch.kernels.rmsnorm import (
    add_rmsnorm,
    add_rmsnorm_reference,
    rmsnorm,
    rmsnorm_reference,
)

FP32_TOL = dict(rtol=1e-6, atol=1e-6)
# rows not a multiple of the Pallas kernel's 256-row block, and a tall case
SHAPES = [(7, 64), (300, 96), (2, 3, 130), (513, 40)]


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(0.0, 2.0, shape).astype(np.float32)
    gain = rng.normal(1.0, 0.2, shape[-1]).astype(np.float32)
    return x, gain


def _bf16_ulp(ref: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at each value of ``ref`` (8 significant bits)."""
    a = ref.float().abs().clamp_min(torch.finfo(torch.bfloat16).tiny)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def _jax_bf16(x: np.ndarray) -> jnp.ndarray:
    return jnp.asarray(x).astype(jnp.bfloat16)


def _to_torch(a) -> torch.Tensor:
    """A jax array as a torch tensor (bf16 goes through fp32, exactly)."""
    a = jnp.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_jax_oracle_fp32(shape):
    x, g = _inputs(shape, 0)
    want = _to_torch(jax_rmsnorm_reference(jnp.asarray(x), jnp.asarray(g)))
    got = rmsnorm_reference(torch.from_numpy(x), torch.from_numpy(g))
    assert got.dtype == torch.float32 and got.shape == torch.Size(shape)
    torch.testing.assert_close(got, want, **FP32_TOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_pallas_kernel_fp32(shape):
    x, g = _inputs(shape, 1)
    want = _to_torch(jax_rmsnorm(jnp.asarray(x), jnp.asarray(g), interpret=True))
    got = rmsnorm_reference(torch.from_numpy(x), torch.from_numpy(g))
    torch.testing.assert_close(got, want, **FP32_TOL)


@pytest.mark.parametrize("shape", [(7, 64), (300, 96)])
@pytest.mark.parametrize("source", ["oracle", "pallas"])
def test_plain_matches_reference_bf16_within_one_ulp(shape, source):
    x, g = _inputs(shape, 2)
    xb = _jax_bf16(x)
    if source == "oracle":
        want = _to_torch(jax_rmsnorm_reference(xb, jnp.asarray(g)))
    else:
        want = _to_torch(jax_rmsnorm(xb, jnp.asarray(g), interpret=True))
    got = rmsnorm_reference(_to_torch(xb), torch.from_numpy(g))
    assert got.dtype == torch.bfloat16
    err = (got.float() - want.float()).abs()
    assert bool((err <= _bf16_ulp(want)).all()), float(err.max())


def test_eps_reaches_the_result():
    x = torch.zeros(3, 8)
    x[0, 0] = 1e-3
    g = torch.ones(8)
    small = rmsnorm_reference(x, g, eps=1e-5)
    large = rmsnorm_reference(x, g, eps=1.0)
    want = _to_torch(jax_rmsnorm_reference(jnp.asarray(x.numpy()), jnp.asarray(g.numpy()), eps=1.0))
    torch.testing.assert_close(large, want, **FP32_TOL)
    assert float(small[0, 0]) > float(large[0, 0])
    assert torch.equal(small[1:], torch.zeros(2, 8))


def test_wrapper_takes_the_plain_version_on_cpu_without_a_launch():
    x, g = _inputs((5, 32), 3)
    before = rmsnorm.launches
    got = rmsnorm(torch.from_numpy(x), torch.from_numpy(g))
    assert torch.equal(got, rmsnorm_reference(torch.from_numpy(x), torch.from_numpy(g)))
    assert rmsnorm.launches == before


def _add_inputs(shape, seed):
    x, g = _inputs(shape, seed)
    delta = np.random.default_rng(seed + 100).normal(0.0, 1.0, shape).astype(np.float32)
    return x, delta, g


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_add_plain_is_the_add_then_the_norm_bit_for_bit(shape, dtype):
    x, delta, g = (torch.from_numpy(a) for a in _add_inputs(shape, 4))
    x, delta = x.to(dtype), delta.to(dtype)
    s, h = add_rmsnorm_reference(x, delta, g)
    assert s.dtype == h.dtype == dtype
    assert torch.equal(s, x + delta)
    assert torch.equal(h, rmsnorm_reference(x + delta, g))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("source", ["oracle", "pallas"])
def test_add_plain_matches_jax_fp32(shape, source):
    x, delta, g = _add_inputs(shape, 5)
    xs = jnp.asarray(x) + jnp.asarray(delta)
    if source == "oracle":
        want = _to_torch(jax_rmsnorm_reference(xs, jnp.asarray(g)))
    else:
        want = _to_torch(jax_rmsnorm(xs, jnp.asarray(g), interpret=True))
    s, h = add_rmsnorm_reference(torch.from_numpy(x), torch.from_numpy(delta), torch.from_numpy(g))
    torch.testing.assert_close(s, _to_torch(xs), **FP32_TOL)
    torch.testing.assert_close(h, want, **FP32_TOL)


@pytest.mark.parametrize("shape", [(7, 64), (300, 96)])
@pytest.mark.parametrize("source", ["oracle", "pallas"])
def test_add_plain_matches_jax_bf16_within_one_ulp(shape, source):
    x, delta, g = _add_inputs(shape, 6)
    xs = _jax_bf16(x) + _jax_bf16(delta)
    if source == "oracle":
        want = _to_torch(jax_rmsnorm_reference(xs, jnp.asarray(g)))
    else:
        want = _to_torch(jax_rmsnorm(xs, jnp.asarray(g), interpret=True))
    s, h = add_rmsnorm_reference(_to_torch(_jax_bf16(x)), _to_torch(_jax_bf16(delta)),
                                 torch.from_numpy(g))
    assert s.dtype == h.dtype == torch.bfloat16
    want_s = _to_torch(xs)
    assert bool(((s.float() - want_s.float()).abs() <= _bf16_ulp(want_s)).all())
    err = (h.float() - want.float()).abs()
    assert bool((err <= _bf16_ulp(want)).all()), float(err.max())


def test_add_without_delta_returns_x_itself():
    x, g = (torch.from_numpy(a) for a in _inputs((5, 32), 7))
    for fn in (add_rmsnorm, add_rmsnorm_reference):
        s, h = fn(x, None, g)
        assert s is x
        assert torch.equal(h, rmsnorm_reference(x, g))


def test_add_wrapper_takes_the_plain_version_on_cpu_without_a_launch():
    x, delta, g = (torch.from_numpy(a) for a in _add_inputs((5, 32), 8))
    before = (rmsnorm.launches, add_rmsnorm.launches)
    s, h = add_rmsnorm(x, delta, g)
    want_s, want_h = add_rmsnorm_reference(x, delta, g)
    assert torch.equal(s, want_s) and torch.equal(h, want_h)
    add_rmsnorm(x, None, g)
    assert (rmsnorm.launches, add_rmsnorm.launches) == before
