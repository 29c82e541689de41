"""The port's selective scan: its plain version against the reference
package's jnp oracle (``ssm_scan_reference``) and its Pallas kernel in
interpret mode, at the shapes of the reference's own kernel tests, and the
wrapper's CPU path.  The CUDA kernel's own tests are in
``test_torch_cuda_kernels.py``.

Tolerance: fp32 within 1e-5 (rtol and atol), bf16 inputs within 3e-2, as
the reference's kernel tests hold its Pallas kernel to its oracle.  Both
sides convert to fp32 and run the same recurrence; the sum over the state
width runs in another order."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssm_scan import ssm_scan as jax_ssm_scan
from repro.kernels.ssm_scan import ssm_scan_reference as jax_ssm_scan_reference
from repro_torch.kernels.ssm_scan import ssm_scan, ssm_scan_reference

SHAPES = [
    # (B, S, D, N, chunk, block_d) of the reference's kernel tests
    (2, 64, 32, 8, 16, 16),
    (1, 128, 64, 16, 32, 32),
    (2, 100, 48, 4, 32, 16),   # S and D not multiples of the Pallas tiles
    (1, 32, 16, 16, 32, 16),
]
TOL = {"float32": 1e-5, "bfloat16": 3e-2}


def _inputs(B, S, D, N, seed):
    """Seeded numpy inputs in the ranges the Mamba block feeds the scan:
    softplus'd step sizes, a negative decay, a non-zero initial state."""
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.normal(size=(B, S, D)))) * 0.1
    x = rng.normal(size=(B, S, D))
    bm = rng.normal(size=(B, S, N)) * 0.5
    cm = rng.normal(size=(B, S, N)) * 0.5
    a = -np.exp(rng.normal(size=(D, N)) * 0.3)
    h0 = rng.normal(size=(B, D, N)) * 0.1
    return [v.astype(np.float32) for v in (dt, x, bm, cm, a, h0)]


def _both(arrays, dtype):
    """The inputs for each package: dt, x, B and C in ``dtype`` (rounded to
    bf16 the same way in both), a and h0 in fp32."""
    jd, td = {"float32": (jnp.float32, torch.float32),
              "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    j = [jnp.asarray(v).astype(jd) for v in arrays[:4]] + [jnp.asarray(v) for v in arrays[4:]]
    t = [torch.from_numpy(v).to(td) for v in arrays[:4]] + [torch.from_numpy(v) for v in arrays[4:]]
    return j, t


def _close(got, want, tol):
    torch.testing.assert_close(got, torch.from_numpy(np.array(want)), rtol=tol, atol=tol)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_jax_oracle(shape, dtype):
    B, S, D, N, _, _ = shape
    j, t = _both(_inputs(B, S, D, N, seed=S + D + N), dtype)
    wy, wh = jax_ssm_scan_reference(*j)
    y, h = ssm_scan_reference(*t)
    assert y.shape == (B, S, D) and h.shape == (B, D, N)
    assert y.dtype == h.dtype == torch.float32
    _close(y, wy, TOL[dtype])
    _close(h, wh, TOL[dtype])


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_kernel(shape, dtype):
    B, S, D, N, chunk, block_d = shape
    j, t = _both(_inputs(B, S, D, N, seed=7 * S + N), dtype)
    wy, wh = jax_ssm_scan(*j, chunk=chunk, block_d=block_d, interpret=True)
    y, h = ssm_scan(*t)
    _close(y, wy, TOL[dtype])
    _close(h, wh, TOL[dtype])


@pytest.mark.parametrize("S", [1, 7])
def test_short_sequences_and_zero_state_match_jax_oracle(S):
    """S = 1 is the decode step; a zero h0 is the prefill's start."""
    arrays = _inputs(3, S, 20, 16, seed=S)
    arrays[5] = np.zeros_like(arrays[5])
    j, t = _both(arrays, "float32")
    wy, wh = jax_ssm_scan_reference(*j)
    y, h = ssm_scan(*t)
    _close(y, wy, TOL["float32"])
    _close(h, wh, TOL["float32"])


def test_strided_projections_give_the_same_result():
    """B and C arrive as slices of the x_proj output, not contiguous."""
    B, S, D, N = 2, 9, 24, 8
    dt, x, bm, cm, a, h0 = map(torch.from_numpy, _inputs(B, S, D, N, seed=3))
    proj = torch.cat([torch.zeros(B, S, 5), bm, cm], dim=-1)
    _, bv, cv = proj.split([5, N, N], dim=-1)
    assert not bv.is_contiguous() and not cv.is_contiguous()
    y, h = ssm_scan(dt, x, bv, cv, a, h0)
    want_y, want_h = ssm_scan_reference(dt, x, bm, cm, a, h0)
    assert torch.equal(y, want_y) and torch.equal(h, want_h)


def test_wrapper_takes_the_plain_version_on_cpu_without_a_launch():
    dt, x, bm, cm, a, h0 = map(torch.from_numpy, _inputs(1, 12, 16, 4, seed=11))
    before = ssm_scan.launches
    y, h = ssm_scan(dt, x, bm, cm, a, h0)
    want_y, want_h = ssm_scan_reference(dt, x, bm, cm, a, h0)
    assert torch.equal(y, want_y) and torch.equal(h, want_h)
    assert ssm_scan.launches == before
    assert torch.equal(h0, torch.from_numpy(_inputs(1, 12, 16, 4, seed=11)[5]))   # h0 not written
