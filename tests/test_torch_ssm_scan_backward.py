"""The plain backward of the selective scan
(``ref.py::ssm_scan_backward_reference``, the contract of the CUDA backward
kernel) against ``jax.vjp`` of the reference package's own oracle
(``repro.kernels.ssm_scan.ref.ssm_scan_reference``), against autograd
through the port's plain forward, and the wrapper's CPU path.

Tolerance: fp32 rtol 1e-5, atol 1e-5·max|want| per gradient.  Both sides
run the same recurrence in fp32; the reference's ``lax.scan`` and
autograd order the sums over channels, states, steps and batch rows
otherwise than the written-out reverse recurrence."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.kernels.ssm_scan.ref import ssm_scan_reference as jax_ssm_scan_reference
from repro_torch.kernels.ssm_scan import (
    ssm_scan_backward,
    ssm_scan_backward_reference,
    ssm_scan_reference,
)

RTOL = ATOL_REL = 1e-5
NAMES = ("ddt", "dx", "dB", "dC", "dA", "dh0")


def _inputs(B, S, D, N, seed, h0_scale=0.1):
    """Seeded numpy inputs in the Mamba block's ranges (softplus'd steps, a
    negative decay) and the two output gradients."""
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.normal(size=(B, S, D)))) * 0.1
    x = rng.normal(size=(B, S, D))
    bm = rng.normal(size=(B, S, N)) * 0.5
    cm = rng.normal(size=(B, S, N)) * 0.5
    a = -np.exp(rng.normal(size=(D, N)) * 0.3)
    h0 = rng.normal(size=(B, D, N)) * h0_scale
    dy = rng.normal(size=(B, S, D))
    dhT = rng.normal(size=(B, D, N))
    return [v.astype(np.float32) for v in (dt, x, bm, cm, a, h0, dy, dhT)]


def _close(got, want, what):
    for g, w, name in zip(got, want, NAMES):
        w = torch.as_tensor(np.array(w))
        assert g.dtype == torch.float32 and g.shape == w.shape, f"{what} {name}"
        top = float(w.abs().max()) if w.numel() else 0.0
        torch.testing.assert_close(g, w, rtol=RTOL, atol=ATOL_REL * top,
                                   msg=lambda m: f"{what} {name}: {m}")


def _plain(arrays, with_dhT):
    t = [torch.from_numpy(v) for v in arrays]
    return ssm_scan_backward_reference(*t[:6], t[6], t[7] if with_dhT else None)


CASES = {
    "jamba-like": (2, 64, 32, 16),
    "s-not-32": (1, 70, 24, 16),
    "s1": (2, 1, 16, 16),
    "n4": (2, 37, 20, 4),
    "n7": (1, 33, 12, 7),
    "d-odd": (3, 20, 45, 8),
}


@pytest.mark.parametrize("with_dhT", [True, False])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_backward_matches_jax_vjp_of_the_reference(case, with_dhT):
    """Every gradient, with a non-zero h0 and, for ``with_dhT``, a non-zero
    gradient of the final state (else its cotangent is zero)."""
    B, S, D, N = CASES[case]
    arrays = _inputs(B, S, D, N, seed=len(case) + 10 * with_dhT)
    dt, x, bm, cm, a, h0, dy, dhT = (jnp.asarray(v) for v in arrays)
    grads = jax.jit(lambda *ins: jax.vjp(jax_ssm_scan_reference, *ins)[1](
        (dy, dhT if with_dhT else jnp.zeros_like(dhT))))
    _close(_plain(arrays, with_dhT), grads(dt, x, bm, cm, a, h0), case)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_backward_matches_autograd_through_the_plain_forward(case):
    B, S, D, N = CASES[case]
    arrays = _inputs(B, S, D, N, seed=len(case) + 1)
    leaves = [torch.from_numpy(v).requires_grad_(True) for v in arrays[:6]]
    y, hT = ssm_scan_reference(*leaves)
    torch.autograd.backward((y, hT), (torch.from_numpy(arrays[6]), torch.from_numpy(arrays[7])))
    _close(_plain(arrays, True), [t.grad for t in leaves], case)


def test_wrapper_runs_the_plain_backward_on_cpu_tensors():
    """On CPU tensors the wrapper is the plain backward, bit for bit, with
    each gradient in its input's dtype (bf16 dt, x, B and C; fp32 a and
    h0), B and C as strided slices of one projection, as the Mamba block
    passes them; it counts no launch."""
    before = ssm_scan_backward.launches
    B, S, D, N = 2, 21, 12, 16
    arrays = _inputs(B, S, D, N, seed=7)
    rng = np.random.default_rng(8)
    proj = torch.from_numpy(rng.normal(size=(B, S, 3 + 2 * N)).astype(np.float32))
    _, bm, cm = proj.split([3, N, N], dim=-1)
    for dtype in (torch.float32, torch.bfloat16):
        dt, x = (torch.from_numpy(v).to(dtype) for v in arrays[:2])
        a, h0, dy = (torch.from_numpy(v) for v in (arrays[4], arrays[5], arrays[6]))
        args = (dt, x, bm.to(dtype), cm.to(dtype), a, h0, dy, None)
        got = ssm_scan_backward(*args)
        want = ssm_scan_backward_reference(*args)
        for g, w, like in zip(got, want, args):
            assert g.dtype == like.dtype and g.shape == like.shape and torch.equal(g, w)
    assert ssm_scan_backward.launches == before


@settings(max_examples=40, deadline=None)
@given(B=st.integers(1, 3), S=st.integers(0, 45), D=st.integers(1, 20), N=st.integers(1, 16),
       with_dhT=st.booleans(), seed=st.integers(0, 2**16))
def test_plain_backward_matches_autograd_over_shapes(B, S, D, N, with_dhT, seed):
    """Any batch, length (S = 0 too: dh0 is dhT, the rest zero or empty),
    channel count and state width up to the kernel's 16, against autograd
    through the port's plain forward, which the cases above hold to the
    reference."""
    arrays = _inputs(B, S, D, N, seed=seed)
    leaves = [torch.from_numpy(v).requires_grad_(True) for v in arrays[:6]]
    y, hT = ssm_scan_reference(*leaves)
    dhT = torch.from_numpy(arrays[7]) if with_dhT else torch.zeros_like(hT)
    outs = [(o, g) for o, g in ((y, torch.from_numpy(arrays[6])), (hT, dhT))
            if o.requires_grad]     # at S = 0 the plain y is a constant
    want = torch.autograd.grad([o for o, _ in outs], leaves, [g for _, g in outs],
                               allow_unused=True)
    want = [torch.zeros_like(t) if w is None else w for w, t in zip(want, leaves)]
    _close(_plain(arrays, with_dhT), want, f"B={B} S={S} D={D} N={N} dhT={with_dhT}")


def test_backward_library_is_built_from_its_own_source():
    """The backward kernel is a library of its own, keyed by its source:
    ``build/kernels/ssm_scan_bwd-<hash>.so`` beside the forward's, nothing
    built when the module is imported."""
    from repro_torch.kernels._build import BUILD_DIR
    from repro_torch.kernels.ssm_scan.ops import BACKWARD_LIBRARY, LIBRARY

    path = BACKWARD_LIBRARY.library_path()
    assert path.parent == BUILD_DIR and path.name.startswith("ssm_scan_bwd-")
    assert BACKWARD_LIBRARY.source.name == "ssm_scan_bwd.cu"
    assert BACKWARD_LIBRARY.source.parent == LIBRARY.source.parent
    assert path != LIBRARY.library_path() and BACKWARD_LIBRARY._lib is None
