"""The port's batched simplex (``torch_linprog``) and batched node fit
(``fit_many_torch``) against the reference's ``jax_linprog`` /
``fit_many_jax`` and the numpy ``linprog`` on the CPU."""
import jax
import numpy as np
import pytest
import torch

import repro.core.lp as ref_lp
from repro.core.node_model import fit_many_jax
from repro_torch.core import ContainerDim, allocate, build_flow_problem, oracle_models
from repro_torch.core import lp
from repro_torch.core.node_model import fit_many_torch
from repro_torch.streams import SimParams, adanalytics, wordcount

#: float32 tableau against the float64 oracles (``tests/test_lp.py``'s
#: tolerance for the JAX simplex)
F32_REL, F32_ABS = 2e-4, 1e-5


def _random_problem(rng, n, m_ub, m_eq, feasible=True):
    """``tests/test_lp.py::_random_problem``."""
    c = rng.normal(size=n)
    A_ub = rng.normal(size=(m_ub, n))
    b_ub = rng.uniform(0.5, 3.0, size=m_ub)
    A_eq = rng.normal(size=(m_eq, n)) if m_eq else None
    b_eq = None
    if m_eq:
        x0 = rng.uniform(0, 1, size=n)
        b_eq = A_eq @ x0
        if feasible:
            b_ub = np.maximum(b_ub, A_ub @ x0 + 0.1)
    return c, A_ub, b_ub, A_eq, b_eq


def _seeded(seed):
    rng = np.random.default_rng(100 + seed)
    n = int(rng.integers(2, 7))
    m_ub = int(rng.integers(1, 5))
    m_eq = int(rng.integers(0, 3))
    c, A_ub, b_ub, A_eq, b_eq = _random_problem(rng, n, m_ub, m_eq)
    A_eq = A_eq if A_eq is not None else np.zeros((0, n))
    b_eq = b_eq if b_eq is not None else np.zeros((0,))
    return c, A_ub, b_ub, A_eq, b_eq


@pytest.mark.parametrize("seed", range(10))
def test_matches_jax_simplex_and_numpy_on_seeded_problems(seed):
    c, A_ub, b_ub, A_eq, b_eq = _seeded(seed)
    x, fun, status = lp.torch_linprog(c, A_ub, b_ub, A_eq, b_eq, device="cpu")
    assert x.shape == (c.shape[0],) and fun.shape == () and status.dtype == torch.int32
    assert x.dtype == fun.dtype == torch.float32
    xj, fj, sj = ref_lp.jax_linprog(c, A_ub, b_ub, A_eq, b_eq)
    ref = lp.linprog(c, A_ub=A_ub, b_ub=b_ub, A_eq=A_eq, b_eq=b_eq)
    assert int(status) == int(sj) == ref.status
    if ref.status == lp.STATUS_OPTIMAL:
        assert float(fun) == pytest.approx(ref.fun, rel=F32_REL, abs=F32_ABS)
        assert float(fun) == pytest.approx(float(fj), rel=F32_REL, abs=F32_ABS)
        np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=F32_REL, atol=F32_ABS)
        # float64 agrees with numpy to rounding
        x64, f64, s64 = lp.torch_linprog(c, A_ub, b_ub, A_eq, b_eq, dtype=torch.float64,
                                         device="cpu")
        assert int(s64) == lp.STATUS_OPTIMAL and x64.dtype == torch.float64
        assert float(f64) == pytest.approx(ref.fun, rel=1e-9, abs=1e-12)


def _bench_problem():
    """``benchmarks/bench_speed.py``'s 24-variable LP."""
    rng = np.random.default_rng(0)
    n, m = 24, 16
    c = rng.normal(size=n)
    A = np.abs(rng.normal(size=(m, n))) + 0.05
    b = rng.uniform(1, 4, size=m)
    return rng, c, A, b


def test_batch_rows_match_vmapped_jax_and_their_own_unbatched_solves():
    rng, c, A, b = _bench_problem()
    B = 64
    bs = np.tile(b, (B, 1)) * rng.uniform(0.8, 1.2, size=(B, 1))
    cs = c[None] * rng.uniform(0.5, 1.5, size=(B, c.shape[0]))
    bs[3] = -1.0                                   # one infeasible row in the batch
    cs[5] = -np.abs(cs[5])                         # bounded: A > 0, b > 0
    A_eq, b_eq = np.zeros((0, c.shape[0])), np.zeros((B, 0))
    x, fun, status = lp.torch_linprog(cs, A, bs, A_eq, b_eq, device="cpu")
    assert x.shape == (B, c.shape[0]) and fun.shape == status.shape == (B,)
    xj, fj, sj = jax.vmap(lambda cc, bb: ref_lp.jax_linprog(cc, A, bb, A_eq, np.zeros(0)))(cs, bs)
    np.testing.assert_array_equal(status.numpy(), np.asarray(sj))
    assert int(status[3]) == lp.STATUS_INFEASIBLE and int((status == 0).sum()) == B - 1
    ok = status.numpy() == 0
    np.testing.assert_allclose(fun.numpy()[ok], np.asarray(fj)[ok], rtol=F32_REL, atol=F32_ABS)
    np.testing.assert_allclose(x.numpy()[ok], np.asarray(xj)[ok], rtol=F32_REL, atol=F32_ABS)
    for i in range(B):
        xi, fi, si = lp.torch_linprog(cs[i], A, bs[i], A_eq, np.zeros(0), device="cpu")
        assert int(si) == int(status[i])
        assert torch.equal(xi.nan_to_num(7.0), x[i].nan_to_num(7.0))
        assert torch.equal(fi.nan_to_num(7.0), fun[i].nan_to_num(7.0))
        if ok[i]:
            ref = lp.linprog(cs[i], A_ub=A, b_ub=bs[i])
            assert float(fi) == pytest.approx(ref.fun, rel=F32_REL, abs=F32_ABS)


def test_batch_axis_on_any_of_c_b_ub_b_eq():
    c, A_ub, b_ub, A_eq, b_eq = _seeded(2)
    assert A_eq.shape[0] > 0
    _, f0, s0 = lp.torch_linprog(c, A_ub, b_ub, A_eq, b_eq, device="cpu")
    for args in ((np.stack([c, c]), A_ub, b_ub, A_eq, b_eq),
                 (c, A_ub, np.stack([b_ub, b_ub]), A_eq, b_eq),
                 (c, A_ub, b_ub, A_eq, np.stack([b_eq, b_eq]))):
        x, f, s = lp.torch_linprog(*args, device="cpu")
        assert x.shape == (2, c.shape[0])
        assert torch.equal(f, torch.stack([f0, f0])) and torch.equal(s, torch.stack([s0, s0]))


def test_infeasible_unbounded_and_maxiter_statuses():
    one = np.array([1.0])
    cases = [
        # x = 5 required but x <= -1: infeasible
        ((one, np.array([[1.0]]), np.array([-1.0]), np.array([[1.0]]), np.array([5.0])),
         lp.STATUS_INFEASIBLE),
        # minimize -x, -x <= 1: unbounded
        ((-one, np.array([[-1.0]]), one, np.zeros((0, 1)), np.zeros(0)), lp.STATUS_UNBOUNDED),
    ]
    for args, want in cases:
        x, fun, status = lp.torch_linprog(*args, device="cpu")
        _, fj, sj = ref_lp.jax_linprog(*args)
        assert int(status) == int(sj) == want
        assert bool(torch.isnan(x).all())
        if want == lp.STATUS_UNBOUNDED:
            assert float(fun) == float(fj) == -np.inf
        else:
            assert np.isnan(float(fun)) and np.isnan(float(fj))
    _, c, A, b = _bench_problem()
    A_eq, b_eq = np.zeros((0, c.shape[0])), np.zeros(0)
    _, _, s_full = lp.torch_linprog(c, A, b, A_eq, b_eq, device="cpu")
    _, fun, status = lp.torch_linprog(c, A, b, A_eq, b_eq, maxiter=1, device="cpu")
    _, _, sj = ref_lp.jax_linprog(c, A, b, A_eq, b_eq, maxiter=1)
    assert int(s_full) == lp.STATUS_OPTIMAL
    assert int(status) == int(sj) == lp.STATUS_MAXITER and np.isnan(float(fun))


@pytest.mark.parametrize("make_dag,target", [(wordcount, 300.0), (wordcount, 900.0),
                                             (adanalytics, 150.0), (adanalytics, 400.0)])
def test_float64_flow_lp_matches_numpy(make_dag, target):
    """The flow LP of a small allocation in float64: the rate to rel 1e-9,
    and the same batched eight ways with scaled capacities."""
    dag = make_dag()
    models = oracle_models(dag, SimParams().sm_cost_per_ktuple)
    cfg = allocate(dag, models, target, preferred_dim=ContainerDim(3.0, 4096.0)).config
    prob = build_flow_problem(cfg, models)
    ref = lp.linprog_maximize(prob.c, A_ub=prob.A_ub, b_ub=prob.b_ub, A_eq=prob.A_eq,
                              b_eq=prob.b_eq)
    assert ref.status == lp.STATUS_OPTIMAL
    x, fun, status = lp.torch_linprog(-prob.c, prob.A_ub, prob.b_ub, prob.A_eq, prob.b_eq,
                                      maxiter=4096, dtype=torch.float64, device="cpu")
    assert int(status) == lp.STATUS_OPTIMAL
    assert -float(fun) == pytest.approx(ref.fun, rel=1e-9)
    assert (x.numpy() >= -1e-9).all()
    assert (prob.A_ub @ x.numpy() <= prob.b_ub + 1e-6).all()
    scale = np.random.default_rng(1).uniform(0.9, 1.1, size=(8, 1))
    _, funs, statuses = lp.torch_linprog(-prob.c, prob.A_ub, prob.b_ub[None] * scale, prob.A_eq,
                                         prob.b_eq, maxiter=4096, dtype=torch.float64,
                                         device="cpu")
    for i in range(8):
        r = lp.linprog_maximize(prob.c, A_ub=prob.A_ub, b_ub=prob.b_ub * scale[i, 0],
                                A_eq=prob.A_eq, b_eq=prob.b_eq)
        assert int(statuses[i]) == r.status == lp.STATUS_OPTIMAL
        assert -float(funs[i]) == pytest.approx(r.fun, rel=1e-9)


def test_torch_linprog_needs_the_card_unless_told():
    c, A_ub, b_ub, A_eq, b_eq = _seeded(0)
    if torch.cuda.is_available():
        x, _, _ = lp.torch_linprog(c, A_ub, b_ub, A_eq, b_eq)
        assert x.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        lp.torch_linprog(c, A_ub, b_ub, A_eq, b_eq)
    with pytest.raises(RuntimeError, match="CUDA"):
        fit_many_torch(np.ones((1, 3)), np.ones((1, 3)))


def test_fit_many_matches_jax_including_the_guards():
    rng = np.random.default_rng(3)
    nodes, samples = 12, 64
    rate = rng.uniform(10.0, 900.0, size=(nodes, samples))
    y = 0.002 * rate + 0.05 + rng.normal(scale=0.01, size=(nodes, samples))
    rate[3] = 250.0                       # no rate variance: slope 0
    y[5] = 0.7                            # no value variance: r2 1
    rate[7], y[7] = 100.0, 0.3            # neither
    got = fit_many_torch(rate, y, device="cpu")
    want = fit_many_jax(rate, y)
    for g in got:
        assert g.dtype == torch.float32 and g.shape == (nodes,)
    # slope and r2 to rel 1e-6 (a constant row's slope is a rounding residue
    # near 1e-17 in both, hence the 1e-12 floor); the intercept ``ym - slope
    # * xm`` cancels two terms near max|y| (float32 sums taken in another
    # order), so it is held to 1e-6 of that scale
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=1e-6, atol=0)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0,
                               atol=1e-6 * np.abs(y).max())
    slope, intercept, r2 = (t.numpy() for t in got)
    assert slope[3] == 0.0 and slope[7] == 0.0 and r2[5] == 1.0 and r2[7] == 1.0
    assert intercept[3] == pytest.approx(y[3].mean(), rel=1e-6)
    # against numpy's float64 least squares on the rows that vary
    for i in (0, 1, 2):
        a, b0 = np.polyfit(rate[i], y[i], 1)
        assert slope[i] == pytest.approx(a, rel=1e-4)
        assert intercept[i] == pytest.approx(b0, rel=1e-4)
