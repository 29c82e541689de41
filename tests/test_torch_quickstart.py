"""The whole slice — profile, fit, predict, allocate, verify — on
``deep_pipeline``, in the reference package and in the port, on the CPU.

At ``noise_std=0`` both packages see the same physics, so the fitted
models, the predictions and the allocation agree.  With noise on, the port
draws its noise from a ``torch.Generator`` and the reference from
``jax.random``: the two streams differ, so only the distribution of the
outcome can agree, and the capacities are compared within 5%.
"""
import dataclasses

import numpy as np
import pytest

import repro.core as ref_core
import repro.streams as ref
import repro_torch.core as port_core
import repro_torch.streams as port

TARGET = 500.0
RATES = np.linspace(25, 150, 6)


def _workflow(core, streams, noise_std, **device):
    """Quickstart steps 1-6; returns models, predictions, allocation and
    the allocation's measured capacity."""
    dag = streams.deep_pipeline()
    params = streams.SimParams(noise_std=noise_std)
    dim = core.ContainerDim(cpus=3.0, mem_mb=4096.0)
    test_cfg = core.round_robin_configuration(dag, {n: 1 for n in dag.node_names}, 2, dim)
    store = streams.training_sweep(test_cfg, RATES, params, seconds_per_rate=6.0, **device)
    models = core.fit_workload(store)
    unseen = [
        core.round_robin_configuration(dag, {n: 2 for n in dag.node_names}, 4, dim),
        core.round_robin_configuration(
            dag, {n: 2 if n in ("transform", "aggregate") else 1 for n in dag.node_names}, 3, dim
        ),
    ]
    preds = [core.solve_flow(c, models).rate_ktps for c in unseen]
    result = core.allocate(dag, models, TARGET, overprovision=1.1)
    achieved = streams.measure_capacity(result.config, params, duration_s=6.0, **device)
    return models, preds, result, achieved


@pytest.fixture(scope="module")
def noiseless():
    return (_workflow(ref_core, ref, 0.0),
            _workflow(port_core, port, 0.0, device="cpu"))


def test_fitted_models_match(noiseless):
    (models_r, *_), (models_t, *_) = noiseless
    assert sorted(models_r) == sorted(models_t)
    for name in models_r:
        a, b = models_r[name], models_t[name]
        assert b.peak_rate_ktps == pytest.approx(a.peak_rate_ktps, rel=1e-3), name
        assert b.gamma == pytest.approx(a.gamma, rel=1e-3, abs=1e-6), name
        assert b.resource_class.value == a.resource_class.value, name


def test_predictions_match(noiseless):
    (_, preds_r, *_), (_, preds_t, *_) = noiseless
    np.testing.assert_allclose(preds_t, preds_r, rtol=1e-3)


def test_allocation_matches_and_meets_its_capacity(noiseless):
    (*_, res_r, ach_r), (*_, res_t, ach_t) = noiseless
    assert res_t.config.packing == res_r.config.packing
    assert res_t.config.n_containers <= 32
    assert sum(map(len, res_t.config.packing)) <= 32
    # container sizes are continuous functions of the fitted models
    for a, b in zip(res_r.config.dims, res_t.config.dims):
        np.testing.assert_allclose(dataclasses.astuple(b), dataclasses.astuple(a), rtol=1e-3)
    assert ach_t == pytest.approx(ach_r, rel=1e-3)
    assert ach_t > 0.9 * TARGET


def test_noisy_capacity_agrees_in_distribution():
    _, _, res_r, ach_r = _workflow(ref_core, ref, 0.03)
    _, _, res_t, ach_t = _workflow(port_core, port, 0.03, device="cpu")
    assert ach_t == pytest.approx(ach_r, rel=0.05)
    # the same deployment, measured by both simulators
    cfg_t = port_core.Configuration(
        port.deep_pipeline(), res_r.config.packing,
        tuple(port_core.ContainerDim(*dataclasses.astuple(d)) for d in res_r.config.dims),
    )
    same = port.measure_capacity(cfg_t, port.SimParams(), duration_s=6.0, device="cpu")
    assert same == pytest.approx(ach_r, rel=0.05)
