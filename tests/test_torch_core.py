"""Host-side core of the port (numpy) against the reference package: the
same models and metric samples give exactly equal fits, flow predictions
and allocations on all five workloads."""
import dataclasses

import numpy as np
import pytest

import repro.core as ref
import repro.streams as ref_streams
import repro_torch.core as port
import repro_torch.streams as port_streams
from repro_torch.interop import node_models_from_state

WORKLOADS = list(ref_streams.WORKLOADS)
SM_COST = 1.0 / 724.0


def _model_state(model) -> dict:
    state = dataclasses.asdict(model)
    state["resource_class"] = model.resource_class.value
    return state


def _models_equal(a: dict, b: dict) -> None:
    assert sorted(a) == sorted(b)
    for name in a:
        assert _model_state(a[name]) == _model_state(b[name]), name


def _port_models(ref_models: dict) -> dict:
    return node_models_from_state(
        {k: dataclasses.asdict(m) for k, m in ref_models.items()}
    )


def _dags(name):
    return ref_streams.WORKLOADS[name](), port_streams.WORKLOADS[name]()


def _synthetic_store(module, dag, seed: int):
    """Heron-style samples made with numpy from a seed: per-node linear CPU
    and capacity relations with noise, a GC sawtooth, and backpressure on
    the hottest samples of every third node."""
    rng = np.random.default_rng(seed)
    store = module.MetricsStore()
    names = list(dag.node_names) + [module.STREAM_MANAGER]
    for j, name in enumerate(names):
        cost = 1.0 / rng.uniform(300.0, 1500.0)
        io = rng.uniform(0.0, 0.5) if j % 2 else 0.0
        for inst in range(2):
            n = 24
            rate = np.linspace(20.0, 0.95 / cost, n) * rng.uniform(0.9, 1.1)
            cap = cost * rate + rng.normal(0.0, 0.01, n)
            cpu = cap * (1.0 - io) * 1.12 + rng.normal(0.0, 0.01, n)
            mem = 128.0 + 0.3 * rate + 40.0 * (np.arange(n) % 5)
            bp = np.zeros(n)
            if j % 3 == 0:
                bp[-3:] = 0.5
            store.add(module.InstanceSamples(
                node=name, container=inst, slot=inst,
                rate_in_ktps=rate, rate_out_ktps=rate * rng.uniform(0.3, 1.0),
                cputil=cpu, caputil=cap, memutil_mb=mem,
                gctime=np.where(np.arange(n) % 5 == 4, 0.05, 0.0),
                backpressure=bp,
            ))
    return store


def _port_store(store):
    out = port.MetricsStore()
    for s in store.samples:
        out.add(port.InstanceSamples(**dataclasses.asdict(s)))
    return out


@pytest.mark.parametrize("name", WORKLOADS)
def test_fit_workload_equal(name):
    dag_r, _ = _dags(name)
    store = _synthetic_store(ref, dag_r, seed=len(name))
    _models_equal(ref.fit_workload(store), port.fit_workload(_port_store(store)))


@pytest.mark.parametrize("name", WORKLOADS)
def test_oracle_models_equal_and_carry_over(name):
    dag_r, dag_t = _dags(name)
    om = ref.oracle_models(dag_r, SM_COST)
    _models_equal(om, port.oracle_models(dag_t, SM_COST))
    _models_equal(om, _port_models(om))


def _solution_fields(sol) -> tuple:
    return (sol.rate_ktps, sol.status, sol.instance_rates, sol.sm_traversals,
            sol.cross_container_ktps, sol.bottlenecks)


@pytest.mark.parametrize("name", WORKLOADS)
def test_solve_flow_equal(name):
    dag_r, dag_t = _dags(name)
    models_r = ref.oracle_models(dag_r, SM_COST)
    models_t = _port_models(models_r)
    dim_r, dim_t = ref.ContainerDim(3.0, 4096.0), port.ContainerDim(3.0, 4096.0)
    for i, n_cont in enumerate((1, 2, 3)):
        par = {n: 1 + (i + j) % 2 for j, n in enumerate(dag_r.node_names)}
        cfg_r = ref.round_robin_configuration(dag_r, par, n_cont, dim_r)
        cfg_t = port.round_robin_configuration(dag_t, par, n_cont, dim_t)
        assert cfg_r.packing == cfg_t.packing
        sol_r = ref.solve_flow(cfg_r, models_r)
        sol_t = port.solve_flow(cfg_t, models_t)
        assert _solution_fields(sol_r) == _solution_fields(sol_t)
        assert ref.classify_bound(sol_r) == port.classify_bound(sol_t)


def _allocation_fields(res) -> tuple:
    dims = tuple(dataclasses.astuple(d) for d in res.config.dims)
    templates = tuple(
        (t.nodes, t.counts, t.rate_ktps, dataclasses.astuple(t.dim),
         t.sm_traversal_factor, t.replicas)
        for t in res.templates
    )
    return (res.config.packing, dims, templates, res.target_rate_ktps,
            res.predicted_node_rates, res.total_cpus, res.total_mem_mb)


@pytest.mark.parametrize("name", WORKLOADS)
def test_allocate_equal(name):
    dag_r, dag_t = _dags(name)
    models_r = ref.oracle_models(dag_r, SM_COST)
    models_t = _port_models(models_r)
    for target, over in ((400.0, 1.0), (2500.0, 1.1)):
        a = ref.allocate(dag_r, models_r, target, overprovision=over)
        b = port.allocate(dag_t, models_t, target, overprovision=over)
        assert _allocation_fields(a) == _allocation_fields(b)
    dims_r = [ref.ContainerDim(2.0, 2048.0), ref.ContainerDim(4.0, 8192.0)]
    dims_t = [port.ContainerDim(2.0, 2048.0), port.ContainerDim(4.0, 8192.0)]
    a = ref.allocate(dag_r, models_r, 900.0, candidate_dims=dims_r)
    b = port.allocate(dag_t, models_t, 900.0, candidate_dims=dims_t)
    assert _allocation_fields(a) == _allocation_fields(b)


@pytest.mark.parametrize("name", WORKLOADS)
def test_allocate_under_budget_equal(name):
    dag_r, dag_t = _dags(name)
    models_r = ref.oracle_models(dag_r, SM_COST)
    models_t = _port_models(models_r)
    for cpus in (1e9, 12.0, 0.5):
        a = ref.allocate_under_budget(dag_r, models_r, 3000.0, ref.ResourceBudget(cpus=cpus))
        b = port.allocate_under_budget(dag_t, models_t, 3000.0, port.ResourceBudget(cpus=cpus))
        assert (a.feasible_rate_ktps, a.shortfall_ktps, a.fits, a.degraded) == (
            b.feasible_rate_ktps, b.shortfall_ktps, b.fits, b.degraded
        )
        assert _allocation_fields(a.result) == _allocation_fields(b.result)


@pytest.mark.parametrize("name", WORKLOADS)
def test_workload_dags_equal(name):
    dag_r, dag_t = _dags(name)
    assert dag_r.name == dag_t.name
    assert [dataclasses.astuple(dataclasses.replace(n, fn=None)) for n in dag_r.nodes] == [
        dataclasses.astuple(n) for n in dag_t.nodes
    ]
    assert [(e.src, e.dst, e.grouping.value) for e in dag_r.edges] == [
        (e.src, e.dst, e.grouping.value) for e in dag_t.edges
    ]
    assert all(n.fn is None for n in dag_t.nodes)
