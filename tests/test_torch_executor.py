"""The port's executor, ``ExecutorEvaluator`` and ``fold_executor_timings``
against the reference package on the CPU.

Timings depend on the machine, so parity is on structure (timed nodes,
tuple counts, calibrated-DAG fields) and, with the sources of both packages
replaced by one fixed-batch source, on every node's outputs.  The evaluator
and the fold are held to the reference's field for field under one
deterministic ``calibrate_dag`` stub per package."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.control as ref_control
import repro.core as ref_core
import repro.streams as ref
import repro.streams.executor as ref_exec
import repro_torch.control as port_control
import repro_torch.core as port_core
import repro_torch.streams as port
import repro_torch.streams.executor as port_exec

PAPER = ("wordcount", "adanalytics", "mobile_analytics")
FLOAT_RTOL = 1e-6
PARAMS_SM = port.SimParams().sm_cost_per_ktuple


# ---------------------------------------------------------------- run_dag


@pytest.mark.parametrize("name", PAPER + ("diamond",))
def test_run_dag_times_the_reference_nodes_and_counts(name):
    got = port_exec.run_dag(port.WORKLOADS[name](), n_batches=3, device="cpu")
    want = ref_exec.run_dag(ref.WORKLOADS[name](), n_batches=3)
    assert list(got.per_node_us_per_tuple) == list(want.per_node_us_per_tuple)
    assert got.tuples_processed == want.tuples_processed
    assert sorted(got.outputs) == sorted(want.outputs)
    assert all(v > 0 for v in got.per_node_us_per_tuple.values())
    costs = got.cost_per_ktuple_seconds()
    assert costs == {k: v * 1e-3 for k, v in got.per_node_us_per_tuple.items()}


def test_run_dag_runs_real_operators():
    report = port_exec.run_dag(port.wordcount(), n_batches=5, device="cpu")
    assert report.tuples_processed == 5 * 2048
    assert {"W", "C"} <= set(report.per_node_us_per_tuple)
    # the counting consumer counted: its running counts reach past one batch
    assert report.outputs["C"]["value"].dtype == torch.int32
    assert int(report.outputs["C"]["value"].max()) > 1


def test_run_dag_times_every_operator_of_adanalytics():
    report = port_exec.run_dag(port.adanalytics(), n_batches=3, device="cpu")
    assert {"ads", "event_deserializer", "event_filter"} <= set(report.per_node_us_per_tuple)


@pytest.mark.parametrize("floor", [50.0, 1e6])
def test_calibrate_dag_clamps_costs_to_floor(floor):
    dag2 = port_exec.calibrate_dag(port.wordcount(), n_batches=3, floor_ktps=floor, device="cpu")
    for n in dag2.nodes:
        # cost is clamped so the implied peak rate never drops below floor
        assert 1e-6 <= n.cpu_cost_per_ktuple <= max(1.0 / floor, 1e-6) + 1e-12


@pytest.mark.parametrize("name", PAPER)
def test_calibrate_dag_preserves_topology_and_metadata(name):
    dag = port.WORKLOADS[name]()
    dag2 = port_exec.calibrate_dag(dag, n_batches=3, device="cpu")
    assert dag2.name == dag.name
    assert dag2.node_names == dag.node_names
    assert dag2.edges == dag.edges
    for a, b in zip(dag.nodes, dag2.nodes):
        assert dataclasses.replace(b, cpu_cost_per_ktuple=a.cpu_cost_per_ktuple) == a
        assert b.fn is a.fn
        assert b.cpu_cost_per_ktuple > 0
    # untimed nodes (no operator body) keep their declared cost
    for a, b in zip(dag.nodes, dag2.nodes):
        if a.fn is None:
            assert b.cpu_cost_per_ktuple == a.cpu_cost_per_ktuple


def _fixed_batches(name, n, seed):
    """Seeded numpy source batches for one paper DAG (its source's columns,
    dtypes and ranges at a small batch)."""
    rng = np.random.default_rng(seed)
    size = 256
    out = []
    for _ in range(n):
        if name == "wordcount":
            b = {"key": rng.integers(0, 4096, size), "value": np.ones(size)}
            b = {k: v.astype(np.int32) for k, v in b.items()}
        elif name == "adanalytics":
            b = {"ad_id": rng.integers(0, 1000, size).astype(np.int32),
                 "event_type": rng.integers(0, 3, size).astype(np.int32),
                 "ts": (rng.random(size) * 1e6).astype(np.float32)}
        else:
            b = {"user": rng.integers(0, 2000, size).astype(np.int32),
                 "cell": rng.integers(0, 200, size).astype(np.int32),
                 "bytes": (rng.exponential(size=size) * 1500.0).astype(np.float32),
                 "latency_ms": (rng.gamma(2.0, size=size) * 10.0).astype(np.float32)}
        out.append(b)
    return out


def _with_source(dag, fn):
    return dataclasses.replace(dag, nodes=tuple(
        dataclasses.replace(n, fn=fn) if n.is_source else n for n in dag.nodes))


def _replay_ref(batches):
    it = iter(batches)
    return lambda key, _=None: (key, {k: jnp.asarray(v) for k, v in next(it).items()})


def _replay_port(batches):
    it = iter(batches)
    return lambda gen, _=None: (gen, {k: torch.as_tensor(v, device=gen.device)
                                      for k, v in next(it).items()})


@pytest.mark.parametrize("name", PAPER)
def test_whole_dag_outputs_equal_the_reference_on_one_source(name):
    """Both packages' sources replaced by one source of the same seeded
    batches: every node's last-batch columns agree (ints and bools bit for
    bit, floats to rel 1e-6) after warmup and timed batches."""
    batches = _fixed_batches(name, 4, seed=21)
    got = port_exec.run_dag(_with_source(port.WORKLOADS[name](), _replay_port(batches)),
                            n_batches=3, warmup=1, device="cpu")
    want = ref_exec.run_dag(_with_source(ref.WORKLOADS[name](), _replay_ref(batches)),
                            n_batches=3, warmup=1)
    assert got.tuples_processed == want.tuples_processed == 3 * 256
    assert sorted(got.outputs) == sorted(want.outputs)
    for node, cols in want.outputs.items():
        assert sorted(got.outputs[node]) == sorted(cols), node
        for k, w in cols.items():
            g, w = got.outputs[node][k].numpy(), np.asarray(w)
            assert g.dtype == w.dtype, (node, k)
            if np.issubdtype(w.dtype, np.floating):
                np.testing.assert_allclose(g, w, rtol=FLOAT_RTOL, atol=0, err_msg=f"{node}.{k}")
            else:
                np.testing.assert_array_equal(g, w, err_msg=f"{node}.{k}")


def test_executor_entry_points_need_the_card_unless_told():
    dag = port.wordcount()
    if torch.cuda.is_available():
        assert port.ExecutorEvaluator().device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        port_exec.run_dag(dag, n_batches=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_exec.calibrate_dag(dag, n_batches=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        port.ExecutorEvaluator()


# ------------------------------------------------------- ExecutorEvaluator

DIM = (3.0, 4096.0)


def _stub(calls):
    """A deterministic ``calibrate_dag``: each node that has an operator
    body gets a cost fixed by its position, clamped as the real one is."""

    def calibrate(dag, n_batches=20, floor_ktps=50.0, **_kw):
        calls.append(dag.name)
        nodes = []
        for i, node in enumerate(dag.nodes):
            if node.fn is None:
                nodes.append(node)
                continue
            cost = min(node.cpu_cost_per_ktuple * (1.0 + 0.37 * (i + 1)), 1.0 / floor_ktps)
            nodes.append(dataclasses.replace(node, cpu_cost_per_ktuple=max(cost, 1e-6)))
        return dataclasses.replace(dag, nodes=tuple(nodes))

    return calibrate


@pytest.fixture
def stubbed(monkeypatch):
    calls = {"ref": [], "port": []}
    monkeypatch.setattr(ref_exec, "calibrate_dag", _stub(calls["ref"]))
    monkeypatch.setattr(port_exec, "calibrate_dag", _stub(calls["port"]))
    return calls


def _configs(pkg_core, pkg, name, pars=((1,), (2,), (1, 2), (3, 1)), n_cont=2):
    dag = pkg.WORKLOADS[name]()
    out = []
    for par in pars:
        p = {n: par[i % len(par)] for i, n in enumerate(dag.node_names)}
        out.append(pkg_core.round_robin_configuration(dag, p, n_cont, pkg_core.ContainerDim(*DIM)))
    return out


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert type(g).__name__ == type(w).__name__ == "EvalResult"
        assert g.achieved_ktps == w.achieved_ktps
        assert g.bottleneck == w.bottleneck
        assert g.sim is None and w.sim is None
        assert g.config.describe() == w.config.describe()


@pytest.mark.parametrize("name", PAPER + ("diamond",))
def test_executor_evaluator_matches_reference(stubbed, name):
    cr, ct = _configs(ref_core, ref, name), _configs(port_core, port, name)
    ev_r, ev_t = ref.ExecutorEvaluator(n_batches=2), port.ExecutorEvaluator(n_batches=2, device="cpu")
    _same([ev_t.evaluate(ct[0])], [ev_r.evaluate(cr[0])])
    _same([ev_t.evaluate(ct[1], 150.0)], [ev_r.evaluate(cr[1], 150.0)])
    loads = [1e6, 150.0, 1e6, 80.0]
    _same(ev_t.evaluate_batch(ct, loads), ev_r.evaluate_batch(cr, loads))
    _same(ev_t.evaluate_batch(ct), ev_r.evaluate_batch(cr))
    trace = np.array([100.0, 260.0, 180.0])
    got = ev_t.evaluate_jobs([ct[:2], ct[2:]], [300.0, trace])
    want = ev_r.evaluate_jobs([cr[:2], cr[2:]], [300.0, trace])
    for g, w in zip(got, want):
        _same(g, w)
    got = ev_t.evaluate_grid(ct[:3], [50.0, 400.0, 1e6])
    want = ev_r.evaluate_grid(cr[:3], [50.0, 400.0, 1e6])
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        _same(g, w)
    assert stubbed["port"] == stubbed["ref"] == [name]
    assert ev_t.result_cache.info()["hits"] == ev_r.result_cache.info()["hits"] > 0


def test_executor_evaluator_calibrates_each_distinct_dag_once(stubbed):
    w, d = port.wordcount(), port.diamond()
    cw = port_core.round_robin_configuration(w, {"W": 1, "C": 1}, 2, port_core.ContainerDim(*DIM))
    cd = port_core.round_robin_configuration(d, {n: 1 for n in d.node_names}, 2,
                                             port_core.ContainerDim(*DIM))
    ex = port.ExecutorEvaluator(n_batches=2, device="cpu")
    ex.evaluate_batch([cw, cw, cd, cw, cd])
    assert sorted(stubbed["port"]) == ["diamond", "wordcount"]
    # a second batch re-uses the timings entirely
    ex.evaluate_batch([cw, cd])
    ex.evaluate_jobs([[cw], [cd]])
    ex.evaluate_grid([cw, cd], [100.0, 200.0])
    assert len(stubbed["port"]) == 2
    assert len(ex._groups_seen) == 2
    assert ex.calibrated_dag(w) is ex._calibrated[ex._cache_key(w)]
    assert len(stubbed["port"]) == 2


def test_executor_evaluator_calibrates_with_the_real_executor_once():
    w = port.wordcount()
    cw = port_core.round_robin_configuration(w, {"W": 1, "C": 1}, 2, port_core.ContainerDim(*DIM))
    ex = port.ExecutorEvaluator(n_batches=2, device="cpu")
    r = ex.evaluate(cw)
    assert r.achieved_ktps > 0
    assert r.bottleneck is None or isinstance(r.bottleneck, str)
    cal = ex.calibrated_dag(w)
    assert cal is ex.calibrated_dag(w)
    assert [n.cpu_cost_per_ktuple for n in cal.nodes] != [n.cpu_cost_per_ktuple for n in w.nodes]
    assert isinstance(ex, port.ConfigEvaluator)


def test_executor_evaluator_distinct_dags_with_same_name_do_not_collide(stubbed):
    w = port.wordcount()
    # same name, different physics: must NOT alias the cached calibration
    w2 = dataclasses.replace(w, nodes=tuple(
        dataclasses.replace(n, cpu_cost_per_ktuple=n.cpu_cost_per_ktuple * 2) for n in w.nodes))
    assert w2.name == w.name and w2 != w
    ex = port.ExecutorEvaluator(n_batches=2, device="cpu")
    ex.precalibrate([w, w2])
    assert len(ex._calibrated) == 2


def test_executor_evaluator_dags_differing_only_in_fn_do_not_collide(stubbed):
    """NodeSpec.fn is excluded from DagSpec equality, but it is exactly what
    the executor times: operator-body identity is part of the cache key."""
    w = port.wordcount()
    w2 = dataclasses.replace(w, nodes=tuple(
        dataclasses.replace(n, fn=(lambda st, batch: (st, batch))) for n in w.nodes))
    assert w2 == w                      # fn is compare=False by design
    ex = port.ExecutorEvaluator(n_batches=2, device="cpu")
    ex.precalibrate([w, w2])
    assert len(ex._calibrated) == 2
    # a freshly built DAG carries fresh operator bodies: a new calibration
    ex.precalibrate([port.wordcount()])
    assert len(ex._calibrated) == 3


def test_executor_evaluator_memoizes_and_invalidates(stubbed):
    dag = port.wordcount()
    store = port_control.ModelStore(port_core.oracle_models(dag, PARAMS_SM))
    ev = port.ExecutorEvaluator(n_batches=1, version_source=store, device="cpu")
    cfg = port_core.round_robin_configuration(dag, {"W": 2, "C": 2}, 2, port_core.ContainerDim(*DIM))
    first = ev.evaluate(cfg, 300.0)
    assert ev.evaluate(cfg, 300.0) is first
    assert ev.result_cache.info()["hits"] == 1
    store.observe(cfg, 290.0)
    assert store.version > 0
    ev.evaluate(cfg, 300.0)
    assert ev.result_cache.info()["hits"] == 1   # version bump missed
    # a trace reduces to its peak and bypasses nothing: the same key
    ev.evaluate_batch([cfg], [np.array([100.0, 300.0])])
    assert ev.result_cache.info()["hits"] == 2
    assert port.ExecutorEvaluator(cache=False, device="cpu").result_cache is None
    with pytest.raises(ValueError, match="samples"):
        port.ExecutorEvaluator(samples="bogus", device="cpu")


def test_executor_evaluator_keys_results_by_device(stubbed):
    """Timings taken on the card are not the host's: the device type is in
    the result-cache key, so two evaluators sharing one cache on different
    devices never serve each other's results."""
    dag = port.wordcount()
    cfg = port_core.round_robin_configuration(dag, {"W": 1, "C": 1}, 2, port_core.ContainerDim(*DIM))
    shared = port.ResultCache(name="executor-shared")
    host = port.ExecutorEvaluator(n_batches=1, cache=shared, device="cpu")
    card = port.ExecutorEvaluator(n_batches=1, cache=shared, device="cpu")
    card.device = torch.device("cuda")        # never launched: the stub calibrates
    assert host._eval_key(cfg, 300.0)[-1] == "cpu"
    assert card._eval_key(cfg, 300.0)[-1] == "cuda"
    assert host._eval_key(cfg, 300.0)[:-1] == card._eval_key(cfg, 300.0)[:-1]
    host.evaluate(cfg, 300.0)
    card.evaluate(cfg, 300.0)
    assert shared.info()["hits"] == 0
    host.evaluate(cfg, 300.0)
    assert shared.info()["hits"] == 1


def _costs(dag):
    return dag.name, [(n.name, n.cpu_cost_per_ktuple, n.gamma, n.mem_mb_base) for n in dag.nodes]


def test_fold_executor_timings_matches_reference(stubbed):
    for name in PAPER:
        cal_r, params_r = ref_control.fold_executor_timings(ref.WORKLOADS[name](), n_batches=2)
        cal_t, params_t = port_control.fold_executor_timings(port.WORKLOADS[name](), n_batches=2,
                                                             device="cpu")
        assert _costs(cal_t) == _costs(cal_r)
        assert dataclasses.asdict(params_t) == dataclasses.asdict(params_r)
        assert params_t.sm_cost_per_ktuple != PARAMS_SM
    # through an evaluator: its cached calibration, no new timing run
    ev = port.ExecutorEvaluator(n_batches=2, device="cpu")
    ev_r = ref.ExecutorEvaluator(n_batches=2)
    dag_t, dag_r = port.adanalytics(), ref.adanalytics()
    ev.calibrated_dag(dag_t)
    ev_r.calibrated_dag(dag_r)
    before = len(stubbed["port"])
    cal_t, params_t = port_control.fold_executor_timings(dag_t, ev, params=port.SimParams(dt=0.02))
    cal_r, params_r = ref_control.fold_executor_timings(dag_r, ev_r, params=ref.SimParams(dt=0.02))
    assert len(stubbed["port"]) == before
    assert _costs(cal_t) == _costs(cal_r)
    assert dataclasses.asdict(params_t) == dataclasses.asdict(params_r)
    # diamond has no operator bodies: nothing is timed, the scale stays 1
    cal_d, params_d = port_control.fold_executor_timings(port.diamond(), device="cpu")
    assert cal_d == port.diamond() and params_d == port.SimParams()


def test_fold_executor_timings_drives_the_simulator():
    """The real executor's timings, folded into the physics, give a
    simulator that still scores a round-robin configuration."""
    ev = port.ExecutorEvaluator(n_batches=2, device="cpu")
    cal, params = port_control.fold_executor_timings(port.adanalytics(), ev)
    assert cal.node_names == port.adanalytics().node_names
    assert params.sm_cost_per_ktuple > 0
    cfg = port_core.round_robin_configuration(cal, {n: 1 for n in cal.node_names}, 2,
                                              port_core.ContainerDim(*DIM))
    sim = port.SimulatorEvaluator(params=params, duration_s=1.0, device="cpu")
    assert sim.evaluate(cfg).achieved_ktps > 0
