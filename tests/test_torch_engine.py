"""The port's evaluation engine against the reference package on the CPU:
``SimulatorEvaluator`` scores the same configurations to the simulator's
noise-on tolerance with the same bottleneck labels, regroups grids and
jobs the same way, and pins the same backend and bucket floors after the
same call sequence."""
import pytest

import repro.core as ref_core
import repro.streams as ref
import repro_torch.core as port_core
import repro_torch.streams as port

#: Port against reference with noise on: the achieved rate to rel 1e-5
#: (``tests/test_torch_simulator.py::NOISY_RTOL``, measured 9.4e-8).
NOISY_RTOL = 1e-5
DURATION = 2.0


def _pair(name, pars=((1,), (2,), (1, 2)), n_cont=2):
    """The same configurations in both packages: node ``i`` gets
    ``par[i % len(par)]`` replicas, dealt round-robin over ``n_cont``
    3-CPU containers."""
    dag_r, dag_t = ref.WORKLOADS[name](), port.WORKLOADS[name]()
    out_r, out_t = [], []
    for par in pars:
        p = {n: par[i % len(par)] for i, n in enumerate(dag_r.node_names)}
        out_r.append(ref_core.round_robin_configuration(
            dag_r, p, n_cont, ref_core.ContainerDim(3.0, 4096.0)))
        out_t.append(port_core.round_robin_configuration(
            dag_t, p, n_cont, port_core.ContainerDim(3.0, 4096.0)))
    return out_r, out_t


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert y.achieved_ktps == pytest.approx(x.achieved_ktps, rel=NOISY_RTOL)
        assert y.bottleneck == x.bottleneck
        assert y.config.describe() == x.config.describe()


CASES = [(w, k) for w in ("wordcount", "diamond", "adanalytics") for k in ("dense", "sparse")]


@pytest.mark.parametrize("name,kernel", CASES)
def test_evaluator_matches_reference(name, kernel):
    cr, ct = _pair(name)
    ev_r = ref.SimulatorEvaluator(duration_s=DURATION, tick_kernel=kernel)
    ev_t = port.SimulatorEvaluator(duration_s=DURATION, tick_kernel=kernel, device="cpu")
    loads = [1e6, 150.0, 1e6]
    _same(ev_r.evaluate_batch(cr, loads), ev_t.evaluate_batch(ct, loads))
    _same([ev_r.evaluate(cr[2], 300.0)], [ev_t.evaluate(ct[2], 300.0)])
    assert isinstance(ev_t.evaluate(ct[0]), port.EvalResult)
    assert ev_t.evaluate_batch([]) == []


def test_grid_and_jobs_regroup_as_the_reference_does():
    cr, ct = _pair("diamond")
    ev_r = ref.SimulatorEvaluator(duration_s=DURATION)
    ev_t = port.SimulatorEvaluator(duration_s=DURATION, device="cpu")
    rates = [100.0, 250.0, 1e6]
    grid_r = ev_r.evaluate_grid(cr[:2], rates)
    grid_t = ev_t.evaluate_grid(ct[:2], rates)
    assert [len(r) for r in grid_t] == [len(r) for r in grid_r] == [3, 3]
    for a, b in zip(grid_r, grid_t):
        _same(a, b)
    groups_r, groups_t = [cr[:2], [cr[2]], []], [ct[:2], [ct[2]], []]
    loads_r = [ref.PerCandidateLoads([120.0, 1e6]), 1e6, 5.0]
    loads_t = [port.PerCandidateLoads([120.0, 1e6]), 1e6, 5.0]
    jobs_r = ev_r.evaluate_jobs(groups_r, loads_r)
    jobs_t = ev_t.evaluate_jobs(groups_t, loads_t)
    assert [len(g) for g in jobs_t] == [len(g) for g in jobs_r] == [2, 1, 0]
    for a, b in zip(jobs_r, jobs_t):
        _same(a, b)
    with pytest.raises(ValueError):
        ev_t.evaluate_jobs(groups_t, [port.PerCandidateLoads([1.0]), 1.0, 1.0])
    assert ev_t.evaluate_jobs([[], []]) == [[], []]
    assert ev_t.evaluate_grid(ct[:1], []) == [[]]


class _BatchOnly:
    """An evaluator written against the protocol's first two entry points."""

    def __init__(self, inner):
        self.inner = inner
        self.calls = 0

    def evaluate_batch(self, configs, offered_ktps=port.OVERLOAD_KTPS):
        self.calls += 1
        return self.inner.evaluate_batch(configs, offered_ktps)


def test_grid_and_jobs_shims_fall_back_to_one_batch():
    _, ct = _pair("wordcount")
    ev = port.SimulatorEvaluator(duration_s=DURATION, device="cpu")
    shim = _BatchOnly(ev)
    grid = port.evaluate_grid_with(shim, ct[:2], [100.0, 1e6])
    jobs = port.evaluate_jobs_with(shim, [ct[:1], ct[1:]], [1e6, 200.0])
    assert shim.calls == 2
    assert [len(r) for r in grid] == [2, 2] and [len(g) for g in jobs] == [1, 2]
    direct = ev.evaluate_grid(ct[:2], [100.0, 1e6])
    assert [[e.achieved_ktps for e in r] for r in grid] == [
        [e.achieved_ktps for e in r] for r in direct]
    assert port.evaluate_jobs_with(shim, [[], []]) == [[], []]
    assert isinstance(ev, port.ConfigEvaluator)


STATE = ("_backend", "_inst_floor", "_cont_floor", "_batch_floor", "_edge_floor",
         "_degree_floor")


@pytest.mark.parametrize("kernel", ["auto", "dense", "sparse"])
def test_pinned_backend_and_floors_follow_the_reference(kernel):
    """The same call sequence (a small batch, a larger configuration, a
    presize, a smaller batch) leaves the same pinned backend, the same
    sticky floors and the same launch shapes in both packages."""
    small_r, small_t = _pair("deep_pipeline", pars=((1,), (1, 2)))
    big_r, big_t = _pair("deep_pipeline", pars=((3,),), n_cont=6)
    evs = [
        ref.SimulatorEvaluator(duration_s=0.5, tick_kernel=kernel, sticky_batch=True),
        port.SimulatorEvaluator(duration_s=0.5, tick_kernel=kernel, sticky_batch=True,
                                device="cpu"),
    ]
    ref.clear_kernel_cache()
    port.clear_kernel_cache()
    states = []
    for ev, small, big in zip(evs, (small_r, small_t), (big_r, big_t)):
        seen = [tuple(getattr(ev, k) for k in STATE)]
        ev.evaluate_batch(small, 1e6)
        seen.append(tuple(getattr(ev, k) for k in STATE))
        ev.evaluate_batch(big + small, [1e6, 50.0, 80.0])
        seen.append(tuple(getattr(ev, k) for k in STATE))
        ev.presize(300, 40, n_batch=20, n_edges=600, max_degree=20)
        ev.evaluate_batch(small[:1], 1e6)
        seen.append(tuple(getattr(ev, k) for k in STATE))
        states.append(seen)
    assert states[1] == states[0]
    assert states[1][-1][0] in ("dense", "sparse")
    info_r, info_t = ref.kernel_cache_info(), port.kernel_cache_info()
    assert info_t["entries"] == info_r["entries"]
    assert (info_t["misses"], info_t["hits"]) == (info_r["misses"], info_r["hits"])


def test_shard_count_arithmetic_and_errors():
    """One shard per device: a CPU run has one, and the auto rule keeps two
    configurations a shard; asking for more devices than there are raises
    at the call, as the reference does."""
    for batch in (1, 2, 7, 64):
        assert port.shard_count(batch, None, "cpu") == ref.shard_count(batch, None) == 1
        assert port.shard_count(batch, 1, "cpu") == ref.shard_count(batch, 1) == 1
    with pytest.raises(ValueError, match="devices=2"):
        port.shard_count(8, 2, "cpu")
    with pytest.raises(ValueError, match="devices=2"):
        ref.shard_count(8, 2)
    _, ct = _pair("wordcount")
    with pytest.raises(ValueError, match="available"):
        port.simulate_batch(ct, 1e6, duration_s=0.5, devices=2, device="cpu")
    assert port.shard_count(0, None, "cpu") == 1


def test_shard_count_over_several_cards(monkeypatch):
    """On a host with four cards (the count stubbed: no such host here),
    ``devices=None`` keeps every batch on one card, where the reference's
    auto rule would shard; an explicit count shards, up to one shard a row,
    and more cards than there are raises."""
    import torch

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    for batch in (1, 2, 3, 4, 7, 8, 64):
        assert port.shard_count(batch, None, "cuda") == 1, batch
        assert port.shard_count(batch, None) == 1, batch
    want = {1: 1, 2: 2, 3: 3, 4: 4, 7: 4, 64: 4}
    for batch, n in want.items():
        assert port.shard_count(batch, 4, "cuda") == n, batch
    assert port.shard_count(3, 4, "cuda") == 3          # never more shards than rows
    assert port.shard_count(16, 4, "cuda") == 4
    with pytest.raises(ValueError, match="only 4"):
        port.shard_count(16, 5, "cuda")
    with pytest.raises(ValueError, match="only 1"):
        port.shard_count(16, 4, "cpu")
