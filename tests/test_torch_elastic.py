"""The port's elastic runtime (``runtime/elastic.py``) and
``ElasticLMPolicy`` against the reference package's on the CPU.

With the port's three H100 constants put on ``repro.core.lm_bridge``
(``monkeypatch``), both packages' ``ControlLoop`` under
``ElasticLMPolicy`` and both ``ElasticController``\\ s over
``examples/serve_lm.py``'s spike day give equal event logs, field for
field, and equal allocations; ``FleetElasticController`` under the fleet
tests' deterministic stub evaluator gives the reference's fleet events and
plans, and the events of a ``FleetLoop`` driven directly."""
import dataclasses
import math

import numpy as np
import pytest

from test_torch_fleet import PORT, REF, FleetStub
from test_torch_fleet_loop import demo, event_sig

import repro.control as ref_control
import repro.core.lm_bridge as ref_bridge
import repro.runtime.elastic as ref_elastic
import repro.streams.sources as ref_sources
import repro_torch.control as port_control
import repro_torch.core.lm_bridge as port_bridge
import repro_torch.runtime as port_runtime
import repro_torch.runtime.elastic as port_elastic
import repro_torch.streams.sources as port_sources


@pytest.fixture
def same_constants(monkeypatch):
    for name in ("PEAK_FLOPS", "HBM_BW", "ICI_BW"):
        monkeypatch.setattr(ref_bridge, name, getattr(port_bridge, name))


def _workload(B):
    """``examples/serve_lm.py``'s llama3-8b decode model."""
    stage = B.StageCost("decode_step", flops_per_token=2 * 8.0e9,
                        hbm_bytes_per_token=8.0e9 * 2 / 128, coll_bytes_per_token=2.5e6)
    return B.LMWorkloadModel(arch="llama3-8b", shape="decode_32k", stages=[stage],
                             chips_measured=256)


def _spike_day(sources):
    """``examples/serve_lm.py``'s spiky day of token loads."""
    return sources.spike(96, base_ktps=30.0, spike_ratio=15.0, seed=3) * 1e3


def _rows(loop):
    rows = []
    for ev in loop.events:
        d = dataclasses.asdict(ev)
        d.pop("plan_seconds")
        rows.append({k: ("nan" if isinstance(v, float) and math.isnan(v) else v)
                     for k, v in d.items()})
    return rows


def test_spike_days_are_equal():
    assert np.array_equal(_spike_day(port_sources), _spike_day(ref_sources))


@pytest.mark.parametrize("min_chips,max_chips,overlap", [(8, 4096, 0.0), (1, 64, 0.5)])
def test_elastic_policy_through_control_loop_matches_reference(same_constants, min_chips,
                                                               max_chips, overlap):
    logs, allocs = [], []
    for C, B, S in ((port_control, port_bridge, port_sources),
                    (ref_control, ref_bridge, ref_sources)):
        policy = C.ElasticLMPolicy(_workload(B), 128, min_chips=min_chips,
                                   max_chips=max_chips, overlap=overlap)
        assert policy.name == "elastic-lm"
        loop = C.ControlLoop(policy, guards=C.GuardBands(headroom=1.25, deadband=0.2))
        seen = []
        for load in _spike_day(S):
            ev = loop.step(float(load))
            if ev.acted:
                seen.append(dataclasses.asdict(loop.action.detail))
                assert loop.action.config is None and loop.action.reason == "remesh"
        logs.append(_rows(loop))
        allocs.append(seen)
    assert logs[0] == logs[1]
    assert allocs[0] == allocs[1]
    assert len(allocs[0]) >= 2
    assert {r["policy"] for r in logs[0]} == {"elastic-lm"}


@pytest.mark.parametrize("forecast", [False, True])
def test_elastic_controller_over_the_spike_day_matches_reference(same_constants, forecast):
    runs = []
    for C, B, E, S in ((port_control, port_bridge, port_elastic, port_sources),
                       (ref_control, ref_bridge, ref_elastic, ref_sources)):
        remeshes = []
        ctl = E.ElasticController(
            _workload(B), tokens_per_step=128, min_chips=8, max_chips=2048,
            on_remesh=remeshes.append,
            forecaster=C.HoltWintersForecaster(season=24) if forecast else None)
        allocs = []
        for load in _spike_day(S):
            alloc = ctl.observe(float(load))
            if alloc is not None:
                allocs.append(dataclasses.asdict(alloc))
        assert [dataclasses.asdict(e) for e in remeshes] == [
            dataclasses.asdict(e) for e in ctl.events]
        runs.append(([dataclasses.asdict(e) for e in ctl.events], allocs, ctl.chips,
                     ctl.capacity_tokens_per_s(), _rows(ctl.loop)))
    assert runs[0] == runs[1]
    events = runs[0][0]
    assert len(events) >= 2
    assert max(e["chips_after"] for e in events) > 8          # the spike re-meshes up
    assert all(e["chips_after"] & (e["chips_after"] - 1) == 0 for e in events)


def test_elastic_controller_forwards_its_tunables_live(same_constants):
    ctls = [E.ElasticController(_workload(B), tokens_per_step=128)
            for E, B in ((port_elastic, port_bridge), (ref_elastic, ref_bridge))]
    for ctl, B in zip(ctls, (port_bridge, ref_bridge)):
        ctl.headroom, ctl.deadband, ctl.min_chips, ctl.max_chips = 1.5, 0.1, 2, 256
        ctl.tokens_per_step = 64
        ctl.model = _workload(B)
        assert (ctl.loop.guards.headroom, ctl.loop.guards.deadband) == (1.5, 0.1)
        assert (ctl.loop.policy.min_chips, ctl.loop.policy.max_chips,
                ctl.loop.policy.tokens_per_step) == (2, 256, 64)
        for load in (2e4, 2e4, 4e5, 4e5, 1e4):
            ctl.observe(load)
    assert [dataclasses.asdict(e) for e in ctls[0].events] == [
        dataclasses.asdict(e) for e in ctls[1].events]
    assert ctls[0].capacity_tokens_per_s(16) == ctls[1].capacity_tokens_per_s(16)


def test_runtime_exports_the_reference_names():
    import repro.runtime as ref_runtime

    assert sorted(port_runtime.__all__) == sorted(ref_runtime.__all__)
    assert port_runtime.ElasticController is port_elastic.ElasticController
    assert port_control.ElasticLMPolicy.name == ref_control.ElasticLMPolicy.name


def _demo_loads(P, steps):
    """The demo's loads for ``steps`` steps, then the last step's twice
    more (unchanged demands: the guards hold)."""
    traces = demo(P)[3]
    loads = [{n: float(t[i]) for n, t in traces.items()} for i in range(steps)]
    return loads + [loads[-1]] * 2


def _fleet_run(P, E, steps):
    tenants, cluster, kw, _traces = demo(P)
    replans = []
    ctl = E.FleetElasticController(tenants, cluster, kw["evaluator"],
                                   on_reschedule=replans.append)
    plans = []
    for loads in _demo_loads(P, steps):
        plan = ctl.observe(loads)
        plans.append(None if plan is None else sorted(
            (a.tenant, a.placement.host_names if a.placement else None, a.admitted)
            for a in plan.allocations))
        assert (plan is not None) == ctl.last_event.replanned
        if plan is not None:
            assert plan is ctl.plan
    assert replans == [e for e in ctl.events if e.replanned]
    return [event_sig(e) for e in ctl.events], plans


def test_fleet_elastic_controller_matches_reference_and_its_fleet_loop():
    """The demo's three tenants for 8 steps and two repeats under the stub:
    the port's controller gives the reference's events and plans, and the
    events of the port's ``FleetLoop`` driven directly with the same
    loads."""
    steps = 8
    port = _fleet_run(PORT, port_elastic, steps)
    ref = _fleet_run(REF, ref_elastic, steps)
    assert port == ref
    assert any(p is not None for p in port[1]) and any(p is None for p in port[1])
    tenants, cluster, _kw, _traces = demo(PORT)
    loop = PORT.fleet.FleetLoop(tenants, cluster, FleetStub(PORT))
    direct = [event_sig(loop.step(loads)) for loads in _demo_loads(PORT, steps)]
    assert port[0] == direct
