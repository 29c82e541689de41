"""The port's ``FleetLoop`` against the reference package on the CPU: the
same tenants, traces and failure schedules through both packages' loops
under one deterministic stub evaluator per package give equal event logs,
field for field; the demo's three tenants on each package's own
``SimulatorEvaluator`` take the same decisions at the same achieved rates
(rel 1e-5); and the N+1 headline holds on the port's own simulator."""
import dataclasses

import pytest

from test_torch_fleet import PORT, REF, FleetStub, cluster, dim, tenant, two_racks

import repro_torch.fleet as port_fleet


def event_sig(e) -> dict:
    d = dataclasses.asdict(e)
    for t in d["tenants"]:
        t["qos"] = int(t["qos"])
    return d


def run_log(P, build, traces, failures=None, steps=None):
    """Build ``(tenants, cluster, loop kwargs)`` with ``build(P)``, drive a
    ``FleetLoop`` on the stub over ``traces`` (and ``failures``), and
    return the event log and the final plan's placements."""
    tenants, c, kw = build(P)
    loop = P.fleet.FleetLoop(tenants, c, kw.pop("evaluator", FleetStub(P)), **kw)
    if steps is None:
        events = loop.run(traces, failures=failures)
    else:
        events = [loop.step({n: t[i] for n, t in traces.items()}, failures=(failures or {}).get(i))
                  for i in range(steps)]
    return [event_sig(e) for e in events], [
        (a.tenant, a.placement.host_names if a.placement else None) for a in loop.plan.allocations]


def demo(P, evaluator=None, **kw):
    """``examples/fleet_demo.py``'s tenants, cluster and traces."""
    C = P.control
    n = 24

    def spec(name, dag, qos, target, scenario, forecaster=None):
        d = getattr(P.streams, dag)()
        return P.fleet.TenantSpec(
            name=name, dag=d, target_ktps=target, qos=getattr(P.fleet.QosTier, qos),
            models=P.core.oracle_models(d, 1.0 / 724.0), guards=C.GuardBands.for_scenario(scenario),
            preferred_dim=dim(P), forecaster=forecaster, horizon=4)

    tenants = [
        spec("ads", "adanalytics", "GUARANTEED", 400.0, "diurnal",
             C.HoltWintersForecaster(season=n // 2)),
        spec("clicks", "diamond", "STANDARD", 250.0, "sawtooth"),
        spec("wordcount", "wordcount", "BEST_EFFORT", 1000.0, "bursty"),
    ]
    M = P.fleet.MachineClass
    c = P.fleet.Cluster([M("std", count=5, cores=4.0, mem_mb=16384.0),
                         M("big", count=1, cores=8.0, mem_mb=32768.0, speed=1.05)])
    traces = {
        "ads": C.make_trace("diurnal", n, base_ktps=260.0, seed=3, peak_ratio=3.0),
        "clicks": C.make_trace("sawtooth", n, base_ktps=140.0, seed=5, ratio=2.0),
        "wordcount": C.make_trace("bursty", n, base_ktps=900.0, seed=7, burst_ratio=3.0),
    }
    return tenants, c, dict(kw, evaluator=evaluator or FleetStub(P)), traces


def _squeeze(P):
    return ([tenant(P, "gold", "GUARANTEED", 800.0), tenant(P, "be", "BEST_EFFORT", 800.0)],
            cluster(P, 3, 4.0, 16384.0), {})


def _single(P):
    return [tenant(P, "gold", "GUARANTEED", 400.0)], cluster(P, 8, 4.0, 16384.0), {}


def _mixed(P):
    return ([tenant(P, "gold", "GUARANTEED", 600.0),
             tenant(P, "silver", "STANDARD", 200.0, dag="diamond"),
             tenant(P, "be", "BEST_EFFORT", 400.0)], cluster(P, 10, 4.0, 16384.0), {})


def _slow_learning(P):
    d = P.streams.wordcount()
    store = P.control.ModelStore(P.core.oracle_models(d, 1.0 / 724.0))
    gold = P.fleet.TenantSpec(name="gold", dag=d, target_ktps=800.0,
                              qos=P.fleet.QosTier.GUARANTEED, models=store,
                              guards=P.control.GuardBands(headroom=1.2, deadband=0.15),
                              preferred_dim=dim(P))
    slow = P.fleet.Cluster([P.fleet.MachineClass("slow", count=8, cores=4.0, mem_mb=16384.0,
                                                 speed=0.3)])
    return [gold], slow, {}


def _pair(P):
    return ([tenant(P, "t0", target=120.0), tenant(P, "t1", target=120.0)],
            cluster(P, 6, 8.0), {})


def _spread(P):
    return ([tenant(P, "gold", "GUARANTEED", 200.0)], two_racks(P, 3, 8.0),
            dict(anti_affinity=True, n1_tiers=(P.fleet.QosTier.GUARANTEED,)))


def _grace(P):
    return ([tenant(P, "be", "BEST_EFFORT", 400.0), tenant(P, "gold", "GUARANTEED", 400.0)],
            cluster(P, 4, 4.0, 16384.0), dict(eviction_grace=True, move_budget=2))


def _demo(P):
    tenants, c, kw, _traces = demo(P)
    return tenants, c, kw


def _demo_traces():
    return {k: [float(x) for x in v] for k, v in demo(REF)[3].items()}


LOGS = {
    "squeeze": (_squeeze, {"gold": [300.0, 1400.0, 310.0, 1400.0], "be": [500.0, 500.0, 505.0, 500.0]},
                None),
    "deadband": (_single, {"gold": [400.0, 410.0, 700.0, 700.0]}, None),
    "scenarios": (_mixed, "scenarios", None),
    "slow_hosts_learning": (_slow_learning, {"gold": [800.0] * 4}, None),
    "failure_steps": (_pair, {"t0": [120.0] * 4, "t1": [120.0] * 4},
                      [(1, "fail", "std/0"), (2, "drain", "std/1"), (3, "recover", "std/0")]),
    "flapping": (_pair, {"t0": [110.0] * 8, "t1": [110.0] * 8}, "flapping"),
    "rack_failure": (_spread, {"gold": [200.0] * 3}, [(1, "fail-rack", "r1"), (2, "recover-rack", "r1")]),
    "grace_and_budget": (_grace, {"gold": [400.0, 400.0, 900.0, 400.0],
                                  "be": [400.0, 400.0, 400.0, 400.0]}, None),
    "demo_day": (_demo, "demo", None),
}


@pytest.mark.parametrize("name", sorted(LOGS))
def test_fleet_loop_event_logs_match_reference(name):
    build, traces, failures = LOGS[name]
    if traces == "scenarios":
        traces = {
            "gold": REF.control.make_trace("diurnal", 6, base_ktps=300.0, seed=1),
            "silver": REF.control.make_trace("sawtooth", 6, base_ktps=120.0, seed=2),
            "be": REF.control.make_trace("bursty", 6, base_ktps=200.0, seed=3),
        }
    elif traces == "demo":
        traces = _demo_traces()
    if failures == "flapping":
        failures = REF.control.make_failure_trace("flapping", 8, host="std/0", period=2, start=2)
        assert failures == PORT.control.make_failure_trace("flapping", 8, host="std/0",
                                                           period=2, start=2)
    got, want = run_log(PORT, build, traces, failures), run_log(REF, build, traces, failures)
    assert got == want
    if name == "demo_day":
        events = got[0]
        assert any(e["replanned"] and e["cause"] == "forecast" for e in events)
        assert all(t["sla_met"] for e in events for t in e["tenants"] if t["tenant"] == "ads")
    if name == "slow_hosts_learning":
        assert any(e["replanned"] for e in got[0])


def test_fleet_loop_failure_mapping_and_flat_schedules_agree():
    traces = {"t0": [100.0] * 4}

    def build(P):
        return [tenant(P, "t0", target=100.0)], cluster(P, 4, 8.0), {}

    flat = [(1, "fail", "std/0"), (3, "recover", "std/0")]
    mapped = {1: [("fail", "std/0")], 3: [("recover", "std/0")]}
    runs = [run_log(P, build, traces, f) for P in (PORT, REF) for f in (flat, mapped)]
    assert runs[0] == runs[1] == runs[2] == runs[3]
    assert runs[0][0][1]["cause"] == "failover"
    with pytest.raises(ValueError):
        port_fleet.FleetLoop([tenant(PORT, "t0")], cluster(PORT, 2)).step(
            {"t0": 40.0}, failures=[("explode", "std/0")])


def test_fleet_loop_logs_match_reference_under_random_failures():
    from hypothesis import given, settings, strategies as st

    @settings(max_examples=4, deadline=None)
    @given(schedule=st.lists(st.tuples(st.integers(0, 3), st.integers(0, 4)),
                             max_size=4, unique=True))
    def check(schedule):
        def build(P):
            return ([tenant(P, "t0", target=100.0), tenant(P, "t1", target=70.0)],
                    cluster(P, 6, 8.0), dict(anti_affinity=True))

        by_step: dict = {}
        for step, hi in schedule:
            by_step.setdefault(step, []).append(("fail", f"std/{hi}"))
        traces = {"t0": [100.0] * 4, "t1": [70.0] * 4}
        assert run_log(PORT, build, traces, by_step, steps=4) == run_log(REF, build, traces,
                                                                         by_step, steps=4)

    check()


# ------------------------------------------- each package's own simulator

DECISION_KEYS = ("tenant", "qos", "load", "target", "guard", "planned_ktps", "cpus", "degraded",
                 "admitted", "sla_met", "cause", "moves", "evicted", "draining", "deferred",
                 "failover")


def test_demo_on_each_package_simulator_takes_the_same_decisions():
    """8 steps of the demo at ``duration_s=2.0``: the same replans, causes,
    moves and per-tenant decisions, achieved rates within rel 1e-5."""
    steps = 8
    traces = _demo_traces()
    logs = {}
    for P, ev in ((PORT, lambda: PORT.streams.SimulatorEvaluator(duration_s=2.0, device="cpu")),
                  (REF, lambda: REF.streams.SimulatorEvaluator(duration_s=2.0))):
        tenants, c, kw, _ = demo(P, evaluator=ev())
        loop = P.fleet.FleetLoop(tenants, c, kw.pop("evaluator"), **kw)
        for i in range(steps):
            loop.step({n: t[i] for n, t in traces.items()})
        logs[P.name] = ([event_sig(e) for e in loop.events],
                        [(a.tenant, a.config.describe() if a.config else None,
                          a.placement.host_names if a.placement else None)
                         for a in loop.plan.allocations])
    port_log, ref_log = logs["port"], logs["reference"]
    assert port_log[1] == ref_log[1]
    for pe, re in zip(port_log[0], ref_log[0]):
        for k in ("step", "replanned", "cause", "moves", "evicted", "failed_hosts", "failover",
                  "cores_total", "cores_used"):
            assert pe[k] == re[k], (re["step"], k)
        for pt, rt in zip(pe["tenants"], re["tenants"]):
            for k in DECISION_KEYS:
                assert pt[k] == rt[k], (re["step"], pt["tenant"], k)
            assert pt["achieved_ktps"] == pytest.approx(rt["achieved_ktps"], rel=1e-5)
    assert any(e["replanned"] for e in port_log[0][1:])


def test_n1_headline_on_the_port_simulator():
    """One host of the guaranteed tenant dies at step 2 on the demo cluster
    with N+1 on: a failover replan moves its containers off the dead host
    and the guaranteed tenant books zero breach steps."""
    P = PORT
    ev = P.streams.SimulatorEvaluator(duration_s=2.0, sticky_batch=True, device="cpu")
    tenants = [tenant(P, "ads", "GUARANTEED", 300.0, dag="adanalytics"),
               tenant(P, "clicks", "STANDARD", 150.0, dag="diamond"),
               tenant(P, "wc", "BEST_EFFORT", 200.0)]
    M = P.fleet.MachineClass
    c = P.fleet.Cluster([M("std", count=5, cores=4.0, mem_mb=16384.0, rack="r1"),
                         M("alt", count=5, cores=4.0, mem_mb=16384.0, rack="r2"),
                         M("big", count=1, cores=8.0, mem_mb=32768.0, speed=1.05, rack="r1")])
    loop = P.fleet.FleetLoop(tenants, c, ev, anti_affinity=True,
                             n1_tiers=(P.fleet.QosTier.GUARANTEED,))
    traces = {"ads": [260.0, 300.0, 300.0, 300.0], "clicks": [120.0, 150.0, 150.0, 150.0],
              "wc": [200.0, 260.0, 200.0, 200.0]}
    loop.step({n: t[0] for n, t in traces.items()})
    loop.step({n: t[1] for n, t in traces.items()})
    assert loop.plan.allocation("ads").n1_feasible is True
    victim = loop.plan.allocation("ads").placement.host_names[0]
    e2 = loop.step({n: t[2] for n, t in traces.items()}, failures=[("fail", victim)])
    assert e2.cause == "failover" and e2.replanned and e2.tenant("ads").failover >= 1
    assert victim not in loop.plan.allocation("ads").placement.host_names
    loop.step({n: t[3] for n, t in traces.items()})
    assert [e.step for e in loop.events if not e.tenant("ads").sla_met] == []


def test_fleet_works_with_pre_multijob_evaluators():
    """An evaluator without ``evaluate_jobs`` drives the port's fleet through
    ``evaluate_jobs_with``'s fallback to ``evaluate_batch``."""

    class OldStyleWrapper:
        def __init__(self, inner):
            self.inner = inner
            self.batch_calls = 0

        def evaluate(self, config, offered_ktps=1e6):
            return self.inner.evaluate(config, offered_ktps)

        def evaluate_batch(self, configs, offered_ktps=1e6):
            self.batch_calls += 1
            return self.inner.evaluate_batch(configs, offered_ktps)

    wrapper = OldStyleWrapper(PORT.streams.SimulatorEvaluator(duration_s=2.0, device="cpu"))
    loop = port_fleet.FleetLoop([tenant(PORT, "gold", "GUARANTEED", 400.0)],
                                cluster(PORT, 6, 4.0, 16384.0), wrapper)
    assert loop.step({"gold": 400.0}).tenant("gold").sla_met
    assert wrapper.batch_calls >= 2


def test_version_clock_keys_the_port_result_cache():
    """The loop wires its ``_ModelVersionClock`` (a tuple of every tenant
    store's version) into the evaluator; a version bump on any tenant makes
    the cached row unreachable, and the clock's tuple keys the cache."""
    P = PORT
    ev = P.streams.SimulatorEvaluator(duration_s=0.5, device="cpu")
    stores = []
    tenants = []
    for name in ("a", "b"):
        d = P.streams.wordcount()
        store = P.control.ModelStore(P.core.oracle_models(d, 1.0 / 724.0))
        stores.append(store)
        tenants.append(P.fleet.TenantSpec(name=name, dag=d, target_ktps=200.0, models=store,
                                          preferred_dim=dim(P)))
    loop = P.fleet.FleetLoop(tenants, cluster(P, 6, 4.0, 16384.0), ev)
    assert isinstance(ev.version_source.version, tuple)
    assert ev.version_source.version == (0, 0)
    cfg = P.core.round_robin_configuration(tenants[0].dag, {"W": 2, "C": 1}, 2, dim(P))
    first = ev.evaluate(cfg, 150.0)
    info = ev.result_cache.info()
    assert ev.evaluate(cfg, 150.0).achieved_ktps == first.achieved_ktps
    assert ev.result_cache.info()["hits"] == info["hits"] + 1
    stores[1].observe(cfg, 100.0)
    assert ev.version_source.version == (0, 1)
    again = ev.evaluate(cfg, 150.0)
    assert ev.result_cache.info()["misses"] == info["misses"] + 1
    assert again.achieved_ktps == first.achieved_ktps
    assert loop.scheduler.evaluator is ev
