"""The port's fleet scheduler and cluster against the reference package on
the CPU: every case builds the same tenants, cluster and previous plans in
both packages, schedules them with one deterministic stub evaluator per
package (or none, or a rigged one), asserts what the reference's own test
of that case asserts, and requires the two plans to be identical, tenant
by tenant: touched set, configuration, placement, admission, degradation,
moves, evictions, failover log and N+1 verdict."""
import dataclasses
import inspect
import types

import numpy as np
import pytest

import repro.control as ref_control
import repro.core as ref_core
import repro.fleet as ref_fleet
import repro.streams as ref_streams
import repro_torch.control as port_control
import repro_torch.core as port_core
import repro_torch.fleet as port_fleet
import repro_torch.streams as port_streams

SM_COST = 1.0 / 724.0
REF = types.SimpleNamespace(core=ref_core, streams=ref_streams, control=ref_control,
                            fleet=ref_fleet, name="reference")
PORT = types.SimpleNamespace(core=port_core, streams=port_streams, control=port_control,
                             fleet=port_fleet, name="port")


class FleetStub:
    """A deterministic evaluator over one package, written against the
    pre-multi-job protocol (so ``evaluate_jobs_with`` takes its fallback):
    a configuration achieves ``min(load, solve_flow capacity)`` under its
    DAG's oracle models; the bottleneck is the node with the highest
    capacity utilization when the load reaches the capacity."""

    def __init__(self, P):
        self.P = P
        self.models: dict = {}
        self.rows = 0

    def _one(self, cfg, load):
        models = self.models.setdefault(cfg.dag.name, self.P.core.oracle_models(cfg.dag, SM_COST))
        sol = self.P.core.solve_flow(cfg, models)
        cap = float(sol.rate_ktps) if sol.feasible else 0.0
        load = float(np.max(load))
        bottleneck = None
        if load >= cap and sol.instance_rates:
            util: dict = {}
            for (nm, _c, _s), rate in sol.instance_rates.items():
                util[nm] = max(util.get(nm, 0.0), rate * models[nm].cap.slope)
            bottleneck = max(util.items(), key=lambda kv: kv[1])[0]
        self.rows += 1
        return self.P.streams.EvalResult(config=cfg, achieved_ktps=min(load, cap),
                                         bottleneck=bottleneck, sim=None)

    def evaluate(self, config, offered_ktps=1e6):
        return self._one(config, offered_ktps)

    def evaluate_batch(self, configs, offered_ktps=1e6):
        configs = list(configs)
        loads = ([offered_ktps] * len(configs) if np.isscalar(offered_ktps)
                 else list(offered_ktps))
        return [self._one(c, o) for c, o in zip(configs, loads)]


class Rigged:
    """Configurations at or above a cpu floor score rich, leaner ones poor
    (the reference test's ``_RiggedEvaluator``), with ``evaluate_jobs``."""

    def __init__(self, P, cpu_floor, rich=2000.0, poor=10.0):
        self.P, self.cpu_floor, self.rich, self.poor = P, cpu_floor, rich, poor
        self.group_shapes = []

    def _score(self, c):
        ok = c.total_cpus() >= self.cpu_floor - 1e-9
        return self.P.streams.EvalResult(config=c, achieved_ktps=self.rich if ok else self.poor,
                                         bottleneck=None)

    def evaluate_jobs(self, groups, offered_ktps=1e6):
        self.group_shapes.append([len(g) for g in groups])
        return [[self._score(c) for c in g] for g in groups]


# -------------------------------------------------------------- helpers

def dim(P, cpus=3.0, mem=4096.0):
    return P.core.ContainerDim(cpus=cpus, mem_mb=mem)


def tenant(P, name, qos="STANDARD", target=40.0, dag="wordcount", **kw):
    d = getattr(P.streams, dag)()
    kw.setdefault("guards", P.control.GuardBands(headroom=1.2, deadband=0.15))
    kw.setdefault("preferred_dim", dim(P))
    return P.fleet.TenantSpec(name=name, dag=d, target_ktps=target,
                              qos=getattr(P.fleet.QosTier, qos),
                              models=P.core.oracle_models(d, SM_COST), **kw)


def cluster(P, hosts=8, cores=16.0, mem=65536.0, rack=""):
    return P.fleet.Cluster([P.fleet.MachineClass("std", count=hosts, cores=cores,
                                                 mem_mb=mem, rack=rack)])


def two_racks(P, per_rack=4, cores=8.0):
    M = P.fleet.MachineClass
    return P.fleet.Cluster([M("std", count=per_rack, cores=cores, mem_mb=32768.0, rack="r1"),
                            M("alt", count=per_rack, cores=cores, mem_mb=32768.0, rack="r2")])


def synthetic_plan(P, c, *rows):
    """A hand-placed previous plan: rows are (spec, config, host names)."""
    allocs = []
    for spec, config, names in rows:
        allocs.append(P.fleet.TenantAllocation(
            tenant=spec.name, qos=spec.qos, requested_ktps=spec.target_ktps,
            planned_ktps=spec.target_ktps, config=config,
            placement=P.fleet.Placement(host_of=tuple(range(len(names))),
                                        host_names=tuple(names), min_speed=1.0),
            cpus=float(sum(d.cpus for d in config.dims)),
            predicted_ktps=spec.target_ktps, bottleneck=None,
            shortfall_ktps=0.0, degraded=False,
        ))
    return P.fleet.FleetPlan(allocations=allocs, cores_total=c.total_cores(), cores_used=0.0)


def fragmented_prev(P, c, be, n_hosts=4):
    cfg = P.core.round_robin_configuration(be.dag, {"W": 1, "C": 1}, n_hosts, dim(P))
    return synthetic_plan(P, c, (be, cfg, tuple(f"std/{i}" for i in range(n_hosts))))


# ------------------------------------------------------------ signatures

def alloc_sig(a) -> dict:
    return dict(
        tenant=a.tenant, qos=int(a.qos), requested=a.requested_ktps, planned=a.planned_ktps,
        config=a.config.describe() if a.config else None,
        dims=[(d.cpus, d.mem_mb) for d in a.config.dims] if a.config else None,
        hosts=a.placement.host_names if a.placement else None,
        min_speed=a.placement.min_speed if a.placement else None,
        cpus=a.cpus, predicted=a.predicted_ktps, bottleneck=a.bottleneck,
        shortfall=a.shortfall_ktps, degraded=a.degraded, admitted=a.admitted, moves=a.moves,
        move_cost=a.move_cost, evicted=a.evicted, candidates=a.candidates_scored,
        horizon=tuple(a.horizon_ktps), horizon_feasible=a.horizon_feasible, window=a.window,
        draining=a.draining, deferred=a.deferred, n1_feasible=a.n1_feasible,
    )


def plan_sig(p) -> dict:
    return dict(
        allocations=[alloc_sig(a) for a in p.allocations],
        cores_total=p.cores_total, cores_used=p.cores_used,
        eviction_log=[(t, int(q)) for t, q in p.eviction_log],
        touched=p.touched, deferred=p.deferred, eval_rows=p.eval_rows, failover=p.failover,
        timings=sorted(p.timings),
    )


def check_packing(c, plan):
    """No container on a failed host and no host over its capacity."""
    failed = c.failed_hosts()
    cap = {h.name: (h.cores, h.mem_mb) for h in c.inventory()}
    used: dict = {}
    for a in plan.allocations:
        if a.config is None or a.placement is None:
            continue
        for d, h in zip(a.config.dims, a.placement.host_names):
            assert h and h not in failed, (a.tenant, h)
            cu, mu = used.get(h, (0.0, 0.0))
            used[h] = (cu + d.cpus, mu + d.mem_mb)
    for h, (cu, mu) in used.items():
        assert cu <= cap[h][0] + 1e-9 and mu <= cap[h][1] + 1e-9, (h, cu, mu)


# ----------------------------------------------------------------- cases

def case_cluster_model(P):
    F = P.fleet
    c = F.Cluster([F.MachineClass("slow", count=2, cores=4.0, mem_mb=8192.0, speed=0.5),
                   F.MachineClass("fast", count=2, cores=8.0, mem_mb=16384.0, speed=1.5)])
    out = [c.n_hosts, c.total_cores(), c.total_mem_mb(), [h.name for h in c.inventory()]]
    hosts = c.inventory()
    pl = F.Cluster.pack([dim(P), dim(P, 2.0, 2048.0), dim(P, 6.0, 8192.0)], hosts)
    out += [pl.host_of, pl.host_names, pl.min_speed, pl.feasible, pl.moves,
            [(h.name, h.cores_free, h.mem_free) for h in hosts]]
    before = [(h.cores_free, h.mem_free) for h in hosts]
    out.append(F.Cluster.trial_pack([dim(P, 4.0, 4096.0)] * 3, hosts))
    assert [(h.cores_free, h.mem_free) for h in hosts] == before
    frag = F.Cluster([F.MachineClass("std", count=4, cores=4.0, mem_mb=16384.0)])
    fh = frag.inventory()
    F.Cluster.pack([dim(P)] * 4, fh)
    out.append(F.Cluster.trial_pack([dim(P, 2.0, 2048.0)], fh))
    c.fail_host("fast/0")
    c.drain_host("slow/1")
    out += [c.host_status("fast/0"), c.host_status("slow/1"), sorted(c.failed_hosts()),
            sorted(c.draining_hosts()), c.n_hosts, c.total_cores(),
            [h.name for h in c.inventory()], c.describe()]
    with pytest.raises(KeyError):
        c.fail_host("nope/0")
    r = two_racks(P, per_rack=2, cores=16.0)
    out += [r.racks(), r.rack_of("alt/1"), cluster(P, hosts=2).rack_of("std/0")]
    spread = F.Cluster.pack([dim(P)] * 3, r.inventory(), spread="rack")
    out += [spread.host_names, spread.spread_ok]
    r.fail_rack("r1")
    out.append(sorted(r.failed_hosts()))
    r.recover_rack("r1")
    d = cluster(P, hosts=3, cores=8.0)
    d.drain_host("std/0")
    out.append(F.Cluster.pack([dim(P)], d.inventory(), prefer=("std/0",)).host_names)
    return out


def case_sheds_best_effort_first(P, ev=None):
    gold = tenant(P, "gold", "GUARANTEED", 800.0)
    be = tenant(P, "be", "BEST_EFFORT", 800.0)
    c = P.fleet.Cluster([P.fleet.MachineClass("std", count=2, cores=4.0, mem_mb=16384.0)])
    p1 = P.fleet.FleetScheduler(c, ev).schedule([(be, 960.0), (gold, 960.0)])
    p2 = P.fleet.FleetScheduler(c, ev).schedule([(gold, 960.0), (be, 960.0)])
    g, b = p1.allocation("gold"), p1.allocation("be")
    assert not g.degraded and b.degraded and b.planned_ktps < g.planned_ktps
    return [plan_sig(p1), plan_sig(p2)]


def case_sheds_with_stub(P):
    return case_sheds_best_effort_first(P, FleetStub(P))


def case_degrades_progressively(P):
    demands = [(tenant(P, "gold", "GUARANTEED", 800.0), 960.0),
               (tenant(P, "silver", "STANDARD", 300.0, dag="diamond"), 360.0),
               (tenant(P, "be", "BEST_EFFORT", 600.0), 720.0)]
    out, short = [], {}
    for n in (10, 4, 3):
        c = P.fleet.Cluster([P.fleet.MachineClass("std", count=n, cores=4.0, mem_mb=16384.0)])
        p = P.fleet.FleetScheduler(c, FleetStub(P)).schedule(demands)
        assert not p.allocation("gold").degraded
        short[n] = {a.tenant: a.shortfall_ktps for a in p.allocations}
        out.append(plan_sig(p))
    assert short[10]["be"] == 0.0 and short[4]["be"] > 0.0 and short[4]["silver"] == 0.0
    with pytest.raises(ValueError, match="duplicate tenant"):
        P.fleet.FleetScheduler(c).schedule([(tenant(P, "gold", "GUARANTEED"), 480.0),
                                            (tenant(P, "gold", "BEST_EFFORT"), 240.0)])
    return out


def case_joint_scoring_and_speed_derate(P):
    ev = FleetStub(P)
    c = cluster(P, hosts=8, cores=4.0, mem=16384.0)
    p = P.fleet.FleetScheduler(c, ev).schedule(
        [(tenant(P, "gold", "GUARANTEED", 600.0), 720.0),
         (tenant(P, "silver", "STANDARD", 200.0, dag="diamond"), 240.0)])
    for a in p.allocations:
        assert a.predicted_ktps >= 0.85 * a.planned_ktps
    gold = tenant(P, "gold", "GUARANTEED", 400.0)
    slow = P.fleet.Cluster([P.fleet.MachineClass("slow", count=8, cores=4.0, mem_mb=16384.0,
                                                 speed=0.5)])
    ps = P.fleet.FleetScheduler(slow, ev).schedule([(gold, 480.0)])
    pf = P.fleet.FleetScheduler(cluster(P, 8, 4.0, 16384.0), ev).schedule([(gold, 480.0)])
    assert ps.allocation("gold").predicted_ktps == pytest.approx(
        0.5 * pf.allocation("gold").predicted_ktps, rel=1e-6)
    return [plan_sig(p), plan_sig(ps), plan_sig(pf), ev.rows]


def case_warm_placement(P):
    gold = tenant(P, "gold", "GUARANTEED", 480.0)
    be = tenant(P, "be", "BEST_EFFORT", 480.0)
    sched = P.fleet.FleetScheduler(cluster(P, 4, 4.0, 16384.0))
    p1 = sched.schedule([(gold, 480.0), (be, 480.0)])
    p2 = sched.schedule([(gold, 480.0), (be, 480.0)], previous=p1)
    assert p2.total_moves == 0
    sched6 = P.fleet.FleetScheduler(cluster(P, 6, 4.0, 16384.0))
    q1 = sched6.schedule([(gold, 480.0), (be, 480.0)])
    q2 = sched6.schedule([(gold, 1400.0), (be, 480.0)], previous=q1)
    assert q2.allocation("be").moves == 0
    r1 = sched6.schedule([(gold, 1400.0)])
    r2 = sched6.schedule([(gold, 480.0)], previous=r1)
    assert r2.allocation("gold").moves == 0
    return [plan_sig(p) for p in (p1, p2, q1, q2, r1, r2)]


def case_preemption_and_defrag(P):
    F = P.fleet
    gold = tenant(P, "gold", "GUARANTEED", 400.0)
    be = tenant(P, "be", "BEST_EFFORT", 400.0)
    c = cluster(P, 4, 4.0, 16384.0)
    sched = F.FleetScheduler(c)
    prev = fragmented_prev(P, c, be)
    hosts = c.inventory()
    assert F.Cluster.seat(prev.allocations[0].config.dims,
                          prev.allocations[0].placement.host_names, hosts).feasible
    fp = P.core.minimal_footprint(gold.dag, gold.node_models(), dim(P))
    assert not F.Cluster.trial_pack(fp.dims, hosts)
    p = sched.schedule([(gold, 400.0), (be, 400.0)], previous=prev)
    assert p.allocation("gold").admitted and p.allocation("be").evicted >= 1
    # compaction alone frees a host: zero evictions
    be2 = tenant(P, "be", "BEST_EFFORT", 100.0)
    c2 = cluster(P, 2, 4.0, 16384.0)
    cfg = P.core.round_robin_configuration(be2.dag, {"W": 1, "C": 1}, 2, dim(P))
    cfg = dataclasses.replace(cfg, dims=(dim(P, 2.5, 2048.0), dim(P, 1.5, 2048.0)))
    q = F.FleetScheduler(c2).schedule([(gold, 400.0), (be2, 100.0)],
                                      previous=synthetic_plan(P, c2, (be2, cfg, ("std/0", "std/1"))))
    assert q.eviction_log == () and q.allocation("gold").admitted
    # reverse-QoS eviction order
    big = tenant(P, "gold", "GUARANTEED", 1400.0)
    silver = tenant(P, "silver", "STANDARD", 400.0)
    be3 = tenant(P, "be", "BEST_EFFORT", 400.0)
    c3 = cluster(P, 4, 4.0, 16384.0)
    cfg3 = P.core.round_robin_configuration(be3.dag, {"W": 1, "C": 1}, 2, dim(P))
    r = F.FleetScheduler(c3).schedule(
        [(big, 1400.0), (silver, 400.0), (be3, 400.0)],
        previous=synthetic_plan(P, c3, (silver, cfg3, ("std/0", "std/1")),
                                (be3, cfg3, ("std/2", "std/3"))))
    assert all(int(q_) != int(F.QosTier.GUARANTEED) for _t, q_ in r.eviction_log)
    return [plan_sig(x) for x in (p, q, r)]


def case_candidate_sets_rigged(P):
    ev = Rigged(P, cpu_floor=2.5)
    spec = tenant(P, "wc", "GUARANTEED", 300.0,
                  candidate_dims=[dim(P), dim(P, 1.5, 1024.0)])
    p = P.fleet.FleetScheduler(cluster(P, 4, 4.0, 16384.0), ev).schedule([(spec, 300.0)])
    a = p.allocation("wc")
    assert len(ev.group_shapes) == 1 and a.candidates_scored >= 2
    assert a.predicted_ktps == pytest.approx(2000.0)
    return [plan_sig(p), ev.group_shapes]


def case_touched_set_and_windows(P):
    sched = P.fleet.FleetScheduler(cluster(P, 30), FleetStub(P))
    demands = [(tenant(P, f"t{i}"), 40.0 + (i % 3)) for i in range(10)]
    p1 = sched.schedule(demands)
    p1b = sched.schedule(demands, previous=p1)
    changed = list(demands)
    changed[4] = (demands[4][0], 120.0)
    p2 = sched.schedule(changed, previous=p1b)
    assert p2.touched == ("t4",)
    w1 = sched.schedule(changed, windows={"t1": [40.0, 44.0]}, previous=p2)
    w2 = sched.schedule(changed, windows={"t1": [40.0, 44.0]}, previous=w1)
    w3 = sched.schedule(changed, windows={"t1": [40.0, 52.0]}, previous=w2)
    assert w2.touched == () and w3.touched == ("t1",)
    full = P.fleet.FleetScheduler(cluster(P, 30), incremental=False)
    f1 = full.schedule(demands[:5])
    f2 = full.schedule(demands[:5], previous=f1)
    assert f2.total_moves == 0
    return [plan_sig(p) for p in (p1, p1b, p2, w1, w2, w3, f1, f2)]


def case_move_budget(P):
    c = cluster(P, 40)
    tenants = [tenant(P, f"t{i:02d}") for i in range(8)]
    small = [(t, 60.0) for t in tenants]
    big = [(t, 400.0) for t in tenants]
    out = []
    for budget in (3, 0):
        sched = P.fleet.FleetScheduler(c, move_budget=budget)
        q = sched.schedule(small)
        for _round in range(50):
            q = sched.schedule(big, previous=q)
            assert q.total_moves <= budget
            out.append(plan_sig(q))
            if not q.deferred or budget == 0:
                break
    return out


def case_eviction_grace(P):
    out = []
    for grace in (True, False):
        c = cluster(P, 4, 4.0, 16384.0)
        sched = P.fleet.FleetScheduler(c, eviction_grace=grace)
        gold = tenant(P, "gold", "GUARANTEED", 400.0)
        be = tenant(P, "be", "BEST_EFFORT", 400.0)
        prev = fragmented_prev(P, c, be)
        demands = [(gold, 400.0), (be, 400.0)]
        p1 = sched.schedule(demands, previous=prev)
        p2 = sched.schedule(demands, previous=p1)
        assert bool(p1.allocation("be").draining) == grace
        assert p2.allocation("gold").admitted
        out += [plan_sig(p1), plan_sig(p2), p1.draining]
    return out


def case_pruning(P):
    ev = FleetStub(P)
    demands = [(tenant(P, "a", target=200.0), 240.0)]
    wide = P.fleet.FleetScheduler(cluster(P, 30), ev, prune_band=100.0).schedule(demands)
    tight = P.fleet.FleetScheduler(cluster(P, 30), ev, prune_band=1.0).schedule(demands)
    assert 1 <= tight.allocation("a").candidates_scored <= wide.allocation("a").candidates_scored
    spec = tenant(P, "b", "GUARANTEED", 300.0, candidate_dims=[dim(P), dim(P, 1.5, 1024.0)])
    d = P.fleet.FleetScheduler(cluster(P, 30), ev).schedule([(spec, 300.0)])
    assert d.allocation("b").candidates_scored >= 2
    return [plan_sig(p) for p in (wide, tight, d)]


def case_failover_placement(P):
    out = []
    c = cluster(P, 6, 8.0)
    sched = P.fleet.FleetScheduler(c, FleetStub(P))
    demands = [(tenant(P, f"t{i}", target=120.0), 120.0) for i in range(3)]
    p1 = sched.schedule(demands)
    p1 = sched.schedule(demands, previous=p1)
    victim = p1.allocation("t0").placement.host_names[0]
    c.fail_host(victim)
    p2 = sched.schedule(demands, previous=p1)
    assert p2.failover and all(h == victim for _t, h, _n in p2.failover)
    check_packing(c, p2)
    out += [plan_sig(p1), plan_sig(p2)]
    # a failure the caller reports unions with the cluster's own state
    c = cluster(P, 6, 8.0)
    sched = P.fleet.FleetScheduler(c)
    q1 = sched.schedule(demands[:1])
    q1 = sched.schedule(demands[:1], previous=q1)
    v = q1.allocation("t0").placement.host_names[0]
    q2 = sched.schedule(demands[:1], previous=q1, failed_hosts={v})
    assert v not in q2.allocation("t0").placement.host_names
    out.append(plan_sig(q2))
    # failover is exempt from the move budget
    c = cluster(P, 6, 8.0)
    sched = P.fleet.FleetScheduler(c, move_budget=0)
    r1 = sched.schedule(demands[:1])
    r1 = sched.schedule(demands[:1], previous=r1)
    c.fail_host(r1.allocation("t0").placement.host_names[0])
    r2 = sched.schedule(demands[:1], previous=r1)
    assert not r2.allocation("t0").deferred and r2.failover
    out.append(plan_sig(r2))
    # a best-effort failover never displaces the guaranteed tier
    c = P.fleet.Cluster([P.fleet.MachineClass("std", count=3, cores=3.0, mem_mb=16384.0)])
    sched = P.fleet.FleetScheduler(c)
    dd = [(tenant(P, "gold", "GUARANTEED", 300.0), 300.0),
          (tenant(P, "be", "BEST_EFFORT", 300.0), 300.0)]
    s1 = sched.schedule(dd)
    s1 = sched.schedule(dd, previous=s1)
    c.fail_host(sorted(set(s1.allocation("be").placement.host_names))[0])
    s2 = sched.schedule(dd, previous=s1)
    assert s2.allocation("gold").moves == 0 and len(s2.failover) == 1
    out.append(plan_sig(s2))
    dead = cluster(P, 2)
    dead.fail_host("std/0")
    dead.fail_host("std/1")
    with pytest.raises(ValueError):
        P.fleet.FleetScheduler(dead).schedule([(tenant(P, "t0"), 40.0)])
    return out


def case_failure_knobs_inert_and_deterministic(P):
    out = []
    for rack, failed in (("", None), ("r1", frozenset())):
        c = cluster(P, 6, 8.0, rack=rack)
        sched = P.fleet.FleetScheduler(c)
        demands = [(tenant(P, f"t{i}", target=80.0 + 11 * i), 80.0 + 11 * i) for i in range(4)]
        p = sched.schedule(demands)
        p = sched.schedule(demands, previous=p, failed_hosts=failed)
        out.append(plan_sig(p))
    assert out[0] == out[1]
    c = cluster(P, 6, 8.0)
    sched = P.fleet.FleetScheduler(c, FleetStub(P))
    demands = [(tenant(P, f"t{i}", target=100.0), 100.0) for i in range(3)]
    plan = sched.schedule(demands)
    for op, host in (("fail", "std/0"), ("fail", "std/1"), ("recover", "std/0")):
        getattr(c, f"{op}_host")(host)
        plan = sched.schedule(demands, previous=plan)
        out.append(plan_sig(plan))
    return out


def case_anti_affinity_and_n1(P):
    r = two_racks(P, per_rack=3, cores=8.0)
    a = P.fleet.FleetScheduler(r, anti_affinity=True).schedule(
        [(tenant(P, "gold", "GUARANTEED", 600.0), 600.0)])
    g = a.allocation("gold")
    assert g.placement.spread_ok and len({r.rack_of(h) for h in g.placement.host_names}) >= 2
    s = P.fleet.FleetScheduler(cluster(P, 4, 16.0), anti_affinity=True).schedule(
        [(tenant(P, "std", "STANDARD", 600.0), 600.0)])
    assert len(set(s.allocation("std").placement.host_names)) >= 2
    out = [plan_sig(a), plan_sig(s)]
    for ev in (None, FleetStub(P)):
        n = P.fleet.FleetScheduler(two_racks(P, 3, 8.0), ev, anti_affinity=True,
                                   n1_tiers=(P.fleet.QosTier.GUARANTEED,)).schedule(
            [(tenant(P, "gold", "GUARANTEED", 120.0), 120.0),
             (tenant(P, "std", "STANDARD", 120.0), 120.0)])
        assert n.allocation("gold").n1_feasible is True
        assert n.allocation("std").n1_feasible is None
        out.append(plan_sig(n))
    return out


def case_grace_and_failover(P):
    out = []
    c = cluster(P, 4, 4.0, 16384.0)
    sched = P.fleet.FleetScheduler(c, eviction_grace=True)
    gold = tenant(P, "gold", "GUARANTEED", 400.0)
    be = tenant(P, "be", "BEST_EFFORT", 400.0)
    demands = [(gold, 400.0), (be, 400.0)]
    p1 = sched.schedule(demands, previous=fragmented_prev(P, c, be))
    assert p1.allocation("be").draining
    c.fail_host(p1.allocation("be").placement.host_names[0])
    p2 = sched.schedule(demands, previous=p1)
    check_packing(c, p2)
    out += [plan_sig(p1), plan_sig(p2)]
    c = cluster(P, 5, 4.0, 16384.0)
    c.fail_host("std/4")
    q = P.fleet.FleetScheduler(c, eviction_grace=True).schedule(
        demands, previous=fragmented_prev(P, c, be))
    assert q.allocation("be").draining and q.allocation("be").admitted
    out.append(plan_sig(q))
    return out


CASES = [case_cluster_model, case_sheds_best_effort_first, case_sheds_with_stub,
         case_degrades_progressively, case_joint_scoring_and_speed_derate, case_warm_placement,
         case_preemption_and_defrag, case_candidate_sets_rigged, case_touched_set_and_windows,
         case_move_budget, case_eviction_grace, case_pruning, case_failover_placement,
         case_failure_knobs_inert_and_deterministic, case_anti_affinity_and_n1,
         case_grace_and_failover]


@pytest.mark.parametrize("case", CASES, ids=lambda f: f.__name__.removeprefix("case_"))
def test_fleet_plans_match_reference(case):
    assert case(PORT) == case(REF)


def _defaults(fn) -> list:
    """Parameter names and defaults, enums by value."""
    out = []
    for p in inspect.signature(fn).parameters.values():
        d = p.default
        if isinstance(d, (tuple, list)):
            d = tuple(int(x) if hasattr(x, "value") else x for x in d)
        elif hasattr(d, "value"):
            d = int(d)
        out.append((p.name, repr(d)))
    return out


@pytest.mark.parametrize("path", [
    "FleetScheduler.__init__", "FleetScheduler.schedule", "FleetLoop.__init__", "FleetLoop.step",
    "FleetLoop.run", "Cluster.pack", "Cluster.trial_pack", "Cluster.seat", "Cluster.release",
    "TenantSpec", "MachineClass",
])
def test_fleet_signatures_and_defaults_match_reference(path):
    def resolve(mod):
        obj = mod
        for part in path.split("."):
            obj = getattr(obj, part)
        return obj

    assert _defaults(resolve(port_fleet)) == _defaults(resolve(ref_fleet))


def test_fleet_exports_match_reference():
    assert sorted(port_fleet.__all__) == sorted(ref_fleet.__all__)
    assert [q.name for q in port_fleet.QosTier] == [q.name for q in ref_fleet.QosTier]
    assert [int(q) for q in port_fleet.QosTier] == [int(q) for q in ref_fleet.QosTier]
    assert (port_fleet.HOST_UP, port_fleet.HOST_DRAINING, port_fleet.HOST_FAILED) == (
        ref_fleet.HOST_UP, ref_fleet.HOST_DRAINING, ref_fleet.HOST_FAILED)
    for name in ("TenantSpec", "TenantAllocation", "FleetPlan", "TenantStep", "FleetEvent",
                 "MachineClass", "Host", "Placement"):
        port_fields = [f.name for f in dataclasses.fields(getattr(port_fleet, name))]
        assert port_fields == [f.name for f in dataclasses.fields(getattr(ref_fleet, name))], name


def _churn(P, ops, qos, demand_scale):
    """Random fail/recover churn under N+1 and anti-affinity with the stub
    evaluator: every replan's signature, and the packing invariants."""
    c = cluster(P, 6, 16.0)
    sched = P.fleet.FleetScheduler(c, FleetStub(P), anti_affinity=True,
                                   n1_tiers=(P.fleet.QosTier.GUARANTEED,))
    tiers = ("BEST_EFFORT", "STANDARD", "GUARANTEED")
    demands = [(tenant(P, f"t{i}", tiers[q], (60.0 + 15 * i) * demand_scale),
                (60.0 + 15 * i) * demand_scale) for i, q in enumerate(qos)]
    plan = sched.schedule(demands)
    sigs = [plan_sig(plan)]
    for kind, hi in ops:
        name = f"std/{hi}"
        if kind == "fail":
            if len(c.failed_hosts()) >= 5:
                continue
            c.fail_host(name)
        elif name in c.failed_hosts():
            c.recover_host(name)
        else:
            continue
        plan = sched.schedule(demands, previous=plan)
        check_packing(c, plan)
        sigs.append(plan_sig(plan))
    return sigs


def test_fleet_plans_match_reference_under_random_demands_and_failures():
    from hypothesis import given, settings, strategies as st

    @settings(max_examples=5, deadline=None)
    @given(
        ops=st.lists(st.tuples(st.sampled_from(["fail", "recover"]), st.integers(0, 5)),
                     min_size=1, max_size=5),
        qos=st.lists(st.integers(0, 2), min_size=2, max_size=4),
        demand_scale=st.sampled_from([0.5, 1.0, 3.0]),
    )
    def check(ops, qos, demand_scale):
        assert _churn(PORT, ops, qos, demand_scale) == _churn(REF, ops, qos, demand_scale)

    check()


def _eviction(P, n_hosts, be_t, silver_t, gold_t):
    """A guaranteed arrival onto a cluster that standard and best-effort
    tenants already fill: the warm plan and its eviction log."""
    sched = P.fleet.FleetScheduler(cluster(P, n_hosts, 4.0, 16384.0))
    silver = tenant(P, "silver", "STANDARD", silver_t)
    be = tenant(P, "be", "BEST_EFFORT", be_t)
    gold = tenant(P, "gold", "GUARANTEED", gold_t)
    p0 = sched.schedule([(silver, silver_t), (be, be_t)])
    p1 = sched.schedule([(gold, gold_t), (silver, silver_t), (be, be_t)], previous=p0)
    log = [(t, int(q)) for t, q in p1.eviction_log]
    assert all(q != int(P.fleet.QosTier.GUARANTEED) for _t, q in log)
    resident = len(p0.allocation("be").config.dims) if p0.allocation("be").admitted else 0
    for i, (_t, q) in enumerate(log):
        if q == int(P.fleet.QosTier.STANDARD):
            assert sum(q2 == int(P.fleet.QosTier.BEST_EFFORT) for _t2, q2 in log[:i]) == resident
    return [plan_sig(p0), plan_sig(p1)]


def test_eviction_plans_match_reference_property():
    from hypothesis import given, settings, strategies as st

    @settings(max_examples=6, deadline=None)
    @given(n_hosts=st.integers(2, 6), be_t=st.sampled_from([200.0, 500.0, 900.0]),
           silver_t=st.sampled_from([200.0, 500.0]),
           gold_t=st.sampled_from([600.0, 1400.0, 2400.0]))
    def check(n_hosts, be_t, silver_t, gold_t):
        args = (n_hosts, be_t, silver_t, gold_t)
        assert _eviction(PORT, *args) == _eviction(REF, *args)

    check()
