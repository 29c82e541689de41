"""LP-based data-flow solver (Trevor §3.1.2, fig. 9).

A deployed configuration is *unfolded* into a physical flow network:

* every node instance is a network node with a capacity constraint from its
  learned model (caputil -> 1 at peak rate, single-threaded),
* every container's stream manager is split into an ingest-half that charges
  the full per-tuple SM cost for **locally-originated** tuples (``SiL``) and a
  network-ingest half charging the same cost for tuples **arriving from other
  containers** — so a tuple that crosses a container boundary pays the stream
  manager CPU **twice** (once at the source SM, once at the destination SM)
  while a locally-routed tuple pays once.  This bifurcation (``SiL/Ii/SiR/X``
  in the paper's fig. 9c) is the key to predicting communication cost,
* grouping operators become equality constraints on instance-pair flows:
  ``fields`` and (round-robin) ``shuffle`` split each producer-instance's
  output uniformly over all downstream instances — the paper's
  ``r11 = r12`` constraints — and ``all`` broadcasts the full stream to every
  downstream instance,
* container dimensions bound the summed CPU/memory of packed instances plus
  the stream manager; NIC capacity bounds cross-container bytes.

The LP maximizes the total source rate; its optimum is the predicted
steady-state tuple rate of the configuration, and its tight constraints
pin-point the rate-limiting component (paper: "it also pin-points the
rate-limiting parts of a configuration").
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np

from . import lp
from .dag import Configuration, DagSpec, Grouping
from .metrics import STREAM_MANAGER
from .node_model import NodeModel


@dataclasses.dataclass
class FlowProblem:
    """The assembled LP together with the variable bookkeeping."""

    config: Configuration
    var_names: list[str]
    c: np.ndarray
    A_ub: np.ndarray
    b_ub: np.ndarray
    ub_names: list[str]
    A_eq: np.ndarray
    b_eq: np.ndarray
    eq_names: list[str]

    @property
    def n_vars(self) -> int:
        return len(self.var_names)


@dataclasses.dataclass
class FlowSolution:
    """Solver output: the predicted rate plus full flow visibility."""

    rate_ktps: float                      # total source input rate
    status: int
    instance_rates: dict[tuple[str, int, int], float]  # (node, container, slot) -> ktps in
    sm_traversals: dict[int, float]       # container -> SM tuple traversals (ktps)
    cross_container_ktps: float           # total tuples crossing containers
    bottlenecks: list[str]                # names of tight constraints
    problem: FlowProblem | None = None

    @property
    def feasible(self) -> bool:
        return self.status == lp.STATUS_OPTIMAL


def _grouping_weight(g: Grouping, n_down: int) -> float:
    if g in (Grouping.FIELDS, Grouping.SHUFFLE):
        return 1.0 / n_down
    if g is Grouping.ALL:
        return 1.0
    raise ValueError(g)


def build_flow_problem(
    config: Configuration,
    models: Mapping[str, NodeModel],
    equal_sources: bool = True,
    shuffle_free: bool = False,
) -> FlowProblem:
    """Assemble the LP for ``config`` under per-node ``models``.

    ``models`` must contain an entry for every DAG node plus
    ``STREAM_MANAGER``.  ``equal_sources`` forces all instances of a source to
    emit at the same rate (round-robin Kafka partition assignment);
    ``shuffle_free`` lets the LP route shuffle-grouped edges freely
    (idealized load-balancing) instead of uniform round-robin.
    """
    dag = config.dag
    sm = models[STREAM_MANAGER]

    instances = config.instances()  # (node, container, slot)
    inst_by_node: dict[str, list[int]] = {}
    for idx, (nm, _c, _s) in enumerate(instances):
        inst_by_node.setdefault(nm, []).append(idx)
    for nm in dag.node_names:
        if nm not in inst_by_node:
            raise ValueError(f"configuration has zero instances of node {nm!r}")

    # ---------------- variable layout ----------------
    var_names: list[str] = []
    # per-instance input rate (sources: external offered rate)
    in_var: dict[int, int] = {}
    for idx, (nm, c, s) in enumerate(instances):
        in_var[idx] = len(var_names)
        var_names.append(f"in[{nm}/{c}.{s}]")
    # per (logical edge, producer instance, consumer instance) flow
    flow_var: dict[tuple[int, int, int], int] = {}
    for ei, e in enumerate(dag.edges):
        for p in inst_by_node[e.src]:
            for q in inst_by_node[e.dst]:
                flow_var[(ei, p, q)] = len(var_names)
                var_names.append(
                    f"f[{e.src}/{instances[p][1]}.{instances[p][2]}->"
                    f"{e.dst}/{instances[q][1]}.{instances[q][2]}]"
                )
    n = len(var_names)

    eq_rows: list[np.ndarray] = []
    eq_rhs: list[float] = []
    eq_names: list[str] = []
    ub_rows: list[np.ndarray] = []
    ub_rhs: list[float] = []
    ub_names: list[str] = []

    def eq(row, rhs, name):
        eq_rows.append(row)
        eq_rhs.append(rhs)
        eq_names.append(name)

    def ub(row, rhs, name):
        ub_rows.append(row)
        ub_rhs.append(rhs)
        ub_names.append(name)

    source_names = {s.name for s in dag.sources()}

    # 1) conservation: non-source instance input = sum of incoming flows
    for idx, (nm, c, s) in enumerate(instances):
        if nm in source_names:
            continue
        row = np.zeros(n)
        row[in_var[idx]] = 1.0
        for ei, e in enumerate(dag.edges):
            if e.dst != nm:
                continue
            for p in inst_by_node[e.src]:
                row[flow_var[(ei, p, idx)]] -= 1.0
        eq(row, 0.0, f"conserve[{nm}/{c}.{s}]")

    # 2) grouping: f(p,q) = w * gamma_src * in(p)   (or free for shuffle_free)
    for ei, e in enumerate(dag.edges):
        g = e.grouping
        gamma = models[e.src].gamma
        n_down = len(inst_by_node[e.dst])
        if g is Grouping.SHUFFLE and shuffle_free:
            # only conservation of the producer's output across consumers
            for p in inst_by_node[e.src]:
                row = np.zeros(n)
                row[in_var[p]] = gamma
                for q in inst_by_node[e.dst]:
                    row[flow_var[(ei, p, q)]] -= 1.0
                eq(row, 0.0, f"shuffle_out[{e.src}->{e.dst}/{p}]")
            continue
        w = _grouping_weight(g, n_down)
        for p in inst_by_node[e.src]:
            for q in inst_by_node[e.dst]:
                row = np.zeros(n)
                row[flow_var[(ei, p, q)]] = 1.0
                row[in_var[p]] -= w * gamma
                eq(row, 0.0, f"group[{e.src}/{p}->{e.dst}/{q}]")

    # 3) equal source emission (round-robin partition assignment)
    if equal_sources:
        for nm in source_names:
            ids = inst_by_node[nm]
            for other in ids[1:]:
                row = np.zeros(n)
                row[in_var[ids[0]]] = 1.0
                row[in_var[other]] = -1.0
                eq(row, 0.0, f"equal_src[{nm}/{other}]")

    # 4) per-instance capacity (single-threaded: caputil <= 1)
    for idx, (nm, c, s) in enumerate(instances):
        m = models[nm]
        row = np.zeros(n)
        row[in_var[idx]] = m.busy_cost_per_ktps
        ub(row, max(1.0 - m.cap.intercept, 1e-6), f"cap[{nm}/{c}.{s}]")

    # 5) SM traversal accounting per container.
    #    traversals_i = (flows originating from instances packed in i)
    #                 + (flows arriving at instances in i from other containers)
    trav_rows = []
    for ci in range(config.n_containers):
        row = np.zeros(n)
        for (ei, p, q), v in flow_var.items():
            p_c = instances[p][1]
            q_c = instances[q][1]
            if p_c == ci:
                row[v] += 1.0
            if q_c == ci and p_c != ci:
                row[v] += 1.0
        trav_rows.append(row)
        # SM is a single process: caputil <= 1 at its learned cost
        ub(row * sm.busy_cost_per_ktps, max(1.0 - sm.cap.intercept, 1e-6), f"sm_cap[{ci}]")

    # 6) container CPU: sum of instance cputil + SM cputil <= dims.cpus
    for ci, dim in enumerate(config.dims):
        row = np.zeros(n)
        intercepts = 0.0
        for idx, (nm, c, s) in enumerate(instances):
            if c != ci:
                continue
            m = models[nm]
            row[in_var[idx]] += m.cpu_cost_per_ktps
            intercepts += max(m.cpu.intercept, 0.0)
        row += trav_rows[ci] * sm.cpu_cost_per_ktps
        intercepts += max(sm.cpu.intercept, 0.0)
        ub(row, max(dim.cpus - intercepts, 1e-6), f"cpu[{ci}]")

    # 7) container memory
    for ci, dim in enumerate(config.dims):
        row = np.zeros(n)
        base = 0.0
        any_inst = False
        for idx, (nm, c, s) in enumerate(instances):
            if c != ci:
                continue
            m = models[nm]
            row[in_var[idx]] += m.mem_slope_mb_per_ktps
            base += m.mem_base_mb
            any_inst = True
        base += sm.mem_base_mb
        if any_inst:
            ub(row, dim.mem_mb - base, f"mem[{ci}]")  # may be < 0 -> infeasible

    # 8) container link (egress and ingress separately), in Mbit/s.
    tuple_mbits = {
        nm: dag.node(nm).tuple_bytes * 8.0 / 1e3 for nm in dag.node_names
    }  # Mbit per ktuple = bytes*8*1000/1e6
    for ci, dim in enumerate(config.dims):
        eg = np.zeros(n)
        ing = np.zeros(n)
        for (ei, p, q), v in flow_var.items():
            e = dag.edges[ei]
            p_c = instances[p][1]
            q_c = instances[q][1]
            if p_c == ci and q_c != ci:
                eg[v] += tuple_mbits[e.src]
            if q_c == ci and p_c != ci:
                ing[v] += tuple_mbits[e.src]
        ub(eg, dim.link_mbps, f"link_out[{ci}]")
        ub(ing, dim.link_mbps, f"link_in[{ci}]")

    # objective: maximize total source input rate
    c_vec = np.zeros(n)
    for idx, (nm, _c, _s) in enumerate(instances):
        if nm in source_names:
            c_vec[in_var[idx]] = 1.0

    return FlowProblem(
        config=config,
        var_names=var_names,
        c=c_vec,
        A_ub=np.array(ub_rows) if ub_rows else np.zeros((0, n)),
        b_ub=np.array(ub_rhs),
        ub_names=ub_names,
        A_eq=np.array(eq_rows) if eq_rows else np.zeros((0, n)),
        b_eq=np.array(eq_rhs),
        eq_names=eq_names,
    )


def solve_flow(
    config: Configuration,
    models: Mapping[str, NodeModel],
    equal_sources: bool = True,
    shuffle_free: bool = False,
    keep_problem: bool = False,
    tight_tol: float = 1e-6,
) -> FlowSolution:
    """Predict the steady-state tuple rate of ``config`` under ``models``."""
    prob = build_flow_problem(config, models, equal_sources, shuffle_free)
    if (prob.b_ub < 0).any():
        # a container cannot even hold its instances' base memory footprint
        bad = [prob.ub_names[i] for i in np.where(prob.b_ub < 0)[0]]
        return FlowSolution(0.0, lp.STATUS_INFEASIBLE, {}, {}, 0.0, bad,
                            prob if keep_problem else None)
    res = lp.linprog_maximize(
        prob.c, A_ub=prob.A_ub, b_ub=prob.b_ub, A_eq=prob.A_eq, b_eq=prob.b_eq
    )
    if not res.success:
        return FlowSolution(0.0, res.status, {}, {}, 0.0, [],
                            prob if keep_problem else None)

    x = res.x
    instances = config.instances()
    inst_rates = {}
    for idx, key in enumerate(instances):
        inst_rates[key] = float(x[idx])  # in_var are the first len(instances) vars

    # SM traversals + cross-container flow, recomputed from the solution.
    dag = config.dag
    inst_by_node: dict[str, list[int]] = {}
    for idx, (nm, _c, _s) in enumerate(instances):
        inst_by_node.setdefault(nm, []).append(idx)
    # flows start right after instance vars, in the same order as built:
    sm_trav = {ci: 0.0 for ci in range(config.n_containers)}
    cross = 0.0
    v = len(instances)
    for ei, e in enumerate(dag.edges):
        for p in inst_by_node[e.src]:
            for q in inst_by_node[e.dst]:
                fval = float(x[v]); v += 1
                p_c = instances[p][1]
                q_c = instances[q][1]
                sm_trav[p_c] += fval
                if q_c != p_c:
                    sm_trav[q_c] += fval
                    cross += fval

    # tight constraints = bottlenecks
    tight = []
    if prob.A_ub.shape[0]:
        resid = prob.b_ub - prob.A_ub @ x
        scale = np.maximum(np.abs(prob.b_ub), 1.0)
        for i in np.where(resid <= tight_tol * scale)[0]:
            tight.append(prob.ub_names[i])

    return FlowSolution(
        rate_ktps=float(res.fun),
        status=res.status,
        instance_rates=inst_rates,
        sm_traversals=sm_trav,
        cross_container_ktps=float(cross),
        bottlenecks=tight,
        problem=prob if keep_problem else None,
    )


def classify_bound(sol: FlowSolution) -> str:
    """Summarize the dominant bottleneck the way Table 2's 'bound' column does."""
    if not sol.feasible:
        return "infeasible"
    kinds = {b.split("[")[0] for b in sol.bottlenecks}
    if "sm_cap" in kinds or "link_out" in kinds or "link_in" in kinds:
        if "cap" in kinds:
            return "comm+compute"
        return "comm"
    if "cap" in kinds:
        return "compute"
    if "cpu" in kinds:
        return "container-cpu"
    if "mem" in kinds:
        return "memory"
    return "unknown"
