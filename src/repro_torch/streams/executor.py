"""Real PyTorch executor for stream DAGs.

Runs the operator bodies (:mod:`repro_torch.streams.operators`) on actual
tuple batches, end-to-end through the DAG, and measures the per-ktuple wall
cost of every node on the device it runs on — the "test deployment" path
of the paper's workflow (models can be trained "from production settings or
test deployments", §1/§4).  The measured costs can re-parameterize the
NodeSpecs so the simulator's physical truth tracks the machine it runs on.

Each node is timed on the host clock around its call and a device
synchronise, one node at a time, as in the reference: what is measured is
what a deployment of that operator alone would see, launch cost included.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any

import torch

from ..core.dag import DagSpec
from ..device import resolve_device


@dataclasses.dataclass
class ExecutionReport:
    outputs: dict[str, Any]
    per_node_us_per_tuple: dict[str, float]
    tuples_processed: int

    def cost_per_ktuple_seconds(self) -> dict[str, float]:
        return {k: v * 1e-3 for k, v in self.per_node_us_per_tuple.items()}


def run_dag(
    dag: DagSpec,
    n_batches: int = 20,
    seed: int = 0,
    warmup: int = 3,
    device=None,
) -> ExecutionReport:
    """Push ``n_batches`` real batches through the DAG in topological order,
    timing each node.  Nodes without an ``fn`` are treated as pass-through.

    ``device=None`` runs on the CUDA card (and raises without one); a
    source's generator is seeded with ``seed`` on that device."""
    dev = resolve_device(device)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    states: dict[str, Any] = {}
    for node in dag.nodes:
        fn = node.fn
        if fn is None:
            continue
        init = getattr(fn, "init", None)
        if node.is_source:
            states[node.name] = torch.Generator(device=dev).manual_seed(seed)
        elif init is not None:
            states[node.name] = init(dev)
        elif node.name == "anomaly_detector":
            from .operators import anomaly_detector_init

            states[node.name] = anomaly_detector_init(dev)
        else:
            states[node.name] = None

    timings: dict[str, float] = {n.name: 0.0 for n in dag.nodes}
    counts: dict[str, int] = {n.name: 0 for n in dag.nodes}
    order = dag.topological_order()
    last_out: dict[str, Any] = {}
    total = 0

    for b in range(n_batches + warmup):
        batch_of: dict[str, Any] = {}
        for name in order:
            node = dag.node(name)
            fn = node.fn
            # inputs: merge upstream outputs (column union)
            ins = [batch_of[e.src] for e in dag.in_edges(name) if e.src in batch_of]
            merged: Any = None
            if ins:
                merged = {}
                for d in ins:
                    if isinstance(d, dict):
                        merged.update(d)
            if fn is None:
                batch_of[name] = merged
                continue
            t0 = time.perf_counter()
            st, out = fn(states.get(name), merged)
            sync()
            dt = time.perf_counter() - t0
            states[name] = st
            batch_of[name] = out
            if b >= warmup:
                timings[name] += dt
                n_tuples = 0
                if isinstance(out, dict) and out:
                    first = next(iter(out.values()))
                    n_tuples = int(first.shape[0]) if hasattr(first, "shape") and first.ndim else 0
                counts[name] += n_tuples
        last_out = batch_of
        if b >= warmup:
            src = dag.sources()[0].name
            out = batch_of.get(src)
            if isinstance(out, dict) and out:
                total += int(next(iter(out.values())).shape[0])

    per_tuple_us = {}
    for name in order:
        if counts[name] > 0:
            per_tuple_us[name] = timings[name] / counts[name] * 1e6
    return ExecutionReport(
        outputs=last_out, per_node_us_per_tuple=per_tuple_us, tuples_processed=total
    )


def calibrate_dag(
    dag: DagSpec, n_batches: int = 20, floor_ktps: float = 50.0, device=None
) -> DagSpec:
    """Return a copy of ``dag`` whose ground-truth per-ktuple CPU costs are the
    wall-clock costs measured on ``device`` (clamped to a sane peak-rate
    floor).  ``device=None`` is the CUDA card."""
    report = run_dag(dag, n_batches=n_batches, device=device)
    new_nodes = []
    for node in dag.nodes:
        us = report.per_node_us_per_tuple.get(node.name)
        if us is None:
            new_nodes.append(node)
            continue
        cost = min(us * 1e-3, 1.0 / floor_ktps)  # sec per ktuple
        new_nodes.append(dataclasses.replace(node, cpu_cost_per_ktuple=max(cost, 1e-6)))
    return dataclasses.replace(dag, nodes=tuple(new_nodes))
