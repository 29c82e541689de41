"""Logical DAG specification for stream-processing workloads (Trevor §2.1).

A :class:`DagSpec` is the *logical* topology the programmer writes: user-defined
nodes stitched together by grouping operators (fields / shuffle / all).  A
:class:`Configuration` is the *physical* deployment of that DAG: per-node
parallelism, container dimensions, container count and the packing of node
instances onto containers (Trevor table 1).

Everything downstream (the simulator, the flow solver, the allocator) consumes
these two data structures.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Callable, Mapping, Sequence


class Grouping(enum.Enum):
    """Heron's three default data-grouping operators (Trevor §2.1)."""

    FIELDS = "fields"    # hash(key) -> one downstream instance per key
    SHUFFLE = "shuffle"  # random downstream instance (load-balanced)
    ALL = "all"          # broadcast to every downstream instance


@dataclasses.dataclass(frozen=True)
class NodeSpec:
    """A user-defined DAG node (spout or bolt in Heron terms).

    ``cpu_cost_per_ktuple`` is the *ground-truth* CPU-seconds consumed per
    kilotuple of input — the simulator uses it; Trevor never reads it (it must
    learn it from metrics).  ``gamma`` is the ground-truth output:input rate
    ratio.  ``mem_mb_per_ktps``/``mem_mb_base`` define the ground-truth memory
    footprint as a function of the tuple rate mapped to an instance.
    ``io_fraction`` is the fraction of busy time the node spends blocked on
    I/O rather than on-CPU (Kafka ingestion nodes etc., Trevor §4).
    """

    name: str
    cpu_cost_per_ktuple: float
    gamma: float = 1.0
    mem_mb_base: float = 128.0
    mem_mb_per_ktps: float = 0.0
    io_fraction: float = 0.0
    tuple_bytes: float = 100.0  # size of this node's *output* tuples
    is_source: bool = False
    # Optional real computation for the executor path (operates on a tuple batch).
    fn: Callable | None = dataclasses.field(default=None, compare=False)

    def __post_init__(self) -> None:
        if self.cpu_cost_per_ktuple < 0:
            raise ValueError(f"node {self.name}: negative cpu cost")
        if self.gamma < 0:
            raise ValueError(f"node {self.name}: negative gamma")
        if not 0.0 <= self.io_fraction < 1.0:
            raise ValueError(f"node {self.name}: io_fraction must be in [0,1)")


@dataclasses.dataclass(frozen=True)
class EdgeSpec:
    """A directed edge ``src -> dst`` with a grouping operator."""

    src: str
    dst: str
    grouping: Grouping = Grouping.SHUFFLE


@dataclasses.dataclass(frozen=True)
class DagSpec:
    """A logical streaming DAG."""

    name: str
    nodes: tuple[NodeSpec, ...]
    edges: tuple[EdgeSpec, ...]

    def __post_init__(self) -> None:
        names = [n.name for n in self.nodes]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate node names in {self.name}")
        nameset = set(names)
        for e in self.edges:
            if e.src not in nameset or e.dst not in nameset:
                raise ValueError(f"edge {e.src}->{e.dst} references unknown node")
            if e.src == e.dst:
                raise ValueError("self-loops are not allowed in a DAG")
        # acyclicity check via topological sort
        self.topological_order()

    # -- queries ----------------------------------------------------------
    def node(self, name: str) -> NodeSpec:
        for n in self.nodes:
            if n.name == name:
                return n
        raise KeyError(name)

    @property
    def node_names(self) -> tuple[str, ...]:
        return tuple(n.name for n in self.nodes)

    def sources(self) -> tuple[NodeSpec, ...]:
        indeg = {n.name: 0 for n in self.nodes}
        for e in self.edges:
            indeg[e.dst] += 1
        return tuple(n for n in self.nodes if indeg[n.name] == 0)

    def out_edges(self, name: str) -> tuple[EdgeSpec, ...]:
        return tuple(e for e in self.edges if e.src == name)

    def in_edges(self, name: str) -> tuple[EdgeSpec, ...]:
        return tuple(e for e in self.edges if e.dst == name)

    def topological_order(self) -> tuple[str, ...]:
        indeg = {n.name: 0 for n in self.nodes}
        for e in self.edges:
            indeg[e.dst] += 1
        ready = [n for n, d in sorted(indeg.items()) if d == 0]
        order: list[str] = []
        indeg = dict(indeg)
        while ready:
            u = ready.pop(0)
            order.append(u)
            for e in self.out_edges(u):
                indeg[e.dst] -= 1
                if indeg[e.dst] == 0:
                    ready.append(e.dst)
        if len(order) != len(self.nodes):
            raise ValueError(f"DAG {self.name} has a cycle")
        return tuple(order)

    def gamma_rates(self, source_rate: float = 1.0) -> dict[str, float]:
        """Propagate input rates through the DAG using ground-truth gammas.

        Returns the steady-state *input* rate of every node when every source
        emits ``source_rate`` (after its own gamma).  Used by tests and by the
        allocator (with learned gammas substituted via ``gamma_overrides``).
        """
        return propagate_rates(
            self, source_rate, {n.name: n.gamma for n in self.nodes}
        )


def propagate_rates(
    dag: DagSpec, source_rate: float, gammas: Mapping[str, float]
) -> dict[str, float]:
    """Propagate per-node *input* rates through ``dag`` given gamma factors.

    A source node's "input" rate is defined as ``source_rate`` (the external
    offered load); its output is ``gamma * source_rate``.  Multiple in-edges
    sum.  ALL-grouping broadcast multiplies by downstream parallelism only at
    the *physical* layer, so it does not appear here (logical rates).
    """
    inrate: dict[str, float] = {n.name: 0.0 for n in dag.nodes}
    for s in dag.sources():
        inrate[s.name] = source_rate
    for u in dag.topological_order():
        out = inrate[u] * gammas[u]
        outs = dag.out_edges(u)
        if not outs:
            continue
        for e in outs:
            # each out-edge carries the full output stream (Heron semantics:
            # every downstream bolt subscribed to the stream sees all tuples)
            inrate[e.dst] += out
    return inrate


# ---------------------------------------------------------------------------
# Physical configuration
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ContainerDim:
    """Container dimensions — continuous axes (Trevor §2.1)."""

    cpus: float = 3.0
    mem_mb: float = 4096.0
    link_mbps: float = 10_000.0  # NIC capacity per container

    def __post_init__(self) -> None:
        if self.cpus <= 0 or self.mem_mb <= 0 or self.link_mbps <= 0:
            raise ValueError("container dimensions must be positive")

    def scaled(self, alpha: float) -> "ContainerDim":
        return ContainerDim(self.cpus * alpha, self.mem_mb * alpha, self.link_mbps)


@dataclasses.dataclass(frozen=True)
class Configuration:
    """A physical deployment plan for a DagSpec.

    ``packing[c]`` lists the node-name of every instance placed in container
    ``c``; a node may appear several times in one container (multiple
    instances).  Parallelism of node ``v`` is the total count of ``v`` across
    all containers.  Every container implicitly hosts one stream manager.
    """

    dag: DagSpec
    packing: tuple[tuple[str, ...], ...]
    dims: tuple[ContainerDim, ...] = ()

    def __post_init__(self) -> None:
        if not self.packing:
            raise ValueError("configuration must have at least one container")
        if self.dims and len(self.dims) != len(self.packing):
            raise ValueError("dims must match container count (or be empty)")
        if not self.dims:
            object.__setattr__(
                self, "dims", tuple(ContainerDim() for _ in self.packing)
            )
        known = set(self.dag.node_names)
        for c in self.packing:
            for inst in c:
                if inst not in known:
                    raise ValueError(f"unknown node {inst!r} in packing")

    # -- queries ----------------------------------------------------------
    @property
    def n_containers(self) -> int:
        return len(self.packing)

    def parallelism(self, name: str) -> int:
        return sum(c.count(name) for c in self.packing)

    def parallelism_map(self) -> dict[str, int]:
        return {n: self.parallelism(n) for n in self.dag.node_names}

    def instances(self) -> list[tuple[str, int, int]]:
        """All physical instances as (node_name, container_idx, slot_idx)."""
        out = []
        for ci, c in enumerate(self.packing):
            for si, inst in enumerate(c):
                out.append((inst, ci, si))
        return out

    def total_cpus(self) -> float:
        return float(sum(d.cpus for d in self.dims))

    def total_mem_mb(self) -> float:
        return float(sum(d.mem_mb for d in self.dims))

    def describe(self) -> str:
        packs = []
        for c in self.packing:
            counts: dict[str, int] = {}
            for i in c:
                counts[i] = counts.get(i, 0) + 1
            packs.append(
                "(" + ",".join(f"{k}x{v}" if v > 1 else k for k, v in counts.items()) + ")"
            )
        return f"{self.dag.name}[{self.n_containers}c: {' '.join(packs)}]"


def round_robin_configuration(
    dag: DagSpec,
    parallelism: Mapping[str, int],
    n_containers: int,
    dim: ContainerDim = ContainerDim(),
) -> Configuration:
    """The baseline packing used throughout the paper's sensitivity study:
    instances of each node are dealt round-robin onto ``n_containers``."""
    packs: list[list[str]] = [[] for _ in range(n_containers)]
    i = 0
    for name in dag.node_names:
        for _ in range(int(parallelism[name])):
            packs[i % n_containers].append(name)
            i += 1
    return Configuration(
        dag=dag,
        packing=tuple(tuple(p) for p in packs),
        dims=tuple(dim for _ in range(n_containers)),
    )


def single_container_configuration(
    dag: DagSpec,
    parallelism: Mapping[str, int],
    cpus: float = 1e9,
    mem_mb: float = 1e12,
) -> Configuration:
    """The paper's "optimal line" reference (fig. 14): all instances in one
    container with unbounded resources and a free stream manager."""
    pack = []
    for name in dag.node_names:
        pack.extend([name] * int(parallelism[name]))
    return Configuration(
        dag=dag,
        packing=(tuple(pack),),
        dims=(ContainerDim(cpus=cpus, mem_mb=mem_mb, link_mbps=1e12),),
    )
