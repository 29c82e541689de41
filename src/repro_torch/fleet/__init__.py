"""Fleet layer: multi-job cluster scheduling over a shared hardware model.

``Cluster`` models the finite physical pool (machine classes with per-host
core/memory capacity and relative speed); ``FleetScheduler`` places N
independent jobs — each a DagSpec + declared rate + QoS tier — onto it by
scoring joint candidate *sets* (dim × rounding per tenant) through the
batched evaluation engine (one device unless the evaluator is given
``devices=``); ``FleetLoop`` runs one sense→plan→act→learn cycle across
all tenants, shedding best-effort capacity before guaranteed capacity
when the budget binds.

Scheduling is *stateful*: ``schedule(..., previous=plan)`` warm-places —
containers stay on their current hosts when the allocation allows it and
repacks are scored by container-move cost — and a squeezed higher tier
defragments and then preempts lower-tier residency in reverse-QoS order
(evictions recorded per tenant in the plan's eviction log).

It is also *incremental*: only the touched set (tenants whose demand,
window, or feasibility changed, plus tenants displaced by preemption or
defragmentation) is replanned — everyone else keeps their allocation
verbatim at zero packing/scoring cost, so a 1,000-tenant fleet with a few
percent churn schedules in time proportional to the churn.  Candidate
ladders are pruned to a cost band before joint scoring, ``move_budget``
caps voluntary container moves per replan (excess repacks are deferred to
later rounds), and ``eviction_grace`` gives preemption victims one drain
round before their capacity is reclaimed.

It is *failure-domain aware*: hosts carry lifecycle state
(up/draining/failed) and rack labels; a failed host's containers become
forced displacements re-placed through the same preemption/defrag
machinery (logged in ``FleetPlan.failover``), ``anti_affinity`` spreads
each tenant across hosts (racks, for guaranteed tenants) so no single
domain holds all of a tenant's capacity, and ``n1_tiers`` provisions the
named QoS tiers with enough headroom that losing any one host still meets
the SLA while the replacement containers come up.
"""

from .cluster import (
    HOST_DRAINING,
    HOST_FAILED,
    HOST_UP,
    Cluster,
    Host,
    MachineClass,
    Placement,
)
from .scheduler import (
    FleetPlan,
    FleetScheduler,
    QosTier,
    TenantAllocation,
    TenantSpec,
)
from .loop import FleetEvent, FleetLoop, TenantStep

__all__ = [
    "Cluster", "FleetEvent", "FleetLoop", "FleetPlan", "FleetScheduler",
    "HOST_DRAINING", "HOST_FAILED", "HOST_UP",
    "Host", "MachineClass", "Placement", "QosTier", "TenantAllocation",
    "TenantSpec", "TenantStep",
]
