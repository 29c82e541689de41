"""QoS-aware, *stateful* multi-job scheduling over a shared :class:`Cluster`.

Trevor's central claim is that learned performance models let you
"optimally schedule logically specified jobs onto available physical
hardware".  One job against an infinite cluster (PRs 1-2) only exercises
half of that sentence; the interesting regime — per Phoebe and Daedalus
(PAPERS.md) — is N independent jobs with distinct QoS tiers contending for
one finite pool, *re-planned as conditions change*.  :class:`FleetScheduler`
is that arbiter:

* tenants are served in QoS order (guaranteed → standard → best-effort,
  ties broken by declared rate then name, so the outcome is deterministic),
* each tenant's allocation is the budget-constrained closed form
  (:func:`repro_torch.core.allocator.allocate_under_budget`) against the
  *remaining* host inventory — the feasibility predicate is a trial
  bin-packing, so fragmentation binds, not just aggregate cores,
* scheduling is **warm**: given the previous :class:`FleetPlan`, every
  tenant's containers stay seated on their current hosts and a replanned
  tenant's repack *prefers* its previous hosts — candidate placements are
  scored by a container-move cost (the state they would have to transfer)
  and the cheapest feasible repack wins.  A replan with unchanged demands
  moves zero containers,
* when a guaranteed/standard tenant's allocation is squeezed by lower-tier
  residency — its minimum footprint no longer trial-packs, or the bisected
  rate falls short — the scheduler **defragments** (compacts lower-tier
  residents onto fewer hosts, costing moves but no capacity) and then
  **preempts**: resident containers are evicted in reverse-QoS order
  (best-effort first, then previously-degraded standard, then standard)
  until the higher tier fits.  Evictions are recorded per tenant in the
  plan's eviction log,
* every tenant gets a *candidate set* (its dim × rounding ladder), and all
  tenants' candidate sets — plus every forecast-window rate — are scored in
  ONE batched evaluation on the evaluator's device
  (:meth:`ConfigEvaluator.evaluate_jobs`).  The measured scores pick the
  final deployment among the real alternatives: a provisional winner whose
  measured capacity misses the planned rate is swapped for the cheapest
  candidate that delivers it,
* predicted capacity is derated by the slowest host speed in the winning
  placement,
* replans are **incremental**: given a previous plan the scheduler computes
  a *touched set* — tenants whose demand, forecast window, or feasibility
  changed, plus tenants displaced by preemption/defrag — and every untouched
  tenant keeps its previous :class:`TenantAllocation` verbatim (zero packing
  work, zero evaluator slots), so scheduling latency scales with churn, not
  fleet size,
* candidate sets are **pruned** before the joint call: only trial-feasible
  candidates within ``prune_band``× the provisional winner's cpu footprint
  consume evaluator slots — the single batched call scores
  O(touched × pruned), not O(all × full ladder),
* actuation is bounded: ``move_budget`` caps voluntary container moves per
  replan (an over-budget repack is deferred — the tenant keeps its previous
  deployment and the deferral is carried in the plan, so a large repack
  amortizes over successive rounds), and ``eviction_grace`` gives preemption
  victims a drain round: they are marked draining, keep serving through the
  round, and are reclaimed at the next replan,
* **host failure is a first-class event**: ``schedule(...,
  failed_hosts=...)`` (or lifecycle state carried by the
  :class:`Cluster` itself) removes dead hosts from the inventory, turns
  every container they held into a *forced displacement* — re-placed
  through the same preemption/defrag/incremental machinery, exempt from
  ``move_budget``, logged in ``FleetPlan.failover`` — and with
  ``anti_affinity`` / ``n1_tiers`` enabled, placements are spread across
  failure domains and provisioned N+1 so losing any single host still
  meets the SLA while the replacement containers start.
"""
from __future__ import annotations

import dataclasses
import enum
import time
from collections import OrderedDict
from typing import TYPE_CHECKING, Mapping, Sequence

from ..core.allocator import (
    AllocationResult,
    ResourceBudget,
    allocate_point,
    allocate_under_budget,
)
from ..core.dag import Configuration, ContainerDim, DagSpec
from ..core.node_model import NodeModel
from ..control.loop import GuardBands
from ..streams.engine import OVERLOAD_KTPS, PerCandidateLoads, evaluate_jobs_with
from .cluster import Cluster, Host, Placement

if TYPE_CHECKING:
    from ..control.forecast import Forecaster
    from ..control.learning import ModelStore
    from ..streams.engine import ConfigEvaluator


class QosTier(enum.IntEnum):
    """Service tiers, in shedding order: best-effort capacity goes first."""

    BEST_EFFORT = 0
    STANDARD = 1
    GUARANTEED = 2


@dataclasses.dataclass
class TenantSpec:
    """One logically-specified job: a DAG, a declared rate, and a QoS tier.

    ``models`` may be a plain mapping or a :class:`ModelStore` (the fleet
    loop feeds saturated measurements back into a store).  ``guards`` are
    per-tenant :class:`GuardBands` — a best-effort tenant can run wider
    deadbands than a guaranteed one.  A per-tenant ``forecaster`` makes the
    fleet loop plan this tenant for its forecast-window peak over the next
    ``horizon`` steps — proactive joint reschedules ahead of the breach.

    ``candidate_dims`` / ``candidate_roundings`` define the tenant's
    candidate *set*: one closed-form allocation per (dim, rounding) pair is
    generated at the budget-feasible rate and scored in the scheduler's
    single batched call, so the repack chooses among real alternatives
    rather than trusting one analytic point.  The defaults score the
    preferred dim at both roundings; set ``candidate_roundings=("ceil",)``
    to pin the paper's conservative single point.
    """

    name: str
    dag: DagSpec
    target_ktps: float
    qos: QosTier = QosTier.STANDARD
    models: "ModelStore | Mapping[str, NodeModel] | None" = None
    guards: GuardBands = dataclasses.field(default_factory=GuardBands)
    preferred_dim: ContainerDim | None = None
    forecaster: "Forecaster | None" = None
    horizon: int = 4
    candidate_dims: Sequence[ContainerDim] | None = None
    candidate_roundings: Sequence[str] = ("ceil", "floor")

    def node_models(self) -> Mapping[str, NodeModel]:
        if self.models is None:
            raise ValueError(f"tenant {self.name} has no node models")
        models = getattr(self.models, "models", self.models)
        return models

    @property
    def overprovision(self) -> float:
        return float(getattr(self.models, "overprovision_factor", 1.0))


@dataclasses.dataclass
class TenantAllocation:
    """What one tenant got from a scheduling round."""

    tenant: str
    qos: QosTier
    requested_ktps: float              # the tenant's provisioning target
    planned_ktps: float                # rate the budget actually bought
    config: Configuration | None      # None: not admitted at all
    placement: Placement | None
    cpus: float
    predicted_ktps: float             # evaluator-scored capacity (speed-derated)
    bottleneck: str | None
    shortfall_ktps: float             # requested - planned (budget shed)
    degraded: bool                    # budget bound this tenant
    #: containers started or relocated relative to the previous plan (a
    #: container kept on its warm-preferred host costs nothing)
    moves: int = 0
    #: summed ``mem_mb`` of the moved containers — the state transferred
    move_cost: float = 0.0
    #: containers of THIS tenant preempted by higher tiers this round
    evicted: int = 0
    #: size of the candidate set scored for this tenant (1 without an
    #: evaluator: the analytic point is the only trusted alternative)
    candidates_scored: int = 1
    #: per-window-step measured rates (speed-derated), when the schedule was
    #: given a forecast window for this tenant — empty otherwise
    horizon_ktps: tuple = ()
    #: the deployment keeps up at every step of its forecast window
    horizon_feasible: bool = True
    #: the forecast window this allocation was planned against — incremental
    #: replans compare it to the incoming window to decide "touched"
    window: tuple = ()
    #: indices into ``config.dims`` of containers marked draining by an
    #: eviction-grace round: they keep serving through this round and are
    #: reclaimed (not re-seated) at the next replan
    draining: tuple = ()
    #: this tenant's repack was deferred by the move budget: it keeps its
    #: previous deployment (or stays shut out) until a later round
    deferred: bool = False
    #: N+1 verdict — None when this tenant's tier is not under ``n1_tiers``;
    #: True when losing any ONE host of the committed placement still
    #: delivers ``threshold × planned`` (measured through the joint
    #: evaluator call when one is present, closed-form otherwise)
    n1_feasible: "bool | None" = None

    @property
    def admitted(self) -> bool:
        return self.config is not None


@dataclasses.dataclass
class FleetPlan:
    """One joint placement of every tenant onto the cluster."""

    allocations: list[TenantAllocation]
    cores_total: float
    cores_used: float
    #: evictions in the order they happened: ``(victim tenant, victim QoS)``
    #: — reverse-QoS by construction (a higher tier is never touched while a
    #: lower tier still holds hosts)
    eviction_log: tuple = ()
    #: tenants actually replanned this round (everyone, on a cold or
    #: non-incremental schedule); the rest kept their allocation verbatim
    touched: tuple = ()
    #: tenants whose repack was deferred by the move budget — forced into
    #: the next round's touched set
    deferred: tuple = ()
    #: wall-time (seconds) per scheduling phase:
    #: restore / allocate / pack / score / repair / total
    timings: dict = dataclasses.field(default_factory=dict)
    #: evaluator rows *submitted* by this round's joint score (capacity
    #: probes + window rates across every touched tenant's candidate set).
    #: Pair with ``repro_torch.streams.dedup_info()``'s ``rows_executed`` to read
    #: the cross-tenant dedup factor straight off a plan.
    eval_rows: int = 0
    #: forced displacements off failed hosts, in previous-plan order:
    #: ``(tenant, failed host, containers lost)``.  Empty when no host
    #: failed between the previous plan and this one.
    failover: tuple = ()

    @property
    def cores_free(self) -> float:
        return self.cores_total - self.cores_used

    @property
    def draining(self) -> dict:
        """Per-tenant count of containers draining under eviction grace."""
        return {a.tenant: len(a.draining) for a in self.allocations if a.draining}

    @property
    def total_moves(self) -> int:
        """Containers started or relocated by this plan (0 for a replan
        with unchanged demands — the warm-placement contract)."""
        return sum(a.moves for a in self.allocations)

    @property
    def total_move_cost(self) -> float:
        return float(sum(a.move_cost for a in self.allocations))

    @property
    def evictions(self) -> dict:
        """Per-tenant count of containers preempted this round."""
        return {a.tenant: a.evicted for a in self.allocations if a.evicted}

    def allocation(self, tenant: str) -> TenantAllocation:
        for a in self.allocations:
            if a.tenant == tenant:
                return a
        raise KeyError(tenant)

    def describe(self) -> str:
        rows = []
        for a in self.allocations:
            state = "shut-out" if not a.admitted else (
                "degraded" if a.degraded else "full"
            )
            extra = ""
            if a.moves or a.evicted:
                extra = f" (moves={a.moves}, evicted={a.evicted})"
            rows.append(
                f"{a.tenant}[{a.qos.name.lower()}]: {state} "
                f"{a.planned_ktps:.0f}/{a.requested_ktps:.0f} ktps "
                f"on {a.cpus:.1f} cpus{extra}"
            )
        return "; ".join(rows)


@dataclasses.dataclass
class _Residency:
    """A tenant's containers still seated from the previous plan."""

    tenant: str
    qos: QosTier
    degraded: bool
    dims: list                # ContainerDim per still-seated container
    seated: list              # inventory index per container
    orig: list                # index into the previous config.dims per entry
    prev_names: tuple         # the previous plan's host names (warm prefs)


@dataclasses.dataclass
class _Candidate:
    """One (dim, rounding) alternative for a tenant, with its trial repack."""

    result: AllocationResult
    trial: Placement | None = None     # warm (or cold-fallback) trial pack
    warm: bool = True                  # the trial honored warm preferences
    #: closed-form N+1 verdict on the trial placement (None: not an N+1
    #: tenant); the measured verdict from the joint call refines it
    n1_ok: "bool | None" = None

    @property
    def config(self) -> Configuration:
        return self.result.config

    @property
    def feasible(self) -> bool:
        return self.trial is not None and self.trial.feasible

    @property
    def speed(self) -> float:
        return self.trial.min_speed if self.feasible else 1.0


class FleetScheduler:
    """Places N tenants onto one cluster through the evaluation engine.

    ``feasibility_threshold`` is the measured-feasibility bar used twice:
    a windowed tenant's deployment is ``horizon_feasible`` only when its
    (derated) measured rate reaches ``threshold * window_rate`` at every
    window step, and a candidate is swapped in by the measured repack only
    when its derated capacity reaches ``threshold * planned_rate``.  The
    fleet loop passes its own ``saturation_threshold`` here so "feasible at
    plan time" and "SLA met when the load arrives" are one judgment.

    Scale knobs:

    * ``incremental`` (default on) — with a ``previous`` plan, only the
      *touched set* is replanned; untouched tenants keep their allocation
      verbatim.  ``False`` restores the PR-5 behavior of re-deriving every
      tenant (still warm, still zero moves when nothing changed) — the
      scaling benchmark compares the two.
    * ``move_budget`` — cap on *voluntary* container moves per replan (a
      demand-driven repack whose trial placement would blow the remaining
      budget is deferred: the tenant keeps its previous deployment and is
      forced into the next round's touched set, so a large repack amortizes
      over ⌈moves/budget⌉ rounds).  Moves forced by a higher tier —
      preemption and defragmentation displacement — are exempt: deferring
      them would leave the displaced tenant's bookkeeping pointing at hosts
      it no longer holds.  The bootstrap round (no previous plan) is also
      exempt.
    * ``eviction_grace`` — preemption victims get a drain round: the
      eviction ladder runs against a ghost inventory, victims are marked
      draining (still serving, capacity still seated), and the beneficiary
      stays degraded until the next replan reclaims the drained containers.
    * ``prune_band`` — candidate-set pruning: only trial-feasible candidates
      within ``prune_band``× the provisional winner's cpu footprint are
      scored by the evaluator.

    Failure-domain knobs (both default OFF — with no failed hosts and both
    knobs off, plans are bitwise identical to a scheduler without them):

    * ``anti_affinity`` — spread every multi-container tenant across at
      least two hosts (two *racks* for guaranteed tenants on a multi-rack
      cluster), so no single failure domain holds all of a tenant's
      containers.  Best-effort: a cluster with one usable domain still
      places.
    * ``n1_tiers`` — QoS tiers provisioned N+1: candidate ladders gain
      inflated rungs sized so that losing any ONE host of the placement
      still delivers ``threshold × planned`` while replacements start.
      The verdict is *measured* — each candidate's single-host-loss
      survivor configurations are scored inside the same single batched
      ``evaluate_jobs`` call as the capacity probes — and recorded per
      tenant in :attr:`TenantAllocation.n1_feasible`.  N+1 tenants are
      implicitly spread host-level (headroom on one host is no headroom).
    """

    def __init__(
        self,
        cluster: Cluster,
        evaluator: "ConfigEvaluator | None" = None,
        feasibility_threshold: float = 0.95,
        incremental: bool = True,
        move_budget: int | None = None,
        eviction_grace: bool = False,
        prune_band: float = 2.0,
        anti_affinity: bool = False,
        n1_tiers: "Sequence[QosTier] | None" = None,
    ) -> None:
        self.cluster = cluster
        self.evaluator = evaluator
        self.feasibility_threshold = float(feasibility_threshold)
        self.incremental = bool(incremental)
        self.move_budget = None if move_budget is None else int(move_budget)
        if self.move_budget is not None and self.move_budget < 0:
            raise ValueError("move_budget must be >= 0")
        self.eviction_grace = bool(eviction_grace)
        self.prune_band = float(prune_band)
        self.anti_affinity = bool(anti_affinity)
        self.n1_tiers = frozenset(n1_tiers or ())
        # candidate-ladder memo: (spec identity, rate, models version,
        # overprovision) -> tuple of AllocationResults.  A fleet at steady
        # state re-derives the same (dim × rounding) ladder every replan;
        # memoizing the closed-form allocations keeps the *same*
        # Configuration objects flowing into the evaluator, so its
        # identity-keyed layout memo, the simulator's value-keyed
        # device-resident batch cache, and the cache-first evaluation path
        # (in-batch dedup + the evaluator's ResultCache) all hit.  The
        # models version token (see ModelStore.version) invalidates on
        # observe/retrain — the same token the result cache keys on, so
        # both layers stale out together; plain mappings are treated as
        # immutable.  Values hold the spec so the id in the key stays
        # valid.
        self._cand_memo: OrderedDict[tuple, tuple] = OrderedDict()

    @staticmethod
    def _priority_order(
        demands: Sequence[tuple[TenantSpec, float]]
    ) -> list[tuple[TenantSpec, float]]:
        return sorted(
            demands, key=lambda d: (-int(d[0].qos), -d[1], d[0].name)
        )

    def schedule(
        self,
        demands: Sequence[tuple[TenantSpec, float]],
        windows: "Mapping[str, Sequence[float]] | None" = None,
        previous: "FleetPlan | None" = None,
        failed_hosts: "Sequence[str] | None" = None,
    ) -> FleetPlan:
        """One joint scheduling round.

        Args:
            demands: ``(spec, target_ktps)`` pairs — each tenant with its
                current provisioning target.
            windows: optional map of tenant name → forecast window (future
                loads in ktps).  Windowed tenants' candidate sets are scored
                at every window rate *in the same single batched call* as
                the capacity probes, and the allocation reports per-step
                rates and whole-window feasibility.
            previous: the plan currently deployed.  When given, scheduling
                is *warm*: every tenant's containers start seated on their
                current hosts, a replanned tenant prefers its previous hosts
                (an unchanged allocation moves zero containers), and a
                guaranteed/standard tenant squeezed by lower-tier residency
                triggers the defragment-then-preempt ladder.  With
                ``incremental`` (the default) it is also the baseline for
                the *touched set*: tenants whose demand, window, and
                feasibility are unchanged keep their previous allocation
                verbatim.  ``None`` packs cold from an empty inventory
                (every container counts as a move).
            failed_hosts: host names that died since ``previous`` was
                deployed, in addition to any failures the cluster's own
                lifecycle state carries (:meth:`Cluster.fail_host`).  Dead
                hosts leave the inventory; every container the previous
                plan held on one becomes a *forced* displacement — always
                touched, exempt from ``move_budget``, recorded in
                ``FleetPlan.failover`` — re-placed through the ordinary
                preemption/defrag machinery, so a guaranteed tenant's
                re-placement may evict lower tiers but never the reverse.

        Returns:
            The :class:`FleetPlan` in the original demand order, carrying
            per-tenant ``moves`` / ``move_cost`` / ``evicted`` /
            ``draining``, the ordered ``eviction_log``, the ``touched`` and
            ``deferred`` tenant sets, and per-phase wall-time ``timings``.
        """
        t_start = time.perf_counter()
        names = [spec.name for spec, _t in demands]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate tenant names in demands: {names}")
        specs = {spec.name: spec for spec, _t in demands}
        # effective failed set: the caller's view plus the cluster's own
        # lifecycle state (inventory() already excludes the latter)
        failed = frozenset(failed_hosts or ()) | self.cluster.failed_hosts()
        hosts = self.cluster.inventory()
        if failed:
            hosts = [h for h in hosts if h.name not in failed]
        if not hosts:
            raise ValueError("every host in the cluster has failed")
        timings = {
            k: 0.0 for k in ("restore", "allocate", "pack", "score", "repair")
        }
        eval_rows = 0

        # -- failover: containers on dead hosts are forced displacements ----
        failover_log: list[tuple[str, str, int]] = []
        failover_forced: set[str] = set()
        if failed and previous is not None:
            for a in previous.allocations:
                if a.placement is None or a.tenant not in specs:
                    continue
                lost: dict[str, int] = {}
                for hname in a.placement.host_names:
                    if hname in failed:
                        lost[hname] = lost.get(hname, 0) + 1
                if lost:
                    failover_forced.add(a.tenant)
                    for hname in sorted(lost):
                        failover_log.append((a.tenant, hname, lost[hname]))

        # -- warm state: re-seat the previous plan's residency ---------------
        t0 = time.perf_counter()
        residency = self._restore_residency(previous, specs, hosts)
        touched = self._touched_set(demands, windows, previous, residency)
        if touched is not None:
            # failover displacements are always replanned, and residents of
            # a draining host must migrate off even though their container
            # count re-seated intact
            touched |= failover_forced
            drain = {h.name for h in hosts if h.status == "draining"}
            if drain:
                for rname, res in residency.items():
                    if any(
                        hi >= 0 and hosts[hi].name in drain
                        for hi in res.seated
                    ):
                        touched.add(rname)
        timings["restore"] = time.perf_counter() - t0

        evicted_count = {n: 0 for n in names}
        eviction_log: list[tuple[str, QosTier]] = []
        #: tenant -> config.dims indices marked draining this round (grace)
        drained_marks: dict[str, list[int]] = {}
        #: tenants whose residency was moved by defragmentation this round
        displaced: set[str] = set()
        prev_by = (
            {a.tenant: a for a in previous.allocations} if previous else {}
        )
        budget = self.move_budget if previous is not None else None
        moves_used = 0
        deferred: list[str] = []
        replanned: list[str] = []

        by_tenant: dict[str, TenantAllocation] = {}
        cand_sets: dict[str, list[_Candidate]] = {}
        chosen: dict[str, int] = {}
        prefer_of: dict[str, tuple] = {}

        multi_rack = len({h.rack for h in hosts if h.status == "up"}) > 1

        for spec, target in self._priority_order(demands):
            name = spec.name
            prev_alloc = prev_by.get(name)
            window = tuple(float(x) for x in (windows or {}).get(name, ()))
            forced = (
                name in displaced
                or evicted_count[name] > 0
                or name in failover_forced
            )

            if (
                prev_alloc is not None
                and prev_alloc.admitted
                and name in drained_marks
                and name not in displaced
                and name not in failover_forced
            ):
                # eviction grace: marked draining this round — the tenant
                # keeps serving its current deployment; the drained
                # containers are reclaimed at the next replan (restore
                # skips them, and "draining" forces it into the touched set).
                # A failover-displaced victim is excluded: handing back its
                # previous allocation verbatim would leave it "serving"
                # containers on a dead host, so it replans instead (its
                # fresh draining marks are dropped with it)
                by_tenant[name] = dataclasses.replace(
                    prev_alloc,
                    moves=0,
                    move_cost=0.0,
                    draining=tuple(sorted(drained_marks[name])),
                    deferred=False,
                )
                continue

            if touched is not None and name not in touched and not forced:
                # untouched: the previous allocation is kept verbatim — no
                # packing work, no evaluator slots — and its residency stays
                # seated (later, lower-priority tenants see it as occupied).
                # An allocation that is already clean (steady state after
                # one incremental round) is reused as-is: at 1,000 tenants
                # the per-tenant dataclasses.replace was itself a hot spot
                if (
                    prev_alloc.moves == 0
                    and prev_alloc.move_cost == 0.0
                    and prev_alloc.evicted == 0
                    and not prev_alloc.draining
                    and not prev_alloc.deferred
                ):
                    by_tenant[name] = prev_alloc
                else:
                    by_tenant[name] = dataclasses.replace(
                        prev_alloc,
                        moves=0,
                        move_cost=0.0,
                        evicted=0,
                        draining=(),
                        deferred=False,
                    )
                continue

            if budget is not None and moves_used >= budget and not forced:
                # move budget exhausted: defer before any allocation work
                # (no preemption runs on behalf of a deferred tenant); the
                # residency stays seated
                by_tenant[name] = self._deferred_alloc(spec, target, prev_alloc)
                deferred.append(name)
                continue

            replanned.append(name)
            # release this tenant's own residency: it is being replanned and
            # its capacity is its own to reuse (warm preference keeps the
            # containers on the same hosts when the shape allows it)
            res = residency.pop(name, None)
            prefer = res.prev_names if res is not None else ()
            prefer_of[name] = prefer
            if res is not None:
                for hi, dim in zip(res.seated, res.dims):
                    if hi >= 0:
                        hosts[hi].release(dim)

            t0 = time.perf_counter()
            ba = self._allocate(spec, target, hosts)
            if (ba.degraded or not ba.fits) and spec.qos > QosTier.BEST_EFFORT:
                # the squeeze is (possibly) lower-tier residency: defragment,
                # then preempt in reverse-QoS order, until this tenant fits
                ba = self._make_room(
                    spec, target, ba, hosts, residency,
                    evicted_count, eviction_log, displaced, drained_marks,
                )
            timings["allocate"] += time.perf_counter() - t0
            if not ba.fits:
                by_tenant[name] = self._shut_out(spec, target, window=window)
                continue

            n1 = spec.qos in self.n1_tiers
            spread = self._spread_for(spec.qos, multi_rack)
            t0 = time.perf_counter()
            cands = self._candidate_set(spec, ba)
            if n1:
                self._extend_n1(spec, ba, cands)
            pick = self._trial_candidates(
                cands, hosts, prefer, spread=spread,
                n1_planned=ba.feasible_rate_ktps if n1 else None,
            )
            if pick is None:
                timings["pack"] += time.perf_counter() - t0
                by_tenant[name] = self._shut_out(spec, target, window=window)
                continue
            winner = cands[pick]

            if (
                budget is not None
                and not forced
                and moves_used + (winner.trial.moves if winner.trial else 0)
                    > budget
            ):
                # this repack would blow the remaining move budget: defer
                # it and put the released residency back where it was
                if res is not None:
                    for hi, dim in zip(res.seated, res.dims):
                        if hi >= 0:
                            hosts[hi].place(dim)
                    residency[name] = res
                replanned.pop()
                by_tenant[name] = self._deferred_alloc(spec, target, prev_alloc)
                deferred.append(name)
                timings["pack"] += time.perf_counter() - t0
                continue

            placement = Cluster.pack(
                winner.config.dims, hosts,
                prefer=prefer if winner.warm else None,
                spread=spread,
            )
            moves_used += placement.moves
            timings["pack"] += time.perf_counter() - t0
            chosen[name] = pick
            cand_sets[name] = cands
            by_tenant[name] = TenantAllocation(
                tenant=name,
                qos=spec.qos,
                requested_ktps=target,
                planned_ktps=ba.feasible_rate_ktps,
                config=winner.config,
                placement=placement,
                cpus=winner.config.total_cpus(),
                predicted_ktps=ba.feasible_rate_ktps * placement.min_speed,
                bottleneck=None,
                shortfall_ktps=ba.shortfall_ktps,
                degraded=ba.degraded,
                moves=placement.moves,
                move_cost=placement.move_cost,
                candidates_scored=len(cands),
                window=window,
                n1_feasible=winner.n1_ok if n1 else None,
            )

        # joint scoring: every *replanned* admitted tenant's pruned candidate
        # set — one capacity probe per candidate plus, per forecast-window
        # rate, one per-candidate-load group — in ONE batched call on the
        # evaluator's device.  The measured scores then run the repack
        # repair: a provisional winner that misses its planned rate is
        # swapped for the cheapest candidate that delivers it.
        if self.evaluator is not None:
            eval_rows = self._score_and_repair(
                by_tenant, cand_sets, chosen, prefer_of, windows, hosts,
                timings, multi_rack,
            )

        # a tenant whose window was never scored — shed entirely, or no
        # evaluator to measure with — must not claim whole-window coverage;
        # untouched tenants carry their previously scored window forward
        if windows:
            for name in replanned:
                a = by_tenant[name]
                if windows.get(name) and not a.horizon_ktps:
                    a.horizon_feasible = False

        for name, n in evicted_count.items():
            by_tenant[name].evicted = n
        allocations = [by_tenant[spec.name] for spec, _t in demands]
        timings["total"] = time.perf_counter() - t_start
        return FleetPlan(
            allocations=allocations,
            cores_total=float(sum(h.cores for h in hosts)),
            cores_used=float(sum(a.cpus for a in allocations)),
            eviction_log=tuple(eviction_log),
            touched=tuple(replanned),
            deferred=tuple(deferred),
            timings=timings,
            eval_rows=eval_rows,
            failover=tuple(failover_log),
        )

    # -- warm state -----------------------------------------------------------
    @staticmethod
    def _restore_residency(
        previous: "FleetPlan | None",
        specs: Mapping[str, TenantSpec],
        hosts: list[Host],
    ) -> dict[str, _Residency]:
        """Seat the previous plan's containers back onto the fresh
        inventory (by host *name* — robust to a changed cluster; containers
        whose host is gone are simply not restored).  Tenants absent from
        the current demands are dropped entirely: their capacity is free.
        Containers the previous round marked ``draining`` (eviction grace)
        are *reclaimed* here: their grace round is over, so they are simply
        not re-seated and their capacity is free for the beneficiary."""
        residency: dict[str, _Residency] = {}
        if previous is None:
            return residency
        by_name = {h.name: i for i, h in enumerate(hosts)}
        for a in previous.allocations:
            if a.config is None or a.placement is None:
                continue
            spec = specs.get(a.tenant)
            if spec is None:
                continue
            draining = set(a.draining)
            dims: list = []
            seated: list = []
            orig: list = []
            for ci, (dim, hname) in enumerate(
                zip(a.config.dims, a.placement.host_names)
            ):
                if ci in draining:
                    continue
                hi = by_name.get(hname, -1)
                if hi >= 0 and hosts[hi].can_fit(dim):
                    hosts[hi].place(dim)
                    dims.append(dim)
                    seated.append(hi)
                    orig.append(ci)
            residency[a.tenant] = _Residency(
                tenant=a.tenant,
                qos=spec.qos,
                degraded=a.degraded,
                dims=dims,
                seated=seated,
                orig=orig,
                prev_names=tuple(a.placement.host_names),
            )
        return residency

    def _touched_set(
        self,
        demands: Sequence[tuple[TenantSpec, float]],
        windows: "Mapping[str, Sequence[float]] | None",
        previous: "FleetPlan | None",
        residency: dict[str, _Residency],
    ) -> "set[str] | None":
        """The tenants that must be replanned this round; ``None`` means
        everyone (cold start, or ``incremental=False``).

        A tenant is touched when its demand or forecast window changed,
        when its previous round left work unfinished (not admitted,
        degraded, deferred by the move budget, or draining under eviction
        grace — all worth retrying now that conditions moved), or when its
        residency could not be fully re-seated (hosts vanished or shrank).
        Tenants *displaced* by preemption/defragmentation join dynamically
        during the round — a victim is always strictly lower QoS than its
        beneficiary, so it is processed (and can be replanned) later in
        priority order."""
        if previous is None or not self.incremental:
            return None
        prev_by = {a.tenant: a for a in previous.allocations}
        touched = set(previous.deferred)
        for spec, target in demands:
            name = spec.name
            a = prev_by.get(name)
            if a is None:
                touched.add(name)
                continue
            if not a.admitted or a.degraded or a.deferred or a.draining:
                touched.add(name)
                continue
            if abs(float(target) - a.requested_ktps) > 1e-9:
                touched.add(name)
                continue
            window = tuple(float(x) for x in (windows or {}).get(name, ()))
            if window != tuple(a.window):
                touched.add(name)
                continue
            res = residency.get(name)
            if res is None or len(res.dims) != len(a.config.dims):
                touched.add(name)
        return touched

    # -- allocation -----------------------------------------------------------
    def _allocate(self, spec: TenantSpec, target: float, hosts: list[Host]):
        # the shrinking host inventory is the single source of truth: the
        # trial-pack predicate is strictly stronger than any aggregate
        # cpu/mem budget (fragmentation binds too)
        return allocate_under_budget(
            spec.dag,
            spec.node_models(),
            max(target, 1e-6),
            ResourceBudget(),
            preferred_dim=spec.preferred_dim,
            overprovision=spec.overprovision,
            fits=lambda cfg: Cluster.trial_pack(cfg.dims, hosts),
        )

    def _shut_out(
        self,
        spec: TenantSpec,
        target: float,
        window: tuple = (),
        deferred: bool = False,
    ) -> TenantAllocation:
        return TenantAllocation(
            tenant=spec.name,
            qos=spec.qos,
            requested_ktps=target,
            planned_ktps=0.0,
            config=None,
            placement=None,
            cpus=0.0,
            predicted_ktps=0.0,
            bottleneck=None,
            shortfall_ktps=target,
            degraded=True,
            window=window,
            deferred=deferred,
        )

    def _deferred_alloc(
        self,
        spec: TenantSpec,
        target: float,
        prev_alloc: "TenantAllocation | None",
    ) -> TenantAllocation:
        """Move budget says not this round: the tenant keeps its previous
        deployment exactly (containers stay seated; ``draining`` carries
        through so a pending reclaim is not forgotten) — or stays shut out —
        and ``deferred=True`` forces it into the next round's touched set."""
        if prev_alloc is not None and prev_alloc.admitted:
            return dataclasses.replace(
                prev_alloc,
                requested_ktps=float(target),
                shortfall_ktps=max(
                    0.0, float(target) - prev_alloc.planned_ktps
                ),
                moves=0,
                move_cost=0.0,
                evicted=0,
                deferred=True,
            )
        return self._shut_out(spec, target, deferred=True)

    # -- preemption + defragmentation ladder ---------------------------------
    def _make_room(
        self,
        spec: TenantSpec,
        target: float,
        ba,
        hosts: list[Host],
        residency: dict[str, _Residency],
        evicted_count: dict[str, int],
        eviction_log: list,
        displaced: set,
        drained_marks: dict,
    ):
        """Reclaim capacity held by strictly-lower-tier residents until
        ``spec``'s allocation stops being degraded (or nothing is left to
        reclaim).  Cheapest remedy first:

        1. **defragment** — compact the lower-tier residents onto fewer
           hosts (first-fit-decreasing repack of their containers; costs
           moves, sheds no capacity).  Residents whose containers actually
           moved are recorded in ``displaced`` so an incremental round
           replans them (their bookkeeping changed even if their demand
           did not),
        2. **preempt** — evict resident containers one at a time in
           reverse-QoS order: best-effort before standard, previously-
           degraded before healthy within a tier, largest container first
           (fastest reclaim).  Each eviction is appended to the plan's
           eviction log, so the order is auditable: a higher tier is never
           touched while a lower tier still holds hosts.  Under
           ``eviction_grace`` the ladder runs on a *ghost* inventory
           instead: victims are marked draining (``drained_marks``), keep
           serving through this round, and the beneficiary stays degraded
           until the next replan reclaims the drained containers.

        Returns the final (possibly unchanged) budgeted allocation.
        """

        def victims() -> list[_Residency]:
            return [
                r for r in residency.values() if r.qos < spec.qos and r.dims
            ]

        if not victims():
            return ba
        moved = self._compact(victims(), hosts)
        if moved:
            displaced.update(moved)
            ba = self._allocate(spec, target, hosts)
        if self.eviction_grace:
            if ba.degraded or not ba.fits:
                self._mark_draining(
                    spec, target, hosts, residency,
                    evicted_count, eviction_log, drained_marks,
                )
            return ba
        while ba.degraded or not ba.fits:
            queue = [
                (int(r.qos), 0 if r.degraded else 1, -r.dims[i].cpus,
                 r.tenant, i)
                for r in victims()
                for i in range(len(r.dims))
            ]
            if not queue:
                break
            queue.sort()
            _q, _d, _c, victim_name, ci = queue[0]
            victim = residency[victim_name]
            hi = victim.seated[ci]
            if hi >= 0:
                hosts[hi].release(victim.dims[ci])
            del victim.dims[ci]
            del victim.seated[ci]
            del victim.orig[ci]
            evicted_count[victim_name] += 1
            eviction_log.append((victim_name, victim.qos))
            ba = self._allocate(spec, target, hosts)
        return ba

    def _mark_draining(
        self,
        spec: TenantSpec,
        target: float,
        hosts: list[Host],
        residency: dict[str, _Residency],
        evicted_count: dict[str, int],
        eviction_log: list,
        drained_marks: dict,
    ) -> None:
        """Eviction grace: run the reverse-QoS eviction ladder against a
        *ghost* copy of the inventory and record the victims as draining
        instead of killing them now.  Marked containers stay seated on the
        real hosts (the victim keeps serving through this round); the next
        replan's residency restore skips them, which is when the capacity
        actually frees up.  Containers already marked this round (by an
        earlier beneficiary) are released on the ghost up front, so two
        squeezed tenants don't both count on the same draining capacity."""
        ghost = [h.clone() for h in hosts]
        marked: set = set()
        for vname, idxs in drained_marks.items():
            r = residency.get(vname)
            if r is None:
                continue
            for ci, oi in enumerate(r.orig):
                if oi in idxs and r.seated[ci] >= 0:
                    ghost[r.seated[ci]].release(r.dims[ci])
                    marked.add((vname, ci))
        ba_g = self._allocate(spec, target, ghost)
        while ba_g.degraded or not ba_g.fits:
            queue = [
                (int(r.qos), 0 if r.degraded else 1, -r.dims[i].cpus,
                 r.tenant, i)
                for r in residency.values()
                if r.qos < spec.qos
                for i in range(len(r.dims))
                if (r.tenant, i) not in marked
            ]
            if not queue:
                break
            queue.sort()
            _q, _d, _c, victim_name, ci = queue[0]
            victim = residency[victim_name]
            if victim.seated[ci] >= 0:
                ghost[victim.seated[ci]].release(victim.dims[ci])
            marked.add((victim_name, ci))
            drained_marks.setdefault(victim_name, []).append(victim.orig[ci])
            evicted_count[victim_name] += 1
            eviction_log.append((victim_name, victim.qos))
            ba_g = self._allocate(spec, target, ghost)

    @staticmethod
    def _compact(residents: list[_Residency], hosts: list[Host]) -> set:
        """Defragment: repack the given residents' containers first-fit-
        decreasing, consolidating the free space they fragment.  Applied
        only when a trial shows every container still fits (the previous
        arrangement is a feasibility witness, but FFD is a heuristic — a
        failed trial leaves everything in place).  Returns the names of the
        residents whose containers actually changed host (empty set: no
        compaction happened)."""
        items = [(r, i) for r in residents for i in range(len(r.dims))]
        if not items:
            return set()
        dims = [r.dims[i] for r, i in items]
        trial = [h.clone() for h in hosts]
        for r, i in items:
            if r.seated[i] >= 0:
                trial[r.seated[i]].release(r.dims[i])
        pl = Cluster.pack(dims, trial)
        if not pl.feasible:
            return set()
        if all(pl.host_of[j] == items[j][0].seated[items[j][1]]
               for j in range(len(items))):
            return set()
        for r, i in items:
            if r.seated[i] >= 0:
                hosts[r.seated[i]].release(r.dims[i])
        committed = Cluster.pack(dims, hosts)   # deterministic: same as pl
        moved: set = set()
        for j, (r, i) in enumerate(items):
            if committed.host_of[j] != r.seated[i]:
                moved.add(r.tenant)
            r.seated[i] = committed.host_of[j]
        return moved

    # -- candidate sets -------------------------------------------------------
    def _candidate_set(self, spec: TenantSpec, ba) -> list[_Candidate]:
        """The tenant's (dim × rounding) ladder at the budget-feasible rate.

        Index 0 is always the bisected base point (``allocate_under_budget``'s
        own result); without an evaluator there is nothing to check the
        leaner alternatives against, so the base is the whole set."""
        base = _Candidate(result=ba.result)
        if self.evaluator is None:
            return [base]
        rate = max(ba.feasible_rate_ktps, 1e-6)
        cands = [base]
        seen = {(base.config.packing, base.config.dims)}
        for res in self._ladder_results(spec, rate):
            key = (res.config.packing, res.config.dims)
            if key not in seen:
                seen.add(key)
                cands.append(_Candidate(result=res))
        return cands

    def _ladder_results(self, spec: TenantSpec, rate: float) -> tuple:
        """The (dim × rounding) closed-form allocations at ``rate``,
        memoized on (spec, rate, models version): at steady state every
        replan re-derives the identical ladder, and returning the *same*
        AllocationResult (hence Configuration) objects lets the evaluator's
        identity memo and the simulator's resident batch cache hit.  The
        version token tracks ModelStore mutation; ``overprovision`` is in
        the key because calibration moves it between version bumps."""
        memo_key = (
            id(spec), float(rate),
            getattr(spec.models, "version", None), spec.overprovision,
        )
        hit = self._cand_memo.get(memo_key)
        if hit is not None:
            self._cand_memo.move_to_end(memo_key)
            return hit[1]
        dims_ladder: list[ContainerDim | None] = (
            list(spec.candidate_dims)
            if spec.candidate_dims
            else [spec.preferred_dim]
        )
        results = tuple(
            allocate_point(
                spec.dag, spec.node_models(), rate,
                preferred_dim=dim,
                overprovision=spec.overprovision,
                rounding=rounding,
            )
            for dim in dims_ladder
            for rounding in spec.candidate_roundings
        )
        self._cand_memo[memo_key] = (spec, results)
        if len(self._cand_memo) > 4096:
            self._cand_memo.popitem(last=False)
        return results

    def _spread_for(self, qos: QosTier, multi_rack: bool) -> str | None:
        """The anti-affinity domain for this tenant, or None.  Guaranteed
        tenants spread across *racks* when the cluster has more than one;
        everyone else (and every N+1 tenant — headroom concentrated on one
        host is no headroom) spreads across hosts."""
        n1 = qos in self.n1_tiers
        if not self.anti_affinity and not n1:
            return None
        if self.anti_affinity and qos == QosTier.GUARANTEED and multi_rack:
            return "rack"
        return "host"

    def _extend_n1(self, spec: TenantSpec, ba, cands: list[_Candidate]) -> None:
        """Append *inflated* candidate rungs for an N+1 tenant.  Each
        balanced-container template with ``r`` replicas absorbing
        ``rate_ktps`` each receives group rate ``g ≤ r·rate_ktps``; pushing
        the allocation rate past ``alloc · r·rate_ktps/g`` forces a spare
        replica into the group (rates propagate linearly), so losing any
        one replica leaves the original count.  The max of that factor
        across templates inflates every group at once; a second, larger
        rung adds margin for lopsided packings.  Trial packing (with
        host-level spread) and the measured survivor scoring decide which
        rung actually wins — an N+1 rung that does not fit simply loses."""
        res = ba.result
        alloc = max(res.target_rate_ktps, 1e-9)
        factor = 0.0
        for t in res.templates:
            g = res.predicted_node_rates.get(t.nodes[0], 0.0)
            if g > 0.0:
                factor = max(factor, t.replicas * t.rate_ktps / g)
        if factor <= 0.0:
            return
        seen = {(c.config.packing, c.config.dims) for c in cands}
        for bump in (1.02, 1.55):
            rate = alloc * factor * bump
            for r in self._ladder_results(spec, rate):
                key = (r.config.packing, r.config.dims)
                if key not in seen:
                    seen.add(key)
                    cands.append(_Candidate(result=r))

    def _n1_closed_form(
        self, result: AllocationResult, placement: Placement, planned: float
    ) -> bool:
        """Closed-form single-host-loss check: for every host the placement
        uses, losing it leaves each balanced-container template with
        ``r - lost`` of its ``r`` replicas.  Survivors run up to their
        per-container *sustainable* rate (``t.rate_ktps``), not just their
        planned share — an N+1 rung deliberately carries spare replicas, so
        the surviving capacity of a template is ``(r - lost) · rate``
        against its required group rate — and the worst template fraction,
        speed-derated, must still reach ``threshold × planned``.  The
        allocator lays containers out template-by-template in consecutive
        replica blocks, which is what maps containers back to templates."""
        spans: list[tuple[int, int]] = []
        i = 0
        for t in result.templates:
            spans.append((i, i + t.replicas))
            i += t.replicas
        hosts_used = {h for h in placement.host_of if h >= 0}
        bar = self.feasibility_threshold * planned
        for h in hosts_used:
            frac = 1.0
            for (lo, hi), t in zip(spans, result.templates):
                lost = sum(
                    1 for ci in range(lo, hi) if placement.host_of[ci] == h
                )
                if lost:
                    g = result.predicted_node_rates.get(t.nodes[0], 0.0)
                    cap = (t.replicas - lost) * t.rate_ktps
                    frac = min(
                        frac, cap / g if g > 0.0 else 0.0, 1.0
                    )
            survive = result.target_rate_ktps * frac * placement.min_speed
            if survive + 1e-9 < bar:
                return False
        return True

    def _trial_candidates(
        self,
        cands: list[_Candidate],
        hosts: list[Host],
        prefer,
        spread: str | None = None,
        n1_planned: float | None = None,
    ) -> int | None:
        """Warm trial-pack every candidate; return the index of the
        provisional winner — the cheapest feasible repack by
        ``(move_cost, cpus)`` — or None when nothing places.  For an N+1
        tenant (``n1_planned`` set) each feasible trial also gets the
        closed-form single-host-loss verdict, and candidates that survive
        outrank every one that does not."""
        best: tuple | None = None
        for k, cand in enumerate(cands):
            trial = [h.clone() for h in hosts]
            pl = Cluster.pack(cand.config.dims, trial, prefer=prefer,
                              spread=spread)
            cand.warm = True
            if not pl.feasible and prefer:
                # a preference-first order can wedge where plain FFD fits
                trial = [h.clone() for h in hosts]
                pl = Cluster.pack(cand.config.dims, trial, spread=spread)
                cand.warm = False
            cand.trial = pl
            if pl.feasible:
                if n1_planned is not None:
                    cand.n1_ok = self._n1_closed_form(
                        cand.result, pl, n1_planned
                    )
                key = (
                    0 if (n1_planned is None or cand.n1_ok) else 1,
                    pl.move_cost, cand.result.total_cpus, k,
                )
                if best is None or key < best[0]:
                    best = (key, k)
        return None if best is None else best[1]

    # -- joint scoring + measured repack repair -------------------------------
    def _pruned(self, cands: list[_Candidate], chosen_idx: int) -> list[int]:
        """Prune a tenant's dim×rounding candidate ladder to the indices
        worth spending evaluator slots on: placement-feasible candidates
        whose total CPU footprint sits within ``prune_band`` × the cheaper
        of (cheapest feasible, provisional winner).  Rungs far above the
        winner never win the cost-ordered repair; rungs that failed their
        trial pack can never be committed.  The provisional winner itself
        is always kept (the capacity probe and window rates are read at its
        index even when no repair fires)."""
        feasible = [k for k in range(len(cands)) if cands[k].feasible]
        if not feasible:
            return [chosen_idx]
        floor_cpus = min(cands[k].result.total_cpus for k in feasible)
        limit = self.prune_band * max(
            floor_cpus, cands[chosen_idx].result.total_cpus
        )
        kept = [
            k for k in feasible
            if cands[k].result.total_cpus <= limit + 1e-9
        ]
        if chosen_idx not in kept:
            kept.append(chosen_idx)
            kept.sort()
        if len(kept) < 2:
            # never strand the repair path: keep the cheapest feasible
            # fallback even when the band would prune everything else
            rest = sorted(
                (k for k in feasible if k not in kept),
                key=lambda k: (cands[k].result.total_cpus, k),
            )
            if rest:
                kept = sorted(kept + rest[:1])
        return kept

    def _survivor_config(
        self, config: Configuration, keep: Sequence[int]
    ) -> "Configuration | None":
        """The configuration left after dropping the containers NOT in
        ``keep`` (one host's worth) — or None when the loss wipes out every
        instance of some node (no rebalancing can save a pipeline stage
        that no longer exists)."""
        packing = tuple(config.packing[ci] for ci in keep)
        needed = {n for p in config.packing for n in p}
        present = {n for p in packing for n in p}
        if present != needed:
            return None
        return Configuration(
            dag=config.dag,
            packing=packing,
            dims=tuple(config.dims[ci] for ci in keep),
        )

    def _score_and_repair(
        self,
        by_tenant: dict[str, TenantAllocation],
        cand_sets: dict[str, list[_Candidate]],
        chosen: dict[str, int],
        prefer_of: dict[str, tuple],
        windows: "Mapping[str, Sequence[float]] | None",
        hosts: list[Host],
        timings: dict,
        multi_rack: bool = False,
    ) -> int:
        t0 = time.perf_counter()
        groups: list[list[Configuration]] = []
        loads: list = []
        spans: list[tuple] = []
        for name, a in by_tenant.items():      # insertion order = QoS order
            if a.config is None or name not in cand_sets:
                continue
            all_cands = cand_sets[name]
            kept = self._pruned(all_cands, chosen[name])
            cands = [all_cands[k] for k in kept]
            pos = kept.index(chosen[name])
            a.candidates_scored = len(cands)
            cfgs = [c.config for c in cands]
            speeds = [c.speed for c in cands]
            window = list((windows or {}).get(name, ()))
            groups.append(cfgs)
            loads.append(OVERLOAD_KTPS)        # capacity probes, ref units
            for rate in window:
                # the reference-host simulator is driven at rate/speed and
                # its answer scaled back by speed (fleet-loop rule) — each
                # candidate at its own trial-placement speed, one group
                groups.append(cfgs)
                loads.append(
                    PerCandidateLoads(float(rate) / s for s in speeds)
                )
            # N+1 survivor rows: for every candidate of an N+1 tenant, the
            # configuration left by each single-host loss — capacity-probed
            # in the SAME batched call.  ``surv_of[k]`` is (start, count)
            # into the extra group, None for a candidate some loss wipes
            # out (a node type gone, or everything on one host).
            surv_cfgs: list[Configuration] = []
            surv_speeds: list[float] = []
            surv_of: "list[tuple[int, int] | None] | None" = None
            if a.qos in self.n1_tiers:
                surv_of = []
                for c in cands:
                    if not c.feasible:
                        surv_of.append(None)
                        continue
                    pl = c.trial
                    used = sorted({h for h in pl.host_of if h >= 0})
                    if len(used) < 2:
                        surv_of.append(None)
                        continue
                    start = len(surv_cfgs)
                    ok = True
                    for h in used:
                        keep_idx = [
                            ci for ci in range(len(pl.host_of))
                            if pl.host_of[ci] >= 0 and pl.host_of[ci] != h
                        ]
                        cfg = self._survivor_config(c.config, keep_idx)
                        if cfg is None:
                            ok = False
                            break
                        surv_cfgs.append(cfg)
                        surv_speeds.append(min(
                            hosts[pl.host_of[ci]].speed for ci in keep_idx
                        ))
                    if ok:
                        surv_of.append((start, len(used)))
                    else:
                        del surv_cfgs[start:]
                        del surv_speeds[start:]
                        surv_of.append(None)
                if surv_cfgs:
                    groups.append(surv_cfgs)
                    loads.append(OVERLOAD_KTPS)
            spans.append(
                (a, cands, pos, speeds, window, surv_of, surv_speeds)
            )
        if not groups:
            return 0
        eval_rows = sum(len(g) for g in groups)
        # joint score reads only achieved_ktps per row: under the summary-
        # mode SimulatorEvaluator default, a 1,000-tenant replan transfers
        # kilobytes of on-device reductions instead of every candidate's
        # full metric trajectory (values are exactly the full-mode ones)
        evals = evaluate_jobs_with(self.evaluator, groups, loads)
        timings["score"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        i = 0
        for a, cands, pos, speeds, window, surv_of, surv_speeds in spans:
            caps = evals[i]
            derated = [
                caps[k].achieved_ktps * speeds[k] for k in range(len(cands))
            ]
            bar = self.feasibility_threshold * a.planned_ktps
            # measured N+1 verdict per candidate: every single-host-loss
            # survivor must still deliver the bar at its surviving speed
            n1_meas: "list[bool] | None" = None
            has_surv = surv_of is not None and any(
                s is not None for s in surv_of
            )
            if surv_of is not None:
                srows = evals[i + 1 + len(window)] if has_surv else []
                n1_meas = []
                for k in range(len(cands)):
                    span = surv_of[k]
                    if span is None:
                        n1_meas.append(False)
                        continue
                    start, count = span
                    n1_meas.append(all(
                        srows[j].achieved_ktps * surv_speeds[j] >= bar
                        for j in range(start, start + count)
                    ))
            final = pos
            if derated[final] < bar or (
                n1_meas is not None and not n1_meas[final]
            ):
                final = self._repair(
                    a, cands,
                    [c.achieved_ktps for c in caps], derated, bar, final,
                    hosts, prefer_of[a.tenant],
                    spread=self._spread_for(a.qos, multi_rack),
                    eligible=n1_meas,
                )
            if n1_meas is not None:
                a.n1_feasible = n1_meas[final]
            # derate by the speed of the placement actually committed: for
            # the provisional winner it equals the trial speed, and for a
            # repair swap it reflects where the live repack really landed
            # (the drive rate used the trial speed — a small approximation
            # the feasibility threshold absorbs)
            spd = a.placement.min_speed if a.placement else 1.0
            a.predicted_ktps = caps[final].achieved_ktps * spd
            a.bottleneck = caps[final].bottleneck
            rates = tuple(
                evals[i + 1 + w][final].achieved_ktps * spd
                for w in range(len(window))
            )
            a.horizon_ktps = rates
            a.horizon_feasible = all(
                r >= self.feasibility_threshold * ref
                for r, ref in zip(rates, window)
            )
            i += 1 + len(window) + (1 if has_surv else 0)
        timings["repair"] += time.perf_counter() - t0
        return eval_rows

    def _repair(
        self,
        a: TenantAllocation,
        cands: list[_Candidate],
        ref_caps: list[float],
        derated: list[float],
        bar: float,
        current: int,
        hosts: list[Host],
        prefer,
        spread: str | None = None,
        eligible: "list[bool] | None" = None,
    ) -> int:
        """The provisional winner's measured capacity misses the planned
        rate (or, for an N+1 tenant, flunks the measured survivor check —
        ``eligible``): swap in the cheapest candidate that delivers it (or,
        when nothing reaches the bar, the one that gets closest — mirroring
        :func:`repro_torch.core.allocator.allocate`'s fallback).  The swap
        re-places on the live inventory, and the bar is re-checked against
        the speed of the placement the repack *actually* lands (the trial
        speed may be stale — lower tiers consumed the fast hosts since):
        a candidate that no longer fits, or no longer clears the bar where
        it really lands, is skipped and the original placement restored.
        ``ref_caps`` are the reference-host (un-derated) capacity probes."""
        meets = [
            k for k in range(len(cands))
            if k != current and cands[k].feasible and derated[k] >= bar
            and (eligible is None or eligible[k])
        ]
        meets.sort(
            key=lambda k: (
                cands[k].trial.move_cost, cands[k].result.total_cpus, k
            )
        )
        strict = True
        if not meets:
            if derated[current] >= bar:
                # capacity holds and no candidate fixes the N+1 shortfall:
                # keep the winner (n1_feasible stays False — the honest
                # answer on a cluster without room for headroom)
                return current
            best = max(range(len(cands)), key=lambda k: derated[k])
            if best == current or derated[best] <= derated[current]:
                return current
            meets = [best]
            strict = False       # best-effort capacity grab: no bar to hold
        assert a.config is not None and a.placement is not None
        for k in meets:
            Cluster.release(a.placement, a.config.dims, hosts)
            trial = [h.clone() for h in hosts]
            pl = Cluster.pack(cands[k].config.dims, trial, prefer=prefer,
                              spread=spread)
            if pl.feasible and (
                not strict or ref_caps[k] * pl.min_speed >= bar
            ):
                committed = Cluster.pack(
                    cands[k].config.dims, hosts, prefer=prefer, spread=spread
                )
                a.config = cands[k].config
                a.placement = committed
                a.cpus = cands[k].config.total_cpus()
                a.moves = committed.moves
                a.move_cost = committed.move_cost
                return k
            # put the original back exactly where it was
            a.placement = Cluster.seat(
                a.config.dims, a.placement.host_names, hosts
            )
        return current
