"""One sense→forecast→plan→act→learn cycle across every tenant of the fleet.

:class:`FleetLoop` is the multi-tenant sibling of
:class:`repro_torch.control.loop.ControlLoop` and reuses its semantics piecewise:

* **sense** — each tenant's load sample becomes a provisioning target
  through its own :class:`~repro_torch.control.loop.GuardBands` (per-tenant
  headroom/deadband/anti-thrash, identical rules to the single-job loop;
  a measured SLA breach overrides any hold),
* **forecast** — tenants carrying a
  :class:`~repro_torch.control.forecast.Forecaster` are judged (and planned) at
  their forecast-window *peak* target: a predicted rise triggers a joint
  reschedule BEFORE the sensed breach, and the window's rates are scored
  inside the scheduler's single batched call (``TenantStep.cause``
  distinguishes such proactive steps from reactive guard steps),
* **plan** — if *any* tenant's guards demand action the WHOLE fleet is
  rescheduled jointly (:class:`FleetScheduler` — priority-ordered against
  the shared finite cluster, so a guaranteed tenant scaling up is exactly
  what sheds a best-effort tenant's capacity).  Replans are *warm*: the
  deployed plan is carried across steps as the scheduler's previous state,
  so unchanged tenants keep their hosts (zero container moves) and a
  squeezed higher tier defragments/preempts lower-tier residency instead
  of failing on fragmentation (``TenantStep.moves`` / ``.evicted`` audit
  both),
* **act** — every deployed configuration is measured at its offered load in
  ONE batched evaluation on the evaluator's device (``evaluate_jobs``);
  host speed scales capacity, so the reference-host simulator is driven at
  ``load / speed`` and its answer scaled back by the slowest host speed in
  the tenant's placement,
* **learn** — saturated measurements flow back into any tenant whose
  ``models`` is a :class:`~repro_torch.control.learning.ModelStore`
  (predict-back calibration, same rule as the single-job loop).

Every step emits one :class:`FleetEvent` carrying a per-tenant
:class:`TenantStep` log row — the event log the QoS acceptance criteria
read (who was degraded, who met their SLA, who got shed first).

**Host failures** are injected per step (``step(loads, failures=...)`` /
``run(traces, failures=...)``, fed from the scenario library's failure
traces).  A failure lands *mid-step*: the step's delivered capacity comes
from the previous deployment's SURVIVING containers (the replacement
containers the forced replan starts only serve from the next step), which
is exactly the window N+1 headroom exists to cover — with ``n1_tiers`` on,
the survivors alone still clear the SLA and the failure step books zero
breaches.  Controller state persists through :mod:`repro_torch.checkpoint`
(:meth:`FleetLoop.checkpoint` / :meth:`FleetLoop.restore`), so a restarted
controller resumes with the learned models, calibration and forecaster
state of the dead one.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Iterable, Mapping, Sequence

from ..streams.engine import evaluate_jobs_with
from .cluster import Cluster
from .scheduler import FleetPlan, FleetScheduler, QosTier, TenantSpec

if TYPE_CHECKING:
    from ..streams.engine import ConfigEvaluator


@dataclasses.dataclass
class TenantStep:
    """One tenant's slice of one fleet control step."""

    tenant: str
    qos: QosTier
    load: float
    target: float
    guard: str                 # bootstrap / breach / forecast / ... / deadband
    planned_ktps: float
    achieved_ktps: float
    cpus: float
    degraded: bool             # the budget bound this tenant's allocation
    admitted: bool
    sla_met: bool              # achieved >= saturation_threshold * load
    bottleneck: str | None
    #: why this tenant demanded action: "guard" (reactive threshold),
    #: "forecast" (proactive window-peak), "measured-sla" (breach
    #: override), "bootstrap", or "" when this tenant's guards held
    cause: str = ""
    #: containers this tenant started or relocated this step (0 on held
    #: steps and for warm-placed tenants whose allocation did not change)
    moves: int = 0
    #: containers of this tenant preempted by higher tiers this step
    evicted: int = 0
    #: containers of this tenant marked draining this step (eviction grace:
    #: still serving, reclaimed at the next replan)
    draining: int = 0
    #: this tenant's repack was deferred by the scheduler's move budget —
    #: it keeps its previous deployment and is retried next replan
    deferred: bool = False
    #: containers this tenant lost to failed hosts this step (its achieved
    #: rate was measured on the survivors; replacements serve next step)
    failover: int = 0


@dataclasses.dataclass
class FleetEvent:
    """One uniform log row per fleet step."""

    step: int
    replanned: bool
    cores_total: float
    cores_used: float
    tenants: list[TenantStep]
    #: why the fleet replanned, aggregated over the tenants that demanded
    #: action — "measured-sla" dominates "guard" dominates "forecast"
    #: (a purely proactive reschedule is exactly ``cause == "forecast"``);
    #: "" when no tenant acted
    cause: str = ""
    #: containers started or relocated by this step's replan (0 on held
    #: steps; a replan with unchanged demands also moves 0 — warm placement)
    moves: int = 0
    #: containers preempted by this step's replan, across all tenants
    evicted: int = 0
    #: hosts down at the end of this step (cluster lifecycle snapshot)
    failed_hosts: tuple = ()
    #: this step's forced displacements: ``(tenant, host, containers)``
    #: straight from ``FleetPlan.failover``
    failover: tuple = ()

    def tenant(self, name: str) -> TenantStep:
        for t in self.tenants:
            if t.tenant == name:
                return t
        raise KeyError(name)

    @property
    def degraded_tenants(self) -> list[str]:
        return [t.tenant for t in self.tenants if t.degraded]

    @property
    def proactive(self) -> bool:
        """The fleet replanned purely on forecasts — ahead of any sensed
        guard threshold or measured breach."""
        return self.replanned and self.cause == "forecast"


class _ModelVersionClock:
    """Fleet-wide result-cache invalidation token: the tuple of every
    tenant :class:`~repro_torch.control.learning.ModelStore`'s ``version``
    counter.  Any observe/retrain anywhere in the fleet changes the tuple,
    so evaluations cached before that calibration can no longer be
    returned (see ``SimulatorEvaluator.version_source``)."""

    __slots__ = ("_stores",)

    def __init__(self, stores) -> None:
        self._stores = tuple(stores)

    @property
    def version(self) -> tuple:
        return tuple(s.version for s in self._stores)


class FleetLoop:
    """The fleet-wide sense→plan→act→learn controller.

    ``saturation_threshold`` mirrors the single-job loop: a measurement
    below ``threshold * load`` is an SLA miss — it re-arms that tenant's
    breach override and (if the tenant carries a ``ModelStore``) feeds
    predict-back calibration.  A tenant whose *plan* was deliberately
    degraded is judged against what it was promised (its planned rate), not
    against the full offered load — otherwise a shed best-effort tenant
    would force a futile replan every step.
    """

    def __init__(
        self,
        tenants: Sequence[TenantSpec],
        cluster: Cluster,
        evaluator: "ConfigEvaluator | None" = None,
        saturation_threshold: float = 0.95,
        incremental: bool = True,
        move_budget: int | None = None,
        eviction_grace: bool = False,
        anti_affinity: bool = False,
        n1_tiers: "Sequence[QosTier] | None" = None,
    ) -> None:
        names = [t.name for t in tenants]
        if len(set(names)) != len(names):
            raise ValueError("duplicate tenant names")
        self.tenants = list(tenants)
        self.cluster = cluster
        self.evaluator = evaluator
        # wire the result cache's invalidation clock when the evaluator
        # supports one and the caller left it unset: per-tenant ModelStore
        # version bumps (observe on saturated measurements, retrain) must
        # miss, while steady replans keep hitting
        stores = [
            t.models for t in self.tenants
            if getattr(t.models, "version", None) is not None
        ]
        if (
            evaluator is not None
            and stores
            and getattr(evaluator, "version_source", False) is None
        ):
            evaluator.version_source = _ModelVersionClock(stores)
        self.scheduler = FleetScheduler(
            cluster, evaluator, feasibility_threshold=saturation_threshold,
            incremental=incremental, move_budget=move_budget,
            eviction_grace=eviction_grace,
            anti_affinity=anti_affinity, n1_tiers=n1_tiers,
        )
        self.saturation_threshold = saturation_threshold
        self.plan: FleetPlan | None = None
        self.events: list[FleetEvent] = []
        self._last_target: dict[str, float] = {n: 0.0 for n in names}
        self._breached: dict[str, bool] = {n: False for n in names}

    # -- one cycle ----------------------------------------------------------
    def step(
        self,
        loads: Mapping[str, float],
        failures: "Sequence[tuple[str, str]] | None" = None,
    ) -> FleetEvent:
        # failures land first: ``(kind, target)`` events mutate the
        # cluster's lifecycle state and force a replan.  This step's
        # delivered capacity comes from the PREVIOUS deployment's surviving
        # containers (replacements only serve next step) — see the module
        # docstring for the mid-step timing model
        failure_events = tuple(failures or ())
        for kind, target in failure_events:
            if kind == "fail":
                self.cluster.fail_host(target)
            elif kind == "recover":
                self.cluster.recover_host(target)
            elif kind == "drain":
                self.cluster.drain_host(target)
            elif kind == "fail-rack":
                self.cluster.fail_rack(target)
            elif kind == "recover-rack":
                self.cluster.recover_rack(target)
            else:
                raise ValueError(f"unknown failure event kind {kind!r}")
        prior_plan = self.plan

        # sense + forecast: per-tenant targets through per-tenant guards;
        # tenants with forecasters are judged at their window-peak target
        targets: dict[str, float] = {}
        guard_of: dict[str, str] = {}
        cause_of: dict[str, str] = {}
        windows: dict[str, list[float]] = {}
        replan = self.plan is None or bool(failure_events)
        for spec in self.tenants:
            load = float(loads[spec.name])
            target = spec.guards.target_for(load)
            plan_target = target
            if spec.forecaster is not None:
                spec.forecaster.observe(load)
                fc = [
                    float(x)
                    for x in spec.forecaster.forecast(max(1, int(spec.horizon)))
                ]
                windows[spec.name] = fc
                if fc:
                    plan_target = max(
                        target, spec.guards.target_for(max(fc))
                    )
            targets[spec.name] = plan_target
            if self.plan is None:
                guard_of[spec.name] = cause_of[spec.name] = "bootstrap"
                continue
            breached = self._breached[spec.name]
            act, reason = spec.guards.decide(
                plan_target, self._last_target[spec.name], breached
            )
            cause = ""
            if act:
                if reason == "breach":
                    cause = "measured-sla"
                elif spec.forecaster is not None:
                    # proactive iff the sensed target alone would NOT have
                    # produced this same decision (held, or acted the other
                    # way) — this tenant's demand is owed to its forecast
                    act_now, reason_now = spec.guards.decide(
                        target, self._last_target[spec.name], False
                    )
                    if act_now and reason_now == reason:
                        cause = "guard"
                    else:
                        reason = cause = "forecast"
                else:
                    cause = "guard"
            guard_of[spec.name] = reason
            cause_of[spec.name] = cause
            replan = replan or act

        # unfinished business forces a replan even when every guard holds:
        # a move-budget deferral must be retried (the budget resets each
        # round) and a draining container must be reclaimed (its grace
        # round is over)
        carried = ""
        if not replan and self.plan is not None and (
            self.plan.deferred
            or any(a.draining for a in self.plan.allocations)
        ):
            replan = True
            carried = "deferred"

        # plan: one joint scheduling round covers every tenant; forecast
        # windows ride the scheduler's single batched scoring call.  The
        # current plan is handed back in as the warm state: unchanged
        # tenants keep their hosts (zero moves) and a squeezed higher tier
        # preempts lower-tier residency instead of failing on fragmentation
        if replan:
            self.plan = self.scheduler.schedule(
                [(spec, targets[spec.name]) for spec in self.tenants],
                windows=windows or None,
                previous=self.plan,
            )
            for spec in self.tenants:
                self._last_target[spec.name] = targets[spec.name]
                self._breached[spec.name] = False
        assert self.plan is not None
        causes = {c for c in cause_of.values() if c}
        if failure_events:
            causes.add("failover")
        fleet_cause = carried
        if replan:
            for dominant in (
                "bootstrap", "failover", "measured-sla", "guard", "forecast"
            ):
                if dominant in causes:
                    fleet_cause = dominant
                    break

        # a lifecycle event lands mid-step: what serves THIS step is the
        # previous deployment's surviving containers — the replan above only
        # takes effect next step.  Build each tenant's survivor view of the
        # prior plan: (survivor config, min surviving host speed, containers
        # kept, containers deployed, prior allocation); config None = some
        # pipeline stage was wiped out entirely (delivers nothing)
        failure_step = bool(failure_events) and prior_plan is not None
        survivors: dict[str, tuple] = {}
        if failure_step:
            down = self.cluster.failed_hosts()
            for spec in self.tenants:
                pa = prior_plan.allocation(spec.name)
                if pa.config is None or pa.placement is None:
                    continue
                keep = [
                    ci
                    for ci, h in enumerate(pa.placement.host_names)
                    if h and h not in down
                ]
                cfg = (
                    self.scheduler._survivor_config(pa.config, keep)
                    if keep
                    else None
                )
                speed = (
                    min(
                        self.cluster.host_speed(pa.placement.host_names[ci])
                        for ci in keep
                    )
                    if cfg is not None
                    else 1.0
                )
                survivors[spec.name] = (
                    cfg, speed, len(keep), len(pa.config.dims), pa
                )

        # act: measure all deployed configs at their offered loads in one
        # batched call; values are (derated achieved, bottleneck,
        # reference-host achieved, reference-host load) — calibration must
        # see reference units or the speed derate is booked as model error
        measured: dict[str, tuple[float, str | None, float, float]] = {}
        if self.evaluator is not None:
            if failure_step:
                # failure steps drive the SURVIVOR configs, not the fresh
                # plan; a tenant with nothing left standing (or nothing
                # deployed before the failure) delivers zero this step
                admitted = [
                    (spec, survivors[spec.name][0], survivors[spec.name][1])
                    for spec in self.tenants
                    if survivors.get(spec.name, (None,))[0] is not None
                ]
                standing = {s.name for s, _c, _sp in admitted}
                for spec in self.tenants:
                    if spec.name not in standing:
                        measured[spec.name] = (0.0, None, 0.0, 0.0)
            else:
                admitted = [
                    (
                        spec,
                        self.plan.allocation(spec.name).config,
                        self.plan.allocation(spec.name).placement.min_speed
                        if self.plan.allocation(spec.name).placement
                        else 1.0,
                    )
                    for spec in self.tenants
                    if self.plan.allocation(spec.name).config is not None
                ]
            if admitted:
                # host speed scales *capacity*, not delivered rate: the
                # reference-host simulator is driven at load/speed and its
                # answer scaled back by speed, so an unsaturated tenant on a
                # slow host still achieves its full offered load
                groups = [[c] for _s, c, _sp in admitted]
                speeds = [sp for _s, _c, sp in admitted]
                offered = [
                    float(loads[s.name]) / sp
                    for (s, _c, _p), sp in zip(admitted, speeds)
                ]
                # per-step measurements also consume only scalar reductions
                # (achieved + bottleneck) — the fleet loop never pools
                # trajectories, so summary-mode evaluators ship no
                # trajectory bytes anywhere on a fleet trace
                evals = evaluate_jobs_with(self.evaluator, groups, offered)
                for (spec, _c, _p), sp, off, (ev,) in zip(
                    admitted, speeds, offered, evals
                ):
                    measured[spec.name] = (
                        min(ev.achieved_ktps * sp, float(loads[spec.name])),
                        ev.bottleneck,
                        ev.achieved_ktps,
                        off,
                    )

        # learn + event assembly
        lost_of: dict[str, int] = {}
        if replan:
            for tname, _host, n_lost in self.plan.failover:
                lost_of[tname] = lost_of.get(tname, 0) + int(n_lost)
        steps: list[TenantStep] = []
        for spec in self.tenants:
            load = float(loads[spec.name])
            alloc = self.plan.allocation(spec.name)
            if failure_step:
                # no-evaluator estimate of survivor capacity: the prior
                # promise, pro-rated by the surviving container fraction
                surv = survivors.get(spec.name)
                if surv is None or surv[0] is None:
                    fallback = 0.0
                else:
                    _cfg, _spd, kept, total, pa = surv
                    fallback = min(pa.predicted_ktps * kept / total, load)
            else:
                fallback = (
                    min(alloc.predicted_ktps, load) if alloc.admitted else 0.0
                )
            achieved, bottleneck, ref_achieved, ref_load = measured.get(
                spec.name, (fallback, alloc.bottleneck, 0.0, 0.0)
            )
            achieved = float(achieved)
            sla_met = achieved >= self.saturation_threshold * load
            # breach re-arms a replan only when the tenant was promised the
            # capacity it missed: a deliberately degraded tenant is judged
            # against its planned rate, and the promise is speed-derated
            # (predicted_ktps) — a plan the slow hardware can never deliver
            # must not force an identical futile replan every step
            promised = min(load, alloc.planned_ktps, alloc.predicted_ktps)
            self._breached[spec.name] = (
                alloc.admitted
                and achieved < self.saturation_threshold * promised
            )
            if spec.name in measured and not failure_step:
                # only real measurements may calibrate: the fallback above is
                # the planner's own prediction (mirrors ControlLoop skipping
                # learning when _measure() has no channel).  Calibration runs
                # in reference-host units — the node models describe a
                # speed-1.0 host, so observing the derated rate would book
                # the host speed as model error (and double-derate capacity).
                # Failure steps never calibrate: what was measured is a
                # survivor fragment, not ``alloc.config``, and booking its
                # shortfall against the full plan would corrupt the models
                self._learn(spec, alloc, ref_load, ref_achieved)
            steps.append(
                TenantStep(
                    tenant=spec.name,
                    qos=spec.qos,
                    load=load,
                    target=targets[spec.name],
                    guard=guard_of[spec.name],
                    planned_ktps=alloc.planned_ktps,
                    achieved_ktps=achieved,
                    cpus=alloc.cpus,
                    degraded=alloc.degraded,
                    admitted=alloc.admitted,
                    sla_met=sla_met,
                    bottleneck=bottleneck,
                    cause=cause_of.get(spec.name, "")
                    or ("failover" if lost_of.get(spec.name) else ""),
                    moves=alloc.moves if replan else 0,
                    evicted=alloc.evicted if replan else 0,
                    draining=len(alloc.draining),
                    deferred=alloc.deferred,
                    failover=lost_of.get(spec.name, 0),
                )
            )

        ev = FleetEvent(
            step=len(self.events),
            replanned=replan,
            cores_total=self.plan.cores_total,
            cores_used=self.plan.cores_used,
            tenants=steps,
            cause=fleet_cause,
            moves=self.plan.total_moves if replan else 0,
            evicted=sum(t.evicted for t in steps),
            failed_hosts=tuple(sorted(self.cluster.failed_hosts())),
            failover=self.plan.failover if replan else (),
        )
        self.events.append(ev)
        return ev

    def run(
        self,
        traces: Mapping[str, Iterable[float]],
        failures=None,
    ) -> list[FleetEvent]:
        """Drive the loop over per-tenant load traces (all equal length).

        ``failures`` injects host lifecycle events, either as a mapping
        ``step -> [(kind, target), ...]`` or as a flat iterable of
        ``(step, kind, target)`` tuples (the scenario library's failure
        traces emit the latter).  Step indices are relative to the start
        of THIS run, so a restored controller replaying a trace suffix
        re-applies the right schedule."""
        columns = {n: list(t) for n, t in traces.items()}
        lengths = {len(c) for c in columns.values()}
        if len(lengths) != 1:
            raise ValueError("per-tenant traces must share one length")
        by_step: dict[int, list[tuple[str, str]]] = {}
        if failures is not None:
            if hasattr(failures, "items"):
                for step, evs in failures.items():
                    by_step.setdefault(int(step), []).extend(
                        (k, t) for k, t in evs
                    )
            else:
                for step, kind, target in failures:
                    by_step.setdefault(int(step), []).append((kind, target))
        start = len(self.events)
        for i in range(lengths.pop()):
            self.step(
                {n: c[i] for n, c in columns.items()},
                failures=by_step.get(i),
            )
        return self.events[start:]

    # -- checkpointing -------------------------------------------------------
    def checkpoint(self, ckpt, blocking: bool = True) -> int:
        """Persist the controller's learned state — per-tenant models,
        calibration windows, forecaster state and guard memory — through a
        :class:`~repro_torch.checkpoint.Checkpointer`.  Returns the saved step."""
        from ..checkpoint.control_state import save_controller

        return save_controller(ckpt, self, blocking=blocking)

    def restore(self, ckpt) -> "int | None":
        """Load the newest valid checkpoint into this loop (None when the
        directory holds none).  The restored loop has no deployed plan —
        its next ``step()`` replans against the LIVE cluster (host health
        is re-observed, never trusted from disk) — but it plans with the
        dead controller's exact models, calibration and forecasts."""
        from ..checkpoint.control_state import restore_controller

        return restore_controller(ckpt, self)

    # -- internals ----------------------------------------------------------
    def _learn(
        self, spec: TenantSpec, alloc, load: float, achieved: float
    ) -> None:
        store = spec.models
        observe = getattr(store, "observe", None)
        if observe is None or alloc.config is None:
            return
        if achieved < self.saturation_threshold * load:
            # only a saturated measurement reveals true capacity (§4)
            observe(alloc.config, achieved)
