"""Physical cluster model for the fleet layer.

Everything below the fleet scheduler so far assumed an implicit, infinite
cluster: ``allocate`` would happily return 400 containers.  A
:class:`Cluster` is the *finite* resource pool Trevor's "available physical
hardware" phrase refers to — a set of :class:`MachineClass` entries (count,
per-host cores/memory, relative host speed), flattened into a host
inventory that containers are bin-packed onto.

Speed semantics: the learned node models describe a reference host
(``speed = 1.0``).  A container placed on a ``speed = 0.8`` host sustains
80% of its modeled rate, so a tenant's predicted capacity is derated by the
*slowest* host its containers landed on (conservative — the slowest
container backpressures the whole pipeline).  The scheduler hands out fast
hosts first, so guaranteed tenants get the premium hardware when the pool
is heterogeneous.

Failure semantics: every host carries a lifecycle ``status`` (``up`` /
``draining`` / ``failed``) and a ``rack`` failure-domain label (defaulting
to its machine-class name — one rack per class).  A *failed* host vanishes
from :meth:`Cluster.inventory`, so a previous plan's containers on it
simply fail to re-seat and the scheduler re-places them.  A *draining*
host keeps its residents seated (they are still serving) but accepts no
new containers and loses its warm-placement pull, so residents migrate off
within one replan.  :meth:`Cluster.pack` optionally *spreads* a tenant's
containers across hosts or racks so no single failure domain holds all of
them — the anti-affinity half of surviving a failure.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

from ..core.dag import ContainerDim

_EPS = 1e-9

#: host lifecycle states
HOST_UP = "up"
HOST_DRAINING = "draining"
HOST_FAILED = "failed"


@dataclasses.dataclass(frozen=True)
class MachineClass:
    """``count`` identical hosts with per-host capacity and relative speed.

    ``rack`` is the failure domain every host of this class lives in; the
    empty default means "one rack per machine class" (the class name), the
    coarsest correlated-failure model that still distinguishes hardware
    pools.  Classes sharing an explicit rack label fail together under
    :meth:`Cluster.fail_rack`."""

    name: str
    count: int
    cores: float
    mem_mb: float
    speed: float = 1.0
    rack: str = ""

    def __post_init__(self) -> None:
        if self.count < 0:
            raise ValueError(f"machine class {self.name}: negative count")
        if self.cores <= 0 or self.mem_mb <= 0 or self.speed <= 0:
            raise ValueError(
                f"machine class {self.name}: cores/mem/speed must be positive"
            )

    @property
    def rack_name(self) -> str:
        return self.rack or self.name


@dataclasses.dataclass
class Host:
    """One physical machine with its remaining capacity (mutable inventory)."""

    name: str
    cores: float
    mem_mb: float
    speed: float
    cores_free: float
    mem_free: float
    rack: str = ""
    status: str = HOST_UP

    def can_fit(self, dim: ContainerDim) -> bool:
        return (
            self.cores_free >= dim.cpus - _EPS
            and self.mem_free >= dim.mem_mb - _EPS
        )

    def place(self, dim: ContainerDim) -> None:
        self.cores_free -= dim.cpus
        self.mem_free -= dim.mem_mb

    def release(self, dim: ContainerDim) -> None:
        """Return one container's capacity to this host (inverse of
        :meth:`place`) — incremental unpack for evictions and replans."""
        self.cores_free = min(self.cores, self.cores_free + dim.cpus)
        self.mem_free = min(self.mem_mb, self.mem_free + dim.mem_mb)

    def clone(self) -> "Host":
        # hot path: trial packs clone the whole inventory per candidate —
        # bypass dataclasses.replace/__init__ (hundreds of hosts × many
        # candidates per scheduling round)
        h = Host.__new__(Host)
        h.__dict__.update(self.__dict__)
        return h


@dataclasses.dataclass
class Placement:
    """Where one configuration's containers landed.

    ``host_of[c]`` is the index (into the inventory this placement was packed
    against) of the host carrying container ``c``; ``-1`` marks an unplaced
    container (the packing failed).  ``moves`` counts the containers that
    were *not* kept on their warm-preferred host — a container with no
    preference (a fresh start) counts as a move, a container re-seated on
    its previous host does not.  ``move_cost`` is the container state those
    moves have to transfer (the summed ``mem_mb`` of every moved container);
    schedulers minimize it when choosing between feasible repacks.
    """

    host_of: tuple[int, ...]
    host_names: tuple[str, ...]
    min_speed: float
    moves: int = 0
    move_cost: float = 0.0
    #: the requested anti-affinity spread was satisfied (trivially True when
    #: none was requested or fewer than two containers were placed); packing
    #: never *fails* on spread — a cluster with one usable domain still
    #: places, it just cannot survive losing it
    spread_ok: bool = True

    @property
    def feasible(self) -> bool:
        return all(h >= 0 for h in self.host_of)

    @property
    def n_unplaced(self) -> int:
        return sum(1 for h in self.host_of if h < 0)


class Cluster:
    """A finite pool of hosts built from machine classes."""

    def __init__(self, machines: Sequence[MachineClass]) -> None:
        self.machines = tuple(machines)
        if not any(m.count > 0 for m in self.machines):
            raise ValueError("cluster has no hosts")
        # host lifecycle: name -> status for every host NOT simply "up".
        # Kept sparse so the no-failure path costs nothing.
        self._status: dict[str, str] = {}
        self._rack_of: dict[str, str] = {}
        self._class_of: dict[str, MachineClass] = {}
        for m in self.machines:
            for i in range(m.count):
                hname = f"{m.name}/{i}"
                self._rack_of[hname] = m.rack_name
                self._class_of[hname] = m

    # -- host lifecycle -------------------------------------------------------
    def _check_host(self, name: str) -> None:
        if name not in self._rack_of:
            raise KeyError(f"unknown host {name!r}")

    def host_names(self) -> tuple[str, ...]:
        """Every host name in this cluster (regardless of status)."""
        return tuple(self._rack_of)

    def rack_of(self, name: str) -> str:
        self._check_host(name)
        return self._rack_of[name]

    def host_speed(self, name: str) -> float:
        self._check_host(name)
        return self._class_of[name].speed

    def racks(self) -> tuple[str, ...]:
        """Distinct failure-domain labels, in machine-class order."""
        out: list[str] = []
        for m in self.machines:
            if m.count > 0 and m.rack_name not in out:
                out.append(m.rack_name)
        return tuple(out)

    def host_status(self, name: str) -> str:
        self._check_host(name)
        return self._status.get(name, HOST_UP)

    def fail_host(self, name: str) -> None:
        """Mark one host failed: it leaves the inventory entirely and every
        container it carried becomes a forced displacement at the next
        :meth:`FleetScheduler.schedule` round."""
        self._check_host(name)
        self._status[name] = HOST_FAILED

    def drain_host(self, name: str) -> None:
        """Mark one host draining: residents keep serving but no new
        container lands there and warm preference stops pulling, so the
        next replan migrates them off (planned maintenance)."""
        self._check_host(name)
        self._status[name] = HOST_DRAINING

    def recover_host(self, name: str) -> None:
        """Return a failed or draining host to service (empty — recovered
        hardware comes back with no residents)."""
        self._check_host(name)
        self._status.pop(name, None)

    def fail_rack(self, rack: str) -> None:
        """Correlated failure: every host in the rack fails at once."""
        hit = [n for n, r in self._rack_of.items() if r == rack]
        if not hit:
            raise KeyError(f"unknown rack {rack!r}")
        for n in hit:
            self._status[n] = HOST_FAILED

    def recover_rack(self, rack: str) -> None:
        hit = [n for n, r in self._rack_of.items() if r == rack]
        if not hit:
            raise KeyError(f"unknown rack {rack!r}")
        for n in hit:
            self._status.pop(n, None)

    def failed_hosts(self) -> frozenset:
        return frozenset(
            n for n, s in self._status.items() if s == HOST_FAILED
        )

    def draining_hosts(self) -> frozenset:
        return frozenset(
            n for n, s in self._status.items() if s == HOST_DRAINING
        )

    # -- aggregate capacity -------------------------------------------------
    @property
    def n_hosts(self) -> int:
        """Hosts still in service (up or draining) — failed hosts are gone."""
        return sum(m.count for m in self.machines) - len(self.failed_hosts())

    def total_cores(self) -> float:
        total = float(sum(m.count * m.cores for m in self.machines))
        for n in self.failed_hosts():
            total -= self._class_of[n].cores
        return total

    def total_mem_mb(self) -> float:
        total = float(sum(m.count * m.mem_mb for m in self.machines))
        for n in self.failed_hosts():
            total -= self._class_of[n].mem_mb
        return total

    # -- host inventory -----------------------------------------------------
    def inventory(self) -> list[Host]:
        """A fresh full-capacity host list, fastest (then biggest) hosts
        first — the order :meth:`pack` fills them in, so earlier (higher
        priority) tenants get the premium hardware.  *Failed* hosts are
        excluded entirely (their residents fail to re-seat, which is how
        the scheduler learns about the loss); *draining* hosts appear with
        their status stamped so :meth:`pack` refuses them new containers
        while :meth:`seat` keeps residents in place."""
        hosts: list[Host] = []
        for m in sorted(self.machines, key=lambda m: (-m.speed, -m.cores, m.name)):
            for i in range(m.count):
                hname = f"{m.name}/{i}"
                status = self._status.get(hname, HOST_UP)
                if status == HOST_FAILED:
                    continue
                hosts.append(
                    Host(
                        name=hname,
                        cores=m.cores,
                        mem_mb=m.mem_mb,
                        speed=m.speed,
                        cores_free=m.cores,
                        mem_free=m.mem_mb,
                        rack=m.rack_name,
                        status=status,
                    )
                )
        return hosts

    @staticmethod
    def pack(
        dims: Sequence[ContainerDim],
        hosts: list[Host],
        prefer: Sequence[str] | None = None,
        spread: str | None = None,
    ) -> Placement:
        """First-fit-decreasing bin-packing of containers onto ``hosts``.

        Args:
            dims: one :class:`ContainerDim` per container to place.
            hosts: the (mutable) inventory.  ``pack`` consumes capacity from
                it — successive tenants share one shrinking inventory.
                Callers wanting a *trial* pack pass cloned hosts (see
                :meth:`trial_pack`).
            prefer: optional warm-placement preferences — ``prefer[c]`` is
                the *name* of the host container ``c`` currently lives on
                (``""`` for a container with no previous home).  A container
                whose preferred host still has room is re-seated there and
                costs no move; every other placed container falls back to
                first-fit and is charged to :attr:`Placement.moves` /
                :attr:`Placement.move_cost`.  A preference pointing at a
                draining host is ignored — that is how residents migrate
                off a host marked for maintenance.
            spread: optional anti-affinity domain — ``"host"`` or
                ``"rack"``.  After the normal first-fit pack, if every
                placed container landed in ONE domain and another domain
                has room, the cheapest container is relocated so a single
                failure cannot take the whole tenant down.  Best-effort:
                when no second domain can absorb a container the pack
                still succeeds with :attr:`Placement.spread_ok` False.

        Returns:
            A :class:`Placement`.  Containers are placed largest-CPU-first;
            each non-preferred container goes to the first host with room,
            and hosts are ordered fastest first by :meth:`inventory`.
            ``host_of[c] == -1`` marks a container that fit nowhere
            (``placement.feasible`` is then False); partially consumed
            capacity is *not* rolled back, so infeasible packs on the real
            inventory should be avoided via :meth:`trial_pack` first.
        """
        by_name = {h.name: i for i, h in enumerate(hosts)}
        order = sorted(range(len(dims)), key=lambda i: -dims[i].cpus)
        host_of = [-1] * len(dims)
        charged = [False] * len(dims)
        moves = 0
        move_cost = 0.0
        for ci in order:
            want = prefer[ci] if prefer is not None and ci < len(prefer) else ""
            wi = by_name.get(want, -1) if want else -1
            if (
                wi >= 0
                and hosts[wi].status == HOST_UP
                and hosts[wi].can_fit(dims[ci])
            ):
                hosts[wi].place(dims[ci])
                host_of[ci] = wi
                continue                       # warm: kept on its host
            for hi, h in enumerate(hosts):
                if h.status == HOST_UP and h.can_fit(dims[ci]):
                    h.place(dims[ci])
                    host_of[ci] = hi
                    charged[ci] = True
                    moves += 1                 # started or relocated
                    move_cost += dims[ci].mem_mb
                    break
        spread_ok = True
        if spread is not None and sum(1 for h in host_of if h >= 0) >= 2:
            domain = (
                (lambda h: h.rack) if spread == "rack" else (lambda h: h.name)
            )
            used = {domain(hosts[h]) for h in host_of if h >= 0}
            if len(used) < 2:
                # one failure domain holds everything: relocate the cheapest
                # container into another domain (prefer one already charged
                # as a move, so the fix usually costs no extra state copy)
                only = next(iter(used))
                movers = sorted(
                    (ci for ci in range(len(dims)) if host_of[ci] >= 0),
                    key=lambda ci: (not charged[ci], dims[ci].mem_mb, ci),
                )
                done = False
                for ci in movers:
                    for hi, h in enumerate(hosts):
                        if (
                            h.status == HOST_UP
                            and domain(h) != only
                            and h.can_fit(dims[ci])
                        ):
                            hosts[host_of[ci]].release(dims[ci])
                            h.place(dims[ci])
                            host_of[ci] = hi
                            if not charged[ci]:
                                charged[ci] = True
                                moves += 1
                                move_cost += dims[ci].mem_mb
                            done = True
                            break
                    if done:
                        break
                spread_ok = done
        used_speeds = [hosts[h].speed for h in host_of if h >= 0]
        return Placement(
            host_of=tuple(host_of),
            host_names=tuple(hosts[h].name if h >= 0 else "" for h in host_of),
            min_speed=min(used_speeds) if used_speeds else 1.0,
            moves=moves,
            move_cost=move_cost,
            spread_ok=spread_ok,
        )

    @staticmethod
    def trial_pack(dims: Sequence[ContainerDim], hosts: list[Host]) -> bool:
        """Would these containers fit, without consuming the inventory?

        Args:
            dims: the containers to probe.
            hosts: the current inventory — cloned internally, never mutated.

        Returns:
            True iff a first-fit-decreasing pack places every container.
            This is the feasibility predicate the fleet scheduler threads
            into :func:`repro_torch.core.allocator.allocate_under_budget`, so
            *fragmentation* binds admission, not just aggregate capacity.
        """
        # same FFD walk as pack() (no prefer, largest-cpu-first, first fit)
        # on bare free-capacity lists: the allocator probes this predicate
        # once per candidate rung, and cloning hundreds of Host objects per
        # probe dominated large-fleet scheduling rounds
        # a draining host is "full" to new containers: mirror pack()'s
        # status check or allocation would promise capacity pack won't use
        cores = [
            h.cores_free if h.status == HOST_UP else -1.0 for h in hosts
        ]
        mems = [h.mem_free if h.status == HOST_UP else -1.0 for h in hosts]
        n = len(hosts)
        for dim in sorted(dims, key=lambda d: -d.cpus):
            need_c = dim.cpus - _EPS
            need_m = dim.mem_mb - _EPS
            for i in range(n):
                if cores[i] >= need_c and mems[i] >= need_m:
                    cores[i] -= dim.cpus
                    mems[i] -= dim.mem_mb
                    break
            else:
                return False
        return True

    @staticmethod
    def release(
        placement: Placement, dims: Sequence[ContainerDim], hosts: list[Host]
    ) -> None:
        """Return a placement's capacity to the inventory it was packed
        against (incremental unpack — the inverse of :meth:`pack`).

        Unplaced containers (``host_of[c] == -1``) are skipped.  ``hosts``
        must be the same list (same indices) the placement was produced
        from."""
        for hi, dim in zip(placement.host_of, dims):
            if hi >= 0:
                hosts[hi].release(dim)

    @staticmethod
    def seat(
        dims: Sequence[ContainerDim],
        host_names: Sequence[str],
        hosts: list[Host],
    ) -> Placement:
        """Re-seat containers on specific *named* hosts — restoring a
        previous plan's residency onto a fresh inventory.

        Each container is placed on ``host_names[c]`` when that host exists
        and has room; containers whose named host is gone or full are left
        unplaced (``host_of[c] == -1``) rather than relocated — the caller
        decides whether a failed re-seat becomes a move or an eviction.
        Residents DO re-seat on a *draining* host (they are still serving
        there); a *failed* host is simply absent from the inventory, so
        its residents come back unplaced — the failover signal.
        Consumes capacity for every seated container.  Seated containers
        are never charged as moves."""
        by_name = {h.name: i for i, h in enumerate(hosts)}
        host_of = [-1] * len(dims)
        for ci, (dim, name) in enumerate(zip(dims, host_names)):
            hi = by_name.get(name, -1)
            if hi >= 0 and hosts[hi].can_fit(dim):
                hosts[hi].place(dim)
                host_of[ci] = hi
        used_speeds = [hosts[h].speed for h in host_of if h >= 0]
        return Placement(
            host_of=tuple(host_of),
            host_names=tuple(hosts[h].name if h >= 0 else "" for h in host_of),
            min_speed=min(used_speeds) if used_speeds else 1.0,
        )

    def describe(self) -> str:
        parts = [
            f"{m.count}x{m.name}({m.cores}c/{m.mem_mb:.0f}MB@{m.speed:g})"
            for m in self.machines
        ]
        down = ""
        if self._status:
            failed = sorted(self.failed_hosts())
            draining = sorted(self.draining_hosts())
            bits = []
            if failed:
                bits.append(f"failed={','.join(failed)}")
            if draining:
                bits.append(f"draining={','.join(draining)}")
            down = " " + " ".join(bits)
        return (
            f"Cluster[{' '.join(parts)}: {self.total_cores():.0f} cores"
            f"{down}]"
        )
