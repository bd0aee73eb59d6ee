"""HostMemoryCoordinator — cross-container host memory arbitration (§3.4).

The paper's second contribution: "Valet utilizes unused local memory across
containers by managing local memory via a host-coordinated memory pool,
which allows containers to dynamically expand and shrink their memory
allocations according to the workload demands."

One coordinator owns a fixed physical slab of host pages and arbitrates it
across N co-located containers (``TieredPageStore`` / ``ValetServeEngine``
instances).  Each container's ``ValetMempool`` *leases* pages from the
coordinator when it grows and *returns* them when it shrinks, replacing the
bare ``free_memory_fn`` probe with real accounting:

* **Registration** reserves every container's ``min_pages`` floor up front
  (the sum of floors must fit the slab), so no container can ever be starved
  below its guaranteed minimum.
* **Lease** grants are batched (one call covers a whole grow step, the way
  ``alloc_batch`` covers a whole allocation burst) and capped by the
  container's ``max_pages``.
* **Weighted-fair reclamation**: when a lease cannot be served from free
  pages, the coordinator reclaims from the *other* containers — idle ones
  first (lowest recent demand), shedding them toward their weighted fair
  share, then, if still short, toward their ``min_pages`` floor.  A donor
  frees pages through its registered callback (flush + LRU reclaim + shrink
  on a ``TieredPageStore``), so one container's idle memory becomes
  another's cache instead of forcing remote paging.

Single-container parity: ``available_for(cid)`` reports ``free + leased``
— the total the container could hold — so with N=1 it is the constant slab
size and every sizing decision (80% growth trigger, 50%-of-host-free cap,
pressure shrink) is bitwise identical to a plain pool whose
``free_memory_fn`` returns the slab size (``tests/test_coordinator.py``
pins this).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional


@dataclass
class ContainerRecord:
    """Coordinator-side state for one registered container."""
    cid: int
    name: str
    min_pages: int                 # guaranteed floor, reserved at register
    max_pages: int                 # lease cap
    weight: float                  # weighted-fair share of the surplus
    leased: int = 0                # pages currently held (== its pool size)
    demand: float = 0.0            # decayed recent-activity signal
    donate_cb: Optional[Callable[[int], int]] = None
    size_fn: Optional[Callable[[], int]] = None    # invariant probe
    # remote-pressure routing (§3.4 follow-up): how many victim-candidate
    # MR blocks this container holds on a given peer, and its handler that
    # frees blocks there (migrate or evict, per its policy)
    peer_footprint_fn: Optional[Callable[[int], int]] = None
    peer_pressure_cb: Optional[Callable[[int, int], int]] = None
    # per-container counters
    n_leases: int = 0
    pages_leased_total: int = 0
    pages_donated_total: int = 0
    peer_blocks_freed_total: int = 0
    degraded_blocks: int = 0       # latest repair-backlog report (0 = healthy)


@dataclass
class CoordinatorStats:
    n_lease_calls: int = 0
    n_release_calls: int = 0
    n_partial_grants: int = 0      # lease served below the asked amount
    n_reclaim_events: int = 0      # arbitration rounds (free pool was short)
    pages_reclaimed: int = 0       # pages pulled back from donors
    n_peer_pressure_events: int = 0   # coordinated remote-pressure fan-outs
    peer_blocks_freed: int = 0        # MR blocks freed across containers
    n_degraded_reports: int = 0       # repair-backlog reports (fault path)
    n_degraded_clears: int = 0        # backlog-drained un-throttle events
    n_degraded_denials: int = 0       # lease asks shed to floor while degraded
    n_deregistrations: int = 0        # containers that left mid-run (churn)


class LeaseClient:
    """A container's handle into the coordinator (what ``ValetMempool``
    sees): the lease/return API plus the host-free probe, scoped to one
    container id so the pool never needs to know its own cid."""

    __slots__ = ("coordinator", "cid")

    def __init__(self, coordinator: "HostMemoryCoordinator", cid: int):
        self.coordinator = coordinator
        self.cid = cid

    def available(self) -> int:
        return self.coordinator.available_for(self.cid)

    def lease(self, want: int) -> int:
        return self.coordinator.lease(self.cid, want)

    def release(self, n: int) -> None:
        self.coordinator.release(self.cid, n)


class HostMemoryCoordinator:
    """Arbitrates one fixed host slab across N container mempools."""

    DEMAND_DECAY = 0.5             # aging applied at each arbitration round
    FUTILE_COOLDOWN = 32           # lease calls skipped after a 0-yield round

    def __init__(self, total_pages: int,
                 demand_decay: Optional[float] = None):
        assert total_pages > 0
        self.total_pages = total_pages
        # aging factor for the idle-first donor ordering; instance knob so
        # deployments can tune how fast historic bursts fade (the class
        # attribute stays as the default for existing call sites)
        self.demand_decay = self.DEMAND_DECAY if demand_decay is None \
            else float(demand_decay)
        self._free = total_pages
        self._containers: Dict[int, ContainerRecord] = {}
        self._next_cid = 0
        # arbitration damping: after a reclamation round that freed nothing
        # (every donor at its floor or pinned by live data), skip the next
        # FUTILE_COOLDOWN short-on-free lease calls instead of re-scanning
        # all donors per allocation burst.  Keyed by requesting cid —
        # futility is per-requester (the donor set excludes the caller), so
        # one container's dry round must not block another's reclamation.
        # Any release resets all cooldowns (donor state visibly changed);
        # otherwise they expire by call count, which keeps the retry
        # schedule deterministic.
        self._cooldown: Dict[int, int] = {}
        self.stats = CoordinatorStats()
        # cluster federation (core.cluster): set by
        # ClusterCoordinator.register_host.  With no cluster attached every
        # path below is bitwise identical to the standalone coordinator.
        self.cluster = None
        self.host_id: Optional[int] = None

    # -- registration --------------------------------------------------------

    def register(self, *, min_pages: int, max_pages: int,
                 weight: float = 1.0, name: Optional[str] = None
                 ) -> LeaseClient:
        """Admit a container: reserve its ``min_pages`` floor immediately.

        Raises if the floor does not fit the remaining slab — admission
        control is what makes the no-starvation guarantee possible.  With
        tenant churn a joiner may find the slab fully grown, so a short
        floor first arbitrates against the existing donors (idle-first,
        the same two-pass weighted-fair reclamation lease shortfalls use)
        before admission is refused."""
        assert 0 < min_pages <= max_pages
        assert weight > 0
        if min_pages > self._free:
            self._reclaim_for(self._next_cid, min_pages - self._free)
        if min_pages > self._free:
            raise ValueError(
                f"cannot admit container ({min_pages} floor pages): only "
                f"{self._free} of {self.total_pages} slab pages free")
        cid = self._next_cid
        self._next_cid += 1
        rec = ContainerRecord(cid=cid, name=name or f"container{cid}",
                              min_pages=min_pages, max_pages=max_pages,
                              weight=weight, leased=min_pages)
        self._free -= min_pages
        self._containers[cid] = rec
        return LeaseClient(self, cid)

    def deregister(self, cid: int) -> int:
        """A container leaves (tenant churn): its whole lease — floor
        included — returns to the slab, and every cooldown resets (the
        donor landscape visibly changed).  Returns the pages reclaimed."""
        rec = self._containers.pop(cid)
        returned = rec.leased
        self._free += returned
        self._cooldown.clear()
        self.stats.n_deregistrations += 1
        if rec.degraded_blocks > 0:
            self._forward_degraded()
        return returned

    def set_donor(self, cid: int, donate_cb: Callable[[int], int],
                  size_fn: Optional[Callable[[], int]] = None) -> None:
        """Attach the container's pressure callback (and an optional pool
        size probe used only by ``check_invariants``).  ``donate_cb(n)``
        must free up to ``n`` leased pages (returning them through
        ``release``) and return how many it actually freed."""
        rec = self._containers[cid]
        rec.donate_cb = donate_cb
        rec.size_fn = size_fn

    def register_peer_footprint(self, cid: int,
                                footprint_fn: Callable[[int], int],
                                pressure_cb: Callable[[int, int], int]
                                ) -> None:
        """Attach the container's remote-memory footprint probe and its
        peer-pressure handler.  ``footprint_fn(peer)`` reports how many
        victim-candidate MR blocks the container holds on ``peer`` (a
        ``TieredPageStore`` answers with one masked count over its dense
        per-peer block membership columns); ``pressure_cb(peer, n)`` frees
        up to ``n`` blocks there and returns how many it actually freed."""
        rec = self._containers[cid]
        rec.peer_footprint_fn = footprint_fn
        rec.peer_pressure_cb = pressure_cb

    # -- demand signal -------------------------------------------------------

    def note_activity(self, cid: int, n_ops: int) -> None:
        """Record container activity (ops served); decayed at arbitration
        time so stale bursts fade and idle containers donate first."""
        self._containers[cid].demand += n_ops

    def note_degraded(self, cid: int, n_blocks: int) -> None:
        """A container reports its re-replication backlog (blocks still
        below their replication factor after a drain round).  The report
        is a live admission throttle: while ``degraded_blocks > 0`` the
        container's lease grants are shed to its ``min_pages`` floor (no
        growth on top of an unrepaired backlog), and operators can watch
        ``stats.n_degraded_reports`` / ``ContainerRecord.degraded_blocks``
        for stuck repairs.  ``clear_degraded`` releases the throttle when
        the repair queue drains."""
        self._containers[cid].degraded_blocks = int(n_blocks)
        self.stats.n_degraded_reports += 1
        self._forward_degraded()

    def clear_degraded(self, cid: int) -> None:
        """The container's repair backlog drained (its ``RepairQueue``
        emptied): drop the admission throttle so growth resumes.  Without
        this release path a container that ever reported degraded would be
        pinned at its floor forever."""
        rec = self._containers[cid]
        if rec.degraded_blocks == 0:
            return
        rec.degraded_blocks = 0
        self.stats.n_degraded_clears += 1
        self._forward_degraded()

    def _forward_degraded(self) -> None:
        """Aggregate the per-container backlog and fan it in to the cluster
        coordinator (storm admission watches per-host degradation)."""
        if self.cluster is None:
            return
        total = sum(r.degraded_blocks for r in self._containers.values())
        self.cluster.note_host_degraded(self.host_id, total)

    # -- accounting ----------------------------------------------------------

    def free(self) -> int:
        return self._free

    def available_for(self, cid: int) -> int:
        """Host pages this container could hold in total: the free slab,
        what it already leases, plus the co-tenants' *reclaimable excess*
        (their lease above the ``min_pages`` floor — what weighted-fair
        reclamation could pull back for this container).  Advertising the
        excess is what lets a grower's lease request exceed the bare free
        count and trigger reclamation of idle containers' memory; it is a
        cap input, not a promise — grants are cut to what donors actually
        free.  With one container this is the constant slab size — the
        plain ``free_memory_fn`` parity contract."""
        own = self._containers[cid].leased
        donatable = sum(r.leased - r.min_pages
                        for r in self._containers.values()
                        if r.cid != cid and r.donate_cb is not None
                        and r.leased > r.min_pages)
        headroom = 0 if self.cluster is None \
            else self.cluster.headroom_for(self.host_id)
        return self._free + own + donatable + headroom

    def grantable_for(self, cid: int) -> int:
        """Lower bound on what ``lease(cid, ...)`` would grant right now
        without reclamation: the free slab capped at the container's lease
        room — shed to its floor deficit while it reports a repair backlog
        (the degraded admission throttle).  The batch planner's capacity
        prediction uses this instead of the bare free count so it never
        promises growth the throttle will refuse."""
        rec = self._containers[cid]
        room = rec.max_pages - rec.leased
        if rec.degraded_blocks > 0:
            room = min(room, max(rec.min_pages - rec.leased, 0))
        return max(0, min(room, self._free))

    def fair_share(self, cid: int) -> int:
        """Weighted fair allocation: the floor plus this container's weight
        share of the slab surplus beyond all floors."""
        rec = self._containers[cid]
        floors = sum(r.min_pages for r in self._containers.values())
        weights = sum(r.weight for r in self._containers.values())
        surplus = max(self.total_pages - floors, 0)
        return rec.min_pages + int(surplus * rec.weight / weights)

    # -- lease / return ------------------------------------------------------

    def lease(self, cid: int, want: int) -> int:
        """Grant up to ``want`` pages (one batched call per grow step).

        Shortfalls trigger weighted-fair reclamation from other containers
        before the grant is cut; the grant may still be partial when donors
        cannot free enough."""
        rec = self._containers[cid]
        self.stats.n_lease_calls += 1
        want = min(want, rec.max_pages - rec.leased)
        if rec.degraded_blocks > 0:
            # degraded-mode shedding: a live repair backlog caps grants at
            # the min_pages floor (already reserved at register), so a
            # container cannot grow on top of unreplicated blocks.
            # clear_degraded lifts the cap when the backlog drains.
            capped = min(want, max(rec.min_pages - rec.leased, 0))
            if capped < want:
                self.stats.n_degraded_denials += 1
            want = capped
        if want <= 0:
            return 0
        if want > self._free:
            cd = self._cooldown.get(cid, 0)
            if cd > 0:
                self._cooldown[cid] = cd - 1
            elif self._reclaim_for(cid, want - self._free) == 0:
                self._cooldown[cid] = self.FUTILE_COOLDOWN
            if want > self._free and self.cluster is not None:
                # still short after local arbitration: ask the cluster pool
                # for more slab (storm admission may stagger or deny this).
                got = self.cluster.lease_slab(self.host_id,
                                              want - self._free)
                if got > 0:
                    self.total_pages += got
                    self._free += got
        granted = min(want, self._free)
        if granted < want:
            self.stats.n_partial_grants += 1
        if granted > 0:
            self._free -= granted
            rec.leased += granted
            rec.n_leases += 1
            rec.pages_leased_total += granted
        return granted

    def release(self, cid: int, n: int) -> None:
        """Return ``n`` leased pages to the slab (pool shrink / donation)."""
        if n <= 0:
            return
        rec = self._containers[cid]
        assert rec.leased - n >= 0, (rec.leased, n)
        rec.leased -= n
        self._free += n
        self._cooldown.clear()
        self.stats.n_release_calls += 1

    # -- weighted-fair reclamation ------------------------------------------

    def _reclaim_for(self, cid: int, need: int) -> int:
        """Pull ~``need`` pages back from other containers.

        Donor order is idle-first (lowest decayed demand, cid tie-break for
        determinism).  Pass 1 sheds donors above their weighted fair share
        down to it; pass 2, only if still short, sheds any donor down to its
        ``min_pages`` floor.  Donors free pages via their callback (which
        calls ``release`` internally), so progress is measured on the free
        counter, not on promises.  Returns the pages actually freed."""
        self.stats.n_reclaim_events += 1
        total_got = 0
        donors = sorted(
            (r for r in self._containers.values()
             if r.cid != cid and r.donate_cb is not None),
            key=lambda r: (r.demand, r.cid))
        for floor_of in (lambda r: max(r.min_pages, self.fair_share(r.cid)),
                         lambda r: r.min_pages):
            for rec in donors:
                if need <= 0:
                    break
                excess = rec.leased - floor_of(rec)
                if excess <= 0:
                    continue
                free_before = self._free
                rec.donate_cb(min(excess, need))
                got = self._free - free_before
                rec.pages_donated_total += got
                self.stats.pages_reclaimed += got
                need -= got
                total_got += got
        # age the demand signal so one historic burst does not shield a
        # now-idle container from donating forever
        for rec in self._containers.values():
            rec.demand *= self.demand_decay
        return total_got

    # -- coordinated remote pressure (§3.4 + §3.5) ---------------------------

    def peer_pressure(self, peer: int, blocks_to_free: int) -> int:
        """Fan a remote peer's memory pressure out across containers.

        Without coordination each container only sees its own MR blocks, so
        a pressured peer must signal every sender separately and idle
        containers' blocks survive while busy ones churn.  Here the
        coordinator routes the demand: containers that actually occupy the
        peer (non-zero ``footprint_fn``) free blocks idle-first (lowest
        decayed demand, cid tie-break — the same donor order as host-memory
        reclamation), each asked for at most its own footprint.  Returns
        the blocks actually freed (migrated or evicted per each
        container's policy); may fall short when footprints do."""
        if blocks_to_free <= 0:
            return 0
        self.stats.n_peer_pressure_events += 1
        holders = sorted(
            (r for r in self._containers.values()
             if r.peer_pressure_cb is not None
             and r.peer_footprint_fn is not None),
            key=lambda r: (r.demand, r.cid))
        freed = 0
        for rec in holders:
            if freed >= blocks_to_free:
                break
            fp = rec.peer_footprint_fn(peer)
            if fp <= 0:
                continue
            ask = min(fp, blocks_to_free - freed)
            got = rec.peer_pressure_cb(peer, ask)
            rec.peer_blocks_freed_total += got
            self.stats.peer_blocks_freed += got
            freed += got
        for rec in self._containers.values():
            rec.demand *= self.demand_decay
        return freed

    # -- invariants (property tests) ----------------------------------------

    def containers(self) -> List[ContainerRecord]:
        return list(self._containers.values())

    def check_invariants(self) -> None:
        leased = sum(r.leased for r in self._containers.values())
        assert leased + self._free == self.total_pages, \
            f"slab not conserved: {leased} leased + {self._free} free " \
            f"!= {self.total_pages}"
        assert self._free >= 0
        for rec in self._containers.values():
            assert rec.min_pages <= rec.leased <= rec.max_pages, \
                f"{rec.name}: leased {rec.leased} outside " \
                f"[{rec.min_pages}, {rec.max_pages}]"
            if rec.size_fn is not None:
                size = rec.size_fn()
                assert size == rec.leased, \
                    f"{rec.name}: pool size {size} != leased {rec.leased}"
