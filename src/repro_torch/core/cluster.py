"""ClusterCoordinator — federated host coordinators over a cluster pool.

ROADMAP item 3: Valet's §3.4 host-coordinated pool assumes one host slab
and a flat, static remote peer set.  At cluster scale (the regime Pond's
pool-level admission targets — see PAPERS.md; DOLMA is the
placement-granularity contrast) three things change:

* **Two-level pooling.**  A ``ClusterCoordinator`` owns the cluster-wide
  page pool and admits per-host ``HostMemoryCoordinator``s the same way a
  host coordinator admits containers: registration reserves the host's
  ``min_slab`` floor, and a host whose containers outgrow its slab leases
  *more slab* from the cluster (``lease_slab``) instead of hitting a fixed
  ceiling.  Slab is grow-only while a host lives; the whole slab returns
  on ``deregister_host``/``fail_host`` — which keeps cluster conservation
  a one-line sum.

* **Heterogeneous peers and failure domains.**  Remote peers carry
  ``PeerProfile``s (extra latency, capacity override, failure-domain id)
  drawn from seeded distributions (``draw_peer_profiles``).  Replica
  placement (``replication.ReplicaPlacer``) and migration destination
  choice (``migration.MigrationEngine``) become strictly cross-domain so
  one rack failure never takes out every copy of a block.

* **Recovery-storm admission.**  When a host or rack fails, survivors
  re-lease en masse.  ``fail_host``/``rejoin_host`` open a *storm window*
  (counted in lease calls — the coordinators are clockless) during which
  slab grants are shed to floor deficits and every gated call is charged
  the same staggered exponential ladder the SUSPECT retry path uses
  (``backoff_base_us * (2^attempts - 1)``, ``core/faults.py``): repeated
  denials back a host off, a grant resets its ladder.  Degraded hosts
  (``note_host_degraded`` fan-in from the per-host coordinators) stay
  shed to floor even outside a storm — no growth on top of an unrepaired
  replica backlog.

Convergence is provable, not hoped for: ``check_invariants`` asserts
cluster slab conservation, every DOWN host's slab reclaimed, and each
live host's coordinator internally consistent; ``ClusterInvariantChecker``
composes that with every surviving store's ``InvariantChecker`` plus the
cross-domain replica law and the ``check_replication_restored`` barrier.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.coordinator import HostMemoryCoordinator


# -- heterogeneous peer profiles ------------------------------------------


@dataclass(frozen=True)
class PeerProfile:
    """One remote peer's identity in a heterogeneous cluster.

    ``latency_us`` is *extra* one-way latency added to every remote read
    hit on this peer (0 for a near peer — the homogeneous cost model is
    the base, so an all-zero profile set prices identically to no
    profiles).  ``capacity_blocks`` overrides the store-wide
    ``peer_capacity_blocks`` (None keeps it).  ``domain`` is the failure
    domain (rack): peers sharing a domain fail together under a
    correlated rack crash, so replicas are placed strictly cross-domain.
    """
    latency_us: float = 0.0
    capacity_blocks: Optional[int] = None
    domain: int = 0


def draw_peer_profiles(n_peers: int, n_domains: int = 2, *, seed: int = 0,
                       base_capacity_blocks: int = 1024,
                       latency_scale_us: float = 0.0
                       ) -> Tuple[PeerProfile, ...]:
    """Draw a seeded heterogeneous peer set.

    Capacities are uniform over ``[base/2, 3*base/2]`` (far-memory boxes
    differ in DIMM population), extra latencies lognormal(0, 0.5) scaled
    by ``latency_scale_us`` (0 keeps the homogeneous cost model), and
    domains are contiguous rack stripes (``peer i -> i*n_domains//n``) so
    a rack maps onto a contiguous peer-id range.  Identical seeds yield
    identical tuples.
    """
    assert n_peers > 0 and n_domains > 0
    rng = np.random.default_rng(seed)
    caps = rng.integers(base_capacity_blocks // 2,
                        base_capacity_blocks * 3 // 2 + 1, size=n_peers)
    lats = latency_scale_us * rng.lognormal(0.0, 0.5, size=n_peers)
    return tuple(
        PeerProfile(latency_us=float(lats[i]) if latency_scale_us else 0.0,
                    capacity_blocks=int(caps[i]),
                    domain=(i * n_domains) // n_peers)
        for i in range(n_peers))


def profile_domains(profiles) -> Optional[List[int]]:
    """Peer -> failure-domain list from a profile tuple (None when the
    profiles carry a single domain — a flat peer set needs no exclusion)."""
    if not profiles:
        return None
    doms = [p.domain for p in profiles]
    return doms if len(set(doms)) > 1 else None


# -- host records ----------------------------------------------------------


class HostState(Enum):
    UP = "up"
    DOWN = "down"


@dataclass
class HostRecord:
    """Cluster-side state for one registered host."""
    hid: int
    name: str
    min_slab: int                  # guaranteed slab floor
    max_slab: int                  # slab lease cap
    slab: int = 0                  # pages currently held from the pool
    state: HostState = HostState.UP
    coordinator: Optional[HostMemoryCoordinator] = None
    demand_decay: Optional[float] = None
    degraded_blocks: int = 0       # aggregated per-host repair backlog
    storm_attempts: int = 0        # consecutive gated denials (ladder rung)
    storm_wait_us: float = 0.0     # simulated backoff charged to this host
    n_slab_leases: int = 0
    pages_slab_leased: int = 0


@dataclass
class ClusterStats:
    n_hosts_registered: int = 0
    n_host_deregistrations: int = 0
    n_host_failures: int = 0
    n_host_rejoins: int = 0
    n_slab_lease_calls: int = 0
    pages_slab_leased: int = 0
    n_storms: int = 0              # storm windows opened (fail/rejoin)
    n_storm_denials: int = 0       # gated lease calls shed to zero
    storm_wait_us: float = 0.0     # total staggered-backoff simulated wait
    n_degraded_reports: int = 0    # per-host backlog fan-ins (non-zero)
    n_degraded_clears: int = 0     # per-host backlog drained to zero


# -- the cluster coordinator ----------------------------------------------


class ClusterCoordinator:
    """Arbitrates one cluster page pool across N host coordinators."""

    STORM_WINDOW = 256             # gated lease calls after a fail/rejoin
    MAX_BACKOFF_EXP = 6            # ladder cap: base * (2^6 - 1)

    def __init__(self, total_pages: int, *, backoff_base_us: float = 8.0,
                 storm_window: Optional[int] = None):
        assert total_pages > 0
        self.total_pages = total_pages
        self.backoff_base_us = float(backoff_base_us)
        self.storm_window = self.STORM_WINDOW if storm_window is None \
            else int(storm_window)
        self._free = total_pages
        self._hosts: Dict[int, HostRecord] = {}
        self._next_hid = 0
        self._storm_calls_left = 0
        self.stats = ClusterStats()

    # -- host lifecycle ----------------------------------------------------

    def register_host(self, *, min_slab: int, max_slab: Optional[int] = None,
                      name: Optional[str] = None,
                      demand_decay: Optional[float] = None
                      ) -> HostMemoryCoordinator:
        """Admit a host: reserve its ``min_slab`` floor and hand back a
        freshly built ``HostMemoryCoordinator`` wired into the cluster
        (its lease shortfalls escalate to ``lease_slab``).  Raises when
        the floor does not fit the free pool — the same admission-control
        contract containers get from a host coordinator."""
        max_slab = min_slab if max_slab is None else max_slab
        assert 0 < min_slab <= max_slab
        if min_slab > self._free:
            raise ValueError(
                f"cannot admit host ({min_slab} floor pages): only "
                f"{self._free} of {self.total_pages} pool pages free")
        hid = self._next_hid
        self._next_hid += 1
        rec = HostRecord(hid=hid, name=name or f"host{hid}",
                         min_slab=min_slab, max_slab=max_slab,
                         slab=min_slab, demand_decay=demand_decay)
        self._free -= min_slab
        rec.coordinator = self._attach_coordinator(rec)
        self._hosts[hid] = rec
        self.stats.n_hosts_registered += 1
        return rec.coordinator

    def _attach_coordinator(self, rec: HostRecord) -> HostMemoryCoordinator:
        coord = HostMemoryCoordinator(rec.slab,
                                      demand_decay=rec.demand_decay)
        coord.cluster = self
        coord.host_id = rec.hid
        return coord

    def deregister_host(self, hid: int) -> int:
        """A host leaves cleanly: its whole slab returns to the pool."""
        rec = self._hosts.pop(hid)
        returned = rec.slab
        self._free += returned
        if rec.coordinator is not None:
            rec.coordinator.cluster = None
        self.stats.n_host_deregistrations += 1
        return returned

    def fail_host(self, hid: int) -> int:
        """A host crashes: reclaim its entire slab (every lease its
        containers held dies with the host), drop its coordinator, and
        open a recovery-storm window — the survivors are about to
        re-lease en masse.  Returns the pages reclaimed."""
        rec = self._hosts[hid]
        assert rec.state is HostState.UP, f"host{hid} already down"
        reclaimed = rec.slab
        self._free += reclaimed
        rec.slab = 0
        rec.state = HostState.DOWN
        if rec.coordinator is not None:
            rec.coordinator.cluster = None
            rec.coordinator = None
        rec.degraded_blocks = 0
        self.stats.n_host_failures += 1
        self._enter_storm()
        return reclaimed

    def rejoin_host(self, hid: int) -> HostMemoryCoordinator:
        """A DOWN host comes back empty: re-reserve its floor, hand it a
        *fresh* coordinator (its old containers died with it), and open a
        storm window — a rejoin re-leases just like a failure does."""
        rec = self._hosts[hid]
        assert rec.state is HostState.DOWN, f"host{hid} is not down"
        if rec.min_slab > self._free:
            raise ValueError(
                f"cannot rejoin host{hid} ({rec.min_slab} floor pages): "
                f"only {self._free} pool pages free")
        self._free -= rec.min_slab
        rec.slab = rec.min_slab
        rec.state = HostState.UP
        rec.storm_attempts = 0
        rec.coordinator = self._attach_coordinator(rec)
        self.stats.n_host_rejoins += 1
        self._enter_storm()
        return rec.coordinator

    def _enter_storm(self) -> None:
        self._storm_calls_left = self.storm_window
        self.stats.n_storms += 1

    def storm_active(self) -> bool:
        return self._storm_calls_left > 0

    # -- slab leasing ------------------------------------------------------

    def lease_slab(self, hid: int, want: int) -> int:
        """Grant up to ``want`` more slab pages to a live host.

        Mid-storm (and for a degraded host any time) grants are shed to
        the host's floor deficit, and every gated call pays the staggered
        exponential ladder — ``backoff_base_us * (2^attempts - 1)`` of
        simulated wait, attempts escalating per denial and resetting on a
        grant — so a thundering herd of re-leasing survivors serializes
        instead of oscillating."""
        rec = self._hosts[hid]
        self.stats.n_slab_lease_calls += 1
        if rec.state is not HostState.UP:
            return 0
        want = min(want, rec.max_slab - rec.slab)
        storm = self._storm_calls_left > 0
        if storm:
            self._storm_calls_left -= 1
            wait = self.backoff_base_us * (
                (1 << min(rec.storm_attempts, self.MAX_BACKOFF_EXP)) - 1)
            rec.storm_wait_us += wait
            self.stats.storm_wait_us += wait
        if storm or rec.degraded_blocks > 0:
            # degraded-mode admission: floor deficits only
            want = min(want, max(rec.min_slab - rec.slab, 0))
        granted = min(want, self._free) if want > 0 else 0
        if granted > 0:
            self._free -= granted
            rec.slab += granted
            rec.n_slab_leases += 1
            rec.pages_slab_leased += granted
            self.stats.pages_slab_leased += granted
            rec.storm_attempts = 0
        elif storm:
            rec.storm_attempts += 1
            self.stats.n_storm_denials += 1
        return granted

    def headroom_for(self, hid: int) -> int:
        """Slab pages this host could still lease right now — the cap
        input its coordinator folds into ``available_for``.  Shed to the
        floor deficit mid-storm / while degraded, like ``lease_slab``."""
        rec = self._hosts[hid]
        if rec.state is not HostState.UP:
            return 0
        room = rec.max_slab - rec.slab
        if self._storm_calls_left > 0 or rec.degraded_blocks > 0:
            room = min(room, max(rec.min_slab - rec.slab, 0))
        return max(min(room, self._free), 0)

    # -- degradation fan-in ------------------------------------------------

    def note_host_degraded(self, hid: int, n_blocks: int) -> None:
        """A host coordinator reports its aggregated container repair
        backlog (``HostMemoryCoordinator._forward_degraded``).  Non-zero
        sheds the host's slab admission to floor; zero releases it."""
        rec = self._hosts.get(hid)
        if rec is None:
            return
        was = rec.degraded_blocks
        rec.degraded_blocks = int(n_blocks)
        if n_blocks > 0:
            self.stats.n_degraded_reports += 1
        elif was > 0:
            self.stats.n_degraded_clears += 1

    # -- accounting / invariants ------------------------------------------

    def free(self) -> int:
        return self._free

    def hosts(self) -> List[HostRecord]:
        return list(self._hosts.values())

    def check_invariants(self) -> None:
        held = sum(r.slab for r in self._hosts.values())
        assert held + self._free == self.total_pages, \
            f"cluster pool not conserved: {held} held + {self._free} " \
            f"free != {self.total_pages}"
        assert self._free >= 0
        for rec in self._hosts.values():
            if rec.state is HostState.DOWN:
                assert rec.slab == 0, \
                    f"{rec.name}: DOWN but still holds {rec.slab} pages"
                assert rec.coordinator is None, \
                    f"{rec.name}: DOWN but coordinator attached"
            else:
                assert rec.min_slab <= rec.slab <= rec.max_slab, \
                    f"{rec.name}: slab {rec.slab} outside " \
                    f"[{rec.min_slab}, {rec.max_slab}]"
                coord = rec.coordinator
                assert coord is not None, f"{rec.name}: UP w/o coordinator"
                assert coord.total_pages == rec.slab, \
                    f"{rec.name}: coordinator slab {coord.total_pages} " \
                    f"!= cluster record {rec.slab}"
                coord.check_invariants()


class ClusterInvariantChecker:
    """Cluster-wide safety: the coordinator's conservation laws plus every
    surviving store's full ``InvariantChecker`` (which includes the
    cross-domain replica law when the store carries failure domains)."""

    def __init__(self, cluster: ClusterCoordinator,
                 stores_by_host: Dict[int, List]):
        self.cluster = cluster
        self.stores_by_host = stores_by_host

    def _live_stores(self):
        live = {r.hid for r in self.cluster.hosts()
                if r.state is HostState.UP}
        for hid, stores in sorted(self.stores_by_host.items()):
            if hid in live:
                for store in stores:
                    yield store

    def check(self) -> None:
        from repro_torch.core.invariants import InvariantChecker
        self.cluster.check_invariants()
        for store in self._live_stores():
            InvariantChecker(store).check()

    def check_recovery_converged(self, factor: Optional[int] = None) -> None:
        """The post-storm barrier: every surviving host's store drained
        its repair queue and every referenced primary is back at full
        replication — cluster recovery must end complete, not quiet."""
        from repro_torch.core.invariants import InvariantChecker
        self.check()
        for store in self._live_stores():
            InvariantChecker(store).check_replication_restored(factor)
