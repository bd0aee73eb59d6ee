"""Fault-injection subsystem: peer health states, repair queue, injector.

Valet's fault-tolerance story (paper §5.1/§5.3, Table 3) needs more than the
one-shot ``fail_peer`` sweep to be believable: production remote-memory
peers *blip* (transient network faults), crash in correlated groups (rack
power), and come back — and each of those must degrade latency before it
degrades durability.  This module holds the pieces that are independent of
the store proper:

* ``HealthState`` / ``PeerHealth`` — the per-peer state machine

      UP --suspect--> SUSPECT --recover--> UP
      UP/SUSPECT/REJOINING --down--> DOWN --rejoin--> REJOINING --activate--> UP

  SUSPECT carries a deadline (``suspect_timeout_us`` of simulated time): if
  no ``recover`` arrives first, the store's health poll escalates to DOWN.
  Illegal transitions are rejected (return ``False``), never raised — the
  injector replays seeded schedules that may race a timeout escalation.

* ``RepairQueue`` — degraded primary blocks awaiting re-replication.  FIFO
  with membership dedup; drained off the critical path by
  ``TieredPageStore._drain_repairs`` (sync ticks) or the async daemon.

* ``FaultInjector`` — a deterministic, op-indexed failure schedule driven
  against a live store: ``advance(n_ops)`` after each driven chunk fires
  every due event.  Schedule builders for the canonical scenarios (transient
  blip, permanent crash, correlated multi-peer failure, rejoin-driven
  recovery storm) plus a seeded random generator for fuzz traces.

Everything here is simulation-deterministic: no wall clock, no RNG except
the explicitly seeded ``random_schedule``.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from collections import deque
from typing import Iterable, List, Optional, Sequence, Set, Tuple

import numpy as np


class HealthState(enum.IntEnum):
    UP = 0
    SUSPECT = 1
    DOWN = 2
    REJOINING = 3


# legal (from, to) edges of the per-peer state machine
_LEGAL = {
    (HealthState.UP, HealthState.SUSPECT),         # transient fault observed
    (HealthState.SUSPECT, HealthState.UP),         # blip healed in time
    (HealthState.SUSPECT, HealthState.DOWN),       # timeout / crash
    (HealthState.UP, HealthState.DOWN),            # hard crash
    (HealthState.REJOINING, HealthState.DOWN),     # crashed while rejoining
    (HealthState.DOWN, HealthState.REJOINING),     # operator brought it back
    (HealthState.REJOINING, HealthState.UP),       # first healthy poll
}


class PeerHealth:
    """Per-peer health state machine with a transition log.

    All times are simulated microseconds on the ``stats.time_us`` axis.
    Transition methods return True when the edge was legal and taken.
    """

    def __init__(self, n_peers: int, *, suspect_timeout_us: float = 50_000.0):
        self.n_peers = int(n_peers)
        self.suspect_timeout_us = float(suspect_timeout_us)
        n = max(self.n_peers, 1)
        self.state = np.zeros(n, np.int8)            # HealthState values
        self.since_us = np.zeros(n, np.float64)      # last transition time
        self._deadline = np.full(n, np.inf)          # SUSPECT escalation
        self.transitions: List[Tuple[int, str, str, float]] = []

    def _move(self, peer: int, to: HealthState, now: float) -> bool:
        cur = HealthState(int(self.state[peer]))
        if (cur, to) not in _LEGAL:
            return False
        self.state[peer] = int(to)
        self.since_us[peer] = now
        self.transitions.append((peer, cur.name, to.name, now))
        if to is not HealthState.SUSPECT:
            self._deadline[peer] = np.inf
        return True

    # -- transitions ---------------------------------------------------------

    def suspect(self, peer: int, now: float) -> bool:
        if self._move(peer, HealthState.SUSPECT, now):
            self._deadline[peer] = now + self.suspect_timeout_us
            return True
        return False

    def recover(self, peer: int, now: float) -> bool:
        return self._move(peer, HealthState.UP, now) \
            if self.state[peer] == int(HealthState.SUSPECT) else False

    def down(self, peer: int, now: float) -> bool:
        return self._move(peer, HealthState.DOWN, now)

    def rejoin(self, peer: int, now: float) -> bool:
        return self._move(peer, HealthState.REJOINING, now)

    def activate(self, peer: int, now: float) -> bool:
        return self._move(peer, HealthState.UP, now) \
            if self.state[peer] == int(HealthState.REJOINING) else False

    # -- queries -------------------------------------------------------------

    def state_of(self, peer: int) -> HealthState:
        return HealthState(int(self.state[peer]))

    def expired_suspects(self, now: float) -> List[int]:
        """SUSPECT peers whose escalation deadline has passed."""
        hit = (self.state == int(HealthState.SUSPECT)) \
            & (self._deadline <= now)
        return np.flatnonzero(hit).tolist()

    def rejoining_peers(self) -> List[int]:
        return np.flatnonzero(
            self.state == int(HealthState.REJOINING)).tolist()

    def any_transient(self) -> bool:
        """True while any peer sits in a transitional state (SUSPECT or
        REJOINING) — the store's lazy poll condition."""
        return bool(np.any((self.state == int(HealthState.SUSPECT))
                           | (self.state == int(HealthState.REJOINING))))

    def counts(self) -> dict:
        return {s.name: int(np.count_nonzero(self.state == int(s)))
                for s in HealthState}


class RepairQueue:
    """Degraded primary blocks awaiting re-replication (FIFO, deduped).

    Keys are MR block ids ``(peer, slot)``.  Pushed by ``fail_peer`` (a
    crash stripped copies) and by block placement when the replica
    allocation came up short; drained by ``_drain_repairs`` off the
    critical path.  A block that cannot be repaired yet (no live peer has
    room) is re-queued — the queue length is the store's degradation
    signal (coordinator admission throttling keys off it)."""

    def __init__(self):
        self._q: deque = deque()
        self._set: Set[Tuple[int, int]] = set()
        self.n_enqueued = 0
        self.n_repaired = 0
        self.n_requeued = 0

    def push(self, key: Tuple[int, int]) -> bool:
        if key in self._set:
            return False
        self._set.add(key)
        self._q.append(key)
        self.n_enqueued += 1
        return True

    def requeue(self, key: Tuple[int, int]) -> None:
        if key not in self._set:
            self._set.add(key)
            self._q.append(key)
            self.n_requeued += 1

    def pop(self) -> Tuple[int, int]:
        key = self._q.popleft()
        self._set.discard(key)
        return key

    def __len__(self) -> int:
        return len(self._q)

    def __bool__(self) -> bool:
        return bool(self._q)

    def __contains__(self, key) -> bool:
        return key in self._set


# -- deterministic fault schedules --------------------------------------------

@dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault action, keyed by absolute trace op index."""
    at_op: int
    kind: str                      # suspect | recover | crash | rejoin
    peers: Tuple[int, ...]

    _KINDS = ("suspect", "recover", "crash", "rejoin")

    def __post_init__(self):
        if self.kind not in self._KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(one of {self._KINDS})")


@dataclass
class FaultInjector:
    """Drive a deterministic fault schedule against a live store.

    The driver calls ``advance(n_ops)`` after each executed trace chunk;
    every event whose ``at_op`` has been reached fires in schedule order
    (stable-sorted by ``at_op``).  Events map onto the store's fault API —
    ``mark_suspect`` / ``clear_suspect`` / ``fail_peer`` / ``rejoin_peer``
    — and the per-event outcome is recorded in ``log`` (kind, peer, the
    store method's return), so a replayed seed yields an identical log.

    Works unchanged against sync and async stores: the API is the store's
    in both modes, and all events land *between* driven chunks, never
    mid-op (mid-epoch for async stores — chunks need not align with epoch
    boundaries)."""

    store: object
    events: Sequence[FaultEvent]
    ops: int = 0
    log: List[Tuple[int, str, int, object]] = field(default_factory=list)

    def __post_init__(self):
        self._sched = sorted(self.events, key=lambda e: e.at_op)
        self._i = 0

    @property
    def done(self) -> bool:
        return self._i >= len(self._sched)

    def advance(self, n_ops: int) -> int:
        """Account ``n_ops`` executed ops; fire every due event.  Returns
        the number of events fired."""
        self.ops += int(n_ops)
        fired = 0
        while self._i < len(self._sched) \
                and self._sched[self._i].at_op <= self.ops:
            ev = self._sched[self._i]
            self._i += 1
            for peer in ev.peers:
                self.log.append((self.ops, ev.kind, peer,
                                 self._fire(ev.kind, peer)))
            fired += 1
        return fired

    def _fire(self, kind: str, peer: int):
        s = self.store
        if kind == "suspect":
            return s.mark_suspect(peer)
        if kind == "recover":
            return s.clear_suspect(peer)
        if kind == "crash":
            return s.fail_peer(peer)
        return s.rejoin_peer(peer)


def transient_blip(peer: int, at_op: int, duration_ops: int
                   ) -> List[FaultEvent]:
    """SUSPECT for ``duration_ops`` ops, then heal (UP)."""
    return [FaultEvent(at_op, "suspect", (peer,)),
            FaultEvent(at_op + duration_ops, "recover", (peer,))]


def crash(peer: int, at_op: int) -> List[FaultEvent]:
    """Permanent failure: UP/SUSPECT -> DOWN, recovery sweep + repair."""
    return [FaultEvent(at_op, "crash", (peer,))]


def correlated_crash(peers: Iterable[int], at_op: int) -> List[FaultEvent]:
    """Multi-peer (rack-scale) failure: every peer drops at one op."""
    return [FaultEvent(at_op, "crash", tuple(peers))]


def recovery_storm(peers: Iterable[int], at_op: int) -> List[FaultEvent]:
    """All crashed peers rejoin at once — the repair-drain stress case."""
    return [FaultEvent(at_op, "rejoin", tuple(peers))]


def standard_schedule(n_ops: int, *, blip_peer: int = 0,
                      crash_peer: int = 1,
                      correlated_peers: Tuple[int, int] = (2, 3)
                      ) -> List[FaultEvent]:
    """The canonical four-phase schedule used by the ``fault_recovery``
    benchmark and the recovery tests, scaled to an ``n_ops`` trace:

      phase 1 (~10-25%): transient blip on ``blip_peer`` (retry/backoff)
      phase 2 (~40%):    permanent crash of ``crash_peer`` (repair kicks in)
      phase 3 (~60%):    correlated two-peer crash (rack failure)
      phase 4 (~75%):    recovery storm — all three dead peers rejoin
    """
    evs = transient_blip(blip_peer, n_ops // 10, max(1, 3 * n_ops // 20))
    evs += crash(crash_peer, 2 * n_ops // 5)
    evs += correlated_crash(correlated_peers, 3 * n_ops // 5)
    evs += recovery_storm((crash_peer,) + tuple(correlated_peers),
                          3 * n_ops // 4)
    return evs


def peers_in_domain(domains: Sequence[int], domain: int) -> Tuple[int, ...]:
    """Every peer id in one failure domain (rack) — the unit a correlated
    failure takes out.  ``domains`` maps peer -> domain id (see
    ``cluster.PeerProfile`` / ``draw_peer_profiles``)."""
    return tuple(p for p, d in enumerate(domains) if d == domain)


def domain_correlated_crash(domains: Sequence[int], domain: int,
                            at_op: int) -> List[FaultEvent]:
    """Rack-scale correlated crash: every peer in ``domain`` drops at one
    op.  With strictly cross-domain replica placement this must never lose
    a replicated page — the cluster benchmark gates exactly that."""
    peers = peers_in_domain(domains, domain)
    assert peers, f"failure domain {domain} holds no peers"
    return correlated_crash(peers, at_op)


def domain_recovery_storm(domains: Sequence[int], domain: int,
                          at_op: int) -> List[FaultEvent]:
    """The whole rack rejoins at once — the cross-host repair-drain and
    storm-admission stress case."""
    peers = peers_in_domain(domains, domain)
    assert peers, f"failure domain {domain} holds no peers"
    return recovery_storm(peers, at_op)


def cluster_schedule(n_ops: int, domains: Sequence[int], *,
                     crash_domain: Optional[int] = None
                     ) -> List[FaultEvent]:
    """The canonical cluster churn schedule (``cluster_tenant`` benchmark
    and the cross-host convergence tests), scaled to an ``n_ops`` trace:

      phase 1 (~40%): correlated crash of one whole failure domain
      phase 2 (~70%): rack-wide recovery storm — every dead peer rejoins

    ``crash_domain`` defaults to the highest domain id (by convention the
    far rack).  Identical inputs yield an identical schedule."""
    if crash_domain is None:
        crash_domain = max(domains)
    evs = domain_correlated_crash(domains, crash_domain, 2 * n_ops // 5)
    evs += domain_recovery_storm(domains, crash_domain, 7 * n_ops // 10)
    return evs


def random_schedule(n_ops: int, n_peers: int, *, seed: int = 0,
                    n_events: int = 8) -> List[FaultEvent]:
    """Seeded random fault schedule for fuzz traces.

    Events may be redundant (crashing a DOWN peer, recovering an UP one) —
    the injector fires them anyway and the store's fault API treats illegal
    transitions as no-ops, which is itself part of what the fuzz tests pin.
    Identical ``(n_ops, n_peers, seed)`` yield an identical schedule."""
    rng = np.random.default_rng(seed)
    kinds = FaultEvent._KINDS
    evs = []
    for _ in range(n_events):
        at = int(rng.integers(1, max(2, n_ops)))
        kind = kinds[int(rng.integers(0, len(kinds)))]
        peer = int(rng.integers(0, max(1, n_peers)))
        evs.append(FaultEvent(at, kind, (peer,)))
    return evs
