"""AsyncOrchestrator — overlap reclaim/flush/migration with the critical path.

The synchronous ``TieredPageStore`` runs every flush, reclaim and migration
inline: when the pool runs dry mid-write, the op pays the whole coalesced
remote send (``_flush(in_critical_path=True)``) — exactly the stall Valet's
design hides behind the critical path (§3.2, §5: the Remote Sender Thread
sends lazily while the app keeps writing locally).  This engine restores the
overlap with an **epoch/fence protocol**:

* **Ops pin the current epoch.**  The foreground processes ops in epochs of
  ``epoch_len``; all daemon work scheduled during an epoch commits at the
  *next* epoch boundary, never mid-op.
* **The daemon runs at epoch boundaries** (simulated-clock mode): it flushes
  staged write-sets, restocks the free list by draining the reclaimable
  queue into *epoch-tagged holds* (``ValetMempool.hold_from_free``), and
  absorbs migration copy costs.  Its simulated work accrues to
  ``daemon_clock`` — time the daemon is busy — not to the critical path.
* **A fence is taken only when the pool is genuinely exhausted**: the op
  waits ``max(0, daemon_clock - now)`` (the daemon's in-flight work), all
  holds commit, and the op proceeds.  Only if the daemon had nothing in
  flight does the op fall back to the synchronous emergency flush.

Simulated-clock mode is **deterministic** (no threads, no wall clock), so
its sync/async p99 ratio is reproducible run to run.  The
optional ``real_thread`` mode runs the same daemon work on a real
``threading.Thread`` under a store-wide lock — not deterministic, verified
by the ``InvariantChecker`` and statistical ``Stats`` bounds instead.

**This deliberately breaks bitwise parity with the scalar reference** (flush
cadence, victim order and placement draws all shift).  Its verification tier
is ``repro_torch.core.invariants.InvariantChecker`` — no lost writes, §5.2
write-set safety, slab/page conservation, replica-index consistency — plus
statistical-equivalence bounds on hit/miss/eviction counts vs sync mode.
Synchronous mode is untouched and keeps its bitwise-parity suites.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Optional

import numpy as np


class DaemonClock:
    """Simulated background-daemon clock (us, same axis as ``time_us``).

    ``at_us`` is the time at which the daemon becomes idle.  ``charge``
    appends work starting from ``max(at_us, now)`` (the daemon can't start
    before it is free *or* before the work exists); ``wait_for`` is the
    fence wait ``max(0, at_us - now)``.  ``AsyncOrchestrator`` keeps its
    inline ``daemon_clock`` float for bit-stability of the existing suites;
    the serve engine's async mode charges its demote/flush daemon through
    one of these.
    """

    def __init__(self):
        self.at_us = 0.0

    def charge(self, cost_us: float, now_us: float) -> float:
        """Schedule ``cost_us`` of daemon work at ``now_us``; returns it."""
        self.at_us = max(self.at_us, now_us) + cost_us
        return cost_us

    def wait_for(self, now_us: float) -> float:
        """Fence wait if the foreground synchronizes at ``now_us``."""
        w = self.at_us - now_us
        return w if w > 0.0 else 0.0


class AsyncOrchestrator:
    """Background daemon + epoch/fence protocol for one ``TieredPageStore``.

    Attach via ``OrchestrationConfig(async_mode=True)``; the store routes
    ``access_batch`` / ``background_tick`` / ``drain`` through here.
    """

    # RDMA one-sided writes pipeline on the wire (QP depth): the Remote
    # Sender Thread's per-page occupancy is the issue+completion share, not
    # the full serial latency.  This keeps the simulated daemon's throughput
    # in the regime the paper measures (the sender keeps up with the app).
    FLUSH_PIPELINE_DEPTH = 8

    def __init__(self, store, *, epoch_len: int = 64,
                 daemon_budget: int = 256, real_thread: bool = False):
        if epoch_len < 1:
            raise ValueError("epoch_len must be >= 1")
        if daemon_budget < 1:
            raise ValueError("daemon_budget must be >= 1")
        self.store = store
        self.epoch_len = int(epoch_len)
        self.daemon_budget = int(daemon_budget)
        self.real_thread = bool(real_thread)
        self.epoch = 0
        self._ops_in_epoch = 0
        # simulated time at which the daemon becomes idle (us, on the same
        # axis as stats.time_us); work scheduled at a boundary at time T
        # advances it by the charged cost from max(daemon_clock, T)
        self.daemon_clock = 0.0
        # counters (engine-level; Stats carries fences/fence_wait/daemon_us)
        self.n_boundaries = 0
        self.n_daemon_flush_pages = 0
        self.n_daemon_held_slots = 0
        # real-thread mode plumbing
        self._lock: Optional[threading.RLock] = None
        self._cv: Optional[threading.Condition] = None
        self._work: deque = deque()
        self._thread: Optional[threading.Thread] = None
        self._stop = False
        if self.real_thread:
            # ONE RLock shared with the condition: a fence waiting for the
            # daemon parks on ``_cv.wait()``, which releases the lock (all
            # recursion levels) so the daemon can take it, run its slice,
            # and notify — a separate condition lock would deadlock here
            self._lock = threading.RLock()
            self._cv = threading.Condition(self._lock)
            self._thread = threading.Thread(target=self._daemon_loop,
                                            daemon=True,
                                            name="valet-async-daemon")
            self._thread.start()

    # -- foreground: the async critical path ---------------------------------

    def run_batch(self, pages: np.ndarray, iw: np.ndarray,
                  out_lats: np.ndarray) -> None:
        """Process a batch op-by-op, pinning epochs by construction: the
        boundary only ever runs *between* ops, so no op observes a daemon
        commit mid-flight."""
        pages_l = pages.tolist()
        iw_l = np.asarray(iw, bool).tolist()
        lock = self._lock
        for i, (pg, w) in enumerate(zip(pages_l, iw_l)):
            if lock is not None:
                with lock:
                    out_lats[i] = self._write(pg) if w else self._read(pg)
            else:
                out_lats[i] = self._write(pg) if w else self._read(pg)
            self._ops_in_epoch += 1
            if self._ops_in_epoch >= self.epoch_len:
                self._ops_in_epoch = 0
                self.epoch_boundary()

    def _read(self, pg: int) -> float:
        # the scalar read never stalls (a failed cache-fill alloc simply
        # skips the fill), so it is reused verbatim
        return self.store.read(pg)

    def _write(self, pg: int) -> float:
        """The scalar ``write`` schedule with the synchronous flush stall
        replaced by a fence on the daemon."""
        store = self.store
        st = store.stats
        store.step += 1
        st.writes += 1
        lat = 0.0
        ppb = max(1, store.pages_per_block)
        ws = store.pipeline.write((pg,), store.step)
        if ws is None:
            # pool exhausted: reclaim from reclaimable queue (pointer move)
            store._reclaim(ppb)
            ws = store.pipeline.write((pg,), store.step)
        if ws is None:
            # genuinely exhausted: fence — wait out the daemon's in-flight
            # work and commit its holds instead of flushing inline
            lat += self._fence_locked()
            ws = store.pipeline.write((pg,), store.step)
        if ws is None:
            # daemon had nothing in flight either: emergency synchronous
            # flush, charged to this op exactly like the sync stall (rare)
            lat += store._flush(ppb, in_critical_path=True)
            store._reclaim(ppb)
            ws = store.pipeline.write((pg,), store.step)
        if ws is not None:
            store.gpt.map_local(pg, ws.slots[0])
            if store.data_plane is not None:
                store.data_plane.local_write(pg, ws.slots[0])
            lat += store.costs.local_write
        else:
            lat += store.costs.cold_write      # total pressure: spill cold
            store._host_add(pg)
        st.time_us += lat
        st.ops += 1
        return lat

    # -- fence ---------------------------------------------------------------

    def fence(self) -> float:
        """Public fence: drain the daemon and commit all holds NOW.  Returns
        the simulated wait charged (0 when the daemon was already idle)."""
        if self._lock is not None:
            with self._lock:
                return self._fence_locked()
        return self._fence_locked()

    def _fence_locked(self) -> float:
        store = self.store
        st = store.stats
        st.fences += 1
        if self.real_thread:
            self._wait_daemon_idle()
        wait = self.daemon_clock - st.time_us
        wait = wait if wait > 0.0 else 0.0
        st.fence_wait_us += wait
        st.fence_lat.record(wait)
        store.pool.commit_holds()
        if store.pool.free_count() == 0:
            store._reclaim(max(1, store.pages_per_block))
        return wait

    # -- epoch boundary / daemon work ----------------------------------------

    def epoch_boundary(self, budget: Optional[int] = None) -> None:
        """Commit matured holds, then schedule this epoch's daemon work."""
        budget = self.daemon_budget if budget is None else int(budget)
        self.epoch += 1
        self.n_boundaries += 1
        if self.real_thread:
            with self._cv:
                self.store.pool.commit_holds(
                    now_us=self.store.stats.time_us)
                self._work.append(budget)
                self._cv.notify_all()
            return
        now = self.store.stats.time_us
        self.store.pool.commit_holds(now_us=now)
        self._daemon_work(budget, now)

    def _daemon_work(self, budget: int, now: float) -> None:
        """One daemon slice: flush staged sets, size the pool, restock the
        free list into an epoch-tagged hold.  State mutates now (visible at
        schedule time — the deliberate relaxation vs the scalar reference);
        the simulated cost lands on ``daemon_clock``, not the critical path."""
        store = self.store
        st = store.stats
        # 1. lazy send, off the critical path (the Remote Sender Thread)
        staged = len(store.pipeline.staging)
        if store.policy.lazy_send and staged:
            n = min(budget, staged)
            cost = store._flush(n)
            charged = cost / self.FLUSH_PIPELINE_DEPTH
            self.daemon_clock = max(self.daemon_clock, now) + charged
            st.daemon_us += charged
            self.n_daemon_flush_pages += min(n, staged)
        # 1b. re-replication repair: drain the degraded-block queue at the
        # daemon's pipelined rate — repairs overlap foreground ops exactly
        # like flushes (the repair copies are sender-driven block writes)
        if store.repairq:
            before = st.repair_us
            pages = store._drain_repairs(
                min(budget, store.config.repair_rate))
            if pages:
                charged = (st.repair_us - before) / self.FLUSH_PIPELINE_DEPTH
                self.daemon_clock = max(self.daemon_clock, now) + charged
                st.daemon_us += charged
        # keep the coordinator's degraded-admission signal in sync (note
        # while the backlog persists, clear_degraded once it drains)
        store._report_repair_backlog()
        # 2. pool sizing (same cadence as the sync background_tick)
        if store.policy.dynamic_pool:
            store.pool.shrink_for_pressure()
            if not store.repairq:
                store.pool.maybe_grow()
        # 3. restock ahead of demand: drain the reclaimable queue into a
        # hold that commits once the daemon's clock catches up (at the
        # earliest, the next epoch boundary).  The target is capped at half
        # the pool — restocking two epochs of allocations is pointless (and
        # guts local residency) when the pool itself is barely bigger
        pool = store.pool
        target = min(2 * self.epoch_len, pool.size // 2)
        want = target - pool.free_count() - pool.held_count()
        if want > 0 and len(store.pipeline.reclaimable):
            k = store._reclaim_held(min(want, budget), self.epoch,
                                    self.daemon_clock)
            self.n_daemon_held_slots += k

    def tick(self, budget: int) -> None:
        """``background_tick`` in async mode: an extra epoch boundary with
        an explicitly raised daemon budget."""
        self.epoch_boundary(budget=max(int(budget), self.daemon_budget))

    # -- migration accounting -------------------------------------------------

    def note_block_copied(self, n_pages: int) -> None:
        """Charge one migrated block's copy (read from source + write to
        destination per page, pipelined) to the daemon clock — migration
        runs concurrently with the critical path (§3.5 sender-driven
        protocol; receivers are passive)."""
        store = self.store
        cost = n_pages * (store.costs.remote_read
                          + store.costs.remote_write) \
            / self.FLUSH_PIPELINE_DEPTH
        now = store.stats.time_us
        self.daemon_clock = max(self.daemon_clock, now) + cost
        store.stats.daemon_us += cost

    # -- quiesce / teardown ---------------------------------------------------

    def quiesce(self) -> None:
        """Barrier for ``drain()``: finish all daemon work and commit every
        hold, WITHOUT charging the foreground (a drain is a checkpoint
        barrier, not a critical-path op)."""
        if self.real_thread:
            with self._cv:
                self._wait_daemon_idle()
                self.store.pool.commit_holds()
            return
        self.store.pool.commit_holds()

    def close(self) -> None:
        """Stop the real daemon thread (no-op in simulated-clock mode)."""
        if self._thread is None:
            return
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._thread.join(timeout=5.0)
        self._thread = None

    # -- real-thread mode ------------------------------------------------------

    def _wait_daemon_idle(self) -> None:
        # caller holds the shared lock; wait() releases it (every recursion
        # level) so the daemon can drain, then re-acquires before returning
        while self._work:
            self._cv.wait(timeout=0.05)

    def _daemon_loop(self) -> None:
        while True:
            with self._cv:
                while not self._work and not self._stop:
                    self._cv.wait(timeout=0.1)
                if self._stop and not self._work:
                    return
                budget = self._work[0]
                self._daemon_work(budget, self.store.stats.time_us)
                self._work.popleft()
                self._cv.notify_all()
