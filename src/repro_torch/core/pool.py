"""ValetMempool — the host-coordinated local memory pool (paper §3.4, §4.1).

This is the control plane: deterministic metadata over a fixed array of page
slots whose *effective* size grows and shrinks dynamically.  The data plane
(actual K/V page arrays in HBM) lives in ``tiering.py`` / ``serve``; slots
here are indices into those arrays.

The metadata is **structure-of-arrays**: one dense numpy column per field
(``state``, ``owner``, ``last_step``, ``update_flag``, ``reclaim_flag``)
plus the free list as a stack over an int array (``_free_arr`` /
``_free_top`` — LIFO, preserving the exact pop/append order of the old
Python-list free list, which parity tests pin).  Whole reclaim bursts,
allocation runs and resize windows become masked gathers/scatters instead
of per-slot object churn; the scalar methods (``alloc``/``reclaim``/...)
keep their per-op semantics on the same arrays, and ``slots[i]`` returns a
lightweight view object for the reference paths and tests.

Paper-faithful rules (Table 2 + §4.1):

* **Use-pool-first**: allocation takes a pre-allocated free slot if one
  exists; only when the pool is exhausted does it try to *grow* (the inverse
  of Linux mempool's allocate-first).
* **Growth**: when usage reaches 80% of the current pool size, the pool
  grows on demand, capped at ``min(max_pool_pages, 50% of host free pages)``.
* **Shrink**: when host free memory drops, the pool shrinks (releasing FREE
  slots only), never below ``min_pool_pages``.
* Slot lifecycle (write path, §4.1 "Local Mempool Page Reclaim"):
  ``FREE -> IN_USE -> (staged for remote send) -> RECLAIMABLE -> FREE``.
  Reclaiming a page is a pointer move ("a few CPU cycles").
"""
from __future__ import annotations

import enum
from typing import Callable, List, Optional, Tuple

import numpy as np


class SlotState(enum.IntEnum):
    FREE = 0          # in the pool, ready to serve an allocation
    IN_USE = 1        # holds live data not yet replicated remotely
    RECLAIMABLE = 2   # remote replica exists; may be reclaimed for reuse
    UNBACKED = 3      # beyond the current effective pool size


_FREE = int(SlotState.FREE)
_IN_USE = int(SlotState.IN_USE)
_RECLAIMABLE = int(SlotState.RECLAIMABLE)
_UNBACKED = int(SlotState.UNBACKED)


class SlotView:
    """Scalar view of one slot's metadata row.

    The SoA columns are the single source of truth; this object is a
    zero-copy accessor kept for the scalar reference paths and the unit
    tests, which read and write slots as objects (``pool.slots[i].state``).
    """

    __slots__ = ("_p", "_i")

    def __init__(self, pool: "ValetMempool", i: int):
        self._p = pool
        self._i = i

    @property
    def state(self) -> SlotState:
        return SlotState(int(self._p.state[self._i]))

    @state.setter
    def state(self, v: SlotState):
        self._p.state[self._i] = int(v)

    @property
    def logical_page(self) -> int:
        return int(self._p.owner[self._i])

    @logical_page.setter
    def logical_page(self, v: int):
        self._p.owner[self._i] = v

    @property
    def last_activity(self) -> int:
        return int(self._p.last_step[self._i])

    @last_activity.setter
    def last_activity(self, v: int):
        self._p.last_step[self._i] = v

    @property
    def update_flag(self) -> bool:
        return bool(self._p.update_flag[self._i])

    @update_flag.setter
    def update_flag(self, v: bool):
        self._p.update_flag[self._i] = v

    @property
    def reclaim_flag(self) -> bool:
        return bool(self._p.reclaim_flag[self._i])

    @reclaim_flag.setter
    def reclaim_flag(self, v: bool):
        self._p.reclaim_flag[self._i] = v


class _SlotsView:
    """Sequence facade over the SoA columns (``pool.slots``)."""

    __slots__ = ("_p",)

    def __init__(self, pool: "ValetMempool"):
        self._p = pool

    def __len__(self):
        return self._p.capacity

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [SlotView(self._p, j)
                    for j in range(*i.indices(self._p.capacity))]
        return SlotView(self._p, i)

    def __iter__(self):
        return (SlotView(self._p, j) for j in range(self._p.capacity))


class ValetMempool:
    """Dynamic paged pool metadata.

    ``capacity`` is the physical slot-array size (the data-plane allocation);
    ``size`` is the current effective pool size (<= capacity), which grows
    and shrinks per the paper's rules.  ``free_memory_fn`` models host free
    pages (injected; in the serving engine it reports free HBM pages).
    """

    GROW_THRESHOLD = 0.8           # paper: grow at 80% usage
    HOST_FREE_FRACTION = 0.5       # paper: cap at 50% of host free memory

    def __init__(self, capacity: int, *, min_pages: int, max_pages: int,
                 free_memory_fn: Optional[Callable[[], int]] = None,
                 grow_step: Optional[int] = None,
                 lease=None):
        assert 0 < min_pages <= max_pages <= capacity
        self.capacity = capacity
        self.min_pages = min_pages
        self.max_pages = max_pages
        # coordinator-backed pools (``lease`` is a coordinator LeaseClient
        # whose registration already reserved ``min_pages``) probe the
        # coordinator's free slab instead of a synthetic host-free callable;
        # every grow must then be granted via ``lease.lease`` and every
        # shrink returns pages via ``lease.release``
        self.lease = lease
        if lease is not None:
            free_memory_fn = lease.available
        self.free_memory_fn = free_memory_fn or (lambda: capacity)
        self.grow_step = grow_step or max(min_pages // 2, 1)
        # structure-of-arrays slot metadata
        self.state = np.full(capacity, _UNBACKED, np.int8)
        self.owner = np.full(capacity, -1, np.int64)   # owning logical page
        self.last_step = np.zeros(capacity, np.int64)  # last write activity
        self.update_flag = np.zeros(capacity, bool)    # §5.2 newer set pends
        self.reclaim_flag = np.zeros(capacity, bool)   # §5.2 replica exists
        # per-slot allocation generation: bumped every FREE -> IN_USE
        # transition.  The device tier (core/tiers.py) validates its
        # demoted-but-resident entries against this lazily — a slot reused
        # since demotion has a newer generation — so no alloc hot path pays
        # a callback hook for zero-restore tracking.
        self.gen = np.zeros(capacity, np.int64)
        self._free_arr = np.empty(capacity, np.int64)  # free stack (LIFO)
        self._free_top = 0
        # epoch-tagged holds (async engine): slots the background daemon has
        # reclaimed but whose simulated completion has not been committed at
        # an epoch boundary yet.  Held slots are FREE-state but OFF the free
        # stack, so the foreground cannot allocate them early.  Each entry is
        # ``(epoch, finish_us, slots_array)``.
        self._held: List[Tuple[int, float, np.ndarray]] = []
        self.slots = _SlotsView(self)
        self.size = 0
        self._used = 0           # non-FREE/non-UNBACKED slots below size
        self._resize_to(min_pages)
        # counters for benchmarks / tests
        self.n_grow = 0
        self.n_shrink = 0
        self.n_alloc_from_pool = 0
        self.n_alloc_failed = 0
        self.n_reclaimed = 0
        self.n_claimed = 0       # zero-restore repoints (claim_batch)

    @property
    def _free(self) -> List[int]:
        """The free stack as a plain list, bottom to top (pop takes the last
        element) — the exact order the old list-backed free list held."""
        return self._free_arr[:self._free_top].tolist()

    # -- sizing ------------------------------------------------------------

    def _resize_to(self, new_size: int):
        new_size = max(self.min_pages, min(new_size, self.max_pages,
                                           self.capacity))
        if self._held and new_size < self.size:
            # a shrink rebuilds the free list from FREE-state slots and may
            # unback tail FREE slots — both would corrupt held slots (FREE
            # but deliberately off the list), so holds commit first
            self.commit_holds()
        state = self.state
        if new_size > self.size:
            # only back slots that are actually UNBACKED: a previous shrink
            # can strand non-FREE slots beyond the effective size (they keep
            # live data and simply return under the size here), and a
            # stranded slot released in the meantime is already on the free
            # list — blindly marking the range FREE would clobber both
            back = self.size + np.flatnonzero(
                state[self.size:new_size] == _UNBACKED)
            if back.size:
                state[back] = _FREE
                # re-backed memory is fresh pages, not the old bytes — bump
                # the generation so stale device-tier shadows never validate
                # against a slot that was unbacked in between
                self.gen[back] += 1
                top = self._free_top
                self._free_arr[top:top + back.size] = back
                self._free_top = top + back.size
        elif new_size < self.size:
            # release only FREE slots from the tail of the pool: the
            # reversed scan of the old loop releases the highest-index FREE
            # slots first, i.e. the tail suffix of the FREE set
            want = self.size - new_size
            tail_free = new_size + np.flatnonzero(
                state[new_size:self.size] == _FREE)
            rel = tail_free[max(tail_free.size - want, 0):]
            if rel.size:
                state[rel] = _UNBACKED
                fl = self._free_arr[:self._free_top]
                kept = fl[state[fl] == _FREE]       # order preserved
                self._free_arr[:kept.size] = kept
                self._free_top = int(kept.size)
            new_size = self.size - int(rel.size)
        self.size = new_size
        # resizes can strand non-FREE slots beyond the effective size, so
        # the O(1) usage counter is rebuilt here (resizes are rare events)
        s = state[:new_size]
        self._used = int(np.count_nonzero((s != _FREE) & (s != _UNBACKED)))

    def used(self) -> int:
        return self._used

    def usage_fraction(self) -> float:
        return self.used() / max(self.size, 1)

    def maybe_grow(self):
        """Paper: grow on demand at 80% usage, capped by max and host-free."""
        if self.size >= self.max_pages:
            # static pool (or already at max): growth is provably futile, so
            # skip the usage/host-free probes — the alloc path calls this on
            # every high-usage alloc (free_memory_fn is pure in this repo)
            return False
        if self.usage_fraction() < self.GROW_THRESHOLD:
            return False
        host_cap = int(self.free_memory_fn() * self.HOST_FREE_FRACTION)
        target = min(self.size + self.grow_step, self.max_pages,
                     max(host_cap, self.min_pages))
        if target <= self.size:
            return False
        if self.lease is not None:
            # coordinator-backed: the grow must be granted (one batched
            # lease per grow step); a partial grant grows partially
            granted = self.lease.lease(target - self.size)
            if granted <= 0:
                return False
            target = self.size + granted
        old = self.size
        self._resize_to(target)
        grew = self.size > old
        self.n_grow += int(grew)
        return grew

    def ensure_free(self, n: int) -> bool:
        """Grow (leasing if coordinator-backed) until ``n`` slots are FREE.

        Unlike ``maybe_grow`` this is demand-sized rather than step-sized:
        callers that need a known burst (engine admission/restore) reserve
        it up front instead of discovering mid-burst that growth stalled.
        Respects the same max/host-free caps; returns False when they bind
        first (static pools return False immediately, without side effects).
        """
        while self._free_top < n:
            host_cap = int(self.free_memory_fn() * self.HOST_FREE_FRACTION)
            want = max(self.grow_step, n - self._free_top)
            target = min(self.size + want, self.max_pages,
                         max(host_cap, self.min_pages))
            if target <= self.size:
                return False
            if self.lease is not None:
                granted = self.lease.lease(target - self.size)
                if granted <= 0:
                    return False
                target = self.size + granted
            old = self.size
            self._resize_to(target)
            self.n_grow += int(self.size > old)
            if self.size <= old:
                return False
        return True

    def shrink_for_pressure(self):
        """Shrink toward host free memory, never below min_pages."""
        host_cap = int(self.free_memory_fn() * self.HOST_FREE_FRACTION)
        target = max(self.min_pages, min(self.size, host_cap))
        if target < self.size:
            old = self.size
            self._resize_to(target)
            released = old - self.size
            if released and self.lease is not None:
                self.lease.release(released)
            self.n_shrink += int(self.size < old)
            return True
        return False

    def shrink_by(self, n: int) -> int:
        """Donate up to ``n`` pages back to the host (coordinator pressure
        path): releases FREE slots only, never below ``min_pages``, and
        returns the pages actually shed (already released to the lease)."""
        if n <= 0:
            return 0
        old = self.size
        self._resize_to(self.size - n)
        released = old - self.size
        if released:
            if self.lease is not None:
                self.lease.release(released)
            self.n_shrink += 1
        return released

    # -- overrun prediction (plan-once batch engine) -------------------------

    def alloc_prefix_capacity(self, n: int) -> int:
        """How many of ``n`` upcoming single-slot allocations would succeed
        back to back without a reclaim, counting the growth the alloc path
        itself would trigger (the pre-alloc grow at an empty free list and
        the 80%-usage opportunistic grow).

        This is the free-deficit predictor behind the plan-once
        ``access_batch`` engine: a batch segment is sized to exactly the
        allocations that fit, so the first op that would overrun the pool
        becomes an inline boundary event instead of a mid-bulk surprise.

        The prediction is a LOWER bound by construction — callers feed it to
        ``alloc_batch(..., allow_deficit=True)``, which asserts every alloc
        lands.  It is exact (simulating the same growth arithmetic against
        the same pure ``free_memory_fn``) for clean free-probe pools; pools
        with coordinator leases get a guaranteed lower bound from the
        coordinator's uncontended free slab (``_prefix_capacity_leased``);
        pools with stranded non-UNBACKED slots beyond the effective size (a
        prior shrink pinned live data in the tail) fall back to the current
        FREE count, which is always safe."""
        free = self._free_top
        if free >= n or n <= 0:
            return min(free, n) if n > 0 else 0
        size = self.size
        if size >= self.max_pages:
            return free
        if np.any(self.state[size:min(self.max_pages, self.capacity)]
                  != _UNBACKED):
            return free                # stranded tail: growth not predictable
        if self.lease is not None:
            return self._prefix_capacity_leased(n, free, size)
        grow_step = self.grow_step
        max_pages = self.max_pages
        min_pages = self.min_pages
        thresh = self.GROW_THRESHOLD
        host_frac = self.HOST_FREE_FRACTION
        free_fn = self.free_memory_fn
        used = self._used
        count = 0

        def sim_grow():
            # mirrors maybe_grow for a clean (no-lease, clean-tail) pool;
            # the usage precondition is checked by the callers below
            nonlocal size, free
            host_cap = int(free_fn() * host_frac)
            target = min(size + grow_step, max_pages,
                         max(host_cap, min_pages))
            if target <= size:
                return False
            free += target - size
            size = target
            return True

        while count < n:
            if free == 0:
                # scalar alloc's pre-grow: free list empty => usage is 1.0
                if not sim_grow():
                    break
            free -= 1
            used += 1
            count += 1
            if size < max_pages and used / max(size, 1) >= thresh:
                sim_grow()
        return count

    def _prefix_capacity_leased(self, n: int, free: int, size: int) -> int:
        """Lower-bound alloc capacity for coordinator-leased pools.

        Only the pre-alloc grow (empty free list) is modeled and every
        simulated grant is capped by the coordinator's CURRENT free slab —
        both choices keep the prediction a lower bound: the real path
        additionally takes 80%-usage opportunistic grows (extra capacity
        only) and ``lease()`` may reclaim co-tenants' excess on top of the
        free slab (larger grants only).  ``available_for`` — this pool's
        host-free probe — is invariant under its own leasing (a grant moves
        pages from the free slab into its own lease) and under weighted-fair
        reclamation (a donor's release moves its excess into the free slab),
        so the host cap is read once and holds for the whole simulation.
        Nothing here mutates the coordinator.

        The budget must be what ``lease()`` would actually grant, not the
        bare free count: a degraded container's grants are shed to its
        ``min_pages`` floor, so promising free-slab growth to it makes the
        alloc path's deficit mode overrun (``grantable_for`` folds the
        throttle in; for healthy containers it is the free slab capped at
        the lease room, which the ``cap_sz`` clamp below already implies —
        bitwise-identical predictions)."""
        coord = getattr(self.lease, "coordinator", None)
        if coord is None:
            return free                 # unknown lease backend: free is safe
        grantable = getattr(coord, "grantable_for", None)
        budget = coord.free() if grantable is None \
            else grantable(self.lease.cid)
        host_cap = int(self.free_memory_fn() * self.HOST_FREE_FRACTION)
        cap_sz = min(self.max_pages, max(host_cap, self.min_pages))
        # pre-grows repeat in grow_step chunks until the size cap or the
        # free-slab budget binds, so total guaranteed growth is their min
        growth = max(0, min(cap_sz - size, budget))
        return min(n, free + growth)

    # -- allocation ---------------------------------------------------------

    def alloc(self, logical_page: int, step: int) -> Optional[int]:
        """Use-pool-first allocation.  Returns a slot id or None."""
        if not self._free_top:
            self.maybe_grow()
        if not self._free_top:
            self.n_alloc_failed += 1
            return None
        top = self._free_top - 1
        self._free_top = top
        slot = int(self._free_arr[top])
        # FREE slots carry cleared §5.2 flags canonically (every transition
        # into FREE clears both; check_invariants pins it), so allocation
        # writes only the three live columns
        self.state[slot] = _IN_USE
        self.owner[slot] = logical_page
        self.last_step[slot] = step
        self.gen[slot] += 1
        if slot < self.size:
            self._used += 1
        self.n_alloc_from_pool += 1
        # opportunistic growth so the next alloc stays off the slow path
        if self.usage_fraction() >= self.GROW_THRESHOLD:
            self.maybe_grow()
        return slot

    def alloc_run(self, pages: np.ndarray, steps: np.ndarray) -> np.ndarray:
        """Vectorized bulk allocation for pools that cannot grow (static or
        already at ``max_pages``): one free-stack slice pop plus one scatter
        per metadata column.  Identical pop order, state transitions and
        counters as calling ``alloc`` per page (no growth trigger can fire).
        Requires ``free_count() >= len(pages)``; returns the slot array in
        allocation order."""
        n = len(pages)
        top = self._free_top - n
        sl = self._free_arr[top:self._free_top][::-1].copy()  # LIFO pop order
        self._free_top = top
        self.state[sl] = _IN_USE          # FREE ⇒ flags already clear
        self.owner[sl] = pages
        self.last_step[sl] = steps
        self.gen[sl] += 1
        if self.size == self.capacity:         # no stranded tail possible
            self._used += n
        else:
            self._used += int(np.count_nonzero(sl < self.size))
        self.n_alloc_from_pool += n
        return sl

    def alloc_batch(self, logical_pages, steps,
                    allow_deficit: bool = False) -> Optional[List[int]]:
        """Bulk use-pool-first allocation: one slot per page, in order.

        Semantically identical to calling ``alloc`` once per page (same free-
        stack pop order, same 80%-usage growth triggers, same counters).
        Pools pinned at ``max_pages`` take the fully vectorized ``alloc_run``
        (growth is provably futile there, which assumes ``free_memory_fn``
        is pure — it is everywhere in this repo); growable pools replay the
        scalar loop so every growth trigger lands at the exact op.

        Requires ``free_count() >= len(logical_pages)`` (the caller's batch
        guard); returns None without side effects otherwise.

        ``allow_deficit=True`` lifts the up-front guard for callers that
        pre-sized the batch with ``alloc_prefix_capacity``: the loop then
        also replicates the scalar alloc's pre-grow (grow when the free list
        is empty, before popping), and a pop that still cannot be served is
        an assertion failure — the predictor promised it would land.
        """
        pages = list(logical_pages)
        n = len(pages)
        if self._free_top < n and not allow_deficit:
            return None
        if self.size >= self.max_pages and self._free_top >= n:
            return self.alloc_run(np.asarray(pages, np.int64),
                                  np.asarray(list(steps), np.int64)).tolist()
        state = self.state
        owner = self.owner
        last = self.last_step
        free_arr = self._free_arr
        thresh = self.GROW_THRESHOLD
        size = self.size
        used = self._used
        can_grow = size < self.max_pages
        out: List[int] = []
        for pg, stp in zip(pages, steps):
            if not self._free_top:
                # scalar alloc's pre-grow: only reachable in deficit mode
                # (the guard above keeps the classic path pop-safe)
                self.maybe_grow()
                size = self.size
                used = self._used
                can_grow = size < self.max_pages
                assert self._free_top, \
                    "alloc_batch deficit: predictor overpromised"
            top = self._free_top - 1
            self._free_top = top
            slot = int(free_arr[top])
            state[slot] = _IN_USE         # FREE ⇒ flags already clear
            owner[slot] = pg
            last[slot] = stp
            self.gen[slot] += 1
            out.append(slot)
            if slot < size:
                used += 1
                self._used = used
            if can_grow and used / max(size, 1) >= thresh:
                if self.maybe_grow():
                    size = self.size
                    used = self._used
                    can_grow = size < self.max_pages
        self.n_alloc_from_pool += n
        return out

    def touch(self, slot: int, step: int):
        """Record write activity (paper: timestamp tag updated on write)."""
        self.last_step[slot] = step

    def mark_reclaimable(self, slot: int) -> bool:
        """Remote replica now exists (WC polled): slot may be reclaimed.

        Returns False when §5.2 defers the transition: a newer write-set for
        the same page is still pending, so the flag is cleared and the slot
        stays IN_USE until that newer set completes (the caller re-marks it
        then)."""
        if self.update_flag[slot]:
            self.update_flag[slot] = False
            return False
        self.state[slot] = _RECLAIMABLE
        self.reclaim_flag[slot] = True
        return True

    def reclaim(self, slot: int) -> int:
        """Return a RECLAIMABLE slot to the free list.  O(1) pointer move."""
        assert self.state[slot] == _RECLAIMABLE, SlotState(int(
            self.state[slot]))
        page = int(self.owner[slot])
        # RECLAIMABLE ⇒ update_flag already clear (mark_reclaimable defers
        # flagged slots; a pending slot is never RECLAIMABLE)
        self.state[slot] = _FREE
        self.owner[slot] = -1
        self.reclaim_flag[slot] = False
        if slot < self.size:
            self._used -= 1
        self._free_arr[self._free_top] = slot
        self._free_top += 1
        self.n_reclaimed += 1
        return page

    def reclaim_window(self, start: int, end: int
                       ) -> Tuple[np.ndarray, np.ndarray]:
        """Targeted out-of-FIFO reclaim of every RECLAIMABLE slot in
        ``[start, end)`` — the ``host_donate`` shrink window — as one masked
        gather/scatter.  Identical per-slot transitions, free-stack append
        order (ascending slot) and counters as calling ``reclaim`` on each.
        Returns the reclaimed ``(slots, pages)`` arrays."""
        w = start + np.flatnonzero(self.state[start:end] == _RECLAIMABLE)
        if not w.size:
            return w, w
        pages = self.owner[w].copy()
        self.state[w] = _FREE             # RECLAIMABLE ⇒ update_flag clear
        self.owner[w] = -1
        self.reclaim_flag[w] = False
        self._used -= int(np.count_nonzero(w < self.size))
        top = self._free_top
        self._free_arr[top:top + w.size] = w
        self._free_top = top + w.size
        self.n_reclaimed += int(w.size)
        return w, pages

    def release(self, slot: int):
        """Return an IN_USE slot directly to the free list (rollback path)."""
        assert self.state[slot] == _IN_USE, SlotState(int(self.state[slot]))
        self.state[slot] = _FREE
        self.owner[slot] = -1
        self.update_flag[slot] = False
        self.reclaim_flag[slot] = False
        if slot < self.size:
            self._used -= 1
        self._free_arr[self._free_top] = slot
        self._free_top += 1

    def release_batch(self, slots):
        """Bulk ``release``: the same per-slot transitions as one scatter
        per column (spill/free paths release whole page runs).  ``slots``
        must be distinct — they come from distinct pages' pool slots."""
        sl = np.asarray(slots, np.int64)
        if not sl.size:
            return
        assert (self.state[sl] == _IN_USE).all(), "release of non-IN_USE slot"
        self.state[sl] = _FREE
        self.owner[sl] = -1
        self.update_flag[sl] = False
        self.reclaim_flag[sl] = False
        self._used -= int(np.count_nonzero(sl < self.size))
        top = self._free_top
        self._free_arr[top:top + sl.size] = sl
        self._free_top = top + sl.size

    def free_count(self) -> int:
        return self._free_top

    # -- zero-restore repoint (device tier) ----------------------------------

    def free_gen(self, slot: int) -> Optional[int]:
        """Current generation of ``slot`` if it is claimable (FREE, inside
        the effective pool size — i.e. on the free list, not an epoch hold),
        else ``None``.  This is the validity probe behind the device tier's
        lazy demoted-entry validation."""
        s = int(slot)
        if s >= self.size or self.state[s] != _FREE:
            return None
        if self._held and any(s in h[2] for h in self._held):
            return None
        return int(self.gen[s])

    def claim_batch(self, slots, pages, step: int) -> None:
        """Re-claim *specific* FREE slots off the free list (zero-restore
        repoint): the same FREE -> IN_USE transition as ``alloc`` but
        targeting the exact slots whose data is still resident, so no bytes
        move.  Preserves the relative free-stack order of the remaining
        slots.  Callers validate claimability first (``free_gen``)."""
        sl = np.asarray(slots, np.int64)
        if not sl.size:
            return
        assert (self.state[sl] == _FREE).all(), "claim of non-FREE slot"
        fl = self._free_arr[:self._free_top]
        keep = fl[~np.isin(fl, sl)]
        assert keep.size == self._free_top - sl.size, \
            "claimed slot not on the free list (held or duplicated)"
        self._free_arr[:keep.size] = keep
        self._free_top = int(keep.size)
        self.state[sl] = _IN_USE          # FREE ⇒ flags already clear
        self.owner[sl] = np.asarray(pages, np.int64)
        self.last_step[sl] = step
        self.gen[sl] += 1
        self._used += int(np.count_nonzero(sl < self.size))
        self.n_claimed += int(sl.size)

    # -- epoch-tagged holds (async orchestration engine) ---------------------

    def hold_from_free(self, k: int, epoch: int, finish_us: float) -> int:
        """Move the top ``k`` free-stack slots into an epoch-tagged hold.

        The async daemon reclaims slots *now* (metadata-wise) but the
        simulated reclaim work completes at ``finish_us``; until an epoch
        boundary commits the hold, the foreground must not allocate those
        slots.  Popping the just-reclaimed slots straight back off the stack
        keeps ``reclaim_bulk`` untouched.  Returns the slots actually held.
        """
        k = min(int(k), self._free_top)
        if k <= 0:
            return 0
        top = self._free_top - k
        self._held.append((int(epoch), float(finish_us),
                           self._free_arr[top:self._free_top].copy()))
        self._free_top = top
        return k

    def commit_holds(self, *, up_to_epoch: Optional[int] = None,
                     now_us: Optional[float] = None) -> int:
        """Release held slots back to the free stack.

        A hold commits when every given bound admits it (``epoch <=
        up_to_epoch`` and ``finish_us <= now_us``); with no bounds, all
        holds commit (the fence / quiesce path).  Returns slots released.
        """
        if not self._held:
            return 0
        released = 0
        keep: List[Tuple[int, float, np.ndarray]] = []
        for ep, fin, slots in self._held:
            if ((up_to_epoch is not None and ep > up_to_epoch)
                    or (now_us is not None and fin > now_us)):
                keep.append((ep, fin, slots))
                continue
            top = self._free_top
            self._free_arr[top:top + slots.size] = slots
            self._free_top = top + slots.size
            released += int(slots.size)
        self._held = keep
        return released

    def held_count(self) -> int:
        return sum(int(s.size) for _, _, s in self._held)

    def reclaimable_slots(self) -> List[int]:
        return np.flatnonzero(
            self.state[:self.size] == _RECLAIMABLE).tolist()

    # -- invariants (property tests) ----------------------------------------

    def check_invariants(self):
        assert self.min_pages <= self.size <= min(self.max_pages,
                                                  self.capacity)
        s = self.state[:self.size]
        brute_used = int(np.count_nonzero((s != _FREE) & (s != _UNBACKED)))
        assert self._used == brute_used, (self._used, brute_used)
        fl = self._free_arr[:self._free_top]
        held = (np.concatenate([s for _, _, s in self._held])
                if self._held else np.empty(0, np.int64))
        both = np.concatenate([fl, held])
        assert np.unique(both).size == both.size, \
            "slot duplicated across free list / holds"
        assert (self.state[fl] == _FREE).all(), "non-FREE slot on free list"
        assert (self.state[held] == _FREE).all(), "non-FREE held slot"
        assert (self.owner[held] == -1).all() if held.size else True
        free_mask = self.state == _FREE
        assert int(np.count_nonzero(free_mask)) == both.size, \
            "FREE slot missing from free list + holds"
        assert (self.owner[free_mask] == -1).all()
        # canonical §5.2 flags (the allocation/reclaim fast paths rely on
        # these): FREE slots carry no flags, RECLAIMABLE no update_flag
        assert not self.update_flag[free_mask].any()
        assert not self.reclaim_flag[free_mask].any()
        assert not self.update_flag[self.state == _RECLAIMABLE].any()
