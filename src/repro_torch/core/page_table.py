"""Global Page Table (paper §4.1) — logical page -> physical location.

The paper uses a radix tree (pointer-chasing, host-friendly).  On an
accelerator control plane we keep the same contract with flat dense tables:
O(1) lookup, grow-on-demand, and the paper's simple existence rule — *if a
local mapping exists the page is local; otherwise it is remote* — which
avoids lock contention on updates (here: avoids read-modify-write races
between the scheduler thread and the flush thread).

The backing store is a set of dense numpy arrays indexed by logical page id
(page ids are small sequential ints in both the simulator and the serving
engine), so a whole batch of lookups is a single vectorized gather
(``lookup_batch`` / ``local_slots_batch``) instead of a Python loop of dict
probes — the enabling piece of ``TieredPageStore.access_batch``.  Replica
lists are sparse (only replicated pages carry them) and stay dict-backed.

Tiers mirror DESIGN.md §2: LOCAL HBM pool -> PEER device HBM -> HOST DRAM ->
COLD (recompute / disk analogue).
"""
from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np


class Tier(enum.IntEnum):
    NONE = 0
    LOCAL = 1      # local HBM pool slot
    PEER = 2       # another device's spill pool (RDMA MR analogue)
    HOST = 3       # host DRAM (pinned) tier
    COLD = 4       # disk / recompute analogue
    # demoted-but-resident: the page's pool slot was released (preemption /
    # reclaim) but its bytes are still untouched in device memory, so a
    # later access can *repoint* to the old slot instead of reading a copy
    # back (zero-restore serving; see core/tiers.DeviceTier).  Stored in the
    # remote columns with ``slot`` = the shadow pool slot.
    DEVICE = 5


@dataclass(frozen=True)
class Location:
    tier: Tier
    peer: int = -1          # peer id for Tier.PEER / host id for Tier.HOST
    slot: int = -1          # slot within that tier's pool
    replicas: Tuple[Tuple[int, int], ...] = ()   # [(peer, slot)] extra copies


class GlobalPageTable:
    """logical page id -> Location (+ optional local pool slot).

    Scalar API (``map_local`` / ``lookup`` / ...) is unchanged from the
    dict-backed version; the ``*_batch`` methods operate on int arrays and
    are the fast path for batched orchestration.
    """

    def __init__(self, initial_pages: int = 1024):
        n = max(int(initial_pages), 1)
        self._l_slot = np.full(n, -1, np.int64)    # page -> local pool slot
        self._r_tier = np.zeros(n, np.int8)        # page -> remote tier
        self._r_peer = np.full(n, -1, np.int32)
        self._r_slot = np.full(n, -1, np.int64)
        self._r_mapped = np.zeros(n, bool)         # remote entry exists
        self._replicas: Dict[int, Tuple[Tuple[int, int], ...]] = {}

    # -- capacity ------------------------------------------------------------

    def _ensure(self, page: int):
        """Grow the dense tables to cover ``page`` (geometric growth)."""
        n = self._l_slot.shape[0]
        if page < n:
            return
        new = max(n * 2, page + 1)

        def grow(arr, fill):
            out = np.full(new, fill, arr.dtype)
            out[:n] = arr
            return out

        self._l_slot = grow(self._l_slot, -1)
        self._r_tier = grow(self._r_tier, 0)
        self._r_peer = grow(self._r_peer, -1)
        self._r_slot = grow(self._r_slot, -1)
        self._r_mapped = grow(self._r_mapped, False)

    # -- local mapping (the paper's "page reference exists -> local") --------

    def map_local(self, page: int, slot: int):
        self._ensure(page)
        self._l_slot[page] = slot

    def unmap_local(self, page: int) -> Optional[int]:
        if page >= self._l_slot.shape[0]:
            return None
        slot = self._l_slot[page]
        if slot < 0:
            return None
        self._l_slot[page] = -1
        return int(slot)

    def local_slot(self, page: int) -> Optional[int]:
        if page >= self._l_slot.shape[0]:
            return None
        slot = self._l_slot[page]
        return None if slot < 0 else int(slot)

    # -- remote mapping -------------------------------------------------------

    def map_remote(self, page: int, loc: Location):
        page = int(page)
        self._ensure(page)
        self._r_tier[page] = int(loc.tier)
        self._r_peer[page] = loc.peer
        self._r_slot[page] = loc.slot
        self._r_mapped[page] = True
        if loc.replicas:
            self._replicas[page] = tuple(loc.replicas)
        else:
            self._replicas.pop(page, None)

    def remote_location(self, page: int) -> Optional[Location]:
        page = int(page)
        if page >= self._r_mapped.shape[0] or not self._r_mapped[page]:
            return None
        return Location(Tier(int(self._r_tier[page])),
                        peer=int(self._r_peer[page]),
                        slot=int(self._r_slot[page]),
                        replicas=self._replicas.get(page, ()))

    def drop_remote(self, page: int):
        page = int(page)
        if page >= self._r_mapped.shape[0]:
            return
        self._r_mapped[page] = False
        self._r_tier[page] = 0
        self._r_peer[page] = -1
        self._r_slot[page] = -1
        self._replicas.pop(page, None)

    def lookup(self, page: int) -> Location:
        """Resolution order: local pool, then remote, then NONE."""
        slot = self.local_slot(page)
        if slot is not None:
            return Location(Tier.LOCAL, slot=slot)
        return self.remote_location(page) or Location(Tier.NONE)

    def pages_on_peer(self, peer: int) -> List[int]:
        mask = (self._r_tier == int(Tier.PEER)) & (self._r_peer == peer) \
            & self._r_mapped
        return [int(p) for p in np.flatnonzero(mask)]

    def repoint_replica(self, page: int, alive=None) -> bool:
        """Peer failure: promote the first replica to primary (Table 3).

        ``alive`` (optional ``peer -> bool``) filters the candidate set: a
        replica on a DOWN peer is never promoted and is dropped from the
        surviving tuple (correlated failures would otherwise promote a
        dead copy)."""
        page = int(page)
        reps = self._replicas.get(page)
        if page >= self._r_mapped.shape[0] or not self._r_mapped[page] \
                or not reps:
            return False
        if alive is not None:
            reps = tuple(r for r in reps if alive(r[0]))
            if not reps:
                return False
        (peer, slot), rest = reps[0], reps[1:]
        self.map_remote(page, Location(Tier(int(self._r_tier[page])),
                                       peer=peer, slot=slot, replicas=rest))
        return True

    def purge_replicas_on_peer(self, peer: int) -> int:
        """Strip every replica tuple entry living on ``peer`` (peer death):
        a surviving primary's page must never carry — let alone later
        promote — a replica on a DOWN peer.  Returns pages touched."""
        rd = self._replicas
        if not rd:
            return 0
        n = 0
        for pg in list(rd):
            reps = rd[pg]
            kept = tuple(r for r in reps if r[0] != peer)
            if len(kept) != len(reps):
                n += 1
                if kept:
                    rd[pg] = kept
                else:
                    del rd[pg]
        return n

    def add_replica_batch(self, pages, primary: Tuple[int, int],
                          rep: Tuple[int, int]) -> int:
        """Append replica ``rep`` to every page still mapped with
        ``primary`` as its remote block (the re-replication repair path:
        one mask over the block's page list instead of per-page lookups).
        Pages that moved on — overwritten, migrated, promoted — are
        skipped.  Returns pages updated."""
        parr = np.asarray(pages, np.int64)
        if not parr.size:
            return 0
        self._ensure(int(parr.max()))
        mask = (self._r_tier[parr] == int(Tier.PEER)) \
            & (self._r_peer[parr] == primary[0]) \
            & (self._r_slot[parr] == primary[1]) \
            & self._r_mapped[parr]
        hit = parr[mask]
        rd = self._replicas
        for pg in hit.tolist():
            cur = rd.get(pg, ())
            if rep not in cur:
                rd[pg] = cur + (rep,)
        return int(hit.size)

    def __len__(self):
        return int(np.count_nonzero((self._l_slot >= 0) | self._r_mapped))

    # -- vectorized batch operations (the access_batch fast path) -------------

    def lookup_batch(self, pages: np.ndarray
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Vectorized ``lookup`` for a whole batch: one gather per table.

        Returns ``(tier, peer, slot)`` int arrays; local mappings override
        remote ones exactly as in the scalar resolution order.
        """
        pages = np.asarray(pages, np.int64)
        if pages.size:
            self._ensure(int(pages.max()))
        l_slot = self._l_slot[pages]
        is_local = l_slot >= 0
        tier = np.where(is_local, np.int8(Tier.LOCAL), self._r_tier[pages])
        peer = np.where(is_local, np.int32(-1), self._r_peer[pages])
        slot = np.where(is_local, l_slot, self._r_slot[pages])
        return tier, peer, slot

    def lookup_raw(self, pages: np.ndarray
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Raw gathers for hot callers: ``(local_slot, remote_tier,
        remote_peer)`` with no local-override blending — callers derive
        their own masks (a local slot >= 0 wins, as in ``lookup``)."""
        pages = np.asarray(pages, np.int64)
        if pages.size:
            self._ensure(int(pages.max()))
        return self._l_slot[pages], self._r_tier[pages], self._r_peer[pages]

    def lookup_raw_known(self, pages: np.ndarray
                         ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """``lookup_raw`` minus the growth check, for pages the caller has
        already resolved this batch (the tables cannot have shrunk since).
        This is the targeted re-gather used after a boundary reclaim: only
        the invalidated pages are re-classified, so the gather is a handful
        of rows instead of the whole remaining batch."""
        return self._l_slot[pages], self._r_tier[pages], self._r_peer[pages]

    def remote_raw_batch(self, pages: np.ndarray
                         ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                    np.ndarray]:
        """Vectorized ``remote_location`` essentials: ``(tier, peer, slot,
        mapped)`` arrays — ``mapped`` False where no remote entry exists."""
        pages = np.asarray(pages, np.int64)
        if pages.size:
            self._ensure(int(pages.max()))
        return (self._r_tier[pages], self._r_peer[pages],
                self._r_slot[pages], self._r_mapped[pages])

    def replicas_batch(self, pages) -> List[Tuple[Tuple[int, int], ...]]:
        """Replica tuples per page (``()`` where none) — bulk counterpart of
        reading ``remote_location(pg).replicas``."""
        rd = self._replicas
        if not rd:
            return [()] * len(pages)
        return [rd.get(int(pg), ()) for pg in pages]

    def has_replicas(self) -> bool:
        """True if any page currently carries replica copies."""
        return bool(self._replicas)

    def map_remote_batch(self, pages, tiers, peers, slots, replicas=None):
        """Bulk ``map_remote``: arrays of tier/peer/slot per page, plus an
        optional parallel sequence of replica tuples.  Duplicate pages keep
        last-writer-wins semantics, like sequential ``map_remote`` calls."""
        parr = np.asarray(pages, np.int64)
        if parr.size:
            self._ensure(int(parr.max()))
        self._r_tier[parr] = tiers
        self._r_peer[parr] = peers
        self._r_slot[parr] = slots
        self._r_mapped[parr] = True
        rd = self._replicas
        if replicas is None:
            if rd:
                for pg in parr.tolist():
                    rd.pop(pg, None)
        else:
            for pg, reps in zip(parr.tolist(), replicas):
                if reps:
                    rd[pg] = reps if type(reps) is tuple else tuple(reps)
                elif rd:
                    rd.pop(pg, None)

    def local_slots_batch(self, pages: np.ndarray) -> np.ndarray:
        """Vectorized ``local_slot``: int64 array, -1 where unmapped."""
        pages = np.asarray(pages, np.int64)
        if pages.size:
            self._ensure(int(pages.max()))
        return self._l_slot[pages]

    def local_slots_known(self, pages: np.ndarray) -> np.ndarray:
        """``local_slots_batch`` minus the growth check, for pages already
        covered by the tables (they were resolved or mapped before — the
        reclaim unmapper's case: every freed page was mapped once)."""
        return self._l_slot[pages]

    def map_local_known(self, pages: np.ndarray, slots: np.ndarray):
        """``map_local_batch`` minus the asarray/growth work, for int64
        page arrays the caller already resolved this batch (the segment
        engine: its snapshot gather grew the tables over the whole batch).
        Duplicate pages keep last-writer-wins, like sequential maps."""
        self._l_slot[pages] = slots

    def map_local_batch(self, pages: np.ndarray, slots: np.ndarray):
        pages = np.asarray(pages, np.int64)
        if pages.size:
            self._ensure(int(pages.max()))
        self._l_slot[pages] = slots

    def unmap_local_batch(self, pages: np.ndarray):
        pages = np.asarray(pages, np.int64)
        if pages.size:
            self._ensure(int(pages.max()))
        self._l_slot[pages] = -1

    def drop_remote_batch(self, pages):
        """Bulk ``drop_remote``: clear remote entries for a page array."""
        parr = np.asarray(pages, np.int64)
        if not parr.size:
            return
        self._ensure(int(parr.max()))
        self._r_mapped[parr] = False
        self._r_tier[parr] = 0
        self._r_peer[parr] = -1
        self._r_slot[parr] = -1
        if self._replicas:
            rd = self._replicas
            for pg in parr.tolist():
                rd.pop(pg, None)

    # -- dense device-facing view ---------------------------------------------

    def block_table(self, pages: List[int], n_peers: int,
                    pages_per_peer: int) -> np.ndarray:
        """Dense per-peer gather lists for the data plane.

        Returns int32 [n_peers, pages_per_peer] of tier-slot ids (-1 pad) —
        the device-side view the paged-attention kernel consumes.  Pages in
        the LOCAL tier are listed under peer 0's pool by convention of the
        caller (serving engine passes separate local lists).
        """
        out = np.full((n_peers, pages_per_peer), -1, np.int32)
        fill = [0] * n_peers
        for pg in pages:
            loc = self.lookup(pg)
            if loc.tier == Tier.PEER and fill[loc.peer] < pages_per_peer:
                out[loc.peer, fill[loc.peer]] = loc.slot
                fill[loc.peer] += 1
        return out
