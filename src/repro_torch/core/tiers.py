"""First-class memory tiers behind one small protocol.

Without tiers the device (HBM) KV pool is a *private* resource of whoever
owns it — the serve engine spilled KV through an ad-hoc ``host_store``
dict, and the trace store forgot a page's slot the moment ``_reclaim``
dropped its local mapping.  Both lose the paper's cheapest move: a page
whose pool slot has not been reused yet is still byte-identical in device
memory, so bringing it back is a *pointer repoint* (map the page to its old
slot again), not a data transfer — the serving analogue of the paper's
pointer-move reclaim (§5.1) and the vLLM-style "restore is block-table
repointing" shape.

Two tier objects implement the protocol:

* ``DeviceTier`` — tracks *demoted-but-resident* pages: pages whose pool
  slot was released (preemption / reclaim) but whose bytes are still
  sitting untouched in the slot.  Entries are validated lazily against the
  pool's per-slot generation counter (``ValetMempool.gen``), so no
  allocation hot path pays a hook: a slot that was reused since demotion
  simply fails validation.
* ``HostTier`` — holds the host-DRAM KV blobs (one per spilled page), the
  placement target of the background flush pipeline.  It replaces the serve
  engine's ``host_store`` dict; the trace store's host tier stays the
  simulated ``host_pages`` membership (no real bytes there).

The lifecycle both owners follow::

    preempt/reclaim --demote()--> device-resident (shadow, dirty)
        background flush ------>  + host copy (clean, still repointable)
        slot reused ----------->  evicted: host copy only (stream to return)
    restore/read --claim()----->  repoint (zero copy)   [common case]
                 --stream------>  per-page host read     [slot was reused]
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

from repro_torch.core.page_table import Tier


class PageTier:
    """Minimal tier protocol: named residency tracking for logical pages.

    Concrete tiers add their own movement verbs (``demote``/``claim`` for
    the device tier, ``put``/``pop`` for the host tier); the shared surface
    is what ``TieredPageStore``/``GlobalPageTable`` need to *track* pages
    across tiers: membership, count, and bulk drop.
    """

    #: the ``page_table.Tier`` value this object backs
    tier: Tier = Tier.NONE
    name: str = "none"

    def __contains__(self, page: int) -> bool:
        raise NotImplementedError

    def __len__(self) -> int:
        raise NotImplementedError

    def drop(self, pages: Iterable[int]) -> int:
        """Forget ``pages`` (freed sequences); returns entries dropped."""
        raise NotImplementedError


class DeviceTier(PageTier):
    """Demoted-but-resident pages of the device (HBM) KV pool.

    ``shadow`` maps page -> (slot, generation-at-demotion).  An entry is
    *valid* while the pool slot is still FREE with an unchanged generation
    — i.e. nobody allocated it since the demotion — which makes claiming it
    back a pure metadata move.  Validation is lazy; ``evict_slots`` exists
    for owners (the serve engine) that must copy dirty bytes out *before* a
    reused slot is overwritten.
    """

    tier = Tier.DEVICE
    name = "device"

    def __init__(self):
        self.shadow: Dict[int, Tuple[int, int]] = {}   # page -> (slot, gen)
        self._by_slot: Dict[int, int] = {}             # slot -> page
        # counters (benchmarks / tests)
        self.demotions = 0
        self.repoints = 0
        self.evictions = 0

    def __contains__(self, page: int) -> bool:
        return page in self.shadow

    def __len__(self) -> int:
        return len(self.shadow)

    def demote(self, pages: Iterable[int], slots: Iterable[int],
               gens: Iterable[int]) -> None:
        """Register pages as demoted-but-resident at their released slots."""
        shadow = self.shadow
        by_slot = self._by_slot
        n = 0
        for pg, sl, g in zip(pages, slots, gens):
            old = shadow.get(pg)
            if old is not None:
                by_slot.pop(old[0], None)
            shadow[pg] = (int(sl), int(g))
            by_slot[int(sl)] = int(pg)
            n += 1
        self.demotions += n

    def slot_of(self, page: int) -> Optional[int]:
        e = self.shadow.get(page)
        return None if e is None else e[0]

    def claim(self, page: int, gen_of) -> Optional[int]:
        """Validate + consume one entry: returns the slot if the page is
        still resident (slot FREE, generation unchanged — ``gen_of(slot)``
        returns the pool's current generation or ``None`` when the slot is
        not claimable), else ``None``.  Either way the entry is removed."""
        e = self.shadow.pop(page, None)
        if e is None:
            return None
        slot, gen = e
        self._by_slot.pop(slot, None)
        cur = gen_of(slot)
        if cur is None or cur != gen:
            self.evictions += 1
            return None
        self.repoints += 1
        return slot

    def split(self, pages: Iterable[int], gen_of
              ) -> Tuple[List[int], List[int], List[int]]:
        """Bulk ``claim``: partition ``pages`` into (repointable pages,
        their slots, missed pages).  Consumes every entry it touches."""
        rp_pages: List[int] = []
        rp_slots: List[int] = []
        missed: List[int] = []
        for pg in pages:
            slot = self.claim(pg, gen_of)
            if slot is None:
                missed.append(pg)
            else:
                rp_pages.append(pg)
                rp_slots.append(slot)
        return rp_pages, rp_slots, missed

    def evict_slots(self, slots: Iterable[int]) -> List[Tuple[int, int]]:
        """Slots were just re-allocated: pop and return the shadow
        ``(page, slot)`` pairs that lived there (the owner must secure a
        host copy of any dirty one before the new data lands)."""
        out: List[Tuple[int, int]] = []
        by_slot = self._by_slot
        if not by_slot:
            return out
        for sl in slots:
            pg = by_slot.pop(int(sl), None)
            if pg is not None:
                self.shadow.pop(pg, None)
                out.append((pg, int(sl)))
        self.evictions += len(out)
        return out

    def drop(self, pages: Iterable[int]) -> int:
        n = 0
        for pg in pages:
            e = self.shadow.pop(pg, None)
            if e is not None:
                self._by_slot.pop(e[0], None)
                n += 1
        return n


class HostTier(PageTier):
    """Host-DRAM KV blobs, one per spilled page (pinned-host analogue).

    ``blobs[page]`` holds whatever the owner spilled — the serve engine
    stores ``{layer: (k, v)}`` numpy pairs.  This is the placement target of
    the background flush: a demoted page gains a host copy here ("clean")
    without losing its device residency, so restore still repoints.
    """

    tier = Tier.HOST
    name = "host"

    def __init__(self):
        self.blobs: Dict[int, dict] = {}
        self.puts = 0

    def __contains__(self, page: int) -> bool:
        return page in self.blobs

    def __len__(self) -> int:
        return len(self.blobs)

    def put(self, page: int, blob) -> None:
        self.blobs[page] = blob
        self.puts += 1

    def pop(self, page: int):
        """Remove and return a blob (stream-in consumes the host copy)."""
        return self.blobs.pop(page)

    def get(self, page: int):
        return self.blobs.get(page)

    def drop(self, pages: Iterable[int]) -> int:
        n = 0
        for pg in pages:
            if self.blobs.pop(pg, None) is not None:
                n += 1
        return n
