"""Whole-store invariant checking + statistical stats equivalence.

The synchronous ``TieredPageStore`` is verified by *bitwise parity* suites
(scalar reference vs vectorized paths reach identical state).  The async
orchestration engine deliberately breaks bitwise parity — flush cadence,
victim order and placement draws all shift once daemon work overlaps the
critical path — so its verification tier is this module:

* ``InvariantChecker``: every safety property the paper's protocol promises,
  checked against the live store state.  Runs after every epoch in the async
  tests; passes trivially (and is also exercised) on the synchronous store.
* ``stats_close``: statistical-equivalence bounds between a sync and an
  async run of the same trace — the workload-visible counters (hits per
  tier, evictions, migrations) must agree within tolerance even though
  their exact interleavings differ.

The checks, mapped to the paper:

1. **No lost writes** (§3.1 reliability, §5.2): every IN_USE pool slot is
   reachable — it is staged for remote send or parked in the §5.2 deferred
   map.  An IN_USE slot outside both would hold the only copy of a write
   with nothing scheduled to ever send it.
2. **§5.2 write-set safety**: a page's latest pending slot is IN_USE (never
   RECLAIMABLE/FREE/held — reclaiming it would lose the newest data), and
   the page table maps the page to exactly that slot.
3. **Slab/page conservation**: pool FREE accounting (free stack + epoch
   holds) is exact; per-peer MR block counts match the dense membership
   columns and the block dict.
4. **Replica-index consistency** (§3.3): ``_replica_of`` and
   ``block_replicas`` are mutual inverses and agree with the dense
   ``_blk_replica`` flags.
5. **Mapping coherence**: local page-table entries point at slots owned by
   that page; PEER-mapped pages appear in their block's page list; the
   host-tier dict and its dense mirror agree.
"""
from __future__ import annotations

from typing import List

import numpy as np

from repro_torch.core.pool import SlotState

_IN_USE = int(SlotState.IN_USE)
_RECLAIMABLE = int(SlotState.RECLAIMABLE)


class InvariantError(AssertionError):
    """An invariant violation, with enough context to debug the trace."""


def _fail(msg: str):
    raise InvariantError(msg)


class InvariantChecker:
    """Checks every protocol invariant of one ``TieredPageStore``.

    Usage::

        chk = InvariantChecker(store)
        chk.check()          # raises InvariantError on the first violation

    Cheap enough to run after every epoch in tests (vectorized gathers over
    the SoA columns; the dict walks touch only live blocks/replicas).
    """

    def __init__(self, store):
        self.store = store
        self.n_checks = 0

    def check(self):
        self.n_checks += 1
        s = self.store
        # the queue/pool layer asserts its own conservation laws (free stack
        # + holds exactness, staged slots IN_USE, §5.2 flag canonicality)
        s.pipeline.check_invariants()
        self._check_no_lost_writes()
        self._check_write_set_safety()
        self._check_local_mappings()
        self._check_block_conservation()
        self._check_replica_index()
        self._check_gpt_block_containment()
        self._check_host_tier()
        self._check_peer_health()
        self._check_domain_disjointness()

    # -- 1. no lost writes ----------------------------------------------------

    def _check_no_lost_writes(self):
        s = self.store
        pool = s.pool
        in_use = set(np.flatnonzero(pool.state == _IN_USE).tolist())
        staged = {int(sl) for ws in s.pipeline.staging.entries()
                  for sl in ws.slots}
        defer = s.pipeline._defer
        deferred = set(defer[defer >= 0].tolist())
        orphans = in_use - staged - deferred
        if orphans:
            _fail(f"lost writes: IN_USE slots {sorted(orphans)[:8]} are "
                  "neither staged nor §5.2-deferred — nothing will ever "
                  "send or reclaim them")
        if staged - in_use:
            _fail("staged slot not IN_USE")
        if deferred - in_use:
            _fail("§5.2 deferred slot not IN_USE")

    # -- 2. §5.2 write-set safety ---------------------------------------------

    def _check_write_set_safety(self):
        s = self.store
        pend = s.pipeline._pend
        pgs = np.flatnonzero(pend >= 0)
        if not pgs.size:
            return
        slots = pend[pgs]
        st = s.pool.state[slots]
        if np.any(st != _IN_USE):
            bad = int(pgs[np.argmax(st != _IN_USE)])
            _fail(f"page {bad}: pending slot {int(pend[bad])} is "
                  f"{SlotState(int(s.pool.state[pend[bad]])).name}, "
                  "not IN_USE — the newest write could be reclaimed")
        # the page table must expose exactly the newest write
        lsl = s.gpt._l_slot
        known = pgs[pgs < lsl.shape[0]]
        if known.size < pgs.size:
            _fail("pending page beyond the page table")
        mism = known[lsl[known] != pend[known]]
        if mism.size:
            pg = int(mism[0])
            _fail(f"page {pg}: page table maps slot {int(lsl[pg])} but the "
                  f"pending (newest) slot is {int(pend[pg])}")

    # -- 5a. local mapping coherence ------------------------------------------

    def _check_local_mappings(self):
        s = self.store
        lsl = s.gpt._l_slot
        pgs = np.flatnonzero(lsl >= 0)
        if not pgs.size:
            return
        slots = lsl[pgs]
        owners = s.pool.owner[slots]
        if np.any(owners != pgs):
            i = int(np.argmax(owners != pgs))
            _fail(f"page {int(pgs[i])} maps local slot {int(slots[i])} "
                  f"owned by page {int(owners[i])}")
        st = s.pool.state[slots]
        bad = (st != _IN_USE) & (st != _RECLAIMABLE)
        if np.any(bad):
            i = int(np.argmax(bad))
            _fail(f"page {int(pgs[i])} maps local slot {int(slots[i])} in "
                  f"state {SlotState(int(st[i])).name}")

    # -- 3b. MR block conservation --------------------------------------------

    def _check_block_conservation(self):
        s = self.store
        by_peer: List[set] = [set() for _ in s.peers]
        for (p, slot) in s.blocks:
            by_peer[p].add(slot)
        for p, peer in enumerate(s.peers):
            hi = s._next_block_slot[p]
            if np.any(s._blk_live[p][hi:]):
                _fail(f"peer {p}: live flag beyond next_block_slot {hi}")
            live = set(np.flatnonzero(s._blk_live[p][:hi]).tolist())
            if live != by_peer[p]:
                _fail(f"peer {p}: dense live column {sorted(live)[:8]} != "
                      f"block dict {sorted(by_peer[p])[:8]}")
            if peer.used != len(live):
                _fail(f"peer {p}: used={peer.used} but {len(live)} live "
                      "blocks")
            if peer.used > peer.capacity:
                _fail(f"peer {p}: used {peer.used} over capacity")

    # -- 4. replica index bidirectionality ------------------------------------

    def _check_replica_index(self):
        s = self.store
        n_flagged = sum(int(np.count_nonzero(col)) for col in s._blk_replica)
        if n_flagged != len(s._replica_of):
            _fail(f"{n_flagged} replica flags set but {len(s._replica_of)} "
                  "reverse-index entries")
        for rep, prim in s._replica_of.items():
            rp, rs = rep
            if not s._blk_replica[rp][rs]:
                _fail(f"replica block {rep} missing its dense flag")
            if rep not in s.blocks:
                _fail(f"replica block {rep} not allocated")
            if rep not in tuple(s.block_replicas.get(prim, ())):
                _fail(f"replica {rep} not in primary {prim}'s replica list")
        for prim, reps in s.block_replicas.items():
            if prim not in s.blocks:
                _fail(f"primary {prim} has replicas but is not allocated")
            for rep in reps:
                if s._replica_of.get(tuple(rep)) != prim:
                    _fail(f"replica list of {prim} names {tuple(rep)} whose "
                          "reverse index disagrees")

    # -- 5b. GPT -> block containment -----------------------------------------

    def _check_gpt_block_containment(self):
        s = self.store
        gpt = s.gpt
        from repro_torch.core.page_table import Tier
        peer_t = int(Tier.PEER)
        pgs = np.flatnonzero(gpt._r_tier == peer_t)
        for pg in pgs.tolist():
            loc = gpt.remote_location(pg)
            if loc is None:
                continue
            key = (loc.peer, loc.slot)
            members = s.blocks.get(key)
            if members is None:
                _fail(f"page {pg} maps PEER block {key} which is freed")
            elif pg not in members:
                _fail(f"page {pg} maps PEER block {key} but is not in its "
                      "page list")

    # -- 5c. host tier dict / dense mirror ------------------------------------

    def _check_host_tier(self):
        s = self.store
        dense = set(np.flatnonzero(s._host_mask).tolist())
        keys = set(s.host_pages.keys())
        if dense != keys:
            _fail("host_pages dict and dense mask diverge: "
                  f"{sorted(dense ^ keys)[:8]}")

    # -- 6. peer health / fault handling (§5.1, Table 3) ----------------------

    def _check_peer_health(self):
        """A DOWN peer holds nothing: no mapped page, no live MR block,
        no replica tuple on a survivor still naming it — and the dense
        failure cache agrees with the per-peer flags."""
        s = self.store
        gpt = s.gpt
        from repro_torch.core.page_table import Tier
        peer_t = int(Tier.PEER)
        for p, peer in enumerate(s.peers):
            if bool(s._peer_failed[p]) != peer.failed:
                _fail(f"peer {p}: _peer_failed cache "
                      f"{bool(s._peer_failed[p])} != PeerState.failed "
                      f"{peer.failed}")
            if not peer.failed:
                continue
            mapped = (gpt._r_tier == peer_t) & (gpt._r_peer == p) \
                & gpt._r_mapped
            if np.any(mapped):
                pg = int(np.argmax(mapped))
                _fail(f"page {pg} still mapped on DOWN peer {p}")
            hi = s._next_block_slot[p]
            if np.any(s._blk_live[p][:hi]):
                sl = int(np.argmax(s._blk_live[p][:hi]))
                _fail(f"DOWN peer {p} still holds live block slot {sl}")
            if peer.used != 0:
                _fail(f"DOWN peer {p} reports used={peer.used}")
        failed = {p for p, peer in enumerate(s.peers) if peer.failed}
        if failed:
            for pg, reps in gpt._replicas.items():
                for r in reps:
                    if r[0] in failed:
                        _fail(f"page {pg} keeps stale replica {tuple(r)} "
                              f"on DOWN peer {r[0]}")
            for rep in s._replica_of:
                if rep[0] in failed:
                    _fail(f"replica block {rep} lives on DOWN peer "
                          f"{rep[0]}")

    # -- 6b. failure-domain disjointness (cluster-scale placement) ------------

    def _check_domain_disjointness(self):
        """With failure domains configured (``peer_profiles``), every
        replica of every block lives in a domain distinct from its
        primary's and from every sibling replica's — the law that makes a
        correlated rack failure survivable.  Unconditional because the
        placer has no same-domain fallback (a short replica set goes to
        the repair queue instead).  No-op on flat peer sets."""
        s = self.store
        doms = getattr(s, "_peer_domain", None)
        if doms is None:
            return
        for prim, reps in s.block_replicas.items():
            seen = {doms[prim[0]]}
            for r in reps:
                d = doms[r[0]]
                if d in seen:
                    _fail(f"block {prim} (domain {doms[prim[0]]}) has "
                          f"replica {tuple(r)} in an already-occupied "
                          f"failure domain {d}")
                seen.add(d)

    # -- 7. repair quiesced => replication restored (opt-in barrier) ----------

    def check_replication_restored(self, factor: int = None):
        """After ``repair_quiesce`` the store must be back at full
        durability: an empty repair queue and every live primary block
        that still backs mapped pages carrying >= ``factor`` replicas
        (default ``policy.replication``).  Not part of ``check()`` — mid-
        trace a degraded block is legal; this is the recovery benchmark's
        end-of-phase assertion."""
        self.n_checks += 1
        s = self.store
        R = s.policy.replication if factor is None else int(factor)
        if R <= 0:
            return
        if len(s.repairq):
            _fail(f"repair queue still holds {len(s.repairq)} degraded "
                  "blocks after quiesce")
        gpt = s.gpt
        from repro_torch.core.page_table import Tier
        peer_t = int(Tier.PEER)
        referenced = set()
        for pg in np.flatnonzero((gpt._r_tier == peer_t)
                                 & gpt._r_mapped).tolist():
            loc = gpt.remote_location(pg)
            if loc is not None:
                referenced.add((loc.peer, loc.slot))
        for key in referenced:
            if key in s._replica_of:
                continue               # replicas are counted via the primary
            have = len(tuple(s.block_replicas.get(key, ())))
            if have < R:
                _fail(f"block {key} still degraded after quiesce: "
                      f"{have}/{R} replicas")


# -- statistical equivalence ---------------------------------------------------

def stats_close(sync_stats, async_stats, *, rtol: float = 0.15,
                atol: int = 64) -> bool:
    """Do two runs of the same trace tell the same workload story?

    Bitwise time/stall comparisons are meaningless across orchestration
    modes; what must agree are the workload-visible counters.  Each counter
    pair must satisfy ``|a - b| <= atol + rtol * max(a, b)`` — ``atol``
    absorbs small-count jitter (a handful of extra evictions), ``rtol``
    bounds the drift on large counters (hit counts in the millions).
    """
    fields = ("ops", "writes", "local_hits", "remote_hits", "host_hits",
              "cold_hits", "evictions", "migrations")
    for f in fields:
        a = getattr(sync_stats, f)
        b = getattr(async_stats, f)
        if abs(a - b) > atol + rtol * max(a, b):
            return False
    return True


def stats_delta(sync_stats, async_stats) -> dict:
    """The per-counter deltas behind a ``stats_close`` verdict (debugging)."""
    fields = ("ops", "writes", "local_hits", "remote_hits", "host_hits",
              "cold_hits", "evictions", "migrations")
    return {f: (getattr(sync_stats, f), getattr(async_stats, f))
            for f in fields}
