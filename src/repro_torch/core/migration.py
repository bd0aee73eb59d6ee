"""Sender-driven migration protocol (paper §3.5, Figure 14).

When a remote peer is memory-pressured it must reclaim MR blocks.  Valet
*migrates* the victim block to a less-pressured peer instead of deleting it:

  1. peer's activity monitor reports pressure to the sender
  2. sender selects the victim (least-active block, ``activity.py``) and the
     destination (power-of-two-choices over peer free memory)
  3. sender parks new writes to the migrating block in its local mempool
     staging queue (reads continue against the source block)
  4. source copies the block to the destination (data plane)
  5. sender cuts the page table over, unparks writes, frees the source block

The sender owns the whole control flow (receivers are passive), so messages
are naturally serialized and no extra ordering protocol is needed.  The
explicit message log makes the protocol unit-testable and mirrors Figure 14.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence

import numpy as np

from repro_torch.core.activity import ActivityTracker, power_of_two_choices, \
    select_victims_nad, select_victims_topk
from repro_torch.core.page_table import GlobalPageTable, Location, Tier


class Phase(enum.Enum):
    IDLE = 0
    PREPARE = 1       # destination chosen, writes being parked
    COPYING = 2       # data plane copy in flight; reads served from source
    CUTOVER = 3       # page table repoint + unpark writes
    DONE = 4
    ABORTED = 5


@dataclass
class Message:
    """One protocol message (for the log / tests)."""
    src: str
    dst: str
    kind: str
    payload: dict = field(default_factory=dict)


@dataclass
class Migration:
    block: int                    # victim block id (pool slot on source peer)
    pages: List[int]              # logical pages in the block
    src_peer: int
    dst_peer: int
    dst_slot: int = -1
    phase: Phase = Phase.IDLE
    log: List[Message] = field(default_factory=list)


class MigrationEngine:
    """Drives migrations; the caller supplies data/metadata callbacks.

    copy_fn(src_peer, src_slot, dst_peer, dst_slot): data-plane block copy
    alloc_fn(peer) -> slot | None: allocate an MR slot on a peer
    free_fn(peer, slot): release an MR slot
    park_fn(pages, hold: bool): park/unpark writes (staging queue hold)
    """

    def __init__(self, gpt: GlobalPageTable, tracker: ActivityTracker,
                 free_counts_fn: Callable[[], Sequence[int]],
                 copy_fn, alloc_fn, free_fn, park_fn,
                 rng: Optional[np.random.Generator] = None):
        self.gpt = gpt
        self.tracker = tracker
        self.free_counts_fn = free_counts_fn
        self.copy_fn = copy_fn
        self.alloc_fn = alloc_fn
        self.free_fn = free_fn
        self.park_fn = park_fn
        self.rng = rng or np.random.default_rng(0)
        self.completed: List[Migration] = []
        self.aborted: List[Migration] = []
        # failure-domain awareness (core/cluster.py): ``domains`` maps peer
        # -> failure-domain id and ``replica_peers_fn(block) -> peers``
        # reports where a block's replicas live.  When both are set, a
        # migration never lands a primary in a domain already holding one
        # of its replicas (the correlated-rack-failure guarantee survives
        # migration).  Left at None, destination choice is untouched —
        # bitwise identical draws.
        self.domains: Optional[Sequence[int]] = None
        self.replica_peers_fn: Optional[Callable[[int], Sequence[int]]] = None
        # counters
        self.n_migrated_blocks = 0
        self.n_migrated_pages = 0
        # optional accounting hook, called once per completed block copy
        # with the page count — the async orchestrator charges the copy to
        # its daemon clock (block transfers overlap the critical path)
        self.on_block_copied: Optional[Callable[[int], None]] = None

    # -- entry point: a peer signals memory pressure --------------------------

    def handle_pressure(self, src_peer: int, blocks_to_free: int,
                        block_pages: Callable[[int], List[int]],
                        candidate_blocks: Sequence[int], step: int,
                        batched: bool = False) -> List[Migration]:
        """Select least-active victims on ``src_peer`` and migrate them.

        ``batched=True`` takes the vectorized path: one dense top-k over the
        ``ActivityTracker`` arrays picks all victims in one shot and
        ``migrate_batch`` repoints every affected page with a single
        ``GlobalPageTable`` scatter.  The result (page table, peer state,
        counters, victim order) is identical to the scalar loop."""
        if batched:
            victims = select_victims_topk(self.tracker, candidate_blocks,
                                          blocks_to_free, step)
            return self.migrate_batch(src_peer, victims, block_pages)
        victims = select_victims_nad(self.tracker, candidate_blocks,
                                     blocks_to_free, step)
        out = []
        for blk in victims:
            mig = self.migrate_block(src_peer, blk, block_pages(blk))
            out.append(mig)
        return out

    # -- destination selection --------------------------------------------------

    def _choose_destination(self, src_peer: int, free: Sequence[int],
                            avoid_domains: Sequence[int] = ()
                            ) -> Optional[int]:
        """p2c over free counts; if both sampled peers are pressured, fall
        back to a full scan (freest peer wins, lowest id breaks ties) before
        giving up — repeated pressure no longer aborts into eviction while a
        free peer exists.  ``avoid_domains`` (failure-domain ids) strikes
        whole racks from both the p2c draw and the fallback scan."""
        exclude = [src_peer]
        if avoid_domains and self.domains is not None:
            bad = set(avoid_domains)
            exclude += [p for p, d in enumerate(self.domains)
                        if d in bad and p != src_peer]
        dst = power_of_two_choices(free, self.rng, exclude=exclude)
        if dst is not None and free[dst] > 0:
            return dst
        barred = set(exclude)
        best, best_free = None, 0
        for i, f in enumerate(free):
            if i not in barred and f > best_free:
                best, best_free = i, f
        return best

    def _avoid_domains_for(self, block: int, pages: Sequence[int]
                           ) -> Sequence[int]:
        """Failure domains holding a replica of this block's pages — the
        migrated primary must not join them.  Empty when domain awareness
        is off."""
        if self.domains is None or self.replica_peers_fn is None:
            return ()
        return sorted({self.domains[p]
                       for p in self.replica_peers_fn(block)
                       if 0 <= p < len(self.domains)})

    # -- one block migration ---------------------------------------------------

    def migrate_block(self, src_peer: int, block: int,
                      pages: List[int]) -> Migration:
        mig = Migration(block=block, pages=list(pages), src_peer=src_peer,
                        dst_peer=-1)

        # 2. destination: power-of-two-choices over free counts, != source
        # (and, with domain awareness, != any rack holding a replica)
        free = list(self.free_counts_fn())
        dst = self._choose_destination(src_peer, free,
                                       self._avoid_domains_for(block, pages))
        if dst is None:
            mig.phase = Phase.ABORTED
            mig.log.append(Message("sender", "sender", "NO_DESTINATION"))
            self.aborted.append(mig)
            return mig
        mig.dst_peer = dst
        mig.log.append(Message("sender", f"peer{dst}", "ALLOC_REQ",
                               {"block": block}))
        slot = self.alloc_fn(dst)
        if slot is None:
            mig.phase = Phase.ABORTED
            mig.log.append(Message(f"peer{dst}", "sender", "ALLOC_FAIL"))
            self.aborted.append(mig)
            return mig
        mig.dst_slot = slot
        mig.log.append(Message(f"peer{dst}", "sender", "ALLOC_OK",
                               {"slot": slot}))

        # 3. park writes; reads keep hitting the source block (Figure 12)
        mig.phase = Phase.PREPARE
        self.park_fn(mig.pages, True)
        mig.log.append(Message("sender", "sender", "PARK_WRITES",
                               {"pages": len(mig.pages)}))

        # 4. data-plane copy (source -> destination, sender-coordinated)
        mig.phase = Phase.COPYING
        mig.log.append(Message("sender", f"peer{src_peer}", "COPY_REQ",
                               {"dst": dst, "dst_slot": slot}))
        self.copy_fn(src_peer, block, dst, slot)
        mig.log.append(Message(f"peer{src_peer}", "sender", "COPY_DONE"))

        # 5. cutover: repoint pages, unpark writes, free source block
        mig.phase = Phase.CUTOVER
        for pg in mig.pages:
            loc = self.gpt.remote_location(pg)
            reps = loc.replicas if loc else ()
            self.gpt.map_remote(pg, Location(Tier.PEER, peer=dst, slot=slot,
                                             replicas=reps))
        self.park_fn(mig.pages, False)
        self.free_fn(src_peer, block)
        mig.log.append(Message("sender", f"peer{src_peer}", "FREE_BLOCK",
                               {"block": block}))

        mig.phase = Phase.DONE
        self.completed.append(mig)
        self.n_migrated_blocks += 1
        self.n_migrated_pages += len(mig.pages)
        if self.on_block_copied is not None:
            self.on_block_copied(len(mig.pages))
        return mig

    # -- batched migration (vectorized reclaim pipeline) ------------------------

    def migrate_batch(self, src_peer: int, blocks: Sequence[int],
                      block_pages: Callable[[int], List[int]]
                      ) -> List[Migration]:
        """Migrate several victim blocks with ONE page-table scatter.

        Per victim, the control decisions stay sequential and identical to
        ``migrate_block`` — destination choice consumes the same rng stream
        against the same free counts (each victim's alloc/free lands before
        the next victim's p2c draw) — but the per-page work is hoisted out:
        writes are parked/unparked with two staging-queue scans instead of
        two per block, and every affected page is repointed by a single
        ``map_remote_batch`` scatter (victim order preserved, so duplicate
        pages keep last-writer-wins parity with the scalar loop).  The
        Figure-14 protocol message log is elided on this path (the scalar
        reference keeps it); abort reasons are still logged."""
        infos = [(blk, list(block_pages(blk))) for blk in blocks]
        all_pages = [pg for _, pgs in infos for pg in pgs]
        # 3. park once for the whole batch; reads keep hitting the sources
        self.park_fn(all_pages, True)

        migs: List[Migration] = []
        done: List[Migration] = []
        # free counts tracked incrementally: each dst alloc is -1, each src
        # free is +1 — exactly the transitions ``free_counts_fn`` would
        # report between victims (the src entry may drift for a failed src,
        # but the source is never a destination candidate)
        free = list(self.free_counts_fn())
        for blk, pages in infos:
            mig = Migration(block=blk, pages=pages, src_peer=src_peer,
                            dst_peer=-1)
            migs.append(mig)
            dst = self._choose_destination(src_peer, free,
                                           self._avoid_domains_for(blk,
                                                                   pages))
            if dst is None:
                mig.phase = Phase.ABORTED
                mig.log.append(Message("sender", "sender", "NO_DESTINATION"))
                self.aborted.append(mig)
                continue
            mig.dst_peer = dst
            slot = self.alloc_fn(dst)
            if slot is None:
                mig.phase = Phase.ABORTED
                mig.log.append(Message(f"peer{dst}", "sender", "ALLOC_FAIL"))
                self.aborted.append(mig)
                continue
            mig.dst_slot = slot
            free[dst] -= 1
            # 4. data-plane copy; source freed before the next victim's p2c
            # so destination choices see the same free counts as the scalar
            # loop (which completes each migration before starting the next)
            mig.phase = Phase.COPYING
            self.copy_fn(src_peer, blk, dst, slot)
            self.free_fn(src_peer, blk)
            free[src_peer] += 1
            done.append(mig)

        # 5. cutover: ONE scatter repoints every migrated page (replicas are
        # preserved, fetched in bulk), then unpark with one scan
        if done:
            mv_pages = [pg for mig in done for pg in mig.pages]
            mv_peers = [mig.dst_peer for mig in done for _ in mig.pages]
            mv_slots = [mig.dst_slot for mig in done for _ in mig.pages]
            reps = self.gpt.replicas_batch(mv_pages)
            self.gpt.map_remote_batch(
                mv_pages, [int(Tier.PEER)] * len(mv_pages), mv_peers,
                mv_slots, reps)
        self.park_fn(all_pages, False)
        for mig in done:
            mig.phase = Phase.DONE
            self.completed.append(mig)
            self.n_migrated_blocks += 1
            self.n_migrated_pages += len(mig.pages)
            if self.on_block_copied is not None:
                self.on_block_copied(len(mig.pages))
        return migs
