"""Staging / Reclaimable queues with Update flags (paper §4.1, §5.2).

One ``WriteSet`` is the paper's 24-byte ``tree_entry``: the pages of a single
write transaction.  The pipeline is:

  write completes into local pool  ->  entry enqueued on StagingQueue
  remote send (async, coalesced)   ->  entry moves to ReclaimableQueue
  reclaim                           ->  slots returned to the pool

§5.2 consistency: when two write-sets update the same page, the older one's
slot must NOT be reclaimed before the newer one is sent (its pool slot holds
the only up-to-date copy).  The ``update_flag`` on the slot implements the
skip; both orderings (distance larger/smaller than queue size) are safe.

Both queues are **structure-of-arrays**: flattened parallel row columns
(page, slot, seq/hold, entry-start flag) in sliding buffers whose live
window ``[head, tail)`` is always contiguous, so a whole flush batch or
reclaim burst is one slice gather and the §5.2 bookkeeping becomes masked
scatters (``reclaim_bulk``, ``complete_flush_rows``, ``stage_rows``).
``WriteSet`` objects are materialized only on the scalar reference paths
and for tests; multi-page write-sets (the generic ``write()`` API — the
tiered store always stages single pages) flatten into consecutive rows and
keep the exact entry-atomic pop semantics via the entry-start flags.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.pool import SlotState, ValetMempool

_FREE = int(SlotState.FREE)
_IN_USE = int(SlotState.IN_USE)
_RECLAIMABLE = int(SlotState.RECLAIMABLE)

_EMPTY = np.empty(0, np.int64)


def _has_dup_values(arr: np.ndarray, n: int) -> bool:
    """True when ``arr`` (length ``n`` > 1) repeats a value — a Python set
    probe below 64 elements (cheaper than numpy dispatch there), one sort
    compare above.  Shared by every §5.2 path that must route duplicate
    pages through chain-aware handling."""
    if n <= 64:
        return len(set(arr.tolist())) != n
    srt = np.sort(arr)
    return bool(np.count_nonzero(srt[1:] == srt[:-1]))


@dataclass(slots=True)
class WriteSet:
    """One write transaction: logical pages + their pool slots."""
    seq: int
    pages: Tuple[int, ...]
    slots: Tuple[int, ...]
    migrating_hold: bool = False   # parked while its target block migrates


class _RowQueue:
    """Shared sliding-buffer machinery for the two SoA queues.

    ``_cols`` names the int64 row columns; bool columns are listed in
    ``_flags``.  The live rows sit in ``[head, tail)`` of every column;
    pops advance ``head``, pushes advance ``tail``, and when the tail hits
    the buffer end the window is compacted to the front (amortized O(1),
    and slices over the live window stay contiguous — the property the
    vectorized paths rely on)."""

    _cols: Tuple[str, ...] = ()
    _flags: Tuple[str, ...] = ()

    def _init_rows(self, cap: int = 1024):
        for name in self._cols:
            setattr(self, name, np.empty(cap, np.int64))
        for name in self._flags:
            setattr(self, name, np.zeros(cap, bool))
        self._head = 0
        self._tail = 0
        self._n_entries = 0
        self._n_multi = 0          # multi-page entries currently queued
        # lazy flag columns: while every row ever pushed was a single-page
        # entry (no multi rows yet), ``_first`` is not maintained — readers
        # only consult it when ``_n_multi > 0``.  The first multi-page push
        # normalizes the live window.  Subclasses track their own laziness
        # for extra flag columns (the staging hold column).
        self._first_lazy = True

    def __len__(self):
        return self._n_entries

    def _room_for(self, k: int):
        first = getattr(self, self._cols[0])
        cap = first.shape[0]
        if self._tail + k <= cap:
            return
        n = self._tail - self._head
        new_cap = cap
        while n + k > new_cap:
            new_cap *= 2
        for name in self._cols + self._flags:
            arr = getattr(self, name)
            if new_cap != cap:
                # flag columns grow ZEROED: the lazy-flag convention means
                # rows pushed later may never write their flag bit, and the
                # readers rely on unwritten positions being False
                out = np.zeros(new_cap, arr.dtype) if arr.dtype == bool \
                    else np.empty(new_cap, arr.dtype)
                out[:n] = arr[self._head:self._tail]
                setattr(self, name, out)
            else:
                arr[:n] = arr[self._head:self._tail].copy()
        self._head = 0
        self._tail = n

    def _entry_end(self, h: int) -> int:
        """Row index one past the entry starting at row ``h``."""
        if not self._n_multi:
            return h + 1
        first = self._first
        t = self._tail
        h2 = h + 1
        while h2 < t and not first[h2]:
            h2 += 1
        return h2


class StagingQueue(_RowQueue):
    """Writes accepted locally but not yet replicated to a remote peer.

    Writing (paging-out) is serialized (paper §3.1 Reliability): entries
    leave in FIFO order, via ``take_batch`` (message coalescing + batch send).
    """

    _cols = ("_seq", "_page", "_slot")
    _flags = ("_hold", "_first")

    def __init__(self, max_entries: int):
        self.max_entries = max_entries
        self._init_rows()
        self._n_held = 0               # entries currently parked (migration)
        # while True, every live/reusable row position holds False — pushes
        # skip the hold-column write (holds are rare migration events)
        self._hold_clean = True

    def full(self) -> bool:
        return self._n_entries >= self.max_entries

    def room(self) -> int:
        """Free staging entries — the batch engine's overrun bound."""
        return self.max_entries - self._n_entries

    def push(self, ws: WriteSet) -> bool:
        if self.full():
            return False
        k = len(ws.pages)
        if k > 1 and self._first_lazy:
            # first multi-page entry ever: backfill the live window (every
            # prior row is a single-page entry start)
            self._first[self._head:self._tail] = True
            self._first_lazy = False
        if ws.migrating_hold and self._hold_clean:
            self._hold_clean = False   # zeros until now — stays consistent
        self._room_for(k)
        t = self._tail
        if k == 1:
            self._seq[t] = ws.seq
            self._page[t] = ws.pages[0]
            self._slot[t] = ws.slots[0]
            if not self._hold_clean:
                self._hold[t] = ws.migrating_hold
            if not self._first_lazy:
                self._first[t] = True
        else:
            e = t + k
            self._seq[t:e] = ws.seq
            self._page[t:e] = ws.pages
            self._slot[t:e] = ws.slots
            if not self._hold_clean:
                self._hold[t:e] = ws.migrating_hold
            self._first[t:e] = False
            self._first[t] = True
            self._n_multi += 1
        self._tail = t + k
        self._n_entries += 1
        if ws.migrating_hold:
            self._n_held += 1
        return True

    def push_row(self, seq: int, page: int, slot: int):
        """Scalar single-page push (the fused tiny-segment replay — the
        caller's segment bound already guaranteed staging room, so the
        ``full()`` check is skipped like the pre-checked bulk pushes)."""
        self._room_for(1)
        t = self._tail
        self._seq[t] = seq
        self._page[t] = page
        self._slot[t] = slot
        if not self._hold_clean:
            self._hold[t] = False
        if not self._first_lazy:
            self._first[t] = True
        self._tail = t + 1
        self._n_entries += 1

    def push_rows(self, seqs, pages, slots):
        """Bulk push of single-page write-sets: one block write per column
        (the ``stage_rows`` fast path)."""
        k = len(pages)
        if not k:
            return
        self._room_for(k)
        t = self._tail
        e = t + k
        self._seq[t:e] = seqs
        self._page[t:e] = pages
        self._slot[t:e] = slots
        if not self._hold_clean:
            self._hold[t:e] = False
        if not self._first_lazy:
            self._first[t:e] = True
        self._tail = e
        self._n_entries += k

    def _rows_to_ws(self, h: int, e: int) -> List[WriteSet]:
        """Materialize rows ``[h, e)`` as WriteSet objects (entry-grouped)."""
        if e <= h:
            return []
        seqs = self._seq[h:e].tolist()
        pages = self._page[h:e].tolist()
        slots = self._slot[h:e].tolist()
        holds = self._hold[h:e].tolist()
        if not self._n_multi:
            return [WriteSet(s, (p,), (sl,), hd)
                    for s, p, sl, hd in zip(seqs, pages, slots, holds)]
        firsts = self._first[h:e].tolist()
        out: List[WriteSet] = []
        i = 0
        n = e - h
        while i < n:
            j = i + 1
            while j < n and not firsts[j]:
                j += 1
            out.append(WriteSet(seqs[i], tuple(pages[i:j]),
                                tuple(slots[i:j]), holds[i]))
            i = j
        return out

    def peek(self) -> Optional[WriteSet]:
        if not self._n_entries:
            return None
        return self._rows_to_ws(self._head,
                                self._entry_end(self._head))[0]

    def _rebuild(self, entries: List[WriteSet]):
        """Rewrite the whole buffer from an entry list (cold requeue paths:
        held-entry skips and entry-granular hold flips)."""
        self._init_rows(max(getattr(self, self._cols[0]).shape[0], 1024))
        self._n_held = 0
        self._hold_clean = True            # flag columns re-zeroed
        for ws in entries:                 # push re-counts every counter
            self.push(ws)

    def take_batch(self, n: int, skip_held: bool = True) -> List[WriteSet]:
        """Dequeue up to n sendable entries (held entries stay, FIFO kept).

        With no held entries (the common case — migrations are rare events)
        the whole batch pops as one slice."""
        if self._n_held and skip_held:
            ents = self._rows_to_ws(self._head, self._tail)
            out: List[WriteSet] = []
            keep: List[WriteSet] = []
            for i, ws in enumerate(ents):
                if len(out) >= n:
                    keep.extend(ents[i:])
                    break
                if ws.migrating_hold:
                    keep.append(ws)
                else:
                    out.append(ws)
            self._rebuild(keep)
            return out
        take = min(n, self._n_entries)
        if take == 0:
            return []
        h = self._head
        if not self._n_multi:
            e = h + take
        else:
            e = h
            for _ in range(take):
                e = self._entry_end(e)
        out = self._rows_to_ws(h, e)
        self._head = e
        self._n_entries -= take
        if self._n_held:               # skip_held=False popped held ones
            self._n_held -= sum(1 for ws in out if ws.migrating_hold)
        if self._n_multi:
            self._n_multi -= sum(1 for ws in out if len(ws.pages) > 1)
        return out

    def take_arrays(self, n: int
                    ) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Pop up to ``n`` sendable entries as ``(seqs, pages, slots)``
        arrays — the batched flush's zero-object path.  Returns None when
        held or multi-page entries need the WriteSet walk."""
        if self._n_held or self._n_multi:
            return None
        take = min(n, self._n_entries)
        h = self._head
        e = h + take
        self._head = e
        self._n_entries -= take
        # copies: the buffer may compact under later pushes
        return (self._seq[h:e].copy(), self._page[h:e].copy(),
                self._slot[h:e].copy())

    def hold_pages(self, pages, hold: bool):
        """Park/unpark write-sets touching ``pages`` (migration §3.5)."""
        if self._n_multi:
            pset = set(pages)
            ents = self._rows_to_ws(self._head, self._tail)
            held = self._n_held
            for ws in ents:
                if ws.migrating_hold != hold and pset.intersection(ws.pages):
                    ws.migrating_hold = hold
                    held += 1 if hold else -1
            self._rebuild(ents)
            self._n_held = held
            return
        h, t = self._head, self._tail
        if h == t:
            return
        parr = np.asarray(list(pages) if not isinstance(pages, np.ndarray)
                          else pages, np.int64)
        win = self._hold[h:t]
        m = np.isin(self._page[h:t], parr) & (win != hold)
        cnt = int(np.count_nonzero(m))
        if cnt:
            win[m] = hold
            self._n_held += cnt if hold else -cnt
            self._hold_clean = False       # pushes must maintain the column

    def entries(self) -> List[WriteSet]:
        return self._rows_to_ws(self._head, self._tail)


class ReclaimableQueue(_RowQueue):
    """Write-sets whose remote replica exists; slots are reclaim candidates."""

    _cols = ("_page", "_slot")
    _flags = ("_first",)

    def __init__(self, max_entries: int):
        self.max_entries = max_entries
        self._init_rows()
        # > 0 while two live rows could share one (slot, page) pair — only
        # §5.2 deferred re-queues and out-of-queue-order reclaims
        # (``host_donate``'s shrink window) create such twins.  While 0,
        # ``reclaim_bulk`` skips its first-occurrence dedup pass; draining
        # the queue clears the risk.
        self._dup_risk = 0

    def push(self, ws: WriteSet):
        # arbitrary WriteSet pushes may duplicate a live row's (slot, page)
        # pair (re-queues, external callers): keep the bulk dedup armed
        self._dup_risk += 1
        k = len(ws.pages)
        if k > 1 and self._first_lazy:
            self._first[self._head:self._tail] = True
            self._first_lazy = False
        self._room_for(k)
        t = self._tail
        if k == 1:
            self._page[t] = ws.pages[0]
            self._slot[t] = ws.slots[0]
            if not self._first_lazy:
                self._first[t] = True
        else:
            e = t + k
            self._page[t:e] = ws.pages
            self._slot[t:e] = ws.slots
            self._first[t:e] = False
            self._first[t] = True
            self._n_multi += 1
        self._tail = t + k
        self._n_entries += 1

    def push_row(self, page: int, slot: int):
        """Scalar single-page push (the boundary fill hot path — no
        WriteSet object)."""
        self._room_for(1)
        t = self._tail
        self._page[t] = page
        self._slot[t] = slot
        if not self._first_lazy:
            self._first[t] = True
        self._tail = t + 1
        self._n_entries += 1

    def push_row_deferred(self, page: int, slot: int):
        """Re-queue a §5.2 deferred release: its original write-set row may
        still be live, so the (slot, page) pair can now appear twice."""
        self._dup_risk += 1
        self.push_row(page, slot)

    def push_rows(self, pages, slots):
        """Bulk push of single-page entries: one block write per column."""
        k = len(pages)
        if not k:
            return
        self._room_for(k)
        t = self._tail
        e = t + k
        self._page[t:e] = pages
        self._slot[t:e] = slots
        if not self._first_lazy:
            self._first[t:e] = True
        self._tail = e
        self._n_entries += k

    def reclaim_up_to(self, n_slots: int, pool: ValetMempool
                      ) -> List[Tuple[int, int]]:
        """Reclaim oldest entries' slots (LRU over write order) — the scalar
        reference: entries pop atomically while fewer than ``n_slots`` slots
        are freed, and slots whose page has a pending newer update
        (``update_flag``) were kept IN_USE by ``mark_reclaimable`` per §5.2,
        so the (slot, page) match guard skips their stale entries.
        Returns [(slot, logical_page)] actually freed."""
        freed: List[Tuple[int, int]] = []
        state = pool.state
        owner = pool.owner
        while self._n_entries and len(freed) < n_slots:
            h = self._head
            h2 = self._entry_end(h)
            for r in range(h, h2):
                slot = int(self._slot[r])
                pg = int(self._page[r])
                if state[slot] == _RECLAIMABLE and owner[slot] == pg:
                    pool.reclaim(slot)
                    freed.append((slot, pg))
            self._head = h2
            self._n_entries -= 1
            if h2 - h > 1:
                self._n_multi -= 1
        if not self._n_entries:
            self._dup_risk = 0         # no live rows, no possible twins
        return freed

    def reclaim_bulk(self, n_slots: int, pool: ValetMempool
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """``reclaim_up_to`` as masked gathers/scatters — identical state
        changes, pop/append order and counters, no per-entry Python.

        Chunks of queued rows are classified in one shot against the pool's
        SoA columns ((slot, page) match guard as a vector compare); the
        matched prefix that reaches ``n_slots`` frees with one scatter per
        metadata column and one block append to the free stack.  A slot
        queued twice in one chunk (a §5.2 deferred re-queue next to its
        original entry) frees only at its first occurrence — later rows see
        it FREE exactly as the sequential pop would.  Returns the freed
        ``(slots, pages)`` arrays in pop order."""
        if self._n_multi:
            freed = self.reclaim_up_to(n_slots, pool)
            k = len(freed)
            sl = np.fromiter((s for s, _ in freed), np.int64, k)
            pg = np.fromiter((p for _, p in freed), np.int64, k)
            return sl, pg
        state = pool.state
        owner = pool.owner
        out_s: List[np.ndarray] = []
        out_p: List[np.ndarray] = []
        need = n_slots
        while self._n_entries and need > 0:
            h = self._head
            # generous chunks: under pressure most queued rows are stale
            # (rewritten/refilled pages), and gathering 512 rows costs
            # barely more than 64 — one pass usually reaches the target
            chunk = min(self._n_entries, max(8 * need, 512))
            sl = self._slot[h:h + chunk]
            pg = self._page[h:h + chunk]
            match = (state[sl] == _RECLAIMABLE) & (owner[sl] == pg)
            mi = np.flatnonzero(match)
            if mi.size > 1 and self._dup_risk:
                msl = sl[mi]
                srt = np.sort(msl)
                if np.count_nonzero(srt[1:] == srt[:-1]):
                    # a §5.2 deferred re-queue alongside its original entry:
                    # the slot frees only at its first occurrence (later
                    # rows see it FREE, as the sequential pop would)
                    ao = np.argsort(msl, kind="stable")
                    ss = msl[ao]
                    later = np.zeros(msl.size, bool)
                    later[ao[1:][ss[1:] == ss[:-1]]] = True
                    mi = mi[~later]
                    msl = sl[mi]
            else:
                msl = sl[mi]
            if mi.size >= need:
                cut = int(mi[need - 1]) + 1
                mi = mi[:need]
                msl = msl[:need]
            else:
                cut = chunk
            if mi.size:
                mpg = pg[mi]
                state[msl] = _FREE        # RECLAIMABLE ⇒ update_flag clear
                owner[msl] = -1
                pool.reclaim_flag[msl] = False
                if pool.size == pool.capacity:
                    pool._used -= int(msl.size)
                else:
                    pool._used -= int(np.count_nonzero(msl < pool.size))
                top = pool._free_top
                pool._free_arr[top:top + msl.size] = msl
                pool._free_top = top + msl.size
                pool.n_reclaimed += int(msl.size)
                out_s.append(msl)
                out_p.append(mpg)
                need -= msl.size
            self._head = h + cut
            self._n_entries -= cut
        if not self._n_entries:
            self._dup_risk = 0         # no live rows, no possible twins
        if not out_s:
            return _EMPTY, _EMPTY
        if len(out_s) == 1:
            return out_s[0], out_p[0]
        return np.concatenate(out_s), np.concatenate(out_p)

    def entries(self) -> List[WriteSet]:
        out: List[WriteSet] = []
        h = self._head
        while h < self._tail:
            h2 = self._entry_end(h)
            out.append(WriteSet(-1, tuple(self._page[h:h2].tolist()),
                                tuple(self._slot[h:h2].tolist())))
            h = h2
        return out


class WritePipeline:
    """Pool + staging + reclaimable wired together (the write critical path).

    ``write()`` is the paper's Figure 7 left side: it completes as soon as
    pages are in the local pool.  ``flush()`` is the asynchronous Remote
    Sender Thread: it coalesces staged entries, "sends" them (caller-supplied
    callback = replication to a peer/host tier), then marks slots
    reclaimable.

    The §5.2 page maps are dense columns indexed by logical page id
    (grow-on-demand, like the GlobalPageTable): ``_pend`` holds each page's
    latest pending slot, ``_defer`` the older slot whose reclaim §5.2
    deferred until the newer write-set for the page is sent (FIFO flush ⇒
    at most one per page).  -1 = absent.
    """

    def __init__(self, pool: ValetMempool, queue_len: int = 4096):
        self.pool = pool
        self.staging = StagingQueue(queue_len)
        self.reclaimable = ReclaimableQueue(queue_len)
        self._seq = 0
        self._pend = np.full(1024, -1, np.int64)
        self._defer = np.full(1024, -1, np.int64)
        self._n_deferred = 0

    def _ensure_page(self, page: int):
        n = self._pend.shape[0]
        if page < n:
            return
        new = max(n * 2, page + 1)
        for name in ("_pend", "_defer"):
            arr = getattr(self, name)
            out = np.full(new, -1, np.int64)
            out[:n] = arr
            setattr(self, name, out)

    @property
    def _pending_slot(self) -> Dict[int, int]:
        """Dict view of the dense pending-slot column (tests/invariants)."""
        idx = np.flatnonzero(self._pend >= 0)
        return {int(p): int(self._pend[p]) for p in idx}

    def write(self, pages: Tuple[int, ...], step: int,
              alloc_fallback=None) -> Optional[WriteSet]:
        """Accept a write transaction into the pool.  Returns the WriteSet
        (write is complete for the caller) or None if allocation failed or
        the staging queue is full — either way with NO residual effects
        (slots released, pending-slot map and §5.2 flags restored), so the
        caller's reclaim/stall retry sequence never strands IN_USE slots."""
        slots: List[int] = []
        prevs: List[Optional[int]] = []
        pool = self.pool
        for pg in pages:
            slot = pool.alloc(pg, step)
            if slot is None and alloc_fallback is not None:
                slot = alloc_fallback(pg, step)
            if slot is None:
                self._rollback(pages, slots, prevs)
                return None
            self._ensure_page(pg)
            pend = self._pend
            prev = int(pend[pg])
            if prev >= 0:
                # §5.2 multiple updates: older slot must not be reclaimed
                # before this newer write-set is sent.
                pool.update_flag[prev] = True
                prevs.append(prev)
            else:
                prevs.append(None)
            pend[pg] = slot
            slots.append(slot)
        ws = WriteSet(self._seq, tuple(pages), tuple(slots))
        if not self.staging.push(ws):
            # staging overrun: the write did NOT happen — undo everything
            # (leaking here would pin the slots IN_USE forever: they are
            # neither staged nor reclaimable)
            self._rollback(pages, slots, prevs)
            return None
        self._seq += 1
        return ws

    def _rollback(self, pages, slots, prevs):
        """Undo a partially accepted write transaction: release the slots
        and restore each page's previous pending slot + its §5.2 flag (the
        latest pending slot is never update-flagged, so clearing is exact).
        """
        pend = self._pend
        pool = self.pool
        # newest-first so duplicate pages in one transaction unwind exactly
        # (zip truncates to the pages actually processed before the failure)
        for pg, slot, prev in reversed(list(zip(pages, slots, prevs))):
            if prev is not None:
                pool.update_flag[prev] = False
                pend[pg] = prev
            else:
                pend[pg] = -1
            pool.release(slot)

    def stage_rows(self, pages, slots) -> bool:
        """Vectorized ``stage_batch`` for single-page write-sets: one block
        row append plus masked scatters of the §5.2 update flags.

        Sequential semantics, exactly: every occurrence of a page flags its
        predecessor's slot — the previous occurrence in this batch, or the
        page's pre-existing pending slot for the first occurrence — and the
        page's pending slot ends on its last occurrence.  One stable
        argsort groups occurrences so within-batch predecessors are the
        sorted neighbors; flags only ever SET (idempotent), so scatter
        order is free.  Fresh alloc slots are disjoint from pending slots
        (those are IN_USE, staged), so no flag lands on a batch slot.

        Requires staging room for the whole batch; returns False without
        side effects otherwise."""
        n = len(pages)
        if self.staging.room() < n:
            return False
        parr = pages if isinstance(pages, np.ndarray) \
            else np.asarray(pages, np.int64)
        sarr = slots if isinstance(slots, np.ndarray) \
            else np.asarray(slots, np.int64)
        if not n:
            return True
        pend = self._pend
        try:
            prev = pend[parr]
        except IndexError:             # first sighting of a high page id
            self._ensure_page(int(parr.max()))
            pend = self._pend
            prev = pend[parr]
        uflag = self.pool.update_flag
        if n > 1 and _has_dup_values(parr, n):
            # duplicate pages: group occurrences with one stable argsort —
            # within-batch predecessors are the sorted neighbors
            order = np.argsort(parr, kind="stable")
            ps = parr[order]
            ss = sarr[order]
            same = ps[1:] == ps[:-1]       # row follows a same-page row
            uflag[ss[:-1][same]] = True
            first = np.empty(n, bool)
            first[0] = True
            np.logical_not(same, out=first[1:])
            fprev = pend[ps[first]]
            uflag[fprev[fprev >= 0]] = True
            last = np.empty(n, bool)
            last[n - 1] = True
            np.logical_not(same, out=last[:n - 1])
            pend[ps[last]] = ss[last]
        else:
            uflag[prev[prev >= 0]] = True
            pend[parr] = sarr
        seq = self._seq
        self.staging.push_rows(np.arange(seq, seq + n, dtype=np.int64),
                               parr, sarr)
        self._seq = seq + n
        return True

    def stage_batch(self, pages, slots) -> Optional[List[WriteSet]]:
        """Stage one single-page WriteSet per (page, slot) pair in bulk.

        Scalar-equivalent to ``write((pg,), ...)`` per page with the pool
        allocation done up front by ``ValetMempool.alloc_batch``: same seq
        numbers, same FIFO staging order, and the same §5.2 update-flag
        maintenance for duplicate pages (the older pending slot is flagged
        so it is not reclaimed before the newer write-set is sent).

        Requires staging room for the whole batch; returns None without
        side effects otherwise (callers pre-check and fall back to the
        scalar path).
        """
        n = len(pages)
        if self.staging.room() < n:
            return None
        pend = self._pend
        uflag = self.pool.update_flag
        seq = self._seq
        out: List[WriteSet] = []
        for pg, slot in zip(pages, slots):
            pg = int(pg)
            slot = int(slot)
            self._ensure_page(pg)
            pend = self._pend
            prev = int(pend[pg])
            if prev >= 0:
                uflag[prev] = True
            pend[pg] = slot
            ws = WriteSet(seq, (pg,), (slot,))
            seq += 1
            self.staging.push(ws)
            out.append(ws)
        self._seq = seq
        return out

    def staging_room(self) -> int:
        """Writes acceptable before the staging queue overruns — the batch
        engine bounds each bulk segment with this, so the op that would
        stall lands on the inline boundary path instead."""
        return self.staging.room()

    def complete_fill_batch(self, pages, slots):
        """Cache-fill bookkeeping in bulk: each filled slot is clean (a
        remote copy exists), so it is marked reclaimable and queued as its
        own single-page write-set — the exact per-slot transitions of the
        scalar ``_cache_fill`` tail (``mark_reclaimable`` + push) as one
        masked scatter.  Fill slots are fresh allocations (distinct, flags
        just cleared), so the §5.2 deferral branch is kept only for the
        general ``mark_reclaimable`` contract."""
        sarr = slots if isinstance(slots, np.ndarray) \
            else np.asarray(slots, np.int64)
        parr = pages if isinstance(pages, np.ndarray) \
            else np.asarray(pages, np.int64)
        if not sarr.size:
            return
        pool = self.pool
        uf = pool.update_flag[sarr]
        if uf.any():
            pool.update_flag[sarr[uf]] = False     # §5.2 deferral, as
            ok = sarr[~uf]                         # mark_reclaimable
            pool.state[ok] = _RECLAIMABLE
            pool.reclaim_flag[ok] = True
        else:
            pool.state[sarr] = _RECLAIMABLE
            pool.reclaim_flag[sarr] = True
        self.reclaimable.push_rows(parr, sarr)

    def fill_rows(self, pages: np.ndarray, slots: np.ndarray):
        """``complete_fill_batch`` for slots the caller JUST allocated (the
        segment engine's fills): a fresh slot's ``update_flag`` was cleared
        by the alloc, so the §5.2 deferral gather is skipped — two scatters
        and the row append."""
        pool = self.pool
        pool.state[slots] = _RECLAIMABLE
        pool.reclaim_flag[slots] = True
        self.reclaimable.push_rows(pages, slots)

    def flush(self, n: int, send_fn) -> List[WriteSet]:
        """Remote Sender Thread step: coalesce + send + mark reclaimable."""
        batch = self.staging.take_batch(n)
        pool = self.pool
        pend = self._pend
        defer = self._defer
        for ws in batch:
            send_fn(ws)
            for pg, slot in zip(ws.pages, ws.slots):
                if pend[pg] == slot:
                    pend[pg] = -1
                # §5.2 second half: this send supersedes any older slot for
                # the page whose reclaim was deferred — release it now (its
                # original queue entry may already have been popped, so a
                # fresh single-page entry re-queues it)
                if self._n_deferred:
                    d = int(defer[pg])
                    if d >= 0:
                        defer[pg] = -1
                        self._n_deferred -= 1
                        if pool.mark_reclaimable(d):
                            self.reclaimable.push_row_deferred(pg, d)
                if not pool.mark_reclaimable(slot):
                    defer[pg] = slot
                    self._n_deferred += 1
            self.reclaimable.push(ws)
        return batch

    def take_flush_batch(self, n: int) -> List[WriteSet]:
        """Dequeue up to ``n`` sendable write-sets (the batched flush's first
        half; ``complete_flush`` is the second)."""
        return self.staging.take_batch(n)

    def take_flush_rows(self, n: int
                        ) -> Optional[Tuple[np.ndarray, np.ndarray,
                                            np.ndarray]]:
        """Array form of ``take_flush_batch`` (no WriteSet objects) — None
        when held/multi-page entries need the WriteSet walk."""
        return self.staging.take_arrays(n)

    def complete_flush(self, batch: List[WriteSet]):
        """Post-send bookkeeping for a taken flush batch (WriteSet walk).

        Identical state transitions to the per-write-set tail of ``flush``
        (pending-slot retirement, §5.2 deferred-release handling, the
        reclaimable pushes).  The caller performs the "send" (placement)
        itself — placement touches peers/blocks/page-table only, this loop
        touches pool/queues only, so running them back to back instead of
        interleaved per write-set reaches the same state.  The batched
        store flushes through ``complete_flush_rows`` instead; this walk
        remains for multi-page write-sets and held-entry requeues."""
        pend = self._pend
        defer = self._defer
        pool = self.pool
        state = pool.state
        uflag = pool.update_flag
        rflag = pool.reclaim_flag
        push_row_deferred = self.reclaimable.push_row_deferred
        for ws in batch:
            for pg, slot in zip(ws.pages, ws.slots):
                if pend[pg] == slot:
                    pend[pg] = -1
                if self._n_deferred:
                    d = int(defer[pg])
                    if d >= 0:
                        defer[pg] = -1
                        self._n_deferred -= 1
                        if uflag[d]:
                            uflag[d] = False
                        else:
                            state[d] = _RECLAIMABLE
                            rflag[d] = True
                            push_row_deferred(pg, d)
                if uflag[slot]:
                    uflag[slot] = False
                    defer[pg] = slot
                    self._n_deferred += 1
                else:
                    state[slot] = _RECLAIMABLE
                    rflag[slot] = True
            self.reclaimable.push(ws)

    def complete_flush_rows(self, pages: np.ndarray, slots: np.ndarray):
        """``complete_flush`` over single-page rows as masked scatters.

        With distinct pages the per-entry walks are independent (each
        entry's own slot and its page's deferred slot are disjoint from
        every other entry's), so pending-slot retirement, both §5.2
        deferred-release halves and the reclaimable pushes (a released
        deferred slot's row precedes its entry's own row, in batch order)
        vectorize exactly.

        Duplicate pages couple through the per-page deferral chain, but
        the chain is fully determined: a page's non-last in-batch slot
        ALWAYS carries the update flag at flush time (its successor's
        stage set it, and nothing clears it before the flush), so it is
        deferred at its own step and released exactly when its successor
        flushes — i.e. every within-batch predecessor becomes a release
        row in front of its successor's own row, and only the page's LAST
        slot consults the live flag/deferral state.  One stable argsort
        recovers the chains (``_flush_rows_dup``)."""
        n = int(pages.size)
        if not n:
            return
        self._ensure_page(int(pages.max()))
        if n > 1 and _has_dup_values(pages, n):
            return self._flush_rows_dup(pages, slots)
        pool = self.pool
        pend = self._pend
        cur = pend[pages]
        ret = cur == slots
        if ret.any():
            pend[pages[ret]] = -1
        rel_idx = None                 # entries whose deferred slot releases
        d_rel = None
        if self._n_deferred:
            d = self._defer[pages]
            di = np.flatnonzero(d >= 0)
            if di.size:
                dslots = d[di]
                self._defer[pages[di]] = -1
                self._n_deferred -= int(di.size)
                uf = pool.update_flag[dslots]
                if uf.any():
                    pool.update_flag[dslots[uf]] = False
                rel = ~uf
                if rel.any():
                    d_rel = dslots[rel]
                    pool.state[d_rel] = _RECLAIMABLE
                    pool.reclaim_flag[d_rel] = True
                    rel_idx = di[rel]
        own_uf = pool.update_flag[slots]
        if own_uf.any():
            oi = np.flatnonzero(own_uf)
            pool.update_flag[slots[oi]] = False
            self._defer[pages[oi]] = slots[oi]
            self._n_deferred += int(oi.size)
            ok = slots[~own_uf]
            pool.state[ok] = _RECLAIMABLE
            pool.reclaim_flag[ok] = True
        else:
            pool.state[slots] = _RECLAIMABLE
            pool.reclaim_flag[slots] = True
        self._push_interleaved(pages, slots, rel_idx, d_rel)

    def _flush_rows_dup(self, pages: np.ndarray, slots: np.ndarray):
        """Post-send bookkeeping for a flush batch with duplicate pages —
        the §5.2 chain resolution of ``complete_flush_rows``'s docstring,
        bitwise identical to the sequential walk."""
        n = int(pages.size)
        pool = self.pool
        pend = self._pend
        uflag = pool.update_flag
        order = np.argsort(pages, kind="stable")
        ps = pages[order]
        ss = slots[order]
        samep = ps[1:] == ps[:-1]          # row follows a same-page row
        first = np.empty(n, bool)
        first[0] = True
        np.logical_not(samep, out=first[1:])
        last = np.empty(n, bool)
        last[n - 1] = True
        np.logical_not(samep, out=last[:n - 1])
        up = ps[last]                      # unique pages, sorted
        sl_last = ss[last]
        # pending-slot retirement: only a page's newest in-batch slot can
        # still be its pending slot (every older one was superseded)
        ret = pend[up] == sl_last
        if ret.any():
            pend[up[ret]] = -1
        has_rel_s = np.zeros(n, bool)      # sorted-row release markers
        rel_slot_s = np.empty(n, np.int64)
        if samep.any():
            # within-batch predecessors: deferred at their own step (flag
            # consumed), released when their successor flushes
            pred = ss[:-1][samep]
            uflag[pred] = False
            pool.state[pred] = _RECLAIMABLE
            pool.reclaim_flag[pred] = True
            has_rel_s[1:] = samep
            rel_slot_s[1:][samep] = pred
        if self._n_deferred:
            # a pre-batch deferred slot pops at its page's FIRST row
            d0 = self._defer[up]
            d0i = np.flatnonzero(d0 >= 0)
            if d0i.size:
                d0s = d0[d0i]
                self._defer[up[d0i]] = -1
                self._n_deferred -= int(d0i.size)
                uf0 = uflag[d0s]
                if uf0.any():
                    uflag[d0s[uf0]] = False
                relm = ~uf0
                if relm.any():
                    r0 = d0s[relm]
                    pool.state[r0] = _RECLAIMABLE
                    pool.reclaim_flag[r0] = True
                    fi = np.flatnonzero(first)[d0i[relm]]
                    has_rel_s[fi] = True
                    rel_slot_s[fi] = r0
        # the page's last slot consults the live flag state
        ufk = uflag[sl_last]
        if ufk.any():
            ki = np.flatnonzero(ufk)
            uflag[sl_last[ki]] = False
            self._defer[up[ki]] = sl_last[ki]
            self._n_deferred += int(ki.size)
            ok = sl_last[~ufk]
            pool.state[ok] = _RECLAIMABLE
            pool.reclaim_flag[ok] = True
        else:
            pool.state[sl_last] = _RECLAIMABLE
            pool.reclaim_flag[sl_last] = True
        # back to original row order for the FIFO pushes
        has_rel = np.empty(n, bool)
        rel_slot = np.empty(n, np.int64)
        has_rel[order] = has_rel_s
        rel_slot[order] = rel_slot_s
        rel_idx = np.flatnonzero(has_rel)
        if not rel_idx.size:
            self.reclaimable.push_rows(pages, slots)
            return
        self._push_interleaved(pages, slots, rel_idx, rel_slot[rel_idx])

    def _push_interleaved(self, pages, slots, rel_idx, rel_slots):
        """Push the flush batch's reclaimable rows: each released deferred
        slot's row lands immediately before its entry's own row."""
        if rel_idx is None:
            self.reclaimable.push_rows(pages, slots)
            return
        n = int(pages.size)
        extra = np.zeros(n, np.int64)
        extra[rel_idx] = 1
        own_pos = np.arange(n) + np.cumsum(extra)
        total = n + rel_idx.size
        op = np.empty(total, np.int64)
        osl = np.empty(total, np.int64)
        op[own_pos] = pages
        osl[own_pos] = slots
        op[own_pos[rel_idx] - 1] = pages[rel_idx]
        osl[own_pos[rel_idx] - 1] = rel_slots
        self.reclaimable._dup_risk += int(rel_idx.size)
        self.reclaimable.push_rows(op, osl)

    def reclaim_window(self, start: int, end: int
                       ) -> Tuple[np.ndarray, np.ndarray]:
        """Out-of-FIFO targeted reclaim of the pool window ``[start, end)``
        (the host-donate shrink path).  Arms the reclaimable queue's
        duplicate guard here, at the mechanism: the reclaimed slots' queue
        rows are NOT popped, so a slot later re-staged for the same page
        gives the queue two live rows for one (slot, page) pair."""
        slots, pages = self.pool.reclaim_window(start, end)
        if slots.size:
            self.reclaimable._dup_risk += int(slots.size)
        return slots, pages

    def reclaim(self, n_slots: int) -> List[Tuple[int, int]]:
        return self.reclaimable.reclaim_up_to(n_slots, self.pool)

    def reclaim_bulk(self, n_slots: int) -> Tuple[np.ndarray, np.ndarray]:
        """Vectorized reclaim burst: freed ``(slots, pages)`` arrays."""
        return self.reclaimable.reclaim_bulk(n_slots, self.pool)

    def reclaim_bulk_held(self, n_slots: int, epoch: int, finish_us: float
                          ) -> Tuple[np.ndarray, np.ndarray]:
        """Async-daemon reclaim: same vectorized burst, but the freed slots
        go into an epoch-tagged pool hold (``finish_us`` = simulated daemon
        completion) instead of straight back onto the free stack — the
        foreground cannot allocate them until an epoch boundary (or a
        fence) commits the hold."""
        slots, pages = self.reclaimable.reclaim_bulk(n_slots, self.pool)
        if slots.size:
            held = self.pool.hold_from_free(int(slots.size), epoch, finish_us)
            assert held == int(slots.size)
        return slots, pages

    # -- invariants ----------------------------------------------------------

    def check_invariants(self):
        self.pool.check_invariants()
        staged_slots = [s for ws in self.staging.entries() for s in ws.slots]
        for s in staged_slots:
            st = int(self.pool.state[s])
            assert st == _IN_USE, \
                f"staged slot {s} in state {SlotState(st).name}"
        # a page's latest pending slot must never be RECLAIMABLE
        pend_slots = self._pend[self._pend >= 0]
        assert not np.any(self.pool.state[pend_slots] == _RECLAIMABLE)
        assert self._n_deferred == int(np.count_nonzero(self._defer >= 0))
