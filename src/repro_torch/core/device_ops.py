"""Device-side data plane for the Valet page pools (PyTorch).

The pool is a fixed array of page slots per layer:
  K/V pool: (n_slots, page_size, n_kv_heads, head_dim)

Every writer updates the pool **in place** and returns the same ``KVPool``
(the JAX reference is functional and donates its buffers; mutating in place
is the PyTorch form of the same "no pool-sized copy" contract).  A caller
that needs the old bytes snapshots them with ``.clone()`` first.  The
control plane (pool.py/tiers.py) decides *which* slots, the data plane only
moves bytes.  Index tensors are int64; the decode kernel reads the block
table as int32 (``repro_torch.kernels.paged_attention``).  The host tier's
KV pages live in a ``HostPageArena``: one contiguous block of pinned
memory per page for all paged layers, moved by ``kernels/host_pages.py``.
"""
from __future__ import annotations

import heapq
from typing import List, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core import spans
from repro_torch.kernels import host_pages as hp
from repro_torch.kernels.kv_append import kv_append


class KVPool(NamedTuple):
    """One layer's paged KV storage."""
    k: torch.Tensor     # (n_slots, page, n_kv, hd)
    v: torch.Tensor


def make_kv_pool(n_slots, page, n_kv, hd, dtype=torch.bfloat16,
                 device="cuda") -> KVPool:
    shape = (n_slots, page, n_kv, hd)
    return KVPool(torch.zeros(shape, dtype=dtype, device=device),
                  torch.zeros(shape, dtype=dtype, device=device))


def _index(x, device) -> torch.Tensor:
    return torch.as_tensor(x, device=device).to(torch.int64)


def append_token(pool: KVPool, k, v, slot, offset) -> KVPool:
    """Write one token's K/V into (slot, offset) per batch element, in place.

    k, v: (B, n_kv, hd); slot, offset: (B,).  The write completes into the
    *local pool* — the paper's critical-path contract: callers never wait
    for any remote traffic.
    """
    dev = pool.k.device
    s, o = _index(slot, dev), _index(offset, dev)
    pool.k[s, o] = k.to(pool.k.dtype)
    pool.v[s, o] = v.to(pool.v.dtype)
    return pool


def live_rows(own_mask, slot, n_slots) -> torch.Tensor:
    """Batch rows whose append lands: owned and in ``[0, n_slots)``.

    The reference drops the rest through XLA's ``mode="drop"``; an
    out-of-bounds ``index_put_`` is a device-side assert in PyTorch, so the
    valid rows are selected explicitly.  The selection is ``nonzero()``,
    which on a CUDA mask waits for the card: the CPU's decode step and the
    sharded serve step (``launch/serve_step.py``, once a step) take it; the
    decode step on the card appends through the ``kv_append`` kernel
    instead (``append_token_masked`` without ``rows``)."""
    slot = torch.as_tensor(slot)
    ok = torch.as_tensor(own_mask, device=slot.device).bool() \
        & (slot >= 0) & (slot < n_slots)
    return ok.nonzero().squeeze(1)


def append_token_masked(pool: KVPool, k, v, slot, offset, own_mask,
                        rows=None) -> KVPool:
    """Masked append: only rows with ``own_mask`` (and an in-range slot)
    write; the others are dropped.  ``rows`` may pass a precomputed
    ``live_rows`` selection (the CPU's decode step shares one across
    layers).  On the card, without ``rows``, the ``kv_append`` kernel
    writes the live rows and skips the others, with no host sync."""
    dev = pool.k.device
    if rows is None and pool.k.is_cuda:
        kv_append(pool.k, pool.v, k, v, _index(slot, dev), _index(offset, dev),
                  torch.as_tensor(own_mask, device=dev).bool())
        return pool
    if rows is None:
        rows = live_rows(own_mask, slot, pool.k.shape[0])
    rows = rows.to(dev)
    return append_token(pool, k[rows], v[rows], _index(slot, dev)[rows],
                        _index(offset, dev)[rows])


def gather_pages(pool: KVPool, slots):
    """slots: (B, P) (-1 = pad).  Returns k,v (B, P, page, n_kv, hd) and a
    page-valid mask (B, P).  A gathered copy: the decode path reads through
    the block table with the paged kernel instead."""
    slots = _index(slots, pool.k.device)
    valid = slots >= 0
    safe = slots.clamp(min=0)
    return pool.k[safe], pool.v[safe], valid


def write_prefill_pages(pool: KVPool, k_pages, v_pages, slots) -> KVPool:
    """Bulk-insert prefill KV in place.  k_pages: (B, P, page, n_kv, hd);
    slots: (B, P) (-1 = skip; the skipped pages are not written)."""
    dev = pool.k.device
    flat = _index(slots, dev).reshape(-1)
    kf = k_pages.reshape((-1,) + tuple(k_pages.shape[2:]))
    vf = v_pages.reshape((-1,) + tuple(v_pages.shape[2:]))
    keep = ((flat >= 0) & (flat < pool.k.shape[0])).nonzero().squeeze(1)
    pool.k.index_copy_(0, flat[keep], kf[keep].to(pool.k.dtype))
    pool.v.index_copy_(0, flat[keep], vf[keep].to(pool.v.dtype))
    return pool


def local_write_batch(pool: KVPool, k_pages, v_pages, slots) -> KVPool:
    """Bulk local-pool write: scatter ``n`` whole pages into their slots, in
    place.  k_pages/v_pages: (n, page, n_kv, hd); slots: (n,), distinct (an
    alloc run pops each pool slot at most once)."""
    return insert_blocks(pool, k_pages, v_pages, slots)


def stream_page(pool: KVPool, k, v, slot) -> KVPool:
    """On-demand single-page stream-in (the zero-restore miss path).

    k/v: one page ``(page, n_kv, hd)``, usually a pinned host-tier blob;
    ``slot`` a scalar index.  The page is copied into the pool in place with
    ``index_copy_`` (the host-to-device copy is stream-ordered, so no host
    sync is needed).  The serving engine streams a restore's pages in one
    ``local_write_batch`` per layer instead, which writes the same bytes."""
    dev = pool.k.device
    s = _index([int(slot)], dev)
    pool.k.index_copy_(0, s, from_host_tier(k, pool.k)[None])
    pool.v.index_copy_(0, s, from_host_tier(v, pool.v)[None])
    return pool


def copy_block(pool: KVPool, src_slot, dst_slot) -> KVPool:
    """Migration data plane: copy one slot's page, in place."""
    pool.k[int(dst_slot)] = pool.k[int(src_slot)]
    pool.v[int(dst_slot)] = pool.v[int(src_slot)]
    return pool


def extract_blocks(pool: KVPool, slots):
    """Read slots out of the pool (spill to host tier).  (n, page, kv, hd)."""
    s = _index(slots, pool.k.device)
    return pool.k[s], pool.v[s]


def insert_blocks(pool: KVPool, ks, vs, slots) -> KVPool:
    """Insert blocks fetched from a slower tier back into the pool, in place."""
    s = _index(slots, pool.k.device)
    pool.k.index_copy_(0, s, from_host_tier(ks, pool.k))
    pool.v.index_copy_(0, s, from_host_tier(vs, pool.v))
    return pool


# -- host tier ----------------------------------------------------------------

class HostPageArena:
    """The host tier's store of KV pages: page-major host memory, pinned
    when the pools are on the card.

    One arena slot holds one logical page's bytes for every paged layer:
    the ``R = 2 x (paged layers)`` rows of ``kernels/host_pages.py``'s
    layout (layer 0's K, layer 0's V, ...), contiguous, so that a page
    crosses PCIe as one copy.  ``store`` moves pool slots' pages into free
    arena slots and returns their ids; ``load`` moves arena slots back into
    pool slots and frees them; ``free`` frees without reading.  Ids are
    handed out lowest first, so a batch's slots tend to be adjacent and its
    copies few (one per run of adjacent slots).

    The arena takes its geometry from the first pools it moves and
    allocates nothing before: it grows by chunks of ``CHUNK_BYTES`` (at
    least one page) when a store finds too few free slots (span
    ``host_arena.grow``, the slots added), and never shrinks.  On the card
    a move is ``host_pages.move_pages``: the gather or scatter kernel for
    all layers and the copies, through a staging buffer of ``STAGE_PAGES``
    pages on the card (made at the first move), on the current stream, with
    no wait.  Every later reader or writer of those pool slots, arena slots
    or the staging buffer runs on the same stream, so stream order is the
    guarantee; the arena waits for its last move only when it is freed, so
    that its pinned memory never goes back to the allocator under a copy.
    On the CPU the same moves go through ``host_pages``' plain version.
    Span ``host_tier.issue`` of each move carries its bytes.  ``capacity``,
    ``in_use`` and ``peak`` count slots."""

    STAGE_PAGES = 64        # one launch's pages
    CHUNK_BYTES = 1 << 28   # a power of two: the pinned allocator rounds to one

    def __init__(self):
        self.chunks: List[torch.Tensor] = []    # (chunk_slots, R, *row)
        self._bases = np.empty(0, np.int64)     # each chunk's host address
        self._free: List[int] = []              # heap of free slot ids
        self.capacity = self.in_use = self.peak = 0
        self._row = None            # (R, row shape, dtype, device)
        self.chunk_slots = 0
        self.slot_bytes = 0
        self._table = None          # (pool addresses, their device table)
        self._stage = None
        self._done = None           # an event after the last move

    def __del__(self):
        done = getattr(self, "_done", None)
        if done is not None:
            done.synchronize()

    def _bind(self, pools: Sequence[torch.Tensor]) -> None:
        if pools:
            p = pools[0]
            geom = (len(pools), tuple(p.shape[1:]), p.dtype, p.device)
        else:                       # a model with no paged layer
            geom = (0, (), None, None)
        if self._row is None:
            self._row = geom
            self.slot_bytes = len(pools) * pools[0][0].nbytes if pools else 0
            self.chunk_slots = max(1, self.CHUNK_BYTES // self.slot_bytes) \
                if self.slot_bytes else 0
        elif geom != self._row:
            raise ValueError(f"pools of {geom} in an arena of {self._row}")

    def _grow(self, need: int) -> None:
        rows, row, dtype, device = self._row
        per = self.chunk_slots or need      # pages of no bytes take no memory
        add = -(-need // per)
        with spans.span("host_arena.grow", n=add * per):
            for _ in range(add):
                if rows:
                    c = torch.empty((per, rows) + row, dtype=dtype,
                                    pin_memory=device.type == "cuda")
                    self.chunks.append(c)
                    self._bases = np.append(self._bases, c.data_ptr())
                # ids above every free one: appended, the heap stays a heap
                self._free.extend(range(self.capacity, self.capacity + per))
                self.capacity += per

    def _take(self, n: int) -> List[int]:
        if len(self._free) < n:
            self._grow(n - len(self._free))
        ids = [heapq.heappop(self._free) for _ in range(n)]
        self.in_use += n
        self.peak = max(self.peak, self.in_use)
        return ids

    def free(self, ids: Sequence[int]) -> None:
        for i in ids:
            heapq.heappush(self._free, i)
        self.in_use -= len(ids)

    def view(self, sid: int) -> torch.Tensor:
        """Arena slot ``sid``'s page: ``(R, *row)`` on the host."""
        return self.chunks[sid // self.chunk_slots][sid % self.chunk_slots]

    def _move(self, pools, ids, slots, to_host: bool) -> None:
        n = len(ids)
        if not n or not self.slot_bytes:
            return
        with spans.span("host_tier.issue", n=n * self.slot_bytes):
            if pools[0].is_cuda:
                self._move_on_card(pools, ids, slots, to_host)
                return
            stage = torch.empty((n, self._row[0]) + self._row[1],
                                dtype=self._row[2])
            if to_host:
                hp.host_pages(stage, pools, slots, True)
                for page, sid in zip(stage, ids):
                    self.view(sid).copy_(page)
            else:
                for page, sid in zip(stage, ids):
                    page.copy_(self.view(sid))
                hp.host_pages(stage, pools, slots, False)

    def _move_on_card(self, pools, ids, slots, to_host: bool) -> None:
        addrs = tuple(p.data_ptr() for p in pools)
        if self._table is None or self._table[0] != addrs:
            self._table = (addrs, hp.pool_table(pools))
        if self._stage is None:
            self._stage = torch.empty(
                (self.STAGE_PAGES, self._row[0]) + self._row[1],
                dtype=self._row[2], device=self._row[3])
            self._done = torch.cuda.Event()
        ids = np.asarray(ids, np.int64)
        host = self._bases[ids // self.chunk_slots] \
            + (ids % self.chunk_slots) * self.slot_bytes
        hp.move_pages(self._stage, pools, self._table[1], slots, host, to_host)
        self._done.record(torch.cuda.current_stream(self._row[3]))

    def store(self, pools: Sequence[torch.Tensor], slots) -> List[int]:
        """Copy the pages of pool slots ``slots`` (all ``pools``, the R
        rows in order) into free arena slots; returns their ids."""
        self._bind(pools)
        ids = self._take(len(slots))
        self._move(pools, ids, slots, True)
        return ids

    def load(self, pools: Sequence[torch.Tensor], ids: Sequence[int],
             slots) -> None:
        """Copy arena slots ``ids`` into pool slots ``slots`` (distinct)
        and free the arena slots."""
        self._bind(pools)
        self._move(pools, ids, slots, False)
        self.free(ids)


def to_host_tier_many(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Spill tensors to the host memory tier.

    A CUDA tensor is copied into pinned CPU memory with ``non_blocking``
    copies, all issued before one synchronisation of the copying streams, so
    the blobs are complete when this returns and host code may read them.
    A CPU tensor is cloned.  The spill round-trips exactly.  Spans
    ``host_tier.issue`` (allocations and copies) and ``host_tier.wait``
    (the synchronisation) carry the bytes moved."""
    out, streams, nbytes = [], {}, 0
    with spans.span("host_tier.issue") as sp:
        for x in xs:
            nbytes += x.nbytes
            if x.is_cuda:
                h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                h.copy_(x, non_blocking=True)
                streams[x.device] = torch.cuda.current_stream(x.device)
                out.append(h)
            else:
                out.append(x.clone())
        sp.set(nbytes)
    with spans.span("host_tier.wait", n=nbytes):
        for s in streams.values():
            s.synchronize()
    return out


def to_host_tier(x: torch.Tensor) -> torch.Tensor:
    """Spill one tensor to the host tier (see ``to_host_tier_many``)."""
    return to_host_tier_many([x])[0]


def from_host_tier(x, like=None) -> torch.Tensor:
    """Fetch a spilled tensor back toward ``like``'s device and dtype
    (inverse of ``to_host_tier``).  From pinned memory the copy is
    asynchronous and ordered on the current stream."""
    x = torch.as_tensor(x)
    if like is None:
        return x
    return x.to(device=like.device, dtype=like.dtype,
                non_blocking=x.is_pinned())


# -- ring buffer for sliding-window layers -----------------------------------

class RingKV(NamedTuple):
    k: torch.Tensor     # (B, W, n_kv, hd)
    v: torch.Tensor


def make_ring(batch, window, n_kv, hd, dtype=torch.bfloat16,
              device="cuda") -> RingKV:
    shape = (batch, window, n_kv, hd)
    return RingKV(torch.zeros(shape, dtype=dtype, device=device),
                  torch.zeros(shape, dtype=dtype, device=device))


def ring_append(ring: RingKV, k, v, pos) -> RingKV:
    """k, v: (B, n_kv, hd); pos: scalar int (global step).  In place."""
    w = ring.k.shape[1]
    idx = int(pos) % w
    ring.k[:, idx] = k.to(ring.k.dtype)
    ring.v[:, idx] = v.to(ring.v.dtype)
    return ring


def ring_valid(ring: RingKV, pos):
    """(B, W) validity mask after ``pos + 1`` tokens written."""
    w = ring.k.shape[1]
    b = ring.k.shape[0]
    filled = min(int(pos) + 1, w)
    m = torch.arange(w, device=ring.k.device)[None, :] < filled
    return m.expand(b, w)
