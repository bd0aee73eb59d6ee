"""Device-side data plane for the Valet page pools (PyTorch).

The pool is a fixed array of page slots per layer:
  K/V pool: (n_slots, page_size, n_kv_heads, head_dim)

Every writer updates the pool **in place** and returns the same ``KVPool``
(the JAX reference is functional and donates its buffers; mutating in place
is the PyTorch form of the same "no pool-sized copy" contract).  A caller
that needs the old bytes snapshots them with ``.clone()`` first.  The
control plane (pool.py/tiers.py) decides *which* slots, the data plane only
moves bytes.  Index tensors are int64; the decode kernel reads the block
table as int32 (``repro_torch.kernels.paged_attention``).
"""
from __future__ import annotations

from typing import List, NamedTuple, Sequence

import torch


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
    valid rows are selected explicitly (one host sync on a CUDA mask)."""
    slot = torch.as_tensor(slot)
    ok = torch.as_tensor(own_mask, device=slot.device).bool() \
        & (slot >= 0) & (slot < n_slots)
    return ok.nonzero().squeeze(1)


def append_token_masked(pool: KVPool, k, v, slot, offset, own_mask,
                        rows=None) -> KVPool:
    """Masked append: only rows with ``own_mask`` (and an in-range slot)
    write; the others are dropped.  ``rows`` may pass a precomputed
    ``live_rows`` selection (the decode step shares one across layers)."""
    if rows is None:
        rows = live_rows(own_mask, slot, pool.k.shape[0])
    dev = pool.k.device
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
    ``slot`` a scalar index.  Only pages whose slot was *reused* since
    preemption come back through here, one host read each.  The page is
    copied into the pool in place with ``index_copy_`` (the host-to-device
    copy is stream-ordered, so no host sync is needed)."""
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

def to_host_tier_many(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Spill tensors to the host memory tier.

    A CUDA tensor is copied into pinned CPU memory with ``non_blocking``
    copies, all issued before one synchronisation of the copying streams, so
    the blobs are complete when this returns and host code may read them.
    A CPU tensor is cloned.  The spill round-trips exactly."""
    out, streams = [], {}
    for x in xs:
        if x.is_cuda:
            h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            h.copy_(x, non_blocking=True)
            streams[x.device] = torch.cuda.current_stream(x.device)
            out.append(h)
        else:
            out.append(x.clone())
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
