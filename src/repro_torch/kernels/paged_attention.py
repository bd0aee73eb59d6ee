"""Paged decode attention — the Valet data-plane hot spot.

One query token per sequence attends over KV pages scattered through the
page pool, read *through* the block table: the table lookup is fused into
the kernel's KV loads, so no gathered KV copy is ever written.  That is why
a zero-restore needs no bulk copy — the engine repoints block-table entries
at pool slots whose bytes survived preemption and streams back only pages
whose slot was reused; any (B, P) table whose live entries index valid pool
pages is a correct input.

Layout (the reference's):
  q:            (B, Hq, D)        one token per sequence, Hq = Hkv * G
  k/v pool:     (n_slots, page, Hkv, D)
  block_table:  (B, P) int32 pool slot per logical page (-1 pad)
  lengths:      (B,)   int32 valid token count per sequence

``paged_attention`` checks its inputs against what the kernel takes, then
dispatches by device: a CPU tensor takes the plain
PyTorch version ``paged_attention_plain``; a CUDA tensor launches the
hand-written kernel (``csrc/paged_attention.cu``) or raises on what the
kernel does not take.  ``paged_attention.launches`` counts kernel launches.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import cuda_lib
from repro_torch.models.attention import combine_partials, decode_partial

MAX_GROUP = 16       # query heads per KV head the kernel takes
MAX_HEAD_DIM = 256


def paged_attention_plain(q, k_pool, v_pool, block_table, lengths):
    """Gather the pages, then a masked softmax: the kernel's plain version."""
    b, hq, d = q.shape
    _, page, hkv, _ = k_pool.shape
    p = block_table.shape[1]
    bt = block_table.long()
    safe = bt.clamp(min=0)
    keys = k_pool[safe].reshape(b, p * page, hkv, d)
    values = v_pool[safe].reshape(b, p * page, hkv, d)
    pos = torch.arange(p * page, device=q.device)[None, :]
    valid = (pos < lengths.long()[:, None]) & \
        (bt >= 0).repeat_interleave(page, dim=1)
    m, l, acc = decode_partial(q, keys, values, valid)
    return combine_partials((m[None], l[None], acc[None]), q.dtype)


def _chunk(page: int) -> int:
    """Tokens the kernel stages per step: 64 (whole pages) or one page."""
    if 64 % page == 0:
        return 64
    if page % 32 == 0 and page <= 256:
        return page
    raise ValueError(f"paged kernel takes a page that divides 64 or is a "
                     f"multiple of 32 up to 256, not {page}")


def _check(q, k_pool, v_pool, block_table, lengths):
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool),
                    ("block_table", block_table), ("lengths", lengths)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")
    b, hq, d = q.shape
    n_slots, page, hkv, dk = k_pool.shape
    if v_pool.shape != k_pool.shape or v_pool.dtype != k_pool.dtype:
        raise ValueError("k_pool and v_pool differ in shape or dtype")
    if dk != d or d % 8 or d > MAX_HEAD_DIM:
        raise ValueError(f"head_dim must be a multiple of 8 up to "
                         f"{MAX_HEAD_DIM} and match the pool, got {d}/{dk}")
    if hq % hkv or hq // hkv > MAX_GROUP:
        raise ValueError(f"Hq={hq} must be a multiple of Hkv={hkv} with at "
                         f"most {MAX_GROUP} query heads per KV head")
    if block_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("block_table and lengths must be int32")
    if block_table.shape[0] != b or tuple(lengths.shape) != (b,):
        raise ValueError("block_table/lengths batch does not match q")
    _chunk(page)
    for t in (q, k_pool, v_pool):
        cuda_lib.dtype_code(t.dtype)
        if t.data_ptr() % 16:
            raise ValueError("kernel needs 16-byte aligned tensors")


def paged_attention(q, k_pool, v_pool, block_table, lengths):
    """q: (B, Hq, D); pools: (n_slots, page, Hkv, D); block_table: (B, P).

    Returns (B, Hq, D) in q's dtype.  Pages with slot -1 and tokens at
    ``pos >= length`` contribute nothing.
    """
    _check(q, k_pool, v_pool, block_table, lengths)
    if not q.is_cuda:
        return paged_attention_plain(q, k_pool, v_pool, block_table, lengths)
    b, hq, d = q.shape
    _, page, hkv, _ = k_pool.shape
    chunk = _chunk(page)
    out = torch.empty_like(q)
    lib = cuda_lib.load()
    err = lib.valet_paged_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        b, hkv, hq // hkv, d, page, block_table.shape[1], chunk,
        cuda_lib.dtype_code(q.dtype), cuda_lib.dtype_code(k_pool.dtype),
        1.0 / math.sqrt(d), torch.cuda.current_stream(q.device).cuda_stream)
    cuda_lib.check(err, "paged_attention")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
