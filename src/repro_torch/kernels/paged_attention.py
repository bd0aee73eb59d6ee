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
kernel does not take.  ``paged_attention.launches`` counts kernel calls.

The kernel splits each sequence into runs of tokens (flash-decoding): one
block per (run, KV head, sequence) writes a partial softmax (m, l, acc) to
a workspace the wrapper allocates, and a second pass combines the partials
as ``combine_partials`` does.  ``split_plan`` picks the run from static
shapes only -- never from the lengths -- so a row's output does not depend
on the other rows of its batch (exactness under pressure compares runs
whose batches differ) and the launch grid is set without reading the device.

``paged_attention_partials`` is the kernel's entry for one peer of a pool
sharded round-robin over ``kvr`` ranks (``launch/serve_step.py``): its block
table holds the rank's local pages, local page ``j`` of rank ``rank`` holds
absolute positions ``(j * kvr + rank) * page + o``, and it returns the f32
partial softmax ``(m, l, acc)`` for ``combine_partials_psum`` to combine
across the ranks.  Its pools may be int8 with per-(slot, position, head)
scales in q's dtype.  ``paged_attention_partials.launches`` counts its calls
of the kernel.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import cuda_lib
from repro_torch.models.attention import combine_partials, decode_partial

MAX_GROUP = 16       # query heads per KV head the kernel takes
MAX_HEAD_DIM = 256
INT8_CODE = 2      # the C interface's code of an int8 pool


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


SMS = 132            # streaming multiprocessors of an H100
BLOCKS_PER_SM = 2    # the plan's target: blocks per SM over the whole grid
MIN_RUN = 64         # tokens per split: at least this ...
MAX_RUN = 512        # ... and at most this (its per-token rows in shared memory)


def _bits(dtype) -> int:
    return (torch.iinfo if dtype == torch.int8 else torch.finfo)(dtype).bits


def tile_tokens(d: int, kv_dtype) -> int:
    """Tokens the kernel stages per step: 64 when a token's row of K is at
    most 256 bytes (so that a tile carries enough bytes), else 32."""
    return 64 if d * _bits(kv_dtype) // 8 <= 256 else 32


def _check_page(page: int) -> None:
    if not (64 % page == 0 or (page % 32 == 0 and page <= 256)):
        raise ValueError(f"paged kernel takes a page that divides 64 or is a "
                         f"multiple of 32 up to 256, not {page}")


def split_plan(b: int, hkv: int, g: int, d: int, page: int, n_pages: int,
               q_dtype, kv_dtype) -> tuple[int, int]:
    """Tokens per split and number of splits of the kernel's first pass.

    A function of static shapes only: the engine always passes B =
    ``max_batch`` and P = ``max_seq / page``, so the plan, the launch grid and
    every row's order of sums are the same whatever lengths the batch holds.
    A run is whole pages and whole staged tiles (``tile_tokens``); runs are
    sized so that the B * Hkv * splits blocks number about
    ``BLOCKS_PER_SM`` per SM when every row is full.  (``g`` and the q dtype
    do not change the plan today; they are part of what it may depend on.)
    """
    _check_page(page)
    n_tok = n_pages * page
    unit = math.lcm(tile_tokens(d, kv_dtype), page)
    want = -(-BLOCKS_PER_SM * SMS // max(b * hkv, 1))     # splits per row
    run = -(-max(-(-n_tok // want), MIN_RUN) // unit) * unit
    run = max(min(run, MAX_RUN // unit * unit), unit)
    return run, max(-(-n_tok // run), 1)


def plan_for(q, k_pool, block_table) -> tuple[int, int]:
    """``split_plan`` of a call's shapes and dtypes (never its lengths)."""
    b, hq, d = q.shape
    _, page, hkv, _ = k_pool.shape
    return split_plan(b, hkv, hq // hkv, d, page, block_table.shape[1],
                      q.dtype, k_pool.dtype)


def _check(q, k_pool, v_pool, block_table, lengths, scales=()):
    """What the kernel takes.  ``scales``: an int8 pool's (k_scale,
    v_scale), each (n_slots, page, Hkv) in q's dtype; none for a float
    pool."""
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool),
                    ("block_table", block_table), ("lengths", lengths),
                    *(("scale", sc) for sc in scales)):
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
    _check_page(page)
    quant = k_pool.dtype == torch.int8
    if quant != bool(scales):
        raise ValueError("an int8 pool takes scales, a float pool none")
    if quant and d % 16:
        raise ValueError(f"an int8 pool needs head_dim a multiple of 16, not {d}")
    for sc in scales:
        if tuple(sc.shape) != (n_slots, page, hkv) or sc.dtype != q.dtype:
            raise ValueError(f"scales must be (n_slots, page, Hkv) in q's "
                             f"dtype, got {tuple(sc.shape)} {sc.dtype}")
    cuda_lib.dtype_code(q.dtype)
    if not quant:
        cuda_lib.dtype_code(k_pool.dtype)
    for t in (q, k_pool, v_pool):
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
    run, n_splits = plan_for(q, k_pool, block_table)
    out = torch.empty_like(q)
    # the first pass's partials (m, l) and acc, combined by the second pass;
    # with one split the first pass writes ``out`` and they are not touched
    f32 = dict(dtype=torch.float32, device=q.device)
    ws_ml = torch.empty((n_splits, b, hq, 2) if n_splits > 1 else (0,), **f32)
    ws_acc = torch.empty((n_splits, b, hq, d) if n_splits > 1 else (0,), **f32)
    lib = cuda_lib.load()
    err = lib.valet_paged_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        ws_ml.data_ptr(), ws_acc.data_ptr(),
        b, hkv, hq // hkv, d, page, block_table.shape[1],
        tile_tokens(d, k_pool.dtype), run, n_splits,
        cuda_lib.dtype_code(q.dtype), cuda_lib.dtype_code(k_pool.dtype),
        1.0 / math.sqrt(d), torch.cuda.current_stream(q.device).cuda_stream)
    cuda_lib.check(err, "paged_attention")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0


# --------------------------------------------------------------------------
# One peer's partials over its round-robin share of the pages
# --------------------------------------------------------------------------

def _widen(pool, scale, safe, dtype):
    """The pages ``safe`` of a pool, int8 values times their scale in
    ``dtype`` as the reference widens them (``launch/serve_step.py``)."""
    pages = pool[safe]
    if scale is None:
        return pages
    return pages.to(dtype) * scale[safe][..., None]


def paged_attention_partials_plain(q, k_pool, v_pool, block_table, lengths,
                                   *, kvr=1, rank=0, k_scale=None,
                                   v_scale=None):
    """Gather the rank's pages, then ``decode_partial`` at their absolute
    positions: the partial entry's plain version."""
    b, hq, d = q.shape
    _, page, hkv, _ = k_pool.shape
    p = block_table.shape[1]
    bt = block_table.long()
    safe = bt.clamp(min=0)
    keys = _widen(k_pool, k_scale, safe, q.dtype).reshape(b, p * page, hkv, d)
    values = _widen(v_pool, v_scale, safe, q.dtype).reshape(b, p * page, hkv, d)
    base = (torch.arange(p, device=q.device) * kvr + rank) * page
    pos = (base[:, None] + torch.arange(page, device=q.device)).reshape(-1)
    valid = (pos[None, :] < lengths.long()[:, None]) & \
        (bt >= 0).repeat_interleave(page, dim=1)
    return decode_partial(q, keys, values, valid)


def paged_attention_partials(q, k_pool, v_pool, block_table, lengths, *,
                             kvr=1, rank=0, k_scale=None, v_scale=None):
    """One peer's partial softmax over its pages of a sharded pool.

    q: (B, Hq, D); pools: (n_slots, page, Hkv, D), f32, bf16, or int8 with
    ``k_scale``/``v_scale`` (n_slots, page, Hkv) in q's dtype; block_table:
    (B, P) the rank's local pages (-1 pad); lengths: (B,) int32, valid
    positions are those below it.  Returns f32 ``(m, l, acc)`` of shapes
    (B, Hkv, G), (B, Hkv, G) and (B, Hkv, G, D), as ``decode_partial``.
    """
    scales = () if k_scale is None else (k_scale, v_scale)
    _check(q, k_pool, v_pool, block_table, lengths, scales)
    if not 0 <= rank < kvr:
        raise ValueError(f"rank {rank} is not one of {kvr} ranks")
    if not q.is_cuda:
        return paged_attention_partials_plain(
            q, k_pool, v_pool, block_table, lengths, kvr=kvr, rank=rank,
            k_scale=k_scale, v_scale=v_scale)
    b, hq, d = q.shape
    _, page, hkv, _ = k_pool.shape
    g = hq // hkv
    run, n_splits = plan_for(q, k_pool, block_table)
    f32 = dict(dtype=torch.float32, device=q.device)
    ml = torch.empty((b, hq, 2), **f32)
    acc = torch.empty((b, hq, d), **f32)
    ws_ml = torch.empty((n_splits, b, hq, 2) if n_splits > 1 else (0,), **f32)
    ws_acc = torch.empty((n_splits, b, hq, d) if n_splits > 1 else (0,), **f32)
    quant = k_pool.dtype == torch.int8
    lib = cuda_lib.load()
    err = lib.valet_paged_attention_partials(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        k_scale.data_ptr() if quant else None,
        v_scale.data_ptr() if quant else None,
        block_table.data_ptr(), lengths.data_ptr(), ml.data_ptr(),
        acc.data_ptr(), ws_ml.data_ptr(), ws_acc.data_ptr(),
        b, hkv, g, d, page, block_table.shape[1],
        tile_tokens(d, k_pool.dtype), run, n_splits, kvr, rank,
        cuda_lib.dtype_code(q.dtype),
        INT8_CODE if quant else cuda_lib.dtype_code(k_pool.dtype),
        1.0 / math.sqrt(d), torch.cuda.current_stream(q.device).cuda_stream)
    cuda_lib.check(err, "paged_attention_partials")
    paged_attention_partials.launches += 1
    return (ml[..., 0].reshape(b, hkv, g), ml[..., 1].reshape(b, hkv, g),
            acc.reshape(b, hkv, g, d))


paged_attention_partials.launches = 0
