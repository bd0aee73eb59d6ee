"""Page-major moves of whole KV pages between the paged layers' pools and a
staging buffer, for the host tier's arena (``core/device_ops.HostPageArena``).

A page of the host tier is one block holding every paged layer's K and V
rows of one pool slot: ``R = 2 x (paged layers)`` rows, in the order
layer 0's K, layer 0's V, layer 1's K, ...  ``pools`` lists the R pool
tensors in that order, each ``(n_slots, *row)`` of one shape and dtype; a
staging buffer is ``(n, R, *row)``, page ``i`` holding slot ``slots[i]``.

``host_pages(stage, pools, slots, to_stage)`` gathers (``to_stage``) or
scatters n pages.  It checks its inputs, then dispatches by device: CPU
tensors take the plain PyTorch version ``host_pages_plain``; CUDA tensors
launch the hand-written kernel (``csrc/host_pages.cu``) or raise.
``move_pages`` is the host tier's whole move on the card: the kernel and
the copies between the staging buffer and pinned host blocks, issued from
C in one call on the current stream, with no wait.  ``host_pages.launches``
counts kernel launches (at most 64 pages each) of both entries;
``move_pages.copies`` counts the copies ``move_pages`` issued (one per run
of adjacent host blocks).

The kernel replaces no TPU kernel (the JAX package moves a spilled page's
bytes with ``jax.device_put`` to a ``pinned_host`` sharding,
``src/repro/core/device_ops.py:136``); it is bound by device memory bytes,
a read and a write of each page.  Its design is in the source.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import numpy as np
import torch

from repro_torch.kernels import cuda_lib

VEC_BYTES = 16          # the kernel copies in 16-byte vectors


def host_pages_plain(stage, pools, slots, to_stage):
    """The kernel's plain version: ``stage[i, r] = pools[r][slots[i]]``
    (``to_stage``), else the reverse.  Returns ``stage``."""
    idx = torch.as_tensor(np.asarray(slots, np.int64), device=stage.device)
    n = idx.numel()
    for r, pool in enumerate(pools):
        if to_stage:
            stage[:n, r] = pool.index_select(0, idx)
        else:
            pool.index_copy_(0, idx, stage[:n, r])
    return stage


def pool_table(pools: Sequence[torch.Tensor]) -> torch.Tensor:
    """The kernel's table of the pools' device addresses (int64), after
    checking that the pools are what the kernel takes."""
    _check_pools(pools)
    return torch.tensor([p.data_ptr() for p in pools], dtype=torch.int64,
                        device=pools[0].device)


def row_bytes(pools) -> int:
    p = pools[0]
    return p[0].numel() * p.element_size()


def _check_pools(pools) -> None:
    p0 = pools[0]
    for p in pools:
        if p.shape != p0.shape or p.dtype != p0.dtype or p.device != p0.device:
            raise ValueError("the pools differ in shape, dtype or device")
        if not p.is_contiguous():
            raise ValueError("the pools must be contiguous")
    if p0.is_cuda:
        if row_bytes(pools) % VEC_BYTES:
            raise ValueError(f"a pool row of {row_bytes(pools)} B is not a "
                             f"multiple of {VEC_BYTES}")
        if any(p.data_ptr() % VEC_BYTES for p in pools):
            raise ValueError("kernel needs 16-byte aligned pools")


def _check(stage, pools, slots, rounds=False) -> None:
    """What a call takes, the pools checked apart (``_check_pools``);
    ``slots`` an int32 array.  ``rounds``: the pages go through ``stage``
    in rounds, so it may hold fewer."""
    p0 = pools[0]
    want = (len(pools),) + tuple(p0.shape[1:])
    if tuple(stage.shape[1:]) != want or stage.dtype != p0.dtype \
            or stage.device != p0.device or not stage.is_contiguous():
        raise ValueError(f"stage must be contiguous (pages,) + {want} in the "
                         f"pools' dtype and device, got {tuple(stage.shape)}")
    n = len(slots)
    if n > stage.shape[0] and not rounds:
        raise ValueError(f"{n} pages do not fit a stage of {stage.shape[0]}")
    if n and (slots.min() < 0 or slots.max() >= p0.shape[0]):
        raise ValueError(f"pool slots out of range [0, {p0.shape[0]})")
    if stage.data_ptr() % VEC_BYTES:
        raise ValueError("kernel needs a 16-byte aligned stage")


def host_pages(stage, pools, slots, to_stage, table=None):
    """Gather (``to_stage``) or scatter the pages of pool slots ``slots``
    between ``pools`` and ``stage`` (see the module's layout).  ``table``
    may pass ``pool_table(pools)``, built once by the caller."""
    sl = np.ascontiguousarray(slots, np.int32)
    _check_pools(pools)
    _check(stage, pools, sl)
    if not stage.is_cuda:
        return host_pages_plain(stage, pools, sl, to_stage)
    if table is None:
        table = pool_table(pools)
    counts = (ctypes.c_int * 2)()
    err = cuda_lib.load().valet_host_pages(
        table.data_ptr(), sl.ctypes.data, len(sl), stage.data_ptr(), len(pools),
        row_bytes(pools), int(bool(to_stage)), counts,
        torch.cuda.current_stream(stage.device).cuda_stream)
    cuda_lib.check(err, "host_pages")
    host_pages.launches += counts[0]
    return stage


host_pages.launches = 0


def move_pages(stage, pools, table, slots, host_addrs, to_host) -> None:
    """The host tier's move on the card: pool slots ``slots[i]`` to
    (``to_host``) or from the pinned host blocks at ``host_addrs[i]`` (one
    page each, ``len(pools) * row_bytes`` B), through ``stage`` in rounds
    of its pages.  ``table`` is ``pool_table(pools)``, which checked the
    pools.  Issued on the current stream; nothing waits."""
    sl = np.ascontiguousarray(slots, np.int32)
    _check(stage, pools, sl, rounds=True)
    if not stage.is_cuda:
        raise ValueError("move_pages runs on the card; the CPU path copies "
                         "through host_pages")
    addrs = np.ascontiguousarray(host_addrs, np.int64)
    counts = (ctypes.c_int * 2)()
    err = cuda_lib.load().valet_host_pages_move(
        table.data_ptr(), sl.ctypes.data, addrs.ctypes.data, len(sl),
        stage.data_ptr(), stage.shape[0], len(pools), row_bytes(pools),
        int(bool(to_host)), counts,
        torch.cuda.current_stream(stage.device).cuda_stream)
    cuda_lib.check(err, "host_pages_move")
    host_pages.launches += counts[0]
    move_pages.copies += counts[1]


move_pages.copies = 0
