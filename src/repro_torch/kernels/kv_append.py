"""A decode step's append of one token's K and V per batch row into a paged
layer's pools, where only the rows that own a slot in range write: the
card's form of ``core.device_ops.append_token_masked``, with no host sync.

Row b writes ``k[b]`` and ``v[b]`` at ``(slot[b], off[b])`` of the pools
(cast to the pools' dtype) when ``mask[b]`` holds, ``0 <= slot[b] <
n_slots`` and ``0 <= off[b] < page``; every other row writes nothing.

  pool_k, pool_v: (n_slots, page, n_kv, hd); k, v: (B, n_kv, hd);
  slot, off: (B,) integers; mask: (B,) bool.  All on one device.

``kv_append`` checks its inputs, then dispatches by device: a CPU tensor
takes the plain PyTorch version ``kv_append_plain``, row by row; a CUDA
tensor runs the hand-written kernel (``csrc/kv_append.cu``) or raises.
The eager path selects the live rows with ``nonzero()``, which waits for
the card (``device_ops.live_rows``); the kernel reads the mask on the
card, so a decode step replayed as a CUDA graph can append.
``kv_append.launches`` counts the calls that launched it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import cuda_lib


def kv_append_plain(pool_k, pool_v, k, v, slot, off, mask):
    """The kernel's plain version: one row at a time, on the host's
    reading of the mask and the indices."""
    n_slots, page = pool_k.shape[:2]
    for b, (on, s, o) in enumerate(zip(mask.tolist(), slot.tolist(), off.tolist())):
        if on and 0 <= s < n_slots and 0 <= o < page:
            pool_k[s, o] = k[b].to(pool_k.dtype)
            pool_v[s, o] = v[b].to(pool_v.dtype)


def _check(pool_k, pool_v, k, v, slot, off, mask):
    named = [("pool_k", pool_k), ("pool_v", pool_v), ("k", k), ("v", v),
             ("slot", slot), ("off", off), ("mask", mask)]
    for name, t in named:
        if t.device != pool_k.device:
            raise ValueError(f"{name} is on {t.device}, the pool on {pool_k.device}")
    if pool_v.shape != pool_k.shape or pool_v.dtype != pool_k.dtype:
        raise ValueError("pool_k and pool_v differ in shape or dtype")
    b = k.shape[0]
    if v.shape != k.shape or tuple(k.shape[1:]) != tuple(pool_k.shape[2:]):
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} are not "
                         f"(B, {tuple(pool_k.shape[2:])})")
    for name, t in (("slot", slot), ("off", off), ("mask", mask)):
        if tuple(t.shape) != (b,):
            raise ValueError(f"{name} must be ({b},), got {tuple(t.shape)}")
    if mask.dtype != torch.bool:
        raise TypeError("mask must be bool")


def kv_append(pool_k, pool_v, k, v, slot, off, mask) -> None:
    """Append, in place, the rows ``mask`` and the ranges allow."""
    _check(pool_k, pool_v, k, v, slot, off, mask)
    if not pool_k.is_cuda:
        return kv_append_plain(pool_k, pool_v, k, v, slot, off, mask)
    if k.shape[0] == 0:
        return None
    if not (pool_k.is_contiguous() and pool_v.is_contiguous()):
        raise ValueError("the pools must be contiguous")
    k, v = k.contiguous(), v.contiguous()
    slot, off, mask = slot.long().contiguous(), off.long().contiguous(), mask.contiguous()
    err = cuda_lib.load().valet_kv_append(
        k.data_ptr(), v.data_ptr(), mask.data_ptr(), slot.data_ptr(), off.data_ptr(),
        pool_k.data_ptr(), pool_v.data_ptr(), k.shape[0], pool_k.shape[0],
        pool_k.shape[1], pool_k[0, 0].numel(), cuda_lib.dtype_code(k.dtype),
        cuda_lib.dtype_code(pool_k.dtype), torch.cuda.current_stream(k.device).cuda_stream)
    cuda_lib.check(err, "kv_append")
    kv_append.launches += 1


kv_append.launches = 0
