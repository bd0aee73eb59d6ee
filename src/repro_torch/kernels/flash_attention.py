"""Flash attention forward (prefill path).

Layout (the reference's kernel layout):
  q:    (BH, Sq, D)   BH = batch * q_heads, heads contiguous per batch entry
  k/v:  (BKV, Sk, D)  BKV = batch * kv_heads; q head ``i`` reads KV head
                      ``i // (BH // BKV)``
Causal and sliding-window masks count positions from 0 for both q and k.
Ragged lengths are fine (no multiple-of-the-tile requirement).

``flash_attention`` checks its inputs against what the kernel takes, then
dispatches by device: a CPU tensor takes the plain
PyTorch version ``flash_attention_plain``; a CUDA tensor launches the
hand-written kernel (``csrc/flash_attention.cu``) or raises on what the
kernel does not take.  ``flash_attention.launches`` counts kernel launches.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import cuda_lib
from repro_torch.models.attention import reference_attention

MAX_HEAD_DIM = 256


def flash_attention_plain(q, k, v, *, causal=True, window=0):
    """Materialized-score attention in the kernel layout: the plain version."""
    bh, sq, d = q.shape
    bkv, sk, _ = k.shape
    g = bh // bkv
    # each KV head with its query group is one GQA "batch" entry
    qm = q.reshape(bkv, g, sq, d).transpose(1, 2)          # (BKV, Sq, G, D)
    out = reference_attention(qm, k[:, :, None], v[:, :, None],
                              causal=causal, window=window)
    return out.transpose(1, 2).reshape(bh, sq, d)


def _check(q, k, v):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        cuda_lib.dtype_code(t.dtype)
        if t.data_ptr() % 16:
            raise ValueError("kernel needs 16-byte aligned tensors")
    bh, sq, d = q.shape
    bkv, sk, dk = k.shape
    if v.shape != k.shape or v.dtype != k.dtype:
        raise ValueError("k and v differ in shape or dtype")
    if dk != d or d % 8 or d > MAX_HEAD_DIM:
        raise ValueError(f"head_dim must be a multiple of 8 up to "
                         f"{MAX_HEAD_DIM} and match k, got {d}/{dk}")
    if bh % bkv:
        raise ValueError(f"BH={bh} is not a multiple of BKV={bkv}")


def flash_attention(q, k, v, *, causal=True, window=0):
    """q: (BH, Sq, D); k, v: (BKV, Sk, D).  Returns (BH, Sq, D) in q's dtype."""
    _check(q, k, v)
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    bh, sq, d = q.shape
    bkv, sk, _ = k.shape
    out = torch.empty_like(q)
    lib = cuda_lib.load()
    err = lib.valet_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        bh, sq, sk, d, bh // bkv, int(bool(causal)), int(window),
        cuda_lib.dtype_code(q.dtype), cuda_lib.dtype_code(k.dtype),
        1.0 / math.sqrt(d), torch.cuda.current_stream(q.device).cuda_stream)
    cuda_lib.check(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
