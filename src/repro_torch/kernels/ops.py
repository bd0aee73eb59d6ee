"""Model-facing wrappers around the hand-written kernels.

Each op takes the model layout, hides the layout shuffle and calls the
kernel's device-dispatching wrapper: on a CPU tensor the plain PyTorch
version runs, on a CUDA tensor the CUDA kernel launches (or raises).
"""
from __future__ import annotations

from repro_torch.kernels.flash_attention import flash_attention as _flash
from repro_torch.kernels.paged_attention import paged_attention as _paged


def flash_attention_op(q, k, v, *, causal=True, window=0):
    """q: (B, Sq, Hq, D); k, v: (B, Sk, Hkv, D) -> (B, Sq, Hq, D)."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    qk = q.transpose(1, 2).reshape(b * hq, sq, d).contiguous()
    kk = k.transpose(1, 2).reshape(b * hkv, sk, d).contiguous()
    vk = v.transpose(1, 2).reshape(b * hkv, sk, d).contiguous()
    out = _flash(qk, kk, vk, causal=causal, window=window)
    return out.reshape(b, hq, sq, d).transpose(1, 2)


def paged_attention_op(q, k_pool, v_pool, block_table, lengths):
    """q: (B, Hq, D) one token/seq; pools: (slots, page, Hkv, D)."""
    return _paged(q, k_pool, v_pool, block_table, lengths)
