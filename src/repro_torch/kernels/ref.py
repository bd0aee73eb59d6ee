"""Plain PyTorch oracles for every kernel (the reference's signatures).

They delegate to the model-layer math (``repro_torch.models.attention``),
so the kernels are pinned to the same math the model path executes.
"""
from __future__ import annotations

from repro_torch.kernels.paged_attention import paged_attention_plain
from repro_torch.models.attention import reference_attention


def flash_attention_ref(q, k, v, *, causal=True, window=0):
    """q: (B, S, Hq, D); k, v: (B, S, Hkv, D) -> (B, S, Hq, D)."""
    return reference_attention(q, k, v, causal=causal, window=window)


def paged_attention_ref(q, k_pool, v_pool, block_table, lengths):
    """Decode over a page pool.

    q: (B, Hq, D); k_pool/v_pool: (n_slots, page, Hkv, D);
    block_table: (B, P) slot ids (-1 pad); lengths: (B,) valid tokens.
    Returns (B, Hq, D).
    """
    return paged_attention_plain(q, k_pool, v_pool, block_table, lengths)
