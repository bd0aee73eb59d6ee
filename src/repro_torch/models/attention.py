"""Attention: blockwise (flash-style) train/prefill path + decode paths.

* ``reference_attention`` — materializes the (Sq, Sk) score matrix.  Oracle
  and the plain version of the prefill kernel.
* ``blockwise_attention`` — flash-style online softmax over KV blocks in
  plain PyTorch.  Never materializes (Sq, Sk); windowed attention visits
  only the statically known band of KV blocks.  This is the full-forward
  path (``transformer.forward_hidden``); prefill goes through the
  hand-written kernel (``repro_torch.kernels.flash_attention``).
* ``decode_partial`` / ``combine_partials`` — flash-decoding: a partial
  softmax over a slice of the KV working set plus an exact combine.

Layouts follow the reference: q (B, S, Hq, D), k/v (B, S, Hkv, D).
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def _fold_gqa(q, n_kv):
    """(B, S, Hq, D) -> (B, S, Hkv, G, D)."""
    b, s, hq, d = q.shape
    return q.reshape(b, s, n_kv, hq // n_kv, d)


# --------------------------------------------------------------------------
# Oracle
# --------------------------------------------------------------------------

def reference_attention(q, k, v, *, causal=True, window=0, q_offset=0,
                        kv_valid=None):
    """Materialized-score attention.  O(Sq*Sk) memory.

    q: (B, Sq, Hq, D); k, v: (B, Sk, Hkv, D).
    ``q_offset``: global position of q[0] (for decode/chunked prefill).
    ``kv_valid``: optional (B, Sk) bool mask.
    """
    b, sq, hq, d = q.shape
    n_kv = k.shape[2]
    dev = q.device
    qf = _fold_gqa(q, n_kv).float()
    scale = 1.0 / math.sqrt(d)
    logits = torch.einsum("bqkgd,btkd->bkgqt", qf, k.float()) * scale
    qpos = torch.arange(sq, device=dev) + q_offset
    kpos = torch.arange(k.shape[1], device=dev)
    mask = torch.ones((sq, k.shape[1]), dtype=torch.bool, device=dev)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window > 0:
        mask &= kpos[None, :] > qpos[:, None] - window
    if kv_valid is not None:
        mask = mask[None] & kv_valid[:, None, :]
        mask = mask[:, None, None]                      # (B,1,1,Sq,Sk)
    else:
        mask = mask[None, None, None]
    logits = torch.where(mask, logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqt,btkd->bqkgd", p, v.float())
    return out.reshape(b, sq, hq, d).to(q.dtype)


# --------------------------------------------------------------------------
# Blockwise flash-style attention (full forward)
# --------------------------------------------------------------------------

def _block_mask(qpos, kpos, causal, window, kv_len):
    m = (kpos[None, :] < kv_len).expand(qpos.shape[0], kpos.shape[0])
    if causal:
        m = m & (kpos[None, :] <= qpos[:, None])
    if window > 0:
        m = m & (kpos[None, :] > qpos[:, None] - window)
    return m


def blockwise_attention(q, k, v, *, causal=True, window=0, q_block=512,
                        kv_block=512, q_offset=0):
    """Flash-style attention.  q: (B,Sq,Hq,D); k,v: (B,Sk,Hkv,D).

    Windowed + causal attention slices only the statically reachable KV band
    per q block: FLOPs are O(Sq * (window + q_block)) instead of O(Sq * Sk).
    Non-divisible lengths are padded internally and masked.
    """
    b, sq0, hq, d = q.shape
    sk0 = k.shape[1]
    q_block = min(q_block, sq0)
    kv_block = min(kv_block, sk0)
    qpad = (-sq0) % q_block
    kpad = (-sk0) % kv_block
    if qpad:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, qpad))
    if kpad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, kpad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, kpad))
    out = _blockwise_padded(q, k, v, causal=causal, window=window,
                            q_block=q_block, kv_block=kv_block,
                            q_offset=q_offset, kv_len=sk0)
    return out[:, :sq0] if qpad else out


def _blockwise_padded(q, k, v, *, causal, window, q_block, kv_block,
                      q_offset, kv_len):
    b, sq, hq, d = q.shape
    sk, n_kv = k.shape[1], k.shape[2]
    nq = sq // q_block
    g = hq // n_kv
    dev = q.device
    scale = 1.0 / math.sqrt(d)
    qf = _fold_gqa(q, n_kv)                             # (B,Sq,K,G,D)
    outs = []

    if window > 0 and causal:
        # Static band: ceil(window / kv_block) blocks behind + the q block.
        band = (window + kv_block - 1) // kv_block * kv_block + q_block
        band = min(band, sk)
        for qi in range(nq):
            qstart = qi * q_block
            qb = qf[:, qstart:qstart + q_block]
            kstart = min(max(qstart + q_block - band, 0), sk - band)
            kb = k[:, kstart:kstart + band]
            vb = v[:, kstart:kstart + band]
            qpos = qstart + torch.arange(q_block, device=dev) + q_offset
            kpos = kstart + torch.arange(band, device=dev)
            mask = _block_mask(qpos, kpos, causal, window, kv_len)
            logits = torch.einsum("bqkgd,btkd->bkgqt", qb.float(),
                                  kb.float()) * scale
            logits = torch.where(mask[None, None, None], logits, NEG_INF)
            p = torch.softmax(logits, dim=-1)
            out = torch.einsum("bkgqt,btkd->bqkgd", p, vb.float())
            outs.append(out.to(q.dtype))
        return torch.cat(outs, dim=1).reshape(b, sq, hq, d)

    # Full (causal or bidirectional): online softmax over all KV blocks.
    nk = sk // kv_block
    for qi in range(nq):
        qstart = qi * q_block
        qb = qf[:, qstart:qstart + q_block].float()
        qpos = qstart + torch.arange(q_block, device=dev) + q_offset
        m = torch.full((b, n_kv, g, q_block), NEG_INF, device=dev)
        l = torch.zeros((b, n_kv, g, q_block), device=dev)
        acc = torch.zeros((b, n_kv, g, q_block, d), device=dev)
        for ki in range(nk):
            kstart = ki * kv_block
            kb = k[:, kstart:kstart + kv_block]
            vb = v[:, kstart:kstart + kv_block]
            kpos = kstart + torch.arange(kv_block, device=dev)
            mask = _block_mask(qpos, kpos, causal, window, kv_len)
            logits = torch.einsum("bqkgd,btkd->bkgqt", qb, kb.float()) * scale
            logits = torch.where(mask[None, None, None], logits, NEG_INF)
            m_new = torch.maximum(m, logits.amax(dim=-1))
            p = torch.exp(logits - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqt,btkd->bkgqd", p, vb.float())
            m = m_new
        out = acc / l.clamp(min=1e-20)[..., None]           # (B,K,G,qb,D)
        outs.append(out.permute(0, 3, 1, 2, 4).to(q.dtype))  # (B,qb,K,G,D)
    return torch.cat(outs, dim=1).reshape(b, sq, hq, d)


# --------------------------------------------------------------------------
# Decode: partial softmax + exact combine (flash-decoding)
# --------------------------------------------------------------------------

def decode_partial(q, keys, values, valid):
    """Partial attention of a single query over a local KV slice.

    q: (B, Hq, D); keys/values: (B, T, Hkv, D); valid: (B, T) bool.
    Returns (m, l, acc): (B,K,G), (B,K,G), (B,K,G,D) float32 partials.
    """
    b, hq, d = q.shape
    n_kv = keys.shape[2]
    qf = q.reshape(b, n_kv, hq // n_kv, d).float()
    scale = 1.0 / math.sqrt(d)
    logits = torch.einsum("bkgd,btkd->bkgt", qf, keys.float()) * scale
    vmask = valid[:, None, None, :]
    logits = torch.where(vmask, logits, NEG_INF)
    m = logits.amax(dim=-1)
    p = torch.exp(logits - m[..., None])
    p = torch.where(vmask, p, 0.0)
    l = p.sum(dim=-1)
    acc = torch.einsum("bkgt,btkd->bkgd", p, values.float())
    return m, l, acc


def combine_partials(partials, out_dtype):
    """Exact softmax combine of stacked partials.

    partials: tuple of (m, l, acc) stacked on a leading shard axis:
    m,l: (N, B, K, G); acc: (N, B, K, G, D).  Returns (B, Hq, D).
    """
    m, l, acc = partials
    m_glob = m.amax(dim=0)
    corr = torch.exp(m - m_glob[None])
    l_glob = (l * corr).sum(dim=0)
    acc_glob = (acc * corr[..., None]).sum(dim=0)
    out = acc_glob / l_glob.clamp(min=1e-20)[..., None]
    b = m.shape[1]
    return out.reshape(b, -1, acc.shape[-1]).to(out_dtype)
