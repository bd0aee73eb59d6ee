"""Decode path: per-layer caches (Valet paged pools / rings) plus an exact
cache-building prefill (PyTorch).

Layers are unrolled (heterogeneous caches per layer kind):

  full-attention layer   -> paged KV pool (the Valet-managed working set)
  sliding-window layer   -> ring buffer (bounded; no paging needed)

The SSM, hybrid and cross-attention kinds come with their ROADMAP items.
The control plane (serve/engine.py) owns slot allocation; this module is the
data plane: given block tables + append targets it computes one decode
step.  All paged layers share one block table — a logical page allocation
spans every paged layer (slot i of each layer's pool).

Caches are updated **in place** (the reference returns new arrays): the
pools and rings of ``caches`` are the same tensors after a step, and only
``lengths`` is a new tensor in the returned dict.

Kernels on this path: decode attention over the pool is the paged kernel
(``kernels/paged_attention.py``), reading KV through the block table with no
gathered copy; prefill attention is the flash kernel
(``kernels/flash_attention.py``).  On CPU tensors both run their plain
PyTorch versions.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List

import torch

from repro_torch.bridge import tree_map
from repro_torch.configs.base import ArchConfig
from repro_torch.core import device_ops as dev
from repro_torch.kernels.ops import flash_attention_op, paged_attention_op
from repro_torch.models.attention import combine_partials, decode_partial
from repro_torch.models.layers import (apply_rope, gelu_mlp, matmul, rms_norm,
                                       swiglu)
from repro_torch.models.transformer import (ParallelCtx, check_ported,
                                            mask_vocab_pad, segments,
                                            unembed_matrix)


@dataclass(frozen=True)
class LayerInfo:
    kind: str
    window: int
    ffn: str
    d_ff: int
    seg: int
    idx: int

    @property
    def uses_paged(self):
        return self.kind in ("attn", "dec", "hybrid") and self.window == 0

    @property
    def uses_ring(self):
        return self.kind in ("attn", "hybrid") and self.window > 0

    @property
    def uses_ssm(self):
        return self.kind in ("ssm", "hybrid")

    @property
    def uses_cross(self):
        return self.kind in ("xattn", "dec")


def layer_infos(cfg: ArchConfig) -> List[LayerInfo]:
    out = []
    for si, seg in enumerate(segments(cfg)):
        for i in range(seg.count):
            out.append(LayerInfo(seg.kind, seg.window, seg.ffn,
                                 seg.d_ff or cfg.d_ff, si, i))
    return out


def layer_params(params, info: LayerInfo):
    return tree_map(lambda a: a[info.idx], params["segments"][info.seg])


# --------------------------------------------------------------------------
# Cache init
# --------------------------------------------------------------------------

def init_caches(cfg: ArchConfig, batch: int, *, pool_slots: int, page: int,
                n_cross: int = 0, dtype=torch.float32,
                device="cuda") -> Dict[str, Any]:
    hd = cfg.resolved_head_dim
    layers = []
    for info in layer_infos(cfg):
        check_ported(info.kind, info.ffn)
        c: Dict[str, Any] = {}
        if info.uses_paged:
            c["pool"] = dev.make_kv_pool(pool_slots, page, cfg.n_kv_heads,
                                         hd, dtype, device=device)
        if info.uses_ring:
            c["ring"] = dev.make_ring(batch, info.window, cfg.n_kv_heads,
                                      hd, dtype, device=device)
        layers.append(c)
    return {"layers": layers,
            "lengths": torch.zeros((batch,), dtype=torch.int32,
                                   device=device)}


# --------------------------------------------------------------------------
# Per-layer decode compute
# --------------------------------------------------------------------------

def _qkv_one(p, x, cfg, positions):
    """x: (B, d) -> q (B,Hq,hd), k,v (B,Hkv,hd), roped at ``positions``."""
    b, d = x.shape
    hd = cfg.resolved_head_dim
    q = matmul(x, p["wq"]).reshape(b, cfg.n_heads, hd)
    k = matmul(x, p["wk"]).reshape(b, cfg.n_kv_heads, hd)
    v = matmul(x, p["wv"]).reshape(b, cfg.n_kv_heads, hd)
    if cfg.rope_theta > 0:
        q = apply_rope(q[:, None], positions[:, None], cfg.rope_theta)[:, 0]
        k = apply_rope(k[:, None], positions[:, None], cfg.rope_theta)[:, 0]
    return q, k, v


def _attn_out(p, out, b):
    return matmul(out.reshape(b, -1), p["wo"])


def _paged_attn_step(p, x, cache, cfg, step_args):
    """Full-attention decode over the Valet page pool: append, then the
    paged kernel reads the pool through the block table."""
    b = x.shape[0]
    q, k, v = _qkv_one(p, x, cfg, step_args["lengths"])
    pool = dev.append_token_masked(cache["pool"], k, v,
                                   step_args["append_slot"],
                                   step_args["append_off"],
                                   step_args["active"],
                                   rows=step_args["rows"])
    # decode attends to pos <= length (the token just appended); the
    # kernel masks pos < its length argument, hence lengths + 1
    out = paged_attention_op(q.contiguous(), pool.k, pool.v,
                             step_args["block_table"],
                             step_args["lengths_incl"])
    return _attn_out(p, out.to(x.dtype), b), {**cache, "pool": pool}


def _ring_attn_step(p, x, cache, cfg, step_args, window):
    b = x.shape[0]
    lengths = step_args["lengths"].long()
    q, k, v = _qkv_one(p, x, cfg, lengths)
    ring = cache["ring"]
    w = ring.k.shape[1]
    idx = lengths % w
    rows = torch.arange(b, device=x.device)
    ring.k[rows, idx] = k.to(ring.k.dtype)
    ring.v[rows, idx] = v.to(ring.v.dtype)
    # slot j holds the latest absolute position p_j <= length with
    # p_j = j (mod w); valid iff p_j >= 0 and p_j > length - window
    slot = torch.arange(w, device=x.device)[None]
    cur = lengths[:, None]
    abs_pos = cur - ((cur - slot) % w)
    valid = (abs_pos >= 0) & (abs_pos <= cur) & (abs_pos > cur - window)
    m, l, acc = decode_partial(q, ring.k, ring.v, valid)
    out = combine_partials((m[None], l[None], acc[None]), x.dtype)
    return _attn_out(p, out, b), {**cache, "ring": ring}


def _ffn_step(p, x, info: LayerInfo):
    if info.ffn == "gelu":
        return gelu_mlp(p["mlp"], x)
    return swiglu(p["mlp"], x)


def decode_layer(p, x, info: LayerInfo, cache, cfg: ArchConfig,
                 ctx: ParallelCtx, step_args):
    check_ported(info.kind, info.ffn)
    h = rms_norm(p["ln1"], x, cfg.norm_eps)
    new_cache = dict(cache)
    if info.uses_paged:
        a, new_cache = _paged_attn_step(p["attn"], h, new_cache, cfg,
                                        step_args)
    else:
        a, new_cache = _ring_attn_step(p["attn"], h, new_cache, cfg,
                                       step_args, info.window)
    x = x + a
    if info.ffn != "none":
        h2 = rms_norm(p["ln2"], x, cfg.norm_eps)
        x = x + _ffn_step(p, h2, info)
    return x, new_cache


def decode_step(params, caches, tokens, cfg: ArchConfig, ctx: ParallelCtx,
                block_table, append_slot, append_off, active=None):
    """One decode step.  tokens: (B,).  Returns (logits, caches).

    ``active``: (B,) bool — inactive batch slots neither append KV nor
    advance their length (continuous batching with holes).  Pools and rings
    are updated in place.
    """
    device = caches["lengths"].device
    if cfg.family == "audio":
        check_ported("dec")
    tokens = torch.as_tensor(tokens, device=device)
    x = params["embed"][tokens].to(ctx.compute_dtype)
    if active is None:
        active = torch.ones(tokens.shape, dtype=torch.bool, device=device)
    active = torch.as_tensor(active, device=device)
    append_slot = torch.as_tensor(append_slot, device=device).long()
    lengths = caches["lengths"]
    infos = layer_infos(cfg)
    paged = [c["pool"] for c in caches["layers"] if "pool" in c]
    step_args = {
        "lengths": lengths,
        "lengths_incl": (lengths + 1).to(torch.int32),
        "block_table": torch.as_tensor(block_table, device=device)
        .to(torch.int32).contiguous(),
        "append_slot": append_slot,
        "append_off": torch.as_tensor(append_off, device=device).long(),
        "active": active,
        # one selection of the appending rows, shared by every paged layer
        "rows": dev.live_rows(active, append_slot, paged[0].k.shape[0])
        if paged else None,
    }
    new_layers = []
    for info, cache in zip(infos, caches["layers"]):
        p = layer_params(params, info)
        x, cache = decode_layer(p, x, info, cache, cfg, ctx, step_args)
        new_layers.append(cache)

    x = rms_norm(params["final_ln"], x, cfg.norm_eps)
    w = unembed_matrix(params, cfg).to(x.dtype)
    logits = mask_vocab_pad(matmul(x, w).float(), cfg)
    new_len = lengths + active.to(torch.int32)
    return logits, {"layers": new_layers, "lengths": new_len}


# --------------------------------------------------------------------------
# Cache-building prefill (exact, unrolled)
# --------------------------------------------------------------------------

def prefill(params, tokens, cfg: ArchConfig, ctx: ParallelCtx, caches,
            block_table, frontend=None):
    """Run the prompt through the model, filling every cache in place.

    tokens: (B, S) — equal prompt lengths per prefill batch.
    block_table: (B, P) pre-allocated slots for ceil(S/page) pages (plus the
    current partial page).  Returns (last_logits, caches).
    """
    if cfg.family == "audio" or frontend is not None:
        check_ported("dec")
    device = caches["lengths"].device
    tokens = torch.as_tensor(tokens, device=device)
    b, s = tokens.shape
    hd = cfg.resolved_head_dim
    x = params["embed"][tokens].to(ctx.compute_dtype)
    positions = torch.arange(s, device=device)[None]
    block_table = torch.as_tensor(block_table, device=device).long()
    new_layers = []
    for info, cache in zip(layer_infos(cfg), caches["layers"]):
        check_ported(info.kind, info.ffn)
        p = layer_params(params, info)
        cache = dict(cache)
        h = rms_norm(p["ln1"], x, cfg.norm_eps)
        ap = p["attn"]
        q = matmul(h, ap["wq"]).reshape(b, s, cfg.n_heads, hd)
        k = matmul(h, ap["wk"]).reshape(b, s, cfg.n_kv_heads, hd)
        v = matmul(h, ap["wv"]).reshape(b, s, cfg.n_kv_heads, hd)
        if cfg.rope_theta > 0:
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)
        a = flash_attention_op(q, k, v, causal=True, window=info.window)
        a = matmul(a.reshape(b, s, -1), ap["wo"])

        if info.uses_paged:
            page = cache["pool"].k.shape[1]
            pad = (-s) % page
            kp = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
            vp = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
            npages = kp.shape[1] // page
            kp = kp.reshape(b, npages, page, cfg.n_kv_heads, hd)
            vp = vp.reshape(b, npages, page, cfg.n_kv_heads, hd)
            cache["pool"] = dev.write_prefill_pages(
                cache["pool"], kp, vp, block_table[:, :npages])
        if info.uses_ring:
            ring = cache["ring"]
            w = ring.k.shape[1]
            take = min(w, s)
            tail = torch.arange(s - take, s, device=device)
            ring.k[:, tail % w] = k[:, tail].to(ring.k.dtype)
            ring.v[:, tail % w] = v[:, tail].to(ring.v.dtype)

        x = x + a
        if info.ffn != "none":
            h2 = rms_norm(p["ln2"], x, cfg.norm_eps)
            x = x + _ffn_step(p, h2.reshape(b * s, -1), info).reshape(b, s, -1)
        new_layers.append(cache)

    x = rms_norm(params["final_ln"], x, cfg.norm_eps)
    w = unembed_matrix(params, cfg).to(x.dtype)
    logits = mask_vocab_pad(matmul(x[:, -1], w).float(), cfg)
    return logits, {"layers": new_layers,
                    "lengths": torch.full((b,), s, dtype=torch.int32,
                                          device=device)}
