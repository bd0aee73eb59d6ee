"""Decode path: per-layer caches (Valet paged pools / rings) plus an exact
cache-building prefill (PyTorch).

Layers are unrolled (heterogeneous caches per layer kind):

  full-attention layer   -> paged KV pool (the Valet-managed working set)
  sliding-window layer   -> ring buffer (bounded; no paging needed)
  SSM / hybrid layer     -> O(1) SSD state + conv ring per sequence (a hybrid
                            layer also has its attention pool or ring)
  cross-attn layer (vlm ``xattn``, audio ``dec``) -> static per-request
                            cross K/V, written once by the prefill

The serving engine (serve/engine.py) owns slot allocation, and its decode
batch (serve/batch.py) builds the caches here and runs the steps; this module
is the model's data plane: given block tables + append targets it computes
one decode step.  All paged layers share one block table — a logical page
allocation spans every paged layer (slot i of each layer's pool).

Caches are updated **in place** (the reference returns new arrays): a
decode step writes the pools, the rings, each SSM layer's state (right
after the layer, so a step never holds two states of more than one layer)
and ``lengths`` into the tensors ``caches`` holds, and returns ``caches``
itself.  So a step has fixed inputs and outputs, and the decode batch
replays it as one CUDA graph on the card (``serve/batch.py``).  The
prefill's caches are new tensors (its SSM states and cross K/V).  Given
``length``, the prefill takes a prompt padded past its length and is exact
for the first ``length`` positions with no host read of a device value, so
the decode batch replays it as one CUDA graph per padded length
(``pads_exactly`` says which archs it serves).

Kernels on this path: decode attention over the pool is the paged kernel
(``kernels/paged_attention.py``), reading KV through the block table with no
gathered copy; prefill attention is the flash kernel
(``kernels/flash_attention.py``): causal self-attention, and non-causal
cross-attention and whisper's encoder with ``Sk != Sq``; the SSM prefill's
scan is the SSD kernel (``kernels/ssd_scan.py``, through ``models/ssm.py``).
SSM decode, a decode step's cross-attention over the static cross K/V and
the capacity-bounded MoE dispatch (``models/moe.py``) are plain PyTorch (the
reference has no kernel for them); the dropless MoE's expert products are
the grouped-GEMM kernel (``kernels/moe_gemm.py``).  On CPU tensors every kernel
runs its plain PyTorch version.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List

import torch

from repro_torch.bridge import tree_map
from repro_torch.configs.base import ArchConfig
from repro_torch.core import device_ops as dev
from repro_torch.kernels.ops import flash_attention_op, paged_attention_op
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.attention import combine_partials, decode_partial
from repro_torch.models.layers import (apply_rope, gelu_mlp, matmul, rms_norm,
                                       swiglu)
from repro_torch.models.moe import moe_ffn, moe_ffn_dropless
from repro_torch.models.transformer import (ParallelCtx, _sinusoidal,
                                            add_mixer, encode, mask_vocab_pad,
                                            scale_embed, scale_logits, scale_q,
                                            scale_residual, segments,
                                            sinusoidal_at, unembed_matrix,
                                            xgate)


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
        c: Dict[str, Any] = {}
        if info.uses_paged:
            c["pool"] = dev.make_kv_pool(pool_slots, page, cfg.n_kv_heads,
                                         hd, dtype, device=device)
        if info.uses_ring:
            c["ring"] = dev.make_ring(batch, info.window, cfg.n_kv_heads,
                                      hd, dtype, device=device)
        if info.uses_ssm:
            c["ssm"] = ssm_lib.ssm_init_state(batch, cfg.d_model, cfg.ssm,
                                              dtype, device=device)
        if info.uses_cross:
            n = n_cross or cfg.n_frontend_tokens
            for key in ("cross_k", "cross_v"):
                c[key] = torch.zeros((batch, n, cfg.n_kv_heads, hd),
                                     dtype=dtype, device=device)
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
    q = scale_q(matmul(x, p["wq"]), cfg).reshape(b, cfg.n_heads, hd)
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
    return _attn_out(p, out.to(x.dtype), b)


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
    return _attn_out(p, out, b)


def _cross_attn_step(p, x, cache, cfg):
    """One query token per row over the row's static cross K/V."""
    b = x.shape[0]
    hd = cfg.resolved_head_dim
    q = matmul(x, p["wq"]).reshape(b, cfg.n_heads, hd)
    valid = torch.ones(cache["cross_k"].shape[:2], dtype=torch.bool,
                       device=x.device)
    m, l, acc = decode_partial(q, cache["cross_k"], cache["cross_v"], valid)
    out = combine_partials((m[None], l[None], acc[None]), x.dtype)
    return _attn_out(p, out, b)


def _ffn_step(p, x, cfg: ArchConfig, info: LayerInfo, active=None):
    """x: (T, d).  MoE routes all T rows in one call (T = the batch in
    decode, inactive rows too; B * S in prefill): the capacity, and so
    what is dropped, depends on T, as in the reference.  The dropless
    path drops nothing and computes experts for the ``active`` rows only
    (every row without it), so a row's output depends on no other row."""
    if info.ffn == "moe" and cfg.moe.dropless:
        return moe_ffn_dropless(p["moe"], x, cfg.moe, active=active,
                                with_aux=False)
    if info.ffn == "moe":
        return moe_ffn(p["moe"], x[:, None, :], cfg.moe)[0][:, 0, :]
    if info.ffn == "gelu":
        return gelu_mlp(p["mlp"], x)
    return swiglu(p["mlp"], x)


def decode_layer(p, x, info: LayerInfo, cache, cfg: ArchConfig,
                 ctx: ParallelCtx, step_args):
    """One layer's step; its caches are written in place."""
    h = rms_norm(p["ln1"], x, cfg.norm_eps)
    if info.kind == "xattn":
        x = x + xgate(p, x) * _cross_attn_step(p["xattn"], h, cache, cfg)
    else:
        a = y = None
        if info.kind in ("attn", "dec", "hybrid"):
            if info.uses_paged:
                a = _paged_attn_step(p["attn"], h, cache, cfg, step_args)
            else:
                a = _ring_attn_step(p["attn"], h, cache, cfg, step_args,
                                    info.window)
        if info.uses_ssm:
            state = cache["ssm"]
            y, new = ssm_lib.ssm_decode_step(p["ssm"], h, state, cfg.d_model,
                                             cfg.ssm)
            # into the state's own tensors at once: the layer's new state is
            # freed before the next layer makes its own
            state["h"].copy_(new["h"])
            state["conv"].copy_(new["conv"])
        x = add_mixer(p, x, a, y, cfg)
        if info.kind == "dec":
            hx = rms_norm(p["lnx"], x, cfg.norm_eps)
            x = x + _cross_attn_step(p["xattn"], hx, cache, cfg)
    if info.ffn != "none":
        h2 = rms_norm(p["ln2"], x, cfg.norm_eps)
        x = x + scale_residual(_ffn_step(p, h2, cfg, info, step_args["active"]),
                               cfg)
    return x


def decode_step(params, caches, tokens, cfg: ArchConfig, ctx: ParallelCtx,
                block_table, append_slot, append_off, active=None):
    """One decode step.  tokens: (B,).  Returns (logits, caches), the
    ``caches`` passed in, updated in place (the module docstring).

    ``active``: (B,) bool — inactive batch slots neither append KV nor
    advance their length (continuous batching with holes).  No step
    operation waits for the card on CUDA tensors, so the step can be
    captured as a CUDA graph; on the CPU the paged layers share one
    ``live_rows`` selection of the appending rows.
    """
    device = caches["lengths"].device
    tokens = torch.as_tensor(tokens, device=device)
    x = scale_embed(params["embed"][tokens].to(ctx.compute_dtype), cfg)
    lengths = caches["lengths"]
    if cfg.family == "audio":
        # sinusoidal position at each sequence's current length
        x = x + sinusoidal_at(lengths.float()[:, None],
                              cfg.d_model).to(x.dtype)
    if active is None:
        active = torch.ones(tokens.shape, dtype=torch.bool, device=device)
    active = torch.as_tensor(active, device=device)
    append_slot = torch.as_tensor(append_slot, device=device).long()
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
        # off the card one selection of the appending rows, shared by every
        # paged layer; on the card each append skips the others itself
        "rows": dev.live_rows(active, append_slot, paged[0].k.shape[0])
        if paged and device.type != "cuda" else None,
    }
    for info, cache in zip(infos, caches["layers"]):
        x = decode_layer(layer_params(params, info), x, info, cache, cfg, ctx,
                         step_args)

    x = rms_norm(params["final_ln"], x, cfg.norm_eps)
    w = unembed_matrix(params, cfg).to(x.dtype)
    logits = mask_vocab_pad(scale_logits(matmul(x, w).float(), cfg), cfg)
    lengths.add_(active.to(torch.int32))
    return logits, caches


# --------------------------------------------------------------------------
# Cache-building prefill (exact, unrolled)
# --------------------------------------------------------------------------

def _cross_prefill(xp, h, enc_out, cache, cfg):
    """A cross-attention layer's prefill: project the (B, N, d) encoder or
    frontend states into the layer's cross K/V (kept in ``cache`` for
    decode) and attend to them, non-causal, through the flash kernel."""
    b, s, _ = h.shape
    hd = cfg.resolved_head_dim
    cache["cross_k"] = matmul(enc_out, xp["wk"]).reshape(
        b, -1, cfg.n_kv_heads, hd)
    cache["cross_v"] = matmul(enc_out, xp["wv"]).reshape(
        b, -1, cfg.n_kv_heads, hd)
    q = matmul(h, xp["wq"]).reshape(b, s, cfg.n_heads, hd)
    a = flash_attention_op(q, cache["cross_k"], cache["cross_v"],
                           causal=False)
    return matmul(a.reshape(b, s, -1), xp["wo"])


def pads_exactly(cfg: ArchConfig) -> bool:
    """Whether ``prefill`` takes ``length``: whether a prompt padded past
    its length gives the caches and logits of the prompt alone.  Not with
    a frontend or cross-attention, and not where an MoE's capacity, and so
    what it drops, depends on the rows of the call."""
    infos = layer_infos(cfg)
    if cfg.family == "audio" or any(i.uses_cross for i in infos):
        return False
    return cfg.moe is None or cfg.moe.dropless or \
        not any(i.ffn == "moe" for i in infos)


def prefill(params, tokens, cfg: ArchConfig, ctx: ParallelCtx, caches,
            block_table, frontend=None, length=None):
    """Run the prompt through the model, filling every cache in place.

    tokens: (B, S) — equal prompt lengths per prefill batch.
    block_table: (B, P) pre-allocated slots for ceil(S/page) pages (plus the
    current partial page).  ``frontend``: whisper's (B, N, d) frame
    embeddings (required for the audio arch; its encoder runs here) or
    llama-vision's (B, N, d) patch embeddings.  Returns (last_logits,
    caches).

    ``length``: (B,) int64 on the device, each row's prompt length when
    ``tokens`` is padded past it (``pads_exactly`` archs only; P pages
    must cover S).  The result is the unpadded prompt's: attention is
    causal, so the padding after the prompt changes nothing before it;
    each pool row is written through the masked append up to the prompt's
    last page (zero past the prompt, as the unpadded write pads); a ring
    takes each slot's latest position before the length (zero where there
    is none); the SSM's steps past the length have dt = 0 and its conv
    ring takes the K - 1 raw rows before it; the dropless MoE computes and
    counts the prompt's rows only; the logits are the last prompt
    position's.  No operation reads a device value on the host.
    """
    device = caches["lengths"].device
    tokens = torch.as_tensor(tokens, device=device)
    b, s = tokens.shape
    hd = cfg.resolved_head_dim
    keep = active = None
    if length is not None:
        if frontend is not None or not pads_exactly(cfg):
            raise ValueError(f"{cfg.name}: a padded prefill is not exact here")
        # (B, S): the prompt's positions
        keep = torch.arange(s, device=device)[None] < length[:, None]
        active = keep.reshape(-1)
    x = scale_embed(params["embed"][tokens].to(ctx.compute_dtype), cfg)
    enc_out = None
    if cfg.family == "audio":
        if frontend is None:
            raise ValueError("the audio arch needs frame embeddings")
        x = x + _sinusoidal(s, cfg.d_model, device).to(x.dtype)
        enc_out = encode(params, torch.as_tensor(frontend, device=device),
                         cfg, ctx, attention=flash_attention_op)
    elif frontend is not None:
        enc_out = torch.as_tensor(frontend, device=device).to(
            ctx.compute_dtype)
    positions = torch.arange(s, device=device)[None]
    block_table = torch.as_tensor(block_table, device=device).long()
    new_layers = []
    for info, cache in zip(layer_infos(cfg), caches["layers"]):
        p = layer_params(params, info)
        cache = dict(cache)
        h = rms_norm(p["ln1"], x, cfg.norm_eps)
        a = y = None
        if info.kind in ("attn", "dec", "hybrid"):
            ap = p["attn"]
            q = scale_q(matmul(h, ap["wq"]), cfg).reshape(b, s, cfg.n_heads, hd)
            k = matmul(h, ap["wk"]).reshape(b, s, cfg.n_kv_heads, hd)
            v = matmul(h, ap["wv"]).reshape(b, s, cfg.n_kv_heads, hd)
            if cfg.rope_theta > 0:
                q = apply_rope(q, positions, cfg.rope_theta)
                k = apply_rope(k, positions, cfg.rope_theta)
            a = flash_attention_op(q, k, v, causal=True, window=info.window)
            a = matmul(a.reshape(b, s, -1), ap["wo"])
        if info.uses_ssm:
            y, cache["ssm"] = ssm_lib.ssm_forward(
                p["ssm"], h, cfg.d_model, cfg.ssm, return_state=True,
                length=length)

        if info.uses_paged and length is not None:
            _append_prompt(cache["pool"], k, v, keep, length, block_table)
        elif info.uses_paged:
            page = cache["pool"].k.shape[1]
            pad = (-s) % page
            kp = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
            vp = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
            npages = kp.shape[1] // page
            kp = kp.reshape(b, npages, page, cfg.n_kv_heads, hd)
            vp = vp.reshape(b, npages, page, cfg.n_kv_heads, hd)
            cache["pool"] = dev.write_prefill_pages(
                cache["pool"], kp, vp, block_table[:, :npages])
        if info.uses_ring and length is not None:
            _fill_ring(cache["ring"], k, v, length)
        elif info.uses_ring:
            ring = cache["ring"]
            w = ring.k.shape[1]
            take = min(w, s)
            tail = torch.arange(s - take, s, device=device)
            ring.k[:, tail % w] = k[:, tail].to(ring.k.dtype)
            ring.v[:, tail % w] = v[:, tail].to(ring.v.dtype)

        if info.kind == "xattn":
            x = x + xgate(p, x) * _cross_prefill(p["xattn"], h, enc_out,
                                                 cache, cfg)
        else:
            x = add_mixer(p, x, a, y, cfg)
            if info.kind == "dec":
                hx = rms_norm(p["lnx"], x, cfg.norm_eps)
                x = x + _cross_prefill(p["xattn"], hx, enc_out, cache, cfg)
        if info.ffn != "none":
            h2 = rms_norm(p["ln2"], x, cfg.norm_eps)
            x = x + scale_residual(_ffn_step(p, h2.reshape(b * s, -1), cfg,
                                             info, active).reshape(b, s, -1), cfg)
        new_layers.append(cache)

    x = rms_norm(params["final_ln"], x, cfg.norm_eps)
    if length is None:
        last = x[:, -1]
        lengths = torch.full((b,), s, dtype=torch.int32, device=device)
    else:
        last = x.gather(1, (length - 1)[:, None, None].expand(-1, 1, x.shape[-1]))[:, 0]
        lengths = length.to(torch.int32)
    w = unembed_matrix(params, cfg).to(x.dtype)
    logits = mask_vocab_pad(scale_logits(matmul(last, w).float(), cfg), cfg)
    return logits, {"layers": new_layers, "lengths": lengths}


def _append_prompt(pool, k, v, keep, length, block_table):
    """A padded prefill's K and V (B, S, n_kv, hd) into the pool: row t of
    a sequence at ``(block_table[t // page], t % page)``, for t up to the
    end of the prompt's last page; the rows past the prompt write zeros."""
    b, s = keep.shape
    page = pool.k.shape[1]
    if block_table.shape[1] * page < s:
        raise ValueError(f"{block_table.shape[1]} pages of {page} do not cover {s} rows")
    t = torch.arange(s, device=k.device)
    fill = t[None] < ((length + page - 1) // page * page)[:, None]
    slot = block_table.gather(1, (t // page)[None].expand(b, -1))
    kz, vz = (torch.where(keep[..., None, None], a, 0).reshape(b * s, *a.shape[2:])
              for a in (k, v))
    dev.append_token_masked(pool, kz, vz, slot.reshape(-1),
                            (t % page).repeat(b), fill.reshape(-1))


def _fill_ring(ring, k, v, length):
    """A ring after a padded prefill: slot j holds the K and V of the latest
    position p < length with p = j (mod w), zeros where there is none."""
    w = ring.k.shape[1]
    last = (length - 1)[:, None]
    pos = last - (last - torch.arange(w, device=k.device)) % w        # (B, w)
    idx = pos.clamp(min=0)[..., None, None].expand(-1, -1, *k.shape[2:])
    ok = (pos >= 0)[..., None, None]
    ring.k.copy_(torch.where(ok, k.gather(1, idx), 0))
    ring.v.copy_(torch.where(ok, v.gather(1, idx), 0))
