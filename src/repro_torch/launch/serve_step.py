"""Sharded serve step: decode with the Valet page pool distributed across a
rank mesh.

Distribution plan (the reference's):

* batch over the DP axes; **KV pages round-robin over the KV axes** -- each
  rank is a "peer memory donor" holding a shard of every sequence's pages
  (page ``pg`` of a sequence lives on KV rank ``pg % kvr`` as its local page
  ``pg // kvr``);
* each peer computes a partial softmax over *its* pages (a one-sided read:
  no control-plane work on the peer) with the paged kernel's partial entry,
  and an exact flash-decoding combine over the KV axes costs one max and one
  sum all-reduce of a few KiB (``combine_partials_psum``);
* appends are masked to the owning peer (sender-driven placement);
* weights are Megatron-TP over ``model`` (``param_pspecs``), the MoE
  experts EP over it; per-token activations are replicated across
  ``model``.

The reference runs this as one SPMD program over global arrays, with the
collectives GSPMD and ``shard_map`` insert.  Here every rank runs
``serve_step`` on its local shards (``launch/mesh.py``) and the collectives
are written out: the vocab-parallel embedding's sum, one all-gather of the
column-parallel q, k and v, the sums after the row-parallel projections
(and the MoE experts'), the partials' combine, the SSM decode's gather of
its x columns for the replicated conv ring and its gate norm's sum, and the
all-gather of the vocab-parallel logits before the argmax.  Local shapes
are the global ones of ``decode_struct`` cut by their placements
(``mesh.local_block``): a rank's pool is (n, 1, 1, slots, page, kv, hd),
its block table (1, 1, B_loc, P_loc), its SSD state its part of (n, B, H,
P, N) (heads, else head_dim, else whole).  Pools, rings, SSD states and
conv rings are updated in place; the cross K/V (``xattn`` and ``dec``
layers) are read.

Shapes:
  decode_32k : batch over (pod,)data, pages over model.
  long_500k  : batch=1 -> pure sequence parallelism: pages over ALL axes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core import device_ops as dev
from repro_torch.kernels.paged_attention import paged_attention_partials
from repro_torch.models import ssm as ssm_lib
from repro_torch.models import transformer as T
from repro_torch.models.attention import (combine_partials,
                                          combine_partials_psum,
                                          decode_partial)
from repro_torch.models.layers import (apply_rope, gelu_mlp, matmul, rms_norm,
                                       row_parallel, swiglu)
from repro_torch.models.moe import moe_ffn
from repro_torch.models.transformer import ParallelCtx, segments


@dataclass(frozen=True)
class DecodePlan:
    batch_axes: Tuple[str, ...]
    kv_axes: Tuple[str, ...]
    page: int = 64
    headroom: float = 1.25
    kv_dtype: str = "bf16"        # bf16 | int8 (quantized page pool)

    def batch_spec(self):
        if not self.batch_axes:
            return None
        return self.batch_axes if len(self.batch_axes) > 1 else self.batch_axes[0]

    def kv_spec(self):
        return self.kv_axes if len(self.kv_axes) > 1 else self.kv_axes[0]


def plan_for(shape: ShapeConfig, mesh, kv_dtype: str = "bf16") -> DecodePlan:
    names = mesh.axis_names
    dp = tuple(n for n in names if n != "model")
    if shape.global_batch == 1:
        return DecodePlan(batch_axes=(), kv_axes=tuple(names),
                          kv_dtype=kv_dtype)
    return DecodePlan(batch_axes=dp, kv_axes=("model",), kv_dtype=kv_dtype)


def axis_sizes(mesh, axes) -> int:
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n


# --------------------------------------------------------------------------
# Cache geometry
# --------------------------------------------------------------------------

def cache_geometry(cfg: ArchConfig, shape: ShapeConfig, mesh,
                   plan: DecodePlan):
    b = shape.global_batch
    dp = axis_sizes(mesh, plan.batch_axes)
    kvr = axis_sizes(mesh, plan.kv_axes)
    b_loc = b // max(dp, 1)
    p_tot = -(-shape.seq_len // plan.page)             # pages per sequence
    p_loc = -(-p_tot // kvr)
    slots_loc = max(int(b_loc * p_loc * plan.headroom), b_loc)
    return dict(b=b, dp=dp, kvr=kvr, b_loc=b_loc, p_tot=p_tot, p_loc=p_loc,
                slots_loc=slots_loc)


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def decode_struct(cfg: ArchConfig, shape: ShapeConfig, mesh,
                  plan: DecodePlan, dtype=torch.bfloat16):
    """Global shapes (tensors on the ``meta`` device) and placements (per
    dim an axis name, a tuple of them, or None) for caches and step
    inputs."""
    geo = cache_geometry(cfg, shape, mesh, plan)
    hd = cfg.resolved_head_dim
    kv = cfg.n_kv_heads
    bsp = plan.batch_spec()
    ksp = plan.kv_spec()

    caches, specs = [], []
    for seg in segments(cfg):
        c, s = {}, {}
        n = seg.count
        if seg.kind in ("attn", "dec", "hybrid") and seg.window == 0:
            shp = (n, max(geo["dp"], 1), geo["kvr"], geo["slots_loc"],
                   plan.page, kv, hd)
            pool_dt = torch.int8 if plan.kv_dtype == "int8" else dtype
            c["pool_k"] = _meta(shp, pool_dt)
            c["pool_v"] = _meta(shp, pool_dt)
            s["pool_k"] = s["pool_v"] = (None, bsp, ksp, None, None, None, None)
            if plan.kv_dtype == "int8":
                sshp = shp[:-1]               # per (slot, pos, head) scales
                c["scale_k"] = _meta(sshp, dtype)
                c["scale_v"] = _meta(sshp, dtype)
                s["scale_k"] = s["scale_v"] = (None, bsp, ksp, None, None, None)
        if seg.kind in ("attn", "hybrid") and seg.window > 0:
            shp = (n, geo["b"], seg.window, kv, hd)
            c["ring_k"] = _meta(shp, dtype)
            c["ring_v"] = _meta(shp, dtype)
            s["ring_k"] = s["ring_v"] = (None, bsp, None, None, None)
        if seg.kind in ("ssm", "hybrid"):
            d_in, nh, d_bc = ssm_lib.ssm_dims(cfg.d_model, cfg.ssm)
            mp = mesh.shape["model"]
            c["ssm_h"] = _meta((n, geo["b"], nh, cfg.ssm.head_dim,
                                cfg.ssm.d_state), torch.float32)
            if nh % mp == 0:           # shard heads, else head_dim, else rep
                s["ssm_h"] = (None, bsp, "model", None, None)
            elif cfg.ssm.head_dim % mp == 0:
                s["ssm_h"] = (None, bsp, None, "model", None)
            else:
                s["ssm_h"] = (None, bsp, None, None, None)
            c["ssm_conv"] = _meta((n, geo["b"], cfg.ssm.conv_kernel - 1,
                                   d_in + d_bc), dtype)
            s["ssm_conv"] = (None, bsp, None, None)
        if seg.kind in ("xattn", "dec"):
            shp = (n, geo["b"], cfg.n_frontend_tokens, kv, hd)
            c["cross_k"] = _meta(shp, dtype)
            c["cross_v"] = _meta(shp, dtype)
            s["cross_k"] = s["cross_v"] = (None, bsp, None, None, None)
        caches.append(c)
        specs.append(s)

    i32 = torch.int32
    step = {
        "tokens": _meta((geo["b"],), i32),
        "block_table": _meta((max(geo["dp"], 1), geo["kvr"], geo["b_loc"],
                              geo["p_loc"]), i32),
        "app_slot": _meta((geo["b"],), i32),
        "app_off": _meta((geo["b"],), i32),
        "app_rank": _meta((geo["b"],), i32),
        "lengths": _meta((geo["b"],), i32),
    }
    step_specs = {
        "tokens": (bsp,),
        "block_table": (bsp, ksp, None, None),
        "app_slot": (bsp,),
        "app_off": (bsp,),
        "app_rank": (bsp,),
        "lengths": (bsp,),
    }
    return caches, specs, step, step_specs, geo


# --------------------------------------------------------------------------
# The sharded paged-attention inner (one layer)
# --------------------------------------------------------------------------

def _quantize_token(x, eps=1e-6):
    """(B, kv, hd) -> int8 values + per-(B, kv) scales in x's dtype.

    The scale is max|x| times the f32 reciprocal of 127, not divided by
    127: the reference's step is compiled, and XLA rewrites a division by
    a constant into that product (they differ in the last bit of ~5% of
    values)."""
    xf = x.float()
    recip = torch.tensor(np.float32(1) / np.float32(127), device=x.device)
    scale = (xf.abs().amax(dim=-1) * recip).clamp(min=eps)
    q = torch.round(xf / scale[..., None])
    return q.clamp(-127, 127).to(torch.int8), scale.to(x.dtype)


def owned_rows(app_rank, app_slot, mesh, plan: DecodePlan, n_slots):
    """The batch rows whose append lands on this rank: owned, with a slot
    in range (the reference drops the rest, ``mode="drop"``).  One host
    sync on CUDA tensors, so the serve step makes it once per step."""
    return dev.live_rows(app_rank == mesh.index(plan.kv_axes), app_slot,
                         n_slots)


def _paged_attn_sharded(cache, bt, q, k, v, app_slot, app_off, app_rank,
                        lengths, *, mesh, plan: DecodePlan, out_dtype,
                        rows=None):
    """Append + this rank's partial attention + the cross-peer combine.

    Local shapes: cache's pools (1, 1, slots, page, kv, hd) (one layer) and,
    for ``kv_dtype="int8"``, scales (1, 1, slots, page, kv); bt (1, 1,
    B_loc, P_loc); q (B_loc, Hq, hd); k/v (B_loc, kv, hd); app_*/lengths
    (B_loc,).  The pools are written in place; returns (B_loc, Hq, hd) in
    ``out_dtype``.  On CUDA tensors the partials come from the paged
    kernel's partial entry; on CPU tensors from its plain version.
    ``rows``: the appending rows (``owned_rows``), if the caller has them.
    """
    quant = plan.kv_dtype == "int8"
    kvr = axis_sizes(mesh, plan.kv_axes)
    my = mesh.index(plan.kv_axes)
    pk, pv = cache["pool_k"][0, 0], cache["pool_v"][0, 0]
    if rows is None:
        rows = owned_rows(app_rank, app_slot, mesh, plan, pk.shape[0])
    slot, off = app_slot.long()[rows], app_off.long()[rows]
    if quant:
        sk, sv = cache["scale_k"][0, 0], cache["scale_v"][0, 0]
        kq, ks = _quantize_token(k[rows])
        vq, vs = _quantize_token(v[rows])
        pk[slot, off], pv[slot, off] = kq, vq
        sk[slot, off], sv[slot, off] = ks, vs
        scales = dict(k_scale=sk, v_scale=sv)
    else:
        pk[slot, off] = k[rows].to(pk.dtype)
        pv[slot, off] = v[rows].to(pv.dtype)
        scales = {}
    # decode attends to pos <= length (the token just appended); the kernel
    # masks pos < its length argument, hence lengths + 1
    m, l, acc = paged_attention_partials(
        q.contiguous(), pk, pv, bt[0, 0].contiguous(),
        (lengths + 1).to(torch.int32), kvr=kvr, rank=my, **scales)
    return combine_partials_psum(m, l, acc, plan.kv_axes, out_dtype, mesh)


# --------------------------------------------------------------------------
# Migration data plane (paper §3.5 at pod scale)
# --------------------------------------------------------------------------

def make_migrate_step(mesh, plan: DecodePlan, pool_struct=None):
    """Data plane for sender-driven migration between peer shards.

    The control plane (Valet sender) picks victims by Non-Activity-Duration
    and a destination by power-of-two-choices; this step moves the selected
    page payloads one hop along the last KV axis's ring (rank i to i + 1)
    and installs them at the destination slots.  Reads keep hitting the
    source slots until the control plane cuts the block table over -- the
    data plane never blocks decode.

    Local shapes: pools (n, 1, 1, slots, page, kv, hd), updated in place;
    src/dst slots (1, 1, n_mig).
    """
    axis = plan.kv_axes[-1]

    def migrate_step(pool_k, pool_v, src_slots, dst_slots):
        src, dst = src_slots[0, 0].long(), dst_slots[0, 0].long()
        for pool in (pool_k, pool_v):
            local = pool[:, 0, 0]                    # (n, slots, page, kv, hd)
            local[:, dst] = mesh.ring_shift(local[:, src], axis)
        return pool_k, pool_v

    return migrate_step


# --------------------------------------------------------------------------
# Full serve step
# --------------------------------------------------------------------------

def make_serve_step(cfg: ArchConfig, shape: ShapeConfig, mesh,
                    plan: Optional[DecodePlan] = None,
                    compute_dtype=torch.bfloat16):
    """Build serve_step(params, caches, step) -> (next_tokens, caches).

    ``params`` are this rank's shards under ``param_pspecs`` (for example
    ``bridge.shard_to_torch``), ``caches`` and ``step`` its blocks of
    ``decode_struct``'s.  ``serve_step(..., with_logits=True)`` also returns
    the (B_loc, V) f32 logits the argmax read."""
    plan = plan or plan_for(shape, mesh)
    ctx = ParallelCtx(mesh=mesh, dp_axes=plan.batch_axes or ("data",),
                      compute_dtype=compute_dtype)
    mesh, ax = ctx.mesh, ctx.model_axis    # TP over the placements' "model"
    segs = segments(cfg)
    hd = cfg.resolved_head_dim
    widths = (cfg.n_heads * hd, cfg.n_kv_heads * hd, cfg.n_kv_heads * hd)

    def out_proj(p, out):
        return row_parallel(out.reshape(out.shape[0], -1), p["wo"],
                            cfg.n_heads * hd, mesh, ax)

    def qkv_one(p, x, lengths):
        """Column-parallel q/k/v, replicated across model for the page read:
        the cut ones' columns come back in one all-gather."""
        b = x.shape[0]
        cols = [matmul(x, p[n]) for n in ("wq", "wk", "wv")]
        cut = [c.shape[-1] != w for c, w in zip(cols, widths)]
        if any(cut):
            mine = [c for c, s in zip(cols, cut) if s]
            local = [c.shape[-1] for c in mine]
            every = mesh.all_gather(torch.cat(mine, dim=-1), ax, dim=-1)
            full = iter(part.reshape(b, -1) for part in
                        every.reshape(b, ctx.tp, sum(local)).split(local, dim=-1))
            cols = [next(full) if s else c for c, s in zip(cols, cut)]
        q = cols[0].reshape(b, cfg.n_heads, hd)
        k = cols[1].reshape(b, cfg.n_kv_heads, hd)
        v = cols[2].reshape(b, cfg.n_kv_heads, hd)
        if cfg.rope_theta > 0:
            pos = lengths.long()[:, None]
            q = apply_rope(q[:, None], pos, cfg.rope_theta)[:, 0]
            k = apply_rope(k[:, None], pos, cfg.rope_theta)[:, 0]
        return q, k, v

    def ring_attn(p, x, ring_k, ring_v, lengths):
        """Sliding-window decode, batch-local; the rings are replicated over
        model, so every model rank appends and attends alike."""
        b = x.shape[0]
        q, k, v = qkv_one(p, x, lengths)
        w = ring_k.shape[1]
        cur = lengths.long()
        rows = torch.arange(b, device=x.device)
        ring_k[rows, cur % w] = k.to(ring_k.dtype)
        ring_v[rows, cur % w] = v.to(ring_v.dtype)
        slot = torch.arange(w, device=x.device)[None]
        abs_pos = cur[:, None] - ((cur[:, None] - slot) % w)
        valid = (abs_pos >= 0) & (abs_pos <= cur[:, None])
        m, l, acc = decode_partial(q, ring_k, ring_v, valid)
        return out_proj(p, combine_partials((m[None], l[None], acc[None]),
                                            q.dtype))

    def paged_attn(p, x, cache, step):
        q, k, v = qkv_one(p, x, step["lengths"])
        return out_proj(p, _paged_attn_sharded(
            cache, step["block_table"], q, k, v, step["app_slot"],
            step["app_off"], step["app_rank"], step["lengths"], mesh=mesh,
            plan=plan, out_dtype=x.dtype, rows=step["rows"]))

    def self_attn(p, x, cache, seg, step):
        if seg.window == 0:
            return paged_attn(p, x, cache, step)
        return ring_attn(p, x, cache["ring_k"], cache["ring_v"],
                         step["lengths"])

    def cross_attn(p, x, ck, cv):
        """One token over the static cross K/V (replicated over model): q
        gathered whole, as the reference replicates it."""
        b = x.shape[0]
        q = matmul(x, p["wq"])
        if q.shape[-1] != widths[0]:
            q = mesh.all_gather(q, ax, dim=-1)
        q = q.reshape(b, cfg.n_heads, hd)
        valid = torch.ones(ck.shape[:2], dtype=torch.bool, device=x.device)
        m, l, acc = decode_partial(q, ck, cv, valid)
        return out_proj(p, combine_partials((m[None], l[None], acc[None]),
                                            x.dtype))

    def ffn(p, x, seg):
        if seg.ffn == "moe":
            return moe_ffn(p["moe"], x[:, None, :], cfg.moe, mesh=mesh,
                           model_axis=ax)[0][:, 0]
        mlp = gelu_mlp if seg.ffn == "gelu" else swiglu
        return mlp(p["mlp"], x, mesh, ax, seg.d_ff or cfg.d_ff)

    def layer(p, x, cache, seg, step):
        h = rms_norm(p["ln1"], x, cfg.norm_eps)
        if seg.kind == "xattn":
            x = x + T.xgate(p, x) * cross_attn(p["xattn"], h, cache["cross_k"],
                                               cache["cross_v"])
        else:
            a = y = None
            if seg.kind in ("attn", "dec", "hybrid"):
                a = self_attn(p["attn"], h, cache, seg, step)
            if seg.kind in ("ssm", "hybrid"):
                st = {"h": cache["ssm_h"], "conv": cache["ssm_conv"]}
                y, st = ssm_lib.ssm_decode_step(p["ssm"], h, st, cfg.d_model,
                                                cfg.ssm, mesh=mesh, axis=ax)
                cache["ssm_h"].copy_(st["h"])
                cache["ssm_conv"].copy_(st["conv"])
            x = T.add_mixer(p, x, a, y, cfg)
            if seg.kind == "dec":
                hx = rms_norm(p["lnx"], x, cfg.norm_eps)
                x = x + cross_attn(p["xattn"], hx, cache["cross_k"],
                                   cache["cross_v"])
        if seg.ffn != "none":
            h2 = rms_norm(p["ln2"], x, cfg.norm_eps)
            x = x + ffn(p, h2, seg)
        return x

    def serve_step(params, caches, step, *, with_logits=False):
        pools = [c["pool_k"] for c in caches if "pool_k" in c]
        if pools:                 # one selection of the appending rows
            step = {**step, "rows": owned_rows(step["app_rank"], step["app_slot"],
                                               mesh, plan, pools[0].shape[3])}
        x = T.embed(params, step["tokens"].long(), cfg, ctx)
        for si, (seg, cache) in enumerate(zip(segs, caches)):
            p_stack = params["segments"][si]
            for i in range(seg.count):
                p1 = T._map_with_path(lambda _, a: a[i], p_stack)
                c1 = {k: v[i] for k, v in cache.items()}
                x = layer(p1, x, c1, seg, step)
        x = rms_norm(params["final_ln"], x, cfg.norm_eps)
        logits = T.logits(params, x, cfg, ctx)
        # the first of equal maxima, as jnp.argmax
        tokens = torch.argmax(logits, dim=-1).to(torch.int32)
        if with_logits:
            return tokens, caches, logits
        return tokens, caches

    return serve_step, plan, ctx
