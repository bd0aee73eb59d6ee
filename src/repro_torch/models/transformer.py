"""Model assembly: segment-based layer stacks (forward only, PyTorch).

An architecture is a list of ``Segment``s — homogeneous runs of layers whose
parameters are stacked on a leading layer axis, as in the reference (the
weight bridge carries that layout over unchanged).  Heterogeneous patterns
(gemma3's 5:1 local:global) become short segment lists.

This slice ports the dense and sliding-window kinds (``attn`` segments with
SwiGLU or GELU FFNs).  The other kinds raise ``NotImplementedError`` naming
the ROADMAP item that brings them.  There is no mesh: sharding comes with
the multi-device launch layer (ROADMAP Queue 1 item 13).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, List

import torch

from repro_torch.bridge import tree_map
from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models.layers import (apply_rope, gelu_mlp, matmul, normal_,
                                       rms_norm, swiglu)


# --------------------------------------------------------------------------
# Execution context
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class ParallelCtx:
    """Model-execution knobs (single device; no mesh yet)."""
    remat: bool = True                    # unread until training is ported
    q_block: int = 512
    kv_block: int = 512
    loss_chunk: int = 256
    compute_dtype: Any = torch.float32
    attn_impl: str = "reference"          # unread, as in the reference


_NOT_PORTED = {
    "moe": "ROADMAP Queue 1 item 10 (MoE)",
    "ssm": "ROADMAP Queue 1 item 8 (SSM archs)",
    "hybrid": "ROADMAP Queue 1 item 8 (SSM archs)",
    "xattn": "ROADMAP Queue 1 item 11 (cross-attention kinds)",
    "dec": "ROADMAP Queue 1 item 11 (cross-attention kinds)",
    "enc": "ROADMAP Queue 1 item 11 (cross-attention kinds)",
}


def check_ported(kind: str, ffn: str = "swiglu") -> None:
    """Raise for a layer kind or FFN this slice does not port yet."""
    for what in (kind, ffn):
        if what in _NOT_PORTED:
            raise NotImplementedError(
                f"{what!r} layers are not ported yet: {_NOT_PORTED[what]}")


# --------------------------------------------------------------------------
# Segments
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class Segment:
    kind: str            # attn | ssm | hybrid | xattn | enc | dec
    count: int
    window: int = 0      # 0 = full attention
    ffn: str = "swiglu"  # swiglu | moe | gelu | none
    d_ff: int = 0        # 0 -> cfg.d_ff


def segments(cfg: ArchConfig) -> List[Segment]:
    return [s for s in _segments(cfg) if s.count > 0]


def _segments(cfg: ArchConfig) -> List[Segment]:
    if cfg.family == "ssm":
        return [Segment("ssm", cfg.n_layers, ffn="none")]

    if cfg.family == "moe":
        segs = []
        if cfg.n_dense_layers:
            segs.append(Segment("attn", cfg.n_dense_layers, ffn="swiglu",
                                d_ff=cfg.dense_d_ff))
        segs.append(Segment("attn", cfg.n_layers - cfg.n_dense_layers,
                            ffn="moe"))
        return segs

    if cfg.family == "hybrid":
        # hymba: global full attention at layers {0, mid, last}, SWA elsewhere
        l = cfg.n_layers
        mid = l // 2 - 1
        segs = [Segment("hybrid", 1, window=0)]
        segs.append(Segment("hybrid", mid - 1, window=cfg.window))
        segs.append(Segment("hybrid", 1, window=0))
        segs.append(Segment("hybrid", l - mid - 2, window=cfg.window))
        segs.append(Segment("hybrid", 1, window=0))
        return segs

    if cfg.family == "vlm":
        # every 5th layer is a gated cross-attention layer
        segs = []
        n_groups = cfg.n_layers // cfg.xattn_every
        for _ in range(n_groups):
            segs.append(Segment("attn", cfg.xattn_every - 1))
            segs.append(Segment("xattn", 1))
        rem = cfg.n_layers - n_groups * cfg.xattn_every
        if rem:
            segs.append(Segment("attn", rem))
        return segs

    if cfg.family == "audio":
        return [Segment("dec", cfg.n_layers, ffn="gelu")]

    # dense: uniform or local:global interleave
    if cfg.global_every:
        per = cfg.global_every
        segs = []
        full_groups = cfg.n_layers // per
        for _ in range(full_groups):
            segs.append(Segment("attn", per - 1, window=cfg.window))
            segs.append(Segment("attn", 1, window=0))
        rem = cfg.n_layers - full_groups * per
        if rem > 1:
            segs.append(Segment("attn", rem - 1, window=cfg.window))
        if rem >= 1:
            segs.append(Segment("attn", 1, window=0))
        return segs
    return [Segment("attn", cfg.n_layers, window=cfg.window)]


# --------------------------------------------------------------------------
# Init: stacked per segment, filled in place layer by layer
# --------------------------------------------------------------------------

def init_params(cfg: ArchConfig, *, generator: torch.Generator,
                dtype=torch.float32, device="cuda"):
    """Random parameters with the reference's shapes and scales: N(0, 0.02)
    weights, ``wo`` at 0.02 / sqrt(2 L), zero norms.  Each stacked tensor is
    allocated once and filled layer by layer in place, so a full-width init
    never holds two copies.  ``generator`` must live on ``device``.  The
    numbers differ from the reference's ``jax.random`` draws; parity tests
    carry the reference's parameters over with ``repro_torch.bridge``."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    empty = lambda *shape: torch.empty(shape, dtype=dtype, device=device)
    zeros = lambda *shape: torch.zeros(shape, dtype=dtype, device=device)
    params = {"embed": normal_(empty(cfg.padded_vocab, d), generator),
              "final_ln": zeros(d), "segments": []}
    wo_scale = 0.02 / math.sqrt(2 * cfg.n_layers)
    for seg in segments(cfg):
        check_ported(seg.kind, seg.ffn)
        n, f = seg.count, seg.d_ff or cfg.d_ff
        attn = {"wq": empty(n, d, cfg.n_heads * hd),
                "wk": empty(n, d, cfg.n_kv_heads * hd),
                "wv": empty(n, d, cfg.n_kv_heads * hd),
                "wo": empty(n, cfg.n_heads * hd, d)}
        if seg.ffn == "gelu":
            mlp = {"wi": empty(n, d, f), "wo": empty(n, f, d)}
        else:
            mlp = {"wgu": empty(n, d, 2 * f), "wd": empty(n, f, d)}
        for i in range(n):
            for name, w in attn.items():
                normal_(w[i], generator, wo_scale if name == "wo" else 0.02)
            for w in mlp.values():
                normal_(w[i], generator)
        params["segments"].append({"ln1": zeros(n, d), "attn": attn,
                                   "ln2": zeros(n, d), "mlp": mlp})
    if not cfg.tie_embeddings:
        params["unembed"] = normal_(empty(d, cfg.padded_vocab), generator)
    return params


# --------------------------------------------------------------------------
# Layer application (full forward)
# --------------------------------------------------------------------------

def _attend(p, x, cfg: ArchConfig, ctx: ParallelCtx, *, window, causal=True,
            kv=None, positions=None, q_block=None):
    """Projections + RoPE + blockwise attention + output projection."""
    b, s, d = x.shape
    hd = cfg.resolved_head_dim
    src = kv if kv is not None else x
    q = matmul(x, p["wq"]).reshape(b, s, cfg.n_heads, hd)
    k = matmul(src, p["wk"]).reshape(b, src.shape[1], cfg.n_kv_heads, hd)
    v = matmul(src, p["wv"]).reshape(b, src.shape[1], cfg.n_kv_heads, hd)
    if kv is None and cfg.rope_theta > 0:
        pos = positions if positions is not None else \
            torch.arange(s, device=x.device)[None]
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    out = attn_lib.blockwise_attention(
        q, k, v, causal=causal, window=window,
        q_block=q_block or ctx.q_block, kv_block=ctx.kv_block)
    return matmul(out.reshape(b, s, cfg.n_heads * hd), p["wo"])


def _apply_ffn(p, x, seg: Segment):
    if seg.ffn == "gelu":
        return gelu_mlp(p["mlp"], x)
    return swiglu(p["mlp"], x)


def apply_layer(p, x, seg: Segment, cfg: ArchConfig, ctx: ParallelCtx,
                frontend=None, positions=None):
    """One layer.  x: (B, S, d).  Returns (x, aux_loss)."""
    check_ported(seg.kind, seg.ffn)
    h = rms_norm(p["ln1"], x, cfg.norm_eps)
    x = x + _attend(p["attn"], h, cfg, ctx, window=seg.window,
                    positions=positions)
    if seg.ffn != "none":
        h2 = rms_norm(p["ln2"], x, cfg.norm_eps)
        x = x + _apply_ffn(p, h2, seg)
    return x, 0.0


def run_segments(seg_params, segs, x, cfg, ctx, frontend=None,
                 positions=None):
    """Apply all segments, layer by layer over the stacked parameters."""
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for p_stack, seg in zip(seg_params, segs):
        for i in range(seg.count):
            p_layer = tree_map(lambda a: a[i], p_stack)
            x, a = apply_layer(p_layer, x, seg, cfg, ctx, frontend=frontend,
                               positions=positions)
            aux_total = aux_total + a
    return x, aux_total


# --------------------------------------------------------------------------
# Forward
# --------------------------------------------------------------------------

def forward_hidden(params, tokens, cfg: ArchConfig, ctx: ParallelCtx,
                   frontend=None):
    """Token ids (B, S) -> final hidden states (B, S, d)."""
    if cfg.family == "audio":
        check_ported("dec")
    x = params["embed"][tokens].to(ctx.compute_dtype)
    x, aux = run_segments(params["segments"], segments(cfg), x, cfg, ctx,
                          frontend=frontend)
    x = rms_norm(params["final_ln"], x, cfg.norm_eps)
    return x, aux


def unembed_matrix(params, cfg: ArchConfig):
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["unembed"]


def mask_vocab_pad(logits, cfg: ArchConfig):
    """-1e30 the padded vocab tail (see ArchConfig.padded_vocab)."""
    if cfg.padded_vocab == cfg.vocab:
        return logits
    ids = torch.arange(logits.shape[-1], device=logits.device)
    return torch.where(ids < cfg.vocab, logits, -1e30)
