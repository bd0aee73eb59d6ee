"""Model assembly: segment-based layer stacks, forward and loss (PyTorch).

An architecture is a list of ``Segment``s — homogeneous runs of layers whose
parameters are stacked on a leading layer axis, as in the reference (the
weight bridge carries that layout over unchanged).  Heterogeneous patterns
(gemma3's 5:1 local:global, hymba's 3 global layers, llama-vision's
every-5th cross-attention layer, whisper's encoder and decoder) become short
segment lists.

Every kind of the reference is here: ``attn`` (dense, sliding-window, and
with a SwiGLU, GELU or MoE FFN), ``ssm`` (mamba2), ``hybrid`` (hymba's
parallel attention and SSD heads), ``xattn`` (llama-vision's gated
cross-attention layers), ``enc`` and ``dec`` (whisper).  ``lm_loss`` is the
training objective: the mean next-token NLL over sequence chunks, with
each layer and each loss chunk recomputed in the backward when
``ParallelCtx.remat`` is set.

Sharding is expressed as in the reference: ``param_pspecs`` gives each
parameter a placement (per dim, a mesh axis name or None) keyed on its path,
and ``ParallelCtx`` carries the rank mesh (``launch/mesh.py``) and its model
axis.  The sharded serve step (``launch/serve_step.py``) reads
them; the forward, the prefill and the loss here still run on one device
(the vocab-sharded loss and the sharded forward are ROADMAP items 13b-13c).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, List

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.bridge import tree_flatten, tree_unflatten
from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import (apply_rope, gelu_mlp, matmul, normal_,
                                       records_grad, rms_norm, swiglu)


# --------------------------------------------------------------------------
# Execution context
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class ParallelCtx:
    """Rank mesh + model axis + model-execution knobs.  The reference's
    batch axes (``dp_axes``, ``dp``, ``dp_size``) come with the sharded
    forward that reads them (ROADMAP item 13b)."""
    mesh: Any = None            # a launch.mesh.Mesh, or None on one device
    model_axis: str = "model"   # the axis of the placements' "model" entries
    remat: bool = True          # recompute each layer and loss chunk in the
                                # backward (read only under autograd)
    q_block: int = 512
    kv_block: int = 512
    loss_chunk: int = 256
    compute_dtype: Any = torch.float32
    attn_impl: str = "reference"          # unread, as in the reference


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


def encoder_segments(cfg: ArchConfig) -> List[Segment]:
    assert cfg.family == "audio"
    return [Segment("enc", cfg.encoder_layers, ffn="gelu")]


# --------------------------------------------------------------------------
# Init: stacked per segment, filled in place layer by layer
# --------------------------------------------------------------------------

def _ssm_params(n, cfg: ArchConfig, empty, zeros, device):
    """The ``ssm`` subtree of ``n`` stacked layers, weights unfilled.
    ``A_log``, ``D`` and ``dt_bias`` are float32 whatever the weights'
    dtype, as in the reference."""
    d, ssm = cfg.d_model, cfg.ssm
    d_inner, n_heads, d_bc = ssm_lib.ssm_dims(d, ssm)
    k = ssm.conv_kernel
    per_layer = lambda t: t.to(device).expand(n, -1).contiguous()
    return {"wz": empty(n, d, d_inner), "wx": empty(n, d, d_inner),
            "wbc": empty(n, d, d_bc), "wdt": empty(n, d, n_heads),
            "conv_x": empty(n, k, d_inner), "conv_bc": empty(n, k, d_bc),
            "conv_b": zeros(n, d_inner + d_bc),
            "A_log": per_layer(torch.log(torch.linspace(1.0, 16.0, n_heads))),
            "D": torch.ones((n, n_heads), dtype=torch.float32, device=device),
            "dt_bias": per_layer(torch.log(torch.expm1(
                torch.linspace(1e-3, 1e-1, n_heads)))),
            "gate_norm": zeros(n, d_inner),
            "out_proj": empty(n, d_inner, d)}


_SSM_RANDOM = {"wz": 0.02, "wx": 0.02, "wbc": 0.02, "wdt": 0.02,
               "conv_x": 0.5, "conv_bc": 0.5, "out_proj": 0.02}


def _attn_params(n, cfg: ArchConfig, empty):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    return {"wq": empty(n, d, cfg.n_heads * hd),
            "wk": empty(n, d, cfg.n_kv_heads * hd),
            "wv": empty(n, d, cfg.n_kv_heads * hd),
            "wo": empty(n, cfg.n_heads * hd, d)}


def _init_segment(seg: Segment, cfg: ArchConfig, generator, dtype, device):
    """One segment's stacked layer tree, the reference's ``init_layer``
    stacked over ``seg.count`` layers."""
    d = cfg.d_model
    n, f = seg.count, seg.d_ff or cfg.d_ff
    empty = lambda *shape: torch.empty(shape, dtype=dtype, device=device)
    zeros = lambda *shape: torch.zeros(shape, dtype=dtype, device=device)
    wo_scale = 0.02 / math.sqrt(2 * cfg.n_layers)
    layer = {"ln1": zeros(n, d)}
    random = []                     # (tensor, scale), filled in order
    projs = []
    if seg.kind in ("attn", "enc", "dec", "hybrid"):
        layer["attn"] = _attn_params(n, cfg, empty)
        projs.append(layer["attn"])
    if seg.kind == "dec":
        layer["lnx"] = zeros(n, d)
    if seg.kind in ("dec", "xattn"):
        layer["xattn"] = _attn_params(n, cfg, empty)
        projs.append(layer["xattn"])
    if seg.kind == "xattn":
        layer["xgate"] = torch.zeros((n,), dtype=torch.float32,
                                     device=device)
    for proj in projs:
        random += [(w, wo_scale if name == "wo" else 0.02)
                   for name, w in proj.items()]
    if seg.kind in ("ssm", "hybrid"):
        layer["ssm"] = _ssm_params(n, cfg, empty, zeros, device)
        random += [(layer["ssm"][name], scale)
                   for name, scale in _SSM_RANDOM.items()]
    if seg.kind == "hybrid":
        layer["attn_norm"] = zeros(n, d)
        layer["ssm_norm"] = zeros(n, d)
    if seg.ffn != "none":
        layer["ln2"] = zeros(n, d)
        if seg.ffn == "moe":
            layer["moe"] = moe_lib.init_moe(d, cfg.moe, n, generator=generator,
                                            dtype=dtype, device=device)
        else:
            if seg.ffn == "gelu":
                mlp = {"wi": empty(n, d, f), "wo": empty(n, f, d)}
            else:
                mlp = {"wgu": empty(n, d, 2 * f), "wd": empty(n, f, d)}
            layer["mlp"] = mlp
            random += [(w, 0.02) for w in mlp.values()]
    for i in range(n):
        for w, scale in random:
            normal_(w[i], generator, scale)
    return layer


def init_params(cfg: ArchConfig, *, generator: torch.Generator,
                dtype=torch.float32, device="cuda"):
    """Random parameters with the reference's tree, shapes, dtypes and
    scales: N(0, 0.02) weights, ``wo`` at 0.02 / sqrt(2 L), an f32 MoE
    router at 0.006, SSM conv weights at 0.5, zero norms, a zero f32
    cross-attention gate ``xgate``, and the reference's fixed SSM decay,
    skip and dt bias.  Each stacked tensor is allocated once and filled
    layer by layer in place, so a full-width init never holds two copies.
    ``generator`` must live on ``device``.  The numbers differ from the
    reference's ``jax.random`` draws; parity tests carry the reference's
    parameters over with ``repro_torch.bridge``."""
    d = cfg.d_model
    params = {"embed": normal_(torch.empty((cfg.padded_vocab, d),
                                           dtype=dtype, device=device),
                               generator),
              "final_ln": torch.zeros((d,), dtype=dtype, device=device),
              "segments": [_init_segment(seg, cfg, generator, dtype, device)
                           for seg in segments(cfg)]}
    if not cfg.tie_embeddings:
        params["unembed"] = normal_(torch.empty((d, cfg.padded_vocab),
                                                dtype=dtype, device=device),
                                    generator)
    if cfg.family == "audio":
        params["enc_segments"] = [
            _init_segment(seg, cfg, generator, dtype, device)
            for seg in encoder_segments(cfg)]
        params["enc_ln"] = torch.zeros((d,), dtype=dtype, device=device)
    return params


# --------------------------------------------------------------------------
# Placements (keyed on parameter path)
# --------------------------------------------------------------------------

# (path fragment, placement of the trailing dims): a mesh axis name shards
# that dim over the axis, None keeps it whole
_SPEC_RULES = [
    ("embed", ("model", None)),
    ("unembed", (None, "model")),
    ("experts/wg", ("model", None, None)),
    ("experts/wu", ("model", None, None)),
    ("experts/wd", ("model", None, None)),
    ("router", (None, None)),
    ("attn/wq", (None, "model")),
    ("attn/wk", (None, "model")),
    ("attn/wv", (None, "model")),
    ("attn/wo", ("model", None)),
    ("xattn/wq", (None, "model")),
    ("xattn/wk", (None, "model")),
    ("xattn/wv", (None, "model")),
    ("xattn/wo", ("model", None)),
    ("mlp/wgu", (None, "model")),
    ("mlp/wd", ("model", None)),
    ("mlp/wi", (None, "model")),
    ("mlp/wo", ("model", None)),
    ("shared/wgu", (None, "model")),
    ("shared/wd", ("model", None)),
    ("ssm/wz", (None, "model")),
    ("ssm/wx", (None, "model")),
    ("ssm/wdt", (None, "model")),
    ("ssm/wbc", (None, None)),
    ("ssm/conv_x", (None, "model")),
    ("ssm/out_proj", ("model", None)),
    ("ssm/gate_norm", ("model",)),
    ("ssm/A_log", ("model",)),
    ("ssm/D", ("model",)),
    ("ssm/dt_bias", ("model",)),
]


def _path_str(path) -> str:
    return "/".join(str(k) for k in path)


def _map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a params tree (dicts and lists; a tuple is a
    leaf, so that a placement tree maps too)."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


def param_pspecs(params_shape, cfg: ArchConfig, model_size: int = 16):
    """The placement tree of a params (shape-)tree: per leaf, a tuple with
    one entry per dim (a mesh axis name or None).

    Dimensions that don't divide the model-axis size fall back to
    replication (e.g. hymba's 50 SSD heads, 25 attention heads); K/V
    projections are replicated when the KV heads don't divide it."""
    kv_shardable = cfg.n_kv_heads % model_size == 0 if cfg.n_kv_heads else True
    kv_paths = ("attn/wk", "attn/wv", "xattn/wk", "xattn/wv")

    def spec_for(path, leaf):
        ps = _path_str(path)
        ndim = len(leaf.shape)
        if not kv_shardable and ps.endswith(kv_paths):
            return (None,) * ndim
        for frag, spec in _SPEC_RULES:
            if frag in ps:
                parts = [None] * (ndim - len(spec)) + list(spec)
                for i, ax in enumerate(parts):
                    if ax == "model" and leaf.shape[i] % model_size != 0:
                        parts[i] = None
                return tuple(parts)
        return (None,) * ndim

    return _map_with_path(spec_for, params_shape)


# --------------------------------------------------------------------------
# Layer application (full forward)
# --------------------------------------------------------------------------

def _attend(p, x, cfg: ArchConfig, ctx: ParallelCtx, *, window, causal=True,
            kv=None, positions=None, q_block=None, attention=None):
    """Projections + RoPE + attention + output projection.  ``kv``: the
    states a cross-attention reads (no RoPE then).  ``attention(q, k, v,
    causal=, window=)`` replaces the blockwise path (the prefill passes the
    flash kernel's op)."""
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
    if attention is None:
        out = attn_lib.blockwise_attention(
            q, k, v, causal=causal, window=window,
            q_block=q_block or ctx.q_block, kv_block=ctx.kv_block)
    else:
        out = attention(q, k, v, causal=causal, window=window)
    return matmul(out.reshape(b, s, cfg.n_heads * hd), p["wo"])


def _apply_ffn(p, x, cfg: ArchConfig, seg: Segment):
    """The layer's FFN: (out, aux loss); only MoE has an aux loss."""
    if seg.ffn == "moe":
        return moe_lib.moe_ffn(p["moe"], x, cfg.moe)
    if seg.ffn == "gelu":
        return gelu_mlp(p["mlp"], x), 0.0
    return swiglu(p["mlp"], x), 0.0


def add_mixer(p, x, a, y, cfg: ArchConfig):
    """The residual add of a layer's mixer: the attention output ``a``, the
    SSM output ``y``, or (hybrid, both given) the mean of the two after
    each branch's norm."""
    if y is None:
        return x + a
    if a is None:
        return x + y
    return x + 0.5 * (rms_norm(p["attn_norm"], a, cfg.norm_eps)
                      + rms_norm(p["ssm_norm"], y, cfg.norm_eps))


def xgate(p, x):
    """The cross-attention layer's gate ``tanh(xgate)`` in x's dtype."""
    return torch.tanh(p["xgate"].float()).to(x.dtype)


def apply_layer(p, x, seg: Segment, cfg: ArchConfig, ctx: ParallelCtx,
                frontend=None, positions=None, attention=None):
    """One layer.  x: (B, S, d); ``frontend``: the (B, N, d) states the
    cross-attention reads; ``attention`` as in ``_attend``, for the
    self-attention.  Returns (x, aux_loss)."""
    h = rms_norm(p["ln1"], x, cfg.norm_eps)
    if seg.kind == "xattn":
        x = x + xgate(p, x) * _attend(p["xattn"], h, cfg, ctx, window=0,
                                      causal=False, kv=frontend, q_block=256)
    else:
        a = y = None
        if seg.kind in ("attn", "enc", "dec", "hybrid"):
            a = _attend(p["attn"], h, cfg, ctx, window=seg.window,
                        causal=seg.kind != "enc", positions=positions,
                        attention=attention)
        if seg.kind in ("ssm", "hybrid"):
            y = ssm_lib.ssm_forward(p["ssm"], h, cfg.d_model, cfg.ssm)
        x = add_mixer(p, x, a, y, cfg)
        if seg.kind == "dec":
            hx = rms_norm(p["lnx"], x, cfg.norm_eps)
            x = x + _attend(p["xattn"], hx, cfg, ctx, window=0, causal=False,
                            kv=frontend, q_block=256)
    aux = 0.0
    if seg.ffn != "none":
        h2 = rms_norm(p["ln2"], x, cfg.norm_eps)
        out, aux = _apply_ffn(p, h2, cfg, seg)
        x = x + out
    return x, aux


def _unstack(p_stack, n):
    """The ``n`` layers of a stacked segment tree, as views.  Their
    gradients flow back to the stack as one ``stack`` per leaf (indexing
    each layer instead would make each layer's backward write a
    zero-filled gradient of the whole stack)."""
    leaves, structure = tree_flatten(p_stack)
    cols = [a.unbind(0) for a in leaves]
    return [tree_unflatten(structure, [c[i] for c in cols]) for i in range(n)]


def run_segments(seg_params, segs, x, cfg, ctx, frontend=None,
                 positions=None, attention=None):
    """Apply all segments, layer by layer over the stacked parameters.
    With ``ctx.remat`` under autograd each layer is checkpointed, as the
    reference's ``jax.checkpoint`` of its scan body: the backward keeps
    only each layer's input and recomputes the rest."""
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for p_stack, seg in zip(seg_params, segs):
        remat = ctx.remat and records_grad(x, *tree_flatten(p_stack)[0])
        for p_layer in _unstack(p_stack, seg.count):
            def layer(x, p_layer=p_layer, seg=seg):
                return apply_layer(p_layer, x, seg, cfg, ctx,
                                   frontend=frontend, positions=positions,
                                   attention=attention)
            x, a = (checkpoint(layer, x, use_reentrant=False) if remat
                    else layer(x))
            aux_total = aux_total + a
    return x, aux_total


# --------------------------------------------------------------------------
# Forward
# --------------------------------------------------------------------------

def _sinusoidal(s, d, device=None):
    """(s, d) sinusoidal positions: sin then cos of pos / 10000^(2i/d)."""
    pos = torch.arange(s, device=device, dtype=torch.float32)[:, None]
    return sinusoidal_at(pos, d)


def sinusoidal_at(pos, d):
    """Sinusoidal embedding of float positions ``pos`` (..., 1): (..., d)."""
    i = torch.arange(d // 2, device=pos.device, dtype=torch.float32)[None]
    ang = pos / (10_000.0 ** (2 * i / d))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def encode(params, frontend, cfg: ArchConfig, ctx: ParallelCtx,
           attention=None):
    """Whisper's encoder over the (B, N, d) frame embeddings: sinusoidal
    positions, the ``enc`` layers (``attention`` as in ``_attend``), then
    ``enc_ln``."""
    e = frontend.to(ctx.compute_dtype)
    e = e + _sinusoidal(e.shape[1], cfg.d_model, e.device).to(e.dtype)
    e, _ = run_segments(params["enc_segments"], encoder_segments(cfg), e, cfg,
                        ctx, attention=attention)
    return rms_norm(params["enc_ln"], e, cfg.norm_eps)


def forward_hidden(params, tokens, cfg: ArchConfig, ctx: ParallelCtx,
                   frontend=None):
    """Token ids (B, S) -> (final hidden states (B, S, d), aux loss).
    ``frontend``: whisper's (B, N, d) frame embeddings (required for the
    audio arch), or the (B, N, d) patch embeddings llama-vision's
    cross-attention layers read."""
    x = params["embed"][tokens].to(ctx.compute_dtype)
    enc_out = None
    if cfg.family == "audio":
        if frontend is None:
            raise ValueError("the audio arch needs frame embeddings")
        x = x + _sinusoidal(x.shape[1], cfg.d_model, x.device).to(x.dtype)
        enc_out = encode(params, frontend, cfg, ctx)
    elif frontend is not None:
        enc_out = frontend.to(ctx.compute_dtype)
    x, aux = run_segments(params["segments"], segments(cfg), x, cfg, ctx,
                          frontend=enc_out)
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


def prefill_logits(params, tokens, cfg: ArchConfig, ctx: ParallelCtx,
                   frontend=None):
    """Full forward returning the last position's logits (B, V), f32."""
    h, _ = forward_hidden(params, tokens, cfg, ctx, frontend=frontend)
    w = unembed_matrix(params, cfg).to(h.dtype)
    return mask_vocab_pad(matmul(h[:, -1], w).float(), cfg)


def lm_loss(params, tokens, labels, cfg: ArchConfig, ctx: ParallelCtx,
            frontend=None):
    """Mean next-token cross-entropy plus the MoE aux loss (an f32 scalar).

    Never holds (B, S, V) logits: the sequence is taken in
    ``ctx.loss_chunk`` slices, each chunk's logits formed as the reference
    forms them (the product in the hidden states' dtype, then f32) with the
    padded vocab tail masked, and the chunk recomputed in the backward
    under ``ctx.remat``.  Labels ``< 0`` are left out of the mean."""
    h, aux = forward_hidden(params, tokens, cfg, ctx, frontend=frontend)
    w = unembed_matrix(params, cfg).to(h.dtype)
    s = h.shape[1]
    chunk = min(ctx.loss_chunk, s)
    if s % chunk:
        raise ValueError(f"sequence length {s} is not a multiple of the "
                         f"loss chunk {chunk}")

    def chunk_nll(hs, ls):
        logits = mask_vocab_pad(matmul(hs, w).float(), cfg)
        lse = torch.logsumexp(logits, dim=-1)
        picked = logits.gather(-1, ls.clamp(min=0).long()[..., None])[..., 0]
        valid = ls >= 0
        return torch.where(valid, lse - picked, 0.0).sum(), valid.sum()

    remat = ctx.remat and records_grad(h, w)
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    count = torch.zeros((), dtype=torch.int64, device=h.device)
    for i in range(0, s, chunk):
        hs, ls = h[:, i:i + chunk], labels[:, i:i + chunk]
        nll, n = (checkpoint(chunk_nll, hs, ls, use_reentrant=False) if remat
                  else chunk_nll(hs, ls))
        total = total + nll
        count = count + n
    return total / torch.clamp(count, min=1) + aux
