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
and ``ParallelCtx`` carries the rank mesh (``launch/mesh.py``), its batch
and model axes and ``seq_parallel``.  The reference runs one SPMD program
over global arrays and lets GSPMD insert the collectives; here each rank
runs the forward on its local shards (its rows of the batch, its blocks of
the weights) and the collectives are written out: Megatron TP over the
model axis (column-parallel projections, row-parallel ones summed), the
vocab-parallel embedding and logits, expert parallelism in the MoE FFN,
and, under ``seq_parallel``, residuals cut on the sequence between layers
(``Rows``: each mixer and FFN gathers the sequence and keeps its rows of
the sum).  A dim that ``param_pspecs`` leaves whole takes the unsharded
path.  The loss (``lm_loss``) is vocab-sharded on a mesh, its mean taken
over the global batch.

Under autograd every collective is differentiable (``launch/mesh.py``):
a value replicated over the model axis carries the whole cotangent on
every rank, and where it enters rank-local work (a column-parallel
product, a slice by rank, a parameter applied to the rank's rows under
``seq_parallel``) it passes ``mesh.enter``, whose backward sums the
ranks' parts.  Each rank's gradients are then its shards' over its rows
of the batch; the optimizer sums them over the batch axes
(``optim.adamw``).
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Any, List, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.bridge import tree_flatten, tree_unflatten
from repro_torch.configs.base import ArchConfig
from repro_torch.launch.mesh import Tape
from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import (apply_rope, col_parallel, gelu_mlp,
                                       matmul, normal_, model_ranks,
                                       records_grad, rms_norm, row_parallel,
                                       swiglu)


# --------------------------------------------------------------------------
# Execution context
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class ParallelCtx:
    """Rank mesh + axis names + model-execution knobs."""
    mesh: Any = None            # a launch.mesh.Mesh, or None on one device
    dp_axes: Tuple[str, ...] = ("data",)
    model_axis: str = "model"   # the axis of the placements' "model" entries
    remat: bool = True          # recompute each layer and loss chunk in the
                                # backward (read only under autograd)
    q_block: int = 512
    kv_block: int = 512
    loss_chunk: int = 256
    compute_dtype: Any = torch.float32
    attn_impl: str = "reference"          # unread, as in the reference
    seq_parallel: bool = False            # cut residuals on S over model
    save_collectives: bool = False        # under remat, keep the outputs of
                                          # the self-attention's and FFN's
                                          # collectives (the reference's
                                          # attn_out/mlp_out policy), so the
                                          # recompute does not move them

    def residual_spec(self):
        """Layer-boundary placement of a (B, S, d) activation."""
        return (self.dp, self.model_axis if self.seq_parallel else None,
                None)

    @property
    def dp(self):
        """The batch axes as one placement entry."""
        return self.dp_axes if len(self.dp_axes) > 1 else self.dp_axes[0]

    @property
    def tp(self) -> int:
        """Ranks on the model axis (1 without a mesh)."""
        return model_ranks(self.mesh, self.model_axis)[0]

    def dp_size(self) -> int:
        """Ranks over the batch axes (1 without a mesh)."""
        return 1 if self.mesh is None else self.mesh.axis_size(self.dp_axes)


@dataclass(frozen=True)
class Rows:
    """The rows of a (B, S, ...) activation that this rank holds between
    layers (``residual_spec``), and the moves between them and the whole
    sequence every rank of the model axis shares: all S, or under
    ``seq_parallel`` (with more than one model rank) its block of
    ``ceil(S / tp)`` rows, the last block padded past S.  Every reference
    ``shard(x, ctx, *ctx.residual_spec())`` is a ``take`` here, and a
    mixer's or FFN's replicated input a ``gather``."""
    ctx: ParallelCtx
    s: int

    @property
    def cut(self) -> bool:
        """``residual_spec`` cuts S, over more than one rank."""
        return self.ctx.residual_spec()[1] is not None and self.ctx.tp > 1

    def take(self, x):
        """The whole sequence (replicated over model) -> this rank's rows."""
        if not self.cut:
            return x
        tp = self.ctx.tp
        n = -(-self.s // tp)
        x = self.ctx.mesh.enter(x, self.ctx.model_axis)
        if n * tp != x.shape[1]:
            x = F.pad(x, (0, 0) * (x.dim() - 2) + (0, n * tp - x.shape[1]))
        return x[:, self.ctx.mesh.index(self.ctx.model_axis) * n:][:, :n]

    def gather(self, x):
        """This rank's rows -> the whole sequence."""
        if not self.cut:
            return x
        whole = self.ctx.mesh.all_gather(x, self.ctx.model_axis, dim=1)
        return whole[:, :self.s]

    def param(self, w):
        """A replicated parameter applied to this rank's rows."""
        return self.ctx.mesh.enter(w, self.ctx.model_axis) if self.cut else w

    def params(self, p):
        """A layer's tree with the parameters it applies to the rank's rows
        (its norms and cross-attention gate) through ``param``."""
        if not self.cut:
            return p
        return {k: self.param(v) if k in _ROW_PARAMS else v
                for k, v in p.items()}


# the parameters a layer applies to its residual rows
_ROW_PARAMS = frozenset({"ln1", "lnx", "ln2", "attn_norm", "ssm_norm", "xgate"})


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
    flash kernel's op).

    On a rank of a mesh ``x`` and ``kv`` are whole (replicated over model)
    and so is the output; the reference's four TP branches: q by heads
    where the heads divide the model axis, K/V too where theirs do, else
    K/V whole and repeated to the query heads; MHA whose heads do not
    divide it zero-padded to the next multiple; else attention whole on
    every rank."""
    b, s, d = x.shape
    hd = cfg.resolved_head_dim
    src = kv if kv is not None else x
    tp, mesh, ax = ctx.tp, ctx.mesh, ctx.model_axis
    q_shardable = cfg.n_heads % tp == 0
    kv_shardable = cfg.n_kv_heads % tp == 0
    q = col_parallel(x, p["wq"], cfg.n_heads * hd, mesh, ax)
    k = col_parallel(src, p["wk"], cfg.n_kv_heads * hd, mesh, ax)
    v = col_parallel(src, p["wv"], cfg.n_kv_heads * hd, mesh, ax)
    if tp > 1 and not q_shardable and q.shape[-1] != cfg.n_heads * hd:
        q = mesh.all_gather(q, ax, dim=-1)      # the heads' columns, whole
    q = q.reshape(b, s, -1, hd)
    k = k.reshape(b, src.shape[1], -1, hd)
    v = v.reshape(b, src.shape[1], -1, hd)
    if kv is None and cfg.rope_theta > 0:
        pos = positions if positions is not None else \
            torch.arange(s, device=x.device)[None]
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)

    n_pad = 0
    if tp > 1 and q_shardable and not kv_shardable:
        # K/V whole: each local query head takes its KV head (the
        # reference's repeat to the query heads, then its shard of them)
        hl = q.shape[2]
        first = mesh.index(ax) * hl
        idx = torch.arange(first, first + hl, device=x.device) // \
            (cfg.n_heads // cfg.n_kv_heads)
        k, v = mesh.enter(k, ax)[:, :, idx], mesh.enter(v, ax)[:, :, idx]
    elif tp > 1 and not q_shardable and cfg.n_heads == cfg.n_kv_heads:
        # MHA with heads that do not divide TP (whisper 20H): zero-pad to
        # the next multiple and take this rank's heads; a zero query over
        # zero keys and values gives zeros, sliced off below
        hl = -(-cfg.n_heads // tp)
        n_pad = hl * tp - cfg.n_heads
        first = mesh.index(ax) * hl
        q, k, v = (F.pad(mesh.enter(t, ax), (0, 0, 0, n_pad))
                   [:, :, first:first + hl] for t in (q, k, v))
    if attention is None:
        out = attn_lib.blockwise_attention(
            q, k, v, causal=causal, window=window,
            q_block=q_block or ctx.q_block, kv_block=ctx.kv_block)
    else:
        out = attention(q, k, v, causal=causal, window=window)
    if n_pad:
        out = mesh.all_gather(out, ax, dim=2)[:, :, :cfg.n_heads]
    return row_parallel(out.reshape(b, s, -1), p["wo"], cfg.n_heads * hd,
                        mesh, ax)


def _apply_ffn(p, x, cfg: ArchConfig, ctx: ParallelCtx, seg: Segment):
    """The layer's FFN: (out, aux loss); only MoE has an aux loss.  On a
    rank of a mesh ``x`` and the output are whole, replicated over model."""
    if seg.ffn == "moe":
        return moe_lib.moe_ffn(p["moe"], x, cfg.moe, mesh=ctx.mesh,
                               model_axis=ctx.model_axis,
                               dp_axes=ctx.dp_axes)
    f = seg.d_ff or cfg.d_ff
    mlp = gelu_mlp if seg.ffn == "gelu" else swiglu
    return mlp(p["mlp"], x, ctx.mesh, ctx.model_axis, f), 0.0


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


def _taped(ctx: ParallelCtx, tape):
    """The scope whose forward collectives ``tape`` keeps (none without a
    tape or a mesh)."""
    if tape is None or ctx.mesh is None:
        return contextlib.nullcontext()
    return ctx.mesh.taped(tape)


def apply_layer(p, x, seg: Segment, cfg: ArchConfig, ctx: ParallelCtx,
                frontend=None, positions=None, attention=None, rows=None,
                tape=None):
    """One layer.  x: (B, S, d), or this rank's rows of it (``rows``, a
    ``Rows``); ``frontend``: the (B, N, d) states the cross-attention reads;
    ``attention`` as in ``_attend``; ``tape``: the ``launch.mesh.Tape`` that
    keeps the collectives of the self-attention (``attn``, ``enc`` and
    ``dec`` kinds) and of the FFN, the reference's ``attn_out`` and
    ``mlp_out``.  Returns (x, aux_loss)."""
    rows = rows or Rows(ctx, x.shape[1])
    p = rows.params(p)
    h = rows.gather(rms_norm(p["ln1"], x, cfg.norm_eps))
    if seg.kind == "xattn":
        x = x + xgate(p, x) * rows.take(_attend(
            p["xattn"], h, cfg, ctx, window=0, causal=False, kv=frontend,
            q_block=256, attention=attention))
    else:
        a = y = None
        if seg.kind in ("attn", "enc", "dec", "hybrid"):
            with _taped(ctx, tape if seg.kind != "hybrid" else None):
                a = rows.take(_attend(p["attn"], h, cfg, ctx,
                                      window=seg.window,
                                      causal=seg.kind != "enc",
                                      positions=positions,
                                      attention=attention))
        if seg.kind in ("ssm", "hybrid"):
            y = rows.take(ssm_lib.ssm_forward(p["ssm"], h, cfg.d_model,
                                              cfg.ssm, mesh=ctx.mesh,
                                              axis=ctx.model_axis))
        x = add_mixer(p, x, a, y, cfg)
        if seg.kind == "dec":
            hx = rows.gather(rms_norm(p["lnx"], x, cfg.norm_eps))
            x = x + rows.take(_attend(p["xattn"], hx, cfg, ctx, window=0,
                                      causal=False, kv=frontend, q_block=256,
                                      attention=attention))
    aux = 0.0
    if seg.ffn != "none":
        h2 = rows.gather(rms_norm(p["ln2"], x, cfg.norm_eps))
        with _taped(ctx, tape):
            out, aux = _apply_ffn(p, h2, cfg, ctx, seg)
            out = rows.take(out)
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
                 positions=None, attention=None, rows=None):
    """Apply all segments, layer by layer over the stacked parameters
    (``rows`` as in ``apply_layer``).  With ``ctx.remat`` under autograd
    each layer is checkpointed, as the reference's ``jax.checkpoint`` of
    its scan body: the backward keeps only each layer's input and
    recomputes the rest; with ``ctx.save_collectives`` on a mesh the
    recompute takes the self-attention's and FFN's collective outputs from
    the layer's tape instead of moving them again (the same values, so the
    result is bit-identical)."""
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for p_stack, seg in zip(seg_params, segs):
        remat = ctx.remat and records_grad(x, *tree_flatten(p_stack)[0])
        save = remat and ctx.save_collectives and ctx.mesh is not None
        for p_layer in _unstack(p_stack, seg.count):
            def layer(x, p_layer=p_layer, seg=seg,
                      tape=Tape() if save else None):
                if tape is not None:
                    tape.start()
                return apply_layer(p_layer, x, seg, cfg, ctx,
                                   frontend=frontend, positions=positions,
                                   attention=attention, rows=rows, tape=tape)
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
    ``enc_ln``.  On a rank of a mesh the output is whole, replicated over
    model (the frames are cut on N between layers under
    ``seq_parallel``)."""
    e = frontend.to(ctx.compute_dtype)
    e = e + _sinusoidal(e.shape[1], cfg.d_model, e.device).to(e.dtype)
    rows = Rows(ctx, e.shape[1])
    e, _ = run_segments(params["enc_segments"], encoder_segments(cfg),
                        rows.take(e), cfg, ctx, attention=attention,
                        rows=rows)
    return rows.gather(rms_norm(rows.param(params["enc_ln"]), e,
                                cfg.norm_eps))


def embed(params, tokens, cfg: ArchConfig, ctx: ParallelCtx):
    """Token ids (any shape) -> their embeddings in ``ctx.compute_dtype``,
    replicated over model.  Vocab-parallel where ``embed``'s rows are cut:
    each rank holds rows [lo, lo + n), and the sum over model is exact
    (one rank adds the row, the rest add zeros)."""
    e = params["embed"]
    if e.shape[0] == cfg.padded_vocab:
        return e[tokens].to(ctx.compute_dtype)
    n = e.shape[0]
    idx = tokens.long() - ctx.mesh.index(ctx.model_axis) * n
    mine = (idx >= 0) & (idx < n)
    x = torch.where(mine[..., None], e[idx.clamp(0, n - 1)],
                    torch.zeros((), dtype=e.dtype, device=e.device))
    return ctx.mesh.all_reduce(x.to(ctx.compute_dtype), ctx.model_axis, "sum")


def logits(params, h, cfg: ArchConfig, ctx: ParallelCtx):
    """(..., d) final hidden states -> (..., V) f32 logits with the padded
    vocab tail masked, replicated over model.  A tied unembedding is
    vocab-parallel where ``embed``'s rows are cut (this rank's columns,
    masked by global id, then gathered); an untied one is cut on d, as in
    the reference (the "embed" rule also matches "unembed"), and its
    logits summed."""
    w = unembed_matrix(params, cfg).to(h.dtype)
    if w.shape[1] == cfg.padded_vocab:
        return mask_vocab_pad(row_parallel(h, w, cfg.d_model, ctx.mesh,
                                           ctx.model_axis).float(), cfg)
    out = matmul(ctx.mesh.enter(h, ctx.model_axis), w).float()
    lo = ctx.mesh.index(ctx.model_axis) * w.shape[1]
    ids = lo + torch.arange(w.shape[1], device=h.device)
    out = torch.where(ids < cfg.vocab, out, -1e30)
    return ctx.mesh.all_gather(out, ctx.model_axis, dim=-1)


def forward_hidden(params, tokens, cfg: ArchConfig, ctx: ParallelCtx,
                   frontend=None, attention=None):
    """Token ids (B, S) -> (final hidden states (B, S, d), aux loss).
    ``frontend``: whisper's (B, N, d) frame embeddings (required for the
    audio arch), or the (B, N, d) patch embeddings llama-vision's
    cross-attention layers read; ``attention`` as in ``_attend``, for every
    attention.  On a rank of a mesh: the rank's rows of the batch, and
    under ``seq_parallel`` the hidden states are its rows of S
    (``Rows(ctx, S)``)."""
    s = tokens.shape[1]
    rows = Rows(ctx, s)
    x = embed(params, tokens, cfg, ctx)
    enc_out = None
    if cfg.family == "audio":
        if frontend is None:
            raise ValueError("the audio arch needs frame embeddings")
        x = x + _sinusoidal(s, cfg.d_model, x.device).to(x.dtype)
        enc_out = encode(params, frontend, cfg, ctx, attention=attention)
    elif frontend is not None:
        enc_out = frontend.to(ctx.compute_dtype)
    x, aux = run_segments(params["segments"], segments(cfg), rows.take(x),
                          cfg, ctx, frontend=enc_out, attention=attention,
                          rows=rows)
    x = rms_norm(rows.param(params["final_ln"]), x, cfg.norm_eps)
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
                   frontend=None, attention=None):
    """Full forward returning the last position's logits (B, V), f32 (on a
    rank of a mesh: its rows of the batch, replicated over model)."""
    h, _ = forward_hidden(params, tokens, cfg, ctx, frontend=frontend,
                          attention=attention)
    h = Rows(ctx, tokens.shape[1]).gather(h)
    return logits(params, h[:, -1], cfg, ctx)


def _vocab_block(params, cfg: ArchConfig, ctx: ParallelCtx, dtype):
    """The rank's ``padded_vocab / tp`` columns of the unembedding, in
    ``dtype``: a vocab-parallel tied table's own block; else the whole
    matrix (gathered where it is cut on d) entering rank-local work."""
    w = unembed_matrix(params, cfg).to(dtype)
    mesh, ax, tp = ctx.mesh, ctx.model_axis, ctx.tp
    if cfg.padded_vocab % tp:
        raise ValueError(f"vocab {cfg.padded_vocab} does not split over "
                         f"{tp} model ranks")
    v_loc = cfg.padded_vocab // tp
    if w.shape[1] == v_loc:
        return w
    if w.shape[0] != cfg.d_model:
        w = mesh.all_gather(w, ax, dim=0)
    return mesh.enter(w, ax).narrow(1, mesh.index(ax) * v_loc, v_loc)


def nll_sum(params, h, labels, cfg: ArchConfig, ctx: ParallelCtx,
            masked: bool = True):
    """(the NLL summed over the positions of ``labels``, their count) for
    the final hidden states ``h`` (B, S, d), whole over S.

    Never holds (B, S, V) logits: the sequence is taken in
    ``ctx.loss_chunk`` slices, each chunk's logits formed as the reference
    forms them (the product in the hidden states' dtype, then f32) with the
    padded vocab tail masked, and the chunk recomputed in the backward
    under ``ctx.remat``.  The log-sum-exp is the reference's
    (``jax.nn.logsumexp``): the maximum, taken with no gradient, plus the
    log of the shifted exponentials' sum.  ``masked``: labels ``< 0`` are
    left out (else they count, with a picked logit of 0, as the reference's
    pipeline tail's one-hot gives them).

    On a rank of a mesh (the reference's ``sharded_chunk_nll``) each model
    rank forms the logits of its ``padded_vocab / tp`` columns, and the
    maximum, the exponentials' sum and the picked logit are reduced over
    the model axis; the sums are the rank's rows'."""
    s = h.shape[1]
    chunk = min(ctx.loss_chunk, s)
    if s % chunk:
        raise ValueError(f"sequence length {s} is not a multiple of the "
                         f"loss chunk {chunk}")
    mesh, ax = ctx.mesh, ctx.model_axis
    if mesh is None:
        w = unembed_matrix(params, cfg).to(h.dtype)
        lo = 0
        reduce = lambda x, op: x
    else:
        w = _vocab_block(params, cfg, ctx, h.dtype)
        h = mesh.enter(h, ax)
        lo = mesh.index(ax) * w.shape[1]
        reduce = lambda x, op: mesh.all_reduce(x, ax, op)
    v_loc = w.shape[1]
    ids = lo + torch.arange(v_loc, device=h.device)

    def chunk_nll(hs, ls):
        logits = matmul(hs, w).float()
        if cfg.padded_vocab != cfg.vocab:
            logits = torch.where(ids < cfg.vocab, logits, -1e30)
        m = reduce(logits.detach().amax(-1), "max")
        sumexp = reduce(torch.exp(logits - m[..., None]).sum(-1), "sum")
        local = ls.long() - lo
        mine = (local >= 0) & (local < v_loc)
        picked = logits.gather(-1, local.clamp(0, v_loc - 1)[..., None])[..., 0]
        picked = reduce(torch.where(mine, picked, 0.0), "sum")
        valid = ls >= 0 if masked else torch.ones_like(ls, dtype=torch.bool)
        nll = torch.log(sumexp) + m - picked
        return torch.where(valid, nll, 0.0).sum(), valid.sum()

    remat = ctx.remat and records_grad(h, w)
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    count = torch.zeros((), dtype=torch.int64, device=h.device)
    for i in range(0, s, chunk):
        hs, ls = h[:, i:i + chunk], labels[:, i:i + chunk]
        nll, n = (checkpoint(chunk_nll, hs, ls, use_reentrant=False) if remat
                  else chunk_nll(hs, ls))
        total = total + nll
        count = count + n
    return total, count


def lm_loss(params, tokens, labels, cfg: ArchConfig, ctx: ParallelCtx,
            frontend=None):
    """Mean next-token cross-entropy plus the MoE aux loss (an f32 scalar),
    the NLL chunked over the sequence (``nll_sum``).  Labels ``< 0`` are
    left out of the mean.

    On a rank of a mesh the hidden states are gathered over the
    sequence-parallel rows once (not once per loss chunk), the NLL is
    vocab-sharded, and the mean is the global batch's: the NLL sum and the
    label count are summed over the batch axes, so every rank returns the
    same loss and each rank's gradients are those of its rows."""
    h, aux = forward_hidden(params, tokens, cfg, ctx, frontend=frontend)
    h = Rows(ctx, tokens.shape[1]).gather(h)
    total, count = nll_sum(params, h, labels, cfg, ctx)
    if ctx.mesh is not None:
        total = ctx.mesh.all_reduce(total, ctx.dp_axes, "sum")
        count = ctx.mesh.all_reduce(count, ctx.dp_axes, "sum")
    return total / torch.clamp(count, min=1) + aux
