"""Roofline terms of a cell on the H100, from the meta-device dry run
(``launch/dryrun.py``).

Three terms, in seconds, per (arch x shape x mesh), each per device:

  compute    = FLOPs / peak FLOP/s
  memory     = HBM bytes / HBM bandwidth
  collective = collective bytes / link bandwidth

The reference reads FLOPs and collective bytes from the compiled, SPMD-
partitioned program.  PyTorch has no such program, so ``meta_counts`` takes
them from one rank's cell run on meta tensors: FLOPs from
``torch.utils.flop_counter.FlopCounterMode`` (matrix products and
convolutions; the attention kernels' plain versions, whose square is full:
no masked block is skipped), and the output bytes of every transport of
the dry mesh (``launch/mesh.py``) by kind.  The collectives run in the
cell's own dtypes, so nothing is halved.  The memory term is the analytic
model ``analytic_bytes_for``, the reference's term for term.

Hardware constants, NVIDIA H100 SXM: 989 TFLOP/s dense bf16, 3.35 TB/s
HBM3, 450 GB/s NVLink a direction.  The collective term assumes NVLink
between every pair of ranks, which holds within one 8-card node; a mesh
spread over nodes moves its collectives over the slower network.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

PEAK_FLOPS = 989e12          # bf16 dense / device
HBM_BW = 3.35e12             # bytes / s / device
LINK_BW = 450e9              # bytes / s / direction (NVLink)

# the reference's collective kinds (HLO op names); the dry mesh's
# transports map onto them
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
_KIND = {"all_gather": "all-gather", "all_reduce": "all-reduce",
         "ring_shift": "collective-permute"}


def meta_counts(flops: float, mesh) -> Dict[str, object]:
    """The counterpart of the reference's ``analyze_hlo`` result: ``flops``
    (from ``FlopCounterMode``), the output bytes of each collective kind
    moved through ``mesh`` (its ``stats``, forward and backward),
    ``total_collective``, and ``calls`` per kind.  A kind the port does not
    use (its reduce-scatter is an all-reduce and a slice) stays 0."""
    out: Dict[str, object] = {"flops": float(flops)}
    out.update({k: 0.0 for k in COLLECTIVES})
    calls = {k: 0 for k in COLLECTIVES}
    for (_, op), row in mesh.stats.items():
        out[_KIND[op]] += float(row[2])
        calls[_KIND[op]] += row[0]
    out["total_collective"] = sum(out[k] for k in COLLECTIVES)
    out["calls"] = calls
    return out


# --------------------------------------------------------------------------
# Analytic memory-traffic model (the memory-term numerator)
# --------------------------------------------------------------------------

def analytic_bytes_for(cfg, shape, mesh_shape: Dict[str, int],
                       n_micro: int = 1, zero1: bool = True,
                       kv_bytes: float = 2.0) -> float:
    """Per-device HBM bytes per step, at kernel (fusion) granularity: the
    reference's model, term for term (flash attention keeps its score
    blocks on chip, so the memory term counts streams, not every op's
    operands).

    Streams counted (all per device):
      weights      fwd (+ remat re-fwd + bwd) reads, grad accum r/w,
                   optimizer moments/master r/w (ZeRO-1 sharded over DP)
      activations  layer-boundary residual r/w per microbatch
      attention    Q/K/V + flash KV re-streaming (band-limited for SWA)
      mlp/moe/ssm  intermediate streams at kernel granularity
      kv cache     decode: full local page-pool shard read + one append
    """
    chips = 1
    for v in mesh_shape.values():
        chips *= v
    tp = mesh_shape.get("model", 1)
    dp = chips // tp
    b_loc = max(shape.global_batch // dp, 1)
    s = shape.seq_len
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    kv_loc = max(cfg.n_kv_heads / tp, 1.0) if cfg.n_kv_heads else 0
    hq_loc = max(cfg.n_heads / tp, 1.0) if cfg.n_heads else 0
    p_loc = cfg.param_count() / tp
    dt = 2.0                              # bf16

    from repro_torch.models.transformer import segments, encoder_segments
    segs = [(g.kind, g.count, g.window, g.ffn, g.d_ff or cfg.d_ff)
            for g in segments(cfg)]
    if cfg.family == "audio":
        segs += [(g.kind, g.count, g.window, g.ffn, g.d_ff or cfg.d_ff)
                 for g in encoder_segments(cfg)]

    kind = shape.kind
    passes = {"train": 3.0, "prefill": 1.0, "decode": 1.0}[kind]

    if kind == "decode":
        tokens = b_loc                     # one token per sequence
        weights = p_loc * dt               # stream all local weights once
        cache = 0.0
        for seg_kind, count, window, ffn, dff in segs:
            if seg_kind in ("attn", "dec", "hybrid") and cfg.n_kv_heads:
                eff = min(window or s, s)
                if window == 0:
                    # paged pool shard: seq dim split over the KV axes
                    eff = s / (chips // max(dp, 1))
                    eff = eff * b_loc
                else:
                    eff = eff * b_loc
                per_tok = kv_bytes * hd + (2 if kv_bytes < 2 else 0)
                cache += count * eff * cfg.n_kv_heads * per_tok * 2
            if seg_kind in ("ssm", "hybrid") and cfg.ssm:
                d_in = cfg.ssm.expand * d
                nh = d_in // cfg.ssm.head_dim
                cache += count * b_loc * (nh / tp) * cfg.ssm.head_dim \
                    * cfg.ssm.d_state * 4 * 2
        act = tokens * d * dt * 4 * cfg.n_layers
        return weights + cache + act

    # train / prefill
    toks_loc = b_loc * s
    weights = passes * p_loc * dt * n_micro
    if kind == "train":
        opt_div = chips if zero1 else tp
        weights += n_micro * 12.0 * p_loc          # fp32 grad accum r/w+add
        weights += (cfg.param_count() / opt_div) * 4.0 * (2 + 2 + 2 + 2)
    act = 0.0
    for seg_kind, count, window, ffn, dff in segs:
        per_layer = 0.0
        # residual + norms r/w
        per_layer += 4 * toks_loc * d * dt
        if seg_kind in ("attn", "dec", "hybrid", "enc", "xattn") and cfg.n_heads:
            qkv = toks_loc * (hq_loc + 2 * kv_loc) * hd * dt * 2
            nq = max(s // 512, 1)
            band = min((window or s), s)
            kv_stream = nq * min(band + 512, s) * b_loc * kv_loc * hd * 2 * dt
            per_layer += qkv + kv_stream + toks_loc * hq_loc * hd * dt * 2
        if seg_kind in ("ssm", "hybrid") and cfg.ssm:
            d_in = cfg.ssm.expand * d
            per_layer += toks_loc * (d_in / tp) * dt * 6
        if ffn == "moe" and cfg.moe:
            cap_tokens = toks_loc * cfg.moe.top_k * cfg.moe.capacity_factor
            per_layer += cap_tokens * d * dt * 4 \
                + cap_tokens * (cfg.moe.d_expert) * dt * 2
            per_layer += toks_loc * (cfg.moe.n_shared * cfg.moe.d_expert / tp) * dt * 3
        elif ffn in ("swiglu", "gelu"):
            per_layer += toks_loc * (dff / tp) * dt * 3
        act += count * per_layer
    act *= passes * 0.9                   # bwd streams ~ fwd; remat re-fwd
    if kind == "train":
        act /= 1.0
    # embeddings / logits (vocab-chunked loss)
    logits = toks_loc * (cfg.vocab / tp) * (4.0 if kind == "train" else 0.0)
    if kind == "prefill":
        logits = b_loc * (cfg.vocab / tp) * 4.0
    return weights + act + logits


@dataclass
class RooflineTerms:
    flops: float                 # per device
    bytes_hbm: float             # per device
    bytes_coll: float            # per device
    model_flops: float = 0.0     # analytic useful FLOPs per device

    @property
    def t_compute(self):
        return self.flops / PEAK_FLOPS

    @property
    def t_memory(self):
        return self.bytes_hbm / HBM_BW

    @property
    def t_collective(self):
        return self.bytes_coll / LINK_BW

    @property
    def bottleneck(self):
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def bound_time(self):
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_ratio(self):
        return self.model_flops / self.flops if self.flops else 0.0

    @property
    def roofline_fraction(self):
        """Fraction of the bound-time budget doing useful model FLOPs."""
        if self.bound_time <= 0:
            return 0.0
        return (self.model_flops / PEAK_FLOPS) / self.bound_time

    def to_dict(self):
        return {
            "flops_per_chip": self.flops,
            "hbm_bytes_per_chip": self.bytes_hbm,
            "collective_bytes_per_chip": self.bytes_coll,
            "model_flops_per_chip": self.model_flops,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def model_flops_for(cfg, shape, n_chips: int) -> float:
    """Analytic useful FLOPs per device for the cell.

    train: 6·N_active·tokens; prefill: 2·N_active·tokens (+causal attention
    2·L·H·hd·S²/2·2(QK,AV)·B); decode: 2·N_active·B + full KV attention
    reads (counted as FLOPs: 4·L·kv·hd·S·B... attention decode is
    memory-bound; we count its MACs too).
    """
    n_active = cfg.active_param_count()
    b, s = shape.global_batch, shape.seq_len
    hd = cfg.resolved_head_dim
    # attention score+value FLOPs (causal halves the square)
    attn = 0.0
    if cfg.n_heads:
        full_layers = 0
        win_layers = 0
        for seg_kind, count, window in _seg_summary(cfg):
            if seg_kind in ("attn", "dec", "hybrid", "enc"):
                if window:
                    win_layers += count
                else:
                    full_layers += count
        if shape.kind == "train" or shape.kind == "prefill":
            attn += full_layers * 4 * cfg.n_heads * hd * (s ** 2) / 2 * b
            w = cfg.window or s
            attn += win_layers * 4 * cfg.n_heads * hd * s * min(w, s) * b
            mult = 6.0 if shape.kind == "train" else 2.0
            attn *= mult / 2.0       # bwd recomputes ~2x fwd attention
            return (mult * n_active * b * s + attn) / n_chips
        # decode: one token per seq
        attn += full_layers * 4 * cfg.n_heads * hd * s * b
        attn += win_layers * 4 * cfg.n_heads * hd * min(cfg.window or s, s) * b
    if shape.kind == "train":
        return (6 * n_active * b * s) / n_chips
    if shape.kind == "prefill":
        return (2 * n_active * b * s) / n_chips
    return (2 * n_active * b + attn) / n_chips


def _seg_summary(cfg):
    from repro_torch.models.transformer import segments, encoder_segments
    out = [(s.kind, s.count, s.window) for s in segments(cfg)]
    if cfg.family == "audio":
        out += [(s.kind, s.count, s.window) for s in encoder_segments(cfg)]
    return out
