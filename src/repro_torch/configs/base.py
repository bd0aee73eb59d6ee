"""Architecture & shape configuration for the repro framework.

Every assigned architecture is expressed as an ``ArchConfig``; every
benchmark shape as a ``ShapeConfig``.  Configs are plain frozen dataclasses so
they are hashable (usable as jit static args) and serializable.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts block configuration."""
    n_experts: int                 # routed experts
    top_k: int                     # routed experts per token
    n_shared: int = 0              # always-on shared experts
    d_expert: int = 0              # per-expert FFN hidden size
    capacity_factor: float = 1.25  # per-rank dispatch capacity multiplier
    router_aux_coef: float = 0.01  # load-balance aux loss coefficient
    router_z_coef: float = 1e-3    # router z-loss coefficient
    renorm_topk: bool = False      # renormalize top-k gates to sum to 1


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 (SSD) block configuration."""
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_kernel: int = 4
    chunk_size: int = 256
    n_groups: int = 1


@dataclass(frozen=True)
class ArchConfig:
    """A full architecture description (one per assigned arch)."""
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int                   # query heads (0 for attention-free)
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0              # 0 -> d_model // n_heads

    # Attention pattern ------------------------------------------------
    window: int = 0                # 0 = full attention; >0 = sliding window
    global_every: int = 0          # e.g. 6 -> layers (i+1) % 6 == 0 are global
    rope_theta: float = 10_000.0

    # Optional blocks ---------------------------------------------------
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    n_dense_layers: int = 0        # leading dense-FFN layers in MoE archs
    dense_d_ff: int = 0            # their FFN width

    # Cross-modal -------------------------------------------------------
    xattn_every: int = 0           # vlm: cross-attention every k-th layer
    n_frontend_tokens: int = 0     # vlm patches / audio frames (stub input)
    encoder_layers: int = 0        # audio (enc-dec): encoder depth

    # Misc ---------------------------------------------------------------
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    notes: str = ""

    # Derived -------------------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        """Vocab rounded to 256 so embedding tables shard over any TP degree.

        Logits beyond ``vocab`` are masked in the loss/sampler; parameter
        counts use the true vocab."""
        return -(-self.vocab // 256) * 256

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def is_subquadratic(self) -> bool:
        """True if the decode working set is bounded (SSM / SWA / hybrid)."""
        if self.family == "ssm":
            return True
        if self.window > 0:          # sliding window bounds most/all layers
            return True
        return False

    @property
    def has_decode(self) -> bool:
        """Encoder-only archs have no decode step.  All assigned archs decode."""
        return True

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks), for roofline."""
        d, v = self.d_model, self.vocab
        n = v * d                                   # embed
        if not self.tie_embeddings:
            n += v * d                              # unembed
        hd = self.resolved_head_dim
        for layer in range(self.n_layers):
            if self.family != "ssm":
                # attention
                n += d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd)
                n += (self.n_heads * hd) * d
            if self.ssm is not None:
                d_in = self.ssm.expand * d
                n += d * (2 * d_in + 2 * self.ssm.n_groups * self.ssm.d_state)
                n += d_in * d + d_in * self.ssm.conv_kernel
            if self.moe is not None and layer >= self.n_dense_layers:
                e = self.moe.n_experts + self.moe.n_shared
                n += e * 3 * d * self.moe.d_expert
                n += d * self.moe.n_experts        # router
            elif self.family in ("dense", "hybrid", "vlm", "audio") or (
                self.moe is not None and layer < self.n_dense_layers
            ):
                ff = self.dense_d_ff if (self.moe is not None and layer < self.n_dense_layers) else self.d_ff
                if ff:
                    n += 3 * d * ff                # SwiGLU
            n += 2 * d                             # norms
        if self.xattn_every:
            n_x = self.n_layers // self.xattn_every
            n += n_x * (2 * d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd))
        if self.encoder_layers:
            for _ in range(self.encoder_layers):
                n += 4 * d * (self.n_heads * hd) + 3 * d * self.d_ff + 2 * d
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: only top_k + shared experts)."""
        if self.moe is None:
            return self.param_count()
        d = self.d_model
        total = self.param_count()
        n_moe_layers = self.n_layers - self.n_dense_layers
        all_experts = (self.moe.n_experts + self.moe.n_shared) * 3 * d * self.moe.d_expert
        active_experts = (self.moe.top_k + self.moe.n_shared) * 3 * d * self.moe.d_expert
        return total - n_moe_layers * (all_experts - active_experts)


@dataclass(frozen=True)
class ShapeConfig:
    """A benchmark input shape (one per assigned shape)."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


# The four assigned shapes -------------------------------------------------
TRAIN_4K = ShapeConfig("train_4k", seq_len=4096, global_batch=256, kind="train")
PREFILL_32K = ShapeConfig("prefill_32k", seq_len=32_768, global_batch=32, kind="prefill")
DECODE_32K = ShapeConfig("decode_32k", seq_len=32_768, global_batch=128, kind="decode")
LONG_500K = ShapeConfig("long_500k", seq_len=524_288, global_batch=1, kind="decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


def shape_applicable(arch: ArchConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether an (arch, shape) cell runs, per the brief.

    ``long_500k`` needs a sub-quadratic decode working set: run for SSM /
    hybrid / sliding-window archs, skip for pure full-attention archs.
    """
    if shape.name == "long_500k" and not arch.is_subquadratic:
        return False, "pure full-attention arch: 500k decode working set unbounded (skip per brief)"
    if shape.is_decode and not arch.has_decode:
        return False, "encoder-only arch has no decode step"
    return True, ""


def reduced(arch: ArchConfig) -> ArchConfig:
    """A tiny same-family config for CPU smoke tests."""
    kw = dict(
        name=arch.name + "-smoke",
        family=arch.family,
        n_layers=2,
        d_model=64,
        n_heads=4 if arch.n_heads else 0,
        n_kv_heads=min(arch.n_kv_heads, 2) if arch.n_kv_heads else 0,
        d_ff=128,
        vocab=256,
        head_dim=16 if arch.n_heads else 0,
        window=min(arch.window, 16) if arch.window else 0,
        global_every=arch.global_every if arch.global_every else 0,
        rope_theta=arch.rope_theta,
        n_dense_layers=min(arch.n_dense_layers, 1),
        dense_d_ff=128 if arch.dense_d_ff else 0,
        xattn_every=2 if arch.xattn_every else 0,
        n_frontend_tokens=8 if arch.n_frontend_tokens else 0,
        encoder_layers=2 if arch.encoder_layers else 0,
        tie_embeddings=arch.tie_embeddings,
    )
    if arch.moe is not None:
        # high capacity factor -> no token drops -> smoke tests are exact
        kw["moe"] = MoEConfig(n_experts=4, top_k=2, n_shared=min(arch.moe.n_shared, 1),
                              d_expert=32, capacity_factor=8.0,
                              renorm_topk=arch.moe.renorm_topk)
    if arch.ssm is not None:
        kw["ssm"] = SSMConfig(d_state=8, head_dim=16, expand=2, conv_kernel=4,
                              chunk_size=8, n_groups=1)
    if arch.global_every:
        kw["global_every"] = arch.global_every
    return ArchConfig(**kw)


def replace(cfg, **kw):
    return dataclasses.replace(cfg, **kw)
