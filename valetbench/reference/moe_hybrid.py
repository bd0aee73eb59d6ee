"""Plain float32 forward of a hybrid Mamba-2 / attention decoder with a
mixture of experts in every layer (granite-4.0-h-small), over one chip's
share of the experts.

Per layer, with h = RMSNorm(x) and r = ``residual_multiplier``:
  m = the layer's mixer: a Mamba-2 SSD block (``hybrid.ssm_branch``: the
      causal conv, the SSD heads by the pairwise sum, the gate, the gate's
      RMSNorm and the output projection) in the ``ssm`` layers, or grouped-
      query attention with no positional embedding over the whole causal
      prefix in the ``attn`` layers, its scores scaled by
      ``attention_multiplier`` (here by scaling q by
      ``attention_multiplier * sqrt(head_dim)`` before ``common.attention``'s
      1/sqrt(head_dim));
  x += r m;   x += r (MoE(RMSNorm(x)) + SwiGLU_shared(RMSNorm(x))).
The embeddings are scaled by ``embedding_multiplier`` and the logits
divided by ``logits_scaling``.

MoE: the router's ``router_experts`` logits; each token takes its
``num_experts_per_tok`` largest (ties to the lower index) with gates the
softmax over those k logits, as published.  This chip holds experts
[``held_experts_first``, + ``num_local_experts``) and computes only the
entries routed to them, each with its gate, by a loop over its experts:
no capacity, nothing dropped.  What the other chips' experts would add is
left out, as in the port.  The shared expert is a SwiGLU of
``shared_intermediate_size`` (fused, interleaved gate and up columns).

Departures from the published model, as the port has them
(``configs/granite-4.0-h-small.json`` lists them too): the held share of
the experts; an untied unembedding; RMSNorm scaled by (1 + w).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from valetbench.reference import hybrid
from valetbench.reference.common import (attention, attn_leaves, linear, logits_at,
                                         rms_norm, swiglu)

KINDS = ("ssm", "attn")


def _check(config, run):
    if run["kind"] not in KINDS or run["window"] != 0:
        raise ValueError(f"layer run {run} is not an ssm or attn layer of this family")


def _held(config):
    """(first held expert, experts held, experts routed over)."""
    return (config["held_experts_first"], config["num_local_experts"],
            config["router_experts"])


def moe_leaves(config, prefix, n):
    """The post-norm, the router, the held experts' gate, up and down
    matrices, and the shared expert, of ``n`` stacked layers."""
    d, f = config["hidden_size"], config["intermediate_size"]
    fs = config["shared_intermediate_size"]
    _, held, routed = _held(config)
    z = prefix + ("moe",)
    return [(prefix + ("ln2",), "w", (n, d), "bf16"),
            (z + ("router",), "w", (n, d, routed), "bf16"),
            (z + ("experts", "wg"), "w", (n, held, d, f), "bf16"),
            (z + ("experts", "wu"), "w", (n, held, d, f), "bf16"),
            (z + ("experts", "wd"), "out", (n, held, f, d), "bf16"),
            (z + ("shared", "wgu"), "w", (n, d, 2 * fs), "bf16"),
            (z + ("shared", "wd"), "out", (n, fs, d), "bf16")]


def run_leaves(config, run, prefix):
    """The weights of one run of like layers, stacked, in tree order: the
    pre-norm and the mixer (the attention projections, or the SSM branch
    with its A_log, D and dt_bias f32), then the MoE."""
    _check(config, run)
    n, d = run["count"], config["hidden_size"]
    if run["kind"] == "attn":
        mixer = attn_leaves(config, prefix, n)
    else:
        di, sh, _, sn, sg, k = hybrid.ssm_widths(config)
        dbc = 2 * sg * sn
        z = prefix + ("ssm",)
        mixer = [(prefix + ("ln1",), "w", (n, d), "bf16"),
                 (z + ("wz",), "w", (n, d, di), "bf16"),
                 (z + ("wx",), "w", (n, d, di), "bf16"),
                 (z + ("wbc",), "w", (n, d, dbc), "bf16"),
                 (z + ("wdt",), "w", (n, d, sh), "bf16"),
                 (z + ("conv_x",), "conv", (n, k, di), "bf16"),
                 (z + ("conv_bc",), "conv", (n, k, dbc), "bf16"),
                 (z + ("conv_b",), "w", (n, di + dbc), "bf16"),
                 (z + ("A_log",), "A_log", (n, sh), "f32"),
                 (z + ("D",), "D", (n, sh), "f32"),
                 (z + ("dt_bias",), "dt_bias", (n, sh), "f32"),
                 (z + ("gate_norm",), "w", (n, di), "bf16"),
                 (z + ("out_proj",), "out", (n, di, d), "bf16")]
    return mixer + moe_leaves(config, prefix, n)


def layer_work(config, run):
    """One layer's work per token on this chip: ``matmul`` counts the
    weights a token multiplies here, namely the mixer's projections, the
    router, the shared expert and, in expectation, k x held / routed of
    the held experts (10 x 18 / 72 = 2.5 at the cell's share); ``attn``
    (query heads, KV heads, head size, 0: the whole causal prefix) in the
    attention layers; the SSM's conv and recurrence as other per-token
    FLOPs and its SSD scan's shape in the Mamba-2 layers."""
    _check(config, run)
    d, f = config["hidden_size"], config["intermediate_size"]
    _, held, routed = _held(config)
    k = config["num_experts_per_tok"]
    moe = (d * routed + 3 * d * config["shared_intermediate_size"]
           + k * held * 3 * d * f // routed)
    if run["kind"] == "attn":
        hd = config["head_dim"]
        hq, hkv = config["num_attention_heads"], config["num_key_value_heads"]
        return {"matmul": 2 * d * hq * hd + 2 * d * hkv * hd + moe,
                "attn": (hq, hkv, hd, 0), "token_flops": 0.0, "ssd": None}
    di, sh, sp, sn, sg, kc = hybrid.ssm_widths(config)
    dbc = 2 * sg * sn
    return {"matmul": d * (2 * di + dbc + sh) + di * d + moe, "attn": None,
            "token_flops": 4.0 * sh * sp * sn + 2.0 * kc * (di + dbc),
            "ssd": (sh, sp, sg, sn, config["mamba_chunk_size"])}


def moe(p, x, config, lowp=None):
    """The held experts' part of the routed experts for x (S, d), plus the
    shared expert."""
    first, held, _ = _held(config)
    k = config["num_experts_per_tok"]
    logits = linear(x, p["router"], lowp)
    top, eids = torch.sort(logits, dim=-1, descending=True, stable=True)
    gates = torch.softmax(top[:, :k], dim=-1)
    eids = eids[:, :k]
    out = torch.zeros_like(x)
    ex = p["experts"]
    for j in range(held):
        chosen = eids == first + j                                   # (S, k)
        rows = chosen.any(dim=-1).nonzero()[:, 0]
        if rows.numel() == 0:
            continue
        xe = x[rows]
        h = F.silu(linear(xe, ex["wg"][j], lowp)) * linear(xe, ex["wu"][j], lowp)
        gate = (gates * chosen).sum(dim=-1)[rows]
        out[rows] += gate[:, None] * linear(h, ex["wd"][j], lowp)
    return out + swiglu(x, p["shared"]["wgu"], p["shared"]["wd"], lowp)


def forward(params, config, tokens: torch.Tensor, rows, lowp=None):
    """Logits (len(rows), vocab) of ``tokens`` (S,) at the positions
    ``rows``, one layer at a time over the whole sequence."""
    if config["position_embedding_type"] != "nope":
        raise ValueError("this family's attention has no positional embedding")
    kinds = [run["kind"] for run in config["layers"] for _ in range(run["count"])]
    if kinds != ["attn" if t == "attention" else "ssm" for t in config["layer_types"]]:
        raise ValueError("the layer runs and layer_types disagree")
    eps, r = config["rms_norm_eps"], config["residual_multiplier"]
    hq, hkv, hd = (config["num_attention_heads"], config["num_key_value_heads"],
                   config["head_dim"])
    q_scale = config["attention_multiplier"] * math.sqrt(hd)
    s = tokens.shape[0]
    x = params["embed"][tokens].float() * config["embedding_multiplier"]
    for seg, run in zip(params["segments"], config["layers"]):
        for i in range(run["count"]):
            p = _index(seg, i)
            h = rms_norm(p["ln1"], x, eps)
            if run["kind"] == "ssm":
                m = hybrid.ssm_branch(p["ssm"], h, config, lowp)
            else:
                at = p["attn"]
                q = linear(h, at["wq"], lowp).view(s, hq, hd) * q_scale
                k = linear(h, at["wk"], lowp).view(s, hkv, hd)
                v = linear(h, at["wv"], lowp).view(s, hkv, hd)
                m = linear(attention(q, k, v, 0).reshape(s, hq * hd), at["wo"], lowp)
            x = x + r * m
            x = x + r * moe(p["moe"], rms_norm(p["ln2"], x, eps), config, lowp)
    return logits_at(params, config, x, rows, lowp) / config["logits_scaling"]


def _index(v, i):
    return {k: _index(x, i) for k, x in v.items()} if isinstance(v, dict) else v[i]
