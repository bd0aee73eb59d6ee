"""Plain float32 forward of a dense grouped-query-attention decoder
(granite-3-8b).

Per layer: x += Wo attn(RoPE(Wq h), RoPE(Wk h), Wv h), h = RMSNorm(x);
x += SwiGLU(RMSNorm(x)); then a final RMSNorm and the unembedding.

Departures from the published Granite 3.0 model, as the port has them
(``configs/granite-3-8b.json`` lists them too): no embedding, attention,
residual or logits multiplier (scores scaled by 1/sqrt(head_dim)); an
untied unembedding; RMSNorm scaled by (1 + w); RoPE on split halves.
"""
from __future__ import annotations

import torch

from valetbench.reference.common import (attention, attn_leaves, attn_mlp_work,
                                         layer_list, linear, logits_at, mlp_leaves,
                                         rms_norm, rope, swiglu)


def _check(run):
    if run["kind"] != "attn":
        raise ValueError(f"layer kind {run['kind']!r} is not a dense GQA layer")


def run_leaves(config, run, prefix):
    """The weights of one run of like layers, stacked, in tree order."""
    _check(run)
    return (attn_leaves(config, prefix, run["count"])
            + mlp_leaves(config, prefix, run["count"]))


def layer_work(config, run):
    """One layer's work per token (``common.attn_mlp_work``)."""
    _check(run)
    return attn_mlp_work(config, run["window"])


def forward(params, config, tokens: torch.Tensor, rows, lowp=None):
    """Logits (len(rows), vocab) of the token ids ``tokens`` (S,) at the
    positions ``rows``, computed one layer at a time over the whole
    sequence."""
    eps, theta = config["rms_norm_eps"], config["rope_theta"]
    hq, hkv, hd = (config["num_attention_heads"], config["num_key_value_heads"],
                   config["head_dim"])
    s = tokens.shape[0]
    x = params["embed"][tokens].float()
    for p, window in layer_list(params, config):
        a = p["attn"]
        h = rms_norm(p["ln1"], x, eps)
        q = rope(linear(h, a["wq"], lowp).view(s, hq, hd), theta)
        k = rope(linear(h, a["wk"], lowp).view(s, hkv, hd), theta)
        v = linear(h, a["wv"], lowp).view(s, hkv, hd)
        x = x + linear(attention(q, k, v, window).reshape(s, hq * hd),
                       a["wo"], lowp)
        x = x + swiglu(rms_norm(p["ln2"], x, eps), p["mlp"]["wgu"],
                       p["mlp"]["wd"], lowp)
    return logits_at(params, config, x, rows, lowp)
