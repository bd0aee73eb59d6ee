"""Plain float32 forward of a hybrid-head decoder (hymba-1.5b): in every
layer an attention branch and an SSM branch read the same normed input,
side by side.

Per layer, with h = RMSNorm(x):
  a = Wo attn(RoPE(Wq h), RoPE(Wk h), Wv h) over the whole causal prefix
      in the global layers (``global_attn_idx``) and over the last
      ``sliding_window`` positions elsewhere;
  y = the SSM branch below;
  x += (RMSNorm_a(a) + RMSNorm_y(y)) / 2;   x += SwiGLU(RMSNorm(x)).

SSM branch (Mamba-2 SSD heads): z = Wz h; xBC = causal depthwise conv of
width ``mamba_d_conv`` over [Wx h, Wbc h], plus bias, then SiLU; dt =
softplus(Wdt h + dt_bias); A = -exp(A_log); per head and position
    y_t = sum_{s <= t} (C_t . B_s) exp(sum_{r = s+1..t} dt_r A) dt_s x_s
          + D x_t,
computed here as that sum over all pairs at once (no chunks, no carried
state); then y * SiLU(z), an RMSNorm over the channels, and the output
projection.

Departures from the published Hymba, as the port has them
(``configs/hymba-1.5b.json`` lists them too): no meta tokens; no
cross-layer KV sharing; Mamba-2 SSD heads in place of Mamba's selective
scan; an untied unembedding; RMSNorm scaled by (1 + w).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from valetbench.reference.common import (attention, attn_leaves, attn_mlp_work,
                                         layer_list, linear, logits_at, mlp_leaves,
                                         rms_norm, rope, swiglu)


def ssm_widths(config):
    """(inner channels, heads, head size, state size, groups, conv width)."""
    di = config["mamba_expand"] * config["hidden_size"]
    hp = config["mamba_head_dim"]
    return (di, di // hp, hp, config["mamba_d_state"], config["mamba_n_groups"],
            config["mamba_d_conv"])


def _check(run):
    if run["kind"] != "hybrid":
        raise ValueError(f"layer kind {run['kind']!r} is not a hybrid layer")


def run_leaves(config, run, prefix):
    """The weights of one run of like layers, stacked, in tree order: the
    attention branch, the SSM branch (its A_log, D and dt_bias f32), the
    two branches' norms, the SwiGLU."""
    _check(run)
    n, d = run["count"], config["hidden_size"]
    di, sh, _, sn, sg, k = ssm_widths(config)
    dbc = 2 * sg * sn
    z = prefix + ("ssm",)
    return (attn_leaves(config, prefix, n)
            + [(z + ("wz",), "w", (n, d, di), "bf16"),
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
               (z + ("out_proj",), "out", (n, di, d), "bf16"),
               (prefix + ("attn_norm",), "w", (n, d), "bf16"),
               (prefix + ("ssm_norm",), "w", (n, d), "bf16")]
            + mlp_leaves(config, prefix, n))


def layer_work(config, run):
    """One layer's work per token: the attention branch and the SwiGLU
    (``common.attn_mlp_work``), the SSM branch's projections, its conv and
    recurrence, and its SSD scan's shape (heads, head size, groups, state
    size, chunk)."""
    _check(run)
    d = config["hidden_size"]
    di, sh, sp, sn, sg, k = ssm_widths(config)
    dbc = 2 * sg * sn
    w = attn_mlp_work(config, run["window"])
    w["matmul"] += d * (2 * di + dbc + sh) + di * d
    w["token_flops"] = 4.0 * sh * sp * sn + 2.0 * k * (di + dbc)
    w["ssd"] = (sh, sp, sg, sn, config["mamba_chunk_size"])
    return w


def causal_conv(xbc, w, b):
    """Depthwise causal conv: out_t = sum_i w_i x_{t - (K-1) + i} + b."""
    k = w.shape[0]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    s = xbc.shape[0]
    return sum(pad[i:i + s] * w[i].float() for i in range(k)) + b.float()


def ssd(x, dt, a, bm, cm, d):
    """x (S, H, P), dt (S, H), a (H,), bm/cm (S, G, N), d (H,) -> y (S, H, P)
    by the pairwise sum over s <= t."""
    s, h, _ = x.shape
    hpg = h // bm.shape[1]
    lcum = torch.cumsum(dt * a, dim=0)                        # (S, H)
    i = torch.arange(s, device=x.device)
    mask = (i[None, :] <= i[:, None])                          # t, s
    diff = lcum.T[:, :, None] - lcum.T[:, None, :]            # (H, t, s)
    decay = torch.exp(torch.where(mask, diff, torch.zeros_like(diff)))
    cb = torch.einsum("tgn,sgn->gts", cm, bm).repeat_interleave(hpg, dim=0)
    m = torch.where(mask, cb * decay, torch.zeros_like(decay)) * dt.T[:, None, :]
    return torch.einsum("hts,shp->thp", m, x) + d[None, :, None] * x


def ssm_branch(p, h, config, lowp=None):
    s = h.shape[0]
    di, nh, hp, n, g, _ = ssm_widths(config)
    z = linear(h, p["wz"], lowp)
    raw = torch.cat([linear(h, p["wx"], lowp), linear(h, p["wbc"], lowp)], dim=-1)
    w = torch.cat([p["conv_x"], p["conv_bc"]], dim=-1)
    xbc = F.silu(causal_conv(raw, w, p["conv_b"]))
    xs = xbc[:, :di].view(s, nh, hp)
    bm = xbc[:, di:di + g * n].view(s, g, n)
    cm = xbc[:, di + g * n:].view(s, g, n)
    dt = F.softplus(linear(h, p["wdt"], lowp) + p["dt_bias"].float(),
                    beta=1.0, threshold=1e9)
    y = ssd(xs, dt, -torch.exp(p["A_log"].float()), bm, cm, p["D"].float())
    y = y.reshape(s, di) * F.silu(z)
    return linear(rms_norm(p["gate_norm"], y, 1e-5), p["out_proj"], lowp)


def forward(params, config, tokens: torch.Tensor, rows, lowp=None):
    """Logits (len(rows), vocab) of ``tokens`` (S,) at the positions
    ``rows``, one layer at a time over the whole sequence."""
    eps, theta = config["rms_norm_eps"], config["rope_theta"]
    hq, hkv, hd = (config["num_attention_heads"], config["num_key_value_heads"],
                   config["head_dim"])
    global_idx = set(config["global_attn_idx"])
    s = tokens.shape[0]
    x = params["embed"][tokens].float()
    for li, (p, window) in enumerate(layer_list(params, config)):
        if (window == 0) != (li in global_idx):
            raise ValueError(f"layer {li}: the layer runs and global_attn_idx disagree")
        win = 0 if li in global_idx else config["sliding_window"]
        at = p["attn"]
        h = rms_norm(p["ln1"], x, eps)
        q = rope(linear(h, at["wq"], lowp).view(s, hq, hd), theta)
        k = rope(linear(h, at["wk"], lowp).view(s, hkv, hd), theta)
        v = linear(h, at["wv"], lowp).view(s, hkv, hd)
        a = linear(attention(q, k, v, win).reshape(s, hq * hd), at["wo"], lowp)
        y = ssm_branch(p["ssm"], h, config, lowp)
        x = x + 0.5 * (rms_norm(p["attn_norm"], a, eps) + rms_norm(p["ssm_norm"], y, eps))
        x = x + swiglu(rms_norm(p["ln2"], x, eps), p["mlp"]["wgu"],
                       p["mlp"]["wd"], lowp)
    return logits_at(params, config, x, rows, lowp)
