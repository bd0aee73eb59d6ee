"""Plain float32 layers shared by the two references.

Every product runs in float32 with TF32 off (``strict_f32``).  ``lowp``,
where given, rounds both operands of every projection before the product:
the control runs the same forward with ``fp8`` (e4m3, one scale per row of
the activations and per output column of the weight), the precision below
the bf16 that the configurations serve in.
"""
from __future__ import annotations

import math

import torch

E4M3_MAX = 448.0


def attn_leaves(config, prefix, n):
    """(path, scale kind, shape, dtype) of the pre-norm and the attention
    projections of ``n`` stacked layers.  Scale kinds: ``w`` N(0, 0.02),
    ``out`` N(0, 0.02 / sqrt(2 L)), ``conv`` N(0, 0.5), and the f32
    ``A_log``, ``D`` and ``dt_bias`` (``harness/weights.py``)."""
    d, hd = config["hidden_size"], config["head_dim"]
    hq, hkv = config["num_attention_heads"], config["num_key_value_heads"]
    return [(prefix + ("ln1",), "w", (n, d), "bf16"),
            (prefix + ("attn", "wq"), "w", (n, d, hq * hd), "bf16"),
            (prefix + ("attn", "wk"), "w", (n, d, hkv * hd), "bf16"),
            (prefix + ("attn", "wv"), "w", (n, d, hkv * hd), "bf16"),
            (prefix + ("attn", "wo"), "out", (n, hq * hd, d), "bf16")]


def mlp_leaves(config, prefix, n):
    """The pre-norm and the SwiGLU weights of ``n`` stacked layers."""
    d, f = config["hidden_size"], config["intermediate_size"]
    return [(prefix + ("ln2",), "w", (n, d), "bf16"),
            (prefix + ("mlp", "wgu"), "w", (n, d, 2 * f), "bf16"),
            (prefix + ("mlp", "wd"), "out", (n, f, d), "bf16")]


def attn_mlp_work(config, window):
    """One layer's work per token of grouped-query attention over
    ``window`` positions (0: the whole causal prefix) and a SwiGLU:
    ``matmul`` weights multiplied, ``attn`` (query heads, KV heads, head
    size, window), no other per-token FLOPs and no SSD scan."""
    d, hd, f = config["hidden_size"], config["head_dim"], config["intermediate_size"]
    hq, hkv = config["num_attention_heads"], config["num_key_value_heads"]
    return {"matmul": 2 * d * hq * hd + 2 * d * hkv * hd + 3 * d * f,
            "attn": (hq, hkv, hd, window), "token_flops": 0.0, "ssd": None}


def strict_f32() -> None:
    """Float32 products in float32 (a float32 product may otherwise run in
    TF32 on this card)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to e4m3 with one absmax scale per slice along ``dim``
    (the reduction dim of the product), back in float32."""
    s = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / E4M3_MAX
    return (t / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def linear(x: torch.Tensor, w: torch.Tensor, lowp=None) -> torch.Tensor:
    """x (..., n) @ w (n, m) in float32; ``lowp`` rounds both operands."""
    x, w = x.float(), w.float()
    if lowp is not None:
        x, w = lowp(x, -1), lowp(w, 0)
    return x @ w


def rms_norm(w: torch.Tensor, x: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm scaled by (1 + w)."""
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * (1.0 + w.float())


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (S, H, D) rotated at positions 0..S-1, split halves."""
    s, _, d = x.shape
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                       device=x.device) / d)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(q, k, v, window: int) -> torch.Tensor:
    """Causal softmax attention, q (S, Hq, D), k/v (S, Hkv, D); with
    ``window`` > 0 a query sees only the last ``window`` positions (its
    own included).  Scores scaled by 1/sqrt(D)."""
    s, hq, d = q.shape
    rep = hq // k.shape[1]
    k = k.repeat_interleave(rep, dim=1)
    v = v.repeat_interleave(rep, dim=1)
    scores = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(d)
    i = torch.arange(s, device=q.device)
    mask = i[None, :] <= i[:, None]
    if window > 0:
        mask &= i[None, :] > i[:, None] - window
    scores = scores.masked_fill(~mask, float("-inf"))
    return torch.einsum("hqk,khd->qhd", torch.softmax(scores, dim=-1), v)


def swiglu(x, wgu, wd, lowp=None) -> torch.Tensor:
    """SwiGLU whose fused weight interleaves gate and up columns: column
    2j is gate j, column 2j + 1 up j."""
    gu = linear(x, wgu, lowp)
    g, u = gu[..., 0::2], gu[..., 1::2]
    return linear(torch.nn.functional.silu(g) * u, wd, lowp)


def layer_list(params, config):
    """[(layer's weights, window)] in depth order: runs of like layers
    are stacked in ``params['segments']`` as the configuration's
    ``layers`` lists them."""
    out = []
    for seg, run in zip(params["segments"], config["layers"]):
        for i in range(run["count"]):
            out.append(({k: _index(v, i) for k, v in seg.items()}, run["window"]))
    if len(out) != config["num_hidden_layers"]:
        raise ValueError("the layer runs do not add up to num_hidden_layers")
    return out


def _index(v, i):
    return {k: _index(x, i) for k, x in v.items()} if isinstance(v, dict) else v[i]


def logits_at(params, config, h, rows, lowp=None) -> torch.Tensor:
    """Final norm and unembedding of the hidden states at ``rows``, over
    the published vocabulary only."""
    h = rms_norm(params["final_ln"], h[rows], config["rms_norm_eps"])
    return linear(h, params["unembed"][:, : config["vocab_size"]], lowp)
