"""Primitive layers: RMSNorm, RoPE, SwiGLU, GELU MLP (PyTorch).

Parameters are plain nested dicts of tensors and every layer is a plain
function ``f(params, x, ...) -> y``, as in the reference.  ``matmul``
promotes mixed operand types the way ``jnp.einsum`` does (bf16 with f32
gives f32), so an f32 activation never silently meets a bf16 weight.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with JAX-style dtype promotion."""
    if x.dtype != w.dtype:
        t = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(t), w.to(t)
    return x @ w


def normal_(t: torch.Tensor, generator: torch.Generator,
            scale: float = 0.02) -> torch.Tensor:
    """Fill ``t`` in place with N(0, scale^2) drawn in f32 from ``generator``
    (which must live on ``t``'s device), rounded once to ``t``'s dtype."""
    if t.dtype == torch.float32:
        return t.normal_(0.0, scale, generator=generator)
    return t.copy_(torch.empty(t.shape, dtype=torch.float32, device=t.device)
                   .normal_(0.0, scale, generator=generator))


# --------------------------------------------------------------------------
# Norms
# --------------------------------------------------------------------------

def rms_norm(w, x, eps=1e-5):
    """RMSNorm in fp32 with scale ``1 + w``, output in x.dtype."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + w.float())).to(x.dtype)


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None):
    """Inverse frequencies, shape (head_dim // 2,)."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)


def apply_rope(x, positions, theta: float):
    """Rotate split halves (not interleaved pairs).
    x: (..., S, H, D); positions: (..., S) int."""
    if theta <= 0:
        return x
    d = x.shape[-1]
    inv = rope_freqs(d, theta, device=x.device)                   # (D/2,)
    ang = positions[..., None].float() * inv                      # (..., S, D/2)
    cos = torch.cos(ang)[..., None, :]                            # (..., S, 1, D/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# MLP
# --------------------------------------------------------------------------

def swiglu(params, x):
    """SwiGLU FFN.  params: wgu (d, 2f) fused gate+up, wd (f, d).
    The halves are interleaved: wgu[:, 0::2] is the gate, wgu[:, 1::2] up."""
    gu = matmul(x, params["wgu"])
    g, u = gu[..., 0::2], gu[..., 1::2]
    h = F.silu(g.float()).to(x.dtype) * u
    return matmul(h, params["wd"])


def gelu_mlp(params, x):
    """Plain GELU MLP (tanh approximation, as ``jax.nn.gelu``).
    params: wi (d, f), wo (f, d)."""
    h = matmul(x, params["wi"])
    h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    return matmul(h, params["wo"])
