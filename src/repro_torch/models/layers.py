"""Primitive layers: RMSNorm, RoPE, SwiGLU, GELU MLP (PyTorch).

Parameters are plain nested dicts of tensors and every layer is a plain
function ``f(params, x, ...) -> y``, as in the reference.  ``matmul``
promotes mixed operand types the way ``jnp.einsum`` does (bf16 with f32
gives f32), so an f32 activation never silently meets a bf16 weight.

On a rank of a mesh (``launch/mesh.py``) the MLPs take this rank's blocks
of their weights, as ``param_pspecs`` cuts them over the model axis (a dim
is cut where its size divides the axis), and return the whole output,
replicated over the axis: ``row_parallel`` is the Megatron pair's second
half, with its sum written out.
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


def records_grad(*tensors) -> bool:
    """True when autograd records an op on any of ``tensors``: the
    checkpoints of training (remat) apply only then, so serving never
    pays for them."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def normal_(t: torch.Tensor, generator: torch.Generator,
            scale: float = 0.02) -> torch.Tensor:
    """Fill ``t`` in place with N(0, scale^2) drawn in f32 from ``generator``
    (which must live on ``t``'s device), rounded once to ``t``'s dtype.  A
    tensor on the ``meta`` device (shapes only) is left as it is."""
    if t.device.type == "meta":
        return t
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

def model_ranks(mesh, axis="model"):
    """(ranks on ``mesh``'s ``axis``, this rank's index); (1, 0) without
    a mesh."""
    if mesh is None:
        return 1, 0
    return mesh.shape[axis], mesh.index(axis)


def row_parallel(h, w, full, mesh=None, axis="model"):
    """``h @ w`` for a weight ``w`` of ``full`` rows that is row-parallel on
    ``mesh``'s ``axis``: ``w`` holds all its rows or this rank's block of
    them, ``h`` all ``full`` columns or this rank's block (the output of a
    column-parallel product).  Returns the whole product, replicated over
    the axis: summed over it where ``w``'s rows are cut."""
    h_cut, w_cut = h.shape[-1] != full, w.shape[-2] != full
    if w_cut:
        if not h_cut:
            n = w.shape[-2]
            r = mesh.index(axis)
            h = h[..., r * n:(r + 1) * n]
        return mesh.all_reduce(matmul(h, w), axis, "sum")
    if h_cut:
        h = mesh.all_gather(h, axis, dim=-1)
    return matmul(h, w)


def swiglu(params, x, mesh=None, axis="model", d_ff=0):
    """SwiGLU FFN.  params: wgu (d, 2f) fused gate+up, wd (f, d).
    The halves are interleaved: wgu[:, 0::2] is the gate, wgu[:, 1::2] up.
    On a rank of ``mesh``, ``d_ff`` is the global f."""
    gu = matmul(x, params["wgu"])
    if mesh is not None and gu.shape[-1] != 2 * d_ff and \
            params["wd"].shape[-2] == d_ff:
        # wd whole but wgu cut: a gate/up pair may straddle two blocks
        gu = mesh.all_gather(gu, axis, dim=-1)
    g, u = gu[..., 0::2], gu[..., 1::2]
    h = F.silu(g.float()).to(x.dtype) * u
    if mesh is None:
        return matmul(h, params["wd"])
    return row_parallel(h, params["wd"], d_ff, mesh, axis)


def gelu_mlp(params, x, mesh=None, axis="model", d_ff=0):
    """Plain GELU MLP (tanh approximation, as ``jax.nn.gelu``).
    params: wi (d, f), wo (f, d).  On a rank of ``mesh``, ``d_ff`` is the
    global f."""
    h = matmul(x, params["wi"])
    h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    if mesh is None:
        return matmul(h, params["wo"])
    return row_parallel(h, params["wo"], d_ff, mesh, axis)
