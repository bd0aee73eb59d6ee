"""Grouped GEMM over ragged per-expert row groups: the dropless MoE's
expert products (``models.moe.moe_ffn_dropless``).

Group g holds entries [offsets[g], offsets[g + 1]) of a call; entry i reads
row ``rows[i]`` of ``a`` (row i without ``rows``) and is multiplied by
expert g's weights.  Two modes:

  gated:  out[i] = silu(a_i @ w[g]) * (a_i @ w_up[g])   (gate, up, SwiGLU)
  plain:  out[i] = a_i @ w[g]                            (down)

  a: (T, K); w, w_up: (G, K, N); offsets: (G + 1,) int32, non-decreasing,
  from 0; rows: (>= offsets[G],) int32.  Returns (n_rows, N) in a's dtype,
  n_rows >= offsets[G] entries; rows past offsets[G] are unspecified.

Rounding, in both versions, as the capacity path's ``_expert_mlp``: each
product is rounded to a's dtype, SiLU is taken in f32 and rounded, then
the product with the up projection is rounded.

``moe_gemm`` checks its inputs, then dispatches by device: a CPU tensor
takes the plain PyTorch version ``moe_gemm_plain`` (which reads the
offsets on the host), a CUDA tensor runs the hand-written kernel
(``csrc/moe_gemm.cu``: bf16 only, K and N multiples of 64) or raises.
The kernel keeps the offsets on the device: its grid holds
ceil(n_rows / block_m) + G row tiles, and the tiles past the groups' end
exit at once, so nothing waits to learn a group's size.
``moe_gemm.launches`` counts the calls that launched it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import cuda_lib

TILE_N = 64          # the kernel's N and K granularity
TILE_K = 64


def _expert(x, w, w_up):
    if w_up is None:
        return x @ w
    g, u = x @ w, x @ w_up
    return F.silu(g.float()).to(x.dtype) * u


def moe_gemm_plain(a, offsets, w, w_up=None, *, rows=None, n_rows):
    """The kernel's plain version: one product per non-empty group."""
    bounds = offsets.tolist()
    out = a.new_zeros((n_rows, w.shape[2]))
    for g in range(w.shape[0]):
        lo, hi = bounds[g], bounds[g + 1]
        if hi == lo:
            continue
        x = a[rows[lo:hi].long()] if rows is not None else a[lo:hi]
        # a one-row product takes the matrix-vector path, whose sums run
        # in another order: one zero row more keeps every row's bits the
        # same whatever the size of its group
        x = F.pad(x, (0, 0, 0, 1))
        out[lo:hi] = _expert(x, w[g], None if w_up is None else w_up[g])[:-1]
    return out


def _check(a, offsets, w, w_up, rows, n_rows):
    named = [("a", a), ("offsets", offsets), ("w", w)]
    named += [("w_up", w_up)] if w_up is not None else []
    named += [("rows", rows)] if rows is not None else []
    for name, t in named:
        if t.device != a.device:
            raise ValueError(f"{name} is on {t.device}, a on {a.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if a.dim() != 2 or w.dim() != 3 or w.shape[1] != a.shape[1]:
        raise ValueError(f"a {tuple(a.shape)} and w {tuple(w.shape)} are not "
                         "(T, K) and (G, K, N)")
    if w_up is not None and w_up.shape != w.shape:
        raise ValueError("w_up must have w's shape")
    if w.dtype != a.dtype or (w_up is not None and w_up.dtype != a.dtype):
        raise TypeError("the weights must have a's dtype")
    if offsets.dtype != torch.int32 or tuple(offsets.shape) != (w.shape[0] + 1,):
        raise ValueError("offsets must be (G + 1,) int32")
    if rows is not None and (rows.dtype != torch.int32 or rows.dim() != 1):
        raise ValueError("rows must be 1-D int32")
    if n_rows < 1:
        raise ValueError("n_rows must be positive")


def _launch(a, offsets, w, w_up, rows, n_rows, block_m):
    k, n = a.shape[1], w.shape[2]
    if a.dtype != torch.bfloat16:
        raise TypeError(f"the kernel takes bfloat16, not {a.dtype}")
    if k % TILE_K or n % TILE_N:
        raise ValueError(f"the kernel takes K and N in multiples of {TILE_K}, "
                         f"got K={k} N={n}")
    if block_m not in (32, 64):
        raise ValueError("block_m must be 32 or 64")
    out = torch.empty((n_rows, n), dtype=a.dtype, device=a.device)
    groups = w.shape[0]
    max_tiles = -(-n_rows // block_m) + groups
    err = cuda_lib.load().valet_moe_gemm(
        a.data_ptr(), 0 if rows is None else rows.data_ptr(), offsets.data_ptr(),
        groups, w.data_ptr(), 0 if w_up is None else w_up.data_ptr(),
        out.data_ptr(), k, n, n_rows, max_tiles, block_m,
        torch.cuda.current_stream(a.device).cuda_stream)
    cuda_lib.check(err, "moe_gemm")
    moe_gemm.launches += 1
    return out


def moe_gemm(a, offsets, w, w_up=None, *, rows=None, n_rows, block_m=32):
    """The grouped product (gated with ``w_up``) of the groups ``offsets``
    gives; ``block_m`` (32 or 64) is the kernel's row tile, 64 where the
    groups run long."""
    _check(a, offsets, w, w_up, rows, n_rows)
    if not a.is_cuda:
        return moe_gemm_plain(a, offsets, w, w_up, rows=rows, n_rows=n_rows)
    return _launch(a, offsets, w, w_up, rows, n_rows, block_m)


moe_gemm.launches = 0
