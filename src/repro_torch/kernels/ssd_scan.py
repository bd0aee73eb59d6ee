"""Mamba-2 SSD chunk scan (the SSM prefill's core).

The sequence is cut into chunks of ``chunk`` steps.  Within a chunk the
output is a masked quadratic form; across chunks a (P, N) f32 state per
(batch, head) is carried in order:

  lc    = cumsum(dt * A) within the chunk,  ltot = lc[-1]
  y_t   = sum_{s<=t} (C_t . B_s) exp(lc_t - lc_s) dt_s x_s
          + exp(lc_t) (C_t . h_prev)
  h     = exp(ltot) h_prev + sum_s exp(ltot - lc_s) dt_s x_s B_s^T

Layout (the model's, as the reference's ``ssd_scan``):
  x:    (B, S, H, P)  f32 or bf16     dt: (B, S, H) f32, after softplus
  A:    (H,) f32, negative            B, C: (B, S, G, N), x's dtype;
                                      head h reads group h // (H / G)
Returns y (B, S, H, P) f32 and h_final (B, H, P, N) f32.  No D skip and no
gate: the caller (``repro_torch.models.ssm``) applies them.

``ssd_scan`` checks its inputs against what the kernel takes, then
dispatches by device: a CPU tensor takes the plain PyTorch version
``ssd_scan_plain``; a CUDA tensor runs the hand-written kernel
(``csrc/ssd_scan.cu``) or raises on what the kernel does not take.  On the
card one call runs five passes (the in-chunk decay lc, C.B^T per group,
chunk states, state passing, chunk outputs) over scratch buffers that the
wrapper allocates; with bf16 x/B/C their products run on the tensor cores,
with f32 inputs as f32 FMAs.  ``ssd_scan.launches`` counts wrapper calls
that ran the kernel (one per scan, not one per pass).

On the card the scan is differentiable through ``SSDScan``, a
``torch.autograd.Function``: its forward is the kernel, its backward
recomputes the plain scan (``ssd_chunked`` with D = 0) under autograd and
returns that graph's gradients.  The reference trains through the same
``jnp`` scan (it has no backward kernel), so the card's gradients are the
reference's math.  On the CPU the plain version runs with its own autograd.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import cuda_lib

MAX_CHUNK = 256      # steps per chunk the kernel takes
MAX_DIM = 128        # largest head_dim P and state size N the kernel takes


def ssd_scan_plain(x, dt, A, B_mat, C_mat, chunk):
    """``ssd_chunked`` with D = 0 (the reference's ``ssd_scan_ref``): the
    kernel's plain version."""
    # imported here: repro_torch.models.ssm imports this module (via ops)
    from repro_torch.models.ssm import ssd_chunked
    zeros = torch.zeros((x.shape[2],), dtype=torch.float32, device=x.device)
    return ssd_chunked(x, dt, A, B_mat, C_mat, zeros, chunk)


def _check(x, dt, A, B_mat, C_mat, chunk):
    for name, t in (("x", x), ("dt", dt), ("A", A), ("B_mat", B_mat),
                    ("C_mat", C_mat)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    b, s, h, p = x.shape
    bb, sb, g, n = B_mat.shape
    if (bb, sb) != (b, s) or C_mat.shape != B_mat.shape:
        raise ValueError(f"B/C shapes {tuple(B_mat.shape)}/"
                         f"{tuple(C_mat.shape)} do not match x {tuple(x.shape)}")
    if tuple(dt.shape) != (b, s, h) or tuple(A.shape) != (h,):
        raise ValueError("dt must be (B, S, H) and A (H,)")
    cuda_lib.dtype_code(x.dtype)
    if B_mat.dtype != x.dtype or C_mat.dtype != x.dtype:
        raise TypeError("B_mat and C_mat must have x's dtype")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError("dt and A must be float32")
    if not 1 <= chunk <= MAX_CHUNK or s % chunk:
        raise ValueError(f"chunk must be in [1, {MAX_CHUNK}] and divide "
                         f"S={s}, got {chunk}")
    if h % g:
        raise ValueError(f"H={h} is not a multiple of G={g}")
    if not (1 <= p <= MAX_DIM and 1 <= n <= MAX_DIM):
        raise ValueError(f"kernel takes head_dim P and state N up to "
                         f"{MAX_DIM}, got P={p} N={n}")


def _launch(x, dt, A, B_mat, C_mat, chunk):
    """Run the kernel on checked CUDA tensors: (y, h_final)."""
    b, s, h, p = x.shape
    g, n = B_mat.shape[2], B_mat.shape[3]
    nc = s // chunk
    f32 = dict(dtype=torch.float32, device=x.device)
    y = torch.empty((b, s, h, p), **f32)
    h_final = torch.empty((b, h, p, n), **f32)
    # scratch of the passes: C.B^T per (batch, chunk, group), the in-chunk
    # decay lc, and each chunk's state (rewritten as its h_prev)
    cb = torch.empty((b, nc, g, chunk, chunk), **f32)
    lc = torch.empty((b, nc, h, chunk), **f32)
    states = torch.empty((b, nc, h, p, n), **f32)
    lib = cuda_lib.load()
    err = lib.valet_ssd_scan(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B_mat.data_ptr(),
        C_mat.data_ptr(), y.data_ptr(), h_final.data_ptr(), cb.data_ptr(),
        lc.data_ptr(), states.data_ptr(),
        b, s, h, p, g, n, chunk, cuda_lib.dtype_code(x.dtype),
        torch.cuda.current_stream(x.device).cuda_stream)
    cuda_lib.check(err, "ssd_scan")
    ssd_scan.launches += 1
    return y, h_final


class SSDScan(torch.autograd.Function):
    """``SSDScan.apply(forward, x, dt, A, B_mat, C_mat, chunk)``: (y,
    h_final) from ``forward(x, dt, A, B_mat, C_mat, chunk)``, with the
    gradients of the plain scan.  The backward recomputes ``ssd_chunked``
    (D = 0) on detached copies of the saved inputs and differentiates it;
    each gradient comes back in its input's dtype, and an unused h_final
    passes no cotangent.  ``ssd_scan`` passes the kernel as ``forward``; a
    test may pass the plain version to check the backward on the CPU."""

    @staticmethod
    def forward(ctx, forward, x, dt, A, B_mat, C_mat, chunk):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, A, B_mat, C_mat)
        ctx.chunk = chunk
        return forward(x, dt, A, B_mat, C_mat, chunk)

    @staticmethod
    def backward(ctx, gy, gh):
        # imported here: repro_torch.models.ssm imports this module (via ops)
        from repro_torch.models.ssm import ssd_chunked
        inputs = [t.detach().requires_grad_(need) for t, need in
                  zip(ctx.saved_tensors, ctx.needs_input_grad[1:6])]
        wanted = [t for t in inputs if t.requires_grad]
        with torch.enable_grad():
            zeros = torch.zeros((inputs[0].shape[2],), dtype=torch.float32,
                                device=inputs[0].device)
            pairs = [(out, cot) for out, cot in
                     zip(ssd_chunked(*inputs, zeros, ctx.chunk), (gy, gh))
                     if cot is not None]
            grads = iter(torch.autograd.grad(
                [o for o, _ in pairs], wanted, [c for _, c in pairs],
                allow_unused=True))
        return (None, *(next(grads) if t.requires_grad else None
                        for t in inputs), None)


def ssd_scan(x, dt, A, B_mat, C_mat, chunk):
    """x: (B,S,H,P); dt: (B,S,H); A: (H,); B/C: (B,S,G,N).

    Returns y (B,S,H,P) f32, h_final (B,H,P,N) f32.  On a CUDA tensor the
    kernel runs, differentiable through ``SSDScan``."""
    _check(x, dt, A, B_mat, C_mat, chunk)
    if not x.is_cuda:
        return ssd_scan_plain(x, dt, A, B_mat, C_mat, chunk)
    return SSDScan.apply(_launch, x, dt, A, B_mat, C_mat, chunk)


ssd_scan.launches = 0
