"""Mamba-2 (SSD, state-space duality) block (PyTorch).

The SSD recurrence  h_t = a_t * h_{t-1} + dt_t * B_t x_t^T ,
                    y_t = C_t h_t + D x_t
(with per-head scalar decay a_t = exp(dt_t * A_h)) is computed chunk-wise:
quadratic *within* a chunk and a small per-chunk state recurrence *across*
chunks.  ``ssd_chunked`` is the plain PyTorch form (the oracle, and the
kernel's plain version through ``kernels/ssd_scan.py``); ``ssm_forward``
runs the core scan through ``kernels.ops.ssd_scan_op``, which launches the
hand-written CUDA kernel (``csrc/ssd_scan.cu``) on a CUDA tensor, then adds
the D skip.  The kernel also runs under autograd (training): its backward
recomputes ``ssd_chunked`` and differentiates it (``SSDScan``).  Decode
(``ssm_decode_step``) keeps O(1) state per layer: the (H, P, N) SSD state
and a (K-1)-deep conv ring; it has no kernel.

Every dtype cast of the reference is kept: the causal conv sums in the
input's dtype and applies SiLU in f32, ``dt`` is f32, and y is cast to the
input's dtype before the gate.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMConfig
from repro_torch.kernels.ops import ssd_scan_op
from repro_torch.models.layers import matmul, rms_norm


def ssm_dims(d_model: int, ssm: SSMConfig):
    d_inner = ssm.expand * d_model
    n_heads = d_inner // ssm.head_dim
    d_bc = 2 * ssm.n_groups * ssm.d_state
    return d_inner, n_heads, d_bc


def _softplus(x):
    """``jax.nn.softplus`` (log(1 + e^x), no linear cut-off)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _promote(a, b):
    t = torch.promote_types(a.dtype, b.dtype)
    return a.to(t), b.to(t)


def _project(params, x):
    z = matmul(x, params["wz"])
    xs = matmul(x, params["wx"])
    bc = matmul(x, params["wbc"])
    dt = matmul(x, params["wdt"])
    return z, xs, bc, dt


def _causal_conv(w, b, x, kernel):
    """Depthwise causal conv over (B, S, C): summed in the operands' type,
    SiLU in f32, back to ``x``'s dtype."""
    s = x.shape[1]
    pad = F.pad(x, (0, 0, kernel - 1, 0))
    out = 0
    for i in range(kernel):
        out = out + pad[:, i:i + s, :] * w[i]
    return F.silu((out + b).float()).to(x.dtype)


def ssd_chunked(x, dt, A, B_mat, C_mat, D, chunk: int, h0=None):
    """Chunked SSD scan.

    x: (B,S,H,P); dt: (B,S,H) (post-softplus); A: (H,) negative;
    B_mat/C_mat: (B,S,G,N); D: (H,).  Returns y (B,S,H,P) f32 and
    h_final (B,H,P,N) f32.
    """
    b, s, h, p = x.shape
    g, n = B_mat.shape[2], B_mat.shape[3]
    assert s % chunk == 0, (s, chunk)
    nc = s // chunk
    hpg = h // g

    xc = x.reshape(b, nc, chunk, h, p).float()
    dtc = dt.reshape(b, nc, chunk, h)
    Bc = B_mat.reshape(b, nc, chunk, g, n).float()
    Cc = C_mat.reshape(b, nc, chunk, g, n).float()

    # per-token log decay and within-chunk cumulative decay
    l = dtc * A[None, None, None, :]                       # (B,NC,Q,H) <= 0
    Lc = torch.cumsum(l, dim=2)                            # (B,NC,Q,H)
    Ltot = Lc[:, :, -1, :]                                 # (B,NC,H)

    # ---- intra-chunk (diagonal blocks), batched over chunks ---------------
    cb = torch.einsum("bcqgn,bcsgn->bcgqs", Cc, Bc)        # (B,NC,G,Q,Q)
    cb = cb.repeat_interleave(hpg, dim=2)                  # (B,NC,H,Q,Q)
    lt = Lc.movedim(3, 2)                                  # (B,NC,H,Q)
    mask = torch.ones((chunk, chunk), dtype=torch.bool,
                      device=x.device).tril()
    # exp only where s <= t: the masked entries would overflow
    diff = torch.where(mask, lt[..., :, None] - lt[..., None, :], 0.0)
    m = torch.where(mask, cb * torch.exp(diff), 0.0)
    m = m * dtc.movedim(3, 2)[..., None, :]                # * dt_s
    y_intra = torch.einsum("bchqs,bcshp->bcqhp", m, xc)

    # ---- chunk input states ----------------------------------------------
    dstate = torch.exp(Ltot[:, :, None, :] - Lc)           # (B,NC,Q,H)
    Bh = Bc.repeat_interleave(hpg, dim=3)                  # (B,NC,Q,H,N)
    s_in = torch.einsum("bcqhn,bcqhp,bcqh->bchpn", Bh, xc, dtc * dstate)

    # ---- inter-chunk recurrence (small loop over chunks) ------------------
    hprev = h0 if h0 is not None else torch.zeros(
        (b, h, p, n), dtype=torch.float32, device=x.device)
    hprevs = []
    decay = torch.exp(Ltot)                                # (B,NC,H)
    for c in range(nc):
        hprevs.append(hprev)
        hprev = hprev * decay[:, c, :, None, None] + s_in[:, c]
    hprevs = torch.stack(hprevs, dim=1)                    # (B,NC,H,P,N)

    # ---- inter-chunk contribution -----------------------------------------
    Ch = Cc.repeat_interleave(hpg, dim=3)                  # (B,NC,Q,H,N)
    y_inter = torch.einsum("bcqhn,bchpn,bcqh->bcqhp", Ch, hprevs,
                           torch.exp(Lc))

    y = y_intra + y_inter + D[None, None, None, :, None] * xc
    return y.reshape(b, s, h, p), hprev


def ssm_forward(params, x, d_model, ssm: SSMConfig, return_state=False):
    """Full SSD mixer over a sequence.  x: (B,S,d_model)."""
    b, s, _ = x.shape
    d_inner, n_heads, d_bc = ssm_dims(d_model, ssm)
    g, n = ssm.n_groups, ssm.d_state

    z, xs, bc, dt = _project(params, x)
    xbc_raw = torch.cat([xs, bc], dim=-1)
    conv_w = torch.cat([params["conv_x"], params["conv_bc"]], dim=-1)
    xbc = _causal_conv(conv_w, params["conv_b"], xbc_raw, ssm.conv_kernel)
    xs = xbc[..., :d_inner].reshape(b, s, n_heads, ssm.head_dim)
    B_mat = xbc[..., d_inner:d_inner + g * n].reshape(b, s, g, n)
    C_mat = xbc[..., d_inner + g * n:].reshape(b, s, g, n)
    dt = _softplus(dt.float() + params["dt_bias"])
    # f32 for the kernel: a bf16 compute copy (``cast_for_compute`` casts
    # the stacked A_log) gives a bf16 A, which the reference promotes
    # exactly to f32 in ``dt * A``
    A = -torch.exp(params["A_log"]).float()

    # padded steps have dt = 0: they neither add to nor decay the state, so
    # the final state is exact for any prompt length
    chunk = min(ssm.chunk_size, s)
    pad = (-s) % chunk
    if pad:
        xs = F.pad(xs, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B_mat = F.pad(B_mat, (0, 0, 0, 0, 0, pad))
        C_mat = F.pad(C_mat, (0, 0, 0, 0, 0, pad))

    y, hT = ssd_scan_op(xs, dt, A, B_mat, C_mat, chunk=chunk)
    y = y + params["D"][None, None, :, None] * xs.float()
    y = y[:, :s].reshape(b, s, d_inner).to(x.dtype)

    y = y * F.silu(z.float()).to(x.dtype)
    y = rms_norm(params["gate_norm"], y)
    out = matmul(y, params["out_proj"])
    if not return_state:
        return out
    # decode-ready state: SSD state + conv ring of the last (K-1) raw xBC
    k = ssm.conv_kernel
    conv_state = torch.zeros((b, k - 1, d_inner + d_bc), dtype=x.dtype,
                             device=x.device)
    take = min(k - 1, s)
    conv_state[:, k - 1 - take:] = xbc_raw[:, s - take:]
    return out, {"h": hT, "conv": conv_state}


# --------------------------------------------------------------------------
# Decode: O(1) state per layer
# --------------------------------------------------------------------------

def ssm_init_state(batch, d_model, ssm: SSMConfig, dtype=torch.float32,
                   device="cuda"):
    d_inner, n_heads, d_bc = ssm_dims(d_model, ssm)
    return {
        "h": torch.zeros((batch, n_heads, ssm.head_dim, ssm.d_state),
                         dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, ssm.conv_kernel - 1, d_inner + d_bc),
                            dtype=dtype, device=device),
    }


def ssm_decode_step(params, x, state, d_model, ssm: SSMConfig):
    """One-token step.  x: (B, d_model).  Returns (y, new_state).

    Every row advances, as in the reference: the engine overwrites a batch
    slot's state on prefill and resume."""
    b = x.shape[0]
    d_inner, n_heads, d_bc = ssm_dims(d_model, ssm)
    g, n = ssm.n_groups, ssm.d_state

    z, xs, bc, dt = _project(params, x)
    xbc = torch.cat([xs, bc], dim=-1)
    hist, xbc = _promote(state["conv"], xbc[:, None, :])
    hist = torch.cat([hist, xbc], dim=1)
    conv_w = torch.cat([params["conv_x"], params["conv_bc"]], dim=-1)
    hist_c, conv_w = _promote(hist, conv_w)
    conv = torch.einsum("bkc,kc->bc", hist_c, conv_w) + params["conv_b"]
    conv = F.silu(conv.float()).to(x.dtype)
    new_conv = hist[:, 1:, :]

    xs = conv[..., :d_inner].reshape(b, n_heads, ssm.head_dim)
    B_mat = conv[..., d_inner:d_inner + g * n].reshape(b, g, n)
    C_mat = conv[..., d_inner + g * n:].reshape(b, g, n)
    dt = _softplus(dt.float() + params["dt_bias"])          # (B,H)
    A = -torch.exp(params["A_log"])

    hpg = n_heads // g
    Bh = B_mat.repeat_interleave(hpg, dim=1).float()        # (B,H,N)
    Ch = C_mat.repeat_interleave(hpg, dim=1).float()

    a = torch.exp(dt * A[None, :])                          # (B,H)
    h = state["h"] * a[:, :, None, None] + torch.einsum(
        "bh,bhp,bhn->bhpn", dt, xs.float(), Bh)
    y = torch.einsum("bhn,bhpn->bhp", Ch, h)
    y = y + params["D"][None, :, None] * xs.float()
    y = y.reshape(b, d_inner).to(x.dtype)

    y = y * F.silu(z.float()).to(x.dtype)
    y = rms_norm(params["gate_norm"], y)
    out = matmul(y, params["out_proj"])
    return out, {"h": h, "conv": new_conv}
