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

On a rank of a mesh (``mesh``, ``axis``: tensor parallelism over the model
axis) the weights are this rank's blocks under ``param_pspecs``: ``wz``,
``wx``, ``wdt`` and ``conv_x`` column-parallel, ``wbc`` and ``conv_bc``
whole, ``A_log``, ``D`` and ``dt_bias`` cut on heads, ``gate_norm`` on
``d_inner``, ``out_proj`` row-parallel.  The recurrence runs on the part
of the SSD state the rank owns (``tp_layout``, the placement of the
decode state ``ssm_h``): its block of heads; else, where the heads do not
divide the axis, every head's block of head_dim (the recurrence is
independent per head_dim row); else all of it.  ``x`` and the outputs are
whole and replicated over the axis; the gate norm's mean of squares is
summed over it, and the decode's conv ring (replicated) gets the rank's
``x`` columns back in one all-gather.  Under autograd every replicated
value that enters the rank's part passes ``mesh.enter`` (``launch/mesh.py``):
``x`` into the cut projections, the conv bias's x block, and, where the
recurrence runs on the rank's part, ``B``, ``C`` and (on head_dim) ``dt``,
``A`` and ``D``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMConfig
from repro_torch.kernels.ops import ssd_scan_op
from repro_torch.models.layers import (col_parallel, matmul, model_ranks,
                                       rms_norm, row_parallel)


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


def _project(params, x, d_inner, n_heads, mesh=None, axis="model"):
    """z, x, B/C and dt before the conv: ``wz``, ``wx`` and ``wdt``
    column-parallel on ``mesh``, ``wbc`` whole."""
    z = col_parallel(x, params["wz"], d_inner, mesh, axis)
    xs = col_parallel(x, params["wx"], d_inner, mesh, axis)
    bc = matmul(x, params["wbc"])
    dt = col_parallel(x, params["wdt"], n_heads, mesh, axis)
    return z, xs, bc, dt


def _enter(t, mesh, axis):
    """``mesh.enter`` (the identity without a mesh)."""
    return t if mesh is None else mesh.enter(t, axis)


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


# --------------------------------------------------------------------------
# Tensor parallelism
# --------------------------------------------------------------------------

def tp_layout(n_heads: int, head_dim: int, tp: int):
    """The dim of the SSD state (B, H, P, N) that ``tp`` model ranks cut:
    "heads", else "head_dim", else None (replicated), as ``decode_struct``
    places ``ssm_h``."""
    if n_heads % tp == 0:
        return "heads"
    if head_dim % tp == 0:
        return "head_dim"
    return None


def _block(x, n, rank, dim=-1):
    """This rank's block of ``n`` along ``dim``."""
    return x.narrow(dim, rank * n, n)


def _conv_b(params, d_inner, rank, mesh=None, axis="model"):
    """The conv bias of this rank's conv channels: its block of the x
    channels (where ``conv_x`` is cut), then the whole B/C part."""
    cb, nx = params["conv_b"], params["conv_x"].shape[-1]
    if nx == d_inner:
        return cb
    return torch.cat([_block(_enter(cb[:d_inner], mesh, axis), nx, rank),
                      cb[d_inner:]])


def _state_part(xs, dt, params, ssm: SSMConfig, n_heads, mesh, axis):
    """The rank's part of the SSD inputs.  ``xs`` (..., d_inner_cols) is
    the conv output on the rank's x columns, ``dt`` (..., H_cols) its dt
    before the bias.  Returns xs (..., H_l, P_l), dt (..., H_l) after
    softplus, A (H_l,) and D (H_l,) for ``tp_layout``'s part."""
    tp, rank = model_ranks(mesh, axis)
    layout = tp_layout(n_heads, ssm.head_dim, tp)
    if layout != "heads" and xs.shape[-1] != n_heads * ssm.head_dim:
        xs = mesh.all_gather(xs, axis, dim=-1)
    xs = xs.reshape(*xs.shape[:-1], -1, ssm.head_dim)
    dt = _softplus(dt.float() + params["dt_bias"])
    A, D = -torch.exp(params["A_log"]), params["D"]
    if layout == "head_dim" and tp > 1:
        # every head's block of head_dim: the replicated per-head inputs
        # enter the rank's part
        xs = _block(mesh.enter(xs, axis), ssm.head_dim // tp, rank)
        dt, A, D = (mesh.enter(t, axis) for t in (dt, A, D))
    return xs, dt, A, D


def _gate_out(y, z, params, d_inner, ssm: SSMConfig, n_heads, mesh, axis):
    """y (..., H_l, P_l) in x's dtype -> the gated, normed, projected
    output, whole and replicated over the axis."""
    tp, rank = model_ranks(mesh, axis)
    if tp_layout(n_heads, ssm.head_dim, tp) == "head_dim":
        y = mesh.all_gather(y, axis, dim=-1)
    y = y.reshape(*y.shape[:-2], -1)
    if y.shape[-1] != z.shape[-1]:                # back to z's column block
        y = _block(mesh.enter(y, axis), z.shape[-1], rank)
    y = y * F.silu(z.float()).to(y.dtype)
    if z.shape[-1] == d_inner:
        y = rms_norm(params["gate_norm"], y)
    else:                                         # the mean over all d_inner
        yf = y.float()
        # the sum feeds the rank's columns: its backward sums theirs
        var = mesh.enter(mesh.all_reduce((yf * yf).sum(-1, keepdim=True),
                                         axis, "sum"), axis)
        y = (yf * torch.rsqrt(var / d_inner + 1e-5)
             * (1.0 + params["gate_norm"].float())).to(y.dtype)
    return row_parallel(y, params["out_proj"], d_inner, mesh, axis)


def _groups(mat, n_heads, xs_heads, mesh, axis):
    """B or C (..., G, N) for the heads of ``xs_heads``: as it is with one
    group or every head; else one group per local head."""
    g = mat.shape[-2]
    if g == 1 or xs_heads == n_heads:
        return mat
    per_head = mat.repeat_interleave(n_heads // g, dim=-2)
    return _block(per_head, xs_heads, model_ranks(mesh, axis)[1], dim=-2)


def _pad_steps(chunk, s, *ts):
    """Pad dim 1 of each tensor to a multiple of ``chunk``.  Padded steps
    have dt = 0: they neither add to nor decay the state, so the final
    state is exact for any prompt length."""
    pad = (-s) % chunk
    return [F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad)) if pad else t
            for t in ts]


def ssm_forward(params, x, d_model, ssm: SSMConfig, return_state=False, *,
                mesh=None, axis="model"):
    """Full SSD mixer over a sequence.  x: (B,S,d_model).  ``mesh``: see
    the module docstring (``return_state`` is for one rank)."""
    b, s, _ = x.shape
    d_inner, n_heads, d_bc = ssm_dims(d_model, ssm)
    g, n = ssm.n_groups, ssm.d_state
    tp, rank = model_ranks(mesh, axis)
    if return_state and tp > 1:
        raise ValueError("return_state takes one rank")

    z, xs, bc, dt = _project(params, x, d_inner, n_heads, mesh, axis)
    xbc_raw = torch.cat([xs, bc], dim=-1)
    conv_w = torch.cat([params["conv_x"], params["conv_bc"]], dim=-1)
    xbc = _causal_conv(conv_w, _conv_b(params, d_inner, rank, mesh, axis),
                       xbc_raw, ssm.conv_kernel)
    nx = xs.shape[-1]                  # this rank's x columns
    B_mat = xbc[..., nx:nx + g * n].reshape(b, s, g, n)
    C_mat = xbc[..., nx + g * n:].reshape(b, s, g, n)
    if tp > 1 and tp_layout(n_heads, ssm.head_dim, tp):
        # the recurrence runs on the rank's part
        B_mat, C_mat = mesh.enter(B_mat, axis), mesh.enter(C_mat, axis)
    xs, dt, A, D = _state_part(xbc[..., :nx], dt, params, ssm, n_heads,
                               mesh, axis)
    B_mat = _groups(B_mat, n_heads, xs.shape[2], mesh, axis)
    C_mat = _groups(C_mat, n_heads, xs.shape[2], mesh, axis)

    chunk = min(ssm.chunk_size, s)
    xs, dt, B_mat, C_mat = _pad_steps(chunk, s, xs, dt, B_mat, C_mat)
    # f32 for the kernel: a bf16 compute copy (``cast_for_compute`` casts
    # the stacked A_log) gives a bf16 A, which the reference promotes
    # exactly to f32 in ``dt * A``
    y, hT = ssd_scan_op(xs, dt, A.float(), B_mat, C_mat, chunk=chunk)
    y = (y + D[None, None, :, None] * xs.float())[:, :s].to(x.dtype)
    out = _gate_out(y, z, params, d_inner, ssm, n_heads, mesh, axis)
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


def ssm_decode_step(params, x, state, d_model, ssm: SSMConfig, *,
                    mesh=None, axis="model"):
    """One-token step.  x: (B, d_model).  Returns (y, new_state).

    Every row advances, as in the reference: the engine overwrites a batch
    slot's state on prefill and resume.  ``mesh``: see the module
    docstring; ``state["h"]`` is then the rank's part (``tp_layout``) and
    ``state["conv"]`` whole."""
    b = x.shape[0]
    d_inner, n_heads, d_bc = ssm_dims(d_model, ssm)
    g, n = ssm.n_groups, ssm.d_state
    _, rank = model_ranks(mesh, axis)

    z, xs, bc, dt = _project(params, x, d_inner, n_heads, mesh, axis)
    nx = xs.shape[-1]                  # this rank's x columns
    # the conv ring holds every x column: gather the rank's
    xs_all = xs if nx == d_inner else mesh.all_gather(xs, axis, dim=-1)
    hist, xbc = _promote(state["conv"],
                         torch.cat([xs_all, bc], dim=-1)[:, None, :])
    hist = torch.cat([hist, xbc], dim=1)
    new_conv = hist[:, 1:, :]
    # the conv of the rank's channels: its x columns, then B/C
    mine = hist if nx == d_inner else torch.cat(
        [_block(hist[..., :d_inner], nx, rank), hist[..., d_inner:]], dim=-1)
    conv_w = torch.cat([params["conv_x"], params["conv_bc"]], dim=-1)
    mine, conv_w = _promote(mine, conv_w)
    conv = torch.einsum("bkc,kc->bc", mine, conv_w) + \
        _conv_b(params, d_inner, rank)
    conv = F.silu(conv.float()).to(x.dtype)

    B_mat = conv[..., nx:nx + g * n].reshape(b, g, n)
    C_mat = conv[..., nx + g * n:].reshape(b, g, n)
    xs, dt, A, D = _state_part(conv[..., :nx], dt, params, ssm, n_heads,
                               mesh, axis)
    hl = xs.shape[1]
    Bh = _groups(B_mat, n_heads, hl, mesh, axis)
    Ch = _groups(C_mat, n_heads, hl, mesh, axis)
    Bh = Bh.repeat_interleave(hl // Bh.shape[1], dim=1).float()   # (B,H_l,N)
    Ch = Ch.repeat_interleave(hl // Ch.shape[1], dim=1).float()

    a = torch.exp(dt * A[None, :])                          # (B,H_l)
    h = state["h"] * a[:, :, None, None] + torch.einsum(
        "bh,bhp,bhn->bhpn", dt, xs.float(), Bh)
    y = torch.einsum("bhn,bhpn->bhp", Ch, h)
    y = (y + D[None, :, None] * xs.float()).to(x.dtype)
    out = _gate_out(y, z, params, d_inner, ssm, n_heads, mesh, axis)
    return out, {"h": h, "conv": new_conv}
