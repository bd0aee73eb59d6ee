"""Mixture-of-experts FFN (PyTorch) with expert parallelism.

Two paths, as in the reference:

* ``moe_ffn_reference`` — exact loop-over-experts oracle (no capacity drops).
* ``moe_ffn`` — capacity-bounded sort-based dispatch (the reference's
  ``_dispatch_local``).  Without a mesh one shard holds every expert.  On a
  rank of a mesh (expert parallelism, EP) the experts are cut over the
  model axis: the tokens are the rank's rows, replicated over the axis,
  each rank dispatches only the entries routed to *its* ``e_local``
  experts, and one sum over the axis combines them, as the reference's
  ``psum`` inside its ``shard_map``.  The router runs on the rank's rows
  and the capacity comes from the rank's token count; the aux loss is the
  global batch's, as the reference's router runs under GSPMD over every
  data-sharded row: its sums and row count are summed over the batch
  axes.  Under autograd the rows and gates enter the rank's experts
  through ``mesh.enter`` (``launch/mesh.py``).

What the port keeps bit for bit from the reference, and how:

* **The router is f32** whatever the weights' dtype: ``router`` is an f32
  leaf and the logits are ``x.float() @ router``.
* **Ties go to the lower expert index**, as ``jax.lax.top_k`` orders them:
  the top k are the first k of a *stable* descending sort (``torch.topk``
  promises no order among equal values).
* **Drops.** The capacity is ``max(int(T k / E cf), 8)`` over the T rows of
  the call.  Entries are sorted stably by expert; of the first
  ``e_local * cap`` sorted entries, each expert keeps its first ``cap`` in
  token order; every other entry is dropped (gate 0).
* **A fixed order of sums.** The reference combines with a scatter-add; an
  f32 ``index_add_`` uses atomics on CUDA, whose order changes from call to
  call.  Here each token's k weighted outputs are gathered into a
  (T, k, d) tensor (zero where dropped) and summed over k by one reduction,
  whose order is fixed for the shape, so two calls give the same bits and a row's output does not depend on the
  other rows of its call (given the same capacity).

The expert products are batched matmuls over a (E, cap + 1, d) buffer, as
the reference's einsums are; no Pallas kernel belongs to MoE.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.models.layers import matmul, model_ranks, normal_, swiglu


def padded_experts(moe: MoEConfig, ep_align: int = 16) -> int:
    """Expert-table size padded so EP shards cleanly (qwen: 60 -> 64).

    Padding experts are never routed to (router has n_experts logits)."""
    return -(-moe.n_experts // ep_align) * ep_align


def init_moe(d: int, moe: MoEConfig, n_layers: int, *,
             generator: torch.Generator, dtype=torch.float32, device="cuda"):
    """The ``moe`` subtree of ``n_layers`` stacked layers with the
    reference's shapes, dtypes and scales: an f32 router at 0.006, experts
    and shared experts at 0.02.  Filled layer by layer in place."""
    e_pad, f = padded_experts(moe), moe.d_expert
    empty = lambda *shape: torch.empty(shape, dtype=dtype, device=device)
    params = {
        "router": torch.empty((n_layers, d, moe.n_experts),
                              dtype=torch.float32, device=device),
        "experts": {"wg": empty(n_layers, e_pad, d, f),
                    "wu": empty(n_layers, e_pad, d, f),
                    "wd": empty(n_layers, e_pad, f, d)},
    }
    random = [(params["router"], 0.006)] + \
        [(w, 0.02) for w in params["experts"].values()]
    if moe.n_shared:
        fs = moe.n_shared * f
        params["shared"] = {"wgu": empty(n_layers, d, 2 * fs),
                            "wd": empty(n_layers, fs, d)}
        random += [(w, 0.02) for w in params["shared"].values()]
    for i in range(n_layers):
        for w, scale in random:
            normal_(w[i], generator, scale)
    return params


def _route(params, x, moe: MoEConfig):
    """(eids, gates, probs, per-row expert indicator, per-row lse^2) of the
    router over x (T, d)."""
    logits = x.float() @ params["router"].float()
    probs = torch.softmax(logits, dim=-1)
    # stable descending sort: on a tie the lower expert index comes first
    gates, eids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, eids = gates[:, :moe.top_k], eids[:, :moe.top_k]
    if moe.renorm_topk:
        gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
    ind = F.one_hot(eids, moe.n_experts).float().sum(1)              # (T,E)
    return eids, gates, probs, ind, torch.logsumexp(logits, dim=-1) ** 2


def _aux(moe: MoEConfig, f_e, p_e, zmean):
    """Load-balance aux, E * sum_e (frac tokens to e) * (mean prob of e),
    plus the z-loss."""
    aux = moe.n_experts * torch.sum(f_e * p_e) * moe.router_aux_coef
    return aux + zmean * moe.router_z_coef


def router_topk(params, x, moe: MoEConfig):
    """Router probabilities + top-k selection + aux losses.

    x: (T, d).  Returns (eids (T,k) int64, gates (T,k) f32, aux_loss scalar).
    """
    eids, gates, probs, ind, lse2 = _route(params, x, moe)
    return eids, gates, _aux(moe, ind.mean(0) / moe.top_k, probs.mean(0),
                             lse2.mean())


def router_topk_global(params, x, moe: MoEConfig, mesh, dp_axes):
    """``router_topk`` over a rank's rows x, with the aux loss of every
    rank's rows over ``dp_axes`` (the reference's router runs under GSPMD
    over the global batch): the indicator, probability and lse^2 sums and
    the row count summed over the axes in one all-reduce."""
    eids, gates, probs, ind, lse2 = _route(params, x, moe)
    e = moe.n_experts
    sums = mesh.all_reduce(torch.cat([
        ind.sum(0), probs.sum(0), lse2.sum()[None],
        torch.full((1,), x.shape[0], dtype=torch.float32, device=x.device)]),
        dp_axes, "sum")
    t = sums[-1]
    return eids, gates, _aux(moe, sums[:e] / t / moe.top_k, sums[e:2 * e] / t,
                             sums[2 * e] / t)


def _expert_mlp(x, wg, wu, wd):
    """SwiGLU of every expert over its rows.  x: (E, C, d); w*: (E, ...)."""
    h = matmul(x, wg)
    u = matmul(x, wu)
    h = F.silu(h.float()).to(x.dtype) * u
    return matmul(h, wd)


def moe_ffn_reference(params, x, moe: MoEConfig):
    """Exact oracle: every expert applied to every token, masked combine."""
    t, d = x.shape
    eids, gates, aux = router_topk(params, x, moe)
    out = torch.zeros((t, d), dtype=torch.float32, device=x.device)
    ex = params["experts"]
    for e in range(moe.n_experts):
        ye = _expert_mlp(x, ex["wg"][e], ex["wu"][e], ex["wd"][e]).float()
        w = torch.where(eids == e, gates, 0.0).sum(-1)                # (T,)
        out = out + w[:, None] * ye
    if moe.n_shared:
        out = out + swiglu(params["shared"], x).float()
    return out.to(x.dtype), aux


def _dispatch_local(x, eids, gates, wg, wu, wd, *, e_base, e_local, cap):
    """Capacity-bounded dispatch of tokens to the local experts.

    x: (T, d); eids/gates: (T, k); w*: (E_loc, ...).  Returns (T, d) f32.
    """
    t, d = x.shape
    k = eids.shape[1]
    n = t * k
    dev = x.device
    flat_e = eids.reshape(-1).long() - e_base                        # (T*k,)
    valid = (flat_e >= 0) & (flat_e < e_local)

    # stable sort by local expert; invalid entries pushed to the end
    key, order = torch.sort(torch.where(valid, flat_e, e_local), stable=True)
    # position within each expert's group (the groups are contiguous)
    rank = torch.arange(n, device=dev)
    pos = rank - torch.searchsorted(key, key)
    keep = (key < e_local) & (pos < cap) & (rank < e_local * cap)
    # buffer row of each sorted entry: expert-major, cap + 1 rows an expert
    # (the last one a pad row, as in the reference); dropped entries go to
    # one spare row past the buffer, never read
    spare = e_local * (cap + 1)
    row = torch.where(keep, key * (cap + 1) + pos, spare)
    buf = x.new_zeros((spare + 1, d))
    buf[row] = x[order // k]
    y = _expert_mlp(buf[:spare].view(e_local, cap + 1, d), wg, wu, wd)
    y = torch.cat([y.reshape(spare, d), y.new_zeros((1, d))])

    # back to (token, choice) order: entry order[i] is sorted entry i
    entry_row = torch.empty_like(row)
    entry_row[order] = row
    vals = y[entry_row].float() * gates.reshape(-1, 1).float()
    # one reduction over k, in a fixed order for the shape and with no
    # atomics, where the reference scatter-adds
    return vals.view(t, k, d).sum(1)


def capacity(t: int, moe: MoEConfig) -> int:
    """Entries each expert keeps in a call that routes ``t`` rows."""
    return max(int(t * moe.top_k / moe.n_experts * moe.capacity_factor), 8)


def moe_ffn(params, x, moe: MoEConfig, *, mesh=None, model_axis="model",
            dp_axes=()):
    """Routed + shared expert FFN.  x: (B, S, d) (or (T, d)).

    Capacity-bounded dispatch over every (B * S) row of the call.  On a
    rank of ``mesh`` (more than one rank on ``model_axis``): ``x`` is the
    rank's rows, the expert tables (and the shared experts) are its blocks
    under ``param_pspecs``, and the output is summed over the axis; the
    aux loss is the rows' of every rank over ``dp_axes``
    (``router_topk_global``).
    Returns (out in x's dtype, aux_loss)."""
    squeeze = x.dim() == 2
    if squeeze:
        x = x[None]
    b, s, d = x.shape
    xt = x.reshape(-1, d)
    if mesh is not None and mesh.axis_size(dp_axes) > 1:
        eids, gates, aux = router_topk_global(params, xt, moe, mesh, dp_axes)
    else:
        eids, gates, aux = router_topk(params, xt, moe)
    wg, wu, wd = (params["experts"][n] for n in ("wg", "wu", "wd"))
    ep, rank = model_ranks(mesh, model_axis)
    e_pad = padded_experts(moe)
    e_local = e_pad // ep if e_pad % ep == 0 else -(-moe.n_experts // ep)
    if wg.shape[0] == e_pad and ep > 1:
        # a whole table (e_pad does not divide EP): pad it to e_local * ep
        # experts, as the reference does, and take this rank's block
        if e_local * ep < e_pad:
            raise ValueError(f"{e_pad} experts do not fit {ep} ranks of "
                             f"{e_local}")
        lo, hi = rank * e_local, (rank + 1) * e_local
        wg, wu, wd = (F.pad(mesh.enter(w, model_axis),
                            (0, 0, 0, 0, 0, e_local * ep - e_pad))[lo:hi]
                      for w in (wg, wu, wd))
    if ep > 1:                         # the rows enter the rank's experts
        xt, gates = mesh.enter(xt, model_axis), mesh.enter(gates, model_axis)
    out = _dispatch_local(xt, eids, gates, wg, wu, wd, e_base=rank * e_local,
                          e_local=e_local, cap=capacity(b * s, moe))
    if ep > 1:
        out = mesh.all_reduce(out, model_axis, "sum")
    out = out.reshape(b, s, d).to(x.dtype)
    if moe.n_shared:
        out = out + swiglu(params["shared"], x, mesh, model_axis,
                           moe.n_shared * moe.d_expert)
    if squeeze:
        out = out[0]
    return out, aux
