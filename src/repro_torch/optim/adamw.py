"""AdamW + schedule + global-norm clipping over parameter trees (PyTorch).

The update is the reference's formula written out by hand, not
``torch.optim.AdamW``: f32 moments, the learning-rate schedule and the bias
corrections computed in f32 tensors from the int32 step, decoupled weight
decay on leaves of two or more dimensions only, and the global gradient
norm summed over the leaves in the reference's order (``tree_flatten``:
dict keys sorted).  ``update`` and ``update_sharded`` are pure: they
return new tensors and leave their arguments as they were.

On a rank mesh (``launch/mesh.py``) ``reduce_grads`` sums each gradient
over the batch axes its parameter is not cut on, and ``update_sharded``
takes the rank's shards: the global norm is summed over every axis that
cuts a leaf (a replicated leaf counted once), and under ZeRO-1
(``zero1_specs``: the moments cut over the batch axes on top of the
tensor-parallel placement) each rank keeps and updates its block of the
gradient, the moments and the parameter, then gathers the new parameter
back to its placement.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, NamedTuple

import torch

from repro_torch.bridge import (is_spec, tree_flatten, tree_map,
                                tree_map_specs, tree_unflatten)


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_fraction: float = 0.1
    clip_norm: float = 1.0


class AdamWState(NamedTuple):
    step: torch.Tensor          # int32 scalar: updates taken so far
    mu: Any
    nu: Any


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay to ``min_lr_fraction``; an f32 scalar."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_fraction + (1 - cfg.min_lr_fraction) * cos
    return cfg.lr * warm * frac


def init(params) -> AdamWState:
    """Step 0 and zero f32 moments on each parameter's device."""
    zeros = lambda t: tree_map(
        lambda a: torch.zeros(a.shape, dtype=torch.float32, device=a.device), t)
    device = tree_flatten(params)[0][0].device
    return AdamWState(torch.zeros((), dtype=torch.int32, device=device),
                      zeros(params), zeros(params))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf in f32, leaves summed one by
    one in ``tree_flatten`` order."""
    total = 0
    for leaf in tree_flatten(tree)[0]:
        total = total + torch.sum(leaf.to(torch.float32) ** 2)
    return torch.sqrt(total)


def _clip_scale(norm, max_norm):
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm):
    """(grads scaled so that their global norm is at most ``max_norm``,
    the norm before scaling)."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: g * scale, grads), norm


def _flat(params, grads, state: AdamWState):
    flat_p, structure = tree_flatten(params)
    flat_g = tree_flatten(grads)[0]
    flat_m = tree_flatten(state.mu)[0]
    flat_v = tree_flatten(state.nu)[0]
    if not len(flat_p) == len(flat_g) == len(flat_m) == len(flat_v):
        raise ValueError("params, grads and moments differ in their leaves")
    return structure, flat_p, flat_g, flat_m, flat_v


def _leaf_update(cfg: AdamWConfig, step, scale):
    """``upd(p, g, m, v) -> (new p, m, v)`` for the step after ``step``
    with the clip ``scale``, and that step's (number, lr).  The clipped
    f32 gradient is formed one leaf at a time and each leaf's
    intermediates are updated in place, so the update holds about one leaf
    beyond its outputs (a full-width model's state fits the card); every
    operation rounds as the reference's expression does."""
    step = step + 1
    lr = schedule(cfg, step)
    b1c = 1 - cfg.b1 ** step.to(torch.float32)
    b2c = 1 - cfg.b2 ** step.to(torch.float32)

    def upd(p, g, m, v):
        g = g.to(torch.float32) * scale
        m = (m * cfg.b1).add_(g * (1 - cfg.b1))
        v = (v * cfg.b2).add_(g.mul_(g).mul_(1 - cfg.b2))
        del g
        delta = (m / b1c).div_((v / b2c).sqrt_().add_(cfg.eps))
        p32 = p.to(torch.float32)
        if p.ndim >= 2:                    # decay matrices only
            delta.add_(p32 * cfg.weight_decay)
        newp = p32 - delta.mul_(lr)
        return newp.to(p.dtype), m, v

    return upd, step, lr


def _state(structure, step, res):
    newp = tree_unflatten(structure, [r[0] for r in res])
    mu = tree_unflatten(structure, [r[1] for r in res])
    nu = tree_unflatten(structure, [r[2] for r in res])
    return newp, AdamWState(step, mu, nu)


def update(cfg: AdamWConfig, params, grads, state: AdamWState):
    """One AdamW step.  Returns (new_params, new_state, metrics) with
    ``metrics = {"lr", "grad_norm"}`` as f32 scalar tensors."""
    structure, flat_p, flat_g, flat_m, flat_v = _flat(params, grads, state)
    gnorm = global_norm(flat_g)
    upd, step, lr = _leaf_update(cfg, state.step,
                                 _clip_scale(gnorm, cfg.clip_norm))
    res = [upd(p, g, m, v) for p, g, m, v in
           zip(flat_p, flat_g, flat_m, flat_v)]
    newp, new_state = _state(structure, step, res)
    return newp, new_state, {"lr": lr, "grad_norm": gnorm}


# --------------------------------------------------------------------------
# Sharded: a rank of a mesh, ZeRO-1 over the batch axes
# --------------------------------------------------------------------------

def axes_of(spec):
    """The mesh axes a placement names, in order."""
    out = []
    for entry in spec:
        out.extend((entry,) if isinstance(entry, str) else entry or ())
    return tuple(out)


def zero1_specs(param_specs, params_shape, dp_axes=("data",), dp_size=1):
    """The moments' placements under ZeRO-1: each parameter's placement
    with its first dim that the placement leaves whole and that ``dp_size``
    divides cut over the batch axes ``dp_axes`` (one entry: the axis, or
    the tuple of them); a parameter with no such dim keeps its placement
    (replicated moments: only small norms and biases in practice)."""
    dp = dp_axes if len(dp_axes) > 1 else dp_axes[0]

    def moment_spec(spec, leaf):
        parts = list(spec)
        for i, p in enumerate(parts):
            if p is None and leaf.shape[i] % dp_size == 0 and leaf.shape[i] > 0:
                parts[i] = dp
                break
        return tuple(parts)

    return tree_map_specs(moment_spec, param_specs, params_shape)


def _zero1_dim(pspec, mspec):
    """(dim, axes) where the moments' placement cuts a dim that the
    parameter's leaves whole, or None."""
    for i, (p, m) in enumerate(zip(pspec, mspec)):
        if p != m:
            return i, ((m,) if isinstance(m, str) else tuple(m))
    return None


def _block(t, mesh, dim, axes):
    """This rank's block of ``t`` along ``dim`` over ``axes``."""
    n = t.shape[dim] // mesh.axis_size(axes)
    return t.narrow(dim, mesh.index(axes) * n, n)


def reduce_grads(grads, *, mesh, param_specs, moment_specs, batch_axes):
    """The rank's gradients (over its rows of the batch) summed over the
    ``batch_axes`` each parameter is not cut on, as a list in
    ``tree_flatten`` order; where the moments cut a dim over batch axes
    (ZeRO-1) the rank keeps its block of the sum (the transport is an
    all-reduce followed by the slice: gloo has no reduce-scatter on CUDA
    tensors).  The sums are taken in each gradient's own dtype, before
    any cast for accumulation, as the reference's SPMD step sums each
    microbatch's gradients.  Sums in place where the gradient is not a
    view."""
    flat_g = tree_flatten(grads)[0]
    flat_ps = tree_flatten(param_specs, is_leaf=is_spec)[0]
    flat_ms = tree_flatten(moment_specs, is_leaf=is_spec)[0]
    out = []
    for g, ps, ms in zip(flat_g, flat_ps, flat_ms):
        red = tuple(a for a in batch_axes if a not in axes_of(ps))
        if red:
            g = mesh.all_reduce(g.contiguous(), red, "sum")
        z = _zero1_dim(ps, ms)
        out.append(g if z is None else _block(g, mesh, *z))
    return out


def update_sharded(cfg: AdamWConfig, params, grads, state: AdamWState, *,
                   mesh, param_specs, moment_specs):
    """One AdamW step on a rank of ``mesh``: ``params`` are the rank's
    shards under ``param_specs``, the moments its blocks under
    ``moment_specs``, ``grads`` (a list in ``tree_flatten`` order) the
    summed gradients of ``reduce_grads``, blocks of the moments' shape.

    * The global norm: each block's sum of squares, summed over the axes
      that cut the block (one all-reduce per set of axes), so that a
      replicated leaf counts once.
    * Each rank updates its blocks, then gathers the new parameter block
      back over the batch axes to the parameter's placement (ZeRO-1).

    Returns (new_params, new_state, metrics) as ``update``; the metrics are
    the same on every rank."""
    structure, flat_p, _, flat_m, flat_v = _flat(params, params, state)
    flat_ps = tree_flatten(param_specs, is_leaf=is_spec)[0]
    flat_ms = tree_flatten(moment_specs, is_leaf=is_spec)[0]
    if len(grads) != len(flat_p):
        raise ValueError("params and grads differ in their leaves")
    sq = [torch.sum(g.to(torch.float32) ** 2) for g in grads]
    cuts = [axes_of(ms) for ms in flat_ms]
    for axes in sorted(set(cuts)):
        if axes and mesh.axis_size(axes) > 1:
            idx = [i for i, c in enumerate(cuts) if c == axes]
            summed = mesh.all_reduce(torch.stack([sq[i] for i in idx]),
                                     axes, "sum")
            for j, i in enumerate(idx):
                sq[i] = summed[j]
    total = 0
    for v in sq:
        total = total + v
    gnorm = torch.sqrt(total)
    upd, step, lr = _leaf_update(cfg, state.step,
                                 _clip_scale(gnorm, cfg.clip_norm))
    res = []
    for p, g, m, v, ps, ms in zip(flat_p, grads, flat_m, flat_v, flat_ps,
                                  flat_ms):
        z = _zero1_dim(ps, ms)
        if z is None:
            res.append(upd(p, g, m, v))
            continue
        newp, m, v = upd(_block(p, mesh, *z), g, m, v)
        res.append((mesh.all_gather(newp, z[1], dim=z[0]), m, v))
    newp, new_state = _state(structure, step, res)
    return newp, new_state, {"lr": lr, "grad_norm": gnorm}
