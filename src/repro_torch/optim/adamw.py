"""AdamW + schedule + global-norm clipping over parameter trees (PyTorch).

The update is the reference's formula written out by hand, not
``torch.optim.AdamW``: f32 moments, the learning-rate schedule and the bias
corrections computed in f32 tensors from the int32 step, decoupled weight
decay on leaves of two or more dimensions only, and the global gradient
norm summed over the leaves in the reference's order (``tree_flatten``:
dict keys sorted).  Every function is pure: it returns new tensors and
leaves its arguments as they were.  ZeRO-1 moment sharding comes with the
multi-device launch layer (ROADMAP Queue 1 item 13).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, NamedTuple

import torch

from repro_torch.bridge import tree_flatten, tree_map, tree_unflatten


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


def update(cfg: AdamWConfig, params, grads, state: AdamWState):
    """One AdamW step.  Returns (new_params, new_state, metrics) with
    ``metrics = {"lr", "grad_norm"}`` as f32 scalar tensors.  The clipped
    f32 gradient is formed one leaf at a time, and each leaf's
    intermediates are updated in place, so the update holds about one leaf
    beyond its outputs (a full-width model's state fits the card); every
    operation rounds as the reference's expression does."""
    flat_p, structure = tree_flatten(params)
    flat_g = tree_flatten(grads)[0]
    flat_m = tree_flatten(state.mu)[0]
    flat_v = tree_flatten(state.nu)[0]
    if not len(flat_p) == len(flat_g) == len(flat_m) == len(flat_v):
        raise ValueError("params, grads and moments differ in their leaves")
    gnorm = global_norm(flat_g)
    scale = _clip_scale(gnorm, cfg.clip_norm)
    step = state.step + 1
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

    res = [upd(p, g, m, v) for p, g, m, v in
           zip(flat_p, flat_g, flat_m, flat_v)]
    newp = tree_unflatten(structure, [r[0] for r in res])
    mu = tree_unflatten(structure, [r[1] for r in res])
    nu = tree_unflatten(structure, [r[2] for r in res])
    return newp, AdamWState(step, mu, nu), {"lr": lr, "grad_norm": gnorm}
