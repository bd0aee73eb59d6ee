"""Training loop: microbatched gradient accumulation, mixed precision and
ZeRO-1 (PyTorch).

``make_train_step`` builds the step function ``fit`` runs:

* the f32 master parameters are cast to ``compute_dtype`` (every floating
  leaf of two or more dimensions, stacked norms and the MoE router
  included), and the gradients are taken with respect to that cast copy,
  as the reference differentiates its cast tree;
* each microbatch's gradients are added, in ``grad_dtype``, into
  accumulators that start at zero, then divided by the microbatch count
  (bf16 halves the gradient bytes: the reference's compression knob);
* ``optim.update`` applies AdamW to the f32 masters.

Batches arrive microbatch-major, (n_micro, mb, S).

On a rank mesh (``ctx.mesh``, ``launch/mesh.py``) the step is the rank's
part of the reference's SPMD step, with the placements of
``make_shardings``: the rank holds its shards of the parameters (Megatron
TP over the model axis), its rows of each microbatch (the batch axes) and
its blocks of the moments (ZeRO-1, ``TrainConfig.zero1``: cut over the
batch axes on top of TP), runs the sharded loss (``lm_loss``) under
autograd, and ``optim.update_sharded`` sums the gradients over the batch
axes and returns the rank's shards of the new state.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Any

import torch

from repro_torch import optim
from repro_torch.bridge import tree_flatten, tree_map, tree_unflatten
from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as T


@dataclass(frozen=True)
class TrainConfig:
    microbatches: int = 1
    zero1: bool = True                    # moments cut over the batch axes
    grad_dtype: Any = torch.float32       # bf16 = compressed gradients
    compute_dtype: Any = torch.bfloat16
    adamw: optim.AdamWConfig = field(default_factory=optim.AdamWConfig)


def cast_for_compute(params, dtype):
    """Cast >=2D floating params to the compute dtype (the final norm and
    other 1-D leaves stay as they are)."""
    def cast(a):
        if a.ndim >= 2 and a.is_floating_point():
            return a.to(dtype)
        return a
    return tree_map(cast, params)


def _moment_specs(cfg, ctx, tcfg, params_shape):
    """(the parameters' placements, the moments')."""
    pspecs = T.param_pspecs(params_shape, cfg,
                            model_size=ctx.mesh.shape[ctx.model_axis])
    if not tcfg.zero1:
        return pspecs, pspecs
    return pspecs, optim.zero1_specs(pspecs, params_shape, ctx.dp_axes,
                                     ctx.dp_size())


def make_shardings(cfg: ArchConfig, ctx: T.ParallelCtx, tcfg: TrainConfig,
                   params_shape, has_frontend: bool = False):
    """(in placements, out placements) of the sharded step on
    ``ctx.mesh``, per dim a mesh axis name, a tuple of them or None:
    params (``param_pspecs``), the optimizer state
    ``AdamWState((), moments, moments)`` (ZeRO-1 moments under
    ``tcfg.zero1``), tokens and labels ``(None, dp, None)`` (microbatch
    major), the frontend ``(None, dp, None, None)``, and the metrics."""
    pspecs, mspecs = _moment_specs(cfg, ctx, tcfg, params_shape)
    opt = optim.AdamWState((), mspecs, mspecs)
    batch = (None, ctx.dp, None)
    ins = [pspecs, opt, batch, batch]
    if has_frontend:
        ins.append((None, ctx.dp, None, None))
    metrics = {"lr": (), "grad_norm": (), "loss": ()}
    return tuple(ins), (pspecs, opt, metrics)


def make_train_step(cfg: ArchConfig, ctx: T.ParallelCtx, tcfg: TrainConfig,
                    has_frontend: bool = False):
    """Returns ``step(params, opt_state, tokens, labels[, frontend])`` ->
    (new_params, new_opt_state, metrics with ``loss``, ``lr`` and
    ``grad_norm`` as f32 scalar tensors).  ``tokens`` and ``labels``:
    (n_micro, mb, S); ``frontend``: (n_micro, mb, N, d).  On a mesh each
    is the rank's part under ``make_shardings``, and so are the results;
    the metrics are the global step's on every rank."""
    reduce = None
    update = functools.partial(optim.update, tcfg.adamw)
    if ctx.mesh is not None:
        pspecs, mspecs = _moment_specs(
            cfg, ctx, tcfg, T.init_params(cfg, generator=None, device="meta"))
        placed = dict(mesh=ctx.mesh, param_specs=pspecs, moment_specs=mspecs)
        reduce = functools.partial(optim.reduce_grads, batch_axes=ctx.dp_axes,
                                   **placed)
        update = functools.partial(optim.update_sharded, tcfg.adamw, **placed)

    def step(params, opt_state, tokens, labels, frontend=None):
        n_micro = tokens.shape[0]
        if n_micro != tcfg.microbatches:
            raise ValueError(f"batch has {n_micro} microbatches, the "
                             f"config {tcfg.microbatches}")
        # the differentiated tree: detached leaves of the cast copy
        leaves, structure = tree_flatten(cast_for_compute(params,
                                                          tcfg.compute_dtype))
        leaves = [a.detach().requires_grad_() for a in leaves]
        params_c = tree_unflatten(structure, leaves)
        gacc = None
        loss_sum = torch.zeros((), dtype=torch.float32, device=tokens.device)
        for i in range(n_micro):
            # the modality input takes no gradient (the reference's
            # stop_gradient)
            fe = frontend[i].detach() if has_frontend else None
            loss = T.lm_loss(params_c, tokens[i], labels[i], cfg, ctx,
                             frontend=fe)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            grads = [torch.zeros_like(a) if g is None else g
                     for a, g in zip(leaves, grads)]
            if reduce is not None:
                # summed over the batch axes (the rank's ZeRO-1 block)
                # before the cast, as the reference's step sums them
                grads = reduce(tree_unflatten(structure, grads))
            if gacc is None:
                gacc = [torch.zeros(g.shape, dtype=tcfg.grad_dtype,
                                    device=g.device) for g in grads]
            for a, g in zip(gacc, grads):
                a.add_(g.to(tcfg.grad_dtype))
            loss_sum = loss_sum + loss.detach()
            del loss, grads
        del params_c, leaves
        for a in gacc:
            a.div_(n_micro)
        grads = gacc if reduce is not None else tree_unflatten(structure, gacc)
        new_params, new_opt, metrics = update(params, grads, opt_state)
        metrics["loss"] = loss_sum / n_micro
        return new_params, new_opt, metrics

    return step


def fit(params, cfg: ArchConfig, ctx: T.ParallelCtx, tcfg: TrainConfig,
        dataset, n_steps: int, log_every: int = 10, callback=None):
    """Simple single-host fit loop (examples / integration tests).  Runs on
    the device the parameters live on; ``dataset`` yields numpy
    (tokens, labels) of the global batch.  Returns (params, opt_state,
    history), a history entry every ``log_every`` steps and at the last."""
    step_fn = make_train_step(cfg, ctx, tcfg)
    opt_state = optim.init(params)
    device = tree_flatten(params)[0][0].device
    history = []
    n_micro = tcfg.microbatches
    for i, (tokens, labels) in zip(range(n_steps), dataset):
        tokens = torch.as_tensor(tokens, device=device)
        labels = torch.as_tensor(labels, device=device)
        tokens = tokens.reshape((n_micro, -1) + tuple(tokens.shape[1:]))
        labels = labels.reshape((n_micro, -1) + tuple(labels.shape[1:]))
        params, opt_state, metrics = step_fn(params, opt_state, tokens,
                                             labels)
        if i % log_every == 0 or i == n_steps - 1:
            history.append({k: float(v) for k, v in metrics.items()})
            history[-1]["step"] = i
        if callback is not None:
            callback(i, params, opt_state, metrics)
    return params, opt_state, history
