"""Pipeline parallelism over the pod axis (GPipe, 2 stages).

Between pods the link is slower than within one, so pipelining is the
natural cross-pod strategy: per microbatch only one (mb, S, d) activation
(and its gradient) crosses the pod boundary, instead of a full-parameter
gradient all-reduce.  The reference's SPMD formulation, on ranks:

* each layer stack (n_layers, ...) is cut in two over ``pod``: a rank
  holds its stage's n_layers / 2 layers (cut over ``model`` as
  ``param_pspecs`` cuts them); the embedding, final norm and unembedding
  are replicated over ``pod``;
* the GPipe schedule is M + 1 ticks: at tick t stage 0 runs microbatch t
  while stage 1 runs microbatch t - 1, received by one differentiable
  ``ring_shift`` along ``pod``.  Both stages run every tick and keep their
  own result with ``torch.where`` on the pod index, so both ranks build
  the same graph;
* autograd through the ticks and the hops gives the backward pipeline (the
  hop's backward is the reverse hop), as ``jax.grad`` through the
  reference's scan and ``ppermute`` does.

Inside a stage the data and model axes work as in the rest of the launch
layer (Megatron TP, the rows of the batch, the vocab-sharded NLL).  The
reference's fixed choices are kept: bf16 compute, remat, the
``AdamWConfig()`` defaults, an NLL tail that does not mask labels
(``masked=False``), and the aux loss weighted ``1 / (2 n_micro)``.

Uniform dense archs only (the two stages need the same layer structure).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import optim
from repro_torch.bridge import tree_flatten, tree_map_specs, tree_unflatten
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models import transformer as T
from repro_torch.models.layers import rms_norm
from repro_torch.train import trainer


def pp_specs(cfg: ArchConfig, mesh, params_shape):
    """The parameters' placements: ``param_pspecs`` with each layer
    stack's leading dim over ``pod``."""
    pspecs = T.param_pspecs(params_shape, cfg, model_size=mesh.shape["model"])
    stage = tree_map_specs(lambda sp: ("pod",) + tuple(sp)[1:],
                           pspecs["segments"][0])
    return dict(pspecs, segments=[stage])


def make_pp_train_step(cfg: ArchConfig, shape: ShapeConfig, mesh,
                       n_micro: int = 8):
    """The 2-stage GPipe train step on a (pod, data, model) mesh.

    Returns (train_step, args, in placements): ``train_step(params,
    opt_state, tokens, labels)`` on a rank's shards (params and moments
    under the placements, tokens and labels (n_micro, mb, S) cut on mb over
    ``data``) -> (new params, new opt state, metrics), the metrics the
    same on every rank; ``args`` the global shapes on the meta device."""
    if "pod" not in mesh.axis_names:
        raise ValueError("the pipeline needs a mesh with a pod axis")
    if cfg.family != "dense" or cfg.global_every or cfg.window:
        raise ValueError("the pipeline takes uniform dense archs")
    segs = T.segments(cfg)
    if len(segs) != 1 or segs[0].count % 2:
        raise ValueError("the pipeline needs one stack of an even depth")
    stage_seg = dataclasses.replace(segs[0], count=segs[0].count // 2)
    ctx = T.ParallelCtx(mesh=mesh, dp_axes=("data",), model_axis="model",
                        remat=True, compute_dtype=torch.bfloat16,
                        loss_chunk=256)
    b, s = shape.global_batch, shape.seq_len
    mb = b // n_micro
    pshape = T.init_params(cfg, generator=None, device="meta")
    specs = pp_specs(cfg, mesh, pshape)
    adamw = optim.AdamWConfig()

    def loss_tail(shared, h, labels_mb):
        """The microbatch's NLL over its global mb * S positions (the
        rank's rows' part of it)."""
        h = rms_norm(shared["final_ln"], h, cfg.norm_eps)
        total, _ = T.nll_sum(shared, h, labels_mb, cfg, ctx, masked=False)
        return total / (mb * s)

    def pp_loss(params, tokens, labels):
        my = torch.tensor(mesh.index("pod"), device=tokens.device)
        stage = params["segments"][0]
        shared = {k: v for k, v in params.items() if k != "segments"}
        zero = torch.zeros((), dtype=torch.float32, device=tokens.device)
        x_recv = torch.zeros((tokens.shape[1], s, cfg.d_model),
                             dtype=ctx.compute_dtype, device=tokens.device)
        loss_acc, aux_acc = zero, zero
        for t in range(n_micro + 1):
            # stage 0 takes microbatch t (the last again on the drain tick)
            x0 = T.embed(shared, tokens[min(t, n_micro - 1)], cfg, ctx)
            x = torch.where(my == 0, x0, x_recv)
            h, aux = T.run_segments([stage], [stage_seg], x, cfg, ctx)
            # stage 1 finishes microbatch t - 1
            l = loss_tail(shared, h, labels[min(max(t - 1, 0), n_micro - 1)])
            live1 = (my == 1) & (t >= 1)
            live0 = (my == 0) & (t <= n_micro - 1)
            loss_acc = loss_acc + torch.where(live1, l, 0.0)
            aux_acc = aux_acc + torch.where(live0 | live1, aux, 0.0)
            # the hop: stage 0's output of tick t is stage 1's input at t + 1
            x_recv = mesh.ring_shift(h, "pod")
        # stage 1 owns the loss: sum over the pods (and the rows of data)
        loss = mesh.all_reduce(loss_acc, ("pod", "data"), "sum") / n_micro
        aux = mesh.all_reduce(aux_acc, "pod", "sum")
        return loss + aux / (2 * n_micro)

    def train_step(params, opt_state, tokens, labels):
        leaves, structure = tree_flatten(
            trainer.cast_for_compute(params, torch.bfloat16))
        leaves = [a.detach().requires_grad_() for a in leaves]
        loss = pp_loss(tree_unflatten(structure, leaves), tokens, labels)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(a) if g is None else g
                 for a, g in zip(leaves, grads)]
        placed = dict(mesh=mesh, param_specs=specs, moment_specs=specs)
        grads = optim.reduce_grads(tree_unflatten(structure, grads),
                                   batch_axes=("pod", "data"), **placed)
        new_p, new_o, metrics = optim.update_sharded(adamw, params, grads,
                                                     opt_state, **placed)
        metrics["loss"] = loss.detach()
        return new_p, new_o, metrics

    batch = (None, "data", None)
    ins = (specs, optim.AdamWState((), specs, specs), batch, batch)
    toks = torch.empty((n_micro, mb, s), dtype=torch.int32, device="meta")
    args = (pshape, optim.init(pshape), toks, toks)
    return train_step, args, ins
