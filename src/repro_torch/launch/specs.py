"""Cell builders: for an (arch x shape) the step function, its abstract
inputs (tensors on the ``meta`` device -- no allocation) and their
placements.

The decode cell is the sharded serve step (``launch/serve_step.py``), the
prefill cell the sharded ``prefill_logits`` (``models/transformer.py``)
with each rank's attention on the flash kernel's op, the train cell the
sharded ``make_train_step`` (``train/trainer.py``: remat with the
collectives saved, bf16 compute, ZeRO-1).  The meta-device dry run
(``launch/dryrun.py``) runs one rank's cell on its blocks of the args.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import optim
from repro_torch.configs import get_arch, get_shape, shape_applicable
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.kernels.ops import flash_attention_op
from repro_torch.launch import serve_step as SS
from repro_torch.launch.mesh import mesh_axes
from repro_torch.models import transformer as T
from repro_torch.train import trainer


@dataclass
class Cell:
    arch: ArchConfig
    shape: ShapeConfig
    fn: Any                      # the rank's step function
    args: tuple                  # meta-tensor trees (global shapes)
    in_shardings: Any            # placement trees of ``args``
    donate: Tuple[int, ...]      # args the step updates in place
    meta: Dict[str, Any]
    out_shardings: Any = None


def params_struct(cfg: ArchConfig, dtype) -> Any:
    """The params tree's global shapes and dtypes, on the meta device."""
    return T.init_params(cfg, generator=None, dtype=dtype, device="meta")


def _param_shardings(mesh, cfg, pshape):
    return T.param_pspecs(pshape, cfg, model_size=mesh.shape["model"])


def microbatches_for(cfg: ArchConfig, shape: ShapeConfig, mesh) -> int:
    """Gradient-accumulation steps, so that each microbatch's activations
    fit: one row a rank (VLMs at d >= 4096, whose frontend K/V inflates
    them), two (d >= 2048) or four per microbatch."""
    dp_axes, _ = mesh_axes(mesh)
    b_local = max(shape.global_batch // mesh.axis_size(dp_axes), 1)
    if cfg.n_frontend_tokens and cfg.d_model >= 4096:
        micro_local = 1
    elif cfg.d_model >= 2048:
        micro_local = 2
    else:
        micro_local = 4
    return max(b_local // micro_local, 1)


def build_train_cell(cfg: ArchConfig, shape: ShapeConfig, mesh,
                     compute_dtype=torch.bfloat16) -> Cell:
    """The rank's sharded train step over ``microbatches_for`` microbatches:
    remat with the self-attention's and FFN's collectives saved, a loss
    chunk of 256, ZeRO-1, f32 masters and moments.  The reference computes
    in bf16; ``compute_dtype`` lets a check run f32."""
    dp_axes, model_axis = mesh_axes(mesh)
    ctx = T.ParallelCtx(mesh=mesh, dp_axes=dp_axes, model_axis=model_axis,
                        remat=True, compute_dtype=compute_dtype,
                        loss_chunk=256, save_collectives=True)
    tcfg = trainer.TrainConfig(microbatches=microbatches_for(cfg, shape, mesh),
                               zero1=True, compute_dtype=compute_dtype)
    has_fe = cfg.n_frontend_tokens > 0
    fn = trainer.make_train_step(cfg, ctx, tcfg, has_frontend=has_fe)
    pshape = params_struct(cfg, torch.float32)
    nm = tcfg.microbatches
    b, s = shape.global_batch, shape.seq_len
    toks = torch.empty((nm, b // nm, s), dtype=torch.int32, device="meta")
    args = [pshape, optim.init(pshape), toks, toks]
    if has_fe:
        args.append(torch.empty((nm, b // nm, cfg.n_frontend_tokens,
                                 cfg.d_model), dtype=compute_dtype,
                                device="meta"))
    ins, outs = trainer.make_shardings(cfg, ctx, tcfg, pshape,
                                       has_frontend=has_fe)
    return Cell(cfg, shape, fn, tuple(args), ins, donate=(0, 1),
                meta={"kind": "train", "microbatches": nm, "ctx": ctx,
                      "tcfg": tcfg},
                out_shardings=outs)


def build_prefill_cell(cfg: ArchConfig, shape: ShapeConfig, mesh,
                       compute_dtype=torch.bfloat16) -> Cell:
    """The rank's ``fn(params, tokens, frontend=None)`` -> its rows of the
    last position's (B, V) f32 logits.  Sequence-parallel residuals pay off
    for prefill only where attention shards by heads: heads that divide
    the model axis, or MHA (zero-padded to it); GQA archs with heads that
    do not (hymba's 25 over 5 KV heads) keep them whole.  The reference
    computes in bf16; ``compute_dtype`` lets a check run f32."""
    dp_axes, model_axis = mesh_axes(mesh)
    mp = mesh.shape["model"]
    sp = (cfg.n_heads % mp == 0 or cfg.n_heads == cfg.n_kv_heads) \
        if cfg.n_heads else True
    ctx = T.ParallelCtx(mesh=mesh, dp_axes=dp_axes, model_axis=model_axis,
                        remat=False, compute_dtype=compute_dtype,
                        seq_parallel=sp)
    has_fe = cfg.n_frontend_tokens > 0

    def fn(params, tokens, frontend=None):
        return T.prefill_logits(params, tokens, cfg, ctx, frontend=frontend,
                                attention=flash_attention_op)

    pshape = params_struct(cfg, compute_dtype)
    b, s = shape.global_batch, shape.seq_len
    args = [pshape, torch.empty((b, s), dtype=torch.int32, device="meta")]
    ins = [_param_shardings(mesh, cfg, pshape), (ctx.dp, None)]
    if has_fe:
        args.append(torch.empty((b, cfg.n_frontend_tokens, cfg.d_model),
                                dtype=compute_dtype, device="meta"))
        ins.append((ctx.dp, None, None))
    return Cell(cfg, shape, fn, tuple(args), tuple(ins), donate=(),
                meta={"kind": "prefill", "ctx": ctx})


def build_decode_cell(cfg: ArchConfig, shape: ShapeConfig, mesh,
                      kv_dtype: str = "bf16") -> Cell:
    plan = SS.plan_for(shape, mesh, kv_dtype=kv_dtype)
    fn, plan, ctx = SS.make_serve_step(cfg, shape, mesh, plan=plan)
    caches, cache_specs, step, step_specs, geo = SS.decode_struct(
        cfg, shape, mesh, plan)
    pshape = params_struct(cfg, torch.bfloat16)
    args = (pshape, caches, step)
    ins = (_param_shardings(mesh, cfg, pshape), cache_specs, step_specs)
    outs = (step_specs["tokens"], cache_specs)
    return Cell(cfg, shape, fn, args, ins, donate=(1,),
                meta={"kind": "decode", "plan": plan, "geo": geo},
                out_shardings=outs)


def build_cell(arch_name: str, shape_name: str, mesh,
               kv_dtype: str = "bf16") -> Optional[Cell]:
    """The cell, or None where the shape does not apply to the arch."""
    cfg = get_arch(arch_name)
    shape = get_shape(shape_name)
    ok, _ = shape_applicable(cfg, shape)
    if not ok:
        return None
    if shape.kind == "train":
        return build_train_cell(cfg, shape, mesh)
    if shape.kind == "prefill":
        return build_prefill_cell(cfg, shape, mesh)
    return build_decode_cell(cfg, shape, mesh, kv_dtype=kv_dtype)
