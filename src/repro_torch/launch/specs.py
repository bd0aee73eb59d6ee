"""Cell builders: for an (arch x shape) the step function, its abstract
inputs (tensors on the ``meta`` device -- no allocation) and their
placements.

The decode cell is the sharded serve step (``launch/serve_step.py``).  The
prefill and train cells wait for ROADMAP items 13b and 13c, and the
meta-device dry run that sweeps the cells for 13d.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs import get_arch, get_shape, shape_applicable
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.launch import serve_step as SS
from repro_torch.models import transformer as T


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
    if shape.kind != "decode":
        item = "13c" if shape.kind == "train" else "13b"
        raise NotImplementedError(f"the {shape.kind} cell is ROADMAP item {item}")
    return build_decode_cell(cfg, shape, mesh, kv_dtype=kv_dtype)
