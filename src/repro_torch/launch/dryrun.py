"""Meta-device dry run: one rank's cell of every (arch x shape) on the
production mesh, run on meta tensors, with what it computes, moves and
holds recorded.

  PYTHONPATH=src python -m repro_torch.launch.dryrun                # all cells
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-3-8b \\
      --shape decode_32k --mesh single

The reference lowers and compiles each cell for 512 devices and reads the
compiled program's memory, cost and collectives.  PyTorch has no such
program: here rank 0 of the 16x16 mesh (2x16x16 for ``multi``) runs its
step function (``launch/specs.py``) on a dry mesh (``launch/mesh.py``),
whose transports move nothing, over its blocks of the cell's arguments,
all on the ``meta`` device: nothing is allocated.  FLOPs come from
``FlopCounterMode``, collective bytes from the dry mesh, and the roofline
from ``roofline.py`` (the H100's constants).  What a meta run cannot see
is in every record's ``limits``.  A full train cell runs its whole step
(every microbatch, the backward and the AdamW update) and takes minutes
on meta; the decode and prefill cells take seconds.

Artifacts: build/dryrun/<mesh>/<arch>__<shape>[__int8].json (incremental:
an existing artifact is kept unless --force).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback
from collections import Counter

import torch

from repro_torch.bridge import tree_flatten
from repro_torch.configs import ARCHS, SHAPES, get_arch, get_shape, shape_applicable
from repro_torch.launch.mesh import Mesh, local_block, make_production_mesh

HBM_BYTES = 80e9             # an H100's device memory

LIMITS = ("meta-device run of one rank: no compiled temporaries or code "
          "(temp_bytes and code_bytes null), so peak_per_device is a lower "
          "bound (arguments + outputs - aliased); no fusion; FLOPs are "
          "FlopCounterMode's (matrix products and convolutions) on the "
          "kernels' plain versions, so attention counts the full square with "
          "no masked block skipped; collective bytes are the outputs of the "
          "port's transports as they run (a reduce-scatter is an all-reduce "
          "and a slice); a decode step assumes every row appends (nonzero on "
          "meta)")


def _artifact_dir():
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    d = os.path.join(here, "build", "dryrun")
    os.makedirs(d, exist_ok=True)
    return d


def cut_args(tree, spec, mesh):
    """The rank's blocks of a tree of meta tensors under its placement tree,
    as fresh meta tensors; a NamedTuple (the AdamW state) is cut field by
    field."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        block = local_block(tree, spec, mesh)
        return torch.empty(block.shape, dtype=tree.dtype, device="meta")
    if isinstance(tree, dict):
        return {k: cut_args(v, spec[k], mesh) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(cut_args(v, s, mesh) for v, s in zip(tree, spec)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(cut_args(v, s, mesh) for v, s in zip(tree, spec))
    raise TypeError(f"no placement rule for a {type(tree).__name__}")


def _tensors(tree):
    return [a for a in tree_flatten(tree)[0] if isinstance(a, torch.Tensor)]


def tree_bytes(tree) -> int:
    return sum(a.numel() * a.element_size() for a in _tensors(tree))


def alias_bytes(args, out, donate) -> int:
    """Bytes of the donated args that come back as outputs: each donated
    leaf matched with an output leaf of its shape and dtype."""
    free = Counter((tuple(a.shape), a.dtype) for a in _tensors(out))
    total = 0
    for i in donate:
        for a in _tensors(args[i]):
            key = (tuple(a.shape), a.dtype)
            if free[key]:
                free[key] -= 1
                total += a.numel() * a.element_size()
    return total


@contextlib.contextmanager
def _every_row_appends():
    """``torch.nonzero`` on meta tensors as if every element were nonzero
    (the serve step's live rows: the upper bound), for this scope only."""
    from torch.fx.experimental import _config
    with _config.patch(meta_nonzero_assume_all_nonzero=True):
        yield


def analyze_cell(cell, mesh: Mesh, kv_bytes: float = 2.0) -> dict:
    """Run ``cell`` (built on the dry ``mesh``) on the rank's meta blocks of
    its args: the record's n_chips, trace_s, memory, collectives,
    cost_analysis_raw, roofline, meta, fits_hbm_80g and limits."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch import roofline as RL
    if not mesh.dry:
        raise ValueError("the dry run needs a dry mesh (Mesh(..., dry=True))")
    args = cut_args(cell.args, cell.in_shardings, mesh)
    mesh.stats.clear()
    t0 = time.time()
    with _every_row_appends(), FlopCounterMode(display=False) as counter:
        out = cell.fn(*args)
    trace_s = time.time() - t0
    flops = counter.get_total_flops()
    by_op = {str(op): n for op, n in
             counter.get_flop_counts().get("Global", {}).items()}
    coll = RL.meta_counts(flops, mesh)
    n_micro = cell.meta.get("microbatches", 1)
    terms = RL.RooflineTerms(
        flops=float(flops),
        bytes_hbm=RL.analytic_bytes_for(cell.arch, cell.shape, dict(mesh.shape),
                                        n_micro=n_micro, kv_bytes=kv_bytes),
        bytes_coll=float(coll["total_collective"]),
        model_flops=RL.model_flops_for(cell.arch, cell.shape, mesh.size))
    arg_b, out_b = tree_bytes(args), tree_bytes(out)
    alias_b = alias_bytes(args, out, cell.donate)
    peak = arg_b + out_b - alias_b
    return {
        "n_chips": mesh.size,
        "trace_s": round(trace_s, 1),
        "memory": {
            "argument_bytes": arg_b,
            "output_bytes": out_b,
            "temp_bytes": None,
            "alias_bytes": alias_b,
            "code_bytes": None,
            "peak_per_device": peak,
            "peak_is": "lower bound: arguments + outputs - aliased, no temporaries",
        },
        "collectives": coll,
        "cost_analysis_raw": {"flops": float(flops), "bytes_accessed": None,
                              "hlo_bytes_unfused_upper_bound": None,
                              "flops_by_op": by_op},
        "roofline": terms.to_dict(),
        "meta": {k: str(v) for k, v in cell.meta.items()},
        "fits_hbm_80g": bool(peak < HBM_BYTES),
        "limits": LIMITS,
    }


def run_cell(arch_name, shape_name, mesh_name, mesh, out_dir, force=False,
             kv_dtype="bf16"):
    """The record of one cell on rank 0 of ``mesh`` (made dry if it is not),
    written to ``out_dir/<mesh_name>/``; a skip record where the shape does
    not apply, an error record where the run raised."""
    from repro_torch.launch.specs import build_cell

    os.makedirs(os.path.join(out_dir, mesh_name), exist_ok=True)
    suffix = "" if kv_dtype == "bf16" else f"__{kv_dtype}"
    path = os.path.join(out_dir, mesh_name,
                        f"{arch_name}__{shape_name}{suffix}.json")
    if os.path.exists(path) and not force:
        print(f"[skip] {mesh_name}/{arch_name}/{shape_name} (cached)")
        with open(path) as f:
            return json.load(f)

    cfg = get_arch(arch_name)
    shape = get_shape(shape_name)
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        rec = {"arch": arch_name, "shape": shape_name, "mesh": mesh_name,
               "status": "skipped", "reason": why}
        _dump(rec, path)
        print(f"[SKIP] {mesh_name}/{arch_name}/{shape_name}: {why}")
        return rec

    if not mesh.dry:
        mesh = Mesh(tuple(mesh.shape.values()), mesh.axis_names, rank=0,
                    dry=True)
    rec = {"arch": arch_name, "shape": shape_name, "mesh": mesh_name,
           "kv_dtype": kv_dtype}
    try:
        cell = build_cell(arch_name, shape_name, mesh, kv_dtype=kv_dtype)
        rec.update(analyze_cell(cell, mesh,
                                kv_bytes=1.0 if kv_dtype == "int8" else 2.0))
        rec["status"] = "ok"
        terms = rec["roofline"]
        print(f"[ok]   {mesh_name}/{arch_name}/{shape_name}: "
              f"trace={rec['trace_s']:.0f}s "
              f"mem/dev>={rec['memory']['peak_per_device'] / 2**30:.2f}GiB "
              f"bottleneck={terms['bottleneck']} "
              f"frac={terms['roofline_fraction']:.3f}")
    except Exception as e:                                   # noqa: BLE001
        rec.update({"status": "error", "error": repr(e),
                    "trace": traceback.format_exc()[-4000:]})
        print(f"[ERR]  {mesh_name}/{arch_name}/{shape_name}: {e!r}")
    _dump(rec, path)
    return rec


def _dump(rec, path):
    with open(path, "w") as f:
        json.dump(rec, f, indent=2)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi",
                                                       "both"])
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--kv-dtype", default="bf16", choices=["bf16", "int8"])
    args = ap.parse_args(argv)

    out_dir = args.out or _artifact_dir()
    archs = list(ARCHS) if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    results = []
    for multi in meshes:
        mesh = make_production_mesh(multi_pod=multi)
        name = "multi" if multi else "single"
        for a in archs:
            for s in shapes:
                results.append(run_cell(a, s, name, mesh, out_dir,
                                        force=args.force,
                                        kv_dtype=args.kv_dtype))
    n_ok = sum(1 for r in results if r.get("status") == "ok")
    n_skip = sum(1 for r in results if r.get("status") == "skipped")
    n_err = sum(1 for r in results if r.get("status") == "error")
    print(f"\ndone: {n_ok} ok, {n_skip} skipped, {n_err} errors "
          f"of {len(results)} cells")
    return 0 if n_err == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
