"""Weight bridge: the reference's parameter tree (numpy arrays) <-> torch.

A parameter tree is nested dicts, lists and tuples whose leaves are arrays;
per-segment layer stacks keep their leading layer axis.  ``to_torch`` keeps
the nesting and puts every leaf on ``device`` (optionally cast to
``dtype``, except the leaves the reference holds in float32 whatever the
weights' dtype: ``F32_LEAVES``); ``to_numpy`` is its inverse.  Leaves are
read through ``np.asarray``, so anything that converts to a numpy array is
accepted.
bfloat16 arrays (numpy's ``bfloat16`` extension dtype) cross bit for bit.
``shard_to_torch`` cuts a global tree into one rank's local shards by the
placements of ``models.transformer.param_pspecs`` (``opt_state_shard_to_torch``
an optimizer state's, by its moments' placements), and ``unshard_to_numpy``
puts every rank's shards back together.
An optimizer state crosses with ``opt_state_to_torch`` and
``opt_state_to_numpy``.  ``tree_flatten`` and ``tree_unflatten`` order the
leaves as ``jax.tree.flatten`` does.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np
import torch


# leaves the reference keeps in float32 in a tree of any dtype: the SSD
# decay, skip and dt bias (``models/ssm.py``), the cross-attention gate and
# the MoE router (``models/moe.py``)
F32_LEAVES = frozenset({"A_log", "D", "dt_bias", "xgate", "router"})


def tree_map(fn: Callable, tree: Any) -> Any:
    """Apply ``fn`` to every leaf of a dict/list/tuple/NamedTuple tree."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):   # NamedTuple
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


class _Leaf:
    """The place of a leaf in a ``tree_flatten`` structure."""


_LEAF = _Leaf()


def tree_flatten(tree: Any, is_leaf: Optional[Callable] = None):
    """(leaves, structure) in ``jax.tree.flatten``'s order: dict keys sorted,
    lists and tuples in order, NamedTuples by field; ``None`` holds no
    leaf, and a node for which ``is_leaf`` is true is a leaf
    (``is_spec``: a placement tree's tuples).
    ``tree_unflatten(structure, leaves)`` inverts it."""
    leaves = []
    return leaves, _flatten_into(tree, leaves, is_leaf)


def is_spec(x) -> bool:
    """A placement (a plain tuple) is a leaf of a placement tree."""
    return isinstance(x, tuple) and not hasattr(x, "_fields")


# module-level recursion, not a nested closure: a closure that calls itself
# is a reference cycle, which would keep the leaves (a step's parameters,
# moments and gradients) alive until the garbage collector runs
def _flatten_into(t, leaves, is_leaf=None):
    if is_leaf is not None and is_leaf(t):
        leaves.append(t)
        return _LEAF
    if isinstance(t, dict):
        return {k: _flatten_into(t[k], leaves, is_leaf) for k in sorted(t)}
    if isinstance(t, tuple) and hasattr(t, "_fields"):        # NamedTuple
        return type(t)(*(_flatten_into(v, leaves, is_leaf) for v in t))
    if isinstance(t, (list, tuple)):
        return type(t)(_flatten_into(v, leaves, is_leaf) for v in t)
    if t is None:
        return None
    leaves.append(t)
    return _LEAF


def tree_map_specs(fn: Callable, specs: Any, *trees: Any) -> Any:
    """``fn(spec, *leaves)`` over a placement tree and trees of its shape
    (dicts and lists; a placement's tuple is a leaf)."""
    if isinstance(specs, dict):
        return {k: tree_map_specs(fn, v, *(t[k] for t in trees))
                for k, v in specs.items()}
    if isinstance(specs, list):
        return [tree_map_specs(fn, v, *(t[i] for t in trees))
                for i, v in enumerate(specs)]
    return fn(specs, *trees)


def tree_unflatten(structure: Any, leaves) -> Any:
    """The tree of ``structure`` (from ``tree_flatten``) holding ``leaves``."""
    it = iter(leaves)
    out = _unflatten_from(structure, it)
    if next(it, _LEAF) is not _LEAF:
        raise ValueError("more leaves than the structure holds")
    return out


def _unflatten_from(t, it):
    if isinstance(t, dict):
        return {k: _unflatten_from(t[k], it) for k in sorted(t)}
    if isinstance(t, tuple) and hasattr(t, "_fields"):
        return type(t)(*(_unflatten_from(v, it) for v in t))
    if isinstance(t, (list, tuple)):
        return type(t)(_unflatten_from(v, it) for v in t)
    return next(it) if t is _LEAF else t


def _leaf_to_torch(x, device, dtype) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device=device, dtype=dtype or t.dtype)


def to_torch(tree: Any, device="cuda",
             dtype: Optional[torch.dtype] = None) -> Any:
    """numpy parameter tree -> torch tensors with the same nesting.  With
    ``dtype``, every leaf is cast to it except the ``F32_LEAVES``."""
    def walk(t, key=None):
        if isinstance(t, dict):
            return {k: walk(v, k) for k, v in t.items()}
        if isinstance(t, tuple) and hasattr(t, "_fields"):      # NamedTuple
            return type(t)(*(walk(v) for v in t))
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v) for v in t)
        keep = dtype is None or key in F32_LEAVES
        return _leaf_to_torch(t, device, None if keep else dtype)
    return walk(tree)


def shard_to_torch(tree: Any, specs: Any, mesh, device="cuda",
                   dtype: Optional[torch.dtype] = None) -> Any:
    """A global parameter tree (numpy or torch leaves) -> this rank's local
    shards of it.

    ``specs`` is the placement tree (``param_pspecs``) and ``mesh`` the rank
    mesh (``launch/mesh.py``): each leaf is cut to the rank's block, then put
    on ``device`` as ``to_torch`` does (a torch leaf's block is copied, so
    the global tree can be freed).  A sharded dim is cut in contiguous
    blocks, so the fused SwiGLU ``wgu``, whose gate and up columns are
    interleaved, keeps matching pairs in every block."""
    from repro_torch.launch.mesh import local_block

    def walk(t, sp, key=None):
        if isinstance(t, dict):
            return {k: walk(v, sp[k], k) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v, s) for v, s in zip(t, sp))
        cast = None if dtype is None or key in F32_LEAVES else dtype
        if isinstance(t, torch.Tensor):
            block = local_block(t, sp, mesh)
            return block.to(device=device, dtype=cast or block.dtype, copy=True)
        return _leaf_to_torch(local_block(np.asarray(t), sp, mesh), device, cast)
    return walk(tree, specs)


def opt_state_shard_to_torch(state: Any, moment_specs: Any, mesh,
                             device="cuda"):
    """An AdamW state (the reference's, a numpy one or the port's, global)
    -> this rank's ``AdamWState``: the moments cut by ``moment_specs``
    (``optim.zero1_specs`` under ZeRO-1, else ``param_pspecs``), the step
    an int32 scalar tensor."""
    from repro_torch.optim import AdamWState   # optim imports this module
    step = torch.tensor(int(np.asarray(state.step)), dtype=torch.int32,
                        device=device)
    return AdamWState(step, shard_to_torch(state.mu, moment_specs, mesh, device),
                      shard_to_torch(state.nu, moment_specs, mesh, device))


def unshard_to_numpy(rank_trees, specs: Any, mesh) -> Any:
    """Every rank's shards of a tree (``rank_trees[r]``: rank r's, numpy or
    torch leaves) -> the global tree of numpy arrays, each block placed as
    ``specs`` cuts it on ``mesh`` (a layout: only its shape is read).
    Replicated blocks must agree bit for bit."""
    from repro_torch.launch.mesh import Mesh

    def coords_mesh(r):
        m = Mesh([mesh.shape[a] for a in mesh.axis_names], mesh.axis_names)
        m.coords = dict(zip(mesh.axis_names, map(int, np.unravel_index(
            r, [mesh.shape[a] for a in mesh.axis_names]))))
        return m

    meshes = [coords_mesh(r) for r in range(len(rank_trees))]

    def leaf(spec, *blocks):
        blocks = [np.asarray(to_numpy(b)) if isinstance(b, torch.Tensor)
                  else np.asarray(b) for b in blocks]
        shape = [n * (mesh.axis_size(axes) if axes is not None else 1)
                 for n, axes in zip(blocks[0].shape, spec)]
        out = np.zeros(shape, dtype=blocks[0].dtype)
        seen = {}
        for m, block in zip(meshes, blocks):
            index = tuple(
                slice(None) if axes is None else
                slice(m.index(axes) * n, (m.index(axes) + 1) * n)
                for n, axes in zip(block.shape, spec))
            key = tuple((i.start, i.stop) for i in index)
            if key in seen and not np.array_equal(seen[key], block,
                                                  equal_nan=True):
                raise ValueError(f"replicas of block {key} differ")
            seen[key] = block
            out[index] = block
        return out

    return tree_map_specs(leaf, specs, *rank_trees)


def to_numpy(tree: Any) -> Any:
    """torch parameter tree -> numpy arrays (bfloat16 leaves as float32,
    which holds every bfloat16 value exactly)."""
    def leaf(t: torch.Tensor):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    return tree_map(leaf, tree)


def opt_state_to_torch(state: Any, device="cuda"):
    """An AdamW state (``step``, ``mu``, ``nu``; the reference's or a numpy
    one) -> the port's ``AdamWState``: moments through ``to_torch``, step as
    an int32 scalar tensor."""
    from repro_torch.optim import AdamWState   # optim imports this module
    step = torch.tensor(int(np.asarray(state.step)), dtype=torch.int32,
                        device=device)
    return AdamWState(step, to_torch(state.mu, device),
                      to_torch(state.nu, device))


def opt_state_to_numpy(state: Any):
    """The port's ``AdamWState`` -> (step as an int32 numpy scalar, moments
    through ``to_numpy``), as an ``AdamWState`` of numpy leaves."""
    return type(state)(np.asarray(int(state.step), dtype=np.int32),
                       to_numpy(state.mu), to_numpy(state.nu))
