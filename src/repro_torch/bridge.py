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
placements of ``models.transformer.param_pspecs``.
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


def tree_flatten(tree: Any):
    """(leaves, structure) in ``jax.tree.flatten``'s order: dict keys sorted,
    lists and tuples in order, NamedTuples by field; ``None`` holds no
    leaf.  ``tree_unflatten(structure, leaves)`` inverts it."""
    leaves = []
    return leaves, _flatten_into(tree, leaves)


# module-level recursion, not a nested closure: a closure that calls itself
# is a reference cycle, which would keep the leaves (a step's parameters,
# moments and gradients) alive until the garbage collector runs
def _flatten_into(t, leaves):
    if isinstance(t, dict):
        return {k: _flatten_into(t[k], leaves) for k in sorted(t)}
    if isinstance(t, tuple) and hasattr(t, "_fields"):        # NamedTuple
        return type(t)(*(_flatten_into(v, leaves) for v in t))
    if isinstance(t, (list, tuple)):
        return type(t)(_flatten_into(v, leaves) for v in t)
    if t is None:
        return None
    leaves.append(t)
    return _LEAF


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
