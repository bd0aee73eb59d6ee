"""Weight bridge: the reference's parameter tree (numpy arrays) <-> torch.

A parameter tree is nested dicts, lists and tuples whose leaves are arrays;
per-segment layer stacks keep their leading layer axis.  ``to_torch`` keeps
the nesting and puts every leaf on ``device`` (optionally cast to
``dtype``); ``to_numpy`` is its inverse.  Leaves are read through
``np.asarray``, so anything that converts to a numpy array is accepted.
bfloat16 arrays (numpy's ``bfloat16`` extension dtype) cross bit for bit.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np
import torch


def tree_map(fn: Callable, tree: Any) -> Any:
    """Apply ``fn`` to every leaf of a dict/list/tuple/NamedTuple tree."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):   # NamedTuple
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


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
    """numpy parameter tree -> torch tensors with the same nesting."""
    return tree_map(lambda x: _leaf_to_torch(x, device, dtype), tree)


def to_numpy(tree: Any) -> Any:
    """torch parameter tree -> numpy arrays (bfloat16 leaves as float32,
    which holds every bfloat16 value exactly)."""
    def leaf(t: torch.Tensor):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    return tree_map(leaf, tree)
