"""Rank meshes and their collectives.

The reference's launch layer is SPMD over global arrays on a device mesh,
with the collectives that GSPMD and ``shard_map`` insert.  The port's is
SPMD over ranks: one process per mesh cell, each holding its local shards,
and every collective written out with ``torch.distributed`` over one process
group per set of mesh axes.  Rank ``r`` sits at the row-major coordinates of
``r`` in the mesh shape, as a ``jax.sharding.Mesh`` over a reshaped device
list places device ``r``.

The caller initialises the default process group and picks its backend:
NCCL where every rank owns its own card, gloo for the CPU, and gloo for
ranks that share one card (NCCL refuses two ranks on one device).  The
collectives keep tensors where they are, except those that gloo does not
take on CUDA tensors (``HOST_STAGED``): with gloo, a CUDA tensor of those
is copied to a pinned host buffer, moved there, and copied back.  That is
the transport of the caller's backend, not a fallback: the pools, the
kernels and the math stay on the card.

Mesh builders are functions, so importing this module touches no process
group.
"""
from __future__ import annotations

import itertools
from typing import Dict, Iterable, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

Axes = Union[str, Sequence[str]]

# the collectives that gloo does not take on CUDA tensors, which with gloo
# stage a CUDA tensor through pinned host memory.  On the H100 (torch 2.11)
# gloo's all-reduce, broadcast and all-gather take CUDA tensors, and its
# send/recv abort the process (a writev of the device pointer): PERF.md,
# phase 12
HOST_STAGED = frozenset({"send_recv"})


class Mesh:
    """A mesh of ranks: ``shape[axis]`` and ``axis_names`` as a jax mesh's,
    this rank's ``coords``, and a process group per set of axes.

    A mesh over no process group (``rank`` None) is a layout: it answers
    questions of shape (``launch/specs.py``), and its collectives raise."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str], *,
                 rank: Optional[int] = None):
        if len(shape) != len(axis_names):
            raise ValueError(f"shape {tuple(shape)} and axes {tuple(axis_names)}")
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, map(int, shape)))
        self.size = int(np.prod(shape))
        self.rank = rank
        self.coords: Dict[str, int] = {}
        self._groups: Dict[Tuple[str, ...], object] = {}
        self._ranks: Dict[Tuple[str, ...], Tuple[int, ...]] = {}
        if rank is None:
            return
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} outside a mesh of {self.size}")
        self.coords = dict(zip(self.axis_names,
                               map(int, np.unravel_index(rank, tuple(shape)))))
        if self.size == 1:
            return
        grid = np.arange(self.size).reshape(tuple(shape))
        # new_group is collective over the world: every rank makes every
        # group, in the same order
        for k in range(1, len(self.axis_names) + 1):
            for axes in itertools.combinations(self.axis_names, k):
                keep = [self.axis_names.index(a) for a in axes]
                rest = [i for i in range(grid.ndim) if i not in keep]
                cells = np.moveaxis(grid, keep + rest, range(grid.ndim))
                cells = cells.reshape(int(np.prod([grid.shape[i] for i in keep])), -1)
                for col in range(cells.shape[1]):
                    ranks = tuple(int(r) for r in cells[:, col])
                    group = dist.new_group(list(ranks))
                    if rank in ranks:
                        self._groups[axes] = group
                        self._ranks[axes] = ranks

    @property
    def backend(self) -> Optional[str]:
        return dist.get_backend() if self.size > 1 else None

    def _axes(self, axes: Axes) -> Tuple[str, ...]:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        unknown = [a for a in axes if a not in self.shape]
        if unknown:
            raise ValueError(f"axes {unknown} not in {self.axis_names}")
        return tuple(a for a in self.axis_names if a in axes)

    def axis_size(self, axes: Axes) -> int:
        return int(np.prod([self.shape[a] for a in self._axes(axes)]))

    def index(self, axes: Axes) -> int:
        """This rank's row-major index over ``axes`` (the reference's
        ``my = my * mesh.shape[a] + axis_index(a)``)."""
        i = 0
        for a in self._axes(axes):
            i = i * self.shape[a] + self.coords[a]
        return i

    def _group(self, axes):
        if self.rank is None:
            raise RuntimeError("a layout mesh has no process groups")
        return self._groups[axes]

    def _staged(self, op: str, x: torch.Tensor) -> bool:
        return x.is_cuda and op in HOST_STAGED and self.backend == "gloo"

    # ---- collectives (identity over axes of size 1) ----------------------

    def all_reduce(self, x: torch.Tensor, axes: Axes, op: str = "sum"):
        """``x`` reduced over ``axes`` (``sum`` or ``max``), in place."""
        axes = self._axes(axes)
        if self.axis_size(axes) == 1:
            return x
        red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        dist.all_reduce(x, op=red, group=self._group(axes))
        return x

    def all_gather(self, x: torch.Tensor, axes: Axes, dim: int = -1):
        """The ranks' ``x`` along ``axes`` concatenated on ``dim`` in index
        order."""
        axes = self._axes(axes)
        n = self.axis_size(axes)
        if n == 1:
            return x
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=self._group(axes))
        return torch.cat(parts, dim=dim)

    def ring_shift(self, x: torch.Tensor, axis: str):
        """One hop along ``axis``'s ring: rank i sends ``x`` to i + 1 and
        returns what i - 1 sent (the reference's ``ppermute`` with
        ``perm = [(i, (i + 1) % n)]``)."""
        axes = self._axes(axis)
        n = self.axis_size(axes)
        if n == 1:
            return x
        if self._staged("send_recv", x):
            return self.ring_shift(_pinned(x), axis).to(x.device)
        ranks = self._ranks[axes]
        i = ranks.index(self.rank)
        x = x.contiguous()
        out = torch.empty_like(x)
        ops = [dist.P2POp(dist.isend, x, ranks[(i + 1) % n], self._group(axes)),
               dist.P2POp(dist.irecv, out, ranks[(i - 1) % n], self._group(axes))]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return out


def _pinned(x: torch.Tensor) -> torch.Tensor:
    """A pinned host copy of a CUDA tensor (complete when this returns)."""
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host.copy_(x)
    return host


def _bind(shape: Sequence[int], axes: Sequence[str]) -> Mesh:
    """A mesh over the initialised world (one rank per cell), or a layout
    when there is no process group and the mesh has more than one cell."""
    size = int(np.prod(shape))
    if dist.is_available() and dist.is_initialized():
        world = dist.get_world_size()
        if world != size:
            raise ValueError(f"a mesh of {size} ranks over a world of {world}")
        return Mesh(shape, axes, rank=dist.get_rank())
    return Mesh(shape, axes, rank=0 if size == 1 else None)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 (data, model), or 2x16x16 (pod, data, model) over 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _bind(shape, axes)


def make_degraded_mesh(n_alive: int, model_parallel: int = 16) -> Mesh:
    """Elastic mesh over the survivors: keep TP fixed, shed DP replicas."""
    dp = n_alive // model_parallel
    assert dp >= 1, "not enough devices for one model-parallel group"
    return _bind((dp, model_parallel), ("data", "model"))


def make_local_mesh(dp: int = 1, mp: int = 1) -> Mesh:
    """A (data, model) mesh over the initialised process group."""
    return _bind((dp, mp), ("data", "model"))


def mesh_axes(mesh) -> Tuple[Tuple[str, ...], str]:
    names = mesh.axis_names
    dp_axes = tuple(n for n in names if n != "model")
    return dp_axes, "model"


def local_block(x, spec: Iterable, mesh: Mesh):
    """This rank's block of a global array (numpy or torch) under ``spec``:
    per dim None, an axis name or a tuple of them."""
    spec = tuple(spec)
    if len(spec) != x.ndim:
        raise ValueError(f"placement {spec} for an array of {x.ndim} dims")
    index = []
    for dim, axes in enumerate(spec):
        if axes is None:
            index.append(slice(None))
            continue
        n = mesh.axis_size(axes)
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                             f"over {axes} ({n})")
        step = x.shape[dim] // n
        i = mesh.index(axes)
        index.append(slice(i * step, (i + 1) * step))
    return x[tuple(index)]
