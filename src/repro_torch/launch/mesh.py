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

Under autograd (``torch.is_grad_enabled()`` and an input that requires a
gradient) the collectives are ``torch.autograd.Function``s whose backward
is the adjoint of the reference's SPMD semantics, where a value replicated
over an axis carries the whole cotangent on every rank (the Megatron
convention, which GSPMD follows):

* ``all_reduce`` sum: the output is replicated, so each rank's cotangent
  is already the whole one (identity backward);
* ``enter``: identity forward, sum over the axes backward.  It marks where
  a replicated value enters rank-local work (a column-parallel product, a
  slice by rank), whose cotangents are each rank's part;
* ``all_gather``: the rank's slice of the cotangent.  Where the gathered
  value feeds rank-local work, ``enter`` follows it, and the pair's
  backward is a reduce-scatter.  Its transport is an all-reduce followed
  by the slice on every backend: gloo has no reduce-scatter on CUDA tensors;
* ``ring_shift``: the reverse hop;
* ``all_reduce`` max: no gradient (the reference's ``stop_gradient``).

Outside autograd they are the plain transports, bit for bit.  Every
transport is counted in ``Mesh.stats`` (calls and host wall, forward and
backward apart), and inside ``Mesh.taped`` the forward transports are
recorded, then replayed when a checkpointed region is recomputed
(``ParallelCtx.save_collectives``).

A dry mesh (``dry=True``) stands for one rank of a mesh and moves
nothing: it builds no process group, and its transports return empty
tensors of the real output's shape and dtype on the input's device (the
meta device in the dry run, ``launch/dryrun.py``), counted in ``stats``
as any mesh's are.

Mesh builders are functions, so importing this module touches no process
group.
"""
from __future__ import annotations

import contextlib
import itertools
import time
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
    questions of shape (``launch/specs.py``), and its collectives raise.  A
    dry mesh is rank ``rank`` of the mesh without a process group: its
    transports move nothing and return the outputs' shapes (see the module
    docstring)."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str], *,
                 rank: Optional[int] = None, dry: bool = False):
        if len(shape) != len(axis_names):
            raise ValueError(f"shape {tuple(shape)} and axes {tuple(axis_names)}")
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, map(int, shape)))
        self.size = int(np.prod(shape))
        self.rank = rank
        self.dry = dry
        self.coords: Dict[str, int] = {}
        self._groups: Dict[Tuple[str, ...], object] = {}
        self._ranks: Dict[Tuple[str, ...], Tuple[int, ...]] = {}
        # (direction, op) -> [calls, host ms inside them, output bytes]
        self.stats: Dict[Tuple[str, str], list] = {}
        self._tape: Optional[Tape] = None
        if rank is None:
            if dry:
                raise ValueError("a dry mesh stands for one rank: give it")
            return
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} outside a mesh of {self.size}")
        self.coords = dict(zip(self.axis_names,
                               map(int, np.unravel_index(rank, tuple(shape)))))
        if self.size == 1 or dry:
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
        return dist.get_backend() if self.size > 1 and not self.dry else None

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
        """``x`` reduced over ``axes`` (``sum`` or ``max``): in place
        outside autograd; under it a new tensor (see the module docstring)."""
        axes = self._axes(axes)
        if op == "max" and _records(x):
            x = x.detach().clone()
        if self.axis_size(axes) == 1:
            return x
        if _records(x):
            return _AllReduce.apply(x, self, axes)
        return self._move("all_reduce", self._reduce, x, axes, op)

    def enter(self, x: torch.Tensor, axes: Axes):
        """``x``, replicated over ``axes``, as the input of rank-local work:
        the identity, whose backward sums the ranks' cotangents."""
        axes = self._axes(axes)
        if self.axis_size(axes) == 1 or not _records(x):
            return x
        return _Enter.apply(x, self, axes)

    def all_gather(self, x: torch.Tensor, axes: Axes, dim: int = -1):
        """The ranks' ``x`` along ``axes`` concatenated on ``dim`` in index
        order."""
        axes = self._axes(axes)
        if self.axis_size(axes) == 1:
            return x
        if _records(x):
            return _AllGather.apply(x, self, axes, dim)
        return self._move("all_gather", self._gather, x, axes, dim)

    def ring_shift(self, x: torch.Tensor, axis: str):
        """One hop along ``axis``'s ring: rank i sends ``x`` to i + 1 and
        returns what i - 1 sent (the reference's ``ppermute`` with
        ``perm = [(i, (i + 1) % n)]``)."""
        axes = self._axes(axis)
        if self.axis_size(axes) == 1:
            return x
        if _records(x):
            return _RingShift.apply(x, self, axes)
        return self._move("ring_shift", self._shift, x, axes, 1)

    # ---- transports, counted and taped -------------------------------------

    def _move(self, op, fn, *args):
        """``fn(*args)``, one transport (on a dry mesh its output's shape
        only), counted in ``stats``; inside ``taped`` a forward transport
        is recorded, or replayed in the recompute of a checkpointed
        region."""
        tape = self._tape          # set only while a region's forward runs
        if tape is not None and tape.replaying:
            return tape.replay()
        # a checkpointed region's recompute runs inside the backward
        direction = "backward" if _in_backward() else "forward"
        t0 = time.perf_counter()
        out = self._dry_move(op, *args) if self.dry else fn(*args)
        row = self.stats.setdefault((direction, op), [0, 0.0, 0])
        row[0] += 1
        row[1] += 1e3 * (time.perf_counter() - t0)
        row[2] += out.numel() * out.element_size()
        if tape is not None:
            tape.record(out)
        return out

    def _dry_move(self, op, x, axes, arg):
        """What a transport returns, without its values: an all-gather's
        ``axis_size`` blocks along ``dim`` (``arg``), an all-reduce's input
        (reduced in place), a ring shift's received tensor."""
        if op == "all_gather":
            shape = list(x.shape)
            shape[arg] *= self.axis_size(axes)
            return x.new_empty(shape)
        return x if op == "all_reduce" else torch.empty_like(x.contiguous())

    def _reduce(self, x, axes, op):
        red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        dist.all_reduce(x, op=red, group=self._group(axes))
        return x

    def _gather(self, x, axes, dim):
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.axis_size(axes))]
        dist.all_gather(parts, x, group=self._group(axes))
        return torch.cat(parts, dim=dim)

    def _shift(self, x, axes, step):
        """Rank i sends ``x`` to i + ``step`` and returns what i - ``step``
        sent."""
        if self._staged("send_recv", x):
            return self._shift(_pinned(x), axes, step).to(x.device)
        n = self.axis_size(axes)
        ranks = self._ranks[axes]
        i = ranks.index(self.rank)
        x = x.contiguous()
        out = torch.empty_like(x)
        ops = [dist.P2POp(dist.isend, x, ranks[(i + step) % n], self._group(axes)),
               dist.P2POp(dist.irecv, out, ranks[(i - step) % n], self._group(axes))]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return out

    @contextlib.contextmanager
    def taped(self, tape: "Tape"):
        """Forward transports inside record to (or replay from) ``tape``."""
        prev, self._tape = self._tape, tape
        try:
            yield
        finally:
            self._tape = prev

    def stats_total(self, direction: Optional[str] = None):
        """(calls, host ms) summed over ``stats``, of one direction or both."""
        rows = [v for (d, _), v in self.stats.items() if direction in (None, d)]
        return sum(r[0] for r in rows), sum(r[1] for r in rows)


class Tape:
    """The forward transports' outputs of one checkpointed region: recorded
    in its first call, replayed in order in every later call (the
    recompute), so that the backward does not move them again.  The region
    calls ``start`` at each entry."""

    def __init__(self):
        self.outs: list = []
        self.calls = 0
        self.replaying = False
        self._i = 0

    def start(self):
        self.replaying = self.calls > 0
        self.calls += 1
        self._i = 0

    def record(self, out):
        self.outs.append(out.detach())

    def replay(self):
        out = self.outs[self._i]
        self._i += 1
        return out.clone()


def _records(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def _in_backward() -> bool:
    """True inside the autograd engine's backward (a checkpoint's recompute
    included)."""
    return torch._C._current_graph_task_id() != -1


class _AllReduce(torch.autograd.Function):
    """Sum over ``axes``; the output is replicated, so the backward is the
    identity."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        return mesh._move("all_reduce", mesh._reduce, x.clone(), axes, "sum")

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Enter(torch.autograd.Function):
    """Identity forward; the backward sums the ranks' cotangents."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (ctx.mesh._move("all_reduce", ctx.mesh._reduce, g.clone(),
                               ctx.axes, "sum"), None, None)


class _AllGather(torch.autograd.Function):
    """Gather on ``dim``; the backward takes the rank's slice."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.block = (dim, mesh.index(axes) * x.shape[dim], x.shape[dim])
        return mesh._move("all_gather", mesh._gather, x, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(*ctx.block), None, None, None


class _RingShift(torch.autograd.Function):
    """One hop forward; the reverse hop backward."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return mesh._move("ring_shift", mesh._shift, x, axes, 1)

    @staticmethod
    def backward(ctx, g):
        return (ctx.mesh._move("ring_shift", ctx.mesh._shift, g, ctx.axes, -1),
                None, None)


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


def make_pod_mesh(pod: int = 2, dp: int = 1, mp: int = 1) -> Mesh:
    """A (pod, data, model) mesh over the initialised process group (the
    pipeline's, ``launch/pipeline.py``)."""
    return _bind((pod, dp, mp), ("pod", "data", "model"))


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
