"""Gradients through the launch layer's collectives (``launch/mesh.py``)
on gloo ranks, each against one process's autograd of the same global
function (float64, within 1e-10):

* ``all_reduce`` sum (identity backward: the replicated output's cotangent
  is whole on every rank), ``enter`` (the sum of the ranks' cotangents),
  ``all_gather`` (the rank's slice), ``all_gather`` then ``enter`` (a
  reduce-scatter), ``ring_shift`` (the reverse hop) and the ``max``
  all-reduce (no gradient);
* ``layers.col_parallel``/``row_parallel`` (the Megatron pair, with the
  replicated input sliced and with the weight whole), and
  ``transformer.Rows`` under sequence parallelism (``take``, ``gather``
  and a parameter on the rank's rows).

Over 2 ranks (model 2), 4 ranks (model 4) and 4 ranks over both axes of
a 2x2 mesh.  torch's warning that a collective has no autograd kernel is
an error on every rank."""
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

import torch  # noqa: E402

import torch_launch_parity as lp  # noqa: E402

TOL = 1e-10
MESHES = {"model2": ((1, 2), "model"), "model4": ((1, 4), "model"),
          "both2x2": ((2, 2), ("data", "model"))}
COLLECTIVES = ["all_reduce", "enter", "all_gather", "gather_enter",
               "ring_shift", "max"]
LAYERS = ["row_sliced", "row_cut", "row_whole_w", "rows_sp"]   # one axis


def ops_for(name):
    return COLLECTIVES + (LAYERS if isinstance(MESHES[name][1], str) else [])


CASES = [(name, op) for name in sorted(MESHES) for op in ops_for(name)]
D, S = 6, 7          # Rows: S does not divide the ranks


def inputs(n):
    """Global inputs for ``n`` ranks, numpy-seeded."""
    rng = np.random.default_rng(n)
    return {"x": rng.standard_normal((n, 3, 4)),          # one block a rank
            "c": rng.standard_normal((3, 4 * n)),          # a constant
            "h": rng.standard_normal((2, 3, 5)),           # replicated input
            "v": rng.standard_normal((5, 4 * n)),          # column-parallel
            "w": rng.standard_normal((4 * n, 5)),          # row-parallel
            "r": rng.standard_normal((2, S, D)),           # a residual
            "p": rng.standard_normal((D,))}                # a row parameter


def global_loss(op, t, n):
    """The loss every rank computes, written over the global inputs ``t``
    (torch float64 tensors that take gradients)."""
    x, c, h, w, v = t["x"], t["c"], t["h"], t["w"], t["v"]
    if op == "all_reduce":
        return ((x.sum(0) * c[:, :4]) ** 2).sum()
    if op == "enter":
        return sum((torch.sin(x[0] * (r + 1)) * c[:, 4 * r:4 * r + 4]).sum()
                   for r in range(n))
    if op == "all_gather":
        return (torch.cat(list(x), -1) ** 2 * c).sum()
    if op == "gather_enter":
        y = torch.cat(list(x), -1)
        return sum((y[:, 4 * r:4 * r + 4] * y[:, :4] * (r + 1)).sum()
                   for r in range(n))
    if op == "ring_shift":
        return sum((x[(r - 1) % n] ** 2 * c[:, 4 * r:4 * r + 4]).sum()
                   for r in range(n))
    if op == "max":
        m = x.max(0).values.detach()
        return ((x - m) ** 2).sum()
    if op in ("row_sliced", "row_cut", "row_whole_w"):
        return (torch.tanh(h @ v @ w) ** 2).sum()
    if op == "rows_sp":
        y = torch.cumsum(t["r"] * (1 + t["p"]), dim=1)
        return (torch.sin(y) * y).sum()
    raise ValueError(op)


def rank_loss(op, t, mesh, axes):
    """The same loss on a rank: ``t`` holds its blocks (``x``: its own;
    ``w`` and ``v``: its blocks where the op cuts them)."""
    from repro_torch.models.layers import col_parallel, row_parallel
    from repro_torch.models.transformer import ParallelCtx, Rows
    n, r = mesh.axis_size(axes), mesh.index(axes)
    x, c, h = t["x"], t["c"], t["h"]
    if op == "all_reduce":
        return ((mesh.all_reduce(x, axes) * c[:, :4]) ** 2).sum()
    if op == "enter":
        part = (torch.sin(mesh.enter(x, axes) * (r + 1)) * c[:, 4 * r:4 * r + 4]).sum()
        return mesh.all_reduce(part, axes)
    if op == "all_gather":
        return (mesh.all_gather(x, axes) ** 2 * c).sum()
    if op == "gather_enter":
        y = mesh.enter(mesh.all_gather(x, axes), axes)
        return mesh.all_reduce((y[:, 4 * r:4 * r + 4] * y[:, :4] * (r + 1)).sum(), axes)
    if op == "ring_shift":
        part = (mesh.ring_shift(x, axes) ** 2 * c[:, 4 * r:4 * r + 4]).sum()
        return mesh.all_reduce(part, axes)
    if op == "max":
        return mesh.all_reduce(((x - mesh.all_reduce(x, axes, "max")) ** 2).sum(), axes)
    if op in ("row_sliced", "row_cut", "row_whole_w"):
        f = 4 * n
        g = col_parallel(h, t["v"], f, mesh, axes)
        return (torch.tanh(row_parallel(g, t["w"], f, mesh, axes)) ** 2).sum()
    if op == "rows_sp":
        ctx = ParallelCtx(mesh=mesh, model_axis=axes, seq_parallel=True)
        rows = Rows(ctx, S)
        y = rows.gather(rows.take(t["r"]) * (1 + rows.param(t["p"])))
        return (torch.sin(torch.cumsum(y, dim=1)) * torch.cumsum(y, dim=1)).sum()
    raise ValueError(op)


def grad_rank(rank, workdir, name):
    """One rank: every op's gradients of its inputs, saved."""
    from repro_torch.launch.mesh import local_block, make_local_mesh
    lp._no_unregistered_autograd()
    shape, axes = MESHES[name]
    mesh = make_local_mesh(*shape)
    n, r = mesh.axis_size(axes), mesh.index(axes)
    g = inputs(n)
    out = {}
    for op in ops_for(name):
        # enter's input is replicated: every rank holds block 0
        x = g["x"][0 if op == "enter" else r]
        t = {"x": x, "c": g["c"], "h": g["h"], "r": g["r"], "p": g["p"]}
        # row_sliced: v whole, w cut (the replicated product sliced);
        # row_cut: both cut; row_whole_w: v cut, w whole (the product
        # gathered)
        t["v"] = g["v"] if op == "row_sliced" else local_block(g["v"], (None, axes), mesh)
        t["w"] = g["w"] if op == "row_whole_w" else local_block(g["w"], (axes, None), mesh)
        t = {k: torch.tensor(np.ascontiguousarray(a), requires_grad=k != "c")
             for k, a in t.items()}
        loss = rank_loss(op, t, mesh, axes)
        keys = sorted(k for k in t if k != "c")
        grads = torch.autograd.grad(loss, [t[k] for k in keys], allow_unused=True)
        out[f"{op}/loss"] = loss.detach().numpy()
        for k, gr in zip(keys, grads):
            if gr is not None:
                out[f"{op}/{k}"] = gr.numpy()
    np.savez(lp.rank_out(Path(workdir), rank), **out)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = {}
    for name, (shape, _) in sorted(MESHES.items()):
        workdir = tmp_path_factory.mktemp(f"grad_{name}")
        world = shape[0] * shape[1]
        lp.spawn_ranks(grad_rank, world, str(workdir), name)
        out[name] = [dict(np.load(lp.rank_out(workdir, r))) for r in range(world)]
    return out


def _block(a, dim, n, i):
    return np.split(a, n, axis=dim)[i]


@pytest.mark.parametrize("name,op", CASES)
def test_gradient_matches_one_process(runs, name, op):
    from repro_torch.launch.mesh import Mesh
    outs = runs[name]
    shape, axes = MESHES[name]
    layout = Mesh(shape, ("data", "model"))
    n = layout.axis_size(axes)
    g = inputs(n)
    t = {k: torch.tensor(a, requires_grad=k != "c") for k, a in g.items()}
    loss = global_loss(op, t, n)
    keys = [k for k in t if k != "c"]
    want = dict(zip(keys, torch.autograd.grad(loss, [t[k] for k in keys],
                                              allow_unused=True)))
    for rank, got in enumerate(outs):
        layout.coords = dict(zip(("data", "model"), map(int, np.unravel_index(rank, shape))))
        r = layout.index(axes)
        loss = float(loss)
        assert abs(float(got[f"{op}/loss"]) - loss) <= TOL * max(1, abs(loss))
        wx = want["x"]
        checks = {"x": None if wx is None else wx[0 if op == "enter" else r],
                  "h": want["h"], "r": want["r"], "p": want["p"]}
        if op in ("row_sliced", "row_cut", "row_whole_w"):
            checks["v"] = want["v"] if op == "row_sliced" else \
                _block(want["v"].numpy(), 1, n, r)
            checks["w"] = want["w"] if op == "row_whole_w" else \
                _block(want["w"].numpy(), 0, n, r)
        for k, w in checks.items():
            key = f"{op}/{k}"
            if w is None or (isinstance(w, torch.Tensor) and not w.abs().sum()):
                # no gradient reaches this input
                assert key not in got or not np.abs(got[key]).sum(), key
                continue
            w = w.numpy() if isinstance(w, torch.Tensor) else w
            assert key in got, f"rank {rank}: no gradient for {k}"
            err = float(np.abs(got[key] - w).max())
            assert err <= TOL * max(1.0, float(np.abs(w).max())), (rank, k, err)
