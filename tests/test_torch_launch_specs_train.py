"""The train cell of the port's launch layer against the reference's:
its context (remat, saved collectives, loss chunk, bf16),
``microbatches_for``, its args and its in and out placements
(``make_shardings``: ``param_pspecs``, ZeRO-1 moments by ``zero1_specs``,
the batch cut on the batch axes) for all 10 archs at model sizes 1, 2, 4
and 16 over both production layouts' batch axes (16, and 2 x 16 over pod
and data); and ``make_shardings`` with ZeRO-1 off, with and without a
frontend.  The reference's cell builds shardings, on an abstract mesh."""
import functools

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import torch  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS, SHAPES  # noqa: E402
from repro.models import transformer as ref_T  # noqa: E402
from repro_torch.configs import ARCHS as T_ARCHS  # noqa: E402
from repro_torch.configs import SHAPES as T_SHAPES  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

NAMES = sorted(ARCHS)


@functools.lru_cache(maxsize=None)
def _ref_params(name):
    return jax.eval_shape(
        lambda: ref_T.init_params(jax.random.PRNGKey(0), ARCHS[name]))


def _dtype_name(dtype):
    return str(dtype).replace("torch.", "")


def _struct(tree):
    """(shape, dtype name) per leaf of a reference or port struct tree."""
    return jax.tree.map(lambda s: (tuple(s.shape), _dtype_name(s.dtype)),
                        tree, is_leaf=lambda s: hasattr(s, "shape"))


def _spec(tree):
    return jax.tree.map(lambda s: tuple(s.spec), tree,
                        is_leaf=lambda s: hasattr(s, "spec"))


def _closed_ctx(fn):
    """The ParallelCtx a reference function closes over, at any depth."""
    for c in fn.__closure__ or ():
        v = c.cell_contents
        if type(v).__name__ == "ParallelCtx":
            return v
        if callable(v) and getattr(v, "__closure__", None):
            found = _closed_ctx(v)
            if found is not None:
                return found
    return None


TRAIN_LAYOUTS = {"data": ("data",), "pod,data": ("pod", "data")}


def _train_mesh(layout, model_size):
    """The production layout's batch axes (16, or 2 x 16) by ``model_size``."""
    dp = TRAIN_LAYOUTS[layout]
    return (2, 16, model_size)[-len(dp) - 1:], dp + ("model",)


@pytest.mark.parametrize("layout", sorted(TRAIN_LAYOUTS))
@pytest.mark.parametrize("model_size", [1, 2, 4, 16])
@pytest.mark.parametrize("name", NAMES)
def test_train_cell_equals_reference(name, model_size, layout):
    """The train cell's context (remat, saved collectives, loss chunk,
    bf16), ``microbatches_for``, its args (f32 params, the AdamW state,
    microbatch-major tokens and labels, the frontend) and its in and out
    placements: ``param_pspecs``, ZeRO-1 moments (``zero1_specs``) over
    the batch axes, the batch cut on them."""
    from jax.sharding import AbstractMesh
    from repro.launch import specs as ref_specs
    shape, axes = _train_mesh(layout, model_size)
    ref = ref_specs.build_train_cell(ARCHS[name], SHAPES["train_4k"],
                                     AbstractMesh(shape, axes))
    cell = specs.build_cell(name, "train_4k", Mesh(shape, axes))
    ref_ctx, ctx = _closed_ctx(ref.fn), cell.meta["ctx"]
    for field in ("dp_axes", "model_axis", "remat", "loss_chunk",
                  "save_collectives", "seq_parallel"):
        assert getattr(ctx, field) == getattr(ref_ctx, field), field
    assert ctx.compute_dtype == torch.bfloat16 and ref_ctx.compute_dtype == jnp.bfloat16
    assert ctx.dp_size() == ref_ctx.dp_size()
    assert cell.meta["microbatches"] == ref.meta["microbatches"] == \
        specs.microbatches_for(T_ARCHS[name], T_SHAPES["train_4k"], Mesh(shape, axes))
    assert cell.meta["tcfg"].zero1
    assert _struct(list(cell.args)) == _struct(list(ref.args))
    assert cell.args[0]["embed"].device.type == "meta"
    assert list(cell.in_shardings) == list(_spec(ref.in_shardings))
    assert list(cell.out_shardings) == list(_spec(ref.out_shardings))
    assert cell.meta["kind"] == ref.meta["kind"] == "train"
    assert cell.donate == ref.donate == (0, 1)


@pytest.mark.parametrize("has_frontend", [False, True])
@pytest.mark.parametrize("name", ["hymba-1.5b", "llama-3.2-vision-11b"])
def test_make_shardings_without_zero1_equals_reference(name, has_frontend):
    """ZeRO-1 off: the moments keep the parameters' placements."""
    from jax.sharding import AbstractMesh
    from repro.train import trainer as ref_trainer
    from repro_torch.train import TrainConfig, make_shardings
    shape, axes = _train_mesh("pod,data", 4)
    ref_ctx = ref_T.ParallelCtx(mesh=AbstractMesh(shape, axes),
                                dp_axes=("pod", "data"))
    want = ref_trainer.make_shardings(ARCHS[name], ref_ctx,
                                      ref_trainer.TrainConfig(zero1=False),
                                      _ref_params(name), has_frontend=has_frontend)
    ctx = T.ParallelCtx(mesh=Mesh(shape, axes), dp_axes=("pod", "data"))
    got = make_shardings(T_ARCHS[name], ctx, TrainConfig(zero1=False),
                         specs.params_struct(T_ARCHS[name], torch.float32),
                         has_frontend=has_frontend)
    assert [list(g) for g in got] == [list(_spec(w)) for w in want]
    assert got[0][1].mu == got[0][0]
