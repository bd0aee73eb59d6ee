"""Placements and decode geometry of the port's launch layer against the
reference's: ``param_pspecs`` for all 10 archs at model sizes 1, 2, 4 and
16, ``plan_for``, ``cache_geometry`` and ``decode_struct`` (shapes,
dtypes, placements) for both decode shapes, bf16 and int8 pools, on the
production layouts, the SSD state's three placements, and the prefill
cell's ``seq_parallel`` rule, context, args and input placements for all
10 archs at model sizes 1, 2, 4 and 16.  The reference reads only
``mesh.shape`` and ``mesh.axis_names`` in ``decode_struct``, so a stand-in
mesh serves it; its prefill cell builds shardings, on an abstract mesh."""
import functools

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import torch  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import ARCHS, SHAPES  # noqa: E402
from repro.launch import serve_step as ref_SS  # noqa: E402
from repro.models import transformer as ref_T  # noqa: E402
from repro_torch.configs import ARCHS as T_ARCHS  # noqa: E402
from repro_torch.configs import SHAPES as T_SHAPES  # noqa: E402
from repro_torch.launch import serve_step as SS  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

NAMES = sorted(ARCHS)
LAYOUTS = {"16x16": ((16, 16), ("data", "model")),
           "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


class StandIn:
    def __init__(self, shape, names):
        self.shape = dict(zip(names, shape))
        self.axis_names = names


def _tuples(tree):
    return jax.tree.map(tuple, tree, is_leaf=lambda s: isinstance(s, P))


@functools.lru_cache(maxsize=None)
def _ref_params(name):
    return jax.eval_shape(
        lambda: ref_T.init_params(jax.random.PRNGKey(0), ARCHS[name]))


@pytest.mark.parametrize("model_size", [1, 2, 4, 16])
@pytest.mark.parametrize("name", NAMES)
def test_placements_equal_param_pspecs(name, model_size):
    want = _tuples(ref_T.param_pspecs(_ref_params(name), ARCHS[name],
                                      model_size=model_size))
    cfg = T_ARCHS[name]
    got = T.param_pspecs(specs.params_struct(cfg, torch.float32), cfg,
                         model_size=model_size)
    assert got == want


def _dtype_name(dtype):
    return str(dtype).replace("torch.", "")


def _struct(tree):
    """(shape, dtype name) per leaf of a reference or port struct tree."""
    return jax.tree.map(lambda s: (tuple(s.shape), _dtype_name(s.dtype)),
                        tree, is_leaf=lambda s: hasattr(s, "shape"))


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("shape_name", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("name", NAMES)
def test_decode_struct_equals_reference(name, layout, shape_name, kv_dtype):
    shape, axes = LAYOUTS[layout]
    ref_plan = ref_SS.plan_for(SHAPES[shape_name], StandIn(shape, axes),
                               kv_dtype=kv_dtype)
    mesh = Mesh(shape, axes)
    plan = SS.plan_for(T_SHAPES[shape_name], mesh, kv_dtype=kv_dtype)
    assert plan == SS.DecodePlan(**vars(ref_plan))
    assert (plan.batch_spec(), plan.kv_spec()) == \
        (ref_plan.batch_spec(), ref_plan.kv_spec())
    cfg, ref_cfg = T_ARCHS[name], ARCHS[name]
    assert SS.cache_geometry(cfg, T_SHAPES[shape_name], mesh, plan) == \
        ref_SS.cache_geometry(ref_cfg, SHAPES[shape_name],
                              StandIn(shape, axes), ref_plan)
    want = ref_SS.decode_struct(ref_cfg, SHAPES[shape_name],
                                StandIn(shape, axes), ref_plan,
                                dtype=jnp.bfloat16)
    got = SS.decode_struct(cfg, T_SHAPES[shape_name], mesh, plan,
                           dtype=torch.bfloat16)
    caches, cache_specs, step, step_specs, geo = got
    assert _struct(caches) == _struct(want[0])
    assert cache_specs == _tuples(want[1])
    assert _struct(step) == _struct(want[2])
    assert step_specs == _tuples(want[3])
    assert geo == want[4]


@pytest.mark.parametrize("name", ["granite-3-8b", "gemma3-4b",
                                  "phi3-mini-3.8b", "h2o-danube-3-4b"])
def test_decode_cell_args_and_placements(name):
    """The decode cell of the four attention archs: its args are
    ``params_struct`` and ``decode_struct``, its placements
    ``param_pspecs``'s and ``decode_struct``'s."""
    mesh = Mesh((16, 16), ("data", "model"))
    cell = specs.build_cell(name, "decode_32k", mesh)
    cfg = T_ARCHS[name]
    pshape, caches, step = cell.args
    assert pshape["embed"].device.type == "meta"
    assert cell.in_shardings[0] == T.param_pspecs(pshape, cfg, 16)
    _, cache_specs, _, step_specs, geo = SS.decode_struct(
        cfg, T_SHAPES["decode_32k"], mesh, cell.meta["plan"])
    assert cell.in_shardings[1:] == (cache_specs, step_specs)
    assert cell.out_shardings == (step_specs["tokens"], cache_specs)
    assert cell.meta["geo"] == geo and cell.donate == (1,)


def test_build_cell_skips_what_does_not_apply_and_waits_for_13b_13c():
    """Only the train cell still waits (13c); 13b's prefill cell and the
    other kinds' decode cells build.  (The name is from when they waited
    for 13b.)"""
    mesh = Mesh((16, 16), ("data", "model"))
    # pure full attention: the 500k decode working set is unbounded
    assert specs.build_cell("granite-3-8b", "long_500k", mesh) is None
    with pytest.raises(NotImplementedError, match="13c"):
        specs.build_cell("granite-3-8b", "train_4k", mesh)
    assert specs.build_cell("granite-3-8b", "prefill_32k", mesh).meta["kind"] \
        == "prefill"
    assert specs.build_cell("mamba2-2.7b", "decode_32k", mesh).meta["kind"] \
        == "decode"


@pytest.mark.parametrize("model_size", [2, 4])
@pytest.mark.parametrize("name", ["granite-3-8b", "hymba-1.5b"])
def test_shard_to_torch_cuts_torch_leaves_as_numpy_leaves(name, model_size):
    """``bridge.shard_to_torch`` gives each rank the same blocks from a torch
    tree as from its numpy copy, as copies (the global tree can be freed)
    with the ``F32_LEAVES`` kept in f32, and the ranks' blocks of the fused
    SwiGLU ``wgu`` put back together are the whole weight."""
    from repro_torch import bridge
    from repro_torch.configs import reduced
    cfg = reduced(T_ARCHS[name])
    full = T.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    placements = T.param_pspecs(full, cfg, model_size=model_size)
    wgu = []
    for r in range(model_size):
        mesh = Mesh((1, model_size), ("data", "model"))   # a layout at rank r
        mesh.coords = {"data": 0, "model": r}
        got, _ = bridge.tree_flatten(bridge.shard_to_torch(
            full, placements, mesh, device="cpu", dtype=torch.bfloat16))
        want, _ = bridge.tree_flatten(bridge.shard_to_torch(
            bridge.to_numpy(full), placements, mesh, device="cpu", dtype=torch.bfloat16))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)
        leaves, _ = bridge.tree_flatten(full)
        assert not any(g.untyped_storage().data_ptr() == f.untyped_storage().data_ptr()
                       for g, f in zip(got, leaves))
        block = bridge.shard_to_torch(full, placements, mesh, device="cpu")
        wgu.append(block["segments"][0]["mlp"]["wgu"])
        if "ssm" in block["segments"][0]:
            assert bridge.shard_to_torch(full, placements, mesh, device="cpu",
                                         dtype=torch.bfloat16)["segments"][0]["ssm"][
                "A_log"].dtype == torch.float32
    assert torch.equal(torch.cat(wgu, dim=-1), full["segments"][0]["mlp"]["wgu"])


@pytest.mark.parametrize("name,model_size,placement", [
    ("mamba2-2.7b", 16, (None, "data", "model", None, None)),     # 80 heads
    ("hymba-1.5b", 4, (None, "data", None, "model", None)),       # 50 heads
    ("hymba-1.5b", 3, (None, "data", None, None, None))])         # neither
def test_ssm_state_placements(name, model_size, placement):
    """``ssm_h`` is cut on heads where they divide the model axis, else on
    head_dim, else whole, as the reference's ``decode_struct`` and the SSM
    decode's ``tp_layout`` cut it; the conv ring stays whole."""
    from repro_torch.models.ssm import ssm_dims, tp_layout
    shape = (2, model_size)
    plan = SS.plan_for(T_SHAPES["decode_32k"], Mesh(shape, ("data", "model")))
    got = SS.decode_struct(T_ARCHS[name], T_SHAPES["decode_32k"],
                           Mesh(shape, ("data", "model")), plan)[1]
    ref_plan = ref_SS.plan_for(SHAPES["decode_32k"], StandIn(shape, ("data", "model")))
    want = _tuples(ref_SS.decode_struct(ARCHS[name], SHAPES["decode_32k"],
                                        StandIn(shape, ("data", "model")),
                                        ref_plan)[1])
    states = [s["ssm_h"] for s in got if "ssm_h" in s]
    assert states and all(s == placement for s in states)
    assert [s["ssm_h"] for s in want if "ssm_h" in s] == states
    assert all(s["ssm_conv"] == (None, "data", None, None) for s in got if "ssm_conv" in s)
    cfg = T_ARCHS[name]
    _, n_heads, _ = ssm_dims(cfg.d_model, cfg.ssm)
    layout = tp_layout(n_heads, cfg.ssm.head_dim, model_size)
    assert placement.index("model") - 2 == {"heads": 0, "head_dim": 1}[layout] \
        if layout else "model" not in placement


def _ref_ctx(cell):
    """The ParallelCtx the reference's prefill ``fn`` closes over."""
    return next(c.cell_contents for c in cell.fn.__closure__
                if type(c.cell_contents).__name__ == "ParallelCtx")


@pytest.mark.parametrize("model_size", [1, 2, 4, 16])
@pytest.mark.parametrize("name", NAMES)
def test_prefill_cell_equals_reference(name, model_size):
    """The prefill cell's ``seq_parallel`` rule (on where the heads divide
    the model axis or the arch is MHA, and for attention-free archs), its
    context, its args' shapes and dtypes and its input placements."""
    from jax.sharding import AbstractMesh
    from repro.launch import specs as ref_specs
    shape = (4, model_size)
    ref = ref_specs.build_prefill_cell(ARCHS[name], SHAPES["prefill_32k"],
                                       AbstractMesh(shape, ("data", "model")))
    cell = specs.build_cell(name, "prefill_32k", Mesh(shape, ("data", "model")))
    ref_ctx, ctx = _ref_ctx(ref), cell.meta["ctx"]
    assert ctx.seq_parallel == ref_ctx.seq_parallel
    assert (ctx.dp_axes, ctx.model_axis, ctx.remat) == \
        (ref_ctx.dp_axes, ref_ctx.model_axis, ref_ctx.remat)
    assert ctx.compute_dtype == torch.bfloat16 and ref_ctx.compute_dtype == jnp.bfloat16
    assert ctx.residual_spec() == tuple(ref_ctx.residual_spec())
    assert _struct(list(cell.args)) == _struct(list(ref.args))
    ref_ins = jax.tree.map(lambda s: tuple(s.spec), ref.in_shardings,
                           is_leaf=lambda s: hasattr(s, "spec"))
    assert list(cell.in_shardings) == list(ref_ins)
    assert cell.meta["kind"] == ref.meta["kind"] == "prefill" and cell.donate == ()
    cfg = T_ARCHS[name]
    if name == "hymba-1.5b" and model_size > 1:     # GQA, 25 heads
        assert not ctx.seq_parallel
    if not cfg.n_heads or name == "whisper-large-v3":
        assert ctx.seq_parallel
