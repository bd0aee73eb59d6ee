"""The port's configs equal the reference's field by field (the port's own
fields absent), the weight
bridge carries every arch's parameter tree over bit for bit, and the port's
``init_params`` builds the reference's tree for every arch."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.models import transformer as ref_T  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

NAMES = sorted(ref_configs.ARCHS)
SSM = ["mamba2-2.7b", "hymba-1.5b"]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module")
def ref_params():
    """Reference parameters of every reduced arch, as numpy arrays."""
    return {name: jax.tree.map(np.asarray, ref_T.init_params(
        jax.random.PRNGKey(0), ref_configs.reduced(ref_configs.ARCHS[name])))
        for name in NAMES}


def test_registries_have_the_same_archs_and_shapes():
    assert sorted(configs.ARCHS) == NAMES
    assert {k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in ref_configs.SHAPES.items()}


# the port's own fields, absent (at these values) in every registered arch:
# the layer pattern and Granite's multipliers, and the MoE's dropless share
PORT_ONLY = {"layer_pattern": (), "embedding_multiplier": None,
             "attention_multiplier": None, "residual_multiplier": None,
             "logits_scaling": None}
PORT_ONLY_MOE = {"dropless": False, "held_first": 0, "held_count": 0}


def ref_fields(port_cfg):
    """The reference's fields of a port config, once its own are checked
    absent."""
    d = dataclasses.asdict(port_cfg)
    assert {k: d.pop(k) for k in PORT_ONLY} == PORT_ONLY
    if d["moe"] is not None:
        assert {k: d["moe"].pop(k) for k in PORT_ONLY_MOE} == PORT_ONLY_MOE
    return d


@pytest.mark.parametrize("name", NAMES)
def test_arch_and_reduced_configs_equal(name):
    ref, port = ref_configs.ARCHS[name], configs.ARCHS[name]
    assert dataclasses.asdict(ref) == ref_fields(port)
    assert dataclasses.asdict(ref_configs.reduced(ref)) == \
        ref_fields(configs.reduced(port))
    for attr in ("padded_vocab", "resolved_head_dim", "is_subquadratic"):
        assert getattr(ref, attr) == getattr(port, attr)
    assert ref.param_count() == port.param_count()
    assert ref.active_param_count() == port.active_param_count()
    for shape in ref_configs.SHAPES.values():
        assert ref_configs.shape_applicable(ref, shape) == \
            configs.shape_applicable(port, configs.SHAPES[shape.name])


@pytest.mark.parametrize("name", NAMES)
def test_bridge_round_trip_is_bit_exact(ref_params, name):
    params = ref_params[name]
    tparams = bridge.to_torch(params, device="cpu")
    # same nesting: dict keys, segment lists, stacked leading layer axis
    assert jax.tree.structure(params) == jax.tree.structure(
        bridge.tree_map(lambda t: 0, tparams))
    back = bridge.to_numpy(tparams)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_bridge_bfloat16_and_cast():
    x = np.random.default_rng(0).standard_normal((3, 5)).astype(np.float32)
    xb = np.asarray(jnp.asarray(x, jnp.bfloat16))
    t = bridge.to_torch({"w": [xb]}, device="cpu")["w"][0]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), xb.astype(np.float32))
    c = bridge.to_torch({"w": x}, device="cpu", dtype=torch.bfloat16)["w"]
    assert torch.equal(c, torch.from_numpy(x).to(torch.bfloat16))
    assert bridge.to_numpy({"w": c})["w"].dtype == np.float32


@pytest.mark.parametrize("name", NAMES)
def test_init_params_has_the_reference_tree(ref_params, name):
    """Structure, shapes and dtypes of every arch's tree equal the
    reference's; norms and the cross-attention gate are zero; the output
    projections, the MoE router and the SSM's out_proj have the reference's
    scales."""
    params = ref_params[name]
    cfg = configs.reduced(configs.ARCHS[name])
    tp = T.init_params(cfg,
                       generator=torch.Generator().manual_seed(0),
                       device="cpu")
    assert shapes_and_dtypes(tp, torch_tree=True) == shapes_and_dtypes(params)
    segs = tp["segments"] + tp.get("enc_segments", [])
    assert not tp["final_ln"].any() and not any(s["ln1"].any() for s in segs)
    wo_scale = 0.02 / np.sqrt(2 * cfg.n_layers)
    for seg in segs:
        for proj in ("attn", "xattn"):
            if proj in seg:
                assert abs(float(seg[proj]["wo"].std()) - wo_scale) < 0.003
        if "ssm" in seg:
            assert abs(float(seg["ssm"]["out_proj"].std()) - 0.02) < 0.003
        if "moe" in seg:
            assert abs(float(seg["moe"]["router"].std()) - 0.006) < 0.001
            assert abs(float(seg["moe"]["experts"]["wd"].std()) - 0.02) < 0.003
        if "xgate" in seg:
            assert not seg["xgate"].any()
        if "lnx" in seg:
            assert not seg["lnx"].any()


@pytest.mark.parametrize("name", ["deepseek-moe-16b", "qwen2-moe-a2.7b",
                                  "llama-3.2-vision-11b", "whisper-large-v3"])
def test_init_params_bf16_tree_keeps_the_f32_leaves(name):
    """In a bf16 tree the MoE router and the cross-attention gate stay
    f32, as in the reference's bf16 tree."""
    cfg = ref_configs.reduced(ref_configs.ARCHS[name])
    ref = jax.tree.map(np.asarray, ref_T.init_params(
        jax.random.PRNGKey(0), cfg, dtype=jnp.bfloat16))
    tp = T.init_params(configs.reduced(configs.ARCHS[name]),
                       generator=torch.Generator().manual_seed(0),
                       dtype=torch.bfloat16, device="cpu")
    assert shapes_and_dtypes(tp, torch_tree=True) == shapes_and_dtypes(ref)


def shapes_and_dtypes(tree, torch_tree=False):
    if torch_tree:
        return bridge.tree_map(lambda t: (tuple(t.shape),
                                          str(t.dtype).replace("torch.", "")),
                               tree)
    return jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), tree)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", SSM)
def test_init_params_ssm_tree_matches_reference(name, dtype):
    """The ``ssm`` (and hymba's ``attn_norm``/``ssm_norm``) subtrees: shapes
    and dtypes as the reference's in f32 and bf16, with ``A_log``, ``D`` and
    ``dt_bias`` float32 and equal to the reference's fixed values."""
    jdt, tdt = DTYPES[dtype]
    cfg = ref_configs.reduced(ref_configs.ARCHS[name])
    ref = jax.tree.map(np.asarray, ref_T.init_params(jax.random.PRNGKey(0),
                                                     cfg, dtype=jdt))
    tp = T.init_params(configs.reduced(configs.ARCHS[name]),
                       generator=torch.Generator().manual_seed(0),
                       dtype=tdt, device="cpu")
    assert shapes_and_dtypes(tp, torch_tree=True) == shapes_and_dtypes(ref)
    for seg, tseg in zip(ref["segments"], tp["segments"]):
        for key in ("A_log", "D", "dt_bias"):
            assert tseg["ssm"][key].dtype == torch.float32
            np.testing.assert_allclose(tseg["ssm"][key].numpy(),
                                       seg["ssm"][key], rtol=1e-6, atol=0)
        assert not tseg["ssm"]["conv_b"].any()
        conv = tseg["ssm"]["conv_x"].float()
        assert abs(float(conv.std()) - 0.5) < 0.1


@pytest.mark.parametrize("name", SSM + ["llama-3.2-vision-11b",
                                        "deepseek-moe-16b"])
def test_bridge_cast_keeps_the_reference_f32_leaves(ref_params, name):
    """Bridging a tree with ``dtype=bfloat16`` casts the weights and leaves
    the leaves the reference always holds in f32 (``A_log``, ``D``,
    ``dt_bias``, ``xgate``, the MoE ``router``) as they are, bit for bit."""
    params = ref_params[name]
    tp = bridge.to_torch(params, device="cpu", dtype=torch.bfloat16)
    flat_ref = jax.tree_util.tree_flatten_with_path(params)[0]
    flat = dict(jax.tree_util.tree_flatten_with_path(
        bridge.tree_map(lambda t: t, tp))[0])
    kept = 0
    for path, a in flat_ref:
        t = flat[path]
        last = path[-1].key if hasattr(path[-1], "key") else None
        if last in bridge.F32_LEAVES:
            assert t.dtype == torch.float32, path
            np.testing.assert_array_equal(t.numpy(), a)
            kept += 1
        else:
            assert t.dtype == torch.bfloat16, path
    assert kept > 0
