"""The port's configs equal the reference's field by field, the weight
bridge carries every arch's parameter tree over bit for bit, and the port's
``init_params`` builds the reference's tree (or names the ROADMAP item for
a kind not ported yet)."""
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
DENSE = ["granite-3-8b", "gemma3-4b", "phi3-mini-3.8b", "h2o-danube-3-4b"]


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


@pytest.mark.parametrize("name", NAMES)
def test_arch_and_reduced_configs_equal(name):
    ref, port = ref_configs.ARCHS[name], configs.ARCHS[name]
    assert dataclasses.asdict(ref) == dataclasses.asdict(port)
    assert dataclasses.asdict(ref_configs.reduced(ref)) == \
        dataclasses.asdict(configs.reduced(port))
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


@pytest.mark.parametrize("name", DENSE)
def test_init_params_has_the_reference_tree(ref_params, name):
    params = ref_params[name]
    cfg = configs.reduced(configs.ARCHS[name])
    tp = T.init_params(cfg,
                       generator=torch.Generator().manual_seed(0),
                       device="cpu")
    want = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), params)
    got = bridge.tree_map(lambda t: (tuple(t.shape),
                                     str(t.dtype).replace("torch.", "")), tp)
    assert got == want
    assert not tp["final_ln"].any() and not tp["segments"][0]["ln1"].any()
    wo = tp["segments"][0]["attn"]["wo"]
    assert abs(float(wo.std()) - 0.02 / np.sqrt(2 * cfg.n_layers)) < 0.003


@pytest.mark.parametrize("name", ["deepseek-moe-16b", "mamba2-2.7b",
                                  "hymba-1.5b", "llama-3.2-vision-11b",
                                  "whisper-large-v3"])
def test_unported_kinds_raise(name):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        T.init_params(configs.reduced(configs.ARCHS[name]),
                      generator=torch.Generator(), device="cpu")
