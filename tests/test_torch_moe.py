"""The port's MoE FFN (``repro_torch.models.moe``) against
``repro.models.moe`` on the same numpy-seeded inputs and bridged params:
router ids equal and gates within 1e-6, ``moe_ffn`` and
``moe_ffn_reference`` outputs and aux losses within 1e-5 in f32, on the
reduced deepseek and qwen configs (no drops) and at a low capacity where
tokens drop; a bf16 case; ties resolved to the lower expert index; and a
combine whose sums repeat bit for bit whatever the other rows hold."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS, reduced  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro.models.layers import KeyGen  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import ARCHS as T_ARCHS  # noqa: E402
from repro_torch.configs.base import MoEConfig  # noqa: E402
from repro_torch.models import moe  # noqa: E402

# (arch, capacity factor): the reduced configs' 8.0 never drops, 0.5 does
CASES = [("deepseek-moe-16b", 8.0), ("qwen2-moe-a2.7b", 8.0),
         ("deepseek-moe-16b", 0.5), ("qwen2-moe-a2.7b", 0.5)]
IDS = [f"{n}-cf{cf}" for n, cf in CASES]
SHAPE = (3, 11)                       # (B, S): T = 33 rows routed together


def setup(name, cf, dtype=jnp.float32, seed=0):
    """Reference MoE config and params, the port's, and an (B, S, d) input."""
    cfg = reduced(ARCHS[name])
    ref_cfg = dataclasses.replace(cfg.moe, capacity_factor=cf)
    port_cfg = MoEConfig(**dataclasses.asdict(ref_cfg))
    params = ref_moe.init_moe(KeyGen(jax.random.PRNGKey(seed)), cfg.d_model,
                              ref_cfg, dtype)
    params = jax.tree.map(np.asarray, params)
    x = np.random.default_rng(seed).standard_normal(
        SHAPE + (cfg.d_model,)).astype(np.float32)
    return ref_cfg, params, port_cfg, bridge.to_torch(params, "cpu"), x


def close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol, rtol=0)


@pytest.mark.parametrize("name,cf", CASES, ids=IDS)
def test_router_ids_gates_and_aux_match(name, cf):
    ref_cfg, params, port_cfg, tparams, x = setup(name, cf)
    xt = x.reshape(-1, x.shape[-1])
    eids, gates, aux = ref_moe.router_topk(params, jnp.asarray(xt), ref_cfg)
    teids, tgates, taux = moe.router_topk(tparams, torch.from_numpy(xt),
                                          port_cfg)
    np.testing.assert_array_equal(teids.numpy(), np.asarray(eids))
    close(tgates.numpy(), gates, 1e-6)
    close(float(taux), float(aux), 1e-5)


@pytest.mark.parametrize("name,cf", CASES, ids=IDS)
def test_moe_ffn_matches_reference(name, cf):
    ref_cfg, params, port_cfg, tparams, x = setup(name, cf)
    out, aux = ref_moe.moe_ffn(params, jnp.asarray(x), ref_cfg)
    tout, taux = moe.moe_ffn(tparams, torch.from_numpy(x), port_cfg)
    assert tout.shape == x.shape and tout.dtype == torch.float32
    close(tout.numpy(), out, 1e-5)
    close(float(taux), float(aux), 1e-5)
    # the low capacity really drops: some expert gets more than ``cap``
    t = SHAPE[0] * SHAPE[1]
    cap = moe.capacity(t, port_cfg)
    assert cap == max(int(t * ref_cfg.top_k / ref_cfg.n_experts * cf), 8)
    eids = moe.router_topk(tparams, torch.from_numpy(x.reshape(t, -1)),
                           port_cfg)[0]
    assert (int(torch.bincount(eids.reshape(-1)).max()) > cap) == (cf < 1)


@pytest.mark.parametrize("name", ["deepseek-moe-16b", "qwen2-moe-a2.7b"])
def test_moe_ffn_reference_oracle_matches(name):
    ref_cfg, params, port_cfg, tparams, x = setup(name, 8.0)
    xt = x.reshape(-1, x.shape[-1])
    out, aux = ref_moe.moe_ffn_reference(params, jnp.asarray(xt), ref_cfg)
    tout, taux = moe.moe_ffn_reference(tparams, torch.from_numpy(xt),
                                       port_cfg)
    close(tout.numpy(), out, 1e-5)
    close(float(taux), float(aux), 1e-5)
    # without drops the dispatch equals the oracle
    tdisp, _ = moe.moe_ffn(tparams, torch.from_numpy(xt), port_cfg)
    close(tdisp.numpy(), tout.numpy(), 1e-5)


@pytest.mark.parametrize("cf", [8.0, 0.5])
def test_moe_ffn_bf16_matches_reference(cf):
    """bf16 weights and activations; the router stays f32 in both trees."""
    ref_cfg, params, port_cfg, tparams, x = setup("deepseek-moe-16b", cf,
                                                 dtype=jnp.bfloat16)
    assert tparams["router"].dtype == torch.float32
    assert tparams["experts"]["wg"].dtype == torch.bfloat16
    xb = jnp.asarray(x, jnp.bfloat16)
    out, aux = ref_moe.moe_ffn(params, xb, ref_cfg)
    tx = bridge.to_torch({"x": np.asarray(xb)}, "cpu")["x"]
    tout, taux = moe.moe_ffn(tparams, tx, port_cfg)
    assert tout.dtype == torch.bfloat16
    close(tout.float().numpy(), np.asarray(out, np.float32), 2e-2)
    close(float(taux), float(aux), 1e-5)


def test_ties_resolve_to_the_lower_expert_index():
    """A zero router gives every expert the same probability: both
    packages pick experts 0..k-1 in order, and dispatch the same."""
    ref_cfg, params, port_cfg, tparams, x = setup("deepseek-moe-16b", 8.0)
    params = {**params, "router": np.zeros_like(params["router"])}
    tparams = {**tparams, "router": torch.zeros_like(tparams["router"])}
    xt = x.reshape(-1, x.shape[-1])
    eids, gates, _ = ref_moe.router_topk(params, jnp.asarray(xt), ref_cfg)
    teids, tgates, _ = moe.router_topk(tparams, torch.from_numpy(xt),
                                       port_cfg)
    k = port_cfg.top_k
    assert (teids.numpy() == np.arange(k)).all()
    np.testing.assert_array_equal(teids.numpy(), np.asarray(eids))
    close(tgates.numpy(), gates, 1e-6)
    out, _ = ref_moe.moe_ffn(params, jnp.asarray(x), ref_cfg)
    tout, _ = moe.moe_ffn(tparams, torch.from_numpy(x), port_cfg)
    close(tout.numpy(), out, 1e-5)


def test_a_row_keeps_its_bits_whatever_the_other_rows_hold():
    """Decode routes every row of the batch in one call: with no drops, a
    row's output is bit-identical when the other rows change, and on a
    repeat (a fixed order of sums, no scatter-add)."""
    _, _, port_cfg, tparams, x = setup("deepseek-moe-16b", 8.0)
    xb = torch.from_numpy(x[:, :1].copy())            # (B, 1, d): T = B
    first, _ = moe.moe_ffn(tparams, xb, port_cfg)
    again, _ = moe.moe_ffn(tparams, xb.clone(), port_cfg)
    assert torch.equal(first, again)
    other = xb.clone()
    other[1:] = torch.randn(other[1:].shape,
                            generator=torch.Generator().manual_seed(1))
    moved, _ = moe.moe_ffn(tparams, other, port_cfg)
    assert torch.equal(moved[0], first[0])


def test_padded_experts_are_never_routed():
    qwen = T_ARCHS["qwen2-moe-a2.7b"].moe
    assert moe.padded_experts(qwen) == 64 and qwen.n_experts == 60
    ref_cfg, _, port_cfg, tparams, x = setup("qwen2-moe-a2.7b", 8.0)
    assert tparams["experts"]["wg"].shape[0] == moe.padded_experts(port_cfg)
    eids, _, _ = moe.router_topk(tparams, torch.from_numpy(
        x.reshape(-1, x.shape[-1])), port_cfg)
    assert int(eids.max()) < port_cfg.n_experts
