"""The port's serving engine against the JAX engine on the MoE archs
(reduced deepseek-moe-16b: a dense first layer, then routed + shared
experts; reduced qwen2-moe-a2.7b: experts padded 4 -> 16, renormalised
gates), CPU, f32: the same tokens and the same ``EngineStats`` under pool
pressure for all four policies, and pressured tokens equal to an
unpressured run.  At a low capacity factor prefills drop tokens, and an
infiniswap re-prefill (prompt + generated tokens routed together) drops
differently from the first prefill; the two engines still agree.  Every
prompt has one length, so the JAX engine compiles each shape once."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.policies import POLICIES  # noqa: E402
from repro_torch.models import moe as moe_lib  # noqa: E402
from repro_torch.serve import ValetServeEngine  # noqa: E402
from torch_parity import (CTX, GEOM, assert_same_engines, both,  # noqa: E402
                          make_setup, run)

ARCH_NAMES = ["deepseek-moe-16b", "qwen2-moe-a2.7b"]
POLICY_NAMES = ["valet", "valet-mass", "infiniswap", "os-swap"]
PROMPT_LENS = [8] * 6
LOW_CAPACITY = 0.5


def low_capacity(setup):
    """The same setup with the MoE capacity factor cut to LOW_CAPACITY in
    both packages' configs."""
    cfg, params, tcfg, tparams, prompts = setup
    cut = [dataclasses.replace(c, moe=dataclasses.replace(
        c.moe, capacity_factor=LOW_CAPACITY)) for c in (cfg, tcfg)]
    return cut[0], params, cut[1], tparams, prompts


@pytest.fixture(scope="module")
def setups():
    return {name: make_setup(name, PROMPT_LENS) for name in ARCH_NAMES}


@pytest.fixture(scope="module")
def pressured(setups):
    return {(name, p): both(setups[name], p, 10)
            for name in ARCH_NAMES for p in POLICY_NAMES}


@pytest.mark.parametrize("policy", POLICY_NAMES)
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_tokens_and_stats_match_reference_under_pressure(pressured, name,
                                                         policy):
    (ref_outs, ref_eng), (outs, eng) = pressured[(name, policy)]
    assert outs == ref_outs, f"{name} {policy} diverged from the JAX engine"
    assert eng.stats.pauses > 0
    assert_same_engines(ref_eng, eng)


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_unconstrained_pool_matches_pressured_tokens(setups, pressured,
                                                     name):
    _, _, tcfg, tparams, prompts = setups[name]
    outs, eng = run(ValetServeEngine, tparams, tcfg, CTX, prompts, POLICIES,
                    "valet", 64)
    assert eng.stats.pauses == 0
    for policy in POLICY_NAMES:
        assert pressured[(name, policy)][1][0] == outs, policy


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_infiniswap_at_low_capacity_matches_reference(name, monkeypatch):
    """16-token prompts at a low capacity: the prefills' routing overflows
    an expert's capacity (8 entries, the floor), so tokens drop, and the
    re-prefills of infiniswap's recomputes route more rows than the first
    prefills did."""
    setup = low_capacity(make_setup(name, [16] * 6))
    overflow = []

    def recording(params, x, moe_cfg, _fn=moe_lib.router_topk):
        eids, gates, aux = _fn(params, x, moe_cfg)
        load = int(torch.bincount(eids.reshape(-1)).max())
        overflow.append((x.shape[0], load - moe_lib.capacity(x.shape[0],
                                                             moe_cfg)))
        return eids, gates, aux
    monkeypatch.setattr(moe_lib, "router_topk", recording)
    (ref_outs, ref_eng), (outs, eng) = both(setup, "infiniswap", 10)
    assert outs == ref_outs, f"{name} low-capacity infiniswap diverged"
    assert eng.stats.recomputes > 0
    assert_same_engines(ref_eng, eng)
    prefills = [(t, over) for t, over in overflow if t > GEOM["max_batch"]]
    assert any(over > 0 for _, over in prefills)          # tokens dropped
    assert max(t for t, _ in prefills) > 16               # a re-prefill
