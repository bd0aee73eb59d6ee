"""The port's serving engine against the JAX engine on the SSM archs
(reduced mamba2-2.7b: SSD state only, no paged layer; reduced hymba-1.5b:
paged global layers, sliding-window rings and SSD state together), CPU,
f32: the same tokens and the same ``EngineStats`` under pool pressure for
all four policies, pressured tokens equal to an unpressured run, and the
SSM state carried bit-exactly through a preemption."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.policies import POLICIES  # noqa: E402
from repro_torch.serve import ValetServeEngine  # noqa: E402
from torch_parity import (CTX, assert_same_engines, both, make_setup,  # noqa: E402
                          run)

ARCH_NAMES = ["mamba2-2.7b", "hymba-1.5b"]
POLICY_NAMES = ["valet", "valet-mass", "infiniswap", "os-swap"]
PROMPT_LENS = [5, 8, 11, 5, 8, 11]


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
def test_preempt_resume_roundtrips_ssm_state_exactly(setups, name):
    """A paused sequence's SSD state and conv ring leave through the host
    tier and come back bit-identically into another batch slot."""
    _, _, tcfg, tparams, prompts = setups[name]
    eng = ValetServeEngine(tparams, tcfg, CTX, max_batch=2, max_seq=64,
                           page=4, pool_slots=32, policy=POLICIES["valet"],
                           device="cpu")
    rids = [eng.submit(p, max_new=8) for p in prompts[:2]]
    reqs = [eng._requests[r] for r in rids]
    assert all(eng._admit(r) for r in reqs)
    req = reqs[1]
    ssm_layers = [li for li, c in enumerate(eng.batch.caches["layers"])
                  if "ssm" in c]
    assert len(ssm_layers) == len(eng.batch.infos)
    before = {li: {k: eng.batch.caches["layers"][li]["ssm"][k][req.slot].clone()
                   for k in ("h", "conv")} for li in ssm_layers}
    assert any(b["h"].abs().sum() > 0 for b in before.values())
    old_slot = req.slot
    eng._preempt(req)
    assert req.status == "paused" and req.rid in eng._seq_blobs
    eng._free_pages(reqs[0])          # the first sequence leaves its slot
    eng._slots_free.append(reqs[0].slot)
    reqs[0].slot = -1
    eng._slots_free.remove(old_slot)   # so the resume lands in another slot
    assert eng._resume(req) and req.slot != old_slot
    for li in ssm_layers:
        for k in ("h", "conv"):
            assert torch.equal(eng.batch.caches["layers"][li]["ssm"][k][req.slot],
                               before[li][k])
