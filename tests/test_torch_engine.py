"""The port's serving engine against the JAX engine (reduced granite-3-8b,
CPU, f32): the same tokens and the same ``EngineStats`` under pool pressure
for valet and os-swap (the other policies are in ``test_torch_engine_*.py``),
and bit-exact KV round trips through preemption in both restore modes."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.policies import POLICIES  # noqa: E402
from repro_torch.serve import ValetServeEngine  # noqa: E402
from torch_parity import (CTX, assert_same_engines, both, make_setup,  # noqa: E402
                          run)

POLICY_NAMES = ["valet", "os-swap"]


@pytest.fixture(scope="module")
def setup():
    return make_setup("granite-3-8b", [8] * 6)


@pytest.fixture(scope="module")
def pressured(setup):
    return {p: both(setup, p, 10) for p in POLICY_NAMES}


@pytest.mark.parametrize("policy", POLICY_NAMES)
def test_tokens_match_reference_under_pressure(pressured, policy):
    (ref_outs, _), (outs, eng) = pressured[policy]
    assert outs == ref_outs, f"{policy} diverged from the JAX engine"
    assert eng.stats.pauses > 0
    assert (eng.stats.repointed_pages > 0) == (policy == "valet")


@pytest.mark.parametrize("policy", POLICY_NAMES)
def test_engine_stats_match_reference(pressured, policy):
    (_, ref_eng), (_, eng) = pressured[policy]
    assert_same_engines(ref_eng, eng)


def test_unconstrained_pool_matches_pressured_tokens(setup, pressured):
    cfg, params, tcfg, tparams, prompts = setup
    outs, eng = run(ValetServeEngine, tparams, tcfg, CTX, prompts, POLICIES,
                    "valet", 64)
    assert eng.stats.pauses == 0 and eng.stats.spilled_pages == 0
    for policy in POLICY_NAMES:
        assert pressured[policy][1][0] == outs


@pytest.mark.parametrize("mode", ["zero", "legacy"])
def test_preempt_restore_roundtrips_kv_exactly(setup, mode):
    """Preempt then restore returns every KV page bit-identically: legacy
    spills to pinned host blobs and back, zero-restore demotes in place and
    comes back as a pure block-table repoint."""
    _, _, tcfg, tparams, prompts = setup
    eng = ValetServeEngine(tparams, tcfg, CTX, max_batch=2, max_seq=64,
                           page=4, pool_slots=32, policy=POLICIES["valet"],
                           zero_restore=(mode == "zero"), device="cpu")
    rid = eng.submit(prompts[0], max_new=8)
    req = eng._requests[rid]
    assert eng._admit(req) and req.status == "active" and req.pages
    slots = {pg: eng.gpt.local_slot(pg) for pg in req.pages}
    before = {li: {pg: (eng.caches["layers"][li]["pool"].k[s].clone(),
                        eng.caches["layers"][li]["pool"].v[s].clone())
                   for pg, s in slots.items()} for li in eng.paged_layers}

    eng._preempt(req)
    assert req.status == "paused"
    assert eng.stats.spilled_pages == len(req.pages)
    for pg in req.pages:
        assert eng.gpt.local_slot(pg) is None
        assert (pg in eng.device) == (mode == "zero")
        assert (pg in eng.host) == (mode == "legacy")
    if mode == "zero":
        assert eng._flush_demoted(None) == len(req.pages)
        assert all(pg in eng.device and pg in eng.host for pg in req.pages)
    assert eng._resume(req) and req.status == "active"
    for li in eng.paged_layers:
        pool = eng.caches["layers"][li]["pool"]
        for pg in req.pages:
            s = eng.gpt.local_slot(pg)
            assert torch.equal(pool.k[s], before[li][pg][0])
            assert torch.equal(pool.v[s], before[li][pg][1])
    assert all(pg not in eng.host for pg in req.pages)
    assert eng.stats.restored_pages == eng.stats.spilled_pages
    if mode == "zero":
        assert eng.stats.repointed_pages == len(req.pages)
        assert eng.stats.streamed_pages == 0
        assert all(eng.gpt.local_slot(pg) == s for pg, s in slots.items())


def test_coordinator_registers_and_leases(setup):
    """With a coordinator the engine registers its pool floor, leases its
    pool through it and offers its FREE slots as a donor (the multi-tenant
    runs are in ``test_torch_engine_coordinator.py``)."""
    from repro_torch.core import HostMemoryCoordinator
    _, _, tcfg, tparams, _ = setup
    coord = HostMemoryCoordinator(24)
    eng = ValetServeEngine(tparams, tcfg, CTX, max_batch=2, max_seq=16,
                           pool_slots=16, min_pool=4, coordinator=coord,
                           container_name="solo", weight=2.0, device="cpu")
    (rec,) = coord.containers()
    assert (rec.name, rec.min_pages, rec.max_pages, rec.weight) == \
        ("solo", 4, 16, 2.0)
    assert rec.leased == eng.pool.size == 4
    assert eng.pool.ensure_free(6) and rec.leased == eng.pool.size > 4
    assert eng._host_donate(100) > 0 and rec.leased == eng.pool.size == 4
    coord.check_invariants()
