"""Multi-tenant serving (§3.4) in the port against the JAX engine:
``ValetServeEngine`` tenants lease KV-pool pages from one
``HostMemoryCoordinator`` over an oversubscribed slab, driven by one
round-robin ``step()`` loop (so their demand overlaps), next to the same
reference engines on their own coordinator in the same loop.  Reduced
granite-3-8b on the CPU in f32, with the reference's params carried into
the port by ``bridge.to_torch``.

Two tenants ("pair") and three ("trio", where an idle tenant donates to
the busy one inside its ``step()``): per tenant the tokens and
``EngineStats`` equal the reference's; every ``ContainerRecord`` field and
the ``CoordinatorStats`` are equal; the coordinator's books close; and
each tenant's tokens equal its run without a coordinator.  The QoS-weights
case (weights 1 and 3) matches too."""
import pytest

torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402
import repro_torch.core as P  # noqa: E402
from repro_torch.serve import ValetServeEngine  # noqa: E402
from torch_parity import (CTX, REF_CTX, RefEngine, assert_same_stats,  # noqa: E402
                          make_setup)
from torch_store_parity import assert_same  # noqa: E402

GEOM = dict(max_batch=2, max_seq=64, page=4, pool_slots=40)
MAX_NEW = 12
MIN_POOL = 4
STEP_CAP = 400
# tenant a is busy (6 requests); the others get 2 each, drain early and
# hold free slots to donate.  With two tenants a grower never asks for more
# than the free slab (the pool caps its growth at half of what the
# coordinator says it could reach), so no page is reclaimed: the pair pins
# that, the trio adds the third tenant that makes reclamation fire.
SCENARIOS = {
    "pair": dict(slab=28, split={"a": slice(0, 6), "b": slice(6, 8)}),
    "trio": dict(slab=36, split={"a": slice(0, 6), "b": slice(6, 8),
                                 "c": slice(8, 10)}),
}
TENANTS = [("pair", 0), ("pair", 1), ("trio", 0), ("trio", 1), ("trio", 2)]


def round_robin(engines, cap=STEP_CAP):
    """Step every engine in turn until each reports nothing left; fails
    past ``cap`` rounds.  Ends as ``run()`` does: the demoted pages still
    pending write-back are flushed."""
    live = list(engines)
    rounds = 0
    while live:
        rounds += 1
        assert rounds <= cap, "round-robin serving did not finish"
        live = [e for e in live if e.step()]
    for e in engines:
        e._flush_demoted(None)
    return rounds


def outputs(eng):
    reqs = sorted(eng._requests.values(), key=lambda r: r.rid)
    assert all(r.status == "done" for r in reqs)
    return [r.tokens_out for r in reqs]


def serve(kind, setup, *, split, slab=None, weights=None, min_pool=MIN_POOL):
    """Build one tenant of ``kind`` ("ref" or "port") per entry of
    ``split``, on one coordinator of ``slab`` pages (none when ``slab`` is
    None), and serve them round-robin; (coordinator, engines)."""
    cfg, params, tcfg, tparams, prompts = setup
    pkg = R if kind == "ref" else P
    coord = pkg.HostMemoryCoordinator(slab) if slab else None
    engines = []
    for i, (name, sl) in enumerate(split.items()):
        kw = dict(GEOM, policy=pkg.POLICIES["valet"])
        if coord is not None:
            kw.update(min_pool=min_pool, coordinator=coord,
                      container_name=f"tenant-{name}",
                      weight=weights[i] if weights else 1.0)
        if kind == "ref":
            eng = RefEngine(params, cfg, REF_CTX, **kw)
        else:
            eng = ValetServeEngine(tparams, tcfg, CTX, device="cpu", **kw)
        for p in prompts[sl]:
            eng.submit(p, max_new=MAX_NEW)
        engines.append(eng)
    round_robin(engines)
    return coord, engines


@pytest.fixture(scope="module")
def setup():
    # one prompt length: the reference engine compiles per length
    return make_setup("granite-3-8b", [16] * 10)


@pytest.fixture(scope="module")
def runs(setup):
    return {(sc, kind): serve(kind, setup, **SCENARIOS[sc])
            for sc in SCENARIOS for kind in ("ref", "port")}


@pytest.mark.parametrize("scenario,tenant", TENANTS)
def test_tokens_match_reference(runs, scenario, tenant):
    assert outputs(runs[scenario, "port"][1][tenant]) == \
        outputs(runs[scenario, "ref"][1][tenant])


@pytest.mark.parametrize("scenario,tenant", TENANTS)
def test_engine_stats_match_reference(runs, scenario, tenant):
    assert_same_stats(runs[scenario, "ref"][1][tenant].stats,
                      runs[scenario, "port"][1][tenant].stats)


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_container_records_and_coordinator_stats_match(runs, scenario):
    (rc, _), (pc, _) = runs[scenario, "ref"], runs[scenario, "port"]
    assert_same(rc.containers(), pc.containers(), "containers")
    assert_same(rc.stats, pc.stats, "coordinator stats")
    assert [rc.fair_share(r.cid) for r in rc.containers()] == \
        [pc.fair_share(r.cid) for r in pc.containers()]


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_coordinator_books_close(runs, scenario):
    coord, engines = runs[scenario, "port"]
    coord.check_invariants()
    for eng, rec in zip(engines, coord.containers()):
        assert rec.leased == eng.pool.size
        assert rec.leased >= MIN_POOL
        assert rec.n_leases > 0
        assert eng.stats.pauses > 0 and eng.stats.repointed_pages > 0
    if scenario == "pair":
        assert coord.stats.n_reclaim_events == 0
    else:
        assert coord.stats.pages_reclaimed > 0, "no tenant donated"
        assert sum(r.pages_donated_total for r in coord.containers()) == \
            coord.stats.pages_reclaimed


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_tokens_equal_uncoordinated_runs(setup, runs, scenario):
    """Leasing, donation and the preemptions they force change no token:
    each tenant served alone, unpressured (its full 40 slots)."""
    _, alone = serve("port", setup, split=SCENARIOS[scenario]["split"])
    for eng, solo in zip(runs[scenario, "port"][1], alone):
        assert solo.stats.pauses == 0
        assert outputs(eng) == outputs(solo)


def test_from_config_with_coordinator_serves(setup, runs):
    """``from_config`` carries coordinator, container name and the pool
    floor; the engines register, lease and serve as the keyword ones."""
    _, _, tcfg, tparams, prompts = setup
    sc = SCENARIOS["trio"]
    coord = P.HostMemoryCoordinator(sc["slab"])
    engines = []
    for name, sl in sc["split"].items():
        c = P.OrchestrationConfig(
            policy=P.POLICIES["valet"], pool_slots=40, min_pool=MIN_POOL,
            max_batch=2, max_seq=64, page=4, coordinator=coord,
            container_name=f"tenant-{name}")
        eng = ValetServeEngine.from_config(tparams, tcfg, CTX, c, device="cpu")
        for p in prompts[sl]:
            eng.submit(p, max_new=MAX_NEW)
        engines.append(eng)
    round_robin(engines)
    ref_coord, ref_engines = runs["trio", "port"]
    assert_same(coord.containers(), ref_coord.containers(), "records")
    for eng, ref in zip(engines, ref_engines):
        assert outputs(eng) == outputs(ref)


# -- QoS weights ------------------------------------------------------------------

WEIGHTED = dict(weights=(1.0, 3.0), slab=96, min_pool=8,
                split={"light": slice(0, 2), "heavy": slice(2, 4)})


@pytest.fixture(scope="module")
def weighted(setup):
    """Two weighted tenants serve, then a hog registers and leases the whole
    slab: the weighted-fair pass sheds the light tenant further."""
    out = {}
    for kind, pkg in (("ref", R), ("port", P)):
        coord, engines = serve(kind, setup, **WEIGHTED)
        before = [r.leased for r in coord.containers()]
        hog = coord.register(min_pages=8, max_pages=96, name="hog")
        hog.lease(96)
        coord.check_invariants()
        out[kind] = (coord, engines, before)
    return out


def test_weighted_records_match_reference(weighted):
    (rc, re_, rb), (pc, pe, pb) = weighted["ref"], weighted["port"]
    assert rb == pb
    assert_same(rc.containers(), pc.containers(), "containers")
    assert_same(rc.stats, pc.stats, "coordinator stats")
    for a, b in zip(re_, pe):
        assert outputs(a) == outputs(b)
        assert_same_stats(a.stats, b.stats)


def test_weighted_fair_shares_follow_weights(weighted):
    for kind in ("ref", "port"):
        coord, engines, before = weighted[kind]
        light, heavy, _ = coord.containers()
        assert engines[0].weight == 1.0 and engines[1].weight == 3.0
        assert coord.fair_share(light.cid) < coord.fair_share(heavy.cid)
        assert light.leased >= 8 and heavy.leased >= 8
        assert light.leased <= heavy.leased
        shed = before[0] - light.leased + before[1] - heavy.leased
        assert shed > 0, "no pages were reclaimed"
        for eng, rec in zip(engines, (light, heavy)):
            assert rec.leased == eng.pool.size
