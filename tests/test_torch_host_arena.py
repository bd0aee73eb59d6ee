"""The host tier's page-major arena (``device_ops.HostPageArena``) and the
plain version of its kernel (``kernels/host_pages.py``), on the CPU, at a
granite-like geometry (every layer paged, 128-wide heads) and a hymba-like
one (a few paged layers, 64-wide heads): a page round-trips bit-exactly
through one contiguous arena slot holding every layer's K and V rows;
slots are handed out lowest first, reused once freed, and the arena grows
by whole chunks from its first store; the host tier hands dropped and
replaced slots back; an engine allocates no arena before it flushes."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCHS, reduced  # noqa: E402
from repro_torch.core import device_ops as dev  # noqa: E402
from repro_torch.core import spans  # noqa: E402
from repro_torch.core.policies import POLICIES  # noqa: E402
from repro_torch.core.tiers import HostTier  # noqa: E402
from repro_torch.kernels import host_pages as hp  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve import ValetServeEngine  # noqa: E402

# paged layers, page, KV heads, head_dim
GEOMS = {"granite": (4, 16, 8, 128), "hymba": (3, 16, 5, 64)}
N_SLOTS = 32


def make_pools(name, seed=0):
    layers, page, kv, hd = GEOMS[name]
    g = torch.Generator().manual_seed(seed)
    return [torch.randn((N_SLOTS, page, kv, hd), generator=g)
            for _ in range(2 * layers)]


def slot_bytes(pools):
    return len(pools) * pools[0][0].nbytes


@pytest.mark.parametrize("name", GEOMS)
def test_plain_version_gathers_and_scatters_page_major(name):
    pools = make_pools(name)
    slots = [7, 0, 31, 12]
    stage = torch.empty((6, len(pools)) + tuple(pools[0].shape[1:]))
    hp.host_pages(stage, pools, slots, True)
    for i, s in enumerate(slots):
        for r, p in enumerate(pools):
            assert torch.equal(stage[i, r], p[s])
    back = [p.clone() for p in pools]
    dst = [3, 9, 1, 30]
    hp.host_pages(stage, back, dst, False)
    for i, (s, d) in enumerate(zip(slots, dst)):
        for r, p in enumerate(pools):
            assert torch.equal(back[r][d], p[s])
    untouched = sorted(set(range(N_SLOTS)) - set(dst))
    for r, p in enumerate(pools):
        assert torch.equal(back[r][untouched], p[untouched])


@pytest.mark.parametrize("name", GEOMS)
def test_plain_version_refuses_what_the_kernel_does_not_take(name):
    pools = make_pools(name)
    stage = torch.empty((2, len(pools)) + tuple(pools[0].shape[1:]))
    with pytest.raises(ValueError, match="out of range"):
        hp.host_pages(stage, pools, [0, N_SLOTS], True)
    with pytest.raises(ValueError, match="do not fit"):
        hp.host_pages(stage, pools, [0, 1, 2], True)
    with pytest.raises(ValueError, match="differ"):
        hp.host_pages(stage, pools[:-1] + [pools[-1].double()], [0], True)
    with pytest.raises(ValueError, match="stage"):
        hp.host_pages(stage[:, :-1].contiguous(), pools, [0], True)


@pytest.mark.parametrize("name", GEOMS)
def test_round_trip_through_one_contiguous_slot_is_exact(name):
    pools = make_pools(name, seed=1)
    before = [p.clone() for p in pools]
    arena = dev.HostPageArena()
    arena.CHUNK_BYTES = 3 * slot_bytes(pools)
    assert arena.capacity == 0 and not arena.chunks       # nothing before
    slots = [5, 17, 2, 30, 11]
    ids = arena.store(pools, slots)
    assert ids == [0, 1, 2, 3, 4]
    assert (arena.capacity, arena.in_use, arena.peak) == (6, 5, 5)
    assert arena.slot_bytes == slot_bytes(pools)
    for sid, s in zip(ids, slots):
        page = arena.view(sid)
        assert page.is_contiguous() and page.nbytes == arena.slot_bytes
        want = torch.cat([p[s].reshape(-1) for p in pools])
        assert torch.equal(page.reshape(-1), want)
    for p in pools:
        p.zero_()
    dst = [1, 3, 8, 9, 20]
    arena.load(pools, ids, dst)
    assert (arena.in_use, arena.capacity, arena.peak) == (0, 6, 5)
    for d, s in zip(dst, slots):
        for r in range(len(pools)):
            assert torch.equal(pools[r][d], before[r][s])
    others = sorted(set(range(N_SLOTS)) - set(dst))
    assert all(float(p[others].abs().sum()) == 0.0 for p in pools)


@pytest.mark.parametrize("name", GEOMS)
def test_slots_reused_lowest_first_and_growth_by_chunks(name):
    pools = make_pools(name, seed=2)
    arena = dev.HostPageArena()
    arena.CHUNK_BYTES = 4 * slot_bytes(pools)
    spans.take()
    spans.enable()
    try:
        a = arena.store(pools, [0, 1, 2])
        b = arena.store(pools, [3, 4, 5, 6])
        arena.free([a[1], b[1]])
        c = arena.store(pools, [7, 8, 9])
        d = arena.store(pools, list(range(10, 16)))
    finally:
        spans.disable()
    recs = spans.take()
    assert (a, b, c) == ([0, 1, 2], [3, 4, 5, 6], [1, 4, 7])
    assert d == list(range(8, 14))
    assert (arena.capacity, arena.in_use, arena.peak) == (16, 14, 14)
    assert len(arena.chunks) == 4 and arena.chunk_slots == 4
    grows = [r.n for r in recs if r.name == "host_arena.grow"]
    assert grows == [4, 4, 8]
    issued = [r.n for r in recs if r.name == "host_tier.issue"]
    assert issued == [k * arena.slot_bytes for k in (3, 4, 3, 6)]
    # the reused slots hold the newest pages
    for sid, s in zip(c, [7, 8, 9]):
        assert torch.equal(arena.view(sid)[0], pools[0][s])


def test_arena_refuses_pools_of_another_geometry():
    arena = dev.HostPageArena()
    arena.store(make_pools("granite"), [0])
    with pytest.raises(ValueError, match="arena"):
        arena.store(make_pools("hymba"), [0])


def test_host_tier_releases_dropped_and_replaced_blobs():
    got = []
    h = HostTier(release=got.extend)
    for pg in range(4):
        h.put(pg, 10 + pg)
    h.put(2, 99)
    assert got == [12]
    assert h.pop(1) == 11 and got == [12]          # a pop hands it over
    assert h.drop([0, 3, 7]) == 2
    assert got == [12, 10, 13] and len(h) == 1 and h.get(2) == 99
    plain = HostTier()
    plain.put(0, 0)
    plain.put(0, 1)
    assert plain.drop([0]) == 1 and len(plain) == 0


@pytest.mark.parametrize("arch", ["granite-3-8b", "hymba-1.5b"])
@pytest.mark.parametrize("zero", [True, False], ids=["zero", "legacy"])
def test_engine_arena_holds_exactly_the_host_tier(arch, zero):
    """No arena memory at construction; under pressure every host-tier
    page owns one distinct arena slot, freed slots are reused, and nothing
    leaks by the end of the run."""
    cfg = reduced(ARCHS[arch])
    params = T.init_params(cfg, generator=torch.Generator().manual_seed(0),
                           device="cpu")
    eng = ValetServeEngine(params, cfg, T.ParallelCtx(remat=False, q_block=8,
                                                      kv_block=8),
                           max_batch=3, max_seq=64, page=4, pool_slots=12,
                           policy=POLICIES["valet"], zero_restore=zero,
                           device="cpu")
    assert eng.arena.capacity == 0 and not eng.arena.chunks
    stored, store = [], eng.arena.store

    def counted(pools, slots):
        stored.extend(store(pools, slots))
        return stored[-len(slots):]
    eng.arena.store = counted
    rng = np.random.default_rng(0)
    for _ in range(6):
        eng.submit(rng.integers(2, cfg.vocab, size=20), max_new=10)
    while eng.step():
        ids = list(eng.host.blobs.values())
        assert len(set(ids)) == len(ids) == eng.arena.in_use
    assert all(r.status == "done" for r in eng._requests.values())
    assert eng.stats.pauses > 0 and eng.arena.in_use == len(eng.host)
    # lowest first: no id beyond the most ever held at once, so slots that
    # went back were taken again
    assert max(stored) < eng.arena.peak < len(stored)
