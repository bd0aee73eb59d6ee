"""The port's fault, coordinator, cluster and async control plane against
the reference, on seeded traces:

* fault schedules (``standard_schedule`` and seeded ``random_schedule``) on
  a replicated store: equal ``Stats``, injector logs, peer health and repair
  queues, and ``InvariantChecker(store).check()`` passes in both packages;
* a ``ClusterCoordinator`` with a host failure and rejoin, and the rack
  churn ``cluster_schedule`` over seeded peer profiles: equal host records,
  ``ClusterStats`` and per-host coordinator books, and
  ``ClusterInvariantChecker`` passes in both;
* a ``HostMemoryCoordinator`` with three ``TieredPageStore`` tenants under
  skewed demand: equal ``ContainerRecord`` fields and ``CoordinatorStats``;
* ``AsyncOrchestrator``: the simulated-clock mode equal to the reference;
  the threaded mode (not deterministic) held by the invariant checker and
  ``stats_close`` against the synchronous store."""
import numpy as np
import pytest

pytest.importorskip("torch")

from torch_store_parity import (PKGS, assert_same, assert_same_store,  # noqa: E402
                                columns, make_store, zipf_trace)


def populate(store, n_pages):
    for p in range(n_pages):
        store.write(p)
    store.drain()
    return store


def fault_store(pkg, **kw):
    base = dict(pool_capacity=128, min_pool=128, max_pool=128, n_peers=6,
                peer_capacity_blocks=256)
    base.update(kw)
    return make_store(pkg, "valet", **base)


def drive_with_injector(pkg, st, inj, pages, is_write, chunk=100,
                        check_every=4):
    chk = pkg.InvariantChecker(st)
    for i in range(0, len(pages), chunk):
        st.access_batch(pages[i:i + chunk], is_write[i:i + chunk])
        st.background_tick()
        inj.advance(min(chunk, len(pages) - i))
        if (i // chunk) % check_every == 0:
            chk.check()
    st.drain()
    st.repair_quiesce()
    chk.check()
    return chk


def assert_same_faults(a, b):
    assert_same_store(a, b)
    assert_same(columns(a.health), columns(b.health), "health")
    assert_same(columns(a.repairq), columns(b.repairq), "repairq")


# -- fault schedules --------------------------------------------------------------

SCHEDULES = {
    "standard": lambda pkg, n: pkg.standard_schedule(n),
    **{f"random-{s}": (lambda s: lambda pkg, n: pkg.random_schedule(
        n, 6, seed=s, n_events=10))(s) for s in (0, 1, 2)},
}


@pytest.mark.parametrize("async_mode", [False, True], ids=["sync", "async-sim"])
@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
def test_fault_schedule_matches_reference(schedule, async_mode):
    """Blips, crashes, correlated crashes and rejoin storms fired at the same
    ops: the same recovery, repair traffic and health transitions."""
    rng = np.random.default_rng(6)
    n = 5000
    pages = (np.clip(rng.zipf(1.3, n), 1, 500) - 1).astype(np.int64)
    is_write = rng.random(n) < 0.4
    timeout = 1e15 if schedule == "standard" else 2_000.0
    out = {}
    for name, pkg in PKGS.items():
        st = populate(fault_store(pkg, seed=3, async_mode=async_mode,
                                  suspect_timeout_us=timeout), 500)
        inj = pkg.FaultInjector(st, SCHEDULES[schedule](pkg, n))
        chk = drive_with_injector(pkg, st, inj, pages, is_write)
        assert inj.done and chk.n_checks > 3
        out[name] = (st, inj)
    (a, ia), (b, ib) = out["ref"], out["port"]
    assert_same(ia.log, ib.log, "injector log")
    assert_same_faults(a, b)
    if schedule == "standard":
        rec, lost = [r for _, k, _, r in ib.log if k == "crash"][0]
        assert rec > 0 and lost == 0       # replica-covered single crash
        PKGS["port"].InvariantChecker(b).check_replication_restored()
    assert b.stats.repair_pages > 0


# -- cluster ----------------------------------------------------------------------

def cluster_books(cl, stores):
    """Host records, cluster stats, each live host's coordinator records and
    stats, and each store's ``Stats``."""
    hosts = cl.hosts()
    coords = [(h.coordinator.containers(), h.coordinator.stats)
              for h in hosts if h.coordinator is not None]
    return (hosts, cl.stats, coords,
            {hid: [s.stats for s in sts] for hid, sts in stores.items()})


def test_cluster_fail_and_rejoin_matches_reference():
    """Two hosts; one fails and rejoins with a fresh container: the cluster
    comes back conserved and fully replicated in both packages."""
    books = {}
    for name, pkg in PKGS.items():
        cl = pkg.ClusterCoordinator(2048, storm_window=4)
        c0 = cl.register_host(min_slab=96, max_slab=512)
        c1 = cl.register_host(min_slab=96, max_slab=512)
        s0 = populate(fault_store(pkg, min_pool=64, coordinator=c0, seed=0),
                      400)
        populate(fault_store(pkg, min_pool=64, coordinator=c1, seed=1), 400)
        stores = {c0.host_id: [s0], c1.host_id: []}
        cl.fail_host(c1.host_id)
        fresh = cl.rejoin_host(c1.host_id)
        s1b = populate(fault_store(pkg, min_pool=64, coordinator=fresh,
                                   seed=2), 400)
        stores[c1.host_id] = [s1b]
        for st in (s0, s1b):
            st.drain()
            st.repair_quiesce()
        pkg.ClusterInvariantChecker(cl, stores).check_recovery_converged()
        cl.check_invariants()
        assert cl.stats.n_storms == 2
        books[name] = (cluster_books(cl, stores), (s0, s1b))
    assert_same(books["ref"][0], books["port"][0], "cluster")
    for a, b in zip(books["ref"][1], books["port"][1]):
        assert_same_store(a, b)


def test_cluster_schedule_with_peer_profiles_matches_reference():
    """Rack churn from ``cluster_schedule`` over seeded heterogeneous peer
    profiles, against two federated hosts."""
    n = 4000
    books = {}
    for name, pkg in PKGS.items():
        profs = pkg.draw_peer_profiles(6, 2, seed=3)
        domains = [p.domain for p in profs]
        cl = pkg.ClusterCoordinator(4096, storm_window=8)
        stores, injs = {}, []
        for hid in range(2):
            coord = cl.register_host(min_slab=96, max_slab=1024)
            st = populate(fault_store(pkg, pool_capacity=96, max_pool=96,
                                      min_pool=48, seed=20 + hid,
                                      coordinator=coord, peer_profiles=profs,
                                      container_name=f"h{hid}"), 500)
            stores[hid] = [st]
            injs.append(pkg.FaultInjector(st, pkg.cluster_schedule(n, domains)))
        rng = np.random.default_rng(21)
        pages = rng.integers(0, 500, size=n, dtype=np.int64)
        is_write = rng.random(n) < 0.3
        for hid, st in ((h, s[0]) for h, s in stores.items()):
            drive_with_injector(pkg, st, injs[hid], pages, is_write)
        assert all(i.done for i in injs)
        pkg.ClusterInvariantChecker(cl, stores).check_recovery_converged()
        books[name] = (cluster_books(cl, stores), [i.log for i in injs],
                       [s[0] for s in stores.values()])
    ref, port = books["ref"], books["port"]
    assert_same(ref[0], port[0], "cluster")
    assert_same(ref[1], port[1], "injector logs")
    for a, b in zip(ref[2], port[2]):
        assert_same_faults(a, b)


# -- host memory coordinator: three tenants under skew ----------------------------

@pytest.mark.parametrize("weights", [(1.0, 1.0, 1.0), (1.0, 2.0, 4.0)],
                         ids=["equal", "weighted"])
def test_coordinator_three_tenants_skew_matches_reference(weights):
    """Two tenants build a pool and go quiet (one keeps reading), a third
    grows hard: the idle donate, the grower expands, and every container
    record and coordinator counter matches the reference."""
    total = 384
    books = {}
    for name, pkg in PKGS.items():
        coord = pkg.HostMemoryCoordinator(total)
        st = {n: make_store(pkg, "valet", pool_capacity=total, min_pool=32,
                            max_pool=320, n_peers=4, peer_capacity_blocks=256,
                            seed=s, coordinator=coord, container_name=n,
                            weight=w, **({"grow_step": 64} if n == "grower"
                                         else {}))
              for s, (n, w) in enumerate(zip(("busy", "quiet", "grower"),
                                             weights))}
        for n in ("busy", "quiet"):
            st[n].access_batch(np.arange(120), True)
            st[n].background_tick()
            st[n].drain()
            st[n].background_tick()
        for r in range(12):
            st["busy"].access_batch(np.arange(80), False)
            st["grower"].access_batch(np.arange(r * 80, r * 80 + 80) + 5000,
                                      True)
            st["grower"].background_tick()
        coord.check_invariants()
        recs = coord.containers()
        assert coord.stats.pages_reclaimed > 0
        assert all(r.leased == st[r.name].pool.size for r in recs)
        books[name] = (recs, coord.stats, [coord.fair_share(r.cid)
                                           for r in recs], st)
    ref, port = books["ref"], books["port"]
    assert_same(ref[:3], port[:3], "coordinator")
    for n in ref[3]:
        assert_same_store(ref[3][n], port[3][n])


# -- async orchestration ------------------------------------------------------------

ASYNC_EVENTS = {1024: lambda s: s.peer_pressure(0, 4),
                2560: lambda s: s.fail_peer(1),
                3968: lambda s: s.local_pressure(24)}


def drive_checked(pkg, store, pages, is_write, chunk=128, check_every=512,
                  events=None):
    chk = pkg.InvariantChecker(store)
    for i in range(0, len(pages), chunk):
        store.access_batch(pages[i:i + chunk], is_write[i:i + chunk])
        store.background_tick()
        if events and i in events:
            events[i](store)
        if i % check_every == 0:
            chk.check()
    store.drain()
    chk.check()
    return store


def async_store(pkg, **kw):
    return make_store(pkg, "valet", pool_capacity=64, min_pool=64,
                      max_pool=64, peer_capacity_blocks=256, **kw)


@pytest.mark.parametrize("seed", [0, 1])
def test_async_simulated_mode_matches_reference(seed):
    """The simulated-clock daemon is deterministic: epochs, holds, fences
    and daemon time equal the reference's under pressure and a peer
    failure."""
    pages, is_write = zipf_trace(100 + seed, 600, 5000, write_frac=0.5)
    out = {name: drive_checked(pkg, async_store(pkg, seed=seed,
                                                async_mode=True),
                               pages, is_write, events=ASYNC_EVENTS)
           for name, pkg in PKGS.items()}
    a, b = out["ref"], out["port"]
    assert_same_store(a, b)
    assert_same(columns(a.orchestrator), columns(b.orchestrator),
                "orchestrator")
    assert b.orchestrator.n_boundaries > 0 and b.stats.daemon_us > 0


def test_async_threaded_mode_held_by_invariants():
    """The real daemon thread interleaves differently run to run: it is held
    by the invariant checker and by ``stats_close`` against the synchronous
    store of each package, never by equality."""
    from repro_torch import core as P
    pages, is_write = zipf_trace(7, 400, 3000, write_frac=0.5)
    sync = {name: drive_checked(pkg, async_store(pkg), pages, is_write)
            for name, pkg in PKGS.items()}
    assert_same_store(sync["ref"], sync["port"])
    st = async_store(P, async_mode=True, real_thread=True)
    try:
        for i in range(0, len(pages), 128):
            st.access_batch(pages[i:i + 128], is_write[i:i + 128])
            st.background_tick()
        st.drain()
        P.InvariantChecker(st).check()
        assert st.stats.ops == len(pages)
        for ref in sync.values():
            assert P.stats_close(ref.stats, st.stats, rtol=0.35, atol=256), \
                P.stats_delta(ref.stats, st.stats)
    finally:
        st.orchestrator.close()
