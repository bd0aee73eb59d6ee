"""The port's trace-driven control plane against the reference: the same
seeded traces through ``repro.core.TieredPageStore`` and
``repro_torch.core.TieredPageStore`` (both built by ``from_config``) leave
equal ``Stats`` (``==`` per field, the latency reservoirs sample for
sample), per-op latencies, page-table / pool / tracker / write-pipeline
columns and migration logs — for every policy, through the scalar
``write``/``read`` driver and the batched ``access_batch`` driver, on a
pool tight enough to force reclaim and migration.  The trace generators of
``repro_torch.data`` are held to the reference's bit for bit."""
import numpy as np
import pytest

pytest.importorskip("torch")

import repro.data as RD  # noqa: E402
import repro.data.workloads as RW  # noqa: E402
import repro_torch.data as PD  # noqa: E402
import repro_torch.data.workloads as PW  # noqa: E402
from torch_store_parity import (PKGS, assert_same, assert_same_store,  # noqa: E402
                                drive_batched, drive_scalar, make_store,
                                migration_log, zipf_trace)

ALL_POLICIES = ("valet", "valet-mass", "infiniswap", "nbdx", "os-swap")
DRIVERS = {"scalar": drive_scalar, "batched": drive_batched}
DATA = {"ref": (RD, RW), "port": (PD, PW)}

# peer pressure (migrate or delete victims), then local pool pressure
EVENTS = {1000: lambda s: s.peer_pressure(0, 4),
          2000: lambda s: s.local_pressure(16)}


def run_both(build, pages, is_write, driver, events=EVENTS):
    """Drive a store of each package with the same trace; the two stores
    and their per-op latencies."""
    out = {}
    for name, pkg in PKGS.items():
        st = build(pkg)
        out[name] = (st, DRIVERS[driver](st, pages, is_write, events=events))
    (a, la), (b, lb) = out["ref"], out["port"]
    assert_same_store(a, b)
    np.testing.assert_array_equal(la, lb)
    return a, b


# -- trace generators -----------------------------------------------------------

GENERATORS = {
    "etc": lambda d, w: list(d.generate_trace(d.ETC(300, 2000, seed=3))),
    "sys": lambda d, w: list(d.generate_trace(d.SYS(300, 2000, seed=4))),
    **{f"ycsb-{x}": (lambda x: lambda d, w: d.ycsb_trace(
        d.YCSBConfig(x, n_pages=512, n_ops=3000, seed=5)))(x)
       for x in "ABCD"},
    "ml": lambda d, w: d.ml_trace(d.MLTraceConfig(total_pages=256, n_steps=2,
                                                  seed=6)),
    "ml-mamba2": lambda d, w: d.ml_trace(d.MLTraceConfig(
        arch="mamba2-2.7b", total_pages=300, n_steps=1, seed=7)),
    "mixed": lambda d, w: (
        d.mixed_tenant_traces(d.MixedTenantConfig()),
        d.interleave_tenants([700, 1300, 250], 64),
        d.tenant_lifetimes(d.MixedTenantConfig())),
    "phases": lambda d, w: w.phase_segments(
        d.ycsb_trace(d.YCSBConfig("B", n_pages=256, n_ops=2000, seed=8))),
    "train": lambda d, w: (
        [next(it) for it in [d.TrainDataset(d.DataConfig(97, 32, 4, seed=2))]
         for _ in range(3)],
        next(d.TrainDataset(d.DataConfig(97, 32, 4, seed=2),
                            start_step=5).reshard(1, 2)),
        d.batch_for_step(d.DataConfig(97, 32, 4, seed=2), 7, 0, 2)),
}


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_trace_generators_match_reference(name):
    got = {k: GENERATORS[name](*mods) for k, mods in DATA.items()}
    assert_same(got["ref"], got["port"], name)


# -- every policy, both drivers, tight pool --------------------------------------

@pytest.mark.parametrize("driver", sorted(DRIVERS))
@pytest.mark.parametrize("policy", ALL_POLICIES)
def test_store_matches_reference_under_pressure(policy, driver):
    pages, is_write = zipf_trace(0, 400, 3000)
    a, b = run_both(lambda pkg: make_store(pkg, policy, pool_capacity=32,
                                           min_pool=32, max_pool=32),
                    pages, is_write, driver)
    assert b.stats.ops == len(pages)
    if policy in ("valet", "valet-mass"):
        # the pool ran dry (reclaim) and peer pressure migrated blocks
        assert b.pool.n_reclaimed > 0
        assert b.stats.migrations > 0 and migration_log(b)
    elif policy in ("infiniswap", "nbdx"):
        assert b.stats.evictions > 0


def _workload(name):
    d, _ = DATA["ref"]
    if name == "etc":
        ops = list(d.generate_trace(d.ETC(600, 3000, seed=11)))
        return (np.asarray([p for _, p in ops], np.int64),
                np.asarray([k == "write" for k, _ in ops]))
    if name == "ml":
        t = d.ml_trace(d.MLTraceConfig(total_pages=400, n_steps=2, seed=12))
    else:
        t = d.ycsb_trace(d.YCSBConfig(name[-1], n_pages=600, n_ops=3000,
                                      seed=13))
    return t.pages, t.is_write


@pytest.mark.parametrize("driver", sorted(DRIVERS))
@pytest.mark.parametrize("trace,policy", [("etc", "valet"),
                                          ("ycsb-A", "valet-mass"),
                                          ("ycsb-D", "infiniswap"),
                                          ("ml", "valet")])
def test_store_matches_reference_on_workload_traces(trace, policy, driver):
    """The generators' traces (ETC, YCSB, the ML sweep) on a 64-page pool."""
    pages, is_write = _workload(trace)
    n = len(pages)
    events = {n // 3: lambda s: s.peer_pressure(1, 4),
              2 * n // 3: lambda s: s.local_pressure(24)}
    _, b = run_both(lambda pkg: make_store(pkg, policy, pool_capacity=64,
                                           min_pool=64, max_pool=64),
                    pages, is_write, driver, events)
    if policy == "infiniswap":
        assert b.stats.evictions > 0
    else:
        assert b.pool.n_reclaimed > 0


@pytest.mark.parametrize("policy", ["valet", "valet-mass"])
def test_scalar_reclaim_migration_protocol_matches(policy):
    """``batch_reclaim=False``: the scalar migration engine with its full
    protocol message log (ALLOC_REQ ... FREE_BLOCK), phase by phase."""
    pages, is_write = zipf_trace(1, 500, 3000)
    events = {800: lambda s: s.peer_pressure(0, 6),
              1600: lambda s: s.peer_pressure(2, 6),
              2400: lambda s: s.local_pressure(16)}
    _, b = run_both(lambda pkg: make_store(pkg, policy, pool_capacity=32,
                                           min_pool=32, max_pool=32,
                                           batch_reclaim=False),
                    pages, is_write, "scalar", events)
    log = migration_log(b)
    assert log and all(m[5] == "DONE" for m in log)
    kinds = [k for m in log for _, _, k, _ in m[6]]
    assert {"ALLOC_REQ", "COPY_REQ", "FREE_BLOCK"} <= set(kinds)


@pytest.mark.parametrize("driver", sorted(DRIVERS))
def test_dynamic_pool_with_device_tier_matches(driver):
    """A pool that grows and shrinks (min 16, max 128) with the device tier
    on: repoints of reclaimed-but-untouched slots, same in both."""
    pages, is_write = zipf_trace(2, 600, 4000, write_frac=0.5)
    _, b = run_both(lambda pkg: make_store(pkg, "valet", pool_capacity=128,
                                           min_pool=16, max_pool=128,
                                           grow_step=16, device_tier=True),
                    pages, is_write, driver)
    assert b.pool.n_grow > 0
    assert b.stats.device_hits > 0

