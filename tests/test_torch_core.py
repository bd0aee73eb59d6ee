"""The port's serving control plane against the reference, op for op.

The same op sequences — those of ``test_core_pool.py`` (drawn from a numpy
seed here instead of hypothesis) and of ``test_zero_restore.py`` (pool
generations, ``claim_batch``, the device-tier lifecycle) — are replayed
through ``repro.core`` and ``repro_torch.core``; state columns, free-stack
order, generations and counters must be equal after every op.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import activity as ref_activity  # noqa: E402
from repro.core import async_engine as ref_async  # noqa: E402
from repro.core import config as ref_config  # noqa: E402
from repro.core import page_table as ref_pt  # noqa: E402
from repro.core import policies as ref_policies  # noqa: E402
from repro.core import pool as ref_pool  # noqa: E402
from repro.core import reservoir as ref_reservoir  # noqa: E402
from repro.core import tiers as ref_tiers  # noqa: E402
from repro_torch.core import activity as t_activity  # noqa: E402
from repro_torch.core import async_engine as t_async  # noqa: E402
from repro_torch.core import config as t_config  # noqa: E402
from repro_torch.core import page_table as t_pt  # noqa: E402
from repro_torch.core import policies as t_policies  # noqa: E402
from repro_torch.core import pool as t_pool  # noqa: E402
from repro_torch.core import reservoir as t_reservoir  # noqa: E402
from repro_torch.core import tiers as t_tiers  # noqa: E402

COUNTERS = ("size", "_used", "n_grow", "n_shrink", "n_alloc_from_pool",
            "n_alloc_failed", "n_reclaimed", "n_claimed")
COLUMNS = ("state", "owner", "last_step", "update_flag", "reclaim_flag", "gen")


def pool_state(p):
    out = {c: getattr(p, c).copy() for c in COLUMNS}
    out.update({c: getattr(p, c) for c in COUNTERS})
    out["free_stack"] = list(p._free)
    out["free_count"] = p.free_count()
    return out


def assert_same_pool(a, b, where=""):
    sa, sb = pool_state(a), pool_state(b)
    for k in sa:
        np.testing.assert_array_equal(np.asarray(sa[k]), np.asarray(sb[k]),
                                      err_msg=f"{k} {where}")


class Twin:
    """Drive a reference and a port object with the same calls."""

    def __init__(self, ref, port):
        self.ref, self.port = ref, port

    def __call__(self, name, *args, **kw):
        a = getattr(self.ref, name)(*args, **kw)
        b = getattr(self.port, name)(*args, **kw)
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            assert a == b, name
        return a


def make_pools(capacity, min_pages, max_pages, free):
    host = {"free": free}
    fn = lambda: host["free"]
    return (Twin(ref_pool.ValetMempool(capacity, min_pages=min_pages,
                                       max_pages=max_pages, free_memory_fn=fn),
                 t_pool.ValetMempool(capacity, min_pages=min_pages,
                                     max_pages=max_pages, free_memory_fn=fn)),
            host)


@pytest.mark.parametrize("seed", range(6))
def test_pool_random_op_sequences_match(seed):
    """alloc / release / reclaim / grow / shrink / shrink_by / pressure /
    batch ops, interleaved: every column and counter stays equal."""
    rng = np.random.default_rng(seed)
    cap = int(rng.integers(32, 129))
    t, host = make_pools(cap, int(rng.integers(8, 25)), cap, cap)
    live, page = [], 0
    ops = ["alloc", "release", "reclaim", "grow", "shrink", "shrink_by",
           "pressure", "alloc_batch", "release_batch"]
    for i in range(int(rng.integers(60, 200))):
        op = ops[int(rng.integers(len(ops)))]
        if op == "alloc":
            s = t("alloc", page, i)
            if s is not None:
                live.append(s)
                page += 1
        elif op == "release" and live:
            t("release", live.pop(int(rng.integers(len(live)))))
        elif op == "reclaim" and live:
            s = live.pop()
            t("mark_reclaimable", s)
            if t.ref.slots[s].state == ref_pool.SlotState.RECLAIMABLE:
                t("reclaim", s)
        elif op == "grow":
            t("maybe_grow")
        elif op == "shrink":
            t("shrink_for_pressure")
        elif op == "shrink_by":
            t("shrink_by", int(rng.integers(1, 48)))
        elif op == "pressure":
            host["free"] = int(rng.integers(0, cap))
            t("shrink_for_pressure")
            host["free"] = cap
        elif op == "alloc_batch":
            n = int(rng.integers(1, 6))
            pgs = list(range(page, page + n))
            slots = t("alloc_batch", pgs, [i] * n)
            if slots is not None:
                live.extend(slots)
                page += n
        elif op == "release_batch" and live:
            k = int(rng.integers(1, len(live) + 1))
            t("release_batch", live[-k:])
            del live[-k:]
        assert_same_pool(t.ref, t.port, f"after op {i} ({op})")
        t.port.check_invariants()


def test_pool_free_gen_and_claim_batch_match():
    """The ``test_zero_restore.py`` generation / claim sequence."""
    t = Twin(ref_pool.ValetMempool(8, min_pages=8, max_pages=8),
             t_pool.ValetMempool(8, min_pages=8, max_pages=8))
    s0 = t("alloc", 100, 0)
    s1 = t("alloc", 101, 0)
    assert t("free_gen", s0) is None
    t("release_batch", [s0, s1])
    t("free_gen", s0)
    t("free_gen", 10_000)
    s2 = t("alloc", 102, 1)
    assert s2 in (s0, s1)
    t("release_batch", [s2])
    t("claim_batch", [s1], [101], 2)
    assert_same_pool(t.ref, t.port)
    assert t.port.n_claimed == 1


def test_device_and_host_tier_lifecycle_match():
    gens = {3: 7, 4: 1}
    t = Twin(ref_tiers.DeviceTier(), t_tiers.DeviceTier())
    t("demote", [10, 11], [3, 4], [7, 1])
    assert t("claim", 10, lambda s: gens.get(s)) == 3
    gens[4] = 2
    assert t("claim", 11, lambda s: gens.get(s)) is None
    t("demote", [12, 13, 14], [5, 6, 7], [9, 1, 2])
    t("split", [12, 13, 99], lambda s: {5: 9, 6: 0}.get(s))
    t("demote", [15], [8], [4])
    assert t("evict_slots", [8]) == [(15, 8)]
    t("drop", [14])
    for attr in ("repoints", "evictions"):
        assert getattr(t.ref, attr) == getattr(t.port, attr)
    assert dict(t.ref.shadow) == dict(t.port.shadow)
    h = Twin(ref_tiers.HostTier(), t_tiers.HostTier())
    for pg in range(5):
        h("put", pg, {"blob": pg})
    h("pop", 2)
    h("drop", [0, 4, 7])
    assert len(h.ref) == len(h.port) and sorted(h.ref.blobs) == \
        sorted(h.port.blobs)


@pytest.mark.parametrize("seed", range(3))
def test_page_table_and_activity_match(seed):
    rng = np.random.default_rng(seed)
    g = Twin(ref_pt.GlobalPageTable(initial_pages=8),
             t_pt.GlobalPageTable(initial_pages=8))
    a = Twin(ref_activity.ActivityTracker(), t_activity.ActivityTracker())
    pages = np.arange(40, dtype=np.int64)
    g("map_local_batch", pages[:20], rng.permutation(64)[:20].astype(np.int64))
    g("unmap_local_batch", pages[5:10])
    m = 5
    g("map_remote_batch", pages[5:10], [int(ref_pt.Tier.DEVICE)] * m,
      [-1] * m, list(range(m)), None)
    g("map_remote_batch", pages[30:35], [int(ref_pt.Tier.HOST)] * m,
      [-1] * m, [-1] * m, None)
    g("drop_remote_batch", pages[30:32])
    g("local_slots_batch", pages)
    for p in range(40):
        assert g.ref.local_slot(p) == g.port.local_slot(p)
    for step in range(10):
        blocks = rng.integers(0, 50, size=6).tolist()
        a("on_write", blocks, step)
    a("nad", list(range(50)), 12)
    cands = list(range(30))
    assert ref_activity.select_victims_nad(a.ref, cands, 5, 12) == \
        t_activity.select_victims_nad(a.port, cands, 5, 12)


def test_policies_config_clock_and_reservoir_match():
    for costs in ("PAPER_COSTS", "TPU_COSTS"):
        assert dataclasses.asdict(getattr(ref_policies, costs)) == \
            dataclasses.asdict(getattr(t_policies, costs))
    for name, pol in ref_policies.POLICIES.items():
        assert dataclasses.asdict(pol) == \
            dataclasses.asdict(t_policies.POLICIES[name])
    rc, tc = ref_config.OrchestrationConfig(), t_config.OrchestrationConfig()
    assert dataclasses.asdict(rc) == dataclasses.asdict(tc)
    assert ref_config.LEGACY_SERVE_KWARGS == t_config.LEGACY_SERVE_KWARGS
    c = Twin(ref_async.DaemonClock(), t_async.DaemonClock())
    for cost, now in ((5.0, 0.0), (3.0, 2.0), (1.0, 20.0)):
        c("charge", cost, now)
        c("wait_for", now + 1.0)
    r = Twin(ref_reservoir.LatencyReservoir(), t_reservoir.LatencyReservoir())
    for x in np.random.default_rng(0).exponential(10.0, size=5000):
        r("record", float(x))
    assert r("summary") == r.port.summary()
