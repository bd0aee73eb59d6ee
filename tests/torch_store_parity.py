"""Shared helpers of the trace-store parity tests (``test_torch_tiering.py``,
``test_torch_faults_cluster.py``, ``test_torch_engine_coordinator.py``):
build the same store in the JAX package's numpy control plane and in the
port's copy, drive both with one trace, and compare what they hold.

The reference side is ``repro.core``'s numpy control plane; importing the
package also imports jax (for ``device_ops``), which the CPU suite has."""
import dataclasses
import enum
from collections import deque

import numpy as np

import repro.core as R
import repro_torch.core as P

PKGS = {"ref": R, "port": P}

# callbacks and back-references: compared through the objects they point at
SKIP_FIELDS = ("donate_cb", "size_fn", "peer_footprint_fn", "peer_pressure_cb",
               "coordinator", "free_memory_fn", "data_plane")


def make_store(pkg, policy="valet", **kw):
    """``TieredPageStore.from_config`` of ``pkg``, with ``pkg``'s own policy
    and cost profile; ``kw`` overrides the config's fields."""
    base = dict(costs=pkg.PAPER_COSTS, pool_capacity=128, min_pool=128,
                max_pool=128, n_peers=4, peer_capacity_blocks=64,
                pages_per_block=16, seed=0)
    base.update(kw)
    return pkg.TieredPageStore.from_config(
        pkg.OrchestrationConfig(policy=pkg.POLICIES[policy], **base))


def zipf_trace(seed, n_pages, n_ops, write_frac=0.4):
    rng = np.random.default_rng(seed)
    pages = np.clip(rng.zipf(1.3, n_ops), 1, n_pages) - 1
    return pages.astype(np.int64), rng.random(n_ops) < write_frac


def drive_scalar(store, pages, is_write, tick_every=32, events=None):
    """``write``/``read`` per op, ``background_tick`` every ``tick_every``
    ops, ``events[i](store)`` after op ``i``; the per-op latencies."""
    lats = []
    for i in range(len(pages)):
        if is_write[i]:
            lats.append(store.write(int(pages[i])))
        else:
            lats.append(store.read(int(pages[i])))
        if i % tick_every == 0:
            store.background_tick()
        if events and i in events:
            events[i](store)
    return np.asarray(lats)


def drive_batched(store, pages, is_write, tick_every=32, batch=200,
                  events=None):
    """``access_batch`` in chunks that end at the scalar driver's tick and
    event boundaries (so both drivers see the same op/tick/event order)."""
    n = len(pages)
    lats = np.empty(n, np.float64)
    ev = sorted(events) if events else []
    i = 0
    while i < n:
        nxt_tick = i if i % tick_every == 0 \
            else (i // tick_every + 1) * tick_every
        nxt_ev = min([e for e in ev if e >= i], default=n)
        end = min(n, i + batch, nxt_tick + 1, nxt_ev + 1)
        lats[i:end] = store.access_batch(pages[i:end], is_write[i:end])
        if (end - 1) % tick_every == 0:
            store.background_tick()
        if events and (end - 1) in events:
            events[end - 1](store)
        i = end
    return lats


def assert_same(a, b, path="value"):
    """Deep equality across the two packages: dataclasses field by field
    (latency reservoirs sample for sample), enums by class and member name,
    numpy arrays by dtype and value, containers element by element."""
    if isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), path
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert np.array_equal(a, b), path
    elif isinstance(a, enum.Enum):
        assert type(a).__name__ == type(b).__name__ and a.name == b.name, path
    elif hasattr(a, "_buf") and hasattr(a, "_seen"):        # LatencyReservoir
        np.testing.assert_array_equal(a._buf[:a._n], b._buf[:b._n], path)
        assert a._seen == b._seen, path
    elif dataclasses.is_dataclass(a) and not isinstance(a, type):
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(a):
            if f.name in SKIP_FIELDS:
                continue
            assert_same(getattr(a, f.name), getattr(b, f.name),
                        f"{path}.{f.name}")
    elif isinstance(a, dict):
        assert list(a.keys()) == list(b.keys()), path
        for k in a:
            assert_same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple, deque)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    else:
        assert a == b, f"{path}: {a!r} != {b!r}"


def columns(obj):
    """The plain state of ``obj``: its arrays, numbers, flags and plain
    containers (callbacks, generators and sub-objects left out)."""
    plain = (np.ndarray, int, float, bool, str, type(None), list, dict, tuple,
             set, deque, np.integer, np.floating, np.bool_)
    out = {k: v for k, v in vars(obj).items()
           if isinstance(v, plain) and not callable(v)}
    if hasattr(obj, "_cols"):
        # a row queue: only the live window [head, tail) holds data (the
        # rest is never-written or consumed storage)
        for name in obj._cols + obj._flags:
            out[name] = out[name][obj._head:obj._tail]
    if "_free_arr" in out:
        # the pool's free stack: entries above its top are stale storage
        out["_free_arr"] = out["_free_arr"][:obj._free_top]
    return out


def migration_log(store):
    """Every finished migration in order: block, pages, peers, the final
    ``Phase`` and the protocol's message log."""
    out = []
    for m in store.migrator.completed + store.migrator.aborted:
        out.append((m.block, list(m.pages), m.src_peer, m.dst_peer, m.dst_slot,
                    m.phase.name,
                    [(x.src, x.dst, x.kind, x.payload) for x in m.log]))
    return out


def assert_same_store(a, b):
    """Stats (with ``==`` per field; the reservoirs by their samples), the
    page table, pool and tracker columns, the write pipeline's queues,
    blocks, peers, host spills and the migration log."""
    assert_same(a.stats, b.stats, "stats")
    assert a.step == b.step
    for name in ("gpt", "pool", "tracker", "pipeline"):
        assert_same(columns(getattr(a, name)), columns(getattr(b, name)), name)
    for name in ("staging", "reclaimable"):
        assert_same(columns(getattr(a.pipeline, name)),
                    columns(getattr(b.pipeline, name)), f"pipeline.{name}")
    assert_same(a.blocks, b.blocks, "blocks")
    assert_same([columns(p) for p in a.peers], [columns(p) for p in b.peers],
                "peers")
    assert_same(a.host_pages, b.host_pages, "host_pages")
    assert_same(migration_log(a), migration_log(b), "migrations")
    a.pipeline.check_invariants()
    b.pipeline.check_invariants()
