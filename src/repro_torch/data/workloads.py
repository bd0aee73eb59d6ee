"""Trace-driven workload suite: the paper's evaluation matrix, replayable.

The paper's headline numbers (226x over OS swap, up to 5.5x over remote
paging) were measured on NoSQL (Memcached/Redis/VoltDB-style) and ML
workloads; the synthetic uniform/zipfian traces in ``pipeline.py`` only
approximate their *mix ratios*.  This module closes the fidelity gap with
three seeded, fully deterministic workload classes (ROADMAP item 5):

* **YCSB-style key-value mixes** (``ycsb_trace``): workloads A (update
  heavy, 50/50), B (read mostly, 95/5), C (read only) and D (latest-skewed
  reads over a growing keyspace) over a zipfian keyspace, with *hotset
  rotation*: the trace is divided into phases and the zipf head is remapped
  to a different page region at every phase boundary, so a cache sized for
  one phase's hot set pays re-warming costs at each rotation — the
  Memcached/Redis steady-state-plus-churn shape the paper measures.

* **ML-training working-set trace** (``ml_trace``): layer activations
  cycling through the pool — a forward sweep *writes* each layer's
  activation pages in order, the backward sweep *reads* them in reverse
  (and frees them by overwrite on the next step).  Per-layer footprints are
  sized off the real ``repro_torch.configs`` model zoo (relative layer widths
  from ``ArchConfig``, sequence/batch from the ``ShapeConfig`` shapes used
  by the ``train/`` stack), proportionally scaled to a bounded page budget
  so the simulator stays fast.

* **Mixed-tenant combinations** (``mixed_tenant_traces`` +
  ``interleave_tenants``): K tenants — any mix of YCSB and ML classes —
  each with its own page-id space, round-robin time-sliced so their demand
  overlaps in time on one shared host slab (driven through
  ``HostMemoryCoordinator`` by ``benchmarks/workloads.py``).

Everything is a pure function of its config (numpy ``default_rng`` seeded
per trace), so two runs produce bitwise-identical traces — required, since
the workload benchmarks gate CI on deterministic simulated-us metrics.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np

__all__ = [
    "WorkloadTrace", "YCSBConfig", "MLTraceConfig", "MixedTenantConfig",
    "YCSB_MIXES", "ycsb_trace", "ml_trace", "mixed_tenant_traces",
    "interleave_tenants", "phase_segments",
]


@dataclass(eq=False)
class WorkloadTrace:
    """A replayable page-access trace plus its provenance metadata.

    ``pages``/``is_write`` are parallel arrays ready for
    ``TieredPageStore.access_batch``; ``n_pages`` is the page-id space (for
    pool sizing and pre-population); ``phase_bounds`` marks the op indices
    where a new phase begins (hotset rotation for YCSB, sweep boundaries
    for ML) — index 0 is always implied, not listed.
    """
    name: str
    pages: np.ndarray
    is_write: np.ndarray
    n_pages: int
    phase_bounds: Tuple[int, ...] = ()

    def __post_init__(self):
        self.pages = np.ascontiguousarray(self.pages, np.int64)
        self.is_write = np.ascontiguousarray(self.is_write, bool)
        assert len(self.pages) == len(self.is_write)

    def __len__(self) -> int:
        return len(self.pages)

    def read_fraction(self) -> float:
        n = max(len(self), 1)
        return float((~self.is_write).sum()) / n


# --------------------------------------------------------------------------
# YCSB-style key-value mixes
# --------------------------------------------------------------------------

# read fraction per YCSB core workload; the write op is an update-in-place
# for A/B (C is read-only) and an *insert* (new key) for D, whose reads are
# latest-skewed instead of rotation-phased.
YCSB_MIXES = {
    "A": {"read": 0.50, "update": 0.50},
    "B": {"read": 0.95, "update": 0.05},
    "C": {"read": 1.00, "update": 0.00},
    "D": {"read": 0.95, "insert": 0.05},
}


@dataclass(frozen=True)
class YCSBConfig:
    """One YCSB-style trace: mix letter + keyspace + rotation schedule."""
    workload: str = "B"            # "A" | "B" | "C" | "D"
    n_pages: int = 2048            # keyspace (one page per key)
    n_ops: int = 24_000
    zipf_a: float = 1.2            # key-popularity skew
    n_phases: int = 4              # hotset rotations (A/B/C; D drifts)
    seed: int = 0

    def __post_init__(self):
        if self.workload not in YCSB_MIXES:
            raise ValueError(f"unknown YCSB workload {self.workload!r}; "
                             f"available: {sorted(YCSB_MIXES)}")


def _zipf_ranks(rng, a: float, n_ops: int, n_keys: int) -> np.ndarray:
    """Zipf ranks in [0, n_keys) — rank 0 is the hottest key."""
    return np.clip(rng.zipf(a, n_ops), 1, n_keys) - 1


def ycsb_trace(cfg: YCSBConfig) -> WorkloadTrace:
    """Deterministic YCSB-style trace per ``cfg`` (see module docstring)."""
    if cfg.workload == "D":
        return _ycsb_latest(cfg)
    rng = np.random.default_rng(cfg.seed)
    mix = YCSB_MIXES[cfg.workload]
    ranks = _zipf_ranks(rng, cfg.zipf_a, cfg.n_ops, cfg.n_pages)
    is_write = rng.random(cfg.n_ops) >= mix["read"]
    # one shared rank->page permutation spreads hot keys across the id
    # space; each phase then rotates the mapping by a fixed offset so the
    # zipf head lands on a disjoint page region (the hot set *moves*, the
    # popularity law does not)
    perm = rng.permutation(cfg.n_pages).astype(np.int64)
    n_phases = max(cfg.n_phases, 1)
    bounds = [cfg.n_ops * p // n_phases for p in range(1, n_phases)]
    phase_of = np.searchsorted(np.asarray(bounds), np.arange(cfg.n_ops),
                               side="right")
    rot = cfg.n_pages // n_phases
    pages = perm[(ranks + phase_of * rot) % cfg.n_pages]
    return WorkloadTrace(f"ycsb_{cfg.workload.lower()}", pages, is_write,
                         cfg.n_pages, tuple(bounds))


def _ycsb_latest(cfg: YCSBConfig) -> WorkloadTrace:
    """Workload D: inserts append fresh keys, reads skew to the latest.

    The live keyspace starts at ``n_pages // 2`` keys and grows with each
    insert; read popularity is zipfian over *recency* (rank 0 = the newest
    key), so the hot set drifts forward continuously — the rotation is
    built into the workload instead of scheduled.  Key ids wrap at
    ``n_pages`` (the oldest, coldest keys are overwritten), keeping the
    page-id space bounded for the simulator.
    """
    rng = np.random.default_rng(cfg.seed)
    ins_frac = YCSB_MIXES["D"]["insert"]
    n_init = cfg.n_pages // 2
    is_ins = rng.random(cfg.n_ops) < ins_frac
    cum = np.cumsum(is_ins)                      # inserts up to and incl. op
    newest = n_init - 1 + cum                    # newest key id after op i
    prev_newest = newest - is_ins                # newest existing before op
    ranks = _zipf_ranks(rng, cfg.zipf_a, cfg.n_ops, cfg.n_pages)
    live = np.minimum(prev_newest + 1, cfg.n_pages)
    pages = np.where(is_ins, newest,
                     prev_newest - ranks % live) % cfg.n_pages
    return WorkloadTrace("ycsb_d", pages, is_ins, cfg.n_pages)


# --------------------------------------------------------------------------
# ML-training working-set trace
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class MLTraceConfig:
    """Activation-cycling trace sized off the ``repro_torch.configs`` model zoo.

    ``arch``/``shape`` name a real ``ArchConfig``/``ShapeConfig``; per-layer
    activation footprints keep the zoo's *relative* widths (attention
    residual stream + the layer's active FFN width) but are proportionally
    scaled so the whole working set is ``total_pages`` — big enough to
    oversubscribe a pool, small enough to replay in milliseconds.
    """
    arch: str = "granite-3-8b"
    shape: str = "train_4k"
    n_steps: int = 3               # fwd+bwd sweeps
    total_pages: int = 2048        # working-set budget (all layers)
    seed: int = 0


def _layer_weights(arch) -> np.ndarray:
    """Relative activation footprint per layer from the arch config.

    Residual stream (d_model) plus a quarter of the *active* FFN width:
    full ``d_ff`` for dense layers, ``top_k * d_expert`` (or d_ff) for MoE
    layers, the SSD state width for SSM layers.  The absolute scale is
    normalized away by ``total_pages``; only the per-layer ratios matter.
    """
    w = []
    for layer in range(arch.n_layers):
        ffn = arch.d_ff
        if arch.moe is not None and layer >= arch.n_dense_layers:
            d_exp = arch.moe.d_expert or arch.d_ff
            ffn = (arch.moe.top_k + arch.moe.n_shared) * d_exp
        elif arch.n_dense_layers and layer < arch.n_dense_layers:
            ffn = arch.dense_d_ff or arch.d_ff
        if arch.ssm is not None and arch.n_heads == 0:
            ffn = arch.ssm.expand * arch.d_model
        w.append(arch.d_model + ffn // 4)
    return np.asarray(w, np.float64)


def ml_trace(cfg: MLTraceConfig) -> WorkloadTrace:
    """Forward-write / backward-read sweeps over per-layer activation pages.

    Each training step writes layer 0..L-1's activation pages in order
    (forward), then reads L-1..0's in reverse (backward).  Early layers'
    activations are the *oldest* data when the pool fills mid-forward —
    exactly the paper's ML scenario where they spill remote and the
    backward sweep pays the remote-read tail.  ``phase_bounds`` marks every
    sweep boundary (2 per step).
    """
    from repro_torch.configs import ARCHS, SHAPES
    arch = ARCHS[cfg.arch]
    _ = SHAPES[cfg.shape]          # validated; sizing is relative (see doc)
    w = _layer_weights(arch)
    pages_per_layer = np.maximum(
        np.rint(w * cfg.total_pages / w.sum()).astype(np.int64), 1)
    layer_base = np.concatenate(([0], np.cumsum(pages_per_layer)[:-1]))
    n_pages = int(pages_per_layer.sum())

    rng = np.random.default_rng(cfg.seed)
    fwd_chunks, bwd_chunks = [], []
    for layer in range(arch.n_layers):
        ids = layer_base[layer] + np.arange(pages_per_layer[layer],
                                            dtype=np.int64)
        # activation pages are produced in compute order but consumed with
        # a seeded within-layer shuffle (recompute boundaries, attention
        # blocks) — the same shuffle every run
        fwd_chunks.append(ids)
        bwd_chunks.append(rng.permutation(ids))
    fwd = np.concatenate(fwd_chunks)
    bwd = np.concatenate(bwd_chunks[::-1])

    pages, is_write, bounds, pos = [], [], [], 0
    for _step in range(cfg.n_steps):
        for sweep, writes in ((fwd, True), (bwd, False)):
            if pos:
                bounds.append(pos)
            pages.append(sweep)
            is_write.append(np.full(len(sweep), writes))
            pos += len(sweep)
    return WorkloadTrace(f"ml_{cfg.arch}", np.concatenate(pages),
                         np.concatenate(is_write), n_pages, tuple(bounds))


# --------------------------------------------------------------------------
# Mixed-tenant combinations
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class MixedTenantConfig:
    """K tenants (any mix of YCSB/ML traces) time-sliced over one slab.

    Demand is *phase-staggered* (the §3.4 skew scenario, and what a shared
    host actually sees): there is one global phase per tenant, and tenant t
    is hot exactly in phase t — a KV tenant replays its full YCSB trace
    there and only a small keyspace-head trickle elsewhere (diurnal load);
    an ML tenant runs its fwd/bwd sweeps there and is silent elsewhere (the
    training job starts and finishes).  Pooled memory wins when the cold
    tenants' idle share can follow the hot tenant around; static
    partitioning pays the hot tenant's overflow in every phase.
    """
    kv: Tuple[YCSBConfig, ...] = (
        YCSBConfig("B", n_pages=1024, n_ops=18_000, seed=11),
        YCSBConfig("A", n_pages=1024, n_ops=18_000, seed=12))
    ml: Tuple[MLTraceConfig, ...] = (MLTraceConfig(seed=13),)
    idle_ops: int = 800            # KV trickle ops per cold phase
    idle_pages: int = 96           # trickle working set (keyspace head)
    slice_ops: int = 128           # round-robin time slice
    # tenant churn (ROADMAP item 5 follow-up): extra KV tenants that join
    # mid-run and leave again — live only for a bounded phase window
    # around their own hot phase (register/deregister against the
    # coordinator at the window edges).  Empty by default, which keeps the
    # emitted traces bitwise identical to the churn-free suite.
    churn_kv: Tuple[YCSBConfig, ...] = ()
    churn_linger_phases: int = 1   # live phases before/after the hot phase


def tenant_lifetimes(cfg: MixedTenantConfig) -> List[Tuple[int, int]]:
    """Per-tenant live-phase windows ``[join, leave)``.

    Base tenants (``kv`` + ``ml``) live for the whole run.  Churn tenants
    join ``churn_linger_phases`` before their hot phase and leave the same
    margin after it — a driver registers the tenant's container with the
    coordinator at ``join`` and deregisters it at ``leave``."""
    n_base = len(cfg.kv) + len(cfg.ml)
    n_tenants = n_base + len(cfg.churn_kv)
    linger = max(int(cfg.churn_linger_phases), 0)
    out = [(0, n_tenants)] * n_base
    for t in range(n_base, n_tenants):
        out.append((max(t - linger, 0), min(t + linger + 1, n_tenants)))
    return out


def mixed_tenant_traces(cfg: MixedTenantConfig) -> List[WorkloadTrace]:
    """Per-tenant phased traces (KV tenants first, then ML, then churn KV).

    Each tenant's trace has exactly ``n_tenants`` phase segments (its
    ``phase_bounds`` mark the cuts; segments may be empty) aligned with the
    global schedule: segment p is what the tenant does while tenant p is
    hot.  Page-id spaces are per-tenant — the *slab* is shared, the
    keyspaces are not.  Use ``phase_segments`` to slice a trace back into
    its per-phase (start, end) ranges.

    Churn tenants behave like KV tenants inside their ``tenant_lifetimes``
    window (full trace in their hot phase, keyspace-head trickle in the
    linger phases) and emit *empty* segments outside it — op conservation
    over the interleaved schedule therefore holds with or without churn.
    """
    n_base = len(cfg.kv) + len(cfg.ml)
    n_tenants = n_base + len(cfg.churn_kv)
    hot: List[WorkloadTrace] = ([ycsb_trace(c) for c in cfg.kv]
                                + [ml_trace(c) for c in cfg.ml]
                                + [ycsb_trace(c) for c in cfg.churn_kv])
    lifetimes = tenant_lifetimes(cfg)
    out: List[WorkloadTrace] = []
    for t, trace in enumerate(hot):
        is_kv = t < len(cfg.kv) or t >= n_base
        if t < len(cfg.kv):
            seed = cfg.kv[t].seed
        elif t < n_base:
            seed = cfg.ml[t - len(cfg.kv)].seed
        else:
            seed = cfg.churn_kv[t - n_base].seed
        join, leave = lifetimes[t]
        pages_parts, write_parts, bounds, pos = [], [], [], 0
        for ph in range(n_tenants):
            if ph:
                bounds.append(pos)
            if ph == t:
                pages_parts.append(trace.pages)
                write_parts.append(trace.is_write)
                pos += len(trace)
            elif is_kv and cfg.idle_ops > 0 and join <= ph < leave:
                rng = np.random.default_rng((seed + 1) * 1000 + ph)
                idle_span = min(cfg.idle_pages, trace.n_pages)
                pages_parts.append(rng.integers(0, idle_span, cfg.idle_ops,
                                                dtype=np.int64))
                write_parts.append(rng.random(cfg.idle_ops) >= 0.95)
                pos += cfg.idle_ops
            # ML tenants are silent outside their phase, churn tenants
            # outside their lifetime: empty segment
        out.append(WorkloadTrace(
            trace.name, np.concatenate(pages_parts),
            np.concatenate(write_parts), trace.n_pages, tuple(bounds)))
    return out


def phase_segments(trace: WorkloadTrace) -> List[Tuple[int, int]]:
    """(start, end) op ranges of a trace's phase segments, in order."""
    cuts = [0, *trace.phase_bounds, len(trace)]
    return list(zip(cuts[:-1], cuts[1:]))


def interleave_tenants(lengths: Sequence[int], slice_ops: int
                       ) -> List[Tuple[int, int, int]]:
    """Round-robin schedule over per-tenant trace lengths.

    Returns ``(tenant, start, end)`` slices; concatenating a tenant's
    slices reproduces its trace exactly (op conservation — unit-tested),
    while interleaving makes demand overlap in time the way a shared host
    actually sees it.  Tenants that run out simply drop from the rotation.
    """
    if slice_ops < 1:
        raise ValueError("slice_ops must be >= 1")
    cursors = [0] * len(lengths)
    out: List[Tuple[int, int, int]] = []
    live = True
    while live:
        live = False
        for t, n in enumerate(lengths):
            i = cursors[t]
            if i >= n:
                continue
            live = True
            end = min(i + slice_ops, n)
            out.append((t, i, end))
            cursors[t] = end
    return out
