"""Unified orchestration configuration (the stable public API surface).

Five PRs of vectorization work accreted knobs onto ``TieredPageStore`` and
``ValetServeEngine`` one keyword at a time.  ``OrchestrationConfig`` is the
consolidation: one frozen dataclass holding every orchestration decision —
policy, cost profile, pool geometry, pipeline depths, coordinator/QoS
settings, and the async-engine knobs introduced alongside it — constructed
once and handed to ``TieredPageStore.from_config()`` /
``ValetServeEngine.from_config()``.

The legacy constructor keywords keep working as *deprecated aliases*: passing
them emits a ``DeprecationWarning`` naming the replacement field, and they
are folded into an ``OrchestrationConfig`` internally, so both construction
paths produce bitwise-identical stores (``test_config.py`` pins this).
"""
from __future__ import annotations

import dataclasses
import warnings
from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Tuple

from repro_torch.core.policies import (CostModel, Policy, PAPER_COSTS, VALET)


@dataclass(frozen=True)
class OrchestrationConfig:
    """Every orchestration knob in one immutable, replace()-able object.

    Pool geometry is in *pages*; depths are entry counts; ``activity_decay``
    is the coordinator's per-round demand decay (§3.4).  The async fields
    only take effect with ``async_mode=True`` (see ``AsyncOrchestrator``).
    """

    # -- policy & cost profile -------------------------------------------
    policy: Policy = VALET
    costs: CostModel = PAPER_COSTS

    # -- local pool geometry (§4.1) --------------------------------------
    pool_capacity: int = 1024
    min_pool: int = 64
    max_pool: Optional[int] = None        # None -> pool_capacity
    grow_step: Optional[int] = None       # None -> capacity // 8

    # -- remote / host tiers ---------------------------------------------
    n_peers: int = 4
    peer_capacity_blocks: int = 1024
    pages_per_block: int = 16
    host_capacity: int = 1 << 30

    # -- pipeline depths & cadence ---------------------------------------
    batch_reclaim: bool = True            # dense SoA reclaim/flush engine
    staging_depth: int = 1 << 16          # WritePipeline row-queue length
    flush_batch: int = 64                 # default background_tick drain
    pressure_batch: int = 256             # blocks freed per pressure round

    # -- host memory coordinator (§3.4) / QoS ----------------------------
    coordinator: Optional[Any] = None     # HostMemoryCoordinator
    container_name: Optional[str] = None
    weight: float = 1.0                   # weighted-fair share (QoS)
    activity_decay: float = 0.5           # coordinator demand decay / round

    # -- async orchestration engine --------------------------------------
    async_mode: bool = False              # overlap reclaim/flush/migration
    epoch_len: int = 64                   # ops per epoch (commit cadence)
    daemon_budget: int = 256              # pages of daemon work per epoch
    real_thread: bool = False             # real daemon thread (not determ.)

    # -- fault handling (core/faults.py) ---------------------------------
    # retry/backoff against a SUSPECT peer: each access pays
    # ``backoff_base_us * (2^retry_limit - 1)`` of simulated wait (the
    # full exponential ladder — deterministic, so the parity suites hold
    # whenever no fault is injected)
    retry_limit: int = 3
    backoff_base_us: float = 8.0
    # simulated us a peer may stay SUSPECT before the health poll
    # escalates it to DOWN (fail_peer)
    suspect_timeout_us: float = 50_000.0
    # re-replication repair drain rate: pages copied per background tick
    # (sync) or per daemon slice (async)
    repair_rate: int = 256

    # -- cluster-scale knobs (core/cluster.py) ---------------------------
    # heterogeneous remote peers: a tuple of ``PeerProfile``s (one per
    # peer: extra latency, capacity override, failure domain — see
    # ``draw_peer_profiles``).  None keeps the flat homogeneous peer set —
    # bitwise identical to every pre-cluster run.
    peer_profiles: Optional[Tuple[Any, ...]] = None
    # REJOINING warm-up: a rejoined peer's advertised free capacity ramps
    # linearly over its first ``rejoin_ramp_grants`` block grants instead
    # of re-entering placement at full weight.  Only activates after a
    # rejoin event, so fault-free runs are unaffected.  0 disables.
    rejoin_ramp_grants: int = 16

    # -- device tier / zero-restore -------------------------------------
    # trace store: remember reclaimed pages' slots and repoint on re-access
    # while the slot is untouched (off by default: it improves hit ratios,
    # so the bitwise scalar/batch parity suites run without it)
    device_tier: bool = False
    # serve engine: preemption demotes KV pages in place (no copy); restore
    # repoints block-table entries and streams only reused slots.  False =
    # legacy bulk gather/scatter spill/restore (the comparison baseline).
    zero_restore: bool = True

    # -- serving knobs (ValetServeEngine.from_config) --------------------
    page: int = 16                        # tokens per KV page
    max_batch: int = 8                    # concurrent decode slots
    max_seq: int = 512                    # max tokens per sequence
    pool_slots: Optional[int] = None      # KV pool slots; None -> pool_capacity
    step_cost_us: float = 0.0             # simulated cost per decode step

    # -- simulation plumbing ---------------------------------------------
    seed: int = 0
    free_memory_fn: Optional[Callable[[], int]] = field(
        default=None, compare=False)
    data_plane: Optional[Any] = field(default=None, compare=False)

    def replace(self, **changes) -> "OrchestrationConfig":
        return dataclasses.replace(self, **changes)


# legacy TieredPageStore keyword -> OrchestrationConfig field
LEGACY_STORE_KWARGS = {
    "pool_capacity": "pool_capacity",
    "min_pool": "min_pool",
    "max_pool": "max_pool",
    "n_peers": "n_peers",
    "peer_capacity_blocks": "peer_capacity_blocks",
    "pages_per_block": "pages_per_block",
    "host_capacity": "host_capacity",
    "free_memory_fn": "free_memory_fn",
    "seed": "seed",
    "data_plane": "data_plane",
    "batch_reclaim": "batch_reclaim",
    "grow_step": "grow_step",
    "coordinator": "coordinator",
    "container_name": "container_name",
    "container_weight": "weight",
    "weight": "weight",
}


# legacy ValetServeEngine.from_config keyword -> OrchestrationConfig field
# (the serving knobs live on the config; the loose kwargs stay as
# deprecated aliases behind the same CI gate as the store's)
LEGACY_SERVE_KWARGS = {
    "max_batch": "max_batch",
    "max_seq": "max_seq",
    "page": "page",
    "pool_slots": "pool_slots",
    "step_cost_us": "step_cost_us",
}


def config_from_legacy_kwargs(base: OrchestrationConfig,
                              kwargs: dict,
                              *, owner: str,
                              stacklevel: int = 3,
                              alias_map: Optional[dict] = None
                              ) -> OrchestrationConfig:
    """Fold deprecated constructor keywords into a config, warning per key.

    Unknown keys raise ``TypeError`` exactly as the old signature would.
    ``alias_map`` defaults to the store's map; the serve engine passes
    ``LEGACY_SERVE_KWARGS``.
    """
    aliases = LEGACY_STORE_KWARGS if alias_map is None else alias_map
    mapped = {}
    for key, val in kwargs.items():
        tgt = aliases.get(key)
        if tgt is None:
            raise TypeError(
                f"{owner}() got an unexpected keyword argument {key!r}")
        warnings.warn(
            f"{owner}({key}=...) is deprecated; build an "
            f"OrchestrationConfig({tgt}=...) and use "
            f"{owner}.from_config() instead",
            DeprecationWarning, stacklevel=stacklevel)
        mapped[tgt] = val
    return dataclasses.replace(base, **mapped) if mapped else base
