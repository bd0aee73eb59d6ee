"""TieredPageStore — the full Valet orchestration over HBM / peer / host /
cold tiers (paper §3 + §4 wired together).

This is the control-plane state machine used by BOTH:

* the **trace simulator**: drives it with synthetic page-access traces
  (YCSB ETC/SYS analogues, ``repro_torch.data``) and accumulates simulated
  microseconds from a ``CostModel`` — the paper's Table 1 / Figures 8, 10,
  19-23 are built from these counters;
* the **serving engine** (serve/): drives it with real decode steps, where
  the data plane is torch tensors (``device_ops``) and the cost counters are
  informational.

Policy knobs (``policies.py``) select between Valet and the baseline systems
(Infiniswap / nbdX / OS-swap) without changing the workload code.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.activity import (ActivityTracker,
                                 PairSampler,
                                 select_victims_random)
from repro_torch.core.config import OrchestrationConfig, config_from_legacy_kwargs
from repro_torch.core.faults import PeerHealth, RepairQueue
from repro_torch.core.migration import MigrationEngine
from repro_torch.core.page_table import GlobalPageTable, Location, Tier
from repro_torch.core.policies import CostModel, Policy
from repro_torch.core.pool import SlotState, ValetMempool
from repro_torch.core.queues import WritePipeline
from repro_torch.core.replication import (ReplicaPlacer, fail_peer,
                                    fail_peer_batched)
from repro_torch.core.reservoir import LatencyStatsMixin
from repro_torch.core.tiers import DeviceTier

_IN_USE = int(SlotState.IN_USE)
_RECLAIMABLE = int(SlotState.RECLAIMABLE)


@dataclass
class PeerState:
    """A remote memory donor (receiver module)."""
    capacity: int
    used: int = 0
    connected: bool = False
    mapped_blocks: int = 0
    failed: bool = False

    def free(self) -> int:
        return 0 if self.failed else self.capacity - self.used


@dataclass
class Stats(LatencyStatsMixin):
    """Trace-store counters.  The latency/fence reservoirs and their
    percentile accessors live on the shared ``LatencyStatsMixin`` (also
    inherited by the serve engine's ``EngineStats``)."""
    time_us: float = 0.0
    ops: int = 0
    local_hits: int = 0
    remote_hits: int = 0
    host_hits: int = 0
    cold_hits: int = 0
    writes: int = 0
    write_stall_us: float = 0.0
    evictions: int = 0
    migrations: int = 0
    connects: int = 0
    maps: int = 0
    # async orchestration engine (zero in synchronous mode, so the bitwise
    # dataclass-equality parity asserts between sync drivers still hold)
    fences: int = 0
    fence_wait_us: float = 0.0
    daemon_us: float = 0.0
    # device-tier repoints (zero in the default bitwise-parity mode): reads
    # served by repointing a demoted-but-resident page back to its old pool
    # slot instead of reading a copy from host/remote.  Counted inside
    # local_hits too (after the repoint the page IS local).
    device_hits: int = 0
    # fault handling (core/faults.py; all zero until a fault is injected,
    # so the bitwise dataclass-equality parity asserts keep holding):
    # retry/backoff waits against SUSPECT peers, and re-replication repair
    # traffic (informational — repair runs off the critical path)
    retries: int = 0
    retry_wait_us: float = 0.0
    repair_pages: int = 0
    repair_us: float = 0.0

    def hit_ratio(self) -> Dict[str, float]:
        n = max(self.local_hits + self.remote_hits + self.host_hits
                + self.cold_hits, 1)
        return {
            "local": self.local_hits / n,
            "remote": self.remote_hits / n,
            "host": self.host_hits / n,
            "cold": self.cold_hits / n,
        }


class TieredPageStore:
    """Valet (or baseline) orchestration of one sender node's pages."""

    def __init__(self, policy: Optional[Policy] = None,
                 costs: Optional[CostModel] = None, *,
                 config: Optional[OrchestrationConfig] = None,
                 **legacy):
        """Build a store from ``config`` (the stable API surface).

        ``policy``/``costs`` positionals override the config's when given.
        Every pre-config keyword (``pool_capacity=...`` etc.) still works as
        a deprecated alias: it emits a ``DeprecationWarning`` and folds into
        the config, producing a bitwise-identical store either way."""
        cfg = config if config is not None else OrchestrationConfig()
        if policy is not None:
            cfg = cfg.replace(policy=policy)
        if costs is not None:
            cfg = cfg.replace(costs=costs)
        cfg = config_from_legacy_kwargs(cfg, legacy, owner="TieredPageStore")
        self.config = cfg
        policy = cfg.policy
        costs = cfg.costs
        self.policy = policy
        self.costs = costs
        self.pages_per_block = cfg.pages_per_block
        self.rng = np.random.default_rng(cfg.seed)
        self.stats = Stats()
        self.step = 0
        self.data_plane = cfg.data_plane
        # vectorized off-critical-path pipeline (flush placement, victim
        # selection/migration, delete eviction); False = scalar reference
        self.batch_reclaim = cfg.batch_reclaim

        pool_capacity = cfg.pool_capacity
        n_peers = cfg.n_peers
        peer_capacity_blocks = cfg.peer_capacity_blocks
        host_capacity = cfg.host_capacity
        coordinator = cfg.coordinator
        max_pool = cfg.max_pool or pool_capacity
        min_pool = cfg.min_pool
        if not policy.dynamic_pool:
            min_pool = max_pool
        # §3.4 multi-container mode: the pool leases its pages from a shared
        # HostMemoryCoordinator instead of probing a synthetic host-free
        # callable — growth is granted (possibly reclaiming idle containers'
        # memory) and every shrink returns pages to the shared slab
        self.coordinator = coordinator
        self._lease = None
        if coordinator is not None:
            self._lease = coordinator.register(
                min_pages=min_pool, max_pages=max_pool,
                weight=cfg.weight, name=cfg.container_name)
        self.pool = ValetMempool(pool_capacity, min_pages=min_pool,
                                 max_pages=max_pool,
                                 free_memory_fn=cfg.free_memory_fn,
                                 grow_step=cfg.grow_step,
                                 lease=self._lease)
        if coordinator is not None:
            coordinator.set_donor(self._lease.cid, self.host_donate,
                                  size_fn=lambda: self.pool.size)
            # coordinator-aware remote pressure (§3.4 follow-up): expose this
            # container's per-peer MR-block footprint (dense membership
            # columns) and its pressure handler for coordinated fan-out
            reg = getattr(coordinator, "register_peer_footprint", None)
            if reg is not None:
                reg(self._lease.cid, self._peer_block_footprint,
                    self.peer_pressure)
        self.pipeline = WritePipeline(self.pool,
                                      queue_len=cfg.staging_depth)
        self.gpt = GlobalPageTable()
        # heterogeneous peer profiles (core/cluster.py): per-peer capacity
        # overrides, extra read latency, and failure domains.  None (the
        # default) keeps the flat homogeneous peer set — bitwise identical
        # to every pre-cluster run.
        profiles = cfg.peer_profiles
        if profiles is not None and len(profiles) != n_peers:
            raise ValueError(f"peer_profiles has {len(profiles)} entries "
                             f"for {n_peers} peers")
        self.peers = [PeerState(capacity=(
            profiles[i].capacity_blocks
            if profiles is not None
            and profiles[i].capacity_blocks is not None
            else peer_capacity_blocks)) for i in range(n_peers)]
        if profiles is not None:
            doms = [p.domain for p in profiles]
            self._peer_domain = doms if len(set(doms)) > 1 else None
            lat = np.array([p.latency_us for p in profiles], np.float64)
            self._peer_lat_extra = lat if lat.any() else None
        else:
            self._peer_domain = None
            self._peer_lat_extra = None
        # remote blocks: (peer, block_slot) -> list of logical pages
        self.blocks: Dict[Tuple[int, int], List[int]] = {}
        # dense per-peer block-table membership columns: ``_blk_live[p][s]``
        # is True while MR block (p, s) is allocated, ``_blk_replica[p][s]``
        # while it serves as some primary's replica.  The pressure paths
        # select victim candidates with one masked flatnonzero over these
        # instead of scanning the block dict; the per-block page lists stay
        # list-backed (append-heavy, variable length).
        self._blk_live = [np.zeros(1024, bool) for _ in range(n_peers)]
        self._blk_replica = [np.zeros(1024, bool) for _ in range(n_peers)]
        self.block_replicas: Dict[Tuple[int, int], List[Tuple[int, int]]] = {}
        # reverse index: replica block -> its primary.  Replica blocks are
        # not independent victims (migrating one would leave the primary's
        # replica list and the page table dangling), so pressure paths skip
        # them and ``_free_block`` keeps both directions consistent.
        self._replica_of: Dict[Tuple[int, int], Tuple[int, int]] = {}
        self._next_block_slot = [0] * n_peers
        self._open_block: Dict[int, Tuple[int, int]] = {}   # peer -> block key
        # sized to cover the block-id stride (peer << 20 | slot) upfront so
        # the dense activity arrays never re-grow mid-run (calloc is lazy —
        # untouched pages cost nothing)
        self.tracker = ActivityTracker(max(n_peers, 1) << 20)
        # the pair stream gets its own child generator so bulk pre-drawing
        # (draw_batch) never shifts the replica-placement / migration draws
        # that stay on self.rng — scalar and batched paths consume identical
        # streams from both generators
        self._pairs = PairSampler(n_peers, self.rng.spawn(1)[0]) \
            if n_peers >= 2 else None
        self.placer = ReplicaPlacer(self.rng, domains=self._peer_domain)
        self.host_pages: Dict[int, bool] = {}
        # dense mirror of host_pages membership (append-only): batch
        # classification gathers it instead of probing the dict per page
        self._host_mask = np.zeros(1 << 12, bool)
        # cached peer-failed vector (invalidated by fail_peer) — peers only
        # ever fail through fail_peer, so the batch paths never rebuild it
        self._peer_failed = np.zeros(max(n_peers, 1), bool)
        # fault subsystem (core/faults.py): per-peer health state machine,
        # the cached SUSPECT vector (placement avoidance + retry/backoff
        # pricing), and the re-replication repair queue.  All dormant — and
        # bitwise invisible to the parity suites — until a fault is injected
        # (mark_suspect / fail_peer / the FaultInjector).
        self.health = PeerHealth(n_peers,
                                 suspect_timeout_us=cfg.suspect_timeout_us)
        self._peer_suspect = np.zeros(max(n_peers, 1), bool)
        self._any_suspect = False
        # True while some peer is SUSPECT or REJOINING: the scalar ops poll
        # the health machine (timeout escalation, rejoin activation) only
        # behind this flag, keeping the healthy hot path untouched
        self._health_dirty = False
        self.repairq = RepairQueue()
        # REJOINING warm-up ramp: block grants left before a rejoined peer
        # advertises full free capacity again.  All-zero (and _any_ramp
        # False) until a rejoin event, so fault-free placement never pays
        # the extra arithmetic and stays bitwise identical.
        self._ramp_left = np.zeros(max(n_peers, 1), np.int64)
        self._any_ramp = False
        # whether the coordinator currently holds a non-zero degraded
        # report from us (so the backlog-drained clear fires exactly once)
        self._degraded_reported = False
        # the full exponential backoff ladder, paid per access to a SUSPECT
        # peer: base * (2^0 + 2^1 + ... + 2^(retry_limit-1))
        self._retry_penalty_us = \
            cfg.backoff_base_us * ((1 << cfg.retry_limit) - 1)
        # boundary events of the plan-once batch engine install a list here;
        # _reclaim appends every page whose local mapping it drops, so the
        # engine re-classifies exactly the invalidated pages afterwards
        self._unmap_log: Optional[list] = None
        # device tier: remember each reclaimed page's (slot, gen) so a
        # re-access while the slot is still FREE repoints instead of reading
        # the host/remote copy.  Opt-in — the default keeps the bitwise
        # scalar/batch parity of the reference suites (repoints change hit
        # classification and free-stack order).
        self.device = DeviceTier() if cfg.device_tier else None
        self.host_capacity = host_capacity
        # the engine sees encoded block ids (peer<<20|slot); decode for the
        # slot-level data/metadata callbacks
        dec = lambda bid: bid % (1 << 20)
        self.migrator = MigrationEngine(
            self.gpt, self.tracker,
            free_counts_fn=lambda: [
                0 if self._peer_suspect[i] else self._ramp_free(i, p.free())
                for i, p in enumerate(self.peers)],
            copy_fn=lambda sp, sb, dp_, ds: self._copy_block(sp, dec(sb), dp_, ds),
            alloc_fn=self._alloc_block_slot,
            free_fn=lambda p, b: self._free_block(p, dec(b)),
            park_fn=self._park_pages,
            rng=self.rng)
        if self._peer_domain is not None:
            # failure-domain-aware migration: a migrated primary never
            # lands in a rack already holding one of its replicas
            self.migrator.domains = self._peer_domain
            self.migrator.replica_peers_fn = self._block_replica_peers
        # async orchestration engine: a background daemon that
        # drains the reclaimable queue / flushes write-sets / charges
        # migration copies off the critical path, with an epoch/fence
        # protocol in place of the inline stall.  None = synchronous mode
        # (bitwise-parity guaranteed, the default).
        self.orchestrator = None
        if cfg.async_mode and policy.use_local_pool:
            from repro_torch.core.async_engine import AsyncOrchestrator
            self.orchestrator = AsyncOrchestrator(
                self, epoch_len=cfg.epoch_len,
                daemon_budget=cfg.daemon_budget,
                real_thread=cfg.real_thread)
            self.migrator.on_block_copied = \
                self.orchestrator.note_block_copied

    @classmethod
    def from_config(cls, config: OrchestrationConfig, *,
                    policy: Optional[Policy] = None,
                    costs: Optional[CostModel] = None) -> "TieredPageStore":
        """The non-deprecated construction path: one config object in,
        no sprawling keyword surface.  ``policy``/``costs`` override the
        config's fields when given (convenient for policy sweeps)."""
        return cls(policy, costs, config=config)

    # -- host-tier membership --------------------------------------------------

    def _host_add(self, page: int):
        """Record a host-tier spill in both the dict (scalar probes) and the
        dense membership bitmap (batch classification gathers)."""
        self.host_pages[page] = True
        hm = self._host_mask
        if page >= hm.shape[0]:
            grown = np.zeros(max(hm.shape[0] * 2, page + 1), bool)
            grown[:hm.shape[0]] = hm
            self._host_mask = grown
            self._host_mask[page] = True
        else:
            hm[page] = True

    # -- block-id helpers ------------------------------------------------------

    def _block_id(self, peer: int, slot: int) -> int:
        return peer * (1 << 20) + slot

    def _blk_ensure(self, peer: int, slot: int):
        """Grow the dense block-membership columns to cover ``slot``."""
        arr = self._blk_live[peer]
        if slot < arr.shape[0]:
            return
        new = max(arr.shape[0] * 2, slot + 1)
        for cols in (self._blk_live, self._blk_replica):
            g = np.zeros(new, bool)
            g[:cols[peer].shape[0]] = cols[peer]
            cols[peer] = g

    def _ramp_free(self, peer: int, free: int) -> int:
        """Warm-up discount on a freshly rejoined peer's advertised free
        count: ramps linearly over its first ``rejoin_ramp_grants`` block
        grants, never below 1 while room exists (the peer must stay
        placeable to warm up at all).  Identity while no ramp is live."""
        if not self._any_ramp or free <= 0:
            return free
        left = int(self._ramp_left[peer])
        if left <= 0:
            return free
        k = self.config.rejoin_ramp_grants
        return max(1, free * (k - left) // k)

    def _ramp_note_grant(self, peer: int) -> None:
        """A block grant landed on a warming-up peer: one ramp step."""
        if self._ramp_left[peer] > 0:
            self._ramp_left[peer] -= 1
            if not self._ramp_left.any():
                self._any_ramp = False

    def _block_replica_peers(self, bid: int) -> List[int]:
        """Peers holding replicas of the (encoded-id) block — the
        migration engine's domain-avoidance probe."""
        key = (bid >> 20, bid % (1 << 20))
        return [r[0] for r in self.block_replicas.get(key, ())]

    def _alloc_block_slot(self, peer: int) -> Optional[int]:
        p = self.peers[peer]
        if p.failed or self._peer_suspect[peer] or p.free() <= 0:
            return None
        if self._any_ramp:
            self._ramp_note_grant(peer)
        slot = self._next_block_slot[peer]
        self._next_block_slot[peer] += 1
        p.used += 1
        p.mapped_blocks += 1
        self.blocks[(peer, slot)] = []
        self._blk_ensure(peer, slot)
        self._blk_live[peer][slot] = True
        if not p.connected:
            p.connected = True
            self.stats.connects += 1
            self.stats.time_us += 0.0 if self.policy.use_local_pool \
                else self.costs.connect
        self.stats.maps += 1
        if not self.policy.use_local_pool:
            self.stats.time_us += self.costs.map_block
        return slot

    def _free_block(self, peer: int, slot: int, *,
                    free_replicas: bool = False):
        """Release one MR block.

        ``free_replicas=True`` (the delete-eviction paths) additionally
        garbage-collects the freed primary's replica blocks: a replica that
        no page references any more — neither as its primary location (a
        ``repoint_replica`` promotion) nor in its replica tuple — is dead
        weight on its peer and is freed too.  Migration keeps the default:
        a migrated primary's pages still carry their replica tuples, so
        those blocks stay live (they are merely detached here)."""
        self.peers[peer].used -= 1
        key = (peer, slot)
        pages = self.blocks.pop(key, None)
        self._blk_live[peer][slot] = False
        if self._open_block.get(peer) == key:
            self._open_block.pop(peer)
        prim = self._replica_of.pop(key, None)
        if prim is not None:
            self._blk_replica[peer][slot] = False
            reps = self.block_replicas.get(prim)
            if reps:
                self.block_replicas[prim] = tuple(r for r in reps
                                                  if r != key)
        for r in self.block_replicas.pop(key, ()):
            # freeing a primary orphans its replicas: they stop being
            # replicas (and become ordinary eviction candidates) ...
            self._replica_of.pop(r, None)
            self._blk_replica[r[0]][r[1]] = False
            if free_replicas and not self._block_referenced(r):
                # ... unless nothing references them at all — then the
                # orphan would leak its peer memory forever (ROADMAP
                # follow-up): free it symmetrically with its primary
                self._free_block(*r)
        return pages

    def _block_referenced(self, key: Tuple[int, int]) -> bool:
        """True if any page in ``key``'s block still resolves to it — as its
        remote primary (replica promotion) or inside its replica tuple."""
        peer, slot = key
        for pg in self.blocks.get(key, ()):
            loc = self.gpt.remote_location(pg)
            if loc is None:
                continue
            if loc.tier == Tier.PEER and loc.peer == peer \
                    and loc.slot == slot:
                return True
            if key in loc.replicas:
                return True
        return False

    def _copy_block(self, src_peer, src_slot, dst_peer, dst_slot):
        pages = self.blocks.get((src_peer, src_slot), [])
        self.blocks[(dst_peer, dst_slot)] = list(pages)
        self.tracker.touch(self._block_id(dst_peer, dst_slot), self.step)
        # migration copy cost lands on peers, NOT the sender critical path
        if self.data_plane is not None:
            self.data_plane.copy_block(src_peer, src_slot, dst_peer, dst_slot)

    def _park_pages(self, pages, hold: bool):
        self.pipeline.staging.hold_pages(pages, hold)

    # -- placement -------------------------------------------------------------

    def _place_remote_raw(self, page: int
                          ) -> Optional[Tuple[int, int, Tuple]]:
        """Append the page to an open MR block (p2c peer choice per page).

        Returns ``(peer, slot, replicas)`` or None.  Runs once per flushed
        page, so the peer pair comes from the buffered ``PairSampler`` and
        only the two sampled peers' free counts are computed (same p2c
        decision as scanning all of them)."""
        if not self.policy.use_remote:
            return None
        peers = self.peers
        susp = self._peer_suspect
        if self._pairs is not None:
            a, b = self._pairs.draw()
            pa, pb = peers[a], peers[b]
            fa = 0 if pa.failed or susp[a] else pa.capacity - pa.used
            fb = 0 if pb.failed or susp[b] else pb.capacity - pb.used
            if self._any_ramp:
                fa = self._ramp_free(a, fa)
                fb = self._ramp_free(b, fb)
            peer, best_free = (a, fa) if fa >= fb else (b, fb)
        elif peers:
            peer, best_free = 0, peers[0].free()
        else:
            return None                   # no peers configured: host spill
        if best_free <= 0:
            return None
        blk = self._open_block.get(peer)
        if blk is None or len(self.blocks.get(blk, [])) >= self.pages_per_block:
            slot = self._alloc_block_slot(peer)
            if slot is None:
                return None
            blk = (peer, slot)
            self._open_block[peer] = blk
            # replicas are allocated at BLOCK granularity alongside the primary
            reps = []
            if self.policy.replication > 0:
                free = [0 if susp[j] else self._ramp_free(j, p.free())
                        for j, p in enumerate(peers)]
                for rp in self.placer.place(peer, free,
                                            self.policy.replication):
                    rslot = self._alloc_block_slot(rp)
                    if rslot is not None:
                        reps.append((rp, rslot))
                        self._replica_of[(rp, rslot)] = blk
                        self._blk_replica[rp][rslot] = True
            # tuple, like the bulk placement path: block_replicas values are
            # immutable once the block closes
            self.block_replicas[blk] = tuple(reps)
            if len(reps) < self.policy.replication:
                # degraded from birth (no live peer had room): queue for
                # background re-replication once the topology improves
                self.repairq.push(blk)
        self.blocks[blk].append(page)
        self.tracker.touch(self._block_id(*blk), self.step)
        reps = self.block_replicas.get(blk, ())
        for rp, rs in reps:
            self.blocks[(rp, rs)].append(page)
        return blk[0], blk[1], tuple(reps)

    def _place_remote(self, page: int) -> Optional[Location]:
        placed = self._place_remote_raw(page)
        if placed is None:
            return None
        peer, slot, reps = placed
        return Location(Tier.PEER, peer=peer, slot=slot, replicas=reps)

    def _place_pages_bulk(self, pages, *, flush: bool):
        """Bulk ``_place_remote_raw`` over a page sequence.

        One ``PairSampler.draw_batch`` pre-draws every p2c pair, peer
        capacity/usage and the open-block fill state are tracked in local
        scalars, and activity tags are scattered once at the end — the
        placement *decisions* (peer choice, block boundaries, replica
        placement, spill fallbacks, rng consumption) are identical to
        calling the scalar helper once per page.

        ``flush=True`` (lazy-send path): failed placements spill to the HOST
        tier (``host_pages`` updated) and each page costs host/remote write;
        no critical-path time is charged here.  ``flush=False``
        (write-through write run): failed placements fall to COLD, per-page
        latency plus block connect/map costs accumulate into
        ``stats.time_us`` in exactly the scalar interleaving, and the
        activity tag carries the per-op step.

        Returns ``(tiers, peers, slots, replicas, costs)`` parallel lists,
        ready for one ``map_remote_batch`` scatter.
        """
        n = len(pages)
        pol = self.policy
        c = self.costs
        peer_tier = int(Tier.PEER)
        if flush:
            spill_tier, spill_cost = int(Tier.HOST), c.host_write
            hit_cost = c.remote_write
        else:
            spill_tier, spill_cost = int(Tier.COLD), c.cold_write
            hit_cost = c.remote_write
            if pol.receiver_side_cpu:
                hit_cost = hit_cost + c.receiver_cpu
        tiers = [spill_tier] * n
        peers_out = [-1] * n
        slots_out = [-1] * n
        reps_out: List[Tuple] = [()] * n
        costs = [spill_cost] * n

        st = self.stats
        peers = self.peers
        if not pol.use_remote or not peers:
            if flush:
                hadd = self._host_add
                for pg in pages:
                    hadd(pg)
            else:
                st.time_us = self._accumulate_time(
                    st.time_us, np.full(n, spill_cost, np.float64))
            return tiers, peers_out, slots_out, reps_out, costs

        pairs = self._pairs
        if pairs is not None:
            pa, pb = pairs.draw_batch(n)
            pa_l, pb_l = pa.tolist(), pb.tolist()
        n_peers = len(peers)
        cap = [p.capacity for p in peers]
        used = [p.used for p in peers]
        # SUSPECT peers are unplaceable exactly like failed ones (the scalar
        # helper zeroes their free counts the same way), so one merged list
        # serves every free-count probe below
        susp = self._peer_suspect
        failed = [p.failed or bool(susp[j]) for j, p in enumerate(peers)]
        connected = [p.connected for p in peers]
        mapped = [p.mapped_blocks for p in peers]
        next_slot = list(self._next_block_slot)
        blocks = self.blocks
        block_replicas = self.block_replicas
        open_block = self._open_block
        ppb = self.pages_per_block
        repl = pol.replication
        place_reps = self.placer.place
        use_local_pool = pol.use_local_pool
        step = self.step
        hadd = self._host_add
        connects = st.connects
        maps = st.maps
        t = st.time_us
        touch: Dict[int, int] = {}          # block id -> last-writer step
        # per-peer open-block cache:
        # [slot, page_list, replicas, rep_lists, block id]
        open_cache: Dict[int, list] = {}

        def load_open(peer):
            blk = open_block.get(peer)
            if blk is None:
                return None
            lst = blocks[blk]
            reps = tuple(block_replicas.get(blk, ()))
            entry = [blk[1], lst, reps, [blocks[r] for r in reps],
                     peer * (1 << 20) + blk[1]]
            open_cache[peer] = entry
            return entry

        def alloc_slot(peer):
            nonlocal connects, maps, t
            if failed[peer] or cap[peer] - used[peer] <= 0:
                return None
            if self._any_ramp:
                self._ramp_note_grant(peer)
            slot = next_slot[peer]
            next_slot[peer] = slot + 1
            used[peer] += 1
            mapped[peer] += 1
            lst: List[int] = []
            blocks[(peer, slot)] = lst
            self._blk_ensure(peer, slot)
            self._blk_live[peer][slot] = True
            if not connected[peer]:
                connected[peer] = True
                connects += 1
                if not use_local_pool:
                    t += c.connect
            maps += 1
            if not use_local_pool:
                t += c.map_block
            return slot, lst

        for i, pg in enumerate(pages):
            if not flush:
                step += 1                    # scalar write() bumps per op
            if pairs is not None:
                a = pa_l[i]
                b = pb_l[i]
                fa = 0 if failed[a] else cap[a] - used[a]
                fb = 0 if failed[b] else cap[b] - used[b]
                if self._any_ramp:
                    fa = self._ramp_free(a, fa)
                    fb = self._ramp_free(b, fb)
                if fa >= fb:
                    peer, best_free = a, fa
                else:
                    peer, best_free = b, fb
            else:
                peer = 0
                best_free = 0 if failed[0] else cap[0] - used[0]
                if self._any_ramp:
                    best_free = self._ramp_free(0, best_free)
            placed = False
            if best_free > 0:
                entry = open_cache.get(peer)
                if entry is None:
                    entry = load_open(peer)
                if entry is None or len(entry[1]) >= ppb:
                    res = alloc_slot(peer)
                    if res is None:
                        entry = None
                    else:
                        slot, lst = res
                        open_block[peer] = (peer, slot)
                        reps: List[Tuple[int, int]] = []
                        rep_lists: List[list] = []
                        if repl > 0:
                            free_now = [0 if failed[j] else cap[j] - used[j]
                                        for j in range(n_peers)]
                            if self._any_ramp:
                                free_now = [self._ramp_free(j, f)
                                            for j, f in enumerate(free_now)]
                            for rp in place_reps(peer, free_now, repl):
                                r = alloc_slot(rp)
                                if r is not None:
                                    reps.append((rp, r[0]))
                                    rep_lists.append(r[1])
                                    self._replica_of[(rp, r[0])] = \
                                        (peer, slot)
                                    self._blk_replica[rp][r[0]] = True
                        entry = [slot, lst, tuple(reps), rep_lists,
                                 peer * (1 << 20) + slot]
                        block_replicas[(peer, slot)] = entry[2]
                        if len(reps) < repl:
                            # degraded from birth — same enqueue (and same
                            # condition) as the scalar helper, so the
                            # parity traces agree on the repair queue too
                            self.repairq.push((peer, slot))
                        open_cache[peer] = entry
                if entry is not None:
                    entry[1].append(pg)
                    touch[entry[4]] = step
                    for rl in entry[3]:
                        rl.append(pg)
                    tiers[i] = peer_tier
                    peers_out[i] = peer
                    slots_out[i] = entry[0]
                    reps_out[i] = entry[2]
                    costs[i] = hit_cost
                    placed = True
            if not placed and flush:
                hadd(pg)
            if not flush:
                t += costs[i]

        for j in range(n_peers):
            p = peers[j]
            p.used = used[j]
            p.mapped_blocks = mapped[j]
            p.connected = connected[j]
        self._next_block_slot = next_slot
        if touch:
            self.tracker.on_write_map(touch)
        st.connects = connects
        st.maps = maps
        if not flush:
            st.time_us = t
        return tiers, peers_out, slots_out, reps_out, costs

    # -- the two critical-path operations ---------------------------------------

    def write(self, page: int) -> float:
        """Write (page-out) one page.  Returns critical-path latency (us)."""
        self.step += 1
        if self._health_dirty:
            self._poll_health()
        self.stats.writes += 1
        lat = 0.0

        if self.policy.use_local_pool:
            ws = self.pipeline.write((page,), self.step)
            if ws is None:
                # pool exhausted: reclaim from reclaimable queue (pointer move)
                self._reclaim(max(1, self.pages_per_block))
                ws = self.pipeline.write((page,), self.step)
            if ws is None:
                # still nothing reclaimable: must flush synchronously (stall)
                lat += self._flush(self.pages_per_block, in_critical_path=True)
                self._reclaim(self.pages_per_block)
                ws = self.pipeline.write((page,), self.step)
            if ws is not None:
                self.gpt.map_local(page, ws.slots[0])
                if self.data_plane is not None:
                    self.data_plane.local_write(page, ws.slots[0])
                lat += self.costs.local_write
            else:
                lat += self.costs.cold_write       # total pressure: spill cold
                self._host_add(page)
        else:
            # write-through systems: remote send in the critical path
            loc = self._place_remote(page)
            if loc is not None:
                self.gpt.map_remote(page, loc)
                lat += self.costs.remote_write
                if self.policy.receiver_side_cpu:
                    lat += self.costs.receiver_cpu
                if self.policy.cold_backup:
                    pass                           # async disk backup
            else:
                self.gpt.map_remote(page, Location(Tier.COLD))
                lat += self.costs.cold_write
        self.stats.time_us += lat
        self.stats.ops += 1
        return lat

    def _device_repoint(self, pages) -> int:
        """Zero-copy device-tier hits (opt-in via ``device_tier``).

        Pages whose reclaimed pool slot is still FREE with an unchanged
        generation are *repointed*: the slot is claimed back off the free
        list and the page mapped local again with pure metadata moves — no
        host/remote read.  The repointed slot re-enters the store exactly
        like a cache fill (RECLAIMABLE + on the reclaimable queue, remote
        copy kept as the replica), so the invariant checker's no-lost-writes
        and staging invariants keep holding.  Stale shadows — a page that
        re-entered the pool through a write since its demotion — are dropped
        here, never claimed.  Returns the number of pages repointed."""
        dt = self.device
        if dt is None or not dt.shadow:
            return 0
        cand = []
        for pg in pages:
            pg = int(pg)
            if pg not in dt:
                continue
            if self.gpt.local_slot(pg) is not None:
                dt.drop((pg,))      # stale: page already local via a write
            else:
                cand.append(pg)
        if not cand:
            return 0
        rp_pages, rp_slots, _ = dt.split(cand, self.pool.free_gen)
        if not rp_pages:
            return 0
        self.pool.claim_batch(rp_slots, rp_pages, self.step)
        self.gpt.map_local_batch(np.asarray(rp_pages, np.int64),
                                 np.asarray(rp_slots, np.int64))
        for pg, sl in zip(rp_pages, rp_slots):
            self.pool.mark_reclaimable(sl)
            self.pipeline.reclaimable.push_row(pg, sl)
        self.stats.device_hits += len(rp_pages)
        return len(rp_pages)

    def read(self, page: int) -> float:
        """Read (page-in) one page.  Returns critical-path latency (us)."""
        self.step += 1
        if self._health_dirty:
            self._poll_health()
        if self.device is not None:
            # device-tier pre-check: a still-resident demoted page becomes
            # LOCAL here, so the classification below counts a local hit
            self._device_repoint((page,))
        lat = 0.0
        loc = self.gpt.lookup(page)
        if loc.tier == Tier.LOCAL:
            self.stats.local_hits += 1
            lat = self.costs.local_read
        elif loc.tier == Tier.PEER and not self.peers[loc.peer].failed:
            self.stats.remote_hits += 1
            lat = self.costs.remote_read
            if self._peer_lat_extra is not None:
                # heterogeneous peers (PeerProfile): far racks cost more
                lat += self._peer_lat_extra[loc.peer]
            if self.policy.receiver_side_cpu:
                lat += self.costs.receiver_cpu
            if self._any_suspect and self._peer_suspect[loc.peer]:
                # SUSPECT peer: the op times out and retries with
                # exponential backoff — latency degrades, durability
                # doesn't (the data is still there)
                lat += self._suspect_penalty()
            self._cache_fill(page)
        elif loc.tier == Tier.HOST or page in self.host_pages:
            self.stats.host_hits += 1
            lat = self.costs.host_read
            self._cache_fill(page)
        else:
            self.stats.cold_hits += 1
            lat = self.costs.cold_read
        self.stats.time_us += lat
        self.stats.ops += 1
        return lat

    # -- batched critical path (vectorized orchestration) ------------------------

    def access_batch(self, pages, is_write) -> np.ndarray:
        """Batched page accesses: exact-parity fast path for ``write``/``read``.

        ``pages`` is an int sequence; ``is_write`` is a bool (whole batch is
        one op) or a bool sequence (a mixed trace slice).  Returns the per-op
        critical-path latency array, identical to calling the scalar ops in
        sequence — Stats (counts AND accumulated microseconds) are bitwise
        equal to the scalar loop.

        For local-pool policies (Valet) the whole mixed batch runs through
        the plan-once engine (``_access_pooled``): one snapshot gather plus
        one stable argsort resolve every location and intra-batch dependency
        (read-after-write, duplicate reads after a cache fill) up front,
        then the batch executes as bulk segments separated by inline
        boundary events.  A segment ends where the pool free list (growth
        included) or the staging queue would be overrun; the overrunning op
        replays the exact scalar reclaim / flush-stall schedule inline, and
        only the pages that event invalidated are re-classified — the batch
        is never re-analyzed, which keeps the tight-pool (high eviction
        pressure) regime vectorized.

        Write-through policies run per homogeneous run: reads (which never
        mutate state — there is no local pool to fill) are classified with
        one snapshot gather, and writes go through the bulk placement engine
        (``_place_pages_bulk``) with pre-drawn power-of-two-choices pairs and
        one ``map_remote_batch`` scatter — unless ``batch_reclaim`` is off,
        in which case writes keep the scalar reference loop.
        """
        pages = np.asarray(pages, np.int64)
        n = pages.size
        lats = np.empty(n, np.float64)
        iw = np.broadcast_to(np.asarray(is_write, bool), (n,))
        if self._health_dirty:
            self._poll_health()
        if (self._any_suspect or self._peer_lat_extra is not None) \
                and self.orchestrator is None:
            # degraded mode: the plan-once engine's cost LUT cannot price
            # the per-peer retry/backoff ladder — nor per-peer latency
            # profiles — so faulted/heterogeneous batches replay the
            # scalar ops (the async orchestrator is already per-op and
            # prices both inside read()).  Healthy homogeneous batches
            # never reach this branch — the fast paths stay bitwise intact.
            if self._lease is not None:
                self.coordinator.note_activity(self._lease.cid, n)
            for k in range(n):
                lats[k] = self.write(int(pages[k])) if iw[k] \
                    else self.read(int(pages[k]))
            self.stats.lat.record_many(lats)
            return lats
        if self.device is not None and self.device.shadow:
            # device-tier pre-pass: repoint still-resident demoted pages this
            # batch will read, so the snapshot below classifies them LOCAL
            self._device_repoint(np.unique(pages[~iw]))
        if self._lease is not None:
            # per-container demand signal (§3.4): recently busy containers
            # are reclaimed from last under host pressure.  Accounting only —
            # never changes classification, rng draws, or Stats.
            self.coordinator.note_activity(self._lease.cid, n)
        if self.orchestrator is not None:
            # async mode: ops pin the current epoch; reclaim/flush commit at
            # epoch boundaries inside run_batch (not bitwise-parity — see
            # AsyncOrchestrator / InvariantChecker)
            self.orchestrator.run_batch(pages, iw, lats)
            self.stats.lat.record_many(lats)
            return lats
        if self.policy.use_local_pool:
            self._access_pooled(pages, iw, lats)
            self.stats.lat.record_many(lats)
            return lats
        i = 0
        while i < n:
            j = i + 1
            w = iw[i]
            while j < n and iw[j] == w:
                j += 1
            if w:
                if self.batch_reclaim:
                    lats[i:j] = self._write_run_writethrough(pages[i:j])
                else:
                    for k in range(i, j):
                        lats[k] = self.write(int(pages[k]))
            else:
                lats[i:j] = self._read_run_writethrough(pages[i:j])
            i = j
        self.stats.lat.record_many(lats)
        return lats

    # classification codes, mirroring the scalar read's resolution order
    _CLS_LOCAL, _CLS_REMOTE, _CLS_HOST, _CLS_COLD = 0, 1, 2, 3

    def _snapshot_classes(self, pages: np.ndarray, *,
                          known: bool = False) -> np.ndarray:
        """Vectorized read classification against the current table state.

        Fully gather-based: host-tier membership comes from the dense
        ``_host_mask`` bitmap and peer liveness from the cached
        ``_peer_failed`` vector, so there is no per-page Python in here.
        ``known=True`` skips the page-table growth check (targeted
        re-gathers over pages already resolved this batch)."""
        n = pages.size
        if known:
            l_slot, r_tier, r_peer = self.gpt.lookup_raw_known(pages)
        else:
            l_slot, r_tier, r_peer = self.gpt.lookup_raw(pages)
        is_local = l_slot >= 0
        is_peer = ~is_local & (r_tier == int(Tier.PEER))
        remote_hit = is_peer
        if is_peer.any():
            failed = self._peer_failed
            if failed.any():
                remote_hit = is_peer.copy()
                pi = np.flatnonzero(is_peer)
                remote_hit[pi] = ~failed[r_peer[pi]]
        rest = ~is_local & ~remote_hit
        host_hit = np.zeros(n, bool)
        if rest.any():
            ri = np.flatnonzero(rest)
            if self.host_pages:
                hm = self._host_mask
                pr = pages[ri]
                memb = (pr < hm.shape[0]) \
                    & hm[np.minimum(pr, hm.shape[0] - 1)]
                host_hit[ri] = (r_tier[ri] == int(Tier.HOST)) | memb
            else:
                host_hit[ri] = r_tier[ri] == int(Tier.HOST)
        cls = np.full(n, self._CLS_COLD, np.int8)
        cls[is_local] = self._CLS_LOCAL
        cls[remote_hit] = self._CLS_REMOTE
        cls[host_hit] = self._CLS_HOST
        return cls

    def _classify_scalar(self, pg: int) -> int:
        """Scalar mirror of ``_snapshot_classes`` for one page (targeted
        boundary re-classification): same resolution order — local mapping,
        live-peer remote, host membership (tier or spill dict), cold."""
        gpt = self.gpt
        if gpt._l_slot[pg] >= 0:
            return self._CLS_LOCAL
        t = int(gpt._r_tier[pg])
        if t == int(Tier.PEER) and not self._peer_failed[gpt._r_peer[pg]]:
            return self._CLS_REMOTE
        if t == int(Tier.HOST) or (self.host_pages
                                   and pg in self.host_pages):
            return self._CLS_HOST
        return self._CLS_COLD

    def _cost_lut(self) -> np.ndarray:
        """Per-class cost table; entry 4 is the write cost so a single fancy
        index prices a mixed batch (writes carry class 4 in ``eff``).
        Cached — ``CostModel`` and ``Policy`` are frozen."""
        lut = getattr(self, "_lut_cache", None)
        if lut is None:
            c = self.costs
            rr = c.remote_read
            if self.policy.receiver_side_cpu:
                rr = rr + c.receiver_cpu
            lut = np.array([c.local_read, rr, c.host_read, c.cold_read,
                            c.local_write], np.float64)
            self._lut_cache = lut
        return lut

    @staticmethod
    def _accumulate_time(t: float, costs: np.ndarray) -> float:
        """Left-to-right float accumulation of ``t + c0 + c1 + ...`` — the
        same double-add sequence as the scalar loop's ``time_us += lat``
        (cumsum is sequential in C), so totals stay bitwise identical."""
        tmp = np.empty(costs.size + 1, np.float64)
        tmp[0] = t
        tmp[1:] = costs
        return float(np.add.accumulate(tmp)[-1])

    def _access_pooled(self, pages: np.ndarray, iw: np.ndarray,
                       out_lats: np.ndarray) -> None:
        """Plan-once batch engine for local-pool policies.

        The dependency analysis — one stable argsort by page, the per-page
        group structure, the effective per-op classes and the alloc plan —
        is computed ONCE for the whole batch.  The batch then executes as
        bulk segments separated by *inline boundary events*: a segment is
        sized so its allocations fit the pool (``alloc_prefix_capacity``,
        growth included) and its writes fit the staging queue, and the op
        that would overrun runs through ``_boundary_write`` /
        ``_boundary_fill_read``, which replay the exact scalar schedule
        (same ``_reclaim(pages_per_block)`` sizes, same flush-stall
        accounting, same rng draw order).  After the event, only the pages
        the reclaim/fill invalidated are re-classified (one targeted
        ``lookup_raw`` gather) and their remaining ops re-planned — the
        batch is never re-sorted or re-snapshotted, so ``Stats`` stay
        bitwise identical to the scalar loop at a fraction of the old
        prefix-restart cost under pressure."""
        n = pages.size
        cls = self._snapshot_classes(pages)
        fillable = (cls == self._CLS_REMOTE) | (cls == self._CLS_HOST)
        lut = self._cost_lut()

        if not iw.any() and not fillable.any():
            # pure local/cold reads: no state change, no dependencies —
            # straight group accounting, no per-page work at all
            st = self.stats
            counts4 = np.bincount(cls, minlength=4)
            st.local_hits += int(counts4[0])
            st.cold_hits += int(counts4[3])
            costs = lut[cls]
            st.time_us = self._accumulate_time(st.time_us, costs)
            st.ops += n
            out_lats[:n] = costs
            self.step += n
            return

        # group ops by page (argsort stable ⇒ op order within each group) to
        # resolve dependencies: a read behind a write to the same page is a
        # LOCAL hit; the first read of a remote/host page (with no write
        # before it) cache-fills, turning that page's later reads LOCAL too.
        order = np.argsort(pages, kind="stable")
        pg_s = pages[order]
        iw_s = iw[order]
        new_grp = np.empty(n, bool)
        new_grp[0] = True
        np.not_equal(pg_s[1:], pg_s[:-1], out=new_grp[1:])
        starts = np.flatnonzero(new_grp)
        sizes = np.diff(np.append(starts, n))
        group_pages = pg_s[starts]                 # unique pages, ascending
        cw = np.cumsum(iw_s)                       # writes, cumulative
        wr_before_s = cw - np.repeat(cw[starts] - iw_s[starts], sizes) - iw_s
        cand_s = ~iw_s & (wr_before_s == 0)        # reads seeing table state
        cs = np.cumsum(cand_s)
        first_cand_s = cand_s & \
            (cs - np.repeat(cs[starts] - cand_s[starts], sizes) == 1)
        has_ew = np.empty(n, bool)                 # same-page write earlier
        cand = np.empty(n, bool)
        decider = np.empty(n, bool)                # first such read per page
        has_ew[order] = wr_before_s > 0
        cand[order] = cand_s
        decider[order] = first_cand_s

        fill = decider & fillable
        eff = cls                                  # effective per-op class
        # LOCAL for reads behind a same-page write, and for reads of a
        # remote/host page behind its cache-filling first read; writes carry
        # the sentinel class 4 (prices + counts them in one pass)
        eff[~iw & (has_ew | (cand & ~decider & fillable))] = self._CLS_LOCAL
        eff[iw] = 4
        alloc_mask = iw | fill
        # last op position per group: a boundary event only re-plans groups
        # that still have ops after it (vectorized via this gather)
        glast = order[starts + sizes - 1]
        pages_l = pages.tolist()        # one materialization for the batch

        # running-cumulative bounds: the write cumsum is fixed for the batch
        # (is_write never changes); the alloc cumsum and the hoisted
        # execution arrays below are recomputed only when a boundary event
        # actually re-planned some group (rare)
        cum_wr = np.cumsum(iw)
        total_w = int(cum_wr[-1])
        cum_alloc = np.cumsum(alloc_mask)
        total_a = int(cum_alloc[-1])
        # batch-hoisted execution arrays: every segment takes contiguous
        # slices of these instead of re-deriving them per segment
        alloc_pos = np.flatnonzero(alloc_mask)     # positions of alloc ops
        apages_all = pages[alloc_pos]
        aw_all = iw[alloc_pos]                     # write (vs fill) allocs
        costs_all = lut[eff]                       # per-op latencies

        # boundary-side lookup structures, built lazily on the first
        # boundary (pressure-free batches never pay for them)
        page_group = None
        glast_l = None

        # deferred accounting: Stats counters, the step counter, and the
        # sequential time accumulation for segment-executed ops flush in
        # one pass per scalar interruption (a stall tail reads the live
        # Stats) and once at batch end — executed ops' classes never change
        # (re-plans only touch ops behind the boundary), and concatenated
        # accumulate slices reproduce the per-segment double-add sequence
        # bit for bit
        st = self.stats
        step_base = self.step
        acct = 0
        lat_override: List[Tuple[int, float]] = []

        def flush_acct(upto: int):
            nonlocal acct
            if upto > acct:
                c0, c1, c2, c3, c4 = np.bincount(
                    eff[acct:upto], minlength=5).tolist()
                st.writes += c4
                st.ops += upto - acct
                st.local_hits += c0
                st.remote_hits += c1
                st.host_hits += c2
                st.cold_hits += c3
                st.time_us = self._accumulate_time(
                    st.time_us, costs_all[acct:upto])
                self.step += upto - acct
                acct = upto

        s = 0
        while s < n:
            # segment bound: allocations (writes + fills) must fit what the
            # pool can serve without a reclaim (growth included) and writes
            # must fit the staging queue (no stall may run mid-segment)
            base_a = int(cum_alloc[s - 1]) if s else 0
            need = total_a - base_a
            cap = self.pool.alloc_prefix_capacity(need)
            if cap >= need:
                m = n - s
                pool_bound = False
            else:
                m = int(np.searchsorted(cum_alloc, base_a + cap,
                                        side="right")) - s
                pool_bound = True
            room = self.pipeline.staging_room()
            base_w = int(cum_wr[s - 1]) if s else 0
            staging_bound = False
            if total_w - base_w > room:
                mw = int(np.searchsorted(cum_wr, base_w + room,
                                         side="right")) - s
                if mw < m:
                    m = mw
                    pool_bound = False
                    staging_bound = True
                elif mw == m:
                    staging_bound = True
            if m:
                self._run_segment(pages_l, eff, alloc_mask, alloc_pos,
                                  apages_all, aw_all, step_base, s, m)
                s += m
            if s < n:
                if page_group is None:
                    page_group = {p: g for g, p in
                                  enumerate(group_pages.tolist())}
                    glast_l = glast.tolist()
                if pool_bound and not staging_bound \
                        and self.pool.size >= self.pool.max_pages:
                    # pure pool overrun on a pool pinned at max_pages: the
                    # reclaim replays scalar, the op itself is absorbed into
                    # the next segment
                    s2, replanned = self._boundary_inline(
                        pages_l, iw, eff, alloc_mask, s, lat_override,
                        flush_acct, order, starts, sizes, group_pages,
                        page_group, glast_l)
                    if s2 > s:         # stall tail accounted op s scalar
                        acct = s2
                    s = s2
                else:
                    flush_acct(s)
                    s, replanned = self._boundary_event(
                        pages_l, iw, eff, alloc_mask, s, lat_override,
                        order, starts, sizes, group_pages, page_group,
                        glast_l)
                    acct = s           # the boundary op accounted scalar
                if replanned:
                    cum_alloc = np.cumsum(alloc_mask)
                    total_a = int(cum_alloc[-1])
                    alloc_pos = np.flatnonzero(alloc_mask)
                    apages_all = pages[alloc_pos]
                    aw_all = iw[alloc_pos]
                    costs_all = lut[eff]
        flush_acct(n)
        out_lats[:n] = costs_all
        for idx, lat in lat_override:  # scalar-accounted boundary ops
            out_lats[idx] = lat

    # below this op count a fused scalar replay beats the fixed cost of the
    # ~20 numpy kernels the vectorized segment pays (boundary-to-boundary
    # slivers of a few ops are common under extreme pressure; threshold
    # picked empirically on the pressure_speedup trace)
    _SMALL_SEGMENT = 12

    def _run_segment(self, pages_l, eff, alloc_mask, alloc_pos, apages_all,
                     aw_all, step_base, s, m):
        """Execute one bulk segment [s, s+m) whose allocations are known to
        fit: identical free-stack pops, page-table maps, staging rows and
        §5.2 flags as the scalar op sequence, with one gather/scatter per
        metadata column for the whole segment.  Accounting (Stats, the
        step counter, per-op latencies) is deferred to the caller's
        batch-level flush — bitwise the same totals.

        The segment's alloc set comes as contiguous slices of the hoisted
        batch arrays (two ``searchsorted`` probes, no re-scan); for pools
        pinned at ``max_pages`` (the pressure regime) the commit is fully
        fused — writes and fills land with a single state scatter each
        plus the row appends.  Growable pools replay the scalar growth
        triggers inside ``alloc_batch``."""
        if m <= self._SMALL_SEGMENT:
            return self._run_segment_small(pages_l, eff, alloc_mask,
                                           step_base, s, m)
        e = s + m
        lo = int(np.searchsorted(alloc_pos, s))
        hi = int(np.searchsorted(alloc_pos, e))
        if lo == hi:
            return
        k = hi - lo
        apages = apages_all[lo:hi]
        wmask = aw_all[lo:hi]
        asteps = alloc_pos[lo:hi] + (step_base + 1)
        pool = self.pool
        if pool.size >= pool.max_pages and pool._free_top >= k \
                and self.data_plane is None:
            # fused commit: pop the run off the free stack, scatter every
            # column once (fills go straight to RECLAIMABLE — clean slots),
            # map, stage the writes, queue the fills
            top = pool._free_top - k
            sl = pool._free_arr[top:pool._free_top][::-1].copy()
            pool._free_top = top
            if wmask.all():
                pool.state[sl] = _IN_USE
                fills = False
            else:
                fmask = ~wmask
                pool.state[sl] = np.where(wmask, np.int8(_IN_USE),
                                          np.int8(_RECLAIMABLE))
                fsl = sl[fmask]
                pool.reclaim_flag[fsl] = True
                fills = True
            pool.owner[sl] = apages
            pool.last_step[sl] = asteps
            if pool.size == pool.capacity:
                pool._used += k
            else:
                pool._used += int(np.count_nonzero(sl < pool.size))
            pool.n_alloc_from_pool += k
            # the batch-start snapshot gather already grew the page table
            # over every page in this batch, so the local map is one scatter
            self.gpt.map_local_known(apages, sl)
            if fills:
                wpg = apages[wmask]
                if wpg.size:
                    self.pipeline.stage_rows(wpg, sl[wmask])
                self.pipeline.reclaimable.push_rows(apages[fmask], fsl)
            else:
                self.pipeline.stage_rows(apages, sl)
            return
        slots = np.asarray(
            pool.alloc_batch(apages.tolist(), asteps.tolist(),
                             allow_deficit=True), np.int64)
        self.gpt.map_local_known(apages, slots)
        if wmask.all():
            self.pipeline.stage_rows(apages, slots)
        else:
            wsel = np.flatnonzero(wmask)
            if wsel.size:
                self.pipeline.stage_rows(apages[wsel], slots[wsel])
            # filled slots are clean (a remote copy exists): immediately
            # reclaimable, no send needed — and fresh, so the §5.2
            # deferral gather is skipped
            fsel = np.flatnonzero(~wmask)
            self.pipeline.fill_rows(apages[fsel], slots[fsel])
        if self.data_plane is not None:
            lw_batch = getattr(self.data_plane, "local_write_batch", None)
            if lw_batch is not None:
                # one gather/scatter for the whole alloc run (fills and
                # write allocs alike) instead of one update per page
                lw_batch(apages.tolist(), slots.tolist())
            else:
                for pg, slt in zip(apages.tolist(), slots.tolist()):
                    self.data_plane.local_write(pg, slt)

    def _run_segment_small(self, pages_l, eff, alloc_mask, step_base, s, m):
        """Scalar replay of a tiny segment (a couple of ops between
        adjacent boundaries): the same alloc/stage/fill transitions in op
        order without the fixed cost of the fused path's kernels.
        Accounting is deferred like the vectorized path.

        For a pool that cannot grow (the pressure regime), allocation,
        local mapping, staging and fill bookkeeping fuse into one loop of
        per-slot column writes; growable pools keep the batched sub-calls
        (their growth triggers live inside ``alloc_batch``)."""
        e = s + m
        eff_l = eff[s:e].tolist()
        am_l = alloc_mask[s:e].tolist()
        base = step_base + s
        pool = self.pool

        if pool.size >= pool.max_pages and self.data_plane is None:
            pipeline = self.pipeline
            free_arr = pool._free_arr
            state = pool.state
            owner = pool.owner
            last = pool.last_step
            uflag = pool.update_flag
            rflag = pool.reclaim_flag
            size = pool.size
            used = pool._used
            n_alloc = 0
            l_slot = self.gpt._l_slot
            stq = pipeline.staging
            rq = pipeline.reclaimable
            seq = pipeline._seq
            for kk in range(m):
                if am_l[kk]:
                    c = eff_l[kk]
                    pg = pages_l[s + kk]
                    top = pool._free_top - 1
                    pool._free_top = top
                    slot = int(free_arr[top])
                    owner[slot] = pg
                    last[slot] = base + kk + 1
                    if slot < size:
                        used += 1
                    n_alloc += 1
                    l_slot[pg] = slot
                    if c == 4:
                        state[slot] = _IN_USE
                        pipeline._ensure_page(pg)
                        pend = pipeline._pend
                        prev = pend[pg]
                        if prev >= 0:
                            uflag[prev] = True
                        pend[pg] = slot
                        stq.push_row(seq, pg, slot)
                        seq += 1
                    else:
                        # cache fill: clean slot, immediately reclaimable
                        state[slot] = _RECLAIMABLE
                        rflag[slot] = True
                        rq.push_row(pg, slot)
            pool._used = used
            pool.n_alloc_from_pool += n_alloc
            pipeline._seq = seq
            return
        apages: List[int] = []
        asteps: List[int] = []
        awrite: List[bool] = []
        for kk in range(m):
            if am_l[kk]:
                apages.append(pages_l[s + kk])
                asteps.append(base + kk + 1)
                awrite.append(eff_l[kk] == 4)
        if apages:
            slots = pool.alloc_batch(apages, asteps, allow_deficit=True)
            assert slots is not None
            self.gpt.map_local_batch(np.asarray(apages, np.int64),
                                     np.asarray(slots, np.int64))
            if all(awrite):
                self.pipeline.stage_rows(apages, slots)
            else:
                wpg: List[int] = []
                wsl: List[int] = []
                fpg: List[int] = []
                fsl: List[int] = []
                for pg, slt, w in zip(apages, slots, awrite):
                    if w:
                        wpg.append(pg)
                        wsl.append(slt)
                    else:
                        fpg.append(pg)
                        fsl.append(slt)
                if wpg:
                    self.pipeline.stage_rows(wpg, wsl)
                self.pipeline.complete_fill_batch(fpg, fsl)
            if self.data_plane is not None:
                lw_batch = getattr(self.data_plane, "local_write_batch",
                                   None)
                if lw_batch is not None:
                    lw_batch(apages, slots)
                else:
                    for pg, slt in zip(apages, slots):
                        self.data_plane.local_write(pg, slt)

    def _boundary_event(self, pages_l, iw, eff, alloc_mask, m, lat_override,
                        order, starts, sizes, group_pages, page_group,
                        glast_l) -> Tuple[int, bool]:
        """Inline boundary event at batch position ``m``: run the one op
        that would overrun pool/staging through the exact scalar schedule
        (reclaim sizes, flush-stall accounting, rng draws), then re-plan
        ONLY the ops invalidated by it via one targeted gather.

        Invalidated means: pages whose local mappings the event's reclaims
        dropped, plus the op's own page when the op FAILED (a host spill or
        an unfilled read).  A successful boundary write/fill lands its page
        LOCAL, which is exactly what the plan already encodes for the ops
        behind it, so the common case re-plans nothing at all — the
        ``page_group``/``glast_l`` probes keep only invalidated pages that
        are in this batch AND still have ops behind the boundary (under
        pressure that is almost always nobody: reclaim victims are old
        flushed pages, rarely re-read within the same batch).  Returns
        ``(m + 1, whether any group was re-planned)``."""
        pg = pages_l[m]
        self._unmap_log = unmapped = []
        if iw[m]:
            lat, ok = self._boundary_write(pg)
        else:
            lat, ok = self._boundary_fill_read(pg, int(eff[m]))
        lat_override.append((m, lat))
        self._unmap_log = None
        replanned = self._replan_after_boundary(
            unmapped, None if ok else pg, m, False, iw, eff, alloc_mask,
            order, starts, sizes, group_pages, page_group, glast_l)
        return m + 1, replanned

    def _boundary_inline(self, pages_l, iw, eff, alloc_mask, m, lat_override,
                         flush_acct, order, starts, sizes, group_pages,
                         page_group, glast_l) -> Tuple[int, bool]:
        """Pool-overrun boundary for pools pinned at ``max_pages``: replay
        the scalar schedule's side effects — the failed alloc probe (whose
        only effect is the ``n_alloc_failed`` counter: ``maybe_grow`` is
        provably futile at max and short-circuits) and the
        ``_reclaim(pages_per_block)`` burst — then ABSORB the overrunning
        op into the next segment instead of replaying it scalar.  The
        scalar retry would pop exactly the slot the next segment's bulk
        alloc pops first, so the op's transitions vectorize with its
        successors: same free-stack order, same staging row and seq, same
        step/latency accounting sequence.  When the reclaim frees nothing
        the op must stall (write: synchronous flush) or stay unfilled
        (read) — those rare paths replay the remaining scalar schedule via
        the stall tails.  Returns ``(next index, replanned)``; next index
        is ``m`` itself when the op was absorbed."""
        pool = self.pool
        pool.n_alloc_failed += 1       # the alloc attempt on an empty list
        self._unmap_log = unmapped = []
        self._reclaim(max(1, self.pages_per_block))
        absorbed = pool._free_top > 0
        ok = True
        if not absorbed:
            # the stall tail reads live Stats/step: settle the deferred
            # accounting through op m first
            flush_acct(m)
            if iw[m]:
                lat, ok = self._boundary_write_stall(pages_l[m])
            else:
                lat, ok = self._boundary_fill_miss(int(eff[m]))
            lat_override.append((m, lat))
        self._unmap_log = None
        replanned = self._replan_after_boundary(
            unmapped, None if ok else pages_l[m], m, absorbed, iw,
            eff, alloc_mask, order, starts, sizes, group_pages, page_group,
            glast_l)
        return (m if absorbed else m + 1), replanned

    def _replan_after_boundary(self, unmapped, fail_pg, m, include_m, iw,
                               eff, alloc_mask, order, starts, sizes,
                               group_pages, page_group, glast_l) -> bool:
        """Re-plan ONLY the pages a boundary event invalidated: pages whose
        local mappings its reclaims dropped, plus the op's own page when
        the op FAILED (a host spill or an unfilled read).  A successful
        boundary write/fill lands its page LOCAL — exactly what the plan
        already encodes for the ops behind it — so the common case re-plans
        nothing; the ``page_group``/``glast_l`` probes keep only pages that
        are in this batch AND still have ops behind the boundary.

        ``include_m`` is True for absorbed boundaries: op ``m`` has NOT
        executed yet (it runs as the next segment's first op), so it is
        part of the remaining window — an absorbed boundary write whose
        page's OLD slot the reclaim just unmapped must stay the group's
        first remaining op, keeping the reads behind it LOCAL."""
        groups = set()
        for arr in unmapped:            # lists of plain ints (see _reclaim)
            for p in arr:
                g = page_group.get(p)
                if g is not None and glast_l[g] > m:
                    groups.add(g)
        if fail_pg is not None:
            g = page_group.get(fail_pg)
            if g is not None and glast_l[g] > m:
                groups.add(g)
        if not groups:
            return False
        side = "left" if include_m else "right"
        todo = []
        for g in sorted(groups):
            ops = order[starts[g]: starts[g] + sizes[g]]
            lo = int(np.searchsorted(ops, m, side=side))
            if lo < ops.size:
                todo.append((int(group_pages[g]), ops[lo:]))
        if not todo:
            return False
        if len(todo) <= 4:
            # a boundary invalidates a handful of pages at most: per-page
            # scalar resolution beats the vector gather's fixed cost
            cls_new = [self._classify_scalar(p) for p, _ in todo]
        else:
            cls_new = self._snapshot_classes(
                np.fromiter((t[0] for t in todo), np.int64, len(todo)),
                known=True).tolist()
        local_c = np.int8(self._CLS_LOCAL)
        for (_, K), c in zip(todo, cls_new):
            iwK = iw[K]
            effK = np.where(iwK, np.int8(4), local_c)
            allocK = iwK.copy()
            if c != self._CLS_LOCAL:
                # reads before the first remaining write see class ``c``; a
                # fillable class cache-fills on the FIRST such read (its
                # later duplicates go LOCAL), COLD never fills
                nw = np.flatnonzero(iwK)
                stop = int(nw[0]) if nw.size else K.size
                rd = np.flatnonzero(~iwK[:stop])
                if rd.size:
                    if c == self._CLS_COLD:
                        effK[rd] = np.int8(c)
                    else:
                        effK[rd[0]] = np.int8(c)
                        allocK[rd[0]] = True
            eff[K] = effK
            alloc_mask[K] = allocK
        return True

    def _boundary_write(self, pg: int) -> Tuple[float, bool]:
        """The scalar ``write`` schedule for one boundary op, inlined:
        staged-write attempt, pointer-move reclaim, synchronous flush stall,
        host spill — byte-for-byte the reference sequence.  Returns
        ``(latency, staged ok)``."""
        self.step += 1
        st = self.stats
        st.writes += 1
        lat = 0.0
        ws = self.pipeline.write((pg,), self.step)
        if ws is None:
            # pool exhausted: reclaim from reclaimable queue (pointer move)
            self._reclaim(max(1, self.pages_per_block))
            ws = self.pipeline.write((pg,), self.step)
        if ws is None:
            # still nothing reclaimable: must flush synchronously (stall)
            lat += self._flush(self.pages_per_block, in_critical_path=True)
            self._reclaim(self.pages_per_block)
            ws = self.pipeline.write((pg,), self.step)
        if ws is not None:
            self.gpt.map_local(pg, ws.slots[0])
            if self.data_plane is not None:
                self.data_plane.local_write(pg, ws.slots[0])
            lat += self.costs.local_write
        else:
            lat += self.costs.cold_write           # total pressure: spill
            self._host_add(pg)
        st.time_us += lat
        st.ops += 1
        return lat, ws is not None

    def _boundary_fill_read(self, pg: int, cls_m: int) -> Tuple[float, bool]:
        """The scalar ``read`` schedule for one boundary fill-read, inlined.
        Boundary reads are remote/host hits by construction (only
        cache-filling reads allocate), so the hit class comes from the
        plan instead of a fresh table lookup; the cache-fill replays the
        scalar alloc/reclaim sequence exactly.  Returns
        ``(latency, filled ok)``."""
        self.step += 1
        st = self.stats
        if cls_m == self._CLS_REMOTE:
            st.remote_hits += 1
        else:
            st.host_hits += 1
        lat = float(self._cost_lut()[cls_m])
        # _cache_fill, inlined (the filled slot is clean: a remote copy
        # exists, so it is immediately reclaimable without a send)
        slot = self.pool.alloc(pg, self.step)
        if slot is None:
            self._reclaim(max(self.pages_per_block, 1))
            slot = self.pool.alloc(pg, self.step)
        if slot is not None:
            self.gpt.map_local(pg, slot)
            if self.data_plane is not None:
                self.data_plane.local_write(pg, slot)
            self.pool.mark_reclaimable(slot)
            self.pipeline.reclaimable.push_row(pg, slot)
        st.time_us += lat
        st.ops += 1
        return lat, slot is not None

    def _boundary_write_stall(self, pg: int) -> Tuple[float, bool]:
        """Scalar tail of an absorbed-boundary write whose reclaim freed
        nothing: the post-reclaim alloc probe fails too, then the
        synchronous flush stall + reclaim + final attempt — byte-for-byte
        the reference sequence from that point.  (The scalar ``write``
        bumps the step before its alloc attempts; nothing before the flush
        reads it, so bumping here is equivalent.)"""
        self.pool.n_alloc_failed += 1  # the post-reclaim retry found nothing
        self.step += 1
        st = self.stats
        st.writes += 1
        lat = self._flush(self.pages_per_block, in_critical_path=True)
        self._reclaim(self.pages_per_block)
        ws = self.pipeline.write((pg,), self.step)
        if ws is not None:
            self.gpt.map_local(pg, ws.slots[0])
            if self.data_plane is not None:
                self.data_plane.local_write(pg, ws.slots[0])
            lat += self.costs.local_write
        else:
            lat += self.costs.cold_write           # total pressure: spill
            self._host_add(pg)
        st.time_us += lat
        st.ops += 1
        return lat, ws is not None

    def _boundary_fill_miss(self, cls_m: int) -> Tuple[float, bool]:
        """Scalar tail of an absorbed-boundary fill-read whose reclaim
        freed nothing: the retry alloc fails as well, the page stays
        unfilled, and the hit class from the plan is accounted exactly as
        the scalar read would."""
        self.pool.n_alloc_failed += 1  # the post-reclaim retry found nothing
        self.step += 1
        st = self.stats
        if cls_m == self._CLS_REMOTE:
            st.remote_hits += 1
        else:
            st.host_hits += 1
        lat = float(self._cost_lut()[cls_m])
        st.time_us += lat
        st.ops += 1
        return lat, False

    def _read_run_writethrough(self, pages: np.ndarray) -> np.ndarray:
        """All-reads run for pool-less policies: reads never mutate state
        (no pool to cache-fill), so one snapshot classification is exact for
        the whole run, duplicates included."""
        cls = self._snapshot_classes(pages)
        st = self.stats
        counts4 = np.bincount(cls, minlength=4)
        st.local_hits += int(counts4[0])
        st.remote_hits += int(counts4[1])
        st.host_hits += int(counts4[2])
        st.cold_hits += int(counts4[3])
        lats = self._cost_lut()[cls]
        st.time_us = self._accumulate_time(st.time_us, lats)
        st.ops += pages.size
        self.step += pages.size
        return lats

    def _write_run_writethrough(self, pages: np.ndarray) -> np.ndarray:
        """All-writes run for pool-less policies: bulk placement (pre-drawn
        p2c pairs) + one page-table scatter, with per-op latencies and
        Stats bitwise identical to the scalar ``write`` loop."""
        pages_l = pages.tolist()
        tiers, peers_out, slots_out, reps_out, costs = \
            self._place_pages_bulk(pages_l, flush=False)
        self.gpt.map_remote_batch(pages_l, tiers, peers_out, slots_out,
                                  reps_out)
        n = pages.size
        st = self.stats
        st.writes += n
        st.ops += n
        self.step += n
        return np.asarray(costs, np.float64)

    def _cache_fill(self, page: int):
        """Read miss fills the local mempool (it is a cache for remote data,
        §3.2/§3.3; LRU replacement via the reclaimable queue).  The filled
        slot is clean — a remote copy exists — so it is immediately
        reclaimable without a send."""
        if not self.policy.use_local_pool:
            return
        slot = self.pool.alloc(page, self.step)
        if slot is None:
            self._reclaim(max(self.pages_per_block, 1))
            slot = self.pool.alloc(page, self.step)
        if slot is None:
            return
        self.gpt.map_local(page, slot)
        if self.data_plane is not None:
            self.data_plane.local_write(page, slot)
        self.pool.mark_reclaimable(slot)
        self.pipeline.reclaimable.push_row(page, slot)

    # -- background machinery ----------------------------------------------------

    def _reclaim(self, n: int) -> int:
        """Reclaim pool slots; drop local mappings that pointed at them.

        Batched path: one inlined queue drain (``reclaim_bulk``) and one
        gather/scatter drops every stale local mapping — a page freed twice
        in one burst matches at most one of its slots, exactly like the
        sequential check-then-unmap.

        When a plan-once boundary event is active (``_unmap_log`` installed)
        every page whose local mapping is dropped is recorded, so the batch
        engine re-classifies exactly the invalidated pages afterwards."""
        if self.batch_reclaim:
            slots, pages = self.pipeline.reclaim_bulk(n)
            k = int(slots.size)
            if k:
                # a page freed twice in one burst matches at most one of its
                # slots, exactly like the sequential check-then-unmap (freed
                # pages were mapped once, so the growth check is skipped)
                mask = self.gpt.local_slots_known(pages) == slots
                live = pages[mask]
                if live.size:
                    if self.device is not None:
                        # demoted-but-resident: the bytes stay in the FREE
                        # slot until someone allocates it, so remember
                        # (slot, gen) for a zero-copy repoint on re-access
                        lsl = slots[mask]
                        self.device.demote(live.tolist(), lsl.tolist(),
                                           self.pool.gen[lsl].tolist())
                    self.gpt._l_slot[live] = -1
                    if self._unmap_log is not None:
                        self._unmap_log.append(live.tolist())
            return k
        freed = self.pipeline.reclaim(n)
        dropped = [] if self._unmap_log is not None else None
        for slot, pg in freed:
            if self.gpt.local_slot(pg) == slot:
                if self.device is not None:
                    self.device.demote((pg,), (slot,),
                                       (int(self.pool.gen[slot]),))
                self.gpt.unmap_local(pg)
                if dropped is not None:
                    dropped.append(pg)
        if dropped:
            self._unmap_log.append(dropped)
        return len(freed)

    def _reclaim_held(self, n: int, epoch: int, finish_us: float) -> int:
        """Daemon-side reclaim (async engine): identical slot transitions
        and local-mapping drops to the batched ``_reclaim``, except the
        freed slots enter an epoch-tagged pool hold — the foreground cannot
        allocate them until an epoch boundary (or a fence) commits them."""
        slots, pages = self.pipeline.reclaim_bulk_held(n, epoch, finish_us)
        k = int(slots.size)
        if k:
            live = pages[self.gpt.local_slots_known(pages) == slots]
            if live.size:
                self.gpt._l_slot[live] = -1
        return k

    def _flush(self, n: int, in_critical_path: bool = False) -> float:
        """Remote Sender Thread: send staged write-sets to peers.

        Dispatches to the vectorized single-pass placement
        (``_flush_batched``) unless ``batch_reclaim`` is off, in which case
        the scalar per-write-set reference runs — both reach bitwise
        identical state."""
        if self.batch_reclaim:
            return self._flush_batched(n, in_critical_path)
        return self._flush_scalar(n, in_critical_path)

    def _flush_batched(self, n: int, in_critical_path: bool = False) -> float:
        """One bulk placement pass over the whole flush batch: the staged
        rows pop as three column arrays (no WriteSet objects), placement
        runs with pre-drawn p2c pairs, the pool/queue bookkeeping is the
        vectorized ``complete_flush_rows`` and one ``map_remote_batch``
        scatter lands the batch.  Held or multi-page entries (migration
        parks; the generic ``write()`` API) fall back to the WriteSet
        walk — bitwise the same state either way."""
        rows = self.pipeline.take_flush_rows(n)
        if rows is None:
            return self._flush_batched_ws(n, in_critical_path)
        _seqs, parr, sarr = rows
        if not parr.size:
            return 0.0
        pages = parr.tolist()
        tiers, peers_out, slots_out, reps_out, costs = \
            self._place_pages_bulk(pages, flush=True)
        self.pipeline.complete_flush_rows(parr, sarr)
        self.gpt.map_remote_batch(pages, tiers, peers_out, slots_out,
                                  reps_out)
        cost = self._accumulate_time(0.0, np.asarray(costs, np.float64))
        if in_critical_path:
            self.stats.write_stall_us += cost
        # lazy send: cost stays off the critical path (stats untouched) but
        # is returned so the async daemon can charge it to its own clock
        return cost

    def _flush_batched_ws(self, n: int,
                          in_critical_path: bool = False) -> float:
        """WriteSet-walk fallback of ``_flush_batched`` (held/multi-page
        staging entries)."""
        batch = self.pipeline.take_flush_batch(n)
        if not batch:
            return 0.0
        pages = [pg for ws in batch for pg in ws.pages]
        tiers, peers_out, slots_out, reps_out, costs = \
            self._place_pages_bulk(pages, flush=True)
        self.pipeline.complete_flush(batch)
        if pages:
            self.gpt.map_remote_batch(pages, tiers, peers_out, slots_out,
                                      reps_out)
        cost = self._accumulate_time(0.0, np.asarray(costs, np.float64))
        if in_critical_path:
            self.stats.write_stall_us += cost
        return cost                     # lazy: returned for daemon charging

    def _flush_scalar(self, n: int, in_critical_path: bool = False) -> float:
        """Scalar flush reference (per-write-set loop; parity-tested against
        ``_flush_batched``).

        Page-table updates for the whole flush batch are buffered and
        applied with one ``map_remote_batch`` scatter at the end (nothing
        reads the table mid-flush, and last-writer-wins matches sequential
        ``map_remote`` for pages flushed twice in one batch)."""
        cost = 0.0
        mp: List[int] = []
        mt: List[int] = []
        mpe: List[int] = []
        ms: List[int] = []
        mreps: List[Tuple] = []
        peer_tier = int(Tier.PEER)
        host_tier = int(Tier.HOST)

        def send(ws):
            nonlocal cost
            for pg in ws.pages:
                placed = self._place_remote_raw(pg)
                if placed is None:
                    self._host_add(pg)
                    mp.append(pg)
                    mt.append(host_tier)
                    mpe.append(-1)
                    ms.append(-1)
                    mreps.append(())
                    cost += self.costs.host_write
                else:
                    peer, slot, reps = placed
                    mp.append(pg)
                    mt.append(peer_tier)
                    mpe.append(peer)
                    ms.append(slot)
                    mreps.append(reps)
                    cost += self.costs.remote_write

        self.pipeline.flush(n, send)
        if mp:
            self.gpt.map_remote_batch(mp, mt, mpe, ms, mreps)
        if in_critical_path:
            self.stats.write_stall_us += cost
        return cost                     # lazy: returned for daemon charging

    def _report_repair_backlog(self) -> None:
        """Keep the coordinator's degraded-admission signal in sync with
        the repair queue: a non-empty backlog is reported (lease grants
        shed to floor), and the drain-to-empty transition fires
        ``clear_degraded`` exactly once so growth resumes.  Shared by the
        sync tick and the async daemon slice."""
        if self._lease is None:
            return
        if self.repairq:
            note = getattr(self.coordinator, "note_degraded", None)
            if note is not None:
                note(self._lease.cid, len(self.repairq))
                self._degraded_reported = True
        elif self._degraded_reported:
            clear = getattr(self.coordinator, "clear_degraded", None)
            if clear is not None:
                clear(self._lease.cid)
            self._degraded_reported = False

    def background_tick(self, flush_batch: Optional[int] = None):
        """One async maintenance tick: lazy send + pool sizing."""
        if flush_batch is None:
            flush_batch = self.config.flush_batch
        if self.orchestrator is not None:
            # async mode: the daemon owns flush/reclaim scheduling — a tick
            # is just an extra epoch boundary with a raised budget
            self.orchestrator.tick(flush_batch)
            return
        if self.policy.lazy_send:
            self._flush(flush_batch)
        if self.repairq:
            # background re-replication repair, off the critical path
            self._drain_repairs(self.config.repair_rate)
        self._report_repair_backlog()
        if self.policy.dynamic_pool:
            self.pool.shrink_for_pressure()
            # admission throttle while degraded: don't grow the local pool
            # until the repair backlog drains (repairs need peer headroom)
            if not self.repairq:
                self.pool.maybe_grow()
        # reclaim only when pool is tight (use-pool-first otherwise)
        if self.pool.free_count() == 0:
            self._reclaim(flush_batch)

    def drain(self):
        """Flush everything (end of run / checkpoint barrier)."""
        if self.orchestrator is not None:
            self.orchestrator.quiesce()
        while len(self.pipeline.staging):
            self._flush(1 << 12)

    # -- remote pressure: eviction or migration -----------------------------------

    def _peer_block_footprint(self, peer: int) -> int:
        """Victim-candidate MR blocks this container holds on ``peer`` —
        one masked count over the dense per-peer membership columns (live,
        non-replica blocks; replicas only move or die with their primary).
        The coordinator's peer-pressure fan-out uses this to route pressure
        to the containers that actually occupy the pressured peer."""
        if peer < 0 or peer >= len(self.peers):
            return 0
        hi = self._next_block_slot[peer]
        return int(np.count_nonzero(self._blk_live[peer][:hi]
                                    & ~self._blk_replica[peer][:hi]))

    def peer_pressure(self, peer: int, blocks_to_free: int) -> int:
        """A peer's native applications claimed memory; free MR blocks.

        Victim candidates come from one masked ``flatnonzero`` over the
        dense per-peer block-membership columns (slots are allocated
        monotonically and never reused, so ascending slot order equals the
        old dict-scan insertion order).  Replica blocks are skipped as
        victims — they only move or die with their primary (victimizing one
        independently would dangle the primary's replica list and the
        page-table replica tuples)."""
        hi = self._next_block_slot[peer]
        cand_slots = np.flatnonzero(self._blk_live[peer][:hi]
                                    & ~self._blk_replica[peer][:hi])
        if not cand_slots.size:
            return 0
        cand_ids = peer * (1 << 20) + cand_slots    # dense, already ordered
        blk = 1 << 20

        if self.policy.evict_action == "migrate":
            migs = self.migrator.handle_pressure(
                peer, blocks_to_free,
                block_pages=lambda bid: list(
                    self.blocks.get((bid // blk, bid % blk), [])),
                candidate_blocks=cand_ids, step=self.step,
                batched=self.batch_reclaim)
            done = 0
            for mig in migs:
                if mig.phase.name == "DONE":
                    # migrate_block already freed src + repointed pages
                    self._open_block.pop(peer, None)
                    done += 1
                    self.stats.migrations += 1
            return done

        # delete-style eviction (Infiniswap/nbdX): pages fall to backup/cold
        if self.policy.victim == "random":
            victims = select_victims_random(self.rng, cand_ids, blocks_to_free)
        else:
            victims = cand_ids[:blocks_to_free]
        if self.batch_reclaim:
            return self._evict_delete_batched(victims, peer)
        for bid in victims:
            bid = int(bid)
            key = (bid // blk, bid % blk)
            for pg in self.blocks.get(key, []):
                if self.gpt.remote_location(pg) and \
                        self.gpt.remote_location(pg).peer == peer:
                    tier = Tier.COLD if self.policy.cold_backup else Tier.NONE
                    if self.gpt.repoint_replica(pg):
                        pass
                    else:
                        self.gpt.map_remote(pg, Location(tier))
            self._free_block(*key, free_replicas=True)
            self._open_block.pop(peer, None)
            self.stats.evictions += 1
        return len(victims)

    def _evict_delete_batched(self, victims, peer: int) -> int:
        """Delete-style eviction in bulk: one gather classifies every victim
        page, non-replicated pages drop to backup/cold with one
        ``map_remote_batch`` scatter.  Replicated pages (rare on the
        delete-policy baselines, which run replication=0) keep the scalar
        per-occurrence walk — a promoted replica may land back on the
        pressured peer and must be re-checked in order."""
        tier = Tier.COLD if self.policy.cold_backup else Tier.NONE
        blk = 1 << 20
        pages: List[int] = []
        victims = [int(b) for b in victims]
        for bid in victims:
            pages.extend(self.blocks.get((bid // blk, bid % blk), []))
        if pages:
            if self.gpt.has_replicas():
                for pg in pages:
                    if self.gpt.remote_location(pg) and \
                            self.gpt.remote_location(pg).peer == peer:
                        if not self.gpt.repoint_replica(pg):
                            self.gpt.map_remote(pg, Location(tier))
            else:
                parr = np.asarray(pages, np.int64)
                _t, r_peer, _s, mapped = self.gpt.remote_raw_batch(parr)
                hit = parr[mapped & (r_peer == peer)]
                if hit.size:
                    # duplicates are idempotent here (same scatter value)
                    m = hit.size
                    self.gpt.map_remote_batch(hit, [int(tier)] * m,
                                              [-1] * m, [-1] * m, None)
        for bid in victims:
            self._free_block(bid // blk, bid % blk, free_replicas=True)
            self._open_block.pop(peer, None)
            self.stats.evictions += 1
        return len(victims)

    # -- fault handling (core/faults.py; paper §5.1/§5.3, Table 3) -----------------

    def _peer_alive(self, peer: int) -> bool:
        return not bool(self._peer_failed[peer])

    def _suspect_penalty(self) -> float:
        """Price one access against a SUSPECT peer: the op retries
        ``retry_limit`` times with exponential backoff before succeeding
        (the peer is slow, not gone)."""
        self.stats.retries += self.config.retry_limit
        self.stats.retry_wait_us += self._retry_penalty_us
        return self._retry_penalty_us

    def _poll_health(self) -> None:
        """Lazy health poll (runs only while a peer is SUSPECT/REJOINING):
        escalate timed-out suspects to DOWN, activate rejoined peers that
        survived to the next access (REJOINING -> UP)."""
        now = self.stats.time_us
        for p in self.health.expired_suspects(now):
            self.fail_peer(p)
        for p in self.health.rejoining_peers():
            self.health.activate(p, now)
        self._any_suspect = bool(self._peer_suspect.any())
        self._health_dirty = self.health.any_transient()

    def mark_suspect(self, peer: int) -> bool:
        """Transient fault observed (UP -> SUSPECT): every access to the
        peer now pays the retry/backoff ladder and no new block lands
        there, but its data stays readable — latency degrades before
        durability (the paper's replication-first ordering).  Escalates to
        DOWN through ``fail_peer`` once ``suspect_timeout_us`` of simulated
        time passes without a ``clear_suspect``."""
        if self.peers[peer].failed:
            return False
        if not self.health.suspect(peer, now=self.stats.time_us):
            return False
        self._peer_suspect[peer] = True
        self._any_suspect = True
        self._health_dirty = True
        return True

    def clear_suspect(self, peer: int) -> bool:
        """The blip healed (SUSPECT -> UP): penalties stop, placement
        resumes."""
        if not self.health.recover(peer, now=self.stats.time_us):
            return False
        self._peer_suspect[peer] = False
        self._any_suspect = bool(self._peer_suspect.any())
        self._health_dirty = self.health.any_transient()
        return True

    def fail_peer(self, peer: int) -> Tuple[int, int]:
        """Hard peer failure (-> DOWN): the batched recovery sweep.

        Every page on the peer is repointed to its first *live* replica
        (bulk ``map_remote_batch``) or dropped to cold/NONE per the
        Table-3 mode; stale replica tuples referencing the dead peer are
        purged from surviving pages; every MR block the peer held is
        released (its capacity died with it — used returns to 0, and a
        later ``rejoin_peer`` starts empty); and each block left degraded
        — a surviving primary that lost a replica, or a promoted
        ex-replica now holding the only copy — enters the repair queue for
        background re-replication.  Returns ``(recovered, lost)`` page
        counts, bitwise identical between the scalar and batched sweeps."""
        p = self.peers[peer]
        if p.failed:
            return 0, 0
        p.failed = True
        self._peer_failed[peer] = True
        if self._ramp_left[peer] > 0:
            # a crash mid-warm-up ends the ramp (the peer starts over on
            # its next rejoin)
            self._ramp_left[peer] = 0
            self._any_ramp = bool(self._ramp_left.any())
        self.health.down(peer, now=self.stats.time_us)
        if self._peer_suspect[peer]:
            self._peer_suspect[peer] = False
            self._any_suspect = bool(self._peer_suspect.any())
        self._health_dirty = self.health.any_transient()
        cold = (lambda pg: None) if self.policy.cold_backup else None
        sweep = fail_peer_batched if self.batch_reclaim else fail_peer
        recovered, lost = sweep(self.gpt, peer, cold_fetch=cold,
                                peer_alive=self._peer_alive)
        # no surviving page may still carry a replica on the dead peer
        self.gpt.purge_replicas_on_peer(peer)
        # release every MR block the peer held, collecting the blocks the
        # failure degraded: surviving primaries that lost a replica here,
        # and promoted ex-replicas (now sole copies) the free cascade kept
        # because pages still resolve to them
        repair: List[Tuple[int, int]] = []
        hi = self._next_block_slot[peer]
        for s in np.flatnonzero(self._blk_live[peer][:hi]).tolist():
            key = (peer, int(s))
            prim = self._replica_of.get(key)
            reps = tuple(self.block_replicas.get(key, ()))
            self._free_block(peer, int(s), free_replicas=True)
            if prim is not None and prim in self.blocks:
                repair.append(prim)
            for r in reps:
                if r in self.blocks:
                    repair.append(r)
        self._open_block.pop(peer, None)
        p.connected = False            # a rejoin must reconnect
        if self.policy.replication > 0:
            for key in repair:
                self.repairq.push(key)
        return recovered, lost

    def rejoin_peer(self, peer: int) -> bool:
        """A crashed peer came back (DOWN -> REJOINING): its capacity
        returns empty (the crash lost its contents) and placement may use
        it immediately — queued repairs re-replicate onto it on the next
        drain.  The next health poll activates it (REJOINING -> UP)."""
        p = self.peers[peer]
        if not p.failed:
            return False
        if not self.health.rejoin(peer, now=self.stats.time_us):
            return False
        p.failed = False
        self._peer_failed[peer] = False
        self._health_dirty = True
        k = self.config.rejoin_ramp_grants
        if k > 0:
            # warm-up bias: the rejoined peer re-enters placement at a
            # discounted weight, ramping to full over its first k grants
            self._ramp_left[peer] = k
            self._any_ramp = True
        return True

    def _drain_repairs(self, max_pages: int) -> int:
        """Drain the re-replication repair queue (off the critical path).

        Pops degraded primary blocks and places fresh replica blocks via
        the ``ReplicaPlacer`` (DOWN/SUSPECT peers and peers already
        holding a copy excluded) until each is back at
        ``policy.replication`` copies or ``max_pages`` pages were copied
        this round.  A block that cannot be fully repaired — no live peer
        has room — is re-queued and, when nothing at all is placeable,
        the round stops instead of spinning: graceful degradation (the
        store keeps serving from the remaining copies with host/cold
        spill) until a rejoin or eviction changes the topology.  Returns
        pages copied; their cost accrues to ``stats.repair_us``, never
        ``time_us``."""
        R = self.policy.replication
        q = self.repairq
        if R <= 0 or not q:
            return 0
        st = self.stats
        copied = 0
        blocked: List[Tuple[int, int]] = []
        page_cost = self.costs.remote_read + self.costs.remote_write
        susp = self._peer_suspect
        while q and copied < max_pages:
            key = q.pop()
            # the block may have died (eviction / migration / failure) or
            # become a replica itself since it was queued
            if key not in self.blocks or key in self._replica_of \
                    or self.peers[key[0]].failed:
                continue
            reps = tuple(self.block_replicas.get(key, ()))
            deficit = R - len(reps)
            if deficit <= 0:
                q.n_repaired += 1
                continue
            free = [0 if susp[j] else self._ramp_free(j, pr.free())
                    for j, pr in enumerate(self.peers)]
            progressed = False
            for rp in self.placer.place(key[0], free, deficit,
                                        exclude=[r[0] for r in reps]):
                rslot = self._alloc_block_slot(rp)
                if rslot is None:
                    break
                blist = list(self.blocks[key])
                self.blocks[(rp, rslot)] = blist
                self._replica_of[(rp, rslot)] = key
                self._blk_replica[rp][rslot] = True
                reps = reps + ((rp, rslot),)
                self.block_replicas[key] = reps
                self.gpt.add_replica_batch(blist, key, (rp, rslot))
                copied += len(blist)
                st.repair_pages += len(blist)
                st.repair_us += len(blist) * page_cost
                progressed = True
            if len(reps) < R:
                blocked.append(key)
                if not progressed:
                    break
            else:
                q.n_repaired += 1
        for key in blocked:
            q.requeue(key)
        return copied

    def repair_quiesce(self, max_rounds: int = 1 << 10) -> int:
        """Drain the repair queue to empty (or to a stuck under-provisioned
        state: no live peer has room).  Test/benchmark barrier — production
        drains ride the background ticks and the async daemon.  Returns
        pages copied."""
        total = 0
        for _ in range(max_rounds):
            if not self.repairq:
                break
            n = self._drain_repairs(self.config.repair_rate)
            total += n
            if n == 0:
                break
        return total

    # -- local pool pressure (container imbalance, §3.4) ---------------------------

    def local_pressure(self, reclaim_pages: int):
        """Host free memory dropped: shrink pool, reclaiming LRU pages."""
        self._flush(reclaim_pages)
        n = self._reclaim(reclaim_pages)
        self.pool.shrink_for_pressure()
        return n

    def host_donate(self, n_pages: int) -> int:
        """Coordinator-requested donation (§3.4 weighted-fair reclamation).

        The pool can only shed its *tail* slots (the effective size is a
        prefix of the slot array), so donation targets them directly: flush
        everything staged (slots can't leave while they hold the only copy),
        then reclaim the RECLAIMABLE slots inside the shrink window
        out-of-FIFO-order with one masked gather/scatter
        (``ValetMempool.reclaim_window``) — §5.2 safety comes from the slot
        state, not the queue order; their stale queue entries are skipped
        later by the (slot, page) match guard.  Returns pages actually
        donated — fewer than asked when live (IN_USE) data pins the tail."""
        pool = self.pool
        target = max(pool.size - n_pages, pool.min_pages)
        if target >= pool.size:
            return 0
        if self.policy.lazy_send:
            self._flush(len(self.pipeline.staging))
        slots, pgs = self.pipeline.reclaim_window(target, pool.size)
        if pgs.size:
            stale = pgs[self.gpt.local_slots_batch(pgs) == slots]
            if stale.size:
                self.gpt.unmap_local_batch(stale)
        return pool.shrink_by(n_pages)
