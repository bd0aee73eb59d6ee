"""ValetServeEngine — continuous-batching LM serving with Valet-orchestrated
KV memory (PyTorch).

The engine is the paper's sender node in serving clothes:

* the **device page pool** (``ValetMempool``) holds the KV pages of
  *resident* sequences (the paper's local mempool; exact attention requires
  residency);
* when admission/growth needs pages that aren't free, the policy acts:
    - ``valet``: pause the least-active sequence (Non-Activity-Duration over
      its pages) and *demote* its pages (the migration-not-deletion
      principle).  Demotion is a metadata move: the slots return to the free
      list but the KV bytes stay in place, tracked by the **device tier**;
      a background flush secures host copies off the critical path.
    - ``infiniswap``: *delete* a random victim's pages; resuming must
      re-prefill from the prompt (the cold/disk path).
    - ``os-swap``: synchronous spill AND restore in the critical path.
* every page write/read updates activity tags; hit-ratio and latency
  accounting mirror the paper's Stats.

**Zero-restore.**  Because the decode kernel reads KV *through* the block
table (``kernels/paged_attention.py``), restore needs no bulk copy:
``_restore`` repoints block-table entries at pool slots whose bytes survived
preemption untouched (validated against the pool's per-slot generation
counter) and streams only the pages whose slot was reused in the meantime,
all of them moved in one batch (``_stream_in``).  The host copies live in
a ``HostTier`` fed by the background flush; each page's bytes, every paged
layer's K and V together, sit in one slot of a pinned, page-major
``device_ops.HostPageArena``, so that a flush or a stream-in moves whole
pages on the copy engines, issued on the current stream with no wait.
``zero_restore=False`` keeps the legacy bulk spill/restore as the
comparison baseline (and ``os-swap`` / ``infiniswap`` keep their defining
eager/delete behavior either way).

The data plane stays exact: demoted pages come back bit-identically
(repointed bytes never moved; streamed ones round-trip through pinned host
memory), and deleted pages are recomputed by a real re-prefill.

The engine is orchestration only.  The caches, each slot's own state (rings,
SSM state, length), the prefill (on the card one CUDA graph per padded
length), the decode step (one CUDA graph on the card) and the dropless
MoE's counts are the decode batch's
(``serve/batch.py``); the engine fills the step's inputs and keeps each
paused sequence's saved state (``_seq_blobs``) unopened.  The simulated
costs (``costs``, ``sim_time_us``, ``bg_time_us``, ``daemon_us``,
``fence_wait_us`` and the latency reservoirs) are the reference's
simulation; the rest of ``EngineStats`` counts what happened,
``d2h_bytes``/``h2d_bytes`` the bytes moved between the device and the host
tier.  With ``core.spans`` on, each layer of the work records a span
(``engine.*``, ``moe.layer``, ``host_tier.*``).
"""
from __future__ import annotations

import time
import warnings
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import device_ops as dev
from repro_torch.core import spans
from repro_torch.core.activity import ActivityTracker
from repro_torch.core.async_engine import DaemonClock
from repro_torch.core.config import (OrchestrationConfig,
                                     config_from_legacy_kwargs,
                                     LEGACY_SERVE_KWARGS)
from repro_torch.core.page_table import GlobalPageTable, Tier
from repro_torch.core.policies import Policy, CostModel, VALET, TPU_COSTS
from repro_torch.core.pool import ValetMempool
from repro_torch.core.reservoir import LatencyStatsMixin
from repro_torch.core.tiers import DeviceTier, HostTier
from repro_torch.models.transformer import ParallelCtx
from repro_torch.serve.batch import DecodeBatch


@dataclass
class Request:
    rid: int
    prompt: np.ndarray
    max_new: int
    # runtime
    status: str = "waiting"          # waiting | active | paused | done
    slot: int = -1                   # batch slot
    pages: List[int] = field(default_factory=list)   # logical page ids
    tokens_out: List[int] = field(default_factory=list)
    last_active_step: int = 0
    n_recomputes: int = 0
    # admission-to-first-token bookkeeping (simulated us; -1 = not yet).
    submit_us: float = -1.0
    first_token_us: float = -1.0


@dataclass
class EngineStats(LatencyStatsMixin):
    """Serving counters.  The per-step latency and fence-wait reservoirs and
    their percentile accessors come from the shared ``LatencyStatsMixin``."""
    steps: int = 0
    tokens: int = 0
    spilled_pages: int = 0           # pages pushed out of the pool (any mode)
    restored_pages: int = 0          # pages brought back (repoint + stream)
    deleted_pages: int = 0
    recomputes: int = 0
    pauses: int = 0
    sim_time_us: float = 0.0         # critical-path simulated time
    bg_time_us: float = 0.0          # overlapped background traffic
    wall_time_s: float = 0.0
    # async orchestration (all zero in synchronous mode)
    fences: int = 0                  # restores that waited on the daemon
    fence_wait_us: float = 0.0       # simulated wait absorbed by fences
    daemon_us: float = 0.0           # spill traffic charged to the daemon
    # zero-restore breakdown (all zero with zero_restore=False)
    demoted_pages: int = 0           # metadata-only preemptions
    repointed_pages: int = 0         # restores that were pure repoints
    streamed_pages: int = 0          # restores that paid a per-page host read
    flushed_pages: int = 0           # background write-backs to the host tier
    # bytes moved between the device and the host tier (real, not simulated;
    # the port's own: the reference has no such fields)
    d2h_bytes: int = 0               # flushes, forced evictions, spills, blobs
    h2d_bytes: int = 0               # stream-ins and blob write-backs
    # the dropless MoE's work (the port's own; zero on other archs), counted
    # on the device and read back with the tokens
    moe_entries: int = 0             # entries the held experts computed
    moe_groups: int = 0              # held (layer call, expert) groups with rows
    # decode steps replayed as the engine's CUDA graph, and prefills as a
    # bucket's (the port's own; zero off the card)
    graph_replays: int = 0
    prefill_replays: int = 0


class ValetServeEngine:
    def __init__(self, params, cfg: ArchConfig, ctx: ParallelCtx, *,
                 max_batch: int, max_seq: int, page: int = 16,
                 pool_slots: int, min_pool: Optional[int] = None,
                 policy: Policy = VALET, costs: CostModel = TPU_COSTS,
                 step_cost_us: float = 0.0, seed: int = 0,
                 coordinator=None, container_name: Optional[str] = None,
                 container_weight: Optional[float] = None,
                 weight: Optional[float] = None,
                 async_mode: bool = False,
                 zero_restore: bool = True, flush_batch: int = 64,
                 device="cuda"):
        if container_weight is not None:
            warnings.warn(
                "ValetServeEngine(container_weight=...) is deprecated; use "
                "weight=... (or OrchestrationConfig(weight=...) with "
                "ValetServeEngine.from_config())", DeprecationWarning,
                stacklevel=2)
        self.torch_device = torch.device(device)
        self.page = page
        self.max_batch = max_batch
        self.max_pages = (max_seq + page - 1) // page
        self.policy = policy
        self.costs = costs
        self.step_cost_us = step_cost_us
        self.rng = np.random.default_rng(seed)

        self.stats = EngineStats()
        self.batch = DecodeBatch(params, cfg, ctx, self.stats,
                                 max_batch=max_batch, max_pages=self.max_pages,
                                 pool_slots=pool_slots, page=page,
                                 device=self.torch_device)
        # multi-tenant serving (§3.4): K engines register with one
        # HostMemoryCoordinator, each leasing KV-pool pages on demand and
        # donating FREE slots back when a co-located engine is under
        # pressure.  The slot array (the device reservation) stays
        # ``pool_slots``; the *effective* pool size is what gets coordinated.
        self.coordinator = coordinator
        self._lease = None
        # per-container QoS weight (§3.4): a heavier engine claims a larger
        # weighted-fair share of the slab surplus, so coordinator-driven
        # reclamation sheds lighter co-tenants toward their (smaller) fair
        # shares first.  ``weight=`` is the serve-API spelling;
        # ``container_weight`` remains as a deprecated alias.
        if weight is not None:
            self.weight = weight
        elif container_weight is not None:
            self.weight = container_weight
        else:
            self.weight = 1.0
        if coordinator is not None:
            self._lease = coordinator.register(
                min_pages=min_pool or pool_slots, max_pages=pool_slots,
                weight=self.weight, name=container_name)
        self.pool = ValetMempool(
            pool_slots,
            min_pages=min_pool or pool_slots,
            max_pages=pool_slots,
            lease=self._lease)
        if coordinator is not None:
            coordinator.set_donor(self._lease.cid, self._host_donate,
                                  size_fn=lambda: self.pool.size)
        self.gpt = GlobalPageTable()
        self.tracker = ActivityTracker()
        # the KV page store's tiers: the device tier tracks demoted-but-
        # resident pages (bytes still in their released pool slot, validated
        # lazily against the pool's generation counter); the host tier holds
        # the spilled pages the background flush writes back (arena slots)
        self.device = DeviceTier()
        self.arena = dev.HostPageArena()
        self.host = HostTier(release=self.arena.free)
        self._flush_q: deque = deque()   # demoted pages awaiting write-back
        self.flush_batch = flush_batch
        # zero-restore applies to lazy migrate policies (valet/valet-mass);
        # os-swap's eager synchronous spill/restore and infiniswap's delete
        # are those baselines' defining behavior and stay untouched
        self.zero_restore = zero_restore
        self._zero = (bool(zero_restore) and policy.lazy_send
                      and policy.evict_action == "migrate")
        # async orchestration: lazy spill/flush traffic advances the daemon
        # clock instead of ``bg_time_us``, and a restore that needs those
        # bytes FENCES on it.  Synchronous mode (default) is unchanged.
        self.async_mode = async_mode
        self.daemon = DaemonClock()
        self.step_counter = 0
        self._step_index = 0             # step() calls, for the span log
        self._next_page_id = 0
        self._slots_free = list(range(max_batch))
        self._requests: Dict[int, Request] = {}
        self._seq_blobs: Dict[int, Any] = {}     # rid -> DecodeBatch.save

    @classmethod
    def from_config(cls, params, cfg: ArchConfig, ctx: ParallelCtx,
                    config: Optional[OrchestrationConfig] = None,
                    device="cuda", **legacy) -> "ValetServeEngine":
        """Build an engine from the unified ``OrchestrationConfig``.

        ``pool_slots`` (``pool_capacity`` when unset) sizes the KV pool,
        ``min_pool`` its floor; policy/costs/seed/coordinator/weight/
        async_mode/zero_restore/flush_batch carry over directly.  The old
        loose keywords still work as deprecated aliases.  Model-plumbing
        arguments (params, arch, ctx, device) stay explicit."""
        base = config if config is not None else OrchestrationConfig()
        c = config_from_legacy_kwargs(base, legacy, owner="ValetServeEngine",
                                      alias_map=LEGACY_SERVE_KWARGS)
        pool_slots = c.pool_slots if c.pool_slots is not None \
            else c.pool_capacity
        return cls(params, cfg, ctx,
                   max_batch=c.max_batch, max_seq=c.max_seq, page=c.page,
                   pool_slots=pool_slots,
                   min_pool=c.min_pool,
                   policy=c.policy, costs=c.costs,
                   step_cost_us=c.step_cost_us, seed=c.seed,
                   coordinator=c.coordinator,
                   container_name=c.container_name,
                   weight=c.weight,
                   async_mode=c.async_mode,
                   zero_restore=c.zero_restore,
                   flush_batch=c.flush_batch,
                   device=device)

    # --------------------------------------------------------------- paging

    def _pool_pages_to_host(self, pages, slots) -> None:
        """Copy the pages in pool ``slots`` of every paged layer into the
        host arena and put each into the host tier under its logical page
        in ``pages``.  The copies are issued, not waited for."""
        ids = self.arena.store(self.batch.kv_pools(), slots)
        self.stats.d2h_bytes += len(ids) * self.arena.slot_bytes
        for pg, sid in zip(pages, ids):
            self.host.put(pg, sid)

    def _note_allocated(self, slots) -> None:
        """Fresh data is about to land in ``slots``: evict any demoted page
        still shadowed there.  Clean pages (host copy already flushed) just
        lose device residency; dirty ones are copied to the host tier NOW —
        a forced copy charged to the critical path, because the overwrite
        cannot wait for the lazy flush (it is issued on the stream ahead of
        the overwrite, which stream order keeps behind it)."""
        if not self.device.shadow:
            return
        pairs = self.device.evict_slots(slots)
        if not pairs:
            return
        dirty = [(pg, sl) for pg, sl in pairs if pg not in self.host]
        if dirty:
            with spans.span("engine.evict_dirty", n=len(dirty)):
                self._pool_pages_to_host([pg for pg, _ in dirty],
                                         [sl for _, sl in dirty])
            self.stats.sim_time_us += self.costs.host_write * len(dirty)
            self.stats.flushed_pages += len(dirty)
        # every evicted page is host-resident now: retier DEVICE -> HOST
        parr = np.asarray([pg for pg, _ in pairs], np.int64)
        m = int(parr.size)
        self.gpt.map_remote_batch(parr, [int(Tier.HOST)] * m,
                                  [-1] * m, [-1] * m, None)

    def _flush_demoted(self, budget: Optional[int] = None) -> int:
        """Background write-back daemon: secure host copies for up to
        ``budget`` demoted pages (all of them when ``None``).  A flushed
        page becomes *clean* — it keeps device residency (still repointable
        for free) and gains a host copy, so a later slot reuse costs
        nothing.  Charged off the critical path: ``bg_time_us`` in sync
        mode, the daemon clock (+ ``daemon_us``) in async mode."""
        q = self._flush_q
        if not q:
            return 0
        with spans.span("engine.flush") as sp:
            n = len(q) if budget is None else min(int(budget), len(q))
            todo, slots = [], []
            for _ in range(n):
                pg = q.popleft()
                # skip pages that left the device tier (evicted / repointed /
                # freed) or were already flushed by an earlier queue entry
                sl = self.device.slot_of(pg)
                if sl is not None and pg not in self.host:
                    todo.append(pg)
                    slots.append(sl)
            if not todo:
                return 0
            self._pool_pages_to_host(todo, slots)
            sp.set(len(todo))
        m = len(todo)
        self.stats.flushed_pages += m
        cost = self.costs.host_write * m
        if self.async_mode:
            self.daemon.charge(cost, self.stats.sim_time_us)
            self.stats.daemon_us += cost
        else:
            self.stats.bg_time_us += cost
        return m

    def _fence(self) -> float:
        """Wait out the daemon's in-flight write-backs (true data
        dependency before reading host bytes back)."""
        st = self.stats
        wait = self.daemon.wait_for(st.sim_time_us)
        if wait > 0.0:
            st.sim_time_us += wait
            st.fence_wait_us += wait
        st.fences += 1
        st.fence_lat.record(wait)
        return wait

    def _alloc_page(self, req: Request) -> Optional[int]:
        """Allocate one logical page backed by a pool slot (all layers)."""
        pg = self._next_page_id
        slot = self.pool.alloc(pg, self.step_counter)
        if slot is None and self.policy.use_local_pool:
            if self._make_room(1):
                slot = self.pool.alloc(pg, self.step_counter)
        if slot is None:
            return None
        self._note_allocated((slot,))
        self._next_page_id += 1
        self.gpt.map_local(pg, slot)
        self.tracker.on_write([pg], self.step_counter)
        req.pages.append(pg)
        return pg

    def _reserve(self, n: int) -> bool:
        """Secure ``n`` FREE pool slots: grow first (leasing from the
        coordinator when attached — possibly pulling idle co-tenants'
        memory), and only preempt residents when growth is exhausted."""
        return self.pool.ensure_free(n) or self._make_room(n)

    def _host_donate(self, n_pages: int) -> int:
        """Coordinator-requested donation: shed FREE slots back to the
        shared slab (an idle engine's drained sequences are exactly the
        unused memory §3.4 wants to hand to a busy co-tenant).  The shrink
        unbacks FREE slots — exactly where demoted pages keep their bytes —
        so every dirty demoted page is flushed to the host tier first.

        The coordinator calls this in the middle of a co-tenant's lease,
        i.e. inside the co-tenant's ``step()``.  The flush's device-to-host
        copies are issued on the current stream and not waited for: every
        later writer of the shed slots (a co-tenant's prefill or append into
        a slot it leased) and every reader of the arena slots (a stream-in)
        runs on the same stream, after them.  The shrink marks the shed
        slots UNBACKED, so the device tier no longer validates them
        (``free_gen`` is None), and re-backing them later bumps their
        generations: a restore of those pages streams them from their host
        copies and never repoints at a slot whose bytes may have changed.
        An arena slot is not written again until it is freed, and a later
        flush's copy into a freed slot is ordered on the stream after the
        stream-in that read it."""
        self._flush_demoted(None)
        return self.pool.shrink_by(n_pages)

    def _alloc_pages(self, req: Request, n: int) -> bool:
        """Allocate ``n`` logical pages backed by pool slots, in bulk."""
        if n <= 0:
            return True
        if self.pool.free_count() < n and not self._reserve(n):
            return False
        pgs = list(range(self._next_page_id, self._next_page_id + n))
        slots = self.pool.alloc_batch(pgs, [self.step_counter] * n)
        if slots is None:           # cannot happen: free_count checked above
            raise RuntimeError(f"pool refused batch of {n} pages")
        self._note_allocated(slots)
        self._next_page_id += n
        self.gpt.map_local_batch(np.asarray(pgs, np.int64),
                                 np.asarray(slots, np.int64))
        self.tracker.on_write(pgs, self.step_counter)
        req.pages.extend(pgs)
        return True

    def _free_pages(self, req: Request, delete_host=True):
        if req.pages:
            parr = np.asarray(req.pages, np.int64)
            lslots = self.gpt.local_slots_batch(parr)
            mask = lslots >= 0
            if mask.any():
                self.pool.release_batch(lslots[mask].tolist())
                self.gpt.unmap_local_batch(parr[mask])
            self.device.drop(req.pages)
            if delete_host:
                self.host.drop(req.pages)
            self.gpt.drop_remote_batch(parr)
        req.pages = []

    def _make_room(self, n_pages: int) -> bool:
        """Policy-driven preemption to free >= n_pages pool slots."""
        with spans.span("engine.make_room", n=n_pages):
            victims_order = sorted(
                [r for r in self._requests.values() if r.status == "active"],
                key=lambda r: r.last_active_step)
            freed = 0
            while self.pool.free_count() < n_pages and victims_order:
                if self.policy.evict_action == "migrate":
                    victim = victims_order.pop(0)   # NAD: least recently active
                elif self.policy.victim == "random":
                    victim = victims_order.pop(
                        int(self.rng.integers(len(victims_order))))
                else:
                    victim = victims_order.pop(0)
                freed += self._preempt(victim)
            if self._zero and freed:
                # the freed slots are about to be handed out: flush the
                # newly demoted pages now so the reuse finds them clean
                self._flush_demoted(None)
            return self.pool.free_count() >= n_pages

    def _restore(self, req: Request) -> bool:
        """Bring a paused sequence's pages back into the pool.

        Zero-restore mode repoints every page whose old slot is untouched
        and streams only pages whose slot was reused from the host arena,
        in one batch (``_stream_in``).  Legacy mode streams the whole
        sequence the same way.
        Either way the restored bytes are bit-identical."""
        if not req.pages:
            return True
        parr = np.asarray(req.pages, np.int64)
        needed = parr[self.gpt.local_slots_batch(parr) < 0]
        n = int(needed.size)
        if n == 0:
            return True
        if self.pool.free_count() < n:
            if not self._reserve(n):
                return False
        needed_l = needed.tolist()
        if self._zero:
            return self._restore_zero(needed, needed_l, n, req.rid)
        if self.async_mode:
            # a restore is a true data dependency on the spill daemon
            self._fence()
        with spans.span("engine.stream_in", req.rid, n):
            slots = self.pool.alloc_batch(needed_l, [self.step_counter] * n)
            if slots is None:       # cannot happen: free_count checked above
                raise RuntimeError(f"pool refused batch of {n} restore pages")
            self._stream_in(needed_l, slots)
        self.gpt.map_local_batch(needed, np.asarray(slots, np.int64))
        self.gpt.drop_remote_batch(needed)
        self.tracker.on_write(needed_l, self.step_counter)
        self.stats.restored_pages += n
        self.stats.sim_time_us += self.costs.host_read * n
        return True

    def _restore_zero(self, needed: np.ndarray, needed_l: List[int],
                      n: int, rid: int = -1) -> bool:
        """Repoint-first restore (the caller verified ``n`` free slots) of
        request ``rid``'s ``needed`` pages."""
        in_dev = [pg for pg in needed_l if pg in self.device]
        rp_pages, rp_slots, missed = self.device.split(
            in_dev, self.pool.free_gen)
        dset = set(in_dev)
        stream = missed + [pg for pg in needed_l if pg not in dset]
        if rp_pages:
            # zero-copy path: claim the exact old slots back and repoint
            # the block table at them — no data movement, no sim cost
            with spans.span("engine.repoint", rid, len(rp_pages)):
                self.pool.claim_batch(rp_slots, rp_pages, self.step_counter)
                self.gpt.map_local_batch(np.asarray(rp_pages, np.int64),
                                         np.asarray(rp_slots, np.int64))
                # a clean flushed copy goes stale the moment the sequence
                # appends into its partial page again, so drop it
                self.host.drop(rp_pages)
            self.stats.repointed_pages += len(rp_pages)
        if stream:
            if self.async_mode:
                # streamed bytes come from the host tier the flush daemon
                # writes — a true data dependency, so fence on it
                self._fence()
            k = len(stream)
            with spans.span("engine.stream_in", rid, k):
                slots = self.pool.alloc_batch(stream, [self.step_counter] * k)
                if slots is None:   # cannot happen: free_count checked above
                    raise RuntimeError(
                        f"pool refused batch of {k} stream pages")
                self._note_allocated(slots)
                self._stream_in(stream, slots)
                self.gpt.map_local_batch(np.asarray(stream, np.int64),
                                         np.asarray(slots, np.int64))
            self.stats.streamed_pages += k
            self.stats.sim_time_us += self.costs.host_read * k
        self.gpt.drop_remote_batch(needed)
        self.tracker.on_write(needed_l, self.step_counter)
        self.stats.restored_pages += n
        return True

    def _stream_in(self, pages: List[int], slots: List[int]) -> None:
        """Bring ``pages`` back from the host tier into ``slots`` (a
        zero-restore's streamed pages, or a legacy restore's every page):
        their arena slots are popped, in ``pages`` order, and moved into the
        pool slots of every paged layer in one batch (``HostPageArena.load``:
        on the card the copies and one scatter launch per 64 pages), then
        freed.  The bytes are those of one ``device_ops.stream_page`` per
        page and layer."""
        ids = [self.host.pop(pg) for pg in pages]
        self.arena.load(self.batch.kv_pools(), ids, slots)
        self.stats.h2d_bytes += len(ids) * self.arena.slot_bytes

    # ------------------------------------------------------------ scheduling

    def submit(self, prompt: np.ndarray, max_new: int, *,
               submit_us: Optional[float] = None) -> int:
        """Queue a request.  ``submit_us`` overrides the arrival timestamp
        (simulated us; defaults to the current simulated clock)."""
        rid = len(self._requests)
        req = Request(rid, np.asarray(prompt), max_new)
        req.submit_us = (self.stats.sim_time_us if submit_us is None
                         else float(submit_us))
        self._requests[rid] = req
        return rid

    def _pages_for(self, n_tokens: int) -> int:
        return (n_tokens + self.page - 1) // self.page

    def _admit(self, req: Request) -> bool:
        if not self._slots_free:
            return False
        with spans.span("engine.admit", req.rid, len(req.prompt)) as sp:
            need = self._pages_for(len(req.prompt) + 1)
            if self.pool.free_count() < need and not self._reserve(need):
                sp.drop()
                return False
            req.slot = self._slots_free.pop()
            if not self._alloc_pages(req, need):
                raise RuntimeError(f"admit: failed to allocate {need} pages")
            bt = self._block_table_row(req)
            with spans.span("engine.prefill", req.rid, len(req.prompt)):
                logits = self.batch.prefill(req.prompt, req.slot, bt)
                # the prompt's last position yields the first generated token
                req.tokens_out.append(
                    int(self.batch.readback(logits[0].argmax())))
        self.stats.tokens += 1
        self.stats.sim_time_us += self.costs.local_write * need
        if req.first_token_us < 0:
            req.first_token_us = self.stats.sim_time_us
        req.status = "active"
        req.last_active_step = self.step_counter
        if len(req.tokens_out) >= req.max_new:
            req.status = "done"
            self._slots_free.append(req.slot)
            self._free_pages(req)
            req.slot = -1
        return True

    def _resume(self, req: Request) -> bool:
        if not self._slots_free:
            return False
        # a resume that cannot make room is no resume: its span is dropped
        with spans.span("engine.resume", req.rid) as sp:
            if self.policy.evict_action == "delete" or not req.pages:
                # pages were deleted: re-prefill prompt + generated tokens,
                # EXCLUDING the newest one — the next decode step consumes it
                full = np.concatenate(
                    [req.prompt, np.asarray(req.tokens_out[:-1], np.int64)])
                need = self._pages_for(len(full) + 1)
                if self.pool.free_count() < need and not self._reserve(need):
                    sp.drop()
                    return False
                with spans.span("engine.recompute", req.rid, need):
                    req.slot = self._slots_free.pop()
                    if not self._alloc_pages(req, need):
                        raise RuntimeError(
                            f"resume: failed to allocate {need} pages")
                    self.batch.prefill(full, req.slot,
                                       self._block_table_row(req))
                sp.set(need)
                self.stats.recomputes += 1
                self.stats.sim_time_us += self.costs.cold_read * need
                req.status = "active"
                req.last_active_step = self.step_counter
                return True
            restored = self.stats.restored_pages
            if not self._restore(req):
                sp.drop()
                return False
            sp.set(self.stats.restored_pages - restored)
            req.slot = self._slots_free.pop()
            # a slot's own state (rings, SSM state) is the sequence's only
            # while it keeps the slot; after a pause it re-owns a slot, so
            # the state round-trips through a host blob keyed by rid
            blob = self._seq_blobs.pop(req.rid, None)
            if blob is not None:
                self.stats.h2d_bytes += blob.nbytes
                with spans.span("engine.seq_blob.write", req.rid, blob.nbytes):
                    self.batch.load(req.slot, blob)
            req.status = "active"
            req.last_active_step = self.step_counter
            return True

    def _block_table_row(self, req: Request) -> np.ndarray:
        row = np.full((self.max_pages,), -1, np.int32)
        pgs = req.pages[: self.max_pages]
        if pgs:
            row[:len(pgs)] = self.gpt.local_slots_batch(
                np.asarray(pgs, np.int64)).astype(np.int32)
        return row

    # ----------------------------------------------------------------- run

    def step(self, greedy: bool = True) -> bool:
        """One scheduler iteration: admissions + resumes, one background
        flush slice, one batched decode step over the active set.  Returns
        ``False`` once nothing is waiting, paused, or active."""
        k = self._step_index
        self._step_index += 1
        with spans.span("engine.step", n=k, step=k):
            sim_before = self.stats.sim_time_us
            pending = [r for r in self._requests.values()
                       if r.status in ("waiting", "paused")]
            for r in pending:
                if r.status == "waiting":
                    self._admit(r)
                else:
                    self._resume(r)
            # background write-back slice: secure host copies for recently
            # demoted pages while the foreground decodes
            self._flush_demoted(self.flush_batch)
            active = [r for r in self._requests.values()
                      if r.status == "active"]
            if not active:
                # True while something is still pending (deadlock guard: the
                # caller retries, admissions force room next iteration)
                return any(r.status in ("waiting", "paused")
                           for r in self._requests.values())
            with spans.span("engine.decode", n=len(active)):
                self._step_active(active, greedy)
            # one scheduler iteration = one critical-path latency sample
            self.stats.lat.record(self.stats.sim_time_us - sim_before)
            return True

    def run(self, max_steps: int = 10_000, greedy: bool = True):
        """Drive until all requests are done (or max_steps)."""
        t0 = time.monotonic()
        while max_steps > 0 and self.step(greedy):
            max_steps -= 1
        # write back whatever is still demoted (paused survivors) so no
        # spilled byte ever goes uncharged
        self._flush_demoted(None)
        self.stats.wall_time_s += time.monotonic() - t0
        return [r for r in self._requests.values()]

    def _step_active(self, active: List[Request], greedy: bool):
        with spans.span("engine.decode.prep", n=len(active)):
            self.step_counter += 1
            if self._lease is not None:
                # demand signal: busy engines are reclaimed from last (§3.4)
                self.coordinator.note_activity(self._lease.cid, len(active))
            # one device->host transfer for every sequence length this step
            lengths = self.batch.lengths()
            # grow pages where the next token crosses a page boundary
            for r in active:
                pos = int(lengths[r.slot])
                if pos % self.page == 0 \
                        and self._pages_for(pos + 1) > len(r.pages):
                    if self._alloc_page(r) is None:
                        self._preempt(r)
            active = [r for r in active if r.status == "active"]
            if not active:
                return
            toks, bt, app_slot, app_off, act = self.batch.inputs
            bt.fill(-1)
            for a in (toks, app_slot, app_off, act):
                a.fill(0)
            # one batched KV-page table resolution for the whole decode step
            flat_pages = np.concatenate(
                [np.asarray(r.pages[: self.max_pages], np.int64) for r in active])
            flat_slots = self.gpt.local_slots_batch(flat_pages)
            step_pages = []
            off = 0
            for r in active:
                b = r.slot
                npg = min(len(r.pages), self.max_pages)
                bt[b, :npg] = flat_slots[off:off + npg]
                pos = int(lengths[b])
                pidx = pos // self.page
                pg = r.pages[pidx]
                # pidx can pass max_pages when a sequence outgrows the block
                # table; resolve those the scalar way
                app_slot[b] = flat_slots[off + pidx] if pidx < npg \
                    else self.gpt.local_slot(pg)
                app_off[b] = pos % self.page
                toks[b] = (r.tokens_out[-1] if r.tokens_out
                           else r.prompt[-1])
                act[b] = True
                step_pages.append(pg)
                r.last_active_step = self.step_counter
                off += npg
            self.tracker.on_write(step_pages, self.step_counter)
        n = len(active)
        with spans.span("engine.decode.upload", n=n):
            self.batch.upload()
        with spans.span("engine.decode.issue", n=n):
            nxt = self.batch.issue(n)
        with spans.span("engine.decode.readback", n=n):
            nxt = self.batch.readback(nxt)
            self.stats.steps += 1
            self.stats.sim_time_us += self.step_cost_us \
                + self.costs.local_write * n
            for r in active:
                r.tokens_out.append(int(nxt[r.slot]))
                self.stats.tokens += 1
                if len(r.tokens_out) >= r.max_new:
                    r.status = "done"
                    self._slots_free.append(r.slot)
                    self._free_pages(r)
                    r.slot = -1

    def _preempt(self, req: Request) -> int:
        """Pause a sequence: demote (zero-restore), spill (legacy valet /
        os-swap) or delete (infiniswap) its pool pages + save its per-slot
        (ring, SSM) caches."""
        with spans.span("engine.preempt", req.rid, len(req.pages)):
            n = len(req.pages)
            self.stats.pauses += 1
            if req.slot >= 0:
                with spans.span("engine.seq_blob.read", req.rid) as sp:
                    blob = self._seq_blobs[req.rid] = self.batch.save(req.slot)
                    sp.set(blob.nbytes)
                self.stats.d2h_bytes += blob.nbytes
                self._slots_free.append(req.slot)
                req.slot = -1
            if self.policy.evict_action == "delete":
                self._free_pages(req)
                req.status = "paused"
                req.n_recomputes += 1
                self.stats.deleted_pages += n
                self._seq_blobs.pop(req.rid, None)
                return n
            live = np.empty(0, np.int64)
            if req.pages:
                parr = np.asarray(req.pages, np.int64)
                lslots = self.gpt.local_slots_batch(parr)
                mask = lslots >= 0
                live = parr[mask]
                live_slots = lslots[mask]
            if live.size and self._zero:
                # zero-restore demote: a pure metadata move.  The slots
                # return to the free list but the KV bytes stay put,
                # registered with the device tier under the pool's current
                # generation
                m = int(live.size)
                self.device.demote(live.tolist(), live_slots.tolist(),
                                   self.pool.gen[live_slots].tolist())
                self.pool.release_batch(live_slots.tolist())
                self.gpt.unmap_local_batch(live)
                self.gpt.map_remote_batch(live, [int(Tier.DEVICE)] * m,
                                          [-1] * m, live_slots.tolist(), None)
                self._flush_q.extend(live.tolist())
                self.stats.demoted_pages += m
                self.stats.spilled_pages += m
            elif live.size:
                # legacy bulk spill: the pages into the host arena, then
                # grouped release / unmap / remote-map
                self._pool_pages_to_host(live.tolist(), live_slots.tolist())
                self.pool.release_batch(live_slots.tolist())
                self.gpt.unmap_local_batch(live)
                m = int(live.size)
                self.gpt.map_remote_batch(live, [int(Tier.HOST)] * m,
                                          [-1] * m, [-1] * m, None)
                self.stats.spilled_pages += m
                cost = self.costs.host_write * m
                if self.policy.lazy_send:
                    if self.async_mode:
                        # charge the daemon clock: the spill overlaps decode,
                        # but a restore of these pages must fence on it
                        self.daemon.charge(cost, self.stats.sim_time_us)
                        self.stats.daemon_us += cost
                    else:
                        self.stats.bg_time_us += cost
                else:
                    self.stats.sim_time_us += cost
            req.status = "paused"
            return n
