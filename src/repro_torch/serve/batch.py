"""DecodeBatch: the serving engine's decode batch on the device (PyTorch).

The engine (``serve/engine.py``) decides which request holds which batch
slot and which pool slots hold its pages; this module holds the caches of
``models/decode.py`` (the paged layers' pools, shared through the block
table, and each slot's own state) and runs the model over them: a prefill
into a slot, a slot's state to the host tier and back, the decode step.  A
step has fixed shapes, so on the card it is one CUDA graph, captured at the
first step and replayed at every later one; on the CPU it runs eagerly.

A prefill (B=1) on the card is padded to its bucket, the next multiple of
``GRANULE`` tokens up to the engine's longest sequence, and replayed as
that bucket's CUDA graph: the bucket's first prefill runs eagerly, then
the bucket is captured.  The graphs read one device buffer of inputs
(length, slot, block-table row, tokens), write the shared pools, one
static set of B=1 caches (rings, SSM state) and a static logits row, and
copy the B=1 state into the slot on the card.  What the padded prefill
does not cover (``models.decode.pads_exactly``), a prompt past the largest
bucket and the CPU take the unpadded prefill, eagerly.

The dropless MoE's counts (``moe.tally``) come to the host in the copy of
the next ``readback``'s tokens, with no other wait.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import device_ops as dev
from repro_torch.core import spans
from repro_torch.kernels import cuda_lib
from repro_torch.models import decode as D
from repro_torch.models import moe as moe_lib
from repro_torch.models.transformer import ParallelCtx


GRANULE = 256       # tokens: a prefill bucket's multiple (16 pages of 16)


def slot_tensors(caches) -> List[torch.Tensor]:
    """The tensors of ``caches`` that hold a row per batch slot, layer by
    layer: the ring's K and V, then the SSM state's ``h`` and ``conv``."""
    out = []
    for c in caches["layers"]:
        if "ring" in c:
            out += [c["ring"].k, c["ring"].v]
        if "ssm" in c:
            out += [c["ssm"]["h"], c["ssm"]["conv"]]
    return out


def slot_state(caches, slot: int) -> List[torch.Tensor]:
    """Batch slot ``slot``'s own tensors in ``caches``: its row of each of
    ``slot_tensors``."""
    return [t[slot] for t in slot_tensors(caches)]


class SlotBlob(NamedTuple):
    """A slot's state in the host tier, its length and its bytes."""
    tensors: List[torch.Tensor]
    length: int
    nbytes: int


class PrefillGraph(NamedTuple):
    """A bucket's captured prefill and its MoE calls' counts."""
    graph: "torch.cuda.CUDAGraph"
    counts: List[torch.Tensor]


class DecodeBatch:
    def __init__(self, params, cfg: ArchConfig, ctx: ParallelCtx, stats, *,
                 max_batch: int, max_pages: int, pool_slots: int, page: int,
                 device: torch.device):
        self.params, self.cfg, self.ctx = params, cfg, ctx
        self.stats = stats               # the engine's EngineStats
        self.page, self.device = page, device
        self.max_pages = max_pages
        self.infos = D.layer_infos(cfg)
        self.paged_layers = [i for i, inf in enumerate(self.infos) if inf.uses_paged]
        self.caches = D.init_caches(cfg, max_batch, pool_slots=pool_slots, page=page,
                                    device=device)
        # MoE calls' counts not read back: (held,), or (calls, held) rows
        self._counts: List[torch.Tensor] = []
        # the prefill's B=1 caches, reused by every prefill: the batch's
        # pools, and one slot of ring and SSM state
        self._one = D.init_caches(cfg, 1, pool_slots=0, page=page, device=device)
        for c, bc in zip(self._one["layers"], self.caches["layers"]):
            if "pool" in c:
                c["pool"] = bc["pool"]
        # the padded prefill: its buckets' graphs in one memory pool, their
        # inputs in one buffer (length, slot, block-table row, tokens),
        # staged from a host one (pinned on the card), and their logits row
        self._pads = D.pads_exactly(cfg)
        n_in = 2 + max_pages + max_pages * page
        self._prefill_host = torch.zeros(n_in, dtype=torch.int64,
                                         pin_memory=device.type == "cuda")
        self._prefill_in = torch.zeros(n_in, dtype=torch.int64, device=device)
        self._staged = torch.cuda.Event() if device.type == "cuda" else None
        self._plogits: Optional[torch.Tensor] = None
        self._pgraphs: Dict[int, PrefillGraph] = {}
        self._ppool = None
        # the step's inputs (tokens, block table, append slot and offset,
        # active mask): host buffers (pinned on the card) whose numpy views
        # ``inputs`` the engine fills, and the device buffers the step reads
        shapes = [((max_batch,), torch.int64),
                  ((max_batch, max_pages), torch.int32),
                  ((max_batch,), torch.int32), ((max_batch,), torch.int32),
                  ((max_batch,), torch.bool)]
        self._host = [torch.zeros(s, dtype=d, pin_memory=device.type == "cuda")
                      for s, d in shapes]
        self.inputs = tuple(t.numpy() for t in self._host)
        self._in = [torch.zeros(s, dtype=d, device=device) for s, d in shapes]
        # the step's CUDA graph, its next tokens and its MoE calls' counts
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._graph_next: Optional[torch.Tensor] = None
        self._graph_counts: List[torch.Tensor] = []

    def kv_pools(self) -> List[torch.Tensor]:
        """The paged layers' pools in the host arena's row order: layer by
        layer, K then V."""
        return [t for li in self.paged_layers
                for t in self.caches["layers"][li]["pool"]]

    def bucket(self, n: int) -> Optional[int]:
        """The padded length a prefill of ``n`` tokens takes: the next
        multiple of ``GRANULE``, if the block table covers it and the
        padded prefill is exact for the arch; else None (unpadded)."""
        sb = -(-n // GRANULE) * GRANULE
        return sb if self._pads and sb <= self.max_pages * self.page else None

    def prefill(self, tokens: np.ndarray, slot: int, bt_row: np.ndarray) -> torch.Tensor:
        """Prefill one request (B=1) into slot ``slot``: its pages go straight
        into the shared pools through ``bt_row``, its own state is copied
        into the slot.  Returns the logits (on the card, the graphs' logits
        row, which the next prefill overwrites)."""
        n = len(tokens)
        sb = self.bucket(n)
        with spans.span("engine.prefill.issue", n=n):
            if self.device.type != "cuda" or sb is None:
                return self._unpadded(tokens, slot, bt_row)
            self.stage(tokens, slot, bt_row, sb)
            g = self._pgraphs.get(sb)
            if g is None:
                self.padded(sb, self._counts)
                self._capture_prefill(sb)
                return self._plogits
            with spans.span("engine.prefill.replay", n=sb):
                g.graph.replay()
            self.stats.prefill_replays += 1
            if g.counts:
                # out of the graphs' pool before another graph reuses it
                self._counts.append(torch.stack(g.counts))
            return self._plogits

    def _unpadded(self, tokens, slot, bt_row) -> torch.Tensor:
        for c in self._one["layers"]:
            if "ring" in c:          # the prefill writes only the prompt's tail
                c["ring"].k.zero_()
                c["ring"].v.zero_()
        toks, bt = (torch.from_numpy(np.ascontiguousarray(a[None])).to(self.device)
                    for a in (np.asarray(tokens, np.int64), bt_row))
        with moe_lib.tally(self._counts):
            logits, one = D.prefill(self.params, toks, self.cfg, self.ctx, self._one, bt)
        # copy_ casts the prefill's conv ring to the batch dtype
        for dst, src in zip(slot_state(self.caches, slot), slot_state(one, 0)):
            dst.copy_(src)
        self.caches["lengths"][slot] = len(tokens)
        return logits

    def stage(self, tokens, slot: int, bt_row, sb: int) -> None:
        """A padded prefill's inputs into the buffer its graph reads, in one
        copy; the tokens zero-padded to ``sb``."""
        p, n = self.max_pages, 2 + self.max_pages + sb
        if self._staged is not None:
            self._staged.synchronize()  # the last copy out of the host buffer ran
        host = self._prefill_host.numpy()
        host[:2] = len(tokens), slot
        host[2:2 + p] = bt_row
        host[2 + p:2 + p + len(tokens)] = tokens
        host[2 + p + len(tokens):n] = 0
        self._prefill_in[:n].copy_(self._prefill_host[:n], non_blocking=True)
        if self._staged is not None:
            self._staged.record()

    def padded(self, sb: int, counts: List[torch.Tensor]) -> None:
        """The staged prompt's prefill at padded length ``sb`` into its slot:
        logits into the logits row, the slot's state and length copied in
        on the device.  Fixed shapes and no host read: a bucket's graph."""
        p, buf = self.max_pages, self._prefill_in
        length, slot = buf[0:1], buf[1:2]
        with moe_lib.tally(counts):
            logits, one = D.prefill(self.params, buf[2 + p:2 + p + sb][None], self.cfg,
                                    self.ctx, self._one, buf[2:2 + p][None],
                                    length=length)
        if self._plogits is None:       # the eager first prefill, before any capture
            self._plogits = torch.empty_like(logits)
        self._plogits.copy_(logits)
        for dst, src in zip(slot_tensors(self.caches), slot_tensors(one)):
            dst.index_copy_(0, slot, src.to(dst.dtype))
        self.caches["lengths"].index_copy_(0, slot, one["lengths"])

    def _capture_prefill(self, sb: int) -> None:
        """Capture bucket ``sb``'s prefill (after its first ran eagerly).  The
        buckets share one memory pool: a graph's outputs all lie outside it
        (pools, caches, logits row) but its MoE counts, which ``prefill``
        copies out after each replay, so replays may come in any order."""
        if self._ppool is None:
            self._ppool = torch.cuda.graph_pool_handle()
        with spans.span("engine.prefill.capture", n=sb) as sp:
            graph = torch.cuda.CUDAGraph(keep_graph=True)
            counts: List[torch.Tensor] = []
            with torch.cuda.graph(graph, pool=self._ppool):
                self.padded(sb, counts)
            sp.set(cuda_lib.graph_nodes(graph))
            graph.instantiate()
        self._pgraphs[sb] = PrefillGraph(graph, counts)

    def save(self, slot: int) -> SlotBlob:
        """Slot ``slot``'s state to the host tier, behind one
        synchronisation, and its length."""
        hs = dev.to_host_tier_many(slot_state(self.caches, slot))
        return SlotBlob(hs, int(self.caches["lengths"][slot]),
                        sum(h.nbytes for h in hs))

    def load(self, slot: int, blob: SlotBlob) -> None:
        """A saved state back into slot ``slot`` (any slot)."""
        for dst, h in zip(slot_state(self.caches, slot), blob.tensors):
            dst.copy_(dev.from_host_tier(h, dst))
        self.caches["lengths"][slot] = blob.length

    def lengths(self) -> np.ndarray:
        """Every slot's length, in one device-to-host copy."""
        return self.caches["lengths"].cpu().numpy()

    def upload(self) -> None:
        """The filled ``inputs`` into the buffers the step reads (the last
        step's copies are done: its readback waited for them)."""
        for buf, host in zip(self._in, self._host):
            buf.copy_(host, non_blocking=True)

    def issue(self, n: int) -> torch.Tensor:
        """The decode step over the uploaded inputs; returns its next tokens
        (the logits' argmax) on the device.  ``n``: the active rows."""
        if self.device.type != "cuda":
            return self._eager(self._counts)
        if self._graph is None:
            return self._capture(n)
        with spans.span("engine.decode.replay", n=n):
            self._graph.replay()
        self.stats.graph_replays += 1
        self._counts.extend(self._graph_counts)
        return self._graph_next

    def _eager(self, counts: List[torch.Tensor]) -> torch.Tensor:
        toks, bt, app_slot, app_off, act = self._in
        with moe_lib.tally(counts):
            logits, _ = D.decode_step(self.params, self.caches, toks, self.cfg,
                                      self.ctx, bt, app_slot, app_off, active=act)
        return logits.argmax(dim=-1)

    def _capture(self, n: int) -> torch.Tensor:
        """The first step on the card: run eagerly on a side stream, which
        loads every kernel and library handle it uses, then captured (not
        run) over the same buffers.  Returns the eager step's tokens."""
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            nxt = self._eager(self._counts)
        cur.wait_stream(side)
        with spans.span("engine.decode.capture", n=n) as sp:
            graph = torch.cuda.CUDAGraph(keep_graph=True)
            with torch.cuda.graph(graph):
                self._graph_next = self._eager(self._graph_counts)
            sp.set(cuda_lib.graph_nodes(graph))
            graph.instantiate()
        self._graph = graph
        return nxt

    def readback(self, t: torch.Tensor) -> np.ndarray:
        """``t`` (int64, on the device) on the host.  The pending MoE calls'
        counts come in the same copy: into ``EngineStats`` and, per call, the
        span marks ``moe.entries`` and ``moe.groups``."""
        if not self._counts:
            return t.cpu().numpy()
        host = torch.cat([t.reshape(-1), *(c.reshape(-1) for c in self._counts)]).cpu().numpy()
        self._counts.clear()
        for counts in host[t.numel():].reshape(-1, self.cfg.moe.held):
            entries, groups = int(counts.sum()), int(np.count_nonzero(counts))
            self.stats.moe_entries += entries
            self.stats.moe_groups += groups
            spans.mark("moe.entries", n=entries)
            spans.mark("moe.groups", n=groups)
        return host[:t.numel()].reshape(t.shape)
