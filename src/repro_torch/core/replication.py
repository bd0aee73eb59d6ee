"""Replication & fault-tolerance semantics (paper §5.1, §5.3, Table 3).

Replication is the default (RDMA replica >> disk backup in the paper's
measurements); disk backup maps to our COLD tier.  The four Table-3 modes:

  replication + backup   : read replica first, cold tier if replica fails
  replication only       : read replica; peer loss survivable up to R-1
  backup only            : read cold tier on peer loss
  neither                : remote data loss on peer failure (caching use)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.activity import power_of_two_choices
from repro_torch.core.page_table import GlobalPageTable, Location, Tier


@dataclass(frozen=True)
class FaultConfig:
    replication: int = 1           # number of EXTRA copies (0 = none)
    cold_backup: bool = False      # disk-backup analogue


class ReplicaPlacer:
    """Choose replica peers distinct from the primary (p2c per replica).

    With ``domains`` set (peer -> failure-domain id, e.g. rack), placement
    is *strictly* cross-domain: a replica never lands in the same failure
    domain as the primary or any earlier copy, so one correlated rack
    failure cannot take out every copy.  When no cross-domain peer has
    room the replica set comes up short — the caller's existing
    short-replica path (repair-queue push) owns convergence, which keeps
    the domain-disjointness invariant unconditional instead of
    "unless we fell back".  ``domains=None`` adds no exclusions and no
    extra rng draws — bitwise-identical placement to the flat placer.
    """

    def __init__(self, rng: Optional[np.random.Generator] = None,
                 domains: Optional[Sequence[int]] = None):
        self.rng = rng or np.random.default_rng(1)
        self.domains = list(domains) if domains is not None else None

    def _domain_peers(self, taken: Sequence[int]) -> List[int]:
        """Every peer sharing a failure domain with any peer in ``taken``."""
        dom = self.domains
        bad = {dom[q] for q in taken if 0 <= q < len(dom)}
        return [p for p, d in enumerate(dom) if d in bad]

    def place(self, primary: int, free_counts: Sequence[int],
              n_replicas: int, *,
              exclude: Sequence[int] = ()) -> List[int]:
        """``exclude`` bars additional peers beyond the primary — the
        repair path passes the peers already holding a copy, so a block
        never gets two replicas on one peer (or, with domains, in one
        failure domain)."""
        chosen: List[int] = []
        base = [primary, *exclude]
        for _ in range(n_replicas):
            ex = base + chosen
            if self.domains is not None:
                ex = ex + self._domain_peers(ex)
            p = power_of_two_choices(free_counts, self.rng, exclude=ex)
            if p is None:
                break
            chosen.append(p)
        return chosen


def fail_peer(gpt: GlobalPageTable, peer: int, *, cold_fetch=None,
              peer_alive=None) -> Tuple[int, int]:
    """Handle a peer failure: repoint pages to replicas, else cold tier.

    The scalar reference sweep (``fail_peer_batched`` is pinned bitwise
    against it).  ``peer_alive`` (optional ``peer -> bool``) keeps a
    correlated failure from promoting a replica on another DOWN peer.
    Returns (recovered_via_replica, lost_or_cold).
    """
    recovered = lost = 0
    for pg in list(gpt.pages_on_peer(peer)):
        if gpt.repoint_replica(pg, alive=peer_alive):
            recovered += 1
        else:
            if cold_fetch is not None:
                cold_fetch(pg)
                gpt.map_remote(pg, Location(Tier.COLD))
            else:
                gpt.drop_remote(pg)
            lost += 1
    return recovered, lost


def fail_peer_batched(gpt: GlobalPageTable, peer: int, *, cold_fetch=None,
                      peer_alive=None) -> Tuple[int, int]:
    """Bulk ``fail_peer``: the recovery-storm hot path.

    One masked ``flatnonzero`` finds every page on the dead peer, the
    replica dict is probed once per page (sparse — only replicated pages
    carry tuples), and the page table is updated with two scatters: one
    ``map_remote_batch`` promotes every recoverable page to its first
    live replica, one ``drop_remote_batch`` (or a COLD remap, per the
    Table-3 mode) clears the lost ones.  Final page-table state and the
    ``(recovered, lost)`` counts are bitwise identical to the scalar
    reference — promotions and drops touch disjoint pages, so the
    scatter order cannot matter.
    """
    mask = (gpt._r_tier == int(Tier.PEER)) & (gpt._r_peer == peer) \
        & gpt._r_mapped
    pages = np.flatnonzero(mask)
    if not pages.size:
        return 0, 0
    rd = gpt._replicas
    peer_t = int(Tier.PEER)
    promote: List[int] = []
    new_peer: List[int] = []
    new_slot: List[int] = []
    new_reps: List[Tuple[Tuple[int, int], ...]] = []
    lost_pages: List[int] = []
    if rd:
        for pg in pages.tolist():
            reps = rd.get(pg)
            if reps:
                if peer_alive is not None:
                    reps = tuple(r for r in reps if peer_alive(r[0]))
                if reps:
                    promote.append(pg)
                    new_peer.append(reps[0][0])
                    new_slot.append(reps[0][1])
                    new_reps.append(reps[1:])
                    continue
            lost_pages.append(pg)
    else:
        lost_pages = pages.tolist()
    if promote:
        gpt.map_remote_batch(promote, [peer_t] * len(promote),
                             new_peer, new_slot, new_reps)
    if lost_pages:
        if cold_fetch is not None:
            for pg in lost_pages:
                cold_fetch(pg)
            m = len(lost_pages)
            gpt.map_remote_batch(lost_pages, [int(Tier.COLD)] * m,
                                 [-1] * m, [-1] * m, None)
        else:
            gpt.drop_remote_batch(lost_pages)
    return len(promote), len(lost_pages)
