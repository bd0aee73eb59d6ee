"""Orchestration policies: Valet + the paper's comparison systems.

The policy object fixes every decision the paper varies between systems
(§6): local pool or not, lazy vs write-through sending, victim selection,
eviction action, replication, and the per-operation cost profile used by the
trace simulator (benchmarks reproduce Table 1 / Figures 19-23 with these).

Cost profiles: ``PAPER_COSTS`` and ``TPU_COSTS`` are simulated cost
profiles, not measurements of this card.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class CostModel:
    """Per-operation latency in microseconds (one 64KiB-page transaction)."""
    local_write: float        # store into local pool (copy + tree insert)
    local_read: float         # read hit in local pool
    remote_write: float       # one-sided write to a peer
    remote_read: float        # one-sided read from a peer
    host_write: float         # spill to host tier
    host_read: float
    cold_read: float          # disk / recompute analogue
    cold_write: float
    connect: float            # connection establishment (once per peer)
    map_block: float          # map a remote MR block (per block)
    receiver_cpu: float = 0.0 # two-sided receiver involvement (nbdX)


# Paper Table 1 (usec; disk numbers are per ~128KB burst in their setup).
PAPER_COSTS = CostModel(
    local_write=35.31,        # Valet write path total (radix+copy+enqueue)
    local_read=3.5,           # radix 1.39 + copy 2.11
    remote_write=51.35,       # RDMA WRITE
    remote_read=36.48,        # RDMA READ
    host_write=35.31,         # host tier ~ local pool in the paper's model
    host_read=3.5,
    cold_read=20_758.0,       # Disk RD
    cold_write=401_336.0,     # Disk WR
    connect=200_668.0,
    map_block=62_276.0,
    receiver_cpu=15.0,        # nbdX message-pool handling (approx)
)

# A simulated cost profile, not a measurement of this card.
TPU_COSTS = CostModel(
    local_write=2.0,
    local_read=1.0,
    remote_write=3.5,
    remote_read=2.5,
    host_write=14.0,
    host_read=12.0,
    cold_read=2_000.0,
    cold_write=2_000.0,
    connect=1_000.0,
    map_block=200.0,
    receiver_cpu=5.0,
)


@dataclass(frozen=True)
class Policy:
    """A complete orchestration policy (one per compared system)."""
    name: str
    use_local_pool: bool           # host-coordinated mempool in the path
    lazy_send: bool                # writes complete locally, sent async
    victim: str                    # nad | mass | random | none
    evict_action: str              # migrate | delete | none
    replication: int = 0          # extra copies on distinct peers
    cold_backup: bool = False
    write_through: bool = False    # no pool: remote send in critical path
    receiver_side_cpu: bool = False
    dynamic_pool: bool = True      # pool grows/shrinks with free memory
    use_remote: bool = True        # False = conventional OS swap (disk only)


VALET = Policy(
    name="valet", use_local_pool=True, lazy_send=True, victim="nad",
    evict_action="migrate", replication=1)

VALET_MASS = Policy(                     # beyond-paper victim selection
    name="valet-mass", use_local_pool=True, lazy_send=True, victim="mass",
    evict_action="migrate", replication=1)

INFINISWAP = Policy(
    name="infiniswap", use_local_pool=False, lazy_send=False, victim="random",
    evict_action="delete", cold_backup=True, write_through=True)

NBDX = Policy(
    name="nbdx", use_local_pool=False, lazy_send=False, victim="none",
    evict_action="delete", write_through=True, receiver_side_cpu=True)

OS_SWAP = Policy(
    name="os-swap", use_local_pool=False, lazy_send=False, victim="none",
    evict_action="none", write_through=True, cold_backup=True,
    use_remote=False)

POLICIES = {p.name: p for p in (VALET, VALET_MASS, INFINISWAP, NBDX, OS_SWAP)}
