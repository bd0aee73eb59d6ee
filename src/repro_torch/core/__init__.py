"""Valet core for the PyTorch port: the control plane (numpy, the same state
machines as the reference — pool, page table, activity, queues, migration,
replication, faults, coordinators, the tiered page store and its invariant
checker) and the torch KV-pool data plane (``device_ops``)."""
from repro_torch.core.pool import ValetMempool, SlotState
from repro_torch.core.coordinator import (HostMemoryCoordinator, LeaseClient,
                                          ContainerRecord, CoordinatorStats)
from repro_torch.core.queues import (WritePipeline, StagingQueue,
                                     ReclaimableQueue, WriteSet)
from repro_torch.core.page_table import GlobalPageTable, Location, Tier
from repro_torch.core.activity import (ActivityTracker, select_victims_nad,
                                       select_victims_mass,
                                       select_victims_random,
                                       select_victims_topk,
                                       power_of_two_choices)
from repro_torch.core.migration import MigrationEngine, Migration, Phase
from repro_torch.core.replication import (ReplicaPlacer, FaultConfig,
                                          fail_peer, fail_peer_batched)
from repro_torch.core.faults import (HealthState, PeerHealth, RepairQueue,
                                     FaultEvent, FaultInjector,
                                     transient_blip, crash, correlated_crash,
                                     recovery_storm, standard_schedule,
                                     random_schedule, peers_in_domain,
                                     domain_correlated_crash,
                                     domain_recovery_storm, cluster_schedule)
from repro_torch.core.cluster import (ClusterCoordinator, ClusterStats,
                                      ClusterInvariantChecker, HostRecord,
                                      HostState, PeerProfile,
                                      draw_peer_profiles, profile_domains)
from repro_torch.core.policies import (Policy, CostModel, POLICIES, VALET,
                                       VALET_MASS, INFINISWAP, NBDX, OS_SWAP,
                                       PAPER_COSTS, TPU_COSTS)
from repro_torch.core.tiering import TieredPageStore, PeerState, Stats
from repro_torch.core.tiers import PageTier, DeviceTier, HostTier
from repro_torch.core.config import (OrchestrationConfig,
                                     config_from_legacy_kwargs,
                                     LEGACY_STORE_KWARGS, LEGACY_SERVE_KWARGS)
from repro_torch.core.async_engine import AsyncOrchestrator, DaemonClock
from repro_torch.core.invariants import (InvariantChecker, InvariantError,
                                         stats_close, stats_delta)
from repro_torch.core.reservoir import LatencyReservoir, LatencyStatsMixin
from repro_torch.core import device_ops
