"""Valet core for the PyTorch port: the serving control plane (numpy, the
same state machines as the reference) and the torch KV-pool data plane."""
from repro_torch.core.pool import ValetMempool, SlotState
from repro_torch.core.page_table import GlobalPageTable, Location, Tier
from repro_torch.core.activity import (ActivityTracker, select_victims_nad,
                                       select_victims_mass,
                                       select_victims_random,
                                       select_victims_topk,
                                       power_of_two_choices)
from repro_torch.core.policies import (Policy, CostModel, POLICIES, VALET,
                                       VALET_MASS, INFINISWAP, NBDX, OS_SWAP,
                                       PAPER_COSTS, TPU_COSTS)
from repro_torch.core.tiers import PageTier, DeviceTier, HostTier
from repro_torch.core.config import (OrchestrationConfig,
                                     config_from_legacy_kwargs,
                                     LEGACY_STORE_KWARGS, LEGACY_SERVE_KWARGS)
from repro_torch.core.async_engine import DaemonClock
from repro_torch.core.reservoir import LatencyReservoir, LatencyStatsMixin
from repro_torch.core import device_ops
