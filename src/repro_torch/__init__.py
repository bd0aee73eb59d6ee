"""PyTorch/CUDA port of the Valet reproduction (orchestration of host and
remote shared memory for memory-intensive workloads, MemSys '20).

It mirrors ``src/repro`` module by module, imports ``torch`` and numpy only,
and runs its entry points on ``cuda`` unless the caller passes
``device="cpu"``.  The hand-written Hopper kernels live in ``csrc/`` and are
built at first use.

* ``OrchestrationConfig`` — one frozen config object for every knob
* ``TieredPageStore`` — the tiered (HBM/peer/host/cold) page store
* ``ValetServeEngine`` — the paged-KV serving engine
* ``HostMemoryCoordinator`` — §3.4 multi-container host memory sharing

Construct stores/engines via ``.from_config(...)``.
"""
from repro_torch.core.config import OrchestrationConfig
from repro_torch.core.coordinator import HostMemoryCoordinator
from repro_torch.core.tiering import TieredPageStore
from repro_torch.serve.engine import ValetServeEngine

__all__ = [
    "OrchestrationConfig",
    "TieredPageStore",
    "ValetServeEngine",
    "HostMemoryCoordinator",
]
