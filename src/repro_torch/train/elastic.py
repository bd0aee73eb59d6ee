"""Elastic scaling & failure handling for the distributed runtime.

Strategy (synchronous SPMD training):

* every N steps the trainer checkpoints asynchronously (ValetCheckpointer);
* on a device/host failure the launcher rebuilds a smaller mesh from the
  survivors (``degraded_mesh``), the data pipeline reshards deterministically
  (``TrainDataset.reshard``), and training resumes from the last snapshot;
* on scale-up the same path runs in reverse.

Straggler mitigation lives at two levels: (a) serving — the Valet control
plane migrates pages *off* pressured peers (activity-based, §3.5), bounding
p99 added latency; (b) training — deterministic data sharding means a
restarted/replaced host recomputes exactly its shard, so the step barrier
never waits on stale state.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple




@dataclass(frozen=True)
class ClusterSpec:
    n_pods: int
    data_parallel: int
    model_parallel: int

    @property
    def n_devices(self):
        return self.n_pods * self.data_parallel * self.model_parallel


def degraded_mesh_shape(spec: ClusterSpec, n_alive: int
                        ) -> Optional[ClusterSpec]:
    """Largest valid mesh after failures.

    Model-parallel degree is fixed (weights are TP-sharded); we shed DP
    replicas (and whole pods) until the mesh fits the surviving devices.
    Returns None if not even one model-parallel group survives.
    """
    mp = spec.model_parallel
    groups_alive = n_alive // mp
    if groups_alive < 1:
        return None
    # prefer keeping pods balanced: shrink dp first, then pods
    for pods in range(spec.n_pods, 0, -1):
        dp = min(spec.data_parallel, groups_alive // pods)
        if dp >= 1:
            return ClusterSpec(pods, dp, mp)
    return None


def reshard_plan(old_shards: int, new_shards: int, step: int
                 ) -> List[Tuple[int, int]]:
    """(new_shard, start_step) assignments after elastic change.

    Data is a pure function of (step, shard, n_shards) so the plan is just
    the new numbering starting at the restore step.
    """
    return [(s, step) for s in range(new_shards)]


def make_recovery_plan(spec: ClusterSpec, alive_devices: Sequence[int],
                       restore_step: int):
    """Full recovery description for the launcher (tested in simulation)."""
    new_spec = degraded_mesh_shape(spec, len(alive_devices))
    if new_spec is None:
        return None
    dp_total = new_spec.n_pods * new_spec.data_parallel
    return {
        "mesh": new_spec,
        "devices_used": list(alive_devices)[: new_spec.n_devices],
        "data_shards": reshard_plan(
            spec.n_pods * spec.data_parallel, dp_total, restore_step),
        "restore_step": restore_step,
    }
