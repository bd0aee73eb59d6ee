from repro_torch.train.trainer import (TrainConfig, cast_for_compute, fit,
                                      make_shardings, make_train_step)
from repro_torch.train.checkpoint import ValetCheckpointer
from repro_torch.train.elastic import ClusterSpec, degraded_mesh_shape, make_recovery_plan
