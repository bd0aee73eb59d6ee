from repro_torch.train.trainer import TrainConfig, make_train_step, fit, cast_for_compute
from repro_torch.train.checkpoint import ValetCheckpointer
from repro_torch.train.elastic import ClusterSpec, degraded_mesh_shape, make_recovery_plan
