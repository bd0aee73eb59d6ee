from repro_torch.optim.adamw import (AdamWConfig, AdamWState, init, update,
                                     reduce_grads, update_sharded, zero1_specs,
                                     schedule, global_norm,
                                     clip_by_global_norm)
