from repro_torch.optim.adamw import (AdamWConfig, AdamWState, init, update,
                                     schedule, global_norm,
                                     clip_by_global_norm)
