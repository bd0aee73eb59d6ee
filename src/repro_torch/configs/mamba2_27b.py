"""mamba2-2.7b — SSD (state-space duality), attention-free.

[arXiv:2405.21060; unverified]  64L d_model=2560 ssm_state=128.
d_inner = expand*d_model = 5120, head_dim 64 -> 80 SSD heads.
"""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=50_280,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, conv_kernel=4,
                  chunk_size=256, n_groups=1),
    notes="attention-free; Valet KV paging inapplicable (O(1) decode state); "
          "pool reused for SSD chunk-state checkpoints in prefill",
)
