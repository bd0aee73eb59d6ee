"""hymba-1.5b — hybrid-head: parallel attention + mamba heads per layer.

[arXiv:2411.13676; hf]  32L d_model=1600 25H (GQA kv=5) d_ff=5504
vocab=32001 ssm_state=16.  Most layers use sliding-window attention;
layers {0, mid, last} are global (per the paper).
"""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_ff=5504,
    vocab=32_001,
    head_dim=64,
    window=1024,           # SWA layers; global layers tracked separately
    global_every=16,       # layers 15, 31 global (+ layer 0 special-cased)
    ssm=SSMConfig(d_state=16, head_dim=64, expand=2, conv_kernel=4,
                  chunk_size=256, n_groups=1),
    notes="parallel attn+SSM heads, outputs mean-combined after per-branch norm",
)
