"""h2o-danube-3-4b — llama+mistral mix with sliding-window attention.

[arXiv:2401.16818; unverified]  24L d_model=3840 32H (GQA kv=8)
d_ff=10240 vocab=32000.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="h2o-danube-3-4b",
    family="dense",
    n_layers=24,
    d_model=3840,
    n_heads=32,
    n_kv_heads=8,
    d_ff=10_240,
    vocab=32_000,
    head_dim=120,
    window=4096,           # mistral-style SWA on all layers
    rope_theta=10_000.0,
    notes="SWA bounds decode KV -> long_500k runnable with ring buffers",
)
