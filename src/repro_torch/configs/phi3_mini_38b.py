"""phi3-mini-3.8b — dense MHA, RoPE SwiGLU.

[arXiv:2404.14219; unverified]  32L d_model=3072 32H (GQA kv=32)
d_ff=8192 vocab=32064.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="phi3-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=32_064,
    head_dim=96,
    rope_theta=10_000.0,
    notes="pure full attention (MHA)",
)
