"""deepseek-moe-16b — fine-grained MoE, 2 shared + 64 routed top-6.

[arXiv:2401.06066; hf]  28L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=102400.  First layer uses a dense FFN (as in the release).
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=102_400,
    head_dim=128,
    moe=MoEConfig(n_experts=64, top_k=6, n_shared=2, d_expert=1408),
    n_dense_layers=1,
    dense_d_ff=10_944,
    rope_theta=10_000.0,
    notes="fine-grained expert segmentation; shared expert isolation",
)
