"""qwen2-moe-a2.7b — 4 shared + 60 routed top-4.

[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]  24L d_model=2048 16H (GQA kv=16)
d_ff=1408 vocab=151936.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=151_936,
    head_dim=128,
    moe=MoEConfig(n_experts=60, top_k=4, n_shared=4, d_expert=1408,
                  renorm_topk=True),
    rope_theta=1_000_000.0,
    notes="shared-expert MoE, upcycled from dense",
)
