"""gemma3-4b — dense, 5:1 local:global attention, 128k context.

[hf:google/gemma-3-1b-pt; unverified]  34L d_model=2560 8H (GQA kv=4)
d_ff=10240 vocab=262144.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-4b",
    family="dense",
    n_layers=34,
    d_model=2560,
    n_heads=8,
    n_kv_heads=4,
    d_ff=10_240,
    vocab=262_144,
    head_dim=256,
    window=1024,
    global_every=6,        # every 6th layer is global full-attention
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    notes="5:1 local(sliding-1024):global; huge vocab stresses embedding sharding",
)
