"""llama-3.2-vision-11b — LM backbone with cross-attention image layers.

[hf:meta-llama/Llama-3.2-11B-Vision; unverified]  40L d_model=4096 32H
(GQA kv=8) d_ff=14336 vocab=128256.  The vision frontend is a STUB:
``input_specs()`` provides precomputed patch embeddings.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14_336,
    vocab=128_256,
    head_dim=128,
    xattn_every=5,             # cross-attention every 5th layer (8 layers)
    n_frontend_tokens=6656,    # 4 tiles x 1601 patches, padded to 512-multiple
    rope_theta=500_000.0,
    notes="cross-attn KV is static per request -> lives in a pinned pool region",
)
