"""whisper-large-v3 — encoder-decoder; conv frontend is a STUB.

[arXiv:2212.04356; unverified]  32L d_model=1280 20H (MHA kv=20)
d_ff=5120 vocab=51866.  ``input_specs()`` provides precomputed frame
embeddings (1500 frames) in place of the mel+conv frontend.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-large-v3",
    family="audio",
    n_layers=32,               # decoder depth
    encoder_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab=51_866,
    head_dim=64,
    n_frontend_tokens=1536,    # encoder frames (stub, padded to 512-multiple)
    rope_theta=0.0,            # whisper uses learned/sinusoidal positions
    notes="enc-dec: decoder self-KV paged; cross-KV static per request",
)
