"""gemma3-27b [dense] — 5:1 local:global sliding-window, 128k context.
[hf:google/gemma-3-1b-pt; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b", family="dense",
    n_layers=62, d_model=5376, n_heads=32, n_kv_heads=16,
    d_ff=21504, vocab=262144,
    sliding_window=1024, local_per_global=5,
    rope_theta=10_000.0, rope_theta_global=1_000_000.0,
    tie_embeddings=True,
)
