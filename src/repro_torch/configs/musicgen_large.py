"""musicgen-large [audio] — decoder-only over EnCodec tokens; the EnCodec
frontend is a stub (precomputed frame embeddings). [arXiv:2306.05284; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large", family="audio",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab=2048,
    frontend="audio", n_media_tokens=64,
)
