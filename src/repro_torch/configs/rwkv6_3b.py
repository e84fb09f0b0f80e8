"""rwkv6-3b [ssm] — Finch: attention-free, data-dependent decay.
[arXiv:2404.05892; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b", family="ssm",
    n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40,
    d_ff=8960, vocab=65536,
    block_type="rwkv6", ssm_head_dim=64,
)
