"""LM substrate: model families for the assigned architecture pool.

A port of ``src/repro/models``: plain functions on tensors over param
dicts laid out as the reference's.
"""
from . import attention, layers, model, moe, pspec, ssm, transformer
from .model import decode_step, init_cache, prefill
from .transformer import forward, init_params

__all__ = ["attention", "layers", "model", "moe", "pspec", "ssm",
           "transformer",
           "forward", "init_params", "decode_step", "init_cache", "prefill"]
