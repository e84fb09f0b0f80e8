"""Config registry: ``get(arch_id)`` resolves ``--arch`` names."""
from . import base
from .base import ModelConfig, InputShape, SHAPES

from . import (dbrx_132b, deepseek_v2_236b, gemma3_27b, musicgen_large,
               phi3_mini_3p8b, phi3_vision_4p2b, rwkv6_3b,
               zamba2_1p2b, tdr_graph)

REGISTRY = {
    "phi-3-vision-4.2b": phi3_vision_4p2b.CONFIG,
    "gemma3-27b": gemma3_27b.CONFIG,
    "phi3-mini-3.8b": phi3_mini_3p8b.CONFIG,
    "zamba2-1.2b": zamba2_1p2b.CONFIG,
    "dbrx-132b": dbrx_132b.CONFIG,
    "deepseek-v2-236b": deepseek_v2_236b.CONFIG,
    "musicgen-large": musicgen_large.CONFIG,
    "rwkv6-3b": rwkv6_3b.CONFIG,
}

TDR_GRAPH = tdr_graph.CONFIG


def get(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[name]


def list_archs():
    return sorted(REGISTRY)
