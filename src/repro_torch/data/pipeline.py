"""Deterministic, shard-aware, resumable synthetic data pipeline.

A port of ``src/repro/data/pipeline.py``.  Every batch is a pure function
of (seed, step), so resume needs no pipeline state, each data-parallel
shard slices its rows of the same global batch, and a repeated step
reproduces bit-identically.  The tokens come from the port's own
``torch.Generator`` keyed by (seed, step), drawn on the CPU whatever the
device, so they differ from the reference's ``jax.random`` draws by
design; the properties above are the same.

Two tasks:
  * ``lm``    — uniform random tokens (throughput shape stand-in)
  * ``copy``  — the second half of the sequence repeats the first half; a
                small model drives CE toward 0 on it.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..bitset import resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    task: str = "copy"            # "copy" | "lm"
    vocab: int = 512
    seq_len: int = 64
    global_batch: int = 32
    seed: int = 0
    n_media_tokens: int = 0
    d_model: int = 0              # for media stubs


def _generator(*key: int) -> torch.Generator:
    seed = int(np.random.SeedSequence(list(key)).generate_state(
        1, np.uint64)[0])
    return torch.Generator().manual_seed(seed)


def batch_for_step(cfg: DataConfig, step: int,
                   shard: tuple[int, int] = (0, 1), *,
                   device="cuda") -> dict:
    """Batch for ``step`` on ``device`` (default: the card);
    ``shard=(rank, world)`` slices rows."""
    dev = resolve_device(device)
    rank, world = shard
    if cfg.global_batch % world:
        raise ValueError(f"batch {cfg.global_batch} over {world} shards")
    rows = cfg.global_batch // world
    gen = _generator(cfg.seed, step)
    if cfg.task == "lm":
        toks = torch.randint(0, cfg.vocab, (cfg.global_batch, cfg.seq_len),
                             generator=gen, dtype=torch.int32)
    elif cfg.task == "copy":
        half = cfg.seq_len // 2
        first = torch.randint(2, cfg.vocab, (cfg.global_batch, half),
                              generator=gen, dtype=torch.int32)
        toks = torch.cat([first, first], dim=1)
        if toks.shape[1] < cfg.seq_len:
            pad = torch.ones((cfg.global_batch,
                              cfg.seq_len - toks.shape[1]), dtype=torch.int32)
            toks = torch.cat([toks, pad], dim=1)
    else:
        raise ValueError(cfg.task)
    batch = {"tokens": toks[rank * rows:(rank + 1) * rows].to(dev)}
    if cfg.n_media_tokens:
        media = torch.randn(
            (cfg.global_batch, cfg.n_media_tokens, cfg.d_model),
            generator=_generator(cfg.seed, step, 1), dtype=torch.float32)
        batch["media"] = media[rank * rows:(rank + 1) * rows].to(dev)
    return batch
