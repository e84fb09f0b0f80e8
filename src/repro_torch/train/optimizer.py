"""AdamW with f32 master weights, global-norm clipping and a warmup then
cosine schedule: a port of ``src/repro/train/optimizer.py`` as plain
tensor functions (``torch.optim.AdamW`` is not this optimizer: it decays
as ``p * (1 - lr * wd)`` before the step and keeps no master copy).

State layout (sharing the params' tree):
    {"master": params_f32, "m": ..., "v": ..., "count": int32 scalar}

``update`` returns the new compute params in the model dtype: bf16
matmuls over f32 master weights and moments.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from .. import pytree


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1
    # dtype for the m/v moments; master weights always stay f32
    moment_dtype: str = "float32"


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup -> cosine decay to min_lr_ratio (an f32 scalar)."""
    step = torch.as_tensor(step).float()
    warm = step / max(1.0, cfg.warmup_steps)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(1.0, cfg.decay_steps - cfg.warmup_steps),
                       0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) \
        * 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init(params: Any, moment_dtype="float32") -> dict:
    md = getattr(torch, moment_dtype)
    leaf = pytree.leaves(params)[0]
    return {
        "master": pytree.tree_map(
            lambda p: p.detach().to(torch.float32, copy=True), params),
        "m": pytree.tree_map(lambda p: torch.zeros_like(p, dtype=md),
                             params),
        "v": pytree.tree_map(lambda p: torch.zeros_like(p, dtype=md),
                             params),
        "count": torch.zeros((), dtype=torch.int32, device=leaf.device),
    }


def global_norm(tree: Any) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(t.float()))
                          for t in pytree.leaves(tree)))


@torch.no_grad()
def update(cfg: AdamWConfig, grads: Any, state: dict,
           compute_dtype) -> tuple[Any, dict, dict]:
    """One AdamW step.  Returns (new_compute_params, new_state, metrics)."""
    count = state["count"] + 1
    lr = schedule(cfg, count)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    b1, b2 = cfg.beta1, cfg.beta2
    c1 = 1 - b1 ** count.float()
    c2 = 1 - b2 ** count.float()
    md = getattr(torch, cfg.moment_dtype)

    def upd(g, m, v, p):
        g = g.float() * scale
        m_new = b1 * m.float() + (1 - b1) * g
        v_new = b2 * v.float() + (1 - b2) * g * g
        step_ = (m_new / c1) / (torch.sqrt(v_new / c2) + cfg.eps)
        p_new = p - lr * (step_ + cfg.weight_decay * p)
        return m_new.to(md), v_new.to(md), p_new

    paths = [n for n, _ in pytree.leaves_with_paths(grads)]
    out = [upd(*leaves) for leaves in zip(
        pytree.leaves(grads), pytree.leaves(state["m"]),
        pytree.leaves(state["v"]), pytree.leaves(state["master"]))]
    new_m, new_v, new_master = (pytree.unflatten(paths, [o[i] for o in out])
                                for i in range(3))
    new_params = pytree.tree_map(lambda p: p.to(compute_dtype), new_master)
    new_state = {"master": new_master, "m": new_m, "v": new_v,
                 "count": count}
    return new_params, new_state, {"lr": lr, "grad_norm": gnorm}
