"""Train step: loss, autograd grads, microbatch accumulation, remat.

A port of ``src/repro/train/train_step.py``.  ``make_train_step(cfg,
opt_cfg, n_microbatches, remat)`` returns ``(state, batch) -> (state,
metrics)``; microbatches accumulate f32 gradients in a loop.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import pytree
from ..bitset import resolve_device
from ..configs.base import ModelConfig
from ..models import forward, layers
from ..models.transformer import model_dtype
from . import optimizer


def loss_fn(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
            media: Optional[torch.Tensor] = None, *, remat: bool = False,
            remat_policy: str = "", rwkv_chunked: bool = False):
    """Next-token CE (+ MoE aux).  tokens [B, S]."""
    logits, aux, _ = forward(cfg, params, tokens, media, remat=remat,
                             remat_policy=remat_policy,
                             rwkv_chunked=rwkv_chunked)
    ce = layers.cross_entropy(logits[:, :-1, :], tokens[:, 1:])
    return ce + aux, {"ce": ce, "aux": aux}


def grads_of(cfg: ModelConfig, params: dict, tokens, media=None, **kw):
    """(loss, metrics, grads): grads share the params' tree and dtypes."""
    paths, leaves = zip(*pytree.leaves_with_paths(params))
    req = [p.detach().requires_grad_(True) for p in leaves]
    loss, metrics = loss_fn(cfg, pytree.unflatten(paths, req), tokens,
                            media, **kw)
    grads = torch.autograd.grad(loss, req, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for g, p in zip(grads, req)]
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            pytree.unflatten(paths, grads))


def make_train_step(cfg: ModelConfig,
                    opt_cfg: optimizer.AdamWConfig = optimizer.AdamWConfig(),
                    *, n_microbatches: int = 1, remat: bool = False,
                    remat_policy: str = "", rwkv_chunked: bool = False):
    compute_dtype = model_dtype(cfg)
    kw = dict(remat=remat, remat_policy=remat_policy,
              rwkv_chunked=rwkv_chunked)

    def train_step(state: dict, batch: dict) -> tuple[dict, dict]:
        params = state["params"]
        tokens = batch["tokens"]
        media = batch.get("media")
        if n_microbatches == 1:
            loss, metrics, grads = grads_of(cfg, params, tokens, media, **kw)
        else:
            mb = tokens.shape[0] // n_microbatches
            grads = pytree.tree_map(
                lambda p: torch.zeros_like(p, dtype=torch.float32), params)
            loss = torch.zeros((), dtype=torch.float32, device=tokens.device)
            for i in range(n_microbatches):
                rows = slice(i * mb, (i + 1) * mb)
                l_i, _, g_i = grads_of(
                    cfg, params, tokens[rows],
                    None if media is None else media[rows], **kw)
                grads = pytree.tree_map(torch.add, grads, g_i)
                loss = loss + l_i
            grads = pytree.tree_map(lambda g: g / n_microbatches, grads)
            loss = loss / n_microbatches
            metrics = {"ce": loss, "aux": torch.zeros_like(loss)}
        new_params, new_opt, opt_metrics = optimizer.update(
            opt_cfg, grads, state["opt"], compute_dtype)
        metrics = dict(metrics, loss=loss, **opt_metrics)
        return {"params": new_params, "opt": new_opt}, metrics

    return train_step


def init_train_state(cfg: ModelConfig, params: dict,
                     opt_cfg: optimizer.AdamWConfig =
                     optimizer.AdamWConfig(), *, device="cuda") -> dict:
    """``{"params", "opt"}`` on ``device`` (default: the card); params
    elsewhere are copied there."""
    dev = resolve_device(device)
    params = pytree.tree_map(lambda p: p.to(dev), params)
    return {"params": params,
            "opt": optimizer.init(params, opt_cfg.moment_dtype)}
