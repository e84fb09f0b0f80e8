"""Mixture-of-Experts FFN (dbrx 16e top-4, deepseek-v2 2 shared + 160e top-6).

GShard-style grouped one-hot dispatch, as in ``src/repro/models/moe.py``:
tokens are reshaped into groups of ``group_size``, each group gets a
static per-expert capacity ``C = int(group_size · top_k / E ·
capacity_factor)``, and dispatch/combine are einsums, so expert compute
is top-k-proportional.  A (token, k) choice's slot is its position in a
running count over (token, k) order; choices past ``C`` are dropped.

The router is deterministic: gates are the renormalised top-k softmax
probabilities, plus the switch-style load-balance auxiliary loss.  Top-k
is a stable descending sort, so equal probabilities go to the lower
expert index, as ``jax.lax.top_k`` breaks ties; one flipped choice would
drop a different token.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from . import layers, pspec
from ..configs.base import ModelConfig


def init_moe(gen, cfg: ModelConfig, dtype, lead=()) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff_expert, cfg.n_experts
    lead = tuple(lead)
    tn = layers.truncated_normal
    p = {
        "router": tn(gen, lead + (d, e), d ** -0.5, torch.float32),
        "w_gate": tn(gen, lead + (e, d, f), d ** -0.5, dtype),
        "w_up": tn(gen, lead + (e, d, f), d ** -0.5, dtype),
        "w_down": tn(gen, lead + (e, f, d), f ** -0.5, dtype),
    }
    if cfg.n_shared_experts:
        p["shared"] = layers.init_swiglu(gen, d, cfg.n_shared_experts * f,
                                         dtype, lead)
    return p


def route(router: torch.Tensor, xg: torch.Tensor, k: int):
    """(probs [g, gs, E], top_p, top_i [g, gs, K]) of tokens ``xg``
    [g, gs, D]: f32 softmax of the router logits, the k largest with ties
    to the lower index."""
    probs = torch.softmax(xg.float() @ router, dim=-1)
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    return probs, top_p[..., :k], top_i[..., :k]


def _experts(xe, w_gate, w_up, w_down):
    """Each expert's SwiGLU over its slots: xe [g, E, C, D] -> [g, E, C, D]."""
    h = F.silu(torch.einsum("gecd,edf->gecf", xe, w_gate)) \
        * torch.einsum("gecd,edf->gecf", xe, w_up)
    h = pspec.constrain(h, "batch", "experts", None, None)
    return torch.einsum("gecf,efd->gecd", h, w_down)         # [g, E, C, D]


def moe_forward(p: dict, cfg: ModelConfig, x: torch.Tensor,
                group_size: int = 512) -> tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, D] -> (y [B, S, D], aux_loss scalar)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    t = b * s
    gs = min(group_size, t)
    if t % gs:
        raise ValueError(f"{t} tokens are no multiple of group {gs}")
    g = t // gs
    cap = max(1, int(gs * k / e * cfg.capacity_factor))

    xg = x.reshape(g, gs, d)
    # under a mesh each rank routes its own tokens (DTensor would shard
    # them over the model axis too, and lose the nesting in the backward)
    probs, top_p, top_i = pspec.local(
        functools.partial(route, k=k), p["router"], xg,
        axes=((None, None), (0, 1)), out_axes=((0, 1),) * 3, point="router")
    gates = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)

    # position of each (token, k) selection within its expert's capacity
    sel = F.one_hot(top_i, e)                                # [g, gs, K, E]
    sel_flat = sel.reshape(g, gs * k, e)
    pos = (torch.cumsum(sel_flat, dim=1) - sel_flat).reshape(g, gs, k, e)
    in_cap = (pos < cap) & (sel > 0)
    slot = torch.where(in_cap, pos, cap)                     # cap = dropped

    disp = F.one_hot(slot, cap + 1)[..., :cap].to(x.dtype) \
        * sel.to(x.dtype)[..., None]                         # [g,gs,K,E,C]
    dispatch = disp.sum(dim=2)                               # [g, gs, E, C]
    combine = (disp * gates.to(x.dtype)[..., None, None]).sum(dim=2)

    xe = torch.einsum("gsec,gsd->gecd", dispatch, xg)        # [g, E, C, D]
    xe = pspec.constrain(xe, "batch", "experts", None, None)
    # under a mesh each rank runs its own groups through its own experts
    # (the FSDP-sharded weights gathered whole)
    ye = pspec.local(_experts, xe, p["w_gate"], p["w_up"], p["w_down"],
                     axes=((0, 1), (None, 0), (None, 0), (None, 0)),
                     out_axes=((0, 1),), point="moe.experts")
    ye = pspec.constrain(ye, "batch", "experts", None, None)
    y = torch.einsum("gsec,gecd->gsd", combine, ye).reshape(b, s, d)
    y = pspec.constrain(y, "batch", None, None)

    # switch-style load-balance loss
    me = probs.mean(dim=(0, 1))                              # [E]
    ce = sel.float().sum(2).mean(dim=(0, 1)) / k
    aux = cfg.router_aux_coef * e * torch.sum(me * ce)

    if "shared" in p:
        y = y + layers.swiglu(p["shared"], x)
    return y, aux
