"""Public model API: init / forward / prefill / decode_step / init_cache.

A port of ``src/repro/models/model.py``.  Cache layouts per family are
documented on ``init_cache``.  ``decode_step`` writes the step's keys,
values and states into the cache's tensors in place and returns the
cache with its ``index`` advanced, so a caller threads the returned
cache as with the reference's functional one.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from . import attention, layers, moe, ssm
from .transformer import (forward, init_params, layer, layer_flags_np,
                          model_dtype)
from ..bitset import resolve_device
from ..configs.base import ModelConfig

__all__ = ["forward", "init_params", "init_cache", "prefill", "decode_step"]


# ------------------------------------------------------------- init_cache
def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               index: int = 0, *, device="cuda") -> dict:
    """Decode cache on ``device`` (default: the card).

    attn:   {k, v: [L, B, T, KV, hd], index}
    mla:    {c_kv: [L, B, T, ckv], k_rope: [L, B, T, 1, dr], index}
    mamba2: {h: [L, B, P, N, hd], conv: [L, B, K-1, C]}
            (+ hybrid: attn_k/attn_v [G, B, T, KV, hd], index)
    rwkv6:  {s: [L, B, H, hd, hd], last_tm/last_cm: [L, B, D]}

    ``index`` is a Python int: the next position to write.
    """
    dev = resolve_device(device)
    dt = model_dtype(cfg)
    l, d = cfg.n_layers, cfg.d_model

    def zeros(*shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=dev)
    if cfg.block_type == "attn":
        if cfg.mla:
            return {"c_kv": zeros(l, batch, max_len, cfg.kv_lora_rank),
                    "k_rope": zeros(l, batch, max_len, 1, cfg.qk_rope_dim),
                    "index": index}
        hd, kv = cfg.resolved_head_dim, cfg.n_kv_heads
        return {"k": zeros(l, batch, max_len, kv, hd),
                "v": zeros(l, batch, max_len, kv, hd), "index": index}
    if cfg.block_type == "mamba2":
        d_in = cfg.ssm_expand * d
        ph = d_in // cfg.ssm_head_dim
        n = cfg.ssm_state
        cache = {
            "h": zeros(l, batch, ph, n, cfg.ssm_head_dim,
                       dtype=torch.float32),
            "conv": zeros(l, batch, cfg.conv_kernel - 1, d_in + 2 * n),
        }
        if cfg.hybrid_attn_every:
            g = cfg.n_layers // cfg.hybrid_attn_every
            hd, kv = cfg.resolved_head_dim, cfg.n_kv_heads
            cache["attn_k"] = zeros(g, batch, max_len, kv, hd)
            cache["attn_v"] = zeros(g, batch, max_len, kv, hd)
            cache["index"] = index
        return cache
    if cfg.block_type == "rwkv6":
        h, hd = ssm.rwkv_heads(cfg)
        return {"s": zeros(l, batch, h, hd, hd, dtype=torch.float32),
                "last_tm": zeros(l, batch, d), "last_cm": zeros(l, batch, d)}
    raise ValueError(cfg.block_type)


# ---------------------------------------------------------------- prefill
@torch.no_grad()
def prefill(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
            media: Optional[torch.Tensor] = None, *, max_len: int,
            q_chunk: int = 1024):
    """Run the full prompt, return (last-token logits, primed cache)."""
    b, s = tokens.shape
    logits, _, seeds = forward(cfg, params, tokens, media,
                               collect_cache=True, q_chunk=q_chunk)
    cache = init_cache(cfg, b, max_len, device=tokens.device)

    def primed(name, seed):
        # the seed's s positions, then zeros to max_len (a pad, not a
        # slice write, so a sharded seed stays sharded under a mesh)
        pad = [0, 0] * (seed.ndim - 3) + [0, max_len - s]
        return F.pad(seed.to(cache[name].dtype), pad)
    if cfg.block_type == "attn":
        for name, seed in zip(("c_kv", "k_rope") if cfg.mla else ("k", "v"),
                              seeds):
            cache[name] = primed(name, seed)
        cache["index"] = s
    elif cfg.block_type == "mamba2":
        cache["h"], cache["conv"] = seeds["h"], seeds["conv"]
        if cfg.hybrid_attn_every:
            ak, av = seeds["attn"]
            cache["attn_k"] = primed("attn_k", ak)
            cache["attn_v"] = primed("attn_v", av)
            cache["index"] = s
    else:  # rwkv6
        cache.update(seeds)
    return logits[:, -1, :], cache


# ------------------------------------------------------------ decode_step
@torch.no_grad()
def decode_step(cfg: ModelConfig, params: dict, cache: dict,
                tokens: torch.Tensor):
    """One token for every sequence.  tokens [B] -> (logits [B, V], cache)."""
    x = layers.gather_rows(params["embed"]["tok"], tokens)[:, None, :]
    if cfg.block_type == "attn":
        x, cache = _decode_attn(cfg, params, cache, x)
    elif cfg.block_type == "mamba2":
        x, cache = _decode_mamba(cfg, params, cache, x)
    else:
        x, cache = _decode_rwkv(cfg, params, cache, x)
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return layers.unembed(params["embed"], x)[:, 0, :], cache


def _decode_attn(cfg, params, cache, x):
    use_window, thetas = layer_flags_np(cfg)
    idx = cache["index"]
    positions = torch.full((x.shape[0], 1), idx, dtype=torch.int32,
                           device=x.device)
    blocks = params["blocks"]
    for l in range(cfg.n_layers):
        blk = layer(blocks, l)
        h = layers.rms_norm(x, blk["ln1"], cfg.norm_eps)
        if cfg.mla:
            a, _ = attention.mla_forward(
                blk["attn"], cfg, h, positions,
                cache={"c_kv": cache["c_kv"][l],
                       "k_rope": cache["k_rope"][l], "index": idx})
        else:
            a, _ = attention.gqa_forward(
                blk["attn"], cfg, h, positions, window=cfg.sliding_window,
                use_window=bool(use_window[l]), theta=float(thetas[l]),
                cache={"k": cache["k"][l], "v": cache["v"][l],
                       "index": idx})
        x = x + a
        h = layers.rms_norm(x, blk["ln2"], cfg.norm_eps)
        if cfg.is_moe:
            f, _ = moe_forward_decode(blk["ffn"], cfg, h)
        else:
            f = layers.swiglu(blk["ffn"], h)
        x = x + f
    return x, dict(cache, index=idx + 1)


def moe_forward_decode(p, cfg, x):
    """MoE for tiny token counts (decode): group = the whole batch row."""
    b, s, d = x.shape
    return moe.moe_forward(p, cfg, x, group_size=b * s)


def _decode_mamba(cfg, params, cache, x):
    blocks = params["blocks"]
    every = cfg.hybrid_attn_every
    if every:
        idx = cache["index"]
        positions = torch.full((x.shape[0], 1), idx, dtype=torch.int32,
                               device=x.device)
    for l in range(cfg.n_layers):
        blk = layer(blocks, l)
        h = layers.rms_norm(x, blk["ln"], cfg.norm_eps)
        y, st = ssm.mamba2_forward(
            blk["mixer"], cfg, h,
            state={"h": cache["h"][l], "conv": cache["conv"][l]})
        cache["h"][l] = st["h"]
        cache["conv"][l] = st["conv"]
        x = x + y
        if every and (l + 1) % every == 0:
            shared = params["shared"]
            g = l // every
            hh = layers.rms_norm(x, shared["ln_a"], cfg.norm_eps)
            a, _ = attention.gqa_forward(
                shared["attn"], cfg, hh, positions,
                cache={"k": cache["attn_k"][g], "v": cache["attn_v"][g],
                       "index": idx})
            x = x + a
            hh = layers.rms_norm(x, shared["ln_f"], cfg.norm_eps)
            x = x + layers.swiglu(shared["ffn"], hh)
    return x, (dict(cache, index=idx + 1) if every else cache)


def _decode_rwkv(cfg, params, cache, x):
    blocks = params["blocks"]
    for l in range(cfg.n_layers):
        blk = layer(blocks, l)
        h = layers.rms_norm(x, blk["ln1"], cfg.norm_eps)
        y, st = ssm.rwkv6_time_mix(
            blk["tm"], cfg, h,
            state={"s": cache["s"][l], "last": cache["last_tm"][l]})
        x = x + y
        h = layers.rms_norm(x, blk["ln2"], cfg.norm_eps)
        y, lcm = ssm.rwkv6_channel_mix(blk["cm"], cfg, h,
                                       state=cache["last_cm"][l])
        x = x + y
        cache["s"][l] = st["s"]
        cache["last_tm"][l] = st["last"]
        cache["last_cm"][l] = lcm
    return x, cache
