"""Backbone composition for every family, a loop over layers.

A port of ``src/repro/models/transformer.py``.  Params keep the
reference's stacked layout (each block leaf ``[L, ...]``), so names,
shapes and checkpoints match it; the loop takes layer ``l``'s views.

  * attn (dense / moe / vlm / audio):  x += Attn(LN(x));  x += FFN(LN(x))
    FFN = SwiGLU or MoE (+ shared experts).  gemma3's 5:1 local:global
    striping rides through the loop as per-layer (use_window, theta).
  * mla: the same with MLA attention (deepseek-v2).
  * mamba2 (+ zamba2 hybrid): x += Mamba2(LN(x)); the hybrid applies one
    shared-weight attention+MLP block after every ``hybrid_attn_every``
    mamba layers.
  * rwkv6: x += TimeMix(LN(x)); x += ChannelMix(LN(x)).

``remat`` checkpoints each layer body with ``torch.utils.checkpoint``;
``remat_policy="dots"`` saves the unbatched matmul outputs (``aten.mm``,
the reference's ``dots_with_no_batch_dims_saveable``) and recomputes the
rest.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Any, Optional

import numpy as np
import torch
from torch.utils import checkpoint as ckpt

from . import attention, layers, moe, pspec, ssm
from ..configs.base import ModelConfig
from ..bitset import resolve_device


def model_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# ------------------------------------------------------------------ init
def init_params(cfg: ModelConfig, seed: int = 0, *,
                device="cuda") -> dict:
    """Random params for ``cfg`` from a ``torch.Generator`` seeded with
    ``seed`` on ``device`` (default: the card)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt = model_dtype(cfg)
    d, l = cfg.d_model, cfg.n_layers
    lead = (l,)
    params: dict[str, Any] = {
        "embed": layers.init_embedding(gen, cfg.vocab, d, dt,
                                       cfg.tie_embeddings),
        "final_norm": layers.init_rms_norm(d, dev),
    }
    if cfg.block_type == "attn":
        init_attn = attention.init_mla if cfg.mla else attention.init_gqa
        params["blocks"] = {
            "attn": init_attn(gen, cfg, dt, lead),
            "ln1": layers.init_rms_norm(d, dev, lead),
            "ln2": layers.init_rms_norm(d, dev, lead),
            "ffn": (moe.init_moe(gen, cfg, dt, lead) if cfg.is_moe else
                    layers.init_swiglu(gen, d, cfg.d_ff, dt, lead)),
        }
    elif cfg.block_type == "mamba2":
        params["blocks"] = {
            "mixer": ssm.init_mamba2(gen, cfg, dt, lead),
            "ln": layers.init_rms_norm(d, dev, lead),
        }
        if cfg.hybrid_attn_every:
            params["shared"] = {
                "attn": attention.init_gqa(gen, cfg, dt),
                "ffn": layers.init_swiglu(gen, d, cfg.d_ff, dt),
                "ln_a": layers.init_rms_norm(d, dev),
                "ln_f": layers.init_rms_norm(d, dev),
            }
    elif cfg.block_type == "rwkv6":
        params["blocks"] = {
            "tm": ssm.init_rwkv6(gen, cfg, dt, lead),
            "cm": ssm.init_rwkv6_cm(gen, cfg, dt, lead),
            "ln1": layers.init_rms_norm(d, dev, lead),
            "ln2": layers.init_rms_norm(d, dev, lead),
        }
    else:
        raise ValueError(cfg.block_type)
    return params


def layer(tree: dict, l: int) -> dict:
    """Layer ``l``'s views of a stacked ``[L, ...]`` param or cache dict."""
    return {k: layer(v, l) if isinstance(v, dict) else v[l]
            for k, v in tree.items()}


# -------------------------------------------------------- per-layer flags
def layer_flags_np(cfg: ModelConfig):
    """(use_window [L] bool, theta [L] f32) for gemma3-style striping, as
    numpy arrays: the layer loops read them as Python values, which the
    dry-run's fake tensors could not give."""
    l = cfg.n_layers
    if cfg.local_per_global:
        # pattern L,L,L,L,L,G repeating (last of each group is global)
        idx = np.arange(l)
        is_global = (idx % (cfg.local_per_global + 1)
                     == cfg.local_per_global)
    else:
        is_global = np.ones(l, dtype=bool) if cfg.sliding_window == 0 \
            else np.zeros(l, dtype=bool)
    theta = np.where(is_global, cfg.rope_theta_global or cfg.rope_theta,
                     cfg.rope_theta).astype(np.float32)
    return ~is_global, theta


def layer_flags(cfg: ModelConfig):
    """``layer_flags_np`` as tensors."""
    use_window, theta = layer_flags_np(cfg)
    return torch.from_numpy(use_window), torch.from_numpy(theta)


# --------------------------------------------------------------- forward
def forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
            media: Optional[torch.Tensor] = None, *, remat: bool = False,
            remat_policy: str = "", collect_cache: bool = False,
            q_chunk: int = 1024, rwkv_chunked: bool = False):
    """Full-sequence pass.  Returns (logits, aux, cache_seeds).

    ``cache_seeds`` (when collect_cache) hold each layer's KV or state,
    stacked ``[L, ...]``, to continue decoding after prefill: ``(k, v)``
    (GQA), ``(c_kv, k_rope)`` (MLA), ``{"h", "conv"}`` plus, for the
    hybrid, ``"attn": (k, v)`` stacked over shared-block calls (mamba2),
    ``{"s", "last_tm", "last_cm"}`` (rwkv6).
    """
    b, s = tokens.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=tokens.device)[None, :].repeat(b, 1)
    x = layers.embed(params["embed"], tokens, media, cfg.n_media_tokens)
    x = pspec.constrain(x, "batch", "seq", "embed")
    rm = functools.partial(_maybe_remat, remat=remat, policy=remat_policy)
    if cfg.block_type == "attn":
        x, aux, seeds = _attn_stack(cfg, params, x, positions, rm,
                                    collect_cache, q_chunk)
    elif cfg.block_type == "mamba2":
        x, aux, seeds = _mamba_stack(cfg, params, x, positions, rm,
                                     collect_cache, q_chunk)
    else:
        x, aux, seeds = _rwkv_stack(cfg, params, x, rm, collect_cache,
                                    rwkv_chunked)
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = layers.unembed(params["embed"], x)
    logits = pspec.constrain(logits, "batch", "seq", "vocab")
    return logits, aux, seeds


_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_matmuls(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _MATMULS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _maybe_remat(fn, *, remat: bool, policy: str = ""):
    if not remat:
        return fn
    mesh, mapping = pspec.get_mesh(), pspec.get_mapping()
    if policy != "dots" and mesh is None:
        return functools.partial(ckpt.checkpoint, fn, use_reentrant=False)

    def context_fn():
        fwd, rec = (ckpt.create_selective_checkpoint_contexts(_save_matmuls)
                    if policy == "dots" else (contextlib.nullcontext(),
                                              contextlib.nullcontext()))
        if mesh is None:
            return fwd, rec
        # the recompute may run on an autograd device thread: the mesh,
        # its mapping and DTensor's implicit replication go with it
        return fwd, _both(rec, pspec.use_mesh(mesh, mapping))
    return functools.partial(ckpt.checkpoint, fn, use_reentrant=False,
                             context_fn=context_fn)


@contextlib.contextmanager
def _both(a, b):
    with a, b:
        yield


def _stack_seeds(seeds: list):
    """Per-layer seeds (tensor tuples or dicts) stacked on a layer axis."""
    if isinstance(seeds[0], dict):
        return {k: torch.stack([s[k] for s in seeds]) for k in seeds[0]}
    return tuple(torch.stack(t) for t in zip(*seeds))


def _residual(x, y):
    """``x + y`` inside a block, constrained like a block's output.  The
    reference's GSPMD reduces the partial sums of a row-parallel product
    where the next norm reads them, and those of the gradient where the
    product before takes it; DTensor would carry both on, and every model
    rank would run the next product whole."""
    return pspec.constrain(x + y, "batch", "seq", "embed")


def _attn_stack(cfg, params, x, positions, rm, collect_cache, q_chunk):
    use_window, thetas = layer_flags_np(cfg)
    blocks = params["blocks"]

    def body(x, l):
        blk = layer(blocks, l)
        h = layers.rms_norm(x, blk["ln1"], cfg.norm_eps)
        if cfg.mla:
            a, kv = attention.mla_forward(blk["attn"], cfg, h, positions,
                                          q_chunk=q_chunk)
        else:
            a, kv = attention.gqa_forward(
                blk["attn"], cfg, h, positions, window=cfg.sliding_window,
                use_window=bool(use_window[l]), theta=float(thetas[l]),
                q_chunk=q_chunk)
        x = _residual(x, a)
        h = layers.rms_norm(x, blk["ln2"], cfg.norm_eps)
        if cfg.is_moe:
            f, a_loss = moe.moe_forward(blk["ffn"], cfg, h)
        else:
            f, a_loss = layers.swiglu(blk["ffn"], h), None
        x = pspec.constrain(x + f, "batch", "seq", "embed")
        return x, a_loss, (kv if collect_cache else None)

    body = rm(body)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    seeds = []
    for l in range(cfg.n_layers):
        x, a_loss, kv = body(x, l)
        if a_loss is not None:
            aux = aux + a_loss
        seeds.append(kv)
    return x, aux, (_stack_seeds(seeds) if collect_cache else None)


def _mamba_stack(cfg, params, x, positions, rm, collect_cache, q_chunk):
    blocks = params["blocks"]
    every = cfg.hybrid_attn_every

    def mamba_body(x, l):
        blk = layer(blocks, l)
        h = layers.rms_norm(x, blk["ln"], cfg.norm_eps)
        y, st = ssm.mamba2_forward(blk["mixer"], cfg, h)
        return (pspec.constrain(x + y, "batch", "seq", "embed"),
                st if collect_cache else None)

    def shared_attn(x):
        shared = params["shared"]
        h = layers.rms_norm(x, shared["ln_a"], cfg.norm_eps)
        a, kv = attention.gqa_forward(shared["attn"], cfg, h, positions,
                                      q_chunk=q_chunk)
        x = _residual(x, a)
        h = layers.rms_norm(x, shared["ln_f"], cfg.norm_eps)
        return _residual(x, layers.swiglu(shared["ffn"], h)), kv

    mamba_body = rm(mamba_body)
    m_seeds, a_seeds = [], []
    for l in range(cfg.n_layers):
        x, st = mamba_body(x, l)
        m_seeds.append(st)
        # the shared block follows each full group; a tail does without
        if every and (l + 1) % every == 0:
            x, kv = shared_attn(x)
            a_seeds.append(kv)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if not collect_cache:
        return x, aux, None
    seeds = _stack_seeds(m_seeds)
    if every:
        seeds["attn"] = _stack_seeds(a_seeds)
    return x, aux, seeds


def _rwkv_stack(cfg, params, x, rm, collect_cache, chunked):
    blocks = params["blocks"]

    def body(x, l):
        blk = layer(blocks, l)
        h = layers.rms_norm(x, blk["ln1"], cfg.norm_eps)
        y, st = ssm.rwkv6_time_mix(blk["tm"], cfg, h, chunked=chunked)
        x = _residual(x, y)
        h = layers.rms_norm(x, blk["ln2"], cfg.norm_eps)
        y, last_cm = ssm.rwkv6_channel_mix(blk["cm"], cfg, h)
        seed = ({"s": st["s"], "last_tm": st["last"], "last_cm": last_cm}
                if collect_cache else None)
        return pspec.constrain(x + y, "batch", "seq", "embed"), seed

    body = rm(body)
    seeds = []
    for l in range(cfg.n_layers):
        x, seed = body(x, l)
        seeds.append(seed)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, aux, (_stack_seeds(seeds) if collect_cache else None)
