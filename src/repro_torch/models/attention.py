"""Attention variants: GQA (full / sliding-window) and MLA (DeepSeek-V2).

Written as matmul plus masked softmax, like the reference
(``src/repro/models/attention.py``).  The reference keeps its operands in
the model dtype and asks its score and value einsums for f32 output; the
port upcasts both operands to f32 instead, which is the same arithmetic
(bf16 products are exact in f32) provided TF32 is off.  Prefill chunks
the queries so the score matrix never materialises at [S, S]; decode
attends one query row against the cache, which it updates in place.

MLA keeps the latent formulation: the cache stores the compressed
``c_kv`` (kv_lora_rank) and the shared rotary key (qk_rope_dim).
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from . import layers, pspec
from ..configs.base import ModelConfig

NEG_INF = -1e30


# ----------------------------------------------------------------- params
def init_gqa(gen, cfg: ModelConfig, dtype, lead=()) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kv = cfg.n_heads, cfg.n_kv_heads
    lead = tuple(lead)
    std = d ** -0.5
    tn = layers.truncated_normal
    return {
        "wq": tn(gen, lead + (d, h * hd), std, dtype),
        "wk": tn(gen, lead + (d, kv * hd), std, dtype),
        "wv": tn(gen, lead + (d, kv * hd), std, dtype),
        "wo": tn(gen, lead + (h * hd, d), (h * hd) ** -0.5, dtype),
    }


def init_mla(gen, cfg: ModelConfig, dtype, lead=()) -> dict:
    d, h = cfg.d_model, cfg.n_heads
    qk = cfg.qk_nope_dim + cfg.qk_rope_dim
    lead = tuple(lead)
    std = d ** -0.5
    tn = layers.truncated_normal
    return {
        "wq_a": tn(gen, lead + (d, cfg.q_lora_rank), std, dtype),
        "q_norm": layers.init_rms_norm(cfg.q_lora_rank, gen.device, lead),
        "wq_b": tn(gen, lead + (cfg.q_lora_rank, h * qk),
                   cfg.q_lora_rank ** -0.5, dtype),
        "wkv_a": tn(gen, lead + (d, cfg.kv_lora_rank + cfg.qk_rope_dim),
                    std, dtype),
        "kv_norm": layers.init_rms_norm(cfg.kv_lora_rank, gen.device, lead),
        "wkv_b": tn(gen, lead + (cfg.kv_lora_rank,
                                 h * (cfg.qk_nope_dim + cfg.v_head_dim)),
                    cfg.kv_lora_rank ** -0.5, dtype),
        "wo": tn(gen, lead + (h * cfg.v_head_dim, d),
                 (h * cfg.v_head_dim) ** -0.5, dtype),
    }


# ------------------------------------------------------------- mask logic
def _score_mask(q_pos, k_pos, window: int, use_window: bool):
    """Causal (+ sliding window when ``window`` and ``use_window``) mask
    from position vectors; gemma3's local:global striping passes each
    layer's ``use_window``."""
    causal = k_pos[None, :] <= q_pos[:, None]
    if window == 0 or not use_window:
        return causal
    return causal & ((q_pos[:, None] - k_pos[None, :]) < window)


def _sdpa(q, k, v, q_pos, k_pos, window, scale, use_window=True):
    """softmax(q k^T / sqrt) v with mask; q [B,Sq,H,hd] k/v [B,Sk,KV,hd].

    Scores and the value product are f32; the probabilities are cast to
    the value dtype before the product, as the reference does.  Under a
    mesh each rank attends its own batch rows and heads.
    """
    return pspec.local(functools.partial(
        _sdpa_local, q_pos=q_pos, k_pos=k_pos, window=window, scale=scale,
        use_window=use_window), q, k, v, axes=((0, 2),) * 3,
        out_axes=((0, 2),), point="attention")


def _sdpa_local(q, k, v, *, q_pos, k_pos, window, scale, use_window):
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    rep = h // kvh
    qg = (q * scale).reshape(b, sq, kvh, rep, hd)
    scores = torch.einsum("bqgrh,bkgh->bgrqk", qg.float(), k.float())
    mask = _score_mask(q_pos, k_pos, window, use_window)
    scores = scores.masked_fill(~mask, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bgrqk,bkgh->bqgrh", p.to(v.dtype).float(),
                       v.float())
    return out.reshape(b, sq, h, v.shape[-1]).to(q.dtype)


def _chunked_sdpa(q, k, v, positions, window, scale, q_chunk: int,
                  use_window=True):
    """Exact attention with query-block chunking (scores stay [.., qc, S])."""
    s = q.shape[1]
    if s <= q_chunk:
        return _sdpa(q, k, v, positions, positions, window, scale,
                     use_window)
    if s % q_chunk:
        raise ValueError(f"sequence {s} is no multiple of q_chunk {q_chunk}")
    return torch.cat([
        _sdpa(q[:, i:i + q_chunk], k, v, positions[i:i + q_chunk],
              positions, window, scale, use_window)
        for i in range(0, s, q_chunk)], dim=1)


def _write_cache(buf: torch.Tensor, new: torch.Tensor, idx: int):
    """``buf[:, idx:idx + S] = new`` in place; returns ``buf``."""
    buf[:, idx:idx + new.shape[1]] = new.to(buf.dtype)
    return buf


# ---------------------------------------------------------------- GQA fwd
def gqa_forward(p: dict, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor, *, window: int = 0,
                use_window: bool = True, theta: Optional[float] = None,
                cache: Optional[dict] = None, q_chunk: int = 1024):
    """GQA attention.

    Without cache: full/prefill pass over x [B,S,D]; returns (y, (k, v))
    for cache seeding.  With cache: single-step decode; x [B,1,D], cache
    {k, v [B,T,KV,hd], index}; writes the new k, v at ``index`` in place
    and returns (y, (k, v)).
    """
    b, s, d = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    theta = theta if theta is not None else cfg.rope_theta
    q = pspec.split_heads(x @ p["wq"], h, hd)
    kk = pspec.split_heads(x @ p["wk"], kv, hd)
    vv = pspec.split_heads(x @ p["wv"], kv, hd)
    pos2 = positions if positions.ndim == 2 else positions[None, :]
    q = layers.apply_rope(q, pos2, theta)
    kk = layers.apply_rope(kk, pos2, theta)
    q = pspec.constrain(q, "batch", None, "heads", None)
    kk = pspec.constrain(kk, "batch", None, "kv", None)
    vv = pspec.constrain(vv, "batch", None, "kv", None)
    scale = hd ** -0.5
    # TP shardability: when KV heads don't divide the model axis but H
    # does, expand KV to full heads so the attention products shard
    # head-wise instead of replicating.
    tp = pspec.logical_axis_size("heads")
    expand = (h > kv) and (kv % tp != 0) and (h % tp == 0)

    if cache is None:
        kc, vc = kk, vv
        if expand:
            kc = pspec.constrain(kk.repeat_interleave(h // kv, dim=2),
                                 "batch", None, "heads", None)
            vc = pspec.constrain(vv.repeat_interleave(h // kv, dim=2),
                                 "batch", None, "heads", None)
        y = _chunked_sdpa(q, kc, vc, pos2[0], window, scale, q_chunk,
                          use_window)
        return y.reshape(b, s, h * hd) @ p["wo"], (kk, vv)

    # decode: write new kv at cache index, attend over [0, index]
    idx = cache["index"]
    ck = _write_cache(cache["k"], kk, idx)
    cv = _write_cache(cache["v"], vv, idx)
    k_pos = torch.arange(ck.shape[1], device=x.device)
    valid = k_pos <= idx
    if window and use_window:
        valid &= (idx - k_pos) < window
    y = pspec.local(functools.partial(_decode_gqa, valid=valid, scale=scale),
                    q, ck, cv, axes=((0, 2),) * 3, out_axes=((0, 2),),
                    point="attention.decode")
    # one query row: the output product as the [B, D] matrix product a
    # 3-D matmul folds into, so a DTensor, whose global strides may say
    # otherwise of the size-1 axis, takes the same product
    y = (y.reshape(b, h * hd).to(x.dtype) @ p["wo"])[:, None, :]
    return y, (ck, cv)


def _decode_gqa(q, ck, cv, *, valid, scale):
    """One query row q [B,1,H,hd] against the cache ck/cv [B,T,KV,hd]
    where ``valid`` [T]; returns [B,1,H,hd]."""
    b, _, h, hd = q.shape
    kv = ck.shape[2]
    qg = (q * scale).reshape(b, 1, kv, h // kv, hd)
    scores = torch.einsum("bqgrh,bkgh->bgrqk", qg.float(), ck.float())
    scores = scores.masked_fill(~valid, NEG_INF)
    prob = torch.softmax(scores, dim=-1)
    y = torch.einsum("bgrqk,bkgh->bqgrh", prob.to(cv.dtype).float(),
                     cv.float())
    return y.reshape(b, 1, h, cv.shape[-1])


def _decode_mla(qf, kf, v, *, valid, scale):
    """One query row qf [B,1,H,d] against kf [B,T,H,d], v [B,T,H,dv]
    where ``valid`` [T]; returns [B,1,H,dv]."""
    scores = torch.einsum("bqhd,bkhd->bhqk", (qf * scale).float(),
                          kf.float())
    scores = scores.masked_fill(~valid, NEG_INF)
    prob = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", prob.to(v.dtype).float(),
                        v.float())


# ---------------------------------------------------------------- MLA fwd
def mla_forward(p: dict, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor, *, cache: Optional[dict] = None,
                q_chunk: int = 1024):
    """DeepSeek-V2 multi-head latent attention.

    The cache holds the latent (c_kv, k_rope) only.  For prefill/training
    the latent is up-projected and attention runs like MHA; decode writes
    the step's latent in place and re-derives per-head keys from the
    whole cache.
    """
    b, s, d = x.shape
    h = cfg.n_heads
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    pos2 = positions if positions.ndim == 2 else positions[None, :]

    q_lat = layers.rms_norm(x @ p["wq_a"], p["q_norm"], cfg.norm_eps)
    q = pspec.split_heads(q_lat @ p["wq_b"], h, dn + dr)
    q = pspec.constrain(q, "batch", None, "heads", None)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = layers.apply_rope(q_rope, pos2, cfg.rope_theta)

    kv_a = x @ p["wkv_a"]                       # [B,S,kv_lora+dr]
    c_kv = layers.rms_norm(kv_a[..., :cfg.kv_lora_rank], p["kv_norm"],
                           cfg.norm_eps)
    k_rope = layers.apply_rope(kv_a[..., None, cfg.kv_lora_rank:], pos2,
                               cfg.rope_theta)  # [B,S,1,dr]

    if cache is not None:
        c_kv = _write_cache(cache["c_kv"], c_kv, cache["index"])
        k_rope = _write_cache(cache["k_rope"], k_rope, cache["index"])

    t = c_kv.shape[1]
    kv = pspec.split_heads(c_kv @ p["wkv_b"], h, dn + dv)
    kv = pspec.constrain(kv, "batch", None, "heads", None)
    k_nope, v = kv[..., :dn], kv[..., dn:]
    scale = (dn + dr) ** -0.5
    qf = torch.cat([q_nope, q_rope], dim=-1)
    kf = torch.cat([k_nope, k_rope.expand(b, t, h, dr)], dim=-1)

    if cache is None:
        y = _chunked_sdpa(qf, kf, v, pos2[0], 0, scale, q_chunk)
        return y.reshape(b, s, h * dv) @ p["wo"], (c_kv, k_rope)

    valid = torch.arange(t, device=x.device) <= cache["index"]
    y = pspec.local(functools.partial(_decode_mla, valid=valid, scale=scale),
                    qf, kf, v, axes=((0, 2),) * 3, out_axes=((0, 2),),
                    point="attention.decode")
    y = (y.reshape(b, h * dv).to(x.dtype) @ p["wo"])[:, None, :]
    return y, (c_kv, k_rope)
