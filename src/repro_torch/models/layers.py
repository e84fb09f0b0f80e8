"""Shared neural layers: norms, RoPE, SwiGLU, embeddings, the f32 loss.

Plain functions on tensors over param dicts laid out as the reference's
(``src/repro/models/layers.py``): same names, shapes and dtypes.  The
``init_*`` functions draw from an explicit ``torch.Generator`` on the
device the params are made on; ``lead`` prepends the layer axis of a
stacked ``[L, ...]`` leaf.  Every cast of the reference is mirrored, so a
bf16 model keeps its norms, rotations and loss in f32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import pspec


def truncated_normal(gen: torch.Generator, shape, std: float,
                     dtype) -> torch.Tensor:
    """N(0, 1) truncated to [-2, 2], times ``std``, drawn in f32."""
    t = torch.empty(tuple(shape), dtype=torch.float32, device=gen.device)
    if isinstance(t, torch._subclasses.FakeTensor):
        # the dry-run's shape-only params: trunc_normal_ reads a value,
        # which a fake tensor has none of
        return t.to(dtype)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (t * std).to(dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float) -> torch.Tensor:
    dtype = x.dtype
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + weight.float())).to(dtype)


def init_rms_norm(d: int, device, lead=()) -> torch.Tensor:
    # stored as (scale - 1) so zero-init == identity
    return torch.zeros(tuple(lead) + (d,), dtype=torch.float32,
                       device=device)


# -------------------------------------------------------------------- RoPE
def rope_angles(positions: torch.Tensor, dim: int, theta) -> torch.Tensor:
    """positions [...] -> angles [..., dim/2] (float32)."""
    theta = torch.as_tensor(theta, dtype=torch.float32,
                            device=positions.device)
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                        device=positions.device) / dim))
    return positions[..., None].float() * inv


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta) -> torch.Tensor:
    """Rotate pairs (first half against second).  x [B, S, H, hd];
    positions [B, S]."""
    hd = x.shape[-1]
    ang = rope_angles(positions, hd, theta)            # [B, S, hd/2]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------------ SwiGLU
def init_swiglu(gen, d: int, f: int, dtype, lead=()) -> dict:
    lead = tuple(lead)
    return {
        "w_gate": truncated_normal(gen, lead + (d, f), d ** -0.5, dtype),
        "w_up": truncated_normal(gen, lead + (d, f), d ** -0.5, dtype),
        "w_down": truncated_normal(gen, lead + (f, d), f ** -0.5, dtype),
    }


def swiglu(p: dict, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    return h @ p["w_down"]


# -------------------------------------------------------------- embeddings
def init_embedding(gen, vocab: int, d: int, dtype, tie: bool) -> dict:
    p = {"tok": truncated_normal(gen, (vocab, d), d ** -0.5, dtype)}
    if not tie:
        p["unembed"] = truncated_normal(gen, (vocab, d), d ** -0.5, dtype)
    return p


def embed(p: dict, tokens: torch.Tensor, media=None,
          n_media: int = 0) -> torch.Tensor:
    """Token embedding with modality-stub injection.

    ``media`` [B, n_media, D] are precomputed frontend embeddings (the
    CLIP/EnCodec frontend is a stub); they overwrite the first ``n_media``
    positions of the sequence.
    """
    x = gather_rows(p["tok"], tokens)
    if media is not None and n_media:
        x = torch.cat([media.to(x.dtype), x[:, n_media:, :]], dim=1)
    return x


def gather_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]``.  Under a mesh each rank gathers its own ids' rows
    from the whole table, gathered first over the vocab shards (DTensor's
    rule for the index backward fails on a vocab-sharded table)."""
    return pspec.local(lambda t, i: t[i], table, ids, axes=((None,), (0,)),
                       out_axes=((0,),), point="embed.vocab")


def unembed(p: dict, x: torch.Tensor) -> torch.Tensor:
    w = p.get("unembed", p["tok"])
    return x @ w.T


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask=None) -> torch.Tensor:
    """Mean next-token CE in f32 (stable logsumexp)."""
    # DTensor's gather along a sharded vocab dim fails (its mask buffer
    # indexes the wrong rank of the logits): the vocab is gathered first,
    # and each rank picks its own rows' labels
    logits = pspec.replicated(logits, "cross_entropy.vocab", -1).float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = pspec.local(
        lambda lg, lb: torch.gather(lg, -1, lb[..., None].long())[..., 0],
        logits, labels, axes=((0,), (0,)), out_axes=((0,),),
        point="cross_entropy.vocab")
    nll = lse - ll
    if mask is not None:
        return (nll * mask).sum() / mask.sum().clamp_min(1)
    return nll.mean()
