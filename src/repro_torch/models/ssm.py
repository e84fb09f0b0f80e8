"""State-space / linear-attention mixers: Mamba2 (SSD) and RWKV6 (Finch).

A port of ``src/repro/models/ssm.py``.  Mamba2 runs the chunked SSD
algorithm: intra-chunk attention-like einsums plus an inter-chunk state
scan (a loop over chunks).  RWKV6 has the per-step recurrence and the
chunked parallel form; both are exact given the shared decay floor.
Every ``exp`` of a cumulative decay runs in f32, as in the reference,
and the causal conv is the reference's shift-and-sum (no cuDNN conv, so
no TF32 either).  Decode for both is O(1) per token on a small state.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F

from . import layers, pspec
from ..configs.base import ModelConfig


def _stacked(t: torch.Tensor, lead) -> torch.Tensor:
    return t.expand(tuple(lead) + t.shape).clone()


# =============================================================== Mamba2 ==
def init_mamba2(gen, cfg: ModelConfig, dtype, lead=()) -> dict:
    d = cfg.d_model
    d_in = cfg.ssm_expand * d
    n = cfg.ssm_state
    p_heads = d_in // cfg.ssm_head_dim
    conv_ch = d_in + 2 * n
    lead = tuple(lead)
    dev = gen.device
    tn = layers.truncated_normal
    f32 = dict(dtype=torch.float32, device=dev)
    return {
        # fused in_proj: [z | x | B | C | dt]
        "in_proj": tn(gen, lead + (d, 2 * d_in + 2 * n + p_heads),
                      d ** -0.5, dtype),
        "conv_w": tn(gen, lead + (cfg.conv_kernel, conv_ch),
                     cfg.conv_kernel ** -0.5, dtype),
        "conv_b": torch.zeros(lead + (conv_ch,), dtype=dtype, device=dev),
        "a_log": _stacked(torch.log(torch.linspace(1.0, 16.0, p_heads,
                                                   **f32)), lead),
        "d_skip": torch.ones(lead + (p_heads,), **f32),
        "dt_bias": _stacked(torch.log(torch.expm1(
            torch.linspace(1e-3, 1e-1, p_heads, **f32))), lead),
        "norm": layers.init_rms_norm(d_in, dev, lead),
        "out_proj": tn(gen, lead + (d_in, d), d_in ** -0.5, dtype),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv1d.  x [B,S,C], w [K,C] -> (y, new_state)."""
    k = w.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([state, x], dim=1)
    y = sum(xp[:, i:i + x.shape[1], :] * w[i] for i in range(k))
    new_state = xp[:, -(k - 1):, :] if k > 1 else state
    return F.silu(y + b), new_state


def _split_proj(cfg: ModelConfig, proj: torch.Tensor):
    d_in = cfg.ssm_expand * cfg.d_model
    n = cfg.ssm_state
    p_heads = d_in // cfg.ssm_head_dim
    z = proj[..., :d_in]
    rest = proj[..., d_in:]
    xbc = rest[..., :d_in + 2 * n]
    dt = rest[..., d_in + 2 * n:]
    return z, xbc, dt, d_in, n, p_heads


def mamba2_forward(p: dict, cfg: ModelConfig, x: torch.Tensor,
                   state: Optional[dict] = None):
    """Mamba2 SSD mixer.  x [B,S,D] -> (y, new_state).

    ``state`` (decode): {"h": [B,P,N,hd], "conv": [B,K-1,C]}.  Without
    it a full chunked-SSD pass runs and the final state is returned (for
    the prefill -> decode handoff).
    """
    b, s, d = x.shape
    hd = cfg.ssm_head_dim
    proj = pspec.constrain(x @ p["in_proj"], "batch", None, "ff")
    z, xbc, dt, d_in, n, ph = _split_proj(cfg, proj)

    if state is not None and s == 1:
        return _mamba2_step(p, cfg, x, z, xbc, dt, state)

    xbc, conv_state = _causal_conv(
        xbc, p["conv_w"], p["conv_b"],
        state["conv"] if state is not None else None)

    # pad S to a chunk multiple with dt≈0 steps (decay 1, zero input) so the
    # final state is untouched by padding
    chunk = min(cfg.ssm_chunk, s)
    pad = (-s) % chunk
    if pad:
        xbc = F.pad(xbc, (0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad), value=-20.0)
    sp = s + pad
    xs = pspec.constrain(pspec.split_heads(xbc[..., :d_in], ph, hd),
                         "batch", None, "heads", None)
    bs = pspec.constrain(xbc[..., d_in:d_in + n], "batch", None, None)
    cs = pspec.constrain(xbc[..., d_in + n:], "batch", None, None)

    dt = F.softplus(dt.float() + p["dt_bias"])                  # [B,S,P]
    a = -torch.exp(p["a_log"])                                  # [P] (<0)
    la = dt * a[None, None, :]                                  # log-decay

    h0 = state["h"] if state is not None else torch.zeros(
        (b, ph, n, hd), dtype=torch.float32, device=x.device)
    # under a mesh each rank scans its own batch rows and heads
    y, h_last = pspec.local(
        functools.partial(_ssd_chunked, chunk=chunk), xs.float(),
        bs.float(), cs.float(), dt, la, h0,
        axes=((0, 2), (0, None), (0, None), (0, 2), (0, 2), (0, 1)),
        out_axes=((0, 2), (0, 1)), point="ssd")
    y = y + p["d_skip"][None, None, :, None] * xs.float()
    if pad:
        y = y[:, :s]
    y = y.reshape(b, s, d_in).to(x.dtype)
    y = layers.rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    return y @ p["out_proj"], {"h": h_last, "conv": conv_state}


def _ssd_chunked(xs, bs, cs, dt, la, h0, chunk: int):
    """Chunked SSD.  xs [B,S,P,hd] bs/cs [B,S,N] dt/la [B,S,P].

    Returns (y [B,S,P,hd] f32, h_last [B,P,N,hd] f32).
    """
    b, s, ph, hd = xs.shape
    if s % chunk:
        raise ValueError(f"sequence {s} is no multiple of chunk {chunk}")
    nc = s // chunk

    def r(t):
        return t.reshape((b, nc, chunk) + t.shape[2:])
    xs, bs, cs, dt, la = map(r, (xs, bs, cs, dt, la))

    cum = torch.cumsum(la, dim=2)                    # [B,nc,L,P]
    total = cum[:, :, -1, :]                         # [B,nc,P]

    # intra-chunk: y[t] = C_t · Σ_{s<=t} exp(cum_t - cum_s) dt_s B_s x_s
    cb = torch.einsum("bcln,bcmn->bclm", cs, bs)     # [B,nc,L,L]
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # [B,nc,L,L,P]
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=xs.device))
    w = torch.where(tri[None, None, :, :, None], torch.exp(diff), 0.0)
    m = cb[..., None] * w                            # [B,nc,L,L,P]
    dx = dt[..., None] * xs                          # [B,nc,L,P,hd]
    y_intra = torch.einsum("bclmp,bcmph->bclph", m, dx)

    # chunk summaries: S_c = Σ_s exp(total - cum_s) dt_s B_s ⊗ x_s
    wend = torch.exp(total[:, :, None, :] - cum)     # [B,nc,L,P]
    sc = torch.einsum("bcln,bclp,bclph->bcpnh", bs, wend * dt, xs)

    # inter-chunk scan: H_{c+1} = exp(total_c) H_c + S_c
    decay = torch.exp(total)                         # [B,nc,P]
    h = h0
    starts = []
    for c in range(nc):
        starts.append(h)
        h = decay[:, c, :, None, None] * h + sc[:, c]
    h_starts = torch.stack(starts, dim=1)            # [B,nc,P,N,hd] (entry)

    # inter-chunk contribution: y[t] += C_t · exp(cum_t) H_cstart
    y_inter = torch.einsum("bcln,bclp,bcpnh->bclph", cs, torch.exp(cum),
                           h_starts)
    return (y_intra + y_inter).reshape(b, s, ph, hd), h


def _mamba2_step(p, cfg, x, z, xbc, dt, state):
    """O(1) decode step."""
    b = x.shape[0]
    hd = cfg.ssm_head_dim
    d_in = cfg.ssm_expand * cfg.d_model
    n = cfg.ssm_state
    ph = d_in // hd
    xp = torch.cat([state["conv"], xbc], dim=1)      # [B, K, C]
    y = (xp * p["conv_w"][None]).sum(dim=1) + p["conv_b"]
    xbc1 = F.silu(y)                                 # [B, C]
    new_conv = xp[:, 1:, :]
    xs = xbc1[:, :d_in].reshape(b, ph, hd).float()
    bs = xbc1[:, d_in:d_in + n].float()
    cs = xbc1[:, d_in + n:].float()
    dtp = F.softplus(dt[:, 0].float() + p["dt_bias"])
    a = -torch.exp(p["a_log"])
    dec = torch.exp(dtp * a[None, :])                # [B,P]
    h = state["h"] * dec[:, :, None, None] + torch.einsum(
        "bn,bp,bph->bpnh", bs, dtp, xs)
    yh = torch.einsum("bn,bpnh->bph", cs, h)
    yh = yh + p["d_skip"][None, :, None] * xs
    yh = yh.reshape(b, 1, d_in).to(x.dtype)
    yh = layers.rms_norm(yh * F.silu(z), p["norm"], cfg.norm_eps)
    return yh @ p["out_proj"], {"h": h, "conv": new_conv}


# ================================================================ RWKV6 ==
def rwkv_heads(cfg: ModelConfig) -> tuple[int, int]:
    """(heads, head width) of the WKV state."""
    h = max(1, cfg.d_model // cfg.ssm_head_dim)
    return h, cfg.d_model // h


def init_rwkv6(gen, cfg: ModelConfig, dtype, lead=()) -> dict:
    d = cfg.d_model
    h, hd = rwkv_heads(cfg)
    lora = max(32, d // 16)
    lead = tuple(lead)
    dev = gen.device
    std = d ** -0.5
    tn = layers.truncated_normal
    f32 = dict(dtype=torch.float32, device=dev)
    return {
        "mu": torch.full(lead + (5, d), 0.5, **f32),  # r,k,v,w,g shift mix
        "w_r": tn(gen, lead + (d, d), std, dtype),
        "w_k": tn(gen, lead + (d, d), std, dtype),
        "w_v": tn(gen, lead + (d, d), std, dtype),
        "w_g": tn(gen, lead + (d, d), std, dtype),
        "w_o": tn(gen, lead + (d, d), std, dtype),
        "w0": torch.full(lead + (d,), -6.0, **f32),   # decay base
        "w_lora_a": tn(gen, lead + (d, lora), std, torch.float32),
        "w_lora_b": tn(gen, lead + (lora, d), lora ** -0.5, torch.float32),
        "u": tn(gen, lead + (h, hd), hd ** -0.5, torch.float32),
        "ln_x": layers.init_rms_norm(d, dev, lead),
    }


def init_rwkv6_cm(gen, cfg: ModelConfig, dtype, lead=()) -> dict:
    """RWKV channel-mix (the arch's FFN)."""
    d, f = cfg.d_model, cfg.d_ff
    lead = tuple(lead)
    tn = layers.truncated_normal
    return {
        "mu": torch.full(lead + (2, d), 0.5, dtype=torch.float32,
                         device=gen.device),
        "w_r": tn(gen, lead + (d, d), d ** -0.5, dtype),
        "w_k": tn(gen, lead + (d, f), d ** -0.5, dtype),
        "w_v": tn(gen, lead + (f, d), f ** -0.5, dtype),
    }


def _token_shift(x: torch.Tensor, last: Optional[torch.Tensor]):
    """x [B,S,D] -> x shifted right by one (first uses ``last`` or zeros)."""
    b, s, d = x.shape
    if last is None:
        last = torch.zeros((b, 1, d), dtype=x.dtype, device=x.device)
    else:
        last = last.reshape(b, 1, d).to(x.dtype)
    return torch.cat([last, x[:, :-1, :]], dim=1)


def rwkv6_time_mix(p: dict, cfg: ModelConfig, x: torch.Tensor,
                   state: Optional[dict] = None, chunked: bool = False):
    """WKV6 time-mix.  x [B,S,D] -> (y, new_state).

    state: {"s": [B,H,hd,hd], "last": [B,D]}
    """
    b, s, d = x.shape
    h, hd = rwkv_heads(cfg)
    xs = _token_shift(x, state["last"] if state is not None else None)

    def mix(i):
        return x + (xs - x) * p["mu"][i].to(x.dtype)
    r = pspec.constrain(pspec.split_heads(mix(0) @ p["w_r"], h, hd),
                        "batch", None, "heads", None)
    k = pspec.constrain(pspec.split_heads(mix(1) @ p["w_k"], h, hd),
                        "batch", None, "heads", None)
    v = pspec.constrain(pspec.split_heads(mix(2) @ p["w_v"], h, hd),
                        "batch", None, "heads", None)
    # data-dependent decay (Finch): w = exp(-exp(w0 + lora(x_shift))).
    # The per-step log-decay is floored at 80/chunk so the chunked form's
    # exp(-cumsum) stays in f32 range; scan and chunked share the floor.
    chunk_len = max(1, min(cfg.ssm_chunk, 32, s))
    floor = 80.0 / chunk_len
    wlog = p["w0"] + torch.tanh(mix(3).float() @ p["w_lora_a"]) \
        @ p["w_lora_b"]
    logw = -torch.clamp(torch.exp(wlog), max=floor)
    w = pspec.split_heads(torch.exp(logw), h, hd)       # decay in (0,1)
    g = F.silu(mix(4) @ p["w_g"])

    s0 = state["s"] if state is not None else torch.zeros(
        (b, h, hd, hd), dtype=torch.float32, device=x.device)
    rf, kf, vf = r.float(), k.float(), v.float()
    wkv = (functools.partial(_wkv6_chunked, chunk=chunk_len)
           if chunked and s > 1 else _wkv6_scan)
    # under a mesh each rank runs the recurrence of its batch rows and heads
    y, s_last = pspec.local(
        wkv, rf, kf, vf, w, p["u"], s0,
        axes=((0, 2),) * 4 + ((None, 0), (0, 1)),
        out_axes=((0, 2), (0, 1)), point="wkv")
    y = y.reshape(b, s, d).to(x.dtype)
    y = layers.rms_norm(y, p["ln_x"], cfg.norm_eps) * g
    return y @ p["w_o"], {"s": s_last, "last": x[:, -1, :]}


def _wkv6_scan(r, k, v, w, u, s0):
    """Reference recurrence.  r,k,v,w [B,S,H,hd]; u [H,hd]; s0 [B,H,hd,hd].

    y_t = r_t · (S_{t-1} + diag(u) k_t v_tᵀ);  S_t = diag(w_t) S_{t-1}
          + k_t v_tᵀ
    """
    s_prev = s0
    ys = []
    for t in range(r.shape[1]):
        rt, kt, vt, wt = r[:, t], k[:, t], v[:, t], w[:, t]   # [B,H,hd]
        kv = kt[..., :, None] * vt[..., None, :]              # [B,H,hd,hd]
        ys.append(torch.einsum("bhi,bhij->bhj", rt,
                               s_prev + u[None, :, :, None] * kv))
        s_prev = wt[..., :, None] * s_prev + kv
    return torch.stack(ys, dim=1), s_prev                     # [B,S,H,hd]


def _wkv6_chunked(r, k, v, w, u, s0, chunk: int):
    """Chunked-parallel WKV6 (exact given the shared decay floor).

    Factorised intra-chunk form: exp(cum_excl_t - cum_s) = exp(cum_excl_t)
    · exp(-cum_s), so the pairwise decay never materialises at [L, L, D]:
    intra-chunk work is two plain [L, L] products per head.  The floor
    bounds exp(-cum_s) by e^80.
    """
    b, s, h, hd = r.shape
    while s % chunk:
        chunk //= 2
    nc = s // chunk

    def rs(t):
        return t.reshape(b, nc, chunk, h, hd)
    r, k, v, w = map(rs, (r, k, v, w))
    logw = torch.log(torch.clamp(w, min=1e-38))
    cum = torch.cumsum(logw, dim=2)                   # inclusive prefix
    cum_excl = cum - logw                             # exclusive prefix
    total = cum[:, :, -1]                             # [B,nc,H,hd]

    # intra-chunk strict-lower-triangular linear attention
    r_dec = r * torch.exp(cum_excl)                   # exp <= 1, safe
    k_dec = k * torch.exp(-cum)                       # bounded by floor
    att = torch.einsum("bclhd,bcmhd->bclmh", r_dec, k_dec)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=r.device), -1)
    att = torch.where(tri[None, None, :, :, None], att, 0.0)
    y_intra = torch.einsum("bclmh,bcmhd->bclhd", att, v)
    # diagonal bonus term
    y_diag = torch.einsum("bclhd,bclhd,bclhe->bclhe",
                          r * u[None, None, None], k, v)

    # chunk summary: S_c_add = Σ_s exp(total - cum_s) k_s v_sᵀ
    wk = torch.exp(total[:, :, None] - cum) * k
    sc = torch.einsum("bclhd,bclhe->bchde", wk, v)

    dec_c = torch.exp(total)                          # [B,nc,H,hd]
    s_prev = s0
    starts = []
    for c in range(nc):
        starts.append(s_prev)
        s_prev = dec_c[:, c, :, :, None] * s_prev + sc[:, c]
    s_starts = torch.stack(starts, dim=1)             # [B,nc,H,hd,hd]

    y_inter = torch.einsum("bclhd,bchde->bclhe",
                           r * torch.exp(cum_excl), s_starts)
    y = (y_intra + y_diag + y_inter).reshape(b, s, h, hd)
    return y, s_prev


def rwkv6_channel_mix(p: dict, cfg: ModelConfig, x: torch.Tensor,
                      state: Optional[torch.Tensor] = None):
    """RWKV FFN.  state = last token [B,D] for decode."""
    xs = _token_shift(x, state)

    def mix(i):
        return x + (xs - x) * p["mu"][i].to(x.dtype)
    r = torch.sigmoid(mix(0) @ p["w_r"])
    kk = torch.square(F.relu(mix(1) @ p["w_k"]))
    return r * (kk @ p["w_v"]), x[:, -1, :]
