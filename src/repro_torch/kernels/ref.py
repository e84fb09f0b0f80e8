"""Plain PyTorch versions of the three hand kernels.

Each function computes what its CUDA kernel computes, on either device,
with packed words as int32.  They are the kernels' CPU path and their
equality target on the card; nothing on the main path calls them when
the tensors live on a card.  The contractions unpack bits and threshold a
float32 matmul, exact because every count stays below 2^24.
"""
from __future__ import annotations

import torch

from .. import bitset
from ..compressed import ALL_ONE, BlockCompressed

WORD = 32
# float32 elements of one unpacked operand slab (bounds transient memory)
_SLAB = 1 << 26


def bitset_matmul_ref(a_packed: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """OR_j (A[i,j] & X[j,:]) — unpack + matmul + threshold + repack.

    ``a_packed`` int32 [M, K/32], ``x`` int32 [K, W] -> int32 [M, W]."""
    m, kw = a_packed.shape
    k, w = x.shape
    if kw * WORD != k:
        raise ValueError(f"shape mismatch: A {tuple(a_packed.shape)}, "
                         f"X {tuple(x.shape)}")
    x_bits = bitset.unpack_bits(x, w * WORD).to(torch.float32)   # [K, W*32]
    out = torch.empty((m, w), dtype=torch.int32, device=x.device)
    step = max(1, _SLAB // max(k, 1))
    for r0 in range(0, m, step):
        a_bits = bitset.unpack_bits(a_packed[r0:r0 + step], k)
        prod = a_bits.to(torch.float32) @ x_bits
        out[r0:r0 + step] = bitset.pack_bits(prod > 0)
    return out


def way_filter_ref(h_vtx, h_lab, v_vtx, v_lab, vbits, req, forb, null_plane):
    """Per-(job, way) viability predicate -> bool [J, G] (tdr_query phase 1).

    A way survives when it holds the target's bits and the required labels,
    and no vertical level is blocked (no real, non-forbidden label) before
    a level that already reached the target."""
    has_tgt = bitset.words_contain(h_vtx, vbits[:, None, :])
    has_req = bitset.words_contain(h_lab, req[:, None, :])
    real = v_lab & ~forb[:, None, None, :] & ~null_plane[None, None, None, :]
    blocked = (real == 0).all(dim=-1)                            # [J, G, k]
    reached = bitset.words_contain(v_vtx, vbits[:, None, None, :])
    reached_upto = torch.cumsum(reached.to(torch.int32), dim=-1) > 0
    not_before = torch.cat(
        [torch.ones_like(reached_upto[..., :1]), ~reached_upto[..., :-1]],
        dim=-1)
    refuted = (blocked & not_before).any(dim=-1)
    return has_tgt & has_req & ~refuted


def pad_k(x: torch.Tensor, k_pad: int) -> torch.Tensor:
    """Zero-pad the row axis of ``x`` up to ``k_pad`` rows."""
    if x.shape[0] < k_pad:
        x = torch.cat([x, x.new_zeros((k_pad - x.shape[0],) + x.shape[1:])])
    return x


def k_block_summaries(x: torch.Tensor, kb: int, bk: int):
    """Per-k-block column-OR int32 [KB, W] and any-bit flags int32 [KB]."""
    xr = pad_k(x, kb * bk).reshape(kb, bk, x.shape[1])
    colr = bitset.or_reduce(xr, axis=1)
    xany = (xr != 0).any(dim=2).any(dim=1).to(torch.int32)
    return colr, xany


def block_sparse_matmul_ref(comp: BlockCompressed,
                            x: torch.Tensor) -> torch.Tensor:
    """B1's contraction over a ``BlockCompressed`` A: ONE blocks resolve
    through the k-block column-OR, MIXED blocks are contracted from the
    pool and OR-scattered into their row-blocks.  ``x`` int32 [V, W] with
    ``V <= K`` (zero-padded) -> int32 [M, W]."""
    m, _ = comp.shape
    mb, kb = comp.grid
    br, bw = comp.br, comp.bw
    bk = bw * WORD
    w = x.shape[1]
    xr = pad_k(x, kb * bk).reshape(kb, bk, w)
    colr, xany = k_block_summaries(x, kb, bk)

    one = (comp.states == ALL_ONE) & (xany != 0)[None, :]
    one_bi, one_bj = torch.nonzero(one, as_tuple=True)
    one_or = bitset.segment_or_words(colr[one_bj], one_bi, num_segments=mb)

    mix_or = torch.zeros((mb, br * w), dtype=torch.int32, device=x.device)
    p = comp.pool.shape[0]
    step = max(1, _SLAB // (bk * w * WORD))
    for p0 in range(0, p, step):
        a_bits = bitset.unpack_bits(comp.pool[p0:p0 + step], bk)  # [p,br,bk]
        x_blk = xr[comp.mix_bj[p0:p0 + step].long()]              # [p,bk,W]
        x_bits = bitset.unpack_bits(x_blk, w * WORD)
        prod = torch.bmm(a_bits.to(torch.float32), x_bits.to(torch.float32))
        contrib = bitset.pack_bits(prod > 0)                      # [p,br,W]
        mix_or |= bitset.segment_or_words(
            contrib.reshape(-1, br * w), comp.mix_bi[p0:p0 + step],
            num_segments=mb)
    out = mix_or.reshape(mb, br, w) | one_or[:, None, :]
    return out.reshape(mb * br, w)[:m]
