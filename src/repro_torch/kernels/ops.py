"""Kernel entry points used by the engine and the query path.

Each call dispatches on the device of its tensors: CUDA tensors launch the
hand-written kernel (and raise if it cannot launch), CPU tensors run the
plain PyTorch version in ``ref``.  There is no fallback from one to the
other.  ``KERNEL_LAUNCHES`` counts launches per kernel, so a run can show
that the main path went through the kernels.
"""
from __future__ import annotations

import torch

from . import ref
from ._build import KERNEL_LAUNCHES  # noqa: F401  (re-exported)
from .bitset_matmul import cuda_bitset_matmul
from .block_sparse import (block_sparse_lane_matmul,  # noqa: F401
                           cuda_block_sparse_matmul)
from .class_round import cuda_class_round
from .lane_matmul import cuda_lane_matmul
from .pattern_filter import cuda_way_filter, cuda_way_filter_at
from .popcount import cuda_popcount_rows
from .. import bitset
from ..compressed import BlockCompressed


def frontier_step(a_packed: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """One boolean-semiring expansion round: OR_j (A[i,j] & X[j,:])."""
    if a_packed.is_cuda:
        return cuda_bitset_matmul(a_packed, x.contiguous())
    return ref.bitset_matmul_ref(a_packed, x)


def class_round(lists_rev, lists_fwd, allow, has, sh, sup_need, cor_w, f,
                b, state, cf: bool, cb: bool):
    """One phase-2 boolean round of the bidirectional subset expansion on
    each direction's per-row edge lists (``compressed.EdgeLists``) from
    the last round's per-pass ``state`` -> ``(f_next, b_next, state)``;
    ``state`` is int32 ``[3, passes]``: forward flags, backward flags,
    done words (see ``ref.class_round_ref``)."""
    if f.is_cuda:
        return cuda_class_round(lists_rev, lists_fwd, allow, has, sh,
                                sup_need, cor_w, f, b, state, cf, cb)
    return ref.class_round_ref(lists_rev, lists_fwd, allow, has, sh,
                               sup_need, cor_w, f, b, state, cf, cb)


def frontier_step_mxu(a_packed: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The unpacked lowering of ``frontier_step``: both operands as bf16
    0/1 matrices (the reference's MXU operands), one float32
    ``torch.matmul``, threshold, repack.  32x the bytes of the packed
    kernel; the JAX package computes it with ``dot_general`` outside any
    Pallas kernel, so it is a library product here on either device."""
    a_bits = ref.unpacked_bf16(a_packed, x.shape[0])
    x_bits = ref.unpacked_bf16(x, x.shape[1] * bitset.WORD)
    y = torch.matmul(a_bits.float(), x_bits.float())
    return bitset.pack_bits(y > 0)


def frontier_step_lanes(a_packed: torch.Tensor, x: torch.Tensor, *,
                        op: str, cap: int = 0) -> torch.Tensor:
    """One semiring expansion round over stored lanes (one semiring value
    per element, not packed bits): ``(+)_j (A[i,j] (x) X[j,:])``, with
    ``op`` "or", "min" (identity INF) or "sum" (saturating at ``cap``)."""
    if a_packed.is_cuda:
        return cuda_lane_matmul(a_packed, x.contiguous(), op=op, cap=cap)
    return ref.lane_matmul_ref(a_packed, x, op=op, cap=cap)


def frontier_step_sparse(comp: BlockCompressed,
                         x: torch.Tensor) -> torch.Tensor:
    """Block-sparse expansion round over a ``BlockCompressed`` adjacency."""
    if x.is_cuda:
        return cuda_block_sparse_matmul(comp, x.contiguous())
    return ref.block_sparse_matmul_ref(comp, x)


def filter_ways(h_vtx, h_lab, v_vtx, v_lab, vbits, req, forb,
                null_plane) -> torch.Tensor:
    """Fused per-(job, way) viability predicate -> bool [J, G], on rows
    already gathered per job."""
    if h_vtx.is_cuda:
        return cuda_way_filter(*(t.contiguous() for t in (
            h_vtx, h_lab, v_vtx, v_lab, vbits, req, forb, null_plane)))
    return ref.way_filter_ref(h_vtx, h_lab, v_vtx, v_lab, vbits, req, forb,
                              null_plane)


def filter_ways_at(u, v, req, forb, null_plane, vtx_packed, h_vtx, h_lab,
                   v_vtx, v_lab) -> torch.Tensor:
    """``filter_ways`` on the index planes themselves: job ``j`` reads the
    rows of ``u[j]`` and the target bits ``vtx_packed[v[j]]``.  On a card
    the kernel gathers the rows; nothing ``[J, G, ...]`` is built."""
    if h_vtx.is_cuda:
        return cuda_way_filter_at(*(t.contiguous() for t in (
            u, v, req, forb, null_plane, vtx_packed, h_vtx, h_lab, v_vtx,
            v_lab)))
    return ref.way_filter_at_ref(u, v, req, forb, null_plane, vtx_packed,
                                 h_vtx, h_lab, v_vtx, v_lab)


def popcount(words: torch.Tensor) -> torch.Tensor:
    """Popcount over the trailing axis of int32 words [N, W] -> int32 [N]."""
    if words.is_cuda:
        return cuda_popcount_rows(words.contiguous())
    return ref.popcount_rows_ref(words)
