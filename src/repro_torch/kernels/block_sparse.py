"""Wrappers of the ``block_sparse_matmul`` and ``block_sparse_lane_matmul``
CUDA kernels (``csrc/block_sparse.cu``, ``csrc/block_sparse_lane.cu``).

The contraction of ``bitset_matmul`` with A in ``BlockCompressed`` form:
ZERO blocks are skipped, ONE blocks OR in the k-block column-OR of X,
MIXED blocks are contracted from the pool.  Replaces the TPU kernel
``src/repro/kernels/block_sparse.py::block_sparse_matmul``.  It is bound by
the bytes of X, of the operand's live lists and of the pool blocks; the
kernel walks each row-block's MIXED and ONE lists
(``BlockCompressed.mix_off``/``one_off``) in parallel, and when the operand
has ONE blocks a pre-pass in the same call computes the column-OR on the
card (see the note in the source).

``block_sparse_lane_matmul`` is the same contraction over semiring lanes
(the ``lane_matmul`` contraction with A block-compressed): ZERO blocks and
dead k-blocks add the identity, ONE blocks the k-block column-(+) of X,
MIXED blocks fold the X rows of their pool bits.  Replaces the TPU kernel
``src/repro/kernels/block_sparse.py::block_sparse_lane_matmul``.  Its
kernel still scans each row-block's state grid in one warp, and its
summaries ``col_r``/``x_any`` are plain torch
(``ref.k_block_lane_summaries``), as the TPU version computes them outside
its kernel.
"""
from __future__ import annotations

import torch

from . import _build, ref
from .lane_matmul import OPS, check_lanes
from ..compressed import BlockCompressed

WORD = 32
_OUTS_PER_WARP = 256   # block_sparse_lane.cu: 32 lanes x 8 accumulators
# block_sparse.cu: W tile cap, shared accumulator words of one warp, X
# chunks one lane holds
_TILE_WORDS = 128
_SMEM_WORDS = 2048
_CHUNKS_PER_LANE = 2


def _check_block_operands(comp: BlockCompressed, x: torch.Tensor,
                          x_dtype: torch.dtype) -> None:
    """Raise unless the block operand and ``x`` fit the kernels."""
    if comp.br > _OUTS_PER_WARP:
        raise ValueError(f"block_rows={comp.br} exceeds {_OUTS_PER_WARP}")
    k = comp.grid[1] * comp.bw * WORD
    if x.shape[0] > k:
        raise ValueError(f"x has {x.shape[0]} rows > block grid {k}")
    dev = x.device
    _build.check_operand(x, "x", x_dtype, dev)
    _build.check_operand(comp.states, "states", torch.uint8, dev)
    _build.check_operand(comp.slots, "slots", torch.int32, dev)
    _build.check_operand(comp.pool, "pool", torch.int32, dev)


def cuda_block_sparse_matmul(comp: BlockCompressed,
                             x: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: ``x`` int32 ``[V, W]`` with ``V <= K`` (rows past
    ``V`` read as zero) -> int32 ``[M, W]``.  One call is one launch on the
    current stream, two when the operand has ONE blocks (the k-block
    column-OR first)."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError("cuda_block_sparse_matmul takes CUDA tensors")
    _check_block_operands(comp, x, torch.int32)
    for name in ("mix_off", "mix_bj", "one_off", "one_bj"):
        _build.check_operand(getattr(comp, name), name, torch.int32, dev)
    if comp.pool.data_ptr() % 16:
        raise ValueError("pool must be 16-byte aligned")
    m, _ = comp.shape
    mb, kb = comp.grid
    v, w = x.shape
    vec = 4 if w % 4 == 0 and x.data_ptr() % 16 == 0 else 1
    tw = min(w, _TILE_WORDS, 32 * _CHUNKS_PER_LANE * vec,
             _SMEM_WORDS // (comp.br + 1))
    if tw < vec:
        vec = 1
    tw = max(1, tw - tw % vec)
    lanes = 1
    while lanes * _CHUNKS_PER_LANE * vec < tw:
        lanes *= 2
    n_one = comp.one_bj.numel()
    col_or = torch.empty((kb if n_one else 0, w), dtype=torch.int32,
                         device=dev)
    out = torch.empty((m, w), dtype=torch.int32, device=dev)
    _build.launch("block_sparse_matmul", "tdr_block_sparse_matmul", dev,
                  comp.mix_off.data_ptr(), comp.mix_bj.data_ptr(),
                  comp.pool.data_ptr(), comp.one_off.data_ptr(),
                  comp.one_bj.data_ptr(), x.data_ptr(), col_or.data_ptr(),
                  out.data_ptr(), m, v, mb, kb, n_one, comp.br, comp.bw, w,
                  tw, vec, lanes)
    return out


def cuda_block_sparse_lane_matmul(comp: BlockCompressed, x: torch.Tensor, *,
                                  op: str, cap: int = 0) -> torch.Tensor:
    """Launch the lane kernel: ``x`` stored lanes ``[V, W]`` with
    ``V <= K`` (padded here with the identity) -> ``[M, W]``."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError("cuda_block_sparse_lane_matmul takes CUDA tensors")
    check_lanes(x, op, cap)
    _check_block_operands(comp, x, x.dtype)
    m, _ = comp.shape
    mb, kb = comp.grid
    br, bw = comp.br, comp.bw
    bk = bw * WORD
    w = x.shape[1]
    colr, xany = ref.k_block_lane_summaries(x, kb, bk, op, cap)
    xp = ref.pad_k_lanes(x, kb * bk, op).contiguous()
    out = torch.empty((mb * br, w), dtype=x.dtype, device=dev)
    tw = max(1, min(w, _OUTS_PER_WARP // br))
    _build.launch("block_sparse_lane_matmul", "tdr_block_sparse_lane_matmul",
                  dev, comp.states.data_ptr(), comp.slots.data_ptr(),
                  comp.pool.data_ptr(), xany.contiguous().data_ptr(),
                  colr.contiguous().data_ptr(), xp.data_ptr(),
                  out.data_ptr(), mb, kb, br, bw, w, tw, x.element_size(),
                  OPS[op], int(cap))
    return out[:m]


def block_sparse_lane_matmul(comp: BlockCompressed, x: torch.Tensor, *,
                             op: str, cap: int = 0) -> torch.Tensor:
    """``(+)_j (A[i,j] (x) X[j,:])`` with A block-compressed and X in
    stored semiring lanes; equal to ``lane_matmul`` on the decompressed
    adjacency.  A CUDA ``x`` launches the kernel, a CPU one runs the
    plain version."""
    if x.is_cuda:
        return cuda_block_sparse_lane_matmul(comp, x.contiguous(), op=op,
                                             cap=cap)
    return ref.block_sparse_lane_matmul_ref(comp, x, op=op, cap=cap)
