"""Wrappers of the ``block_sparse_matmul`` and ``block_sparse_lane_matmul``
CUDA kernels (``csrc/block_sparse.cu``, ``csrc/block_sparse_lane.cu``).

The contraction of ``bitset_matmul`` with A in ``BlockCompressed`` form:
ZERO blocks and dead k-blocks are skipped, ONE blocks OR in the k-block
column-OR of X, MIXED blocks are contracted from the pool.  Replaces the
TPU kernel ``src/repro/kernels/block_sparse.py::block_sparse_matmul``.  It
is bound by the bytes of the state grid and of the blocks the frontier
keeps live; the kernel scans a row-block's states in one warp and touches
pool and X words only for live blocks.  ``x_any``/``col_or`` are
recomputed on every call in plain torch (``ref.k_block_summaries``).

``block_sparse_lane_matmul`` is the same walk over semiring lanes (the
``lane_matmul`` contraction with A block-compressed): ZERO blocks and dead
k-blocks add the identity, ONE blocks the k-block column-(+) of X, MIXED
blocks fold the X rows of their pool bits.  Replaces the TPU kernel
``src/repro/kernels/block_sparse.py::block_sparse_lane_matmul``.  Its
summaries ``col_r``/``x_any`` are plain torch as well
(``ref.k_block_lane_summaries``), as the TPU version computes them outside
its kernel.
"""
from __future__ import annotations

import torch

from . import _build, ref
from .lane_matmul import OPS, check_lanes
from .ref import k_block_summaries, pad_k
from ..compressed import BlockCompressed

WORD = 32
_OUTS_PER_WARP = 256   # 32 lanes x 8 register accumulators in the kernel


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
    """Launch the kernel: ``x`` int32 ``[V, W]`` with ``V <= K`` (zero
    padded to the block grid here) -> int32 ``[M, W]``."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError("cuda_block_sparse_matmul takes CUDA tensors")
    _check_block_operands(comp, x, torch.int32)
    m, _ = comp.shape
    mb, kb = comp.grid
    br, bw = comp.br, comp.bw
    bk = bw * WORD
    w = x.shape[1]
    colr, xany = k_block_summaries(x, kb, bk)
    xp = pad_k(x, kb * bk).contiguous()
    out = torch.empty((mb * br, w), dtype=torch.int32, device=dev)
    tw = max(1, min(w, _OUTS_PER_WARP // br))
    _build.launch("block_sparse_matmul", "tdr_block_sparse_matmul", dev,
                  comp.states.data_ptr(), comp.slots.data_ptr(),
                  comp.pool.data_ptr(), xany.contiguous().data_ptr(),
                  colr.contiguous().data_ptr(), xp.data_ptr(),
                  out.data_ptr(), mb, kb, br, bw, w, tw)
    return out[:m]


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
