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
(the ``lane_matmul`` contraction with A block-compressed): ZERO blocks add
the identity, ONE blocks the k-block column-(+) of X, MIXED blocks fold the
X rows of their pool bits.  Replaces the TPU kernel
``src/repro/kernels/block_sparse.py::block_sparse_lane_matmul``.  It is
bound by the same bytes (X, the live lists, the pool blocks, the output);
its kernel walks the same live lists, one warp per row-block: the warp
compacts the non-zero pool words into a shared list with one ballot each,
and sub-groups of its lanes, which cover the W axis 16 bytes a lane where
W and the alignment allow, gather the X rows they select and fold them
into shared tiles of packed lanes.  Rows of X past ``V`` read as the
identity, and the column-(+) pre-pass runs on the card only when the
operand has ONE blocks (see the note in the source).
"""
from __future__ import annotations

import torch

from . import _build, ref
from .lane_matmul import OPS, check_lanes
from ..compressed import BlockCompressed

WORD = 32
_MAX_BLOCK_ROWS = 256  # block_sparse.cu keeps a block's rows in shared memory
# block_sparse.cu: W tile cap, shared accumulator words of one warp, X
# chunks one lane holds
_TILE_WORDS = 128
_SMEM_WORDS = 2048
_CHUNKS_PER_LANE = 2
# block_sparse_lane.cu: chunks of a W tile, one a lane
_LANE_TILE_CHUNKS = 32


def _check_block_operands(comp: BlockCompressed, x: torch.Tensor,
                          x_dtype: torch.dtype) -> None:
    """Raise unless the block operand and ``x`` fit the kernels."""
    if comp.br > _MAX_BLOCK_ROWS:
        raise ValueError(f"block_rows={comp.br} exceeds {_MAX_BLOCK_ROWS}")
    k = comp.grid[1] * comp.bw * WORD
    if x.shape[0] > k:
        raise ValueError(f"x has {x.shape[0]} rows > block grid {k}")
    dev = x.device
    _build.check_operand(x, "x", x_dtype, dev)
    _build.check_operand(comp.pool, "pool", torch.int32, dev)
    if comp.pool.data_ptr() % 16:
        raise ValueError("pool must be 16-byte aligned")
    for name in ("mix_off", "mix_bj", "one_off", "one_bj"):
        _build.check_operand(getattr(comp, name), name, torch.int32, dev)


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
    ``V <= K`` (rows past ``V`` read as the identity) -> ``[M, W]``.  One
    call is one launch on the current stream, two when the operand has ONE
    blocks (the k-block column-(+) first)."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError("cuda_block_sparse_lane_matmul takes CUDA tensors")
    check_lanes(x, op, cap)
    _check_block_operands(comp, x, x.dtype)
    m, _ = comp.shape
    mb, kb = comp.grid
    v, w = x.shape
    size = x.element_size()
    # 16-byte chunks of packed lanes, else 4 lanes widened to 32 bits; a
    # sum whose cap exceeds the lane maximum wraps as the plain version
    # does only on the widened path
    packed = ((w * size) % 16 == 0 and x.data_ptr() % 16 == 0
              and (op != "sum" or cap < 1 << (8 * size)))
    per = 16 // size if packed else 4
    tw = min(w, _LANE_TILE_CHUNKS * per)
    group = 1
    while group * per < tw:
        group *= 2
    n_one = comp.one_bj.numel()
    col_r = torch.empty((kb if n_one else 0, w), dtype=x.dtype, device=dev)
    out = torch.empty((m, w), dtype=x.dtype, device=dev)
    _build.launch("block_sparse_lane_matmul", "tdr_block_sparse_lane_matmul",
                  dev, comp.mix_off.data_ptr(), comp.mix_bj.data_ptr(),
                  comp.pool.data_ptr(), comp.one_off.data_ptr(),
                  comp.one_bj.data_ptr(), x.data_ptr(), col_r.data_ptr(),
                  out.data_ptr(), m, v, mb, kb, n_one, comp.br, comp.bw, w,
                  tw, group, int(packed), size, OPS[op], int(cap))
    return out


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
