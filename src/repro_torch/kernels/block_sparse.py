"""Wrapper of the ``block_sparse_matmul`` CUDA kernel
(``csrc/block_sparse.cu``).

The contraction of ``bitset_matmul`` with A in ``BlockCompressed`` form:
ZERO blocks and dead k-blocks are skipped, ONE blocks OR in the k-block
column-OR of X, MIXED blocks are contracted from the pool.  Replaces the
TPU kernel ``src/repro/kernels/block_sparse.py::block_sparse_matmul``.  It
is bound by the bytes of the state grid and of the blocks the frontier
keeps live; the kernel scans a row-block's states in one warp and touches
pool and X words only for live blocks.  ``x_any``/``col_or`` are
recomputed on every call in plain torch (``ref.k_block_summaries``).
"""
from __future__ import annotations

import torch

from . import _build
from .ref import k_block_summaries, pad_k
from ..compressed import BlockCompressed

WORD = 32
_OUTS_PER_WARP = 256   # 32 lanes x 8 register accumulators in the kernel


def cuda_block_sparse_matmul(comp: BlockCompressed,
                             x: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: ``x`` int32 ``[V, W]`` with ``V <= K`` (zero
    padded to the block grid here) -> int32 ``[M, W]``."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError("cuda_block_sparse_matmul takes CUDA tensors")
    m, _ = comp.shape
    mb, kb = comp.grid
    br, bw = comp.br, comp.bw
    if br > _OUTS_PER_WARP:
        raise ValueError(f"block_rows={br} exceeds {_OUTS_PER_WARP}")
    bk = bw * WORD
    w = x.shape[1]
    if x.shape[0] > kb * bk:
        raise ValueError(f"x has {x.shape[0]} rows > block grid {kb * bk}")
    _build.check_operand(x, "x", torch.int32, dev)
    _build.check_operand(comp.states, "states", torch.uint8, dev)
    _build.check_operand(comp.slots, "slots", torch.int32, dev)
    _build.check_operand(comp.pool, "pool", torch.int32, dev)
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
