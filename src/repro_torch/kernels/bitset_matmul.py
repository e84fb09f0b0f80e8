"""Wrapper of the ``bitset_matmul`` CUDA kernel (``csrc/bitset_matmul.cu``).

Computes ``out[i, w] = OR_j (A[i, j] & X[j, w])`` over packed int32 words:
A ``[M, K/32]``, X ``[K, W]`` -> ``[M, W]``.  Replaces the TPU kernel
``src/repro/kernels/bitset_matmul.py::bitset_matmul``.  On this card it is
bound by reading A (the packed adjacency, almost all zero words); the
kernel streams each row of A through one warp in coalesced loads and
gathers X rows only for set bits (see the note in the source).
"""
from __future__ import annotations

import torch

from . import _build

WORD = 32


def cuda_bitset_matmul(a_packed: torch.Tensor,
                       x: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on CUDA tensors; allocates the output."""
    dev = a_packed.device
    if dev.type != "cuda":
        raise ValueError("cuda_bitset_matmul takes CUDA tensors")
    _build.check_operand(a_packed, "a_packed", torch.int32, dev)
    _build.check_operand(x, "x", torch.int32, dev)
    m, kw = a_packed.shape
    k, w = x.shape
    if kw * WORD != k:
        raise ValueError(f"shape mismatch: A {tuple(a_packed.shape)}, "
                         f"X {tuple(x.shape)}")
    out = torch.empty((m, w), dtype=torch.int32, device=dev)
    _build.launch("bitset_matmul", "tdr_bitset_matmul", dev,
                  a_packed.data_ptr(), x.data_ptr(), out.data_ptr(),
                  m, kw, w)
    return out
