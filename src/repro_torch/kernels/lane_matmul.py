"""Wrapper of the ``lane_matmul`` CUDA kernel (``csrc/lane_matmul.cu``).

Computes ``out[i, c] = (+)_j (A[i, j] (x) X[j, c])`` with A a packed int32
bit-matrix ``[M, K/32]`` and X unsigned semiring lanes ``[K, W]`` stored as
uint8 / int16 / int32 for 8 / 16 / 32-bit lanes (``repro_torch.semiring``)
-> ``[M, W]`` in X's dtype.  ``op`` is "or", "min" (identity = the lane
maximum, INF) or "sum" (saturating at ``cap``).  Replaces the TPU kernel
``src/repro/kernels/bitset_matmul.py::lane_matmul``.  Like
``bitset_matmul`` it is bound by reading A (a label class of the packed
adjacency, almost all zero words); the kernel streams each row of A
through one warp and folds X rows only for set bits.
"""
from __future__ import annotations

import torch

from . import _build

WORD = 32
OPS = {"or": 0, "min": 1, "sum": 2}
LANE_DTYPES = (torch.uint8, torch.int16, torch.int32)


def check_lanes(x: torch.Tensor, op: str, cap: int) -> None:
    """Raise unless ``x`` holds stored lanes and ``op``/``cap`` are valid."""
    if x.dtype not in LANE_DTYPES:
        raise ValueError(f"lanes have dtype {x.dtype}; expected one of "
                         f"{LANE_DTYPES}")
    if op not in OPS:
        raise ValueError(f"unknown lane op {op!r}; expected one of "
                         f"{tuple(OPS)}")
    if not 0 <= int(cap) < 1 << 32:
        raise ValueError(f"cap={cap} is not a 32-bit unsigned value")


def cuda_lane_matmul(a_packed: torch.Tensor, x: torch.Tensor, *, op: str,
                     cap: int = 0) -> torch.Tensor:
    """Launch the kernel on CUDA tensors; allocates the output."""
    dev = a_packed.device
    if dev.type != "cuda":
        raise ValueError("cuda_lane_matmul takes CUDA tensors")
    check_lanes(x, op, cap)
    _build.check_operand(a_packed, "a_packed", torch.int32, dev)
    _build.check_operand(x, "x", x.dtype, dev)
    m, kw = a_packed.shape
    k, w = x.shape
    if kw * WORD != k:
        raise ValueError(f"shape mismatch: A {tuple(a_packed.shape)}, "
                         f"X {tuple(x.shape)}")
    out = torch.empty((m, w), dtype=x.dtype, device=dev)
    _build.launch("lane_matmul", "tdr_lane_matmul", dev,
                  a_packed.data_ptr(), x.data_ptr(), out.data_ptr(),
                  m, kw, w, x.element_size(), OPS[op], int(cap))
    return out
