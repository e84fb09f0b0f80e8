"""Wrapper of the ``lane_matmul`` CUDA kernel (``csrc/lane_matmul.cu``).

Computes ``out[i, c] = (+)_j (A[i, j] (x) X[j, c])`` with A a packed int32
bit-matrix ``[M, K/32]`` and X unsigned semiring lanes ``[K, W]`` stored as
uint8 / int16 / int32 for 8 / 16 / 32-bit lanes (``repro_torch.semiring``)
-> ``[M, W]`` in X's dtype.  ``op`` is "or", "min" (identity = the lane
maximum, INF) or "sum" (saturating at ``cap``).  Replaces the TPU kernel
``src/repro/kernels/bitset_matmul.py::lane_matmul``.

It is bound by reading A once: every caller passes a sparse graph operand
(a label class in ``dist_batch``, the full adjacency in the engine's lane
rounds), whose ``M * K / 8`` bytes dwarf the X rows its set bits select.
At V = 32,768 and 3.35 TB/s the bounds are 0.0431 ms for ``dist_batch``'s
``min``/uint16 product (W = 128), 0.0500 ms for
``Engine.propagate(sr=COUNT)`` (``sum``/uint32, W = 128) and 0.0450 ms for
a round of ``Engine.closure(sr=DIST8)`` over 256 sources (``min``/uint8,
W = 256).

Design: a persistent grid of warps, one row of A at a time, streamed once
in 16-byte loads with four in flight a lane; the row's set bits are
compacted into a shared list, and every tile of W walks that list, its X
rows loaded 16 bytes a lane with four in flight and folded on packed
lanes.  W wider than 512 bytes of lanes costs more passes over the list,
not over A.  On an NVIDIA H100 80GB HBM3 at 700.00 W
(``tools/chip_lane.py``) the three products take 0.0509 / 0.0631 / 0.0549
ms, against 0.0595 / 0.0801 / 0.1041 for the kernel this design
replaced; the stream of A alone (an all-zero A) takes 0.0503 ms.
A form that streamed A with ``cp.async.bulk`` copies into shared memory
was slower on every row and was dropped (PERF.md, B4).
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
