"""Wrapper of the ``popcount_rows`` CUDA kernel (``csrc/popcount.cu``).

Population count over the trailing axis of packed int32 words ``[N, W]``
-> int32 ``[N]``.  Replaces the TPU kernel
``src/repro/kernels/popcount.py::popcount_rows``.  A pure streaming reduce,
bound by the bytes it reads; the kernel gives each row a group of lanes
sized to W, so the loads of a narrow plane coalesce across rows, reads
16 bytes a lane where W and the alignment allow, and sizes its grid to the
card, each warp keeping several rows' loads in flight.
"""
from __future__ import annotations

import torch

from . import _build


def cuda_popcount_rows(words: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on a CUDA tensor; allocates the output."""
    dev = words.device
    if dev.type != "cuda":
        raise ValueError("cuda_popcount_rows takes CUDA tensors")
    _build.check_operand(words, "words", torch.int32, dev)
    if words.dim() != 2:
        raise ValueError(f"words must be [N, W], got {tuple(words.shape)}")
    n, w = words.shape
    vec = int(w % 4 == 0 and words.data_ptr() % 16 == 0)
    out = torch.empty(n, dtype=torch.int32, device=dev)
    _build.launch("popcount_rows", "tdr_popcount_rows", dev,
                  words.data_ptr(), out.data_ptr(), n, w, vec)
    return out
