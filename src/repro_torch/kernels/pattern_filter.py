"""Wrapper of the ``way_filter`` CUDA kernel (``csrc/way_filter.cu``).

The fused phase-1 per-(job, way) viability predicate -> bool ``[J, G]``
over packed int32 words gathered per job.  Replaces the TPU kernel
``src/repro/kernels/pattern_filter.py::way_filter``.  It is bound by the
bytes it streams; the kernel gives each (job, way) one thread that reads
its words once and stops at the first refutation.
"""
from __future__ import annotations

import torch

from . import _build


def cuda_way_filter(h_vtx, h_lab, v_vtx, v_lab, vbits, req, forb,
                    null_plane) -> torch.Tensor:
    """Launch the kernel on CUDA tensors: ``h_vtx [J,G,Wv]``,
    ``h_lab [J,G,Wl]``, ``v_vtx [J,G,k,Wv]``, ``v_lab [J,G,k,Wl]``,
    ``vbits [J,Wv]``, ``req``/``forb [J,Wl]``, ``null_plane [Wl]``."""
    dev = h_vtx.device
    if dev.type != "cuda":
        raise ValueError("cuda_way_filter takes CUDA tensors")
    j, g, wv = h_vtx.shape
    k = v_vtx.shape[2]
    wl = h_lab.shape[-1]
    shapes = {"h_vtx": (j, g, wv), "h_lab": (j, g, wl),
              "v_vtx": (j, g, k, wv), "v_lab": (j, g, k, wl),
              "vbits": (j, wv), "req": (j, wl), "forb": (j, wl),
              "null_plane": (wl,)}
    args = dict(h_vtx=h_vtx, h_lab=h_lab, v_vtx=v_vtx, v_lab=v_lab,
                vbits=vbits, req=req, forb=forb, null_plane=null_plane)
    for name, t in args.items():
        _build.check_operand(t, name, torch.int32, dev)
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shapes[name]}")
    out = torch.empty((j, g), dtype=torch.uint8, device=dev)
    _build.launch("way_filter", "tdr_way_filter", dev,
                  *(t.data_ptr() for t in args.values()), out.data_ptr(),
                  j, g, k, wv, wl)
    return out.bool()
