"""Wrappers of the ``way_filter`` CUDA kernel (``csrc/way_filter.cu``).

The fused phase-1 per-(job, way) viability predicate -> bool ``[J, G]``
over packed int32 words.  Replaces the TPU kernel
``src/repro/kernels/pattern_filter.py::way_filter``.  ``cuda_way_filter_at``
takes the index planes with the job endpoints ``u``/``v`` and gathers the
rows inside the kernel; ``cuda_way_filter`` takes rows already gathered
per job and launches the same kernel with identity indices.  It is bound
by the bytes of the rows it reads, and at the main path's sizes by the
time of one launch; the kernel spreads (job, way) pairs over the SMs, 8
lanes to a pair (see the note in the source).
"""
from __future__ import annotations

import torch

from . import _build

_VEC_ALIGN = 16       # bytes of one vector load


def _launch(u, v, vtx, h_vtx, h_lab, v_vtx, v_lab, req, forb, null_plane,
            j: int) -> torch.Tensor:
    """Check shapes against the planes and launch; ``u``/``v`` None means
    the planes are rows gathered per job."""
    dev = h_vtx.device
    if dev.type != "cuda":
        raise ValueError("the way_filter kernel takes CUDA tensors")
    n_u, g, wv = h_vtx.shape
    k = v_vtx.shape[2]
    wl = h_lab.shape[-1]
    n_v = vtx.shape[0] if v is not None else j
    if k > 30:
        raise ValueError(f"k={k} levels exceed the kernel's 30")
    shapes = {"vtx": (n_v, wv), "h_vtx": (n_u, g, wv),
              "h_lab": (n_u, g, wl), "v_vtx": (n_u, g, k, wv),
              "v_lab": (n_u, g, k, wl), "req": (j, wl), "forb": (j, wl),
              "null_plane": (wl,)}
    args = dict(vtx=vtx, h_vtx=h_vtx, h_lab=h_lab, v_vtx=v_vtx, v_lab=v_lab,
                req=req, forb=forb, null_plane=null_plane)
    for name, t in args.items():
        _build.check_operand(t, name, torch.int32, dev)
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shapes[name]}")
    for name, t in (("u", u), ("v", v)):
        if t is not None:
            _build.check_operand(t, name, torch.int64, dev)
            if tuple(t.shape) != (j,):
                raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                                 f"expected ({j},)")
    vec = 4 if wv % 4 == 0 and all(
        t.data_ptr() % _VEC_ALIGN == 0 for t in (vtx, h_vtx, v_vtx)) else 1
    out = torch.empty((j, g), dtype=torch.uint8, device=dev)
    _build.launch("way_filter", "tdr_way_filter", dev,
                  *(0 if t is None else t.data_ptr() for t in (u, v)),
                  *(t.data_ptr() for t in args.values()), out.data_ptr(),
                  j, g, k, wv, wl, n_u, n_v, vec)
    return out.view(torch.bool)


def cuda_way_filter_at(u, v, req, forb, null_plane, vtx_packed, h_vtx,
                       h_lab, v_vtx, v_lab) -> torch.Tensor:
    """Launch the kernel on the index planes: job endpoints ``u``/``v``
    int64 ``[J]``, ``req``/``forb [J,Wl]``, ``null_plane [Wl]``,
    ``vtx_packed [V,Wv]``, ``h_vtx [V,G,Wv]``, ``h_lab [V,G,Wl]``,
    ``v_vtx [V,G,k,Wv]``, ``v_lab [V,G,k,Wl]``."""
    return _launch(u, v, vtx_packed, h_vtx, h_lab, v_vtx, v_lab, req, forb,
                   null_plane, u.shape[0])


def cuda_way_filter(h_vtx, h_lab, v_vtx, v_lab, vbits, req, forb,
                    null_plane) -> torch.Tensor:
    """Launch the kernel on rows gathered per job: ``h_vtx [J,G,Wv]``,
    ``h_lab [J,G,Wl]``, ``v_vtx [J,G,k,Wv]``, ``v_lab [J,G,k,Wl]``,
    ``vbits [J,Wv]``, ``req``/``forb [J,Wl]``, ``null_plane [Wl]``."""
    return _launch(None, None, vbits, h_vtx, h_lab, v_vtx, v_lab, req, forb,
                   null_plane, h_vtx.shape[0])
