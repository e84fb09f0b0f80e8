"""Production mesh factory on a ``torch.distributed`` ``DeviceMesh``.

A port of ``src/repro/launch/mesh.py``.  A function, never a
module-level constant, so importing this module touches no process
group.  The mesh spans the first 256 (16 x 16) or 512 (2 x 16 x 16)
ranks of the default group; the dry-run gets them from a ``"fake"``
process group in its own process, and tests and the card build their
own small meshes.
"""
from __future__ import annotations

import math

import torch.distributed as dist

from ..bitset import resolve_device


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """The ``("data", "model")`` 16 x 16 mesh, or ``("pod", "data",
    "model")`` 2 x 16 x 16, on ``device``'s type (default: the card)."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh
    dev = resolve_device(device)
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have < n:
        raise RuntimeError(
            f"mesh {shape} needs {n} ranks, the default process group has "
            f"{have}: the dry-run initialises a 'fake' process group of "
            f"{n} ranks (torch.distributed.init_process_group('fake', "
            "store=FakeStore(), world_size=...)) in its own process")
    return DeviceMesh(dev.type, torch.arange(n).reshape(shape),
                      mesh_dim_names=axes)


def batch_axes(mesh) -> tuple[str, ...]:
    """Axes the global batch is sharded over."""
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


def tp_axis(mesh) -> str:
    return "model"


def fsdp_axis(mesh) -> str:
    return "data"
