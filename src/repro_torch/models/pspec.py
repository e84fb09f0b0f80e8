"""Logical-axis activation sharding constraints on a ``DeviceMesh``.

A port of ``src/repro/models/pspec.py``.  Models call
``constrain(x, "batch", None, "heads", None)``; the launcher installs a
mesh and a logical -> physical mapping first
(``use_mesh(mesh, {"batch": ("pod", "data"), "heads": "model", ...})``).
Without an installed mesh every call returns ``x`` itself, so the
single-device paths never notice.

Under a mesh, ``constrain`` redistributes a DTensor to the placements
its logical axes resolve to (``torch.distributed.tensor``'s
``Shard``/``Replicate`` in place of a ``NamedSharding``); a plain tensor
is taken as replicated, which is what JAX assumes of an unsharded array.
``use_mesh`` turns on DTensor's implicit replication for the same reason:
positions, masks and scalars the models build as plain tensors meet
sharded activations as replicated operands.

Divisibility guard: a logical axis resolves to its physical axis only
when the dimension divides evenly; otherwise that dim is left unsharded
(e.g. a 40-head model on a 16-wide model axis).  As in the reference, an
axis mapped to a tuple of mesh axes (``"batch"``) is applied unguarded;
DTensor then shards the dim unevenly.  A dim of size 1 is never
sharded: its one shard is the whole, and DTensor refuses the reshapes
(an einsum's squeeze of a group axis of 1) that JAX takes in stride.

Where DTensor has no working sharding rule for an op the models use,
the port replicates the operand's sharded dim at that point through
``replicated``, which counts the point by name in ``REPLICATED``: the
dry-run records the counts, so no redistribution is silent.
"""
from __future__ import annotations

import collections
import contextlib
import threading
from typing import Optional

import torch

_state = threading.local()

# explicit redistributions to Replicate(), by the name of the point
REPLICATED: collections.Counter = collections.Counter()


class PartitionSpec(tuple):
    """Per-dimension mesh axes of a tensor: each entry is ``None``, a mesh
    axis name, or a tuple of names (one dim over several axes, major
    first).  Shorter than the tensor's rank means the rest are ``None``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}" if len(self) != 1 \
            else f"P({self[0]!r})"


P = PartitionSpec


def mesh_shape(mesh) -> dict:
    """``{axis name: size}`` of a ``DeviceMesh``, in mesh order."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def placements(spec, mesh) -> tuple:
    """One ``Shard(d)``/``Replicate()`` per mesh dimension for ``spec``.

    A tuple entry shards one tensor dimension over several mesh
    dimensions; they must appear in mesh order (the major one first),
    which is DTensor's order of nested shards and the reference's
    ``P(("pod", "data"))``."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"{spec}: axes {axes} of dim {d} are not in "
                             f"mesh order {tuple(names)}")
        for i in idx:
            if isinstance(out[i], Shard):
                raise ValueError(f"{spec}: mesh axis {names[i]!r} shards "
                                 "two dims")
            out[i] = Shard(d)
    return tuple(out)


def set_mesh(mesh, mapping: Optional[dict] = None) -> None:
    _state.mesh = mesh
    _state.mapping = mapping or {}


def get_mesh():
    return getattr(_state, "mesh", None)


def get_mapping() -> dict:
    return getattr(_state, "mapping", {})


@contextlib.contextmanager
def use_mesh(mesh, mapping: dict):
    from torch.distributed.tensor.experimental import implicit_replication
    prev = (getattr(_state, "mesh", None), getattr(_state, "mapping", {}))
    set_mesh(mesh, mapping)
    try:
        with implicit_replication():
            yield
    finally:
        set_mesh(*prev)


def _axis_size(mesh, phys) -> int:
    if phys is None:
        return 1
    shape = mesh_shape(mesh)
    if isinstance(phys, (tuple, list)):
        n = 1
        for a in phys:
            n *= shape[a]
        return n
    return shape[phys]


def as_dtensor(x: torch.Tensor, mesh):
    """``x`` as a DTensor on ``mesh``; a plain tensor is replicated."""
    from torch.distributed.tensor import DTensor, Replicate
    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def constrain(x: torch.Tensor, *logical) -> torch.Tensor:
    mesh = getattr(_state, "mesh", None)
    if mesh is None:
        return x
    mapping = getattr(_state, "mapping", {})
    spec = []
    for dim, name in zip(x.shape, logical):
        phys = mapping.get(name) if name is not None else None
        if phys is None or dim == 1:
            spec.append(None)
            continue
        size = _axis_size(mesh, phys)
        spec.append(tuple(phys) if isinstance(phys, (tuple, list)) else phys
                    if dim % size == 0 else None)
    return _Constrained.apply(as_dtensor(x, mesh), placements(P(*spec), mesh))


class _Constrained(torch.autograd.Function):
    """A DTensor redistributed to ``want``, and its gradient redistributed
    to ``want`` too: JAX's sharding constraint binds the cotangent as well
    as the value.  DTensor's own backward would hand on partial sums
    (from a column-parallel product's input gradient, or a reduction's),
    and the product before would then run whole on every rank that holds
    a part."""

    @staticmethod
    def forward(ctx, x, want):
        ctx.want = want
        if tuple(x.placements) == want:
            return x.view_as(x)
        return x.redistribute(x.device_mesh, want)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != ctx.want:
            g = g.redistribute(g.device_mesh, ctx.want)
        return g, None


def replicated(x, point: str, dim: int):
    """``x`` with tensor dim ``dim`` whole on every rank (the mesh dims
    that shard it gather it), counted under ``point`` in ``REPLICATED``;
    ``x`` itself without a mesh, when it is no DTensor or when ``dim`` is
    not sharded.  The models call it before an op that DTensor cannot
    run on that dim sharded."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if getattr(_state, "mesh", None) is None or not isinstance(x, DTensor):
        return x
    dim %= x.ndim
    want = tuple(Replicate() if isinstance(p, Shard)
                 and p.dim % x.ndim == dim else p for p in x.placements)
    if want == tuple(x.placements):
        return x
    REPLICATED[point] += 1
    return x.redistribute(x.device_mesh, want)


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose backward hands on a contiguous gradient:
    DTensor's ``to_local`` backward gives the local gradient the
    forward's (contiguous) global strides, whatever its own layout."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def local(fn, *args, axes: tuple, out_axes: tuple, point: str):
    """``fn(*args)`` on this rank's shards, for an ``fn`` whose results are
    independent along some axes (attention's and the scans' batch and
    heads).  ``axes[i]`` gives, for argument i, the tensor dim of each
    such axis (``None`` where it lacks one); ``out_axes[j]`` the same for
    result j (one result: a tensor; several: a tuple).

    A mesh dim shards at most one axis, the same in every argument that
    has it, and only where each such argument's dim divides evenly; other
    arguments are whole on it.  Arguments are redistributed to that
    layout first (a gather counts under ``point``), and plain tensor
    arguments (masks, positions) are taken whole.  Without a mesh or a
    DTensor argument this is ``fn(*args)``: the same ops on whole
    tensors, which is why a 1x1 mesh gives the unmeshed result bit for
    bit.  (DTensor itself would merge an einsum's batch and head dims into
    one dim sharded two ways, and gather it again in the backward.)"""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = getattr(_state, "mesh", None)
    if mesh is None or not any(isinstance(a, DTensor) for a in args):
        return fn(*args)
    # a plain tensor with an axis (a scan's zero state) is replicated
    args = [as_dtensor(a, mesh) if isinstance(a, torch.Tensor) and any(
        d is not None for d in ax) else a for a, ax in zip(args, axes)]
    ds = [(i, a) for i, a in enumerate(args) if isinstance(a, DTensor)]
    mesh = ds[0][1].device_mesh
    n_axes = len(axes[0])
    # each axis's global size, from the first argument that has it
    size = [next((a.shape[axes[i][k]] for i, a in ds
                  if axes[i][k] is not None), None) for k in range(n_axes)]
    split = [1] * n_axes
    plan = []                       # the axis each mesh dim shards, or None
    for m in range(mesh.ndim):
        votes = [k for i, a in ds for k in range(n_axes)
                 if axes[i][k] is not None
                 and isinstance(a.placements[m], Shard)
                 and a.placements[m].dim % a.ndim == axes[i][k]]
        k = votes[0] if votes else None
        if k is not None and all(
                a.shape[axes[i][k]] % (split[k] * mesh.shape[m]) == 0
                for i, a in ds if axes[i][k] is not None):
            split[k] *= mesh.shape[m]
            plan.append(k)
        else:
            plan.append(None)

    def layout(ax):
        return tuple(Replicate() if k is None or ax[k] is None
                     else Shard(ax[k]) for k in plan)
    local_args = list(args)
    for i, a in ds:
        want = layout(axes[i])
        if want != tuple(a.placements):
            if any(isinstance(p, Shard) and not isinstance(w, Shard)
                   for p, w in zip(a.placements, want)):
                REPLICATED[point] += 1
            a = a.redistribute(mesh, want)
        # an argument whole along a sharded axis it lacks (a weight beside
        # batch rows) gets a gradient that is a partial sum over that dim
        grad = tuple(Partial() if k is not None and axes[i][k] is None
                     else w for k, w in zip(plan, want))
        a = a.to_local(grad_placements=grad)
        local_args[i] = _ContiguousGrad.apply(a) if a.requires_grad else a
    prev = (_state.mesh, _state.mapping)
    set_mesh(None)           # fn is one rank's single-device code
    try:
        out = fn(*local_args)
    finally:
        set_mesh(*prev)
    outs = out if isinstance(out, tuple) else (out,)

    def wrap(t, ax):
        t = t.contiguous()
        shape = list(t.shape)
        for k, d in enumerate(ax):
            if d is not None and k in plan:
                shape[d] = size[k]
        stride = [1] * len(shape)
        for d in range(len(shape) - 2, -1, -1):
            stride[d] = stride[d + 1] * shape[d + 1]
        return DTensor.from_local(t, mesh, layout(ax), run_check=False,
                                  shape=torch.Size(shape),
                                  stride=tuple(stride))
    wrapped = tuple(wrap(t, ax) for t, ax in zip(outs, out_axes))
    return wrapped if isinstance(out, tuple) else wrapped[0]


def split_heads(t: torch.Tensor, heads: int, width: int) -> torch.Tensor:
    """``t`` [..., heads * width] as [..., heads, width].  Under a mesh, a
    last dim sharded into more parts than ``heads`` divides by (8 KV heads
    over a 16-wide axis) is gathered first (counted as "heads.uneven"):
    DTensor refuses to split an uneven shard, which GSPMD reshards."""
    from torch.distributed.tensor import DTensor, Shard
    if isinstance(t, DTensor):
        parts = 1
        for n, p in zip(t.device_mesh.shape, t.placements):
            if isinstance(p, Shard) and p.dim % t.ndim == t.ndim - 1:
                parts *= n
        if heads % parts:
            t = replicated(t, "heads.uneven", -1)
    return t.reshape(*t.shape[:-1], heads, width)


def logical_axis_size(name: str) -> int:
    """Physical size of a logical axis under the installed mapping (1 if
    no mesh/mapping)."""
    mesh = getattr(_state, "mesh", None)
    if mesh is None:
        return 1
    phys = getattr(_state, "mapping", {}).get(name)
    return _axis_size(mesh, phys) if phys is not None else 1


def default_mapping(multi_pod: bool) -> dict:
    return {
        "batch": ("pod", "data") if multi_pod else ("data",),
        "heads": "model",
        "kv": "model",
        "vocab": "model",
        "ff": "model",
        "experts": "model",
        "embed": None,
        "seq": None,
        "sp": "data",     # sequence-parallel axis for batch-1 long context
    }
