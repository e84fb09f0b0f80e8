"""Per-chip cost of a traced step, counted from the ops one rank runs.

The counterpart of ``src/repro/utils/hlo.py``, which parses XLA's
post-SPMD HLO text; torch has no HLO, so ``CostCounter`` is a dispatch
mode that sees every aten op a rank runs, on that rank's local shards:

* ``flops``            — 2·M·N·K per matmul (``mm``, ``addmm``, ``bmm``,
                         ``baddbmm``, which ``einsum`` and ``@`` lower
                         to) and per scaled-dot-product attention, by
                         ``torch.utils.flop_counter``'s formulas;
* ``hbm_bytes``        — Σ operand + output bytes of every op that moves
                         memory: in eager torch each op is its own kernel,
                         so every op except views, allocations and
                         metadata queries (the reference counts fused
                         kernels, since XLA fuses the elementwise chains);
* ``collective_bytes`` — per-rank link traffic by the reference's ring
                         model: all-reduce 2·in, all-gather out,
                         reduce-scatter in, all-to-all in, broadcast in;
* per-kind collective bytes and counts, and the largest memory and
  collective entries for drill-downs.

A dispatch mode above DTensor sees an op at its global shape; the
counter returns ``NotImplemented`` there, DTensor runs the op on its
local shards and runs its redistributions, and the counter counts
those (so on a 2-way data mesh a rank's FLOPs are half a 1x1 mesh's).
DTensor's sharding propagation infers each new op's global output
shape by running it on fake tensors and prices redistributions with
index arithmetic on small tensors; ``CostCounter`` runs the propagation
outside every dispatch mode, so neither it nor a ``MemTracker`` beside
it counts that work.  Ops that autograd's checkpointing recomputes in the backward run
again and count again, as recompute does in the compiled HLO.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# op-name fragment -> collective kind (c10d and functional collectives)
_COLLECTIVES = (("all_reduce", "all-reduce"), ("allreduce", "all-reduce"),
                ("all_gather", "all-gather"), ("allgather", "all-gather"),
                ("reduce_scatter", "reduce-scatter"),
                ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"),
                ("broadcast", "broadcast"))
# ops that allocate or read metadata without moving tensor bytes
_NO_MOVE = {"empty", "empty_strided", "empty_like", "new_empty",
            "new_empty_strided", "detach", "lift_fresh", "alias",
            "_local_scalar_dense", "wait_tensor", "sym_size", "sym_stride",
            "sym_numel", "sym_storage_offset", "is_same_size"}


@dataclasses.dataclass
class StepCost:
    """``HloCost``'s fields (``src/repro/utils/hlo.py``), per chip."""
    flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_bytes: float = 0.0
    collectives: Dict[str, float] = dataclasses.field(
        default_factory=lambda: collections.defaultdict(float))
    collective_counts: Dict[str, int] = dataclasses.field(
        default_factory=lambda: collections.defaultdict(int))
    # drill-down: (total_bytes, count, op, output shape, "")
    top_collectives: list = dataclasses.field(default_factory=list)
    top_memory: list = dataclasses.field(default_factory=list)

    def finalize(self, keep: int = 20):
        self.top_collectives = sorted(self.top_collectives,
                                      reverse=True)[:keep]
        self.top_memory = sorted(self.top_memory, reverse=True)[:keep]
        return self


def _tensors(tree) -> list:
    out = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            for y in x:
                walk(y)
        elif isinstance(x, dict):
            for y in x.values():
                walk(y)
    walk(tree)
    return out


def _nbytes(tree) -> float:
    return float(sum(t.numel() * t.element_size() for t in _tensors(tree)))


def collective_kind(name: str):
    """The collective an op name is, or ``None``."""
    for frag, kind in _COLLECTIVES:
        if frag in name:
            return kind
    return None


@functools.cache
def _flop_formulas() -> dict:
    from torch.utils.flop_counter import flop_registry
    return flop_registry


def _op_flops(func, args, kwargs, out) -> float:
    formula = _flop_formulas().get(func._overloadpacket)
    if formula is None:
        return 0.0
    return float(formula(*args, **kwargs, out_val=out))


@functools.cache
def _propagator_class():
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    return ShardingPropagator


class CostCounter(TorchDispatchMode):
    """Counts a ``StepCost`` over the ops run inside ``with``.

    ``cost`` holds the totals once the block ends (``finalize``d)."""

    def __init__(self):
        super().__init__()
        self.cost = StepCost()
        self._mem: dict = {}
        self._coll: dict = {}
        self._restore = None

    def __enter__(self):
        self._hide_shape_inference()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            if self._restore:
                self._restore()
                self._restore = None
            self.cost.top_memory = [(b, n, op, shape, "") for (op, shape), (
                b, n) in self._mem.items()]
            self.cost.top_collectives = [
                (b, n, kind, shape, op) for (kind, op, shape), (b, n)
                in self._coll.items()]
            self.cost.finalize()

    def _hide_shape_inference(self) -> None:
        """Run DTensor's sharding propagation with every dispatch mode off.

        It infers each new op's global output shape on fake tensors and
        prices candidate redistributions with index arithmetic on small
        tensors; a mode that saw those ops would count global shapes and
        bookkeeping as the rank's work (and slow the trace)."""
        from torch.utils._python_dispatch import _disable_current_modes
        cls = _propagator_class()
        restore = []
        for name in ("propagate_op_sharding_non_cached",
                     "_propagate_tensor_meta_non_cached"):
            orig = cls.__dict__.get(name)
            if orig is None:
                continue

            def hidden(self_, *a, _orig=orig, **kw):
                with _disable_current_modes():
                    return _orig(self_, *a, **kw)

            setattr(cls, name, functools.wraps(orig)(hidden))
            restore.append((name, orig))
        if not restore:
            raise RuntimeError("this torch's DTensor has no sharding "
                               "propagation the cost counter knows")
        self._restore = lambda: [setattr(cls, n, o) for n, o in restore]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented          # DTensor runs the local ops
        out = func(*args, **kwargs)
        self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        c = self.cost
        name = func.name() if hasattr(func, "name") else str(func)
        base = name.split("::")[-1].split(".")[0]
        kind = collective_kind(base)
        if kind is not None:
            if base.endswith("_base_"):        # c10d (output, input, ...)
                in_b, out_b = _nbytes(args[1]), _nbytes(args[0])
            else:
                in_b, out_b = _nbytes(args[0]), _nbytes(out)
            traffic = {"all-reduce": 2.0 * in_b,
                       "all-gather": out_b}.get(kind, in_b)
            c.collective_bytes += traffic
            c.collectives[kind] += traffic
            c.collective_counts[kind] += 1
            shape = tuple(_tensors(out)[0].shape) if _tensors(out) else ()
            key = (kind, base, str(shape))
            b, n = self._coll.get(key, (0.0, 0))
            self._coll[key] = (b + traffic, n + 1)
            moved = in_b + out_b
        else:
            if not name.startswith("aten::") or base in _NO_MOVE \
                    or getattr(func, "is_view", False):
                return
            c.flops += _op_flops(func, args, kwargs, out)
            moved = _nbytes((args, kwargs)) + _nbytes(out)
        if moved:
            c.hbm_bytes += moved
            outs = _tensors(out)
            key = (base, str(tuple(outs[0].shape)) if outs else "()")
            b, n = self._mem.get(key, (0.0, 0))
            self._mem[key] = (b + moved, n + 1)


def count(fn, *args, **kwargs):
    """``(fn(*args, **kwargs), StepCost)``."""
    with CostCounter() as counter:
        result = fn(*args, **kwargs)
    return result, counter.cost
