"""Multi-pod dry-run on fake ranks: trace every (arch × shape × mesh) cell.

A port of ``src/repro/launch/dryrun.py``.  The reference lowers and
compiles each cell for 512 host-platform devices; the port traces it on
one process that plays rank 0 of a ``"fake"`` process group of 256 or
512 ranks (``FakeStore``), which moves nothing: every tensor is a fake
tensor (``FakeTensorMode``) on ``device`` (default: the card), so
nothing is allocated.  The fake group is initialised once per process;
a process that already holds another group (gloo, nccl) cannot run the
dry-run, so tests and the card's smoke run start it in a process of its
own.

Per cell this script:
  1. builds the production mesh (16×16 single-pod / 2×16×16 multi-pod),
  2. makes every input of the cell's step function with ``input_specs()``:
     fake params, train state or decode cache, placed as DTensors by the
     sanitized sharding rules (``launch/sharding.py``),
  3. runs the step (the train step for train_4k, prefill for
     prefill_32k, a greedy decode step for decode shapes) under
     ``pspec.use_mesh``, inside a ``MemTracker`` (peak memory of the
     rank), a ``CostCounter`` (``utils/cost.py``: the rank's FLOPs, HBM
     bytes and collective bytes) and a ``CommDebugMode`` (collective
     counts),
  4. records memory, costs and the three H100 roofline terms
     (``utils/roofline.py``) and dumps everything to JSON.

The record keeps the reference's schema with these differences:
``compile_s`` is the time to trace the step (eager torch compiles
nothing) and ``lower_s`` the time to make its inputs; ``memory`` has
``argument_gb`` (the rank's inputs), ``output_gb`` (its outputs),
``peak_gb`` (``MemTracker``'s peak, inputs included) and ``temp_gb``
(peak less inputs), and no ``alias_gb``, since an eager step aliases no
donated input; ``hlo`` holds the counted per-rank cost under the
reference's key names; ``xla_cost`` is dropped (there is no XLA cost
analysis).  ``replicated`` counts the explicit redistributions to
``Replicate()`` (``pspec.REPLICATED``) and ``comm_counts`` the
``CommDebugMode`` counts per collective op.

Also traces the paper's own engine (``--arch tdr-graph``): the
distributed TDR closure on the full mesh at a static round count
(``distributed.lower_distributed_closure``), vertex-sharded with the
per-round exchange as packed int32 closure words.  It runs the
``segment`` path: a hand-written kernel cannot run on fake tensors.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \
      --shape all --mesh single,multi --out build/dryrun.json
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Optional

import torch
import torch.distributed as dist

from .. import configs
from ..bitset import resolve_device
from ..configs.base import SHAPES
from ..models import decode_step, init_cache, init_params, prefill, pspec
from ..train import AdamWConfig, init_train_state, make_train_step
from ..utils import roofline as roof_lib
from ..utils.cost import CostCounter, StepCost
from . import mesh as mesh_lib
from . import sharding

# per-arch microbatch counts for train_4k (memory lever; tuned so the
# per-chip footprint clears 16 GB — see ARCHITECTURE.md §Dry-run)
# NOTE: microbatch rows (global_batch / n_micro) must stay divisible by
# the batch-axis size (16 single-pod, 32 multi-pod) or activations lose
# their data sharding and replicate -- measured as a 2.5x collective blow-up
# on deepseek (ARCHITECTURE.md §Perf, iteration D1).
TRAIN_MICROBATCHES = {
    "gemma3-27b": 8, "dbrx-132b": 8, "deepseek-v2-236b": 8,
    "phi3-mini-3.8b": 8,
    "phi-3-vision-4.2b": 8, "musicgen-large": 8, "zamba2-1.2b": 8,
    "rwkv6-3b": 4,
}

# bf16 Adam moments for the 100B+ models (standard at this scale; the
# master weights stay f32) -- ARCHITECTURE.md §Dry-run documents the choice
BF16_MOMENT_ARCHS = {"dbrx-132b", "deepseek-v2-236b"}

GB = 1e9


def init_fake_world(world: int) -> None:
    """Make this process rank 0 of a ``"fake"`` group of ``world`` ranks
    (once; a larger fake group will do); raises when it holds another."""
    if dist.is_initialized():
        have = (dist.get_backend(), dist.get_world_size())
        if have[0] != "fake" or have[1] < world:
            raise RuntimeError(
                f"the dry-run needs a 'fake' group of {world} ranks and "
                f"this process holds {have}: run it in a process of its own")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), world_size=world,
                            rank=0)


def small_mesh(data: int, model: int, device="cuda"):
    """A ``data × model`` mesh over the first ranks of the fake group: the
    production path at a size a test can trace."""
    from torch.distributed.device_mesh import DeviceMesh
    dev = resolve_device(device)
    return DeviceMesh(dev.type, torch.arange(data * model).reshape(
        data, model), mesh_dim_names=("data", "model"))


def _cfg(arch: str, reduced: bool):
    cfg = configs.get(arch)
    return cfg.reduced() if reduced else cfg


def _tensor_leaves(tree) -> list:
    """The tensors of a nested dict / list / tuple."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensor_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensor_leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _local_bytes(tree) -> float:
    """Bytes this rank holds of a tree of (D)Tensors."""
    from torch.distributed.tensor import DTensor
    return float(sum(
        (t.to_local() if isinstance(t, DTensor) else t).nbytes
        for t in _tensor_leaves(tree)))


def input_specs(arch: str, shape_name: str, the_mesh, *, device="cuda",
                reduced: bool = False) -> dict:
    """Fake, sharded stand-ins (no allocation) for every input of the
    cell's step function; call under ``FakeTensorMode``."""
    cfg = _cfg(arch, reduced)
    shape = SHAPES[shape_name]
    dt = getattr(torch, cfg.dtype)
    dev = resolve_device(device)
    b_ax = mesh_lib.batch_axes(the_mesh)
    P = pspec.P

    def place(tree, spec):
        return sharding.distribute_tree(tree, spec, the_mesh)

    out = {"tokens": place(
        torch.empty((shape.global_batch, shape.seq_len), dtype=torch.int32,
                    device=dev), P(b_ax, None))}
    if cfg.n_media_tokens:
        out["media"] = place(
            torch.empty((shape.global_batch, cfg.n_media_tokens,
                         cfg.d_model), dtype=dt, device=dev),
            P(b_ax, None, None))

    params_shape = init_params(cfg, 0, device=dev)
    p_specs = sharding.sanitize_specs(
        sharding.param_specs(cfg, params_shape, the_mesh), params_shape,
        the_mesh)
    out["params"] = place(params_shape, p_specs)

    if shape.kind == "train":
        opt_cfg0 = AdamWConfig(
            moment_dtype="bfloat16" if arch in BF16_MOMENT_ARCHS
            else "float32")
        state_shape = init_train_state(cfg, params_shape, opt_cfg0,
                                       device=dev)
        s_specs = sharding.sanitize_specs(
            sharding.state_specs(cfg, state_shape, the_mesh), state_shape,
            the_mesh)
        out["state"] = place(state_shape, s_specs)
    if shape.kind == "decode":
        cache_shape = init_cache(cfg, shape.global_batch, shape.seq_len,
                                 device=dev)
        c_specs = sharding.sanitize_specs(
            sharding.cache_specs(cfg, cache_shape, the_mesh,
                                 shape.global_batch), cache_shape, the_mesh)
        out["cache"] = place(cache_shape, c_specs)
        out["step_tokens"] = place(
            torch.empty((shape.global_batch,), dtype=torch.int32,
                        device=dev),
            P(b_ax if shape.global_batch > 1 else None))
    return out


def applicable(arch: str, shape_name: str) -> bool:
    cfg = configs.get(arch)
    if shape_name == "long_500k" and not cfg.sub_quadratic:
        return False  # full-attention archs skip (see ARCHITECTURE.md)
    return True


@dataclasses.dataclass
class Trace:
    """What one traced cell measured (``trace_cell``)."""
    cost: StepCost
    memory: dict
    comm_counts: dict
    replicated: dict
    lower_s: float
    trace_s: float


@contextlib.contextmanager
def _counted(inputs):
    """MemTracker, CostCounter and CommDebugMode over the block; yields a
    dict that holds, once the block ends, the cost, the peak bytes, the
    collective counts and the replicate points the block added."""
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.distributed.tensor.debug import CommDebugMode
    mt = MemTracker()
    mt.track_external(*_tensor_leaves(inputs))
    got = {}
    before = dict(pspec.REPLICATED)
    with CommDebugMode() as comm, mt, CostCounter() as counter:
        yield got
    got["cost"] = counter.cost
    got["peak"] = float(sum(snap.get("Total", 0) for snap in
                            mt.get_tracker_snapshot("peak").values()))
    got["comm"] = {str(k): int(v) for k, v in comm.get_comm_counts().items()}
    got["replicated"] = {k: v - before.get(k, 0)
                         for k, v in pspec.REPLICATED.items()
                         if v - before.get(k, 0)}


def trace_cell(arch: str, shape_name: str, the_mesh, *, device="cuda",
               rwkv_chunked: bool = False, extra: Optional[dict] = None,
               reduced: bool = False):
    """Returns (Trace, n_tokens, model_flops): ``lower_cell`` of the
    reference, with the step run on fake tensors in place of lowered."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg = _cfg(arch, reduced)
    shape = SHAPES[shape_name]
    extra = extra or {}
    mapping = pspec.default_mapping("pod" in the_mesh.mesh_dim_names)
    t0 = time.time()
    # the step itself runs outside the mode: its fake inputs carry it,
    # and DTensor's own index arithmetic then stays on real tensors
    with FakeTensorMode(allow_non_fake_inputs=True):
        specs = input_specs(arch, shape_name, the_mesh, device=device,
                            reduced=reduced)
    if shape.kind == "train":
        n_micro = extra.get("n_microbatches",
                            TRAIN_MICROBATCHES.get(arch, 4))
        opt_cfg = AdamWConfig(
            moment_dtype="bfloat16" if arch in BF16_MOMENT_ARCHS
            else "float32")
        step = make_train_step(cfg, opt_cfg,
                               n_microbatches=n_micro, remat=True,
                               remat_policy=extra.get("remat_policy", ""),
                               rwkv_chunked=rwkv_chunked)
        batch = {"tokens": specs["tokens"]}
        if "media" in specs:
            batch["media"] = specs["media"]
        args = (specs["state"], batch)
        n_tokens = shape.global_batch * shape.seq_len
        mf = roof_lib.model_flops_train(cfg.n_active_params(), n_tokens)
    elif shape.kind == "prefill":
        def step(params, tokens, media=None):
            return prefill(cfg, params, tokens, media, max_len=shape.seq_len)
        args = (specs["params"], specs["tokens"], specs.get("media"))
        n_tokens = shape.global_batch * shape.seq_len
        mf = roof_lib.model_flops_forward(cfg.n_active_params(), n_tokens)
    else:  # decode: greedy single-token step over the model's decode cell
        def step(params, cache, tokens):
            logits, cache = decode_step(cfg, params, cache, tokens)
            return torch.argmax(logits, dim=-1).to(torch.int32), cache
        args = (specs["params"], specs["cache"], specs["step_tokens"])
        n_tokens = shape.global_batch  # one token per sequence
        mf = roof_lib.model_flops_forward(cfg.n_active_params(), n_tokens)
    t1 = time.time()
    with _counted(args) as got, pspec.use_mesh(the_mesh, mapping):
        out = step(*args)
    t2 = time.time()
    arg_b, out_b = _local_bytes(args), _local_bytes(out)
    memory = {"argument_gb": arg_b / GB, "output_gb": out_b / GB,
              "temp_gb": (got["peak"] - arg_b) / GB,
              "peak_gb": got["peak"] / GB}
    return (Trace(got["cost"], memory, got["comm"], got["replicated"],
                  t1 - t0, t2 - t1), n_tokens, mf)


def _mesh_for(mesh_kind: str, device, mesh_shape) -> tuple:
    """(mesh, chips): the production mesh of ``mesh_kind``, or a
    ``data × model`` ``mesh_shape`` in its place."""
    if mesh_shape:
        init_fake_world(math.prod(mesh_shape))
        return small_mesh(*mesh_shape, device=device), math.prod(mesh_shape)
    n = 512 if mesh_kind == "multi" else 256
    init_fake_world(n)
    the_mesh = mesh_lib.make_production_mesh(
        multi_pod=(mesh_kind == "multi"), device=device)
    return the_mesh, n


def _cost_record(cost: StepCost, detail: bool = True) -> dict:
    rec = {"flops_per_chip": cost.flops,
           "hbm_bytes_per_chip": cost.hbm_bytes,
           "collective_bytes_per_chip": cost.collective_bytes,
           "collectives": dict(cost.collectives)}
    if detail:
        rec.update(collective_counts=dict(cost.collective_counts),
                   top_collectives=cost.top_collectives[:8],
                   top_memory=cost.top_memory[:8])
    return rec


def run_cell(arch: str, shape_name: str, mesh_kind: str, *,
             extra: Optional[dict] = None, device="cuda",
             mesh_shape: Optional[tuple] = None,
             reduced: bool = False) -> dict:
    """Trace one cell on fake ranks of ``device`` (default: the card) and
    return its record.  ``mesh_shape=(data, model)`` replaces the
    production mesh and ``reduced`` the arch's published widths: a small
    run of the same path."""
    resolve_device(device)
    the_mesh, chips = _mesh_for(mesh_kind, device, mesh_shape)
    tr, n_tokens, model_flops = trace_cell(
        arch, shape_name, the_mesh, device=device,
        rwkv_chunked=(extra or {}).get("rwkv_chunked", False), extra=extra,
        reduced=reduced)
    roof = roof_lib.Roofline.from_cost(tr.cost, chips=chips,
                                       model_flops=model_flops)
    return {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "chips": chips, "device": torch.device(device).type,
        "lower_s": round(tr.lower_s, 2), "compile_s": round(tr.trace_s, 2),
        "memory": tr.memory,
        "hlo": _cost_record(tr.cost),
        "comm_counts": tr.comm_counts,
        "replicated": tr.replicated,
        "roofline": roof.as_dict(),
    }


def run_tdr_cell(mesh_kind: str, *, device="cuda",
                 mesh_shape: Optional[tuple] = None,
                 gcfg=None) -> dict:
    """Trace the paper's engine: the distributed closure on the full mesh.

    The fixpoint exchanges packed int32 words (V × W × 4 bytes per round
    over the gathered table); ``rounds`` is static here purely for cost
    accounting — see ``distributed.lower_distributed_closure``.
    ``gcfg`` replaces ``configs.TDR_GRAPH`` (a small graph for a test)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from .. import distributed
    dev = resolve_device(device)
    t0 = time.time()
    the_mesh, chips = _mesh_for(mesh_kind, device, mesh_shape)
    shard_mesh = distributed.ShardMesh.from_device_mesh(the_mesh, dev)
    gcfg = gcfg or configs.TDR_GRAPH
    e_max = -(-gcfg.n_edges // chips)
    lowered = distributed.lower_distributed_closure(
        shard_mesh, gcfg.n_vertices, e_max, gcfg.vtx_bits, gcfg.rounds)
    with FakeTensorMode(allow_non_fake_inputs=True):
        args = lowered.inputs()
    t1 = time.time()
    with _counted(args) as got:
        out = lowered(*args)
    t2 = time.time()
    cost = got["cost"]
    roof = roof_lib.Roofline.from_cost(
        cost, chips=chips,
        # "model flops" for the engine: one OR-op per (edge × word) per
        # round, expressed in flop-equivalents
        model_flops=float(gcfg.n_edges) * (gcfg.vtx_bits // 32)
        * gcfg.rounds)
    arg_b = _local_bytes(args)
    return {
        "arch": "tdr-graph", "shape": f"V{gcfg.n_vertices}", "mesh":
        mesh_kind, "chips": chips, "device": dev.type,
        "lower_s": round(t1 - t0, 2), "compile_s": round(t2 - t1, 2),
        "memory": {"temp_gb": (got["peak"] - arg_b) / GB,
                   "argument_gb": arg_b / GB,
                   "output_gb": _local_bytes(out) / GB,
                   "peak_gb": got["peak"] / GB},
        "hlo": _cost_record(cost, detail=False),
        "comm_counts": got["comm"],
        "roofline": roof.as_dict(),
    }


def _summary(rec: dict) -> str:
    r, h, m = rec["roofline"], rec["hlo"], rec["memory"]
    return (f"peak={m['peak_gb']:.2f}GB/chip "
            f"flops={h['flops_per_chip']:.4e} "
            f"hbm={h['hbm_bytes_per_chip']:.4e}B "
            f"coll={h['collective_bytes_per_chip']:.4e}B "
            f"compute={r['compute_s']:.4f}s memory={r['memory_s']:.4f}s "
            f"collective={r['collective_s']:.4f}s dom={r['dominant']} "
            f"mfu={r['mfu']:.4f} trace={rec['compile_s']}s")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single,multi")
    ap.add_argument("--out", default="build/dryrun.json")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mesh-shape", default="",
                    help="DATAxMODEL: a small fake mesh in place of the "
                    "production one (with --reduced, a test-sized run)")
    ap.add_argument("--reduced", action="store_true",
                    help="the archs' reduced configs")
    ap.add_argument("--continue-on-error", action="store_true")
    args = ap.parse_args(argv)

    archs = configs.list_archs() if args.arch == "all" \
        else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = args.mesh.split(",")
    mesh_shape = tuple(int(x) for x in args.mesh_shape.split("x")) \
        if args.mesh_shape else None
    if "multi" in meshes and not mesh_shape:
        init_fake_world(512)     # the single-pod mesh takes its first 256
    kw = dict(device=args.device, mesh_shape=mesh_shape)

    results, failures = [], []
    for mesh_kind in meshes:
        for arch in archs:
            if arch == "tdr-graph":
                rec = run_tdr_cell(mesh_kind, **kw)
                print(f"[ok] tdr-graph × {mesh_kind}: {_summary(rec)}",
                      flush=True)
                results.append(rec)
                continue
            for shape_name in shapes:
                if not applicable(arch, shape_name):
                    results.append({"arch": arch, "shape": shape_name,
                                    "mesh": mesh_kind, "skipped":
                                    "long_500k: full-attention arch"})
                    continue
                tag = f"{arch} × {shape_name} × {mesh_kind}"
                try:
                    rec = run_cell(arch, shape_name, mesh_kind,
                                   reduced=args.reduced, **kw)
                    print(f"[ok] {tag}: {_summary(rec)}", flush=True)
                    results.append(rec)
                except Exception as e:  # noqa: BLE001 (recorded per cell)
                    print(f"[FAIL] {tag}: {e}", flush=True)
                    failures.append({"cell": tag,
                                     "error": traceback.format_exc()})
                    if not args.continue_on_error:
                        raise
        if "tdr-graph" not in archs and args.arch == "all":
            results.append(run_tdr_cell(mesh_kind, **kw))

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"results": results, "failures": failures}, f, indent=1)
    print(f"wrote {args.out}: {len(results)} cells, "
          f"{len(failures)} failures")


if __name__ == "__main__":
    main()
