"""Named hill-climb iterations over dry-run cells: run one on one cell and
record its roofline into ``build/perf_iterations.json``.

A port of ``src/repro/launch/perf.py``'s iterations, traced on fake ranks
of ``device`` like ``launch/dryrun.py`` (run it in a process of its
own):
  rwkv-chunked         rwkv6-3b × train_4k with the chunked WKV6 formulation
  ds-micro8            deepseek-v2 × train_4k with shardable microbatches
  ds-micro16           the same at 16 microbatches
  ds-policy            + checkpoint policy saving the unbatched matmuls
  gemma3-decode-window gemma3-27b × decode_32k
  rwkv-dp              rwkv6-3b × train_4k as 256-way DP + ZeRO-1
  tdr-1d               tdr-graph closure, vertex-partitioned (1-D)
  tdr-2d               tdr-graph closure, 2-D (vertex × word), 8 word shards
  tdr-2d-w4            the same at 4 word shards

``rwkv-chunk-mxu``, named in the reference's docstring, has no iteration
there to port.

Usage: PYTHONPATH=src python -m repro_torch.launch.perf --iter rwkv-chunked
       PYTHONPATH=src python -m repro_torch.launch.perf --iter tdr-2d
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch

from .. import configs
from ..bitset import resolve_device
from ..configs.base import SHAPES
from ..models import init_params, pspec
from ..train import AdamWConfig, init_train_state, make_train_step
from ..utils import roofline as roof_lib
from . import dryrun
from . import mesh as mesh_lib
from . import sharding

OUT = "build/perf_iterations.json"
ITERATIONS = {
    "rwkv-chunked": ("rwkv6-3b", "train_4k", {"rwkv_chunked": True}),
    "ds-micro8": ("deepseek-v2-236b", "train_4k", {"n_microbatches": 8}),
    "ds-micro16": ("deepseek-v2-236b", "train_4k", {"n_microbatches": 16}),
    "ds-policy": ("deepseek-v2-236b", "train_4k",
                  {"n_microbatches": 8, "remat_policy": "dots"}),
    "gemma3-decode-window": ("gemma3-27b", "decode_32k", {}),
}

# iteration -> run_tdr_variant's (two_d, word_shards)
TDR_ITERATIONS = {"tdr-1d": (False, 8), "tdr-2d": (True, 8),
                  "tdr-2d-w4": (True, 4)}


def record(name: str, rec: dict, out: str = OUT) -> None:
    data = {"iterations": {}}
    if os.path.exists(out):
        with open(out) as f:
            data = json.load(f)
    data["iterations"][name] = rec
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        json.dump(data, f, indent=1)
    ro = rec.get("roofline", {})
    print(f"[perf] {name}: compute={ro.get('compute_s', 0):.3f}s "
          f"memory={ro.get('memory_s', 0):.3f}s "
          f"collective={ro.get('collective_s', 0):.3f}s "
          f"dom={ro.get('dominant')} mfu={ro.get('mfu', 0):.4f}")


def run_tdr_variant(two_d: bool, word_shards: int = 8, *, device="cuda",
                    mesh_shape: tuple | None = None, gcfg=None) -> dict:
    """§Perf iterations T1/T2: the tdr-graph closure on the 256 fake ranks
    of the production mesh, 1-D (``lower_distributed_closure``) or 2-D
    (``lower_distributed_closure_2d``), counted as ``dryrun.run_tdr_cell``
    counts it, in the reference's record schema.  ``mesh_shape`` and
    ``gcfg`` replace the mesh and ``configs.TDR_GRAPH`` (a small run of
    the same path, as in ``run_tdr_cell``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from .. import distributed
    dev = resolve_device(device)
    the_mesh, _ = dryrun._mesh_for("single", device, mesh_shape)
    shard_mesh = distributed.ShardMesh.from_device_mesh(the_mesh, dev)
    gcfg = gcfg or configs.TDR_GRAPH
    n_dev = shard_mesh.size
    if two_d:
        v_shards = n_dev // word_shards
        e_max = -(-gcfg.n_edges // v_shards)
        lowered = distributed.lower_distributed_closure_2d(
            shard_mesh, gcfg.n_vertices, e_max, gcfg.vtx_bits, gcfg.rounds,
            word_shards=word_shards)
    else:
        e_max = -(-gcfg.n_edges // n_dev)
        lowered = distributed.lower_distributed_closure(
            shard_mesh, gcfg.n_vertices, e_max, gcfg.vtx_bits, gcfg.rounds)
    with FakeTensorMode(allow_non_fake_inputs=True):
        args = lowered.inputs()
    t0 = time.time()
    with dryrun._counted(args) as got:
        lowered(*args)
    dt = time.time() - t0
    cost = got["cost"]
    roof = roof_lib.Roofline.from_cost(
        cost, chips=n_dev,
        model_flops=float(gcfg.n_edges) * (gcfg.vtx_bits // 32)
        * gcfg.rounds)
    arg_b = dryrun._local_bytes(args)
    return {
        "cell": "tdr-graph", "variant": "2d" if two_d else "1d",
        "compile_s": round(dt, 2),
        "memory": {"temp_gb": (got["peak"] - arg_b) / dryrun.GB,
                   "argument_gb": arg_b / dryrun.GB},
        "hlo": dryrun._cost_record(cost, detail=False),
        "roofline": roof.as_dict(),
    }


def run_rwkv_dp(*, device="cuda") -> dict:
    """§Perf iteration R4: rwkv6 train as 256-way pure DP + ZeRO-1.

    RWKV6's 40 heads don't divide the 16-wide model axis, so TP never
    sharded its state ops anyway — it only added per-layer all-reduces.
    Re-map: batch over (data×model) = 256-way DP, params replicated,
    optimizer state ZeRO-1-sharded over all 256 ranks.  Predicted: TP
    all-reduces vanish, per-rank activation traffic ÷16; the gradient
    reduction becomes the collective term.
    """
    from torch._subclasses.fake_tensor import FakeTensorMode
    dev = resolve_device(device)
    arch, shape_name = "rwkv6-3b", "train_4k"
    cfg = configs.get(arch)
    sh = SHAPES[shape_name]
    dryrun.init_fake_world(256)
    the_mesh = mesh_lib.make_production_mesh(device=device)
    dm = ("data", "model")
    n_ways = 256
    P = pspec.P

    def zero1_spec(leaf) -> "pspec.PartitionSpec":
        for i, d in enumerate(leaf.shape):
            if d % n_ways == 0:
                spec = [None] * leaf.ndim
                spec[i] = dm
                return P(*spec)
        return P(*([None] * leaf.ndim))

    t0 = time.time()
    with FakeTensorMode(allow_non_fake_inputs=True):
        state = init_train_state(cfg, init_params(cfg, 0, device=dev),
                                 device=dev)
        p_repl = _map(lambda leaf: P(*([None] * leaf.ndim)),
                      state["params"])
        opt_master = _map(zero1_spec, state["opt"]["master"])
        s_specs = {"params": p_repl,
                   "opt": {"master": opt_master, "m": opt_master,
                           "v": opt_master, "count": P()}}
        state = sharding.distribute_tree(state, s_specs, the_mesh)
        toks = sharding.distribute_tree(
            {"tokens": torch.empty((sh.global_batch, sh.seq_len),
                                   dtype=torch.int32, device=dev)},
            {"tokens": P(dm, None)}, the_mesh)
    # n_microbatches=1: with 256-way DP every microbatch must keep >=256
    # rows (the D0/D1 lesson, applied)
    step = make_train_step(cfg, AdamWConfig(), n_microbatches=1,
                           remat=True, rwkv_chunked=True)
    mapping = {"batch": dm, "heads": None, "kv": None, "vocab": None,
               "ff": None, "experts": None, "embed": None, "seq": None}
    args = (state, toks)
    t1 = time.time()
    with dryrun._counted(args) as got, pspec.use_mesh(the_mesh, mapping):
        step(*args)
    t2 = time.time()
    cost = got["cost"]
    mf = roof_lib.model_flops_train(
        cfg.n_active_params(), sh.global_batch * sh.seq_len)
    roofl = roof_lib.Roofline.from_cost(cost, chips=256, model_flops=mf)
    arg_b = dryrun._local_bytes(args)
    return {
        "arch": arch, "shape": shape_name, "mesh": "single", "chips": 256,
        "variant": "dp256-zero1", "lower_s": round(t1 - t0, 2),
        "compile_s": round(t2 - t1, 2),
        "memory": {"peak_gb": got["peak"] / dryrun.GB,
                   "temp_gb": (got["peak"] - arg_b) / dryrun.GB,
                   "argument_gb": arg_b / dryrun.GB},
        "hlo": dryrun._cost_record(cost),
        "comm_counts": got["comm"],
        "replicated": got["replicated"],
        "roofline": roofl.as_dict(),
    }


def _map(fn, tree):
    """``fn`` over the leaves of a nested dict."""
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iter", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    it = args.iter
    if it == "rwkv-dp":
        rec = run_rwkv_dp(device=args.device)
    elif it in TDR_ITERATIONS:
        rec = run_tdr_variant(*TDR_ITERATIONS[it], device=args.device)
    elif it in ITERATIONS:
        arch, shape_name, extra = ITERATIONS[it]
        rec = dryrun.run_cell(arch, shape_name, "single", extra=extra,
                              device=args.device)
    else:
        raise SystemExit(f"unknown iteration {it}")
    record(it, rec, args.out)


if __name__ == "__main__":
    main()
