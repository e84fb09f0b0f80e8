"""Per-arch sharding rules: DP/FSDP over ``data`` (+ pure DP over ``pod``),
TP over ``model``, EP (experts) over ``model``, SP (sequence) over ``data``
for batch-1 long-context caches.

A port of ``src/repro/launch/sharding.py``.  Rules are name-based over the
param dict so every family shares one rule table, which is the
reference's verbatim; a spec is a ``pspec.PartitionSpec`` and a sharded
leaf is a DTensor whose ``Shard``/``Replicate`` placements the spec
resolves to on a ``DeviceMesh``.  Optimizer state inherits the spec of
its parameter.  Pods hold full parameter replicas; FSDP/ZeRO shards
params and optimizer state over the intra-pod ``data`` axis.
"""
from __future__ import annotations

from typing import Any

import torch

from .. import pytree
from ..configs.base import ModelConfig
from ..models.pspec import P, PartitionSpec, mesh_shape, placements
from . import mesh as mesh_lib

# weight classes by leaf name
_UP = {"wq", "wk", "wv", "w_gate", "w_up", "wq_a", "wq_b", "wkv_a",
       "wkv_b", "in_proj", "w_r", "w_k", "w_g"}
_DOWN = {"wo", "w_down", "out_proj", "w_o", "w_v"}
_REPL = {"q_norm", "kv_norm", "ln", "ln1", "ln2", "ln_a", "ln_f", "ln_x",
         "norm", "mu", "w0", "dt_bias", "a_log", "d_skip", "u", "conv_b",
         "final_norm", "count", "conv_w"}


def _ndim(leaf) -> int:
    """Rank of a tensor leaf; a Python scalar (a cache's ``index``) is 0."""
    return leaf.ndim if hasattr(leaf, "ndim") else 0


def _shape(leaf) -> tuple:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else ()


def _map_paths(fn, tree: Any) -> Any:
    """``fn(path_names, leaf)`` over the leaves of a nested dict."""
    items = pytree.leaves_with_paths(tree)
    return pytree.unflatten([p for p, _ in items],
                            [fn(p.split("/"), leaf) for p, leaf in items])


def _leaf_spec(names: list, leaf, fsdp: str, tp: str) -> PartitionSpec:
    name = names[-1]
    nd = _ndim(leaf)
    none = (None,) * nd

    if name in ("router", "w_lora_a"):        # [L, D, small]
        return P(None, fsdp, None) if nd == 3 else P(fsdp, None)
    if name == "w_lora_b":                    # [L, small, D]
        return P(None, None, fsdp) if nd == 3 else P(None, fsdp)
    if name == "tok":
        # vocab over TP; D replicated so the token gather stays local per
        # vocab shard (one all-reduce over model); the table is small
        # relative to HBM once vocab-sharded.
        return P(tp, None)
    if name == "unembed":
        return P(tp, fsdp)
    if name in _REPL or nd <= 1:
        return P(*none)
    if name in _UP:
        if nd == 4:  # MoE expert stacks [L, E, D, F] -> EP over tp
            return P(None, tp, fsdp, None)
        if nd == 3 and "blocks" in names:      # [L, in, out]
            return P(None, fsdp, tp)
        if nd == 3:                            # MoE without L? [E, D, F]
            return P(tp, fsdp, None)
        return P(fsdp, tp)                     # shared blocks [in, out]
    if name in _DOWN:
        if nd == 4:
            return P(None, tp, None, fsdp)
        if nd == 3 and "blocks" in names:
            return P(None, tp, fsdp)
        if nd == 3:
            return P(tp, None, fsdp)
        return P(tp, fsdp)
    return P(*none)


def param_specs(cfg: ModelConfig, params_shape: Any, the_mesh) -> Any:
    """PartitionSpec dict matching ``params_shape`` (a param dict; meta or
    fake tensors will do)."""
    fsdp = mesh_lib.fsdp_axis(the_mesh)
    tp = mesh_lib.tp_axis(the_mesh)
    return _map_paths(lambda names, leaf: _leaf_spec(names, leaf, fsdp, tp),
                      params_shape)


def state_specs(cfg: ModelConfig, state_shape: Any, the_mesh) -> Any:
    """Train-state specs: opt master/m/v inherit the param spec."""
    p_spec = param_specs(cfg, state_shape["params"], the_mesh)
    return {
        "params": p_spec,
        "opt": {
            "master": p_spec, "m": p_spec, "v": p_spec,
            "count": P(),
        },
    }


def batch_specs(cfg: ModelConfig, the_mesh, *, with_media: bool) -> Any:
    b_ax = mesh_lib.batch_axes(the_mesh)
    spec = {"tokens": P(b_ax, None)}
    if with_media:
        spec["media"] = P(b_ax, None, None)
    return spec


def cache_specs(cfg: ModelConfig, cache_shape: Any, the_mesh,
                batch: int) -> Any:
    """Decode-cache specs.  batch>1: shard B over (pod, data), heads/experts
    over model.  batch==1 (long_500k): sequence-parallel — shard the cache
    time axis over ``data`` instead."""
    b_ax = mesh_lib.batch_axes(the_mesh)
    tp = mesh_lib.tp_axis(the_mesh)
    sp = mesh_lib.fsdp_axis(the_mesh)
    big_b = batch > 1

    def spec_of(names, leaf):
        name = names[-1]
        nd = _ndim(leaf)
        if name == "index":
            return P()
        if name in ("k", "v", "attn_k", "attn_v"):
            # [L/G, B, T, KV, hd]
            return P(None, b_ax, None, tp, None) if big_b \
                else P(None, None, sp, tp, None)
        if name == "c_kv":        # [L, B, T, ckv]
            return P(None, b_ax, None, None) if big_b \
                else P(None, None, sp, None)
        if name == "k_rope":      # [L, B, T, 1, dr]
            return P(None, b_ax, None, None, None) if big_b \
                else P(None, None, sp, None, None)
        if name == "h":           # [L, B, P, N, hd]
            return P(None, b_ax, tp, None, None) if big_b \
                else P(None, None, tp, None, None)
        if name == "conv":        # [L, B, K-1, C]
            return P(None, b_ax, None, tp) if big_b \
                else P(None, None, None, tp)
        if name == "s":           # [L, B, H, hd, hd]
            return P(None, b_ax, tp, None, None) if big_b \
                else P(None, None, tp, None, None)
        if name in ("last_tm", "last_cm"):   # [L, B, D]
            return P(None, b_ax, None) if big_b else P(None, None, tp)
        return P(*(None,) * nd)

    return _map_paths(spec_of, cache_shape)


def _axis_size(the_mesh, entry) -> int:
    if entry is None:
        return 1
    shape = mesh_shape(the_mesh)
    if isinstance(entry, (tuple, list)):
        n = 1
        for a in entry:
            n *= shape[a]
        return n
    return shape[entry]


def sanitize_specs(spec_tree: Any, shape_tree: Any, the_mesh) -> Any:
    """Null out spec entries whose dimension doesn't divide the axis size
    (e.g. 8 KV heads on a 16-wide model axis)."""
    def fix(spec: PartitionSpec, leaf) -> PartitionSpec:
        entries = list(spec) + [None] * (_ndim(leaf) - len(spec))
        out = []
        for dim, e in zip(_shape(leaf), entries):
            out.append(e if dim % _axis_size(the_mesh, e) == 0 else None)
        return P(*out)

    return pytree.tree_map(fix, spec_tree, shape_tree)


def to_placements(spec_tree: Any, the_mesh) -> Any:
    """The placements of every spec (``to_named`` of the reference)."""
    return pytree.tree_map(lambda s: placements(s, the_mesh), spec_tree)


def distribute_tree(tree: Any, spec_tree: Any, the_mesh) -> Any:
    """DTensors of a param, state or cache dict, each leaf placed by its
    spec (``sds_with_sharding`` of the reference).  Under
    ``FakeTensorMode`` the leaves are fake, and this is the shape-only
    stand-in the dry-run traces with.  A leaf that is no tensor (a
    cache's ``index``) is kept as it is."""
    from torch.distributed.tensor import distribute_tensor

    def place(leaf, spec):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        return distribute_tensor(leaf, the_mesh, placements(spec, the_mesh))

    return pytree.tree_map(place, tree, spec_tree)
