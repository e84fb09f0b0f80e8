"""Vertex-sharded TDR on ``torch.distributed``: sharded build and answers.

The JAX package runs its shards under one controller (a mesh and
``shard_map``); the port runs them the way PyTorch does, one process per
shard in a process group (SPMD).  A ``ShardMesh`` names the group and this
rank's device, and every entry point that takes ``mesh=`` is collective:
every rank calls it with the same arguments, and every rank gets the whole
result on its device.

* The vertex set is split into contiguous blocks of ``ceil(V/size)`` rows,
  shard s on group rank s.  Each rank owns the index rows of its block,
  the out-edges of its block (forward propagation and the per-way
  projections) and its in-edges (the reverse closure).  The adjacency
  never moves.
* One fixpoint round is an all-gather of the packed int32 closure words
  (``engine.all_gather_words``) and a local packed OR reduction for the
  owned rows (``bitset.segment_or_words``); a changed flag, reduced over
  the ranks every round (``engine.closure_sharded``), stops every rank at
  the same round.  ``row_budget`` trades the dense exchange for shipped
  changed rows (``engine.closure_sharded_delta``).
* ``build_index(graph, cfg, mesh=...)`` shards all of Alg. 1 this way and
  equals the single-device build on every plane (the OR fixpoint has a
  unique least solution and every reduction is an exact OR).  The planes
  are gathered at the end, so every rank holds the whole index.
* ``answer_batch(index, queries, mesh=...)`` runs the phase-1 cascade on
  each rank's contiguous slice of the job axis and gathers the verdicts;
  the c-th compacted phase-2 chunk runs on rank ``c % size`` and the
  full-graph chunks on rank 0, which holds the V-sized class stacks.  The
  answers are OR-combined, and each chunk's counters are gathered and
  folded in chunk order, so every rank's ``QueryStats`` equal a
  single-device run's.

The caller picks the backend: ``nccl`` when each rank has a card of its
own, ``gloo`` on the CPU and for ranks that share one card (NCCL refuses
two ranks on one device).  A mesh checks the pairing and raises on a bad
one; it never switches backend or device by itself.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from . import bitset
from . import engine as engine_mod
from . import tdr_build as build_mod
from . import tdr_query as query_mod
from .graph import Graph

# backend -> the device types its collectives take here
_PAIRS = {"gloo": ("cpu", "cuda"), "nccl": ("cuda",)}


@dataclasses.dataclass(frozen=True)
class ShardMesh:
    """A process group and this rank's device; shard s is group rank s.

    ``group`` defaults to the default group, which must be initialised.
    ``device`` defaults to the card and raises when there is none; pass
    ``device="cpu"`` on a ``gloo`` group to run on the CPU."""
    group: "dist.ProcessGroup | None" = None
    device: torch.device = "cuda"   # type: ignore[assignment]

    def __post_init__(self):
        dev = engine_mod.resolve_device(self.device)
        object.__setattr__(self, "device", dev)
        if not dist.is_initialized():
            raise RuntimeError("ShardMesh needs an initialised process "
                               "group (torch.distributed.init_process_group)")
        backend = _backend_for(str(dist.get_backend(self.group)), dev.type)
        if dev.type not in _PAIRS.get(backend, ()):
            raise ValueError(
                f"a {backend!r} group cannot run collectives on {dev.type} "
                "tensors; use nccl with one card per rank, gloo on the CPU "
                "or for ranks that share a card")

    @property
    def rank(self) -> int:
        return dist.get_rank(self.group)

    @property
    def size(self) -> int:
        return dist.get_world_size(self.group)


def _backend_for(spec: str, device_type: str) -> str:
    """The backend a group runs ``device_type`` tensors on: ``spec`` is a
    backend name, or a ``"cpu:gloo,cuda:nccl"`` map."""
    if ":" not in spec:
        return spec
    table = dict(part.split(":", 1) for part in spec.split(","))
    return table.get(device_type, "")


def _pad_to(x: np.ndarray, n: int, axis: int = 0, fill=0) -> np.ndarray:
    pad = n - x.shape[axis]
    if pad <= 0:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return np.pad(x, widths, constant_values=fill)


@dataclasses.dataclass(frozen=True)
class ShardEdges:
    """Dense per-shard edge layout.

    ``local`` is the shard-owned endpoint as a shard-local row id,
    ``remote`` the other endpoint as a *global* id (it indexes the
    gathered closure table), ``eidx`` the global edge id (aligning
    per-edge payloads such as label planes and way ids to the shard
    layout), and ``valid`` masks the padding slots."""
    local: np.ndarray    # int32 [S, e_max]
    remote: np.ndarray   # int32 [S, e_max]
    eidx: np.ndarray     # int32 [S, e_max]
    valid: np.ndarray    # bool  [S, e_max]


def partition_graph(graph: Graph, n_shards: int, *,
                    by: str = "src") -> tuple[int, ShardEdges]:
    """Pad V to a multiple of shards; group edges by the owning endpoint.

    ``by="src"`` assigns each edge to the shard owning its source (forward
    propagation / projections); ``by="dst"`` to the shard owning its
    destination (reverse propagation).  Returns ``(v_pad, ShardEdges)``;
    ``e_max`` is at least 1, so an empty shard still has a slot."""
    if by not in ("src", "dst"):
        raise ValueError(f"partition_graph: by={by!r}")
    v_pad = -(-graph.n_vertices // n_shards) * n_shards
    per = v_pad // n_shards
    src, dst = graph.src, graph.indices
    own, other = (src, dst) if by == "src" else (dst, src)
    shard_of = own // per
    e_max = int(max(1, np.bincount(shard_of, minlength=n_shards).max()))
    local = np.zeros((n_shards, e_max), dtype=np.int32)
    remote = np.zeros((n_shards, e_max), dtype=np.int32)
    eidx = np.zeros((n_shards, e_max), dtype=np.int32)
    valid = np.zeros((n_shards, e_max), dtype=bool)
    for s in range(n_shards):
        ids = np.flatnonzero(shard_of == s)
        k = ids.shape[0]
        local[s, :k] = own[ids] - s * per
        remote[s, :k] = other[ids]
        eidx[s, :k] = ids
        valid[s, :k] = True
    return v_pad, ShardEdges(local, remote, eidx, valid)


def _shard_edges(ed: ShardEdges, s: int, dev):
    """This shard's (local, remote, valid words ``[e_max, 1]``) tensors."""
    return (torch.from_numpy(ed.local[s].astype(np.int64)).to(dev),
            torch.from_numpy(ed.remote[s].astype(np.int64)).to(dev),
            bitset.full_words_where(
                torch.from_numpy(ed.valid[s]).to(dev))[:, None])


def _gather_rows(x_local: torch.Tensor, mesh, v_n: int) -> torch.Tensor:
    """Every rank's ``[per, ...]`` block gathered into ``[V, ...]`` (the
    padding rows dropped), through the packed ``[per, W]`` exchange."""
    per = x_local.shape[0]
    full = engine_mod.all_gather_words(x_local.reshape(per, -1), mesh)
    return full.reshape((-1,) + tuple(x_local.shape[1:]))[:v_n]


# ------------------------------------------------------------ closure only
def distributed_closure(graph: Graph, seed_words: np.ndarray,
                        mesh: ShardMesh, *, max_iters: int | None = None,
                        chunk_words: int = 2,
                        row_budget: int | None = None) -> torch.Tensor:
    """Reachability closure, vertex-sharded over ``mesh`` (collective).

    ``seed_words`` is the packed uint32 ``[V, W]`` per-vertex pattern;
    every rank gets the whole closure as int32 ``[V, W]`` on its device,
    with the semantics of the single-device build's fixpoint:

        R[u] = OR_{u →+ v} seed[v]

    (a vertex's own seed bits only when it lies on a cycle).  The rounds
    stop on the reduced changed flag; ``row_budget`` switches the
    exchange to shipped changed rows (``engine.closure_sharded_delta``),
    with the same result for any budget >= 1."""
    seed_words = np.asarray(seed_words)
    if seed_words.dtype != np.uint32:
        raise TypeError(
            "distributed_closure takes packed uint32 seed words "
            f"(got {seed_words.dtype}); pack bool planes with "
            "bitset.pack_bits_np first")
    dev, s = mesh.device, mesh.rank
    v_pad, ed = partition_graph(graph, mesh.size, by="src")
    per = v_pad // mesh.size
    iters = max_iters or v_pad
    rows = bitset.np_to_words(
        _pad_to(seed_words, v_pad)[s * per:(s + 1) * per], dev)
    loc, rem, okw = _shard_edges(ed, s, dev)

    def step(r):
        return engine_mod.propagate_sharded(r, rem, loc, okw, mesh,
                                            num_segments=per,
                                            chunk_words=chunk_words)

    base = step(rows)   # successor seeds: self excluded, as in the build
    if row_budget is not None:
        # a binding budget trades rounds for traffic: scale the dense
        # round bound by the worst per-rank backlog
        backlog = -(-per // max(1, min(row_budget, per)))
        r, _ = engine_mod.closure_sharded_delta(
            base, rem, loc, okw, mesh, per=per, v_pad=v_pad,
            chunk_words=chunk_words, row_budget=row_budget,
            max_iters=iters * backlog)
    else:
        r, _ = engine_mod.closure_sharded(base, step, mesh, max_iters=iters)
    return _gather_rows(r, mesh, graph.n_vertices)


# ------------------------------------------------------------ index build
def build_index(graph: Graph, cfg: "build_mod.TDRConfig | None" = None, *,
                mesh: ShardMesh, chunk_words: int | None = None
                ) -> "build_mod.TDRIndex":
    """Vertex-sharded construction of the whole TDR index (collective).

    The host precompute (DFS intervals, hash rows, label slots, way
    routing) is the single-device build's, on every rank; the closures,
    the k vertical levels and the per-way projections run sharded with
    the packed-word exchange.  Every rank returns the whole index on
    ``mesh.device``, equal to ``tdr_build.build_index(graph, cfg)`` on
    every plane.  Like the JAX package's, it keeps no maintenance planes
    (``base_*``, ``r_*``, ``d_*``), only ``disc``: ``update_index`` on it
    takes the layout-pinned rebuild."""
    cfg = cfg or build_mod.TDRConfig()
    dev, s, n = mesh.device, mesh.rank, mesh.size
    v_n = graph.n_vertices
    push, pop, disc = build_mod.dfs_intervals(graph)
    vtx_words_np = build_mod._vertex_bit_words(cfg, disc)      # [V, Wv]
    lab_slot = build_mod._label_slots(cfg, graph.n_labels)
    g_count, way = build_mod.way_assignment(cfg, graph, disc)
    lab_words = build_mod._edge_label_words(cfg, lab_slot, graph.labels)

    v_pad, fwd = partition_graph(graph, n, by="src")
    _, rev = partition_graph(graph, n, by="dst")
    per = v_pad // n
    own = slice(s * per, (s + 1) * per)
    gmax, k = cfg.g_max, cfg.k
    cw = chunk_words or max(1, cfg.bit_chunk // bitset.WORD)
    iters = cfg.max_fixpoint_iters or v_n
    wv, wl = vtx_words_np.shape[1], lab_words.shape[1]

    # per-edge payloads in this shard's forward layout (zeroed pads; an
    # edgeless graph has only padding slots)
    if graph.n_edges:
        ok = fwd.valid[s]
        labw_np = np.where(ok[:, None], lab_words[fwd.eidx[s]], 0)
        way_np = np.where(ok, way[fwd.eidx[s]], 0)
    else:
        labw_np = np.zeros((fwd.eidx.shape[1], wl), dtype=np.uint32)
        way_np = np.zeros(fwd.eidx.shape[1], dtype=np.int64)
    labw = bitset.np_to_words(labw_np.astype(np.uint32), dev)
    way_l = torch.from_numpy(way_np.astype(np.int64)).to(dev)
    vtx_l = bitset.np_to_words(_pad_to(vtx_words_np, v_pad)[own], dev)
    leaf_l = torch.from_numpy(
        _pad_to(graph.out_degree() == 0, v_pad)[own]).to(dev)
    g_l = torch.from_numpy(_pad_to(g_count, v_pad)[own]).to(dev)
    null_w = bitset.np_to_words(build_mod._null_words(cfg), dev)
    f_loc, f_rem, fokw = _shard_edges(fwd, s, dev)
    r_loc, r_rem, rokw = _shard_edges(rev, s, dev)

    def prop_f(x):
        return engine_mod.propagate_sharded(x, f_rem, f_loc, fokw, mesh,
                                            num_segments=per,
                                            chunk_words=cw)

    def prop_r(x):
        return engine_mod.propagate_sharded(x, r_rem, r_loc, rokw, mesh,
                                            num_segments=per,
                                            chunk_words=cw)

    # ---- forward vertex closure  R[u] = OR (bit(v) | R[v]) --------------
    base_v = prop_f(vtx_l)
    r_vtx, rounds = engine_mod.closure_sharded(base_v, prop_f, mesh,
                                               max_iters=iters)
    # ---- forward label closure ------------------------------------------
    base_l = bitset.segment_or_words(labw, f_loc, num_segments=per,
                                     chunk_words=cw)
    r_lab, _ = engine_mod.closure_sharded(base_l, prop_f, mesh,
                                          max_iters=iters)
    # ---- reverse closure for N_in ---------------------------------------
    base_r = prop_r(vtx_l)
    n_in, _ = engine_mod.closure_sharded(base_r, prop_r, mesh,
                                         max_iters=iters)

    # ---- vertical levels (exact k-round propagation) --------------------
    leaf = leaf_l[:, None]
    cur_lab = torch.where(leaf, null_w[None, :], base_l)
    cur_vtx = base_v
    d_lab, d_vtx = [cur_lab], [cur_vtx]
    for _ in range(1, k):
        cur_lab = torch.where(leaf, null_w[None, :], prop_f(cur_lab))
        cur_vtx = torch.where(leaf, 0, prop_f(cur_vtx)).to(torch.int32)
        d_lab.append(cur_lab)
        d_vtx.append(cur_vtx)

    # ---- per-way projections (packed-word gathers + segment ORs) --------
    full_vtx = engine_mod.all_gather_words(vtx_l, mesh)
    full_rvtx = engine_mod.all_gather_words(r_vtx, mesh)
    full_rlab = engine_mod.all_gather_words(r_lab, mesh)
    seg = f_loc * gmax + way_l
    n_seg = per * gmax

    def proj(vals):
        return bitset.segment_or_words(vals & fokw, seg, num_segments=n_seg,
                                       chunk_words=cw)

    h_vtx = proj(full_vtx[f_rem] | full_rvtx[f_rem])
    h_lab = proj(labw | full_rlab[f_rem])
    v_lab_lv = [proj(labw)]
    v_vtx_lv = [proj(full_vtx[f_rem])]
    for l in range(1, k):
        v_lab_lv.append(proj(engine_mod.all_gather_words(
            d_lab[l - 1], mesh)[f_rem]))
        v_vtx_lv.append(proj(engine_mod.all_gather_words(
            d_vtx[l - 1], mesh)[f_rem]))

    h_vtx = h_vtx.reshape(per, gmax, wv)
    h_lab = h_lab.reshape(per, gmax, wl)
    v_lab_p = torch.stack(v_lab_lv, dim=1).reshape(per, gmax, k, wl)
    v_vtx_p = torch.stack(v_vtx_lv, dim=1).reshape(per, gmax, k, wv)

    # the vertex hashes itself into each *used* way (Alg. 1 line 10)
    way_used = torch.arange(gmax, device=dev)[None, :] < g_l[:, None]
    h_vtx = h_vtx | torch.where(way_used[:, :, None], vtx_l[:, None, :], 0)
    n_out = bitset.or_reduce(h_vtx, axis=1) if gmax > 0 else r_vtx
    rounds_t = torch.tensor([rounds], dtype=torch.int32, device=dev)
    return build_mod.TDRIndex(
        cfg=cfg, graph=graph,
        h_vtx=_gather_rows(h_vtx, mesh, v_n),
        h_lab=_gather_rows(h_lab, mesh, v_n),
        v_vtx=_gather_rows(v_vtx_p, mesh, v_n),
        v_lab=_gather_rows(v_lab_p, mesh, v_n),
        n_out=_gather_rows(n_out | vtx_l, mesh, v_n),
        n_in=_gather_rows(n_in | vtx_l, mesh, v_n),
        push=torch.from_numpy(push).to(dev),
        pop=torch.from_numpy(pop).to(dev),
        g_count=torch.from_numpy(g_count).to(dev),
        vtx_words=vtx_words_np, lab_slot=lab_slot,
        fixpoint_rounds=int(engine_mod.all_reduce_max(rounds_t, mesh)[0]),
        # pin the hash layout, so update_index on this index can fall back
        # to a layout-pinned rebuild (no closure planes are kept)
        disc=disc)


# -------------------------------------------------------- query answering
def filter_cascade_sharded(index: "build_mod.TDRIndex",
                           plan: "query_mod.QueryPlan",
                           mesh: ShardMesh) -> np.ndarray:
    """Phase-1 cascade with the job axis split over ``mesh``
    (collective): each rank runs ``tdr_query._filter_cascade`` on its
    contiguous slice of the plan's jobs, and the verdicts are gathered,
    so every rank returns the whole verdict int ``[J]``.  ``plan.n_jobs``
    must be a multiple of ``mesh.size`` (pad with ``QueryPlan.pad_to``)."""
    if plan.n_jobs % mesh.size:
        raise ValueError(f"job axis {plan.n_jobs} not divisible by mesh "
                         f"size {mesh.size}")
    per = plan.n_jobs // mesh.size
    own = slice(mesh.rank * per, (mesh.rank + 1) * per)
    verdict = query_mod._cascade_rows(index, plan, own)
    full = engine_mod.all_gather_words(
        verdict.to(torch.int32).reshape(per, 1), mesh)
    return full.reshape(-1).cpu().numpy()


def answer_batch(index: "build_mod.TDRIndex", queries, *, mesh: ShardMesh,
                 **kw) -> np.ndarray:
    """Sharded PCR answering (collective): ``tdr_query.answer_batch`` with
    the phase-1 cascade split over the job axis and the phase-2 chunks
    dealt over the ranks."""
    return query_mod.answer_batch(index, queries, mesh=mesh, **kw)

