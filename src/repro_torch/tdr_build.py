"""TDR index construction (paper §IV, Alg. 1) on torch.

The paper builds the index by a bottom-up DFS merging child bitsets into
parents.  Here the same fixpoint is computed level-synchronously,

    R ← R  ∨  (A ⊗ R)        (boolean-OR semiring, one round per level)

through ``repro_torch.engine`` on packed int32 words.  On a card each round
is one hand-written CUDA kernel launch (block-sparse for the closures,
dense ``bitset_matmul`` for the one-hop and k-level rounds).

Index anatomy (per vertex ``u``, ``G`` ways, ``k`` vertical levels):

* ``h_vtx [V,G,Wv]``  — horizontal reachable-vertex Bloom masks per way
* ``h_lab [V,G,Wl]``  — horizontal path-label masks per way
* ``v_vtx [V,G,k,Wv]``— vertical per-level vertex masks (hop ℓ+1)
* ``v_lab [V,G,k,Wl]``— vertical per-level label masks (+ NULL bit for
  paths that ended before the level)
* ``n_out/n_in [V,Wv]`` — 1-way global closure Blooms (forward / reverse)
* ``push/pop [V]``    — DFS-forest intervals (ancestor ⇒ reachable)

The host precompute (DFS intervals, hash layout, label slots, way routing)
is numpy, kept in step with the JAX package so both build the same planes.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from . import bitset
from . import compressed as compressed_mod
from . import engine as engine_mod
from .graph import Graph, GraphDelta, csr_row_edges


# ---------------------------------------------------------------- config
@dataclasses.dataclass(frozen=True)
class TDRConfig:
    vtx_bits: int = 256          # Bloom width for vertex sets (per way)
    lab_slots: int = 63          # label slots (identity if n_labels fits)
    g_max: int = 4               # max ways per vertex
    succ_per_way: int = 4        # target successors per way (sets g(u))
    k: int = 3                   # vertical levels
    n_hashes: int = 2            # Bloom hashes per vertex
    hash_scheme: str = "dfs-block"   # "dfs-block" | "mult"
    max_fixpoint_iters: int = 0  # 0 -> |V| (safe upper bound)
    bit_chunk: int = 64          # word-chunk for segment-backend ORs

    @property
    def lab_bits(self) -> int:
        return self.lab_slots + 1  # + NULL bit

    @property
    def null_bit(self) -> int:
        return self.lab_slots


# ----------------------------------------------------------------- index
@dataclasses.dataclass
class TDRIndex:
    """Index planes as int32 tensors on one device (packed uint32 bits)."""
    cfg: TDRConfig
    graph: Graph
    h_vtx: torch.Tensor   # [V, G, Wv]
    h_lab: torch.Tensor   # [V, G, Wl]
    v_vtx: torch.Tensor   # [V, G, k, Wv]
    v_lab: torch.Tensor   # [V, G, k, Wl]
    n_out: torch.Tensor   # [V, Wv]
    n_in: torch.Tensor    # [V, Wv]
    push: torch.Tensor    # [V] int32
    pop: torch.Tensor     # [V] int32
    g_count: torch.Tensor  # [V] int32 (ways actually used)
    # host-side hash tables
    vtx_words: np.ndarray      # uint32 [V, Wv] — packed hash row per vertex
    lab_slot: np.ndarray       # int32 [L] — label -> slot
    fixpoint_rounds: int = 0
    # frozen discovery-order hash layout and the one-hop, closure and
    # vertical working planes (what later incremental updates start from)
    disc: np.ndarray | None = dataclasses.field(default=None, repr=False)
    base_v: torch.Tensor | None = dataclasses.field(default=None, repr=False)
    base_l: torch.Tensor | None = dataclasses.field(default=None, repr=False)
    base_r: torch.Tensor | None = dataclasses.field(default=None, repr=False)
    r_vtx: torch.Tensor | None = dataclasses.field(default=None, repr=False)
    r_lab: torch.Tensor | None = dataclasses.field(default=None, repr=False)
    r_in: torch.Tensor | None = dataclasses.field(default=None, repr=False)
    d_vtx: torch.Tensor | None = dataclasses.field(default=None, repr=False)
    d_lab: torch.Tensor | None = dataclasses.field(default=None, repr=False)
    _vtx_packed: torch.Tensor | None = dataclasses.field(default=None,
                                                         repr=False)
    _engines: dict = dataclasses.field(default_factory=dict, repr=False)
    # plane name -> compressed_mod.CompressedPlanes, built lazily and
    # row-patched across updates (every path that rewrites a plane either
    # patches its entry or drops it)
    _comp: dict = dataclasses.field(default_factory=dict, repr=False)
    # canonical pattern -> compiled plan rows (tdr_query.pattern_rows LRU)
    _plan_cache: dict = dataclasses.field(default_factory=dict, repr=False)
    _sat_dev: tuple | None = dataclasses.field(default=None, repr=False)

    @property
    def device(self) -> torch.device:
        return self.n_out.device

    @property
    def vtx_packed(self) -> torch.Tensor:
        """Device copy of the per-vertex packed hash rows (cached)."""
        if self._vtx_packed is None:
            self._vtx_packed = bitset.np_to_words(self.vtx_words, self.device)
        return self._vtx_packed

    def engine(self, backend: str | None = None,
               config: "engine_mod.EngineConfig | None" = None
               ) -> "engine_mod.Engine":
        """Cached engine over this index's graph, on the index's device."""
        key = engine_mod.resolve_backend(
            backend or (config.backend if config else "auto"), self.device)
        if key not in self._engines:
            self._engines[key] = engine_mod.make_engine(
                self.graph, backend=key, config=config, device=self.device)
        return self._engines[key]

    def plane_specs(self) -> dict:
        """Every packed plane of the index with its valid-bit width:
        ``name -> (tensor, nbits)``.  The closure planes (``r_*``) are
        included when present: updates warm-start from them."""
        cfg = self.cfg
        specs = {
            "h_vtx": (self.h_vtx, cfg.vtx_bits),
            "h_lab": (self.h_lab, cfg.lab_bits),
            "v_vtx": (self.v_vtx, cfg.vtx_bits),
            "v_lab": (self.v_lab, cfg.lab_bits),
            "n_out": (self.n_out, cfg.vtx_bits),
            "n_in": (self.n_in, cfg.vtx_bits),
            "r_vtx": (self.r_vtx, cfg.vtx_bits),
            "r_lab": (self.r_lab, cfg.lab_bits),
            "r_in": (self.r_in, cfg.vtx_bits),
        }
        return {k: v for k, v in specs.items() if v[0] is not None}

    def aux_plane_specs(self) -> dict:
        """The remaining maintenance planes with their valid-bit widths:
        the one-hop bases and the vertical working planes.
        ``repro_torch.snapshot`` stores the union of this and
        ``plane_specs``, so a restored index chains ``update_index`` like
        the one that was saved."""
        cfg = self.cfg
        specs = {
            "base_v": (self.base_v, cfg.vtx_bits),
            "base_l": (self.base_l, cfg.lab_bits),
            "base_r": (self.base_r, cfg.vtx_bits),
            "d_vtx": (self.d_vtx, cfg.vtx_bits),
            "d_lab": (self.d_lab, cfg.lab_bits),
        }
        return {k: v for k, v in specs.items() if v[0] is not None}

    def _compressed(self, names) -> dict:
        """The cached compressed form of the planes ``names``."""
        specs = self.plane_specs()
        for name in names:
            if name not in self._comp:
                arr, nbits = specs[name]
                self._comp[name] = compressed_mod.compress(
                    bitset.words_to_np(arr), nbits=nbits)
        return {name: self._comp[name] for name in names}

    def compressed_planes(self) -> dict:
        """Two-level compressed form of every plane of ``plane_specs``
        (built lazily, cached on the index, row-patched by
        ``update_index``)."""
        self._compressed(self.plane_specs())
        return dict(self._comp)

    def summary_flags(self) -> dict:
        """Host row-summary flags, level 1 of the compressed ``n_out`` /
        ``n_in`` planes (the same cache as ``compressed_planes``, filled
        for these two planes only so a query batch compresses nothing
        else): ``sat_out[u]`` / ``sat_in[v]`` mark vertices whose global
        Bloom row is ALL_ONE — their membership filter passes for every
        counterpart and their query corridor is the whole vertex set."""
        comp = self._compressed(("n_out", "n_in"))
        one = compressed_mod.ALL_ONE
        return {"sat_out": comp["n_out"].row_states == one,
                "sat_in": comp["n_in"].row_states == one}

    def summary_flags_dev(self) -> tuple:
        """Device (sat_out, sat_in) bool [V] for the filter cascade."""
        if self._sat_dev is None:
            flags = self.summary_flags()
            self._sat_dev = (torch.from_numpy(flags["sat_out"]).to(
                self.device), torch.from_numpy(flags["sat_in"]).to(
                self.device))
        return self._sat_dev

    def index_memory_stats(self) -> dict:
        """Per-plane and total footprint, dense vs two-level compressed."""
        planes = {}
        dense = comp = 0
        for name, c in sorted(self.compressed_planes().items()):
            planes[name] = {"dense_bytes": c.dense_nbytes,
                            "compressed_bytes": c.nbytes,
                            "ratio": round(c.ratio, 3)}
            dense += c.dense_nbytes
            comp += c.nbytes
        return {"planes": planes, "dense_bytes": dense,
                "compressed_bytes": comp,
                "ratio": round(dense / max(comp, 1), 3)}

    def size_bytes(self, logical: bool = True) -> int:
        """Index footprint.  ``logical`` counts only the ways in use (the
        paper's accounting); otherwise the dense padded layout."""
        g = self.g_count.cpu().numpy()
        wv = self.h_vtx.shape[-1]
        wl = self.h_lab.shape[-1]
        k = self.v_lab.shape[2]
        per_way = 4 * (wv + wl + k * (wv + wl))
        ways = int(g.sum()) if logical else int(g.shape[0] * self.cfg.g_max)
        fixed = (self.n_out.numel() * 4 + self.n_in.numel() * 4
                 + 2 * 4 * g.shape[0])
        return ways * per_way + fixed


# --------------------------------------------------------- host precompute
def dfs_intervals(graph: Graph) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Iterative DFS forest: push/pop counters + discovery order."""
    v_n = graph.n_vertices
    indptr, indices = graph.indptr, graph.indices
    push = np.full(v_n, -1, dtype=np.int64)
    pop = np.full(v_n, -1, dtype=np.int64)
    disc = np.full(v_n, -1, dtype=np.int64)
    t = 0
    d = 0
    # prefer true roots (no predecessors) first, matching the paper
    in_deg = np.zeros(v_n, dtype=np.int64)
    np.add.at(in_deg, indices, 1)
    order = np.concatenate([np.flatnonzero(in_deg == 0),
                            np.flatnonzero(in_deg != 0)])
    for root in order:
        if push[root] >= 0:
            continue
        stack = [(int(root), int(indptr[root]))]
        push[root] = t; t += 1
        disc[root] = d; d += 1
        while stack:
            u, i = stack[-1]
            if i < indptr[u + 1]:
                stack[-1] = (u, i + 1)
                w = int(indices[i])
                if push[w] < 0:
                    push[w] = t; t += 1
                    disc[w] = d; d += 1
                    stack.append((w, int(indptr[w])))
            else:
                stack.pop()
                pop[u] = t; t += 1
    return push.astype(np.int32), pop.astype(np.int32), disc.astype(np.int32)


def _hash_keys(n: int) -> list:
    """``n`` distinct odd 64-bit multipliers for the Bloom hash schedule:
    three golden-ratio constants, then splitmix64-derived keys."""
    ks = [0x9E3779B97F4A7C15, 0xC2B2AE3D27D4EB4F, 0x165667B19E3779F9]
    mask = (1 << 64) - 1
    x = ks[-1]
    while len(ks) < n:
        x = (x + 0x9E3779B97F4A7C15) & mask
        z = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & mask
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & mask
        ks.append((z ^ (z >> 31)) | 1)
    return [np.uint64(k) for k in ks[:n]]


def _vertex_hash_positions(cfg: TDRConfig, disc: np.ndarray) -> list:
    """Bloom bit positions per vertex: one int64 [V] array per hash."""
    v_n = disc.shape[0]
    ids = np.arange(v_n, dtype=np.uint64)
    if cfg.hash_scheme == "dfs-block":
        # consecutive discovery order -> same bit (paper's locality hashing)
        h0 = (disc.astype(np.uint64) * np.uint64(cfg.vtx_bits)) // np.uint64(
            max(v_n, 1))
    else:
        h0 = ((ids + 1) * np.uint64(2654435761)) % np.uint64(cfg.vtx_bits)
    positions = [h0.astype(np.int64) % cfg.vtx_bits]
    ks = _hash_keys(max(cfg.n_hashes - 1, 0))
    for i in range(1, cfg.n_hashes):
        h = (((ids + 1) * ks[i - 1]) >> np.uint64(17)) % np.uint64(
            cfg.vtx_bits)
        positions.append(h.astype(np.int64))
    return positions


def _vertex_bit_words(cfg: TDRConfig, disc: np.ndarray) -> np.ndarray:
    """Packed Bloom pattern per vertex (uint32 [V, ceil(vtx_bits/32)])."""
    v_n = disc.shape[0]
    words = np.zeros((v_n, bitset.n_words(cfg.vtx_bits)), dtype=np.uint32)
    for pos in _vertex_hash_positions(cfg, disc):
        bitset.set_bits_np(words, (np.arange(v_n),), pos)
    return words


def _label_slots(cfg: TDRConfig, n_labels: int) -> np.ndarray:
    ids = np.arange(n_labels, dtype=np.uint64)
    if n_labels <= cfg.lab_slots:
        return ids.astype(np.int32)
    return (((ids + 1) * np.uint64(0x9E3779B97F4A7C15)) >> np.uint64(13)
            ).astype(np.int64).astype(np.int32) % np.int32(cfg.lab_slots)


def _edge_label_words(cfg: TDRConfig, lab_slot: np.ndarray,
                      labels: np.ndarray) -> np.ndarray:
    """Per-edge packed label plane (uint32 [E, ceil(lab_bits/32)])."""
    e_n = labels.shape[0]
    words = np.zeros((e_n, bitset.n_words(cfg.lab_bits)), dtype=np.uint32)
    bitset.set_bits_np(words, (np.arange(e_n),), lab_slot[labels])
    return words


def _null_words(cfg: TDRConfig) -> np.ndarray:
    """Packed NULL-bit plane (uint32 [ceil(lab_bits/32)])."""
    w = np.zeros(bitset.n_words(cfg.lab_bits), dtype=np.uint32)
    w[cfg.null_bit >> 5] = np.uint32(1) << np.uint32(cfg.null_bit & 31)
    return w


def way_assignment(cfg: TDRConfig, graph: Graph,
                   disc: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-vertex way count g(u) and per-edge way id:
    ``g(u) = min(next_pow2(ceil(deg/succ_per_way)), g_max)``; successors
    are routed by discovery-order hash for locality."""
    deg = graph.out_degree().astype(np.int64)
    g = np.zeros_like(deg)
    nz = deg > 0
    tgt = np.maximum(1, -(-deg[nz] // cfg.succ_per_way))
    g[nz] = np.minimum(2 ** np.ceil(np.log2(tgt)).astype(np.int64), cfg.g_max)
    src = graph.src
    way = (disc[graph.indices].astype(np.int64) % np.maximum(g[src], 1))
    return g.astype(np.int32), way.astype(np.int32)


# ----------------------------------------------------------- device build
def build_index(graph: Graph, cfg: TDRConfig = TDRConfig(), *,
                backend: str | None = None,
                engine_config: "engine_mod.EngineConfig | None" = None,
                layout: np.ndarray | None = None,
                mesh=None, device="cuda") -> TDRIndex:
    """Construct the full TDR index for every vertex of ``graph``.

    ``device`` defaults to the card and raises when there is none; pass
    ``device="cpu"`` to build on the CPU.  ``backend`` (or
    ``engine_config``) selects ``segment`` / ``matmul`` / ``auto``.
    ``layout`` pins the discovery-order hash layout (int32 ``[V]``,
    normally ``TDRIndex.disc`` of an earlier build over the same vertex
    set) instead of deriving it from this graph's DFS forest; push/pop
    intervals are always recomputed from ``graph``.

    ``mesh`` (a ``distributed.ShardMesh``) routes to the vertex-sharded
    build, ``distributed.build_index``: a collective call that builds on
    the mesh's device, with the same planes and the exchange in packed
    int32 words.  It derives its own layout, so ``layout`` is refused.
    """
    if mesh is not None:
        if layout is not None:
            raise ValueError("layout pinning is single-device only; the "
                             "distributed build derives its own")
        from . import distributed  # deferred: it imports this module
        return distributed.build_index(graph, cfg, mesh=mesh)
    dev = engine_mod.resolve_device(device)
    v_n = graph.n_vertices
    push, pop, disc = dfs_intervals(graph)
    if layout is not None:
        disc = np.asarray(layout, dtype=np.int32)
        if disc.shape != (v_n,):
            raise ValueError(
                f"layout must be an int [{v_n}] discovery-order array")
    vtx_words_np = _vertex_bit_words(cfg, disc)
    lab_slot = _label_slots(cfg, graph.n_labels)
    g_count, way = way_assignment(cfg, graph, disc)

    if engine_config is None:
        engine_config = engine_mod.EngineConfig(bit_chunk=cfg.bit_chunk)
    eng = engine_mod.make_engine(graph, backend=backend,
                                 config=engine_config, device=dev)

    vtx_w = bitset.np_to_words(vtx_words_np, dev)                # [V, Wv]
    lab_w = bitset.np_to_words(
        _edge_label_words(cfg, lab_slot, graph.labels), dev)      # [E, Wl]
    max_iters = cfg.max_fixpoint_iters or v_n

    # ---- the three closure fixpoints (forward vtx/lab, reverse) --------
    base_v = eng.propagate(vtx_w)         # R[u] = OR (bit(v) | R[v])
    r_vtx, rounds = eng.closure(base_v, max_iters=max_iters)
    base_l = eng.segment_or(lab_w, eng.edge_src, v_n)
    r_lab, _ = eng.closure(base_l, max_iters=max_iters)
    base_r = eng.propagate(vtx_w, reverse=True)
    r_in, _ = eng.closure(base_r, reverse=True, max_iters=max_iters)

    idx = _assemble_planes(graph, cfg, eng, vtx_w=vtx_w, lab_w=lab_w,
                           base_v=base_v, base_l=base_l, base_r=base_r,
                           r_vtx=r_vtx, r_lab=r_lab, r_in=r_in,
                           g_count=g_count, way=way, push=push, pop=pop,
                           disc=disc, vtx_words_np=vtx_words_np,
                           lab_slot=lab_slot, rounds=int(rounds))
    idx._engines[eng.backend] = eng
    idx._vtx_packed = vtx_w
    return idx


def _assemble_planes(graph: Graph, cfg: TDRConfig, eng, *, vtx_w, lab_w,
                     base_v, base_l, base_r, r_vtx, r_lab, r_in, g_count,
                     way, push, pop, disc, vtx_words_np, lab_slot,
                     rounds: int) -> TDRIndex:
    """Tail of Alg. 1: vertical k-level propagation + per-way projections
    + index wrap-up, given converged closures."""
    v_n = graph.n_vertices
    dev = eng.device
    src, dst = eng.edge_src, eng.edge_dst
    null_w = bitset.np_to_words(_null_words(cfg), dev)           # [Wl]
    is_leaf = torch.from_numpy(graph.out_degree() == 0).to(dev)

    # ---- vertical levels (exact k-round propagation) --------------------
    cur_lab = torch.where(is_leaf[:, None], null_w[None, :], base_l)
    cur_vtx = base_v
    d_lab_levels = [cur_lab]   # D_lab[:, l] — labels at hop l+1
    d_vtx_levels = [cur_vtx]   # D_vtx[:, l] — vertices at hop l+1
    for _ in range(1, cfg.k):
        nxt_lab = eng.propagate(cur_lab)
        nxt_lab = torch.where(is_leaf[:, None], null_w[None, :], nxt_lab)
        nxt_vtx = eng.propagate(cur_vtx)
        nxt_vtx = torch.where(is_leaf[:, None], 0, nxt_vtx)
        d_lab_levels.append(nxt_lab)
        d_vtx_levels.append(nxt_vtx)
        cur_lab, cur_vtx = nxt_lab, nxt_vtx
    d_lab = torch.stack(d_lab_levels, dim=1)   # [V, k, Wl]
    d_vtx = torch.stack(d_vtx_levels, dim=1)   # [V, k, Wv]

    # ---- per-way projections --------------------------------------------
    gmax = cfg.g_max
    seg = src * gmax + torch.from_numpy(way.astype(np.int64)).to(dev)
    n_seg = v_n * gmax

    h_vtx = eng.segment_or(vtx_w[dst] | r_vtx[dst], seg, n_seg)
    h_lab = eng.segment_or(lab_w | r_lab[dst], seg, n_seg)
    v_lab_lv = [eng.segment_or(lab_w, seg, n_seg)]
    v_vtx_lv = [eng.segment_or(vtx_w[dst], seg, n_seg)]
    for l in range(1, cfg.k):
        v_lab_lv.append(eng.segment_or(d_lab[dst, l - 1], seg, n_seg))
        v_vtx_lv.append(eng.segment_or(d_vtx[dst, l - 1], seg, n_seg))

    wv = vtx_w.shape[-1]
    wl = lab_w.shape[-1]
    h_vtx = h_vtx.reshape(v_n, gmax, wv)
    h_lab = h_lab.reshape(v_n, gmax, wl)
    v_lab_p = torch.stack(v_lab_lv, dim=1).reshape(v_n, gmax, cfg.k, wl)
    v_vtx_p = torch.stack(v_vtx_lv, dim=1).reshape(v_n, gmax, cfg.k, wv)

    # the vertex hashes itself into each *used* way (paper Alg. 1 line 10)
    g_count_t = torch.from_numpy(g_count).to(dev)
    way_used = torch.arange(gmax, device=dev)[None, :] < g_count_t[:, None]
    h_vtx = h_vtx | torch.where(way_used[:, :, None], vtx_w[:, None, :], 0)

    n_out = bitset.or_reduce(h_vtx, axis=1) if gmax > 0 else r_vtx
    n_out = n_out | vtx_w  # self is "reachable" for membership filtering

    return TDRIndex(
        cfg=cfg, graph=graph,
        h_vtx=h_vtx, h_lab=h_lab, v_vtx=v_vtx_p, v_lab=v_lab_p,
        n_out=n_out, n_in=r_in | vtx_w,
        push=torch.from_numpy(push).to(dev), pop=torch.from_numpy(pop).to(dev),
        g_count=g_count_t,
        vtx_words=vtx_words_np, lab_slot=lab_slot,
        fixpoint_rounds=rounds, disc=disc,
        base_v=base_v, base_l=base_l, base_r=base_r,
        r_vtx=r_vtx, r_lab=r_lab, r_in=r_in, d_vtx=d_vtx, d_lab=d_lab)


def _carry_compressed(old_comp: dict, idx2: TDRIndex,
                      row_sets: dict) -> dict:
    """Carry an index's compressed-plane cache across a row-granular
    update: for each cached plane, only the sub-rows derived from the
    vertex rows that could have changed are re-summarized
    (``CompressedPlanes.patch_rows``); the update never densifies."""
    out = {}
    v_n = idx2.graph.n_vertices
    specs = idx2.plane_specs()
    for name, c in old_comp.items():
        if name not in specs or name not in row_sets:
            continue
        arr, _ = specs[name]
        vrows = np.asarray(row_sets[name], dtype=np.int64)
        flat = arr.reshape(-1, c.n_words)
        mult = flat.shape[0] // max(v_n, 1)
        sub = (vrows[:, None] * mult
               + np.arange(mult, dtype=np.int64)[None, :]).reshape(-1)
        if sub.size == 0:
            out[name] = c
            continue
        out[name] = c.patch_rows(sub, bitset.words_to_np(
            flat[torch.from_numpy(sub).to(flat.device)]))
    return out


# ------------------------------------------------------ incremental update
@dataclasses.dataclass
class UpdateStats:
    """Counters filled by one ``update_index`` call.

    ``mode`` is "noop" | "incremental" | "rebuild"; ``tail`` refines the
    incremental path: "patch" (row-granular plane rewrite) or "full" (the
    shared build tail, when the affected-row set crossed the threshold
    but the closures still warm-started)."""
    mode: str = ""
    tail: str = ""
    n_added: int = 0
    n_removed: int = 0
    dirty_fwd: int = 0     # rows re-seeded in the forward closures
    dirty_rev: int = 0     # rows re-seeded in the reverse closure
    changed_rows: int = 0  # rows whose closure words actually changed
    patch_rows: int = 0    # rows re-derived by the plane patch
    rounds: int = 0        # warm-start rounds of the forward fixpoint
    wall_s: float = 0.0


def _bfs_mask(indptr: np.ndarray, indices: np.ndarray, seeds,
              v_n: int) -> np.ndarray:
    """Reachable-set bool [V] from ``seeds`` (inclusive) over one CSR —
    the host-side over-invalidation probe for deletions."""
    seen = np.zeros(v_n, dtype=bool)
    frontier = np.unique(np.asarray(seeds, dtype=np.int64))
    while frontier.size:
        seen[frontier] = True
        nbr = indices[csr_row_edges(indptr, frontier)]
        frontier = np.unique(nbr[~seen[nbr]])
    return seen


def _long(a: np.ndarray, dev) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, dtype=np.int64)).to(dev)


def _patch_bases(index: TDRIndex, vtx_w, rows_o, spos_o, dst_o, labw_o,
                 rows_i, dpos_i, src_i, chunk_words: int):
    """Re-derive the one-hop base planes for the rows whose edge set
    changed: out-edge rows ``rows_o`` for ``base_v``/``base_l``, in-edge
    rows ``rows_i`` for ``base_r``.  ``spos_o``/``dpos_i`` renumber each
    subset edge's endpoint to its position in the row list.  The row
    lists are exact (no padding), and the results are new tensors."""
    ro, ri = rows_o.shape[0], rows_i.shape[0]
    bv = bitset.segment_or_words(vtx_w[dst_o], spos_o, num_segments=ro,
                                 chunk_words=chunk_words)
    bl = bitset.segment_or_words(labw_o, spos_o, num_segments=ro,
                                 chunk_words=chunk_words)
    br = bitset.segment_or_words(vtx_w[src_i], dpos_i, num_segments=ri,
                                 chunk_words=chunk_words)
    return (index.base_v.index_put((rows_o,), bv),
            index.base_l.index_put((rows_o,), bl),
            index.base_r.index_put((rows_i,), br))


def _patch_tail(index: TDRIndex, cfg: TDRConfig, base_v2, base_l2, r_vtx2,
                r_lab2, r_in2, vtx_w, null_w, leaf_full, rows, leaf_rows,
                g_rows, spos, dst, labw, way, chunk_words: int):
    """Row-granular rewrite of the vertical planes and per-way projections
    for the affected rows only (``rows``, exact).  ``spos`` renumbers each
    subset edge's source to its position in ``rows``.  Exactness: a
    recomputed row uses the same formula as the full build over the same
    (patched) operands, and rows outside the patch set are provably
    unchanged.  Writes go to copies; the index's planes stay as they
    were."""
    r = rows.shape[0]
    k, gmax = cfg.k, cfg.g_max

    def seg_rows(vals):
        return bitset.segment_or_words(vals, spos, num_segments=r,
                                       chunk_words=chunk_words)

    # vertical planes: level 0 *is* the (already patched) base planes
    d_vtx2 = index.d_vtx.clone()
    d_vtx2[:, 0] = base_v2
    d_lab2 = index.d_lab.clone()
    d_lab2[:, 0] = torch.where(leaf_full[:, None], null_w[None, :], base_l2)
    for l in range(1, k):
        row_l = seg_rows(d_lab2[dst, l - 1])
        d_lab2[rows, l] = torch.where(leaf_rows[:, None], null_w[None, :],
                                      row_l)
        row_v = seg_rows(d_vtx2[dst, l - 1])
        d_vtx2[rows, l] = torch.where(leaf_rows[:, None], 0, row_v).to(
            torch.int32)

    # per-way projections over the affected rows
    seg = spos * gmax + way

    def proj(vals):
        return bitset.segment_or_words(vals, seg, num_segments=r * gmax,
                                       chunk_words=chunk_words)

    wv = vtx_w.shape[-1]
    wl = null_w.shape[-1]
    hv = proj(vtx_w[dst] | r_vtx2[dst]).reshape(r, gmax, wv)
    hl = proj(labw | r_lab2[dst]).reshape(r, gmax, wl)
    vl_lv = [proj(labw)]
    vv_lv = [proj(vtx_w[dst])]
    for l in range(1, k):
        vl_lv.append(proj(d_lab2[dst, l - 1]))
        vv_lv.append(proj(d_vtx2[dst, l - 1]))
    vl = torch.stack(vl_lv, dim=1).reshape(r, gmax, k, wl)
    vv = torch.stack(vv_lv, dim=1).reshape(r, gmax, k, wv)
    way_used = torch.arange(gmax, device=rows.device)[None, :] < \
        g_rows[:, None]
    hv = hv | torch.where(way_used[:, :, None], vtx_w[rows][:, None, :], 0)
    h_vtx2 = index.h_vtx.index_put((rows,), hv)
    h_lab2 = index.h_lab.index_put((rows,), hl)
    v_vtx2 = index.v_vtx.index_put((rows,), vv)
    v_lab2 = index.v_lab.index_put((rows,), vl)
    n_out2 = bitset.or_reduce(h_vtx2, axis=1) | vtx_w
    n_in2 = r_in2 | vtx_w
    return d_vtx2, d_lab2, h_vtx2, h_lab2, v_vtx2, v_lab2, n_out2, n_in2


def update_index(index: TDRIndex, delta: "GraphDelta | None" = None, *,
                 edges_added=(), edges_removed=(),
                 rebuild_threshold: float = 0.5,
                 backend: str | None = None,
                 engine_config: "engine_mod.EngineConfig | None" = None,
                 stats: UpdateStats | None = None,
                 device="cuda") -> TDRIndex:
    """Maintain the TDR index under edge insertions/deletions.

    Returns a *new* ``TDRIndex`` over ``delta.graph`` on the index's
    device; ``index`` is left untouched, so in-flight readers stay
    consistent.  Planes are bit-identical to ``build_index(delta.graph,
    cfg, layout=index.disc)``, the frozen-layout rebuild.  ``delta`` is a
    ``graph.GraphDelta`` from ``Graph.apply_updates``; alternatively pass
    raw ``edges_added``/``edges_removed`` triples.  ``device`` defaults to
    the card and must be where ``index`` lives.

    Strategy (packed-word delta propagation):

    * **Insertions are monotone** under the OR semiring: the one-hop base
      planes are re-derived for the touched rows only, and the three
      closure fixpoints re-enter ``engine.closure`` from the previous
      converged state, which drains the delta in a few rounds.
    * **Deletions are not**: every vertex that could reach a removed
      edge's source (old-graph reachability, a sound superset computed by
      host BFS) is over-invalidated — its closure rows reset to the new
      base — and the same warm fixpoint re-converges them.  When the
      dirty set reaches ``rebuild_threshold * V`` the update falls back
      to a full (still layout-pinned) rebuild.
    * **Plane patching**: the vertical k-level planes and per-way
      projections are rewritten only for rows that can differ — touched
      sources, the radius-k predecessor ball, and predecessors of rows
      whose closure words actually changed — unless that set also
      crosses the threshold, in which case the shared build tail
      recomputes them in full (closure savings kept either way).

    On ``matmul`` the engine is carried over through
    ``Engine.apply_delta``, so the warm closures run over the patched
    dense or block-sparse adjacency.  Every row list is scattered at its
    exact length, into new tensors.
    """
    t0 = time.perf_counter()
    dev = index.device
    engine_mod._check_same_device(dev, device)
    st = stats if stats is not None else UpdateStats()
    if delta is None:
        delta = index.graph.apply_updates(edges_added, edges_removed)
    if not isinstance(delta, GraphDelta):
        raise TypeError("delta must be a graph.GraphDelta "
                        "(the result of Graph.apply_updates)")
    g2 = delta.graph
    if (g2.n_vertices != index.graph.n_vertices
            or g2.n_labels != index.graph.n_labels):
        raise ValueError("updates must preserve the vertex/label universe")
    st.n_added = int(delta.added.shape[0])
    st.n_removed = int(delta.removed.shape[0])
    if delta.n_changes == 0:
        st.mode = "noop"
        st.wall_s = time.perf_counter() - t0
        return index

    cfg = index.cfg
    v_n = g2.n_vertices
    aux_ok = (index.disc is not None and index.base_v is not None
              and index.r_vtx is not None and index.d_vtx is not None
              and cfg.g_max > 0)

    def rebuild():
        st.mode = "rebuild"
        idx2 = build_index(g2, cfg, backend=backend,
                           engine_config=engine_config, layout=index.disc,
                           device=dev)
        st.wall_s = time.perf_counter() - t0
        return idx2

    if not aux_ok:
        return rebuild()

    # ---- deletion over-invalidation scope (host BFS, sound superset) ----
    if st.n_removed:
        rev_old = index.graph.reverse()
        d_fwd = _bfs_mask(rev_old.indptr, rev_old.indices,
                          delta.removed[:, 0], v_n)
        d_rev = _bfs_mask(index.graph.indptr, index.graph.indices,
                          delta.removed[:, 1], v_n)
    else:
        d_fwd = np.zeros(v_n, dtype=bool)
        d_rev = d_fwd
    st.dirty_fwd = int(d_fwd.sum())
    st.dirty_rev = int(d_rev.sum())
    # inclusive compare: rebuild_threshold=0 always rebuilds, >=1 never
    # does on the dirty check (the patch-scope check below still can)
    if max(st.dirty_fwd, st.dirty_rev) >= rebuild_threshold * v_n:
        return rebuild()

    st.mode = "incremental"
    key = engine_mod.resolve_backend(
        backend or (engine_config.backend if engine_config else "auto"), dev)
    old_eng = index._engines.get(key)
    if old_eng is not None and old_eng.graph is index.graph:
        eng = old_eng.apply_delta(g2, delta.added, delta.removed,
                                  device=dev)
    else:
        ecfg = engine_config or engine_mod.EngineConfig(
            bit_chunk=cfg.bit_chunk)
        eng = engine_mod.make_engine(g2, backend=key, config=ecfg,
                                     device=dev)

    push, pop, _ = dfs_intervals(g2)     # intervals track the new forest
    g_count, way = way_assignment(cfg, g2, index.disc)  # frozen hashing
    vtx_w = index.vtx_packed
    cw = eng.config.chunk_words
    src2 = g2.src

    # ---- one-hop base planes: re-derive touched rows only ---------------
    s_all = np.unique(np.concatenate([delta.added[:, 0],
                                      delta.removed[:, 0]]))
    t_all = np.unique(np.concatenate([delta.added[:, 1],
                                      delta.removed[:, 1]]))
    s_mask = np.zeros(v_n, dtype=bool)
    s_mask[s_all] = True
    keep_o = s_mask[src2]
    so, do, lo_ = src2[keep_o], g2.indices[keep_o], g2.labels[keep_o]
    t_mask = np.zeros(v_n, dtype=bool)
    t_mask[t_all] = True
    keep_i = t_mask[g2.indices]
    si, di = src2[keep_i], g2.indices[keep_i]
    base_v2, base_l2, base_r2 = _patch_bases(
        index, vtx_w, _long(s_all, dev), _long(np.searchsorted(s_all, so),
                                               dev),
        _long(do, dev),
        bitset.np_to_words(_edge_label_words(cfg, index.lab_slot, lo_), dev),
        _long(t_all, dev), _long(np.searchsorted(t_all, di), dev),
        _long(si, dev), chunk_words=cw)

    # ---- warm-start closures (fwd vtx+lab fused along the word axis) ----
    wv = int(index.base_v.shape[-1])
    max_iters = cfg.max_fixpoint_iters or v_n
    dm = torch.from_numpy(d_fwd).to(dev)
    old_f = torch.cat([index.r_vtx, index.r_lab], dim=1)
    f0 = torch.cat(
        [torch.where(dm[:, None], base_v2, index.r_vtx) | base_v2,
         torch.where(dm[:, None], base_l2, index.r_lab) | base_l2], dim=1)
    rf, rounds = eng.closure(f0, max_iters=max_iters)
    r_vtx2, r_lab2 = rf[:, :wv].contiguous(), rf[:, wv:].contiguous()
    rm = torch.from_numpy(d_rev).to(dev)
    b0 = torch.where(rm[:, None], base_r2, index.r_in) | base_r2
    r_in2, _ = eng.closure(b0, reverse=True, max_iters=max_iters)
    st.rounds = int(rounds)

    # ---- exact changed-row scope for the plane patch --------------------
    changed = (rf != old_f).any(dim=1).cpu().numpy()
    st.changed_rows = int(changed.sum())
    rev2 = g2.reverse()

    def with_preds(mask):
        ids = np.flatnonzero(mask)
        out = mask.copy()
        if ids.size:
            out[rev2.indices[csr_row_edges(rev2.indptr, ids)]] = True
        return out

    ball = s_mask
    for _ in range(1, cfg.k):
        ball = with_preds(ball)
    p_mask = s_mask | ball | with_preds(changed)
    st.patch_rows = int(p_mask.sum())

    if st.patch_rows > min(rebuild_threshold, 1.0) * v_n:
        # patch scope too wide: reuse the warm closures, full tail
        st.tail = "full"
        lab_w_all = bitset.np_to_words(
            _edge_label_words(cfg, index.lab_slot, g2.labels), dev)
        idx2 = _assemble_planes(
            g2, cfg, eng, vtx_w=vtx_w, lab_w=lab_w_all, base_v=base_v2,
            base_l=base_l2, base_r=base_r2, r_vtx=r_vtx2, r_lab=r_lab2,
            r_in=r_in2, g_count=g_count, way=way, push=push, pop=pop,
            disc=index.disc, vtx_words_np=index.vtx_words,
            lab_slot=index.lab_slot, rounds=int(rounds))
        idx2._engines[eng.backend] = eng
        idx2._vtx_packed = vtx_w
        st.wall_s = time.perf_counter() - t0
        return idx2

    # ---- row-granular plane patch ---------------------------------------
    st.tail = "patch"
    rows = np.flatnonzero(p_mask)
    eidx_p = np.flatnonzero(p_mask[src2])
    sp, dp, lp = src2[eidx_p], g2.indices[eidx_p], g2.labels[eidx_p]
    leaf2 = g2.out_degree() == 0
    (d_vtx2, d_lab2, h_vtx2, h_lab2, v_vtx2, v_lab2, n_out2,
     n_in2) = _patch_tail(
        index, cfg, base_v2, base_l2, r_vtx2, r_lab2, r_in2, vtx_w,
        bitset.np_to_words(_null_words(cfg), dev),
        torch.from_numpy(leaf2).to(dev), _long(rows, dev),
        torch.from_numpy(leaf2[rows]).to(dev),
        torch.from_numpy(g_count[rows]).to(dev),
        _long(np.searchsorted(rows, sp), dev), _long(dp, dev),
        bitset.np_to_words(_edge_label_words(cfg, index.lab_slot, lp), dev),
        _long(way[eidx_p], dev), chunk_words=cw)
    idx2 = TDRIndex(
        cfg=cfg, graph=g2, h_vtx=h_vtx2, h_lab=h_lab2, v_vtx=v_vtx2,
        v_lab=v_lab2, n_out=n_out2, n_in=n_in2,
        push=torch.from_numpy(push).to(dev),
        pop=torch.from_numpy(pop).to(dev),
        g_count=torch.from_numpy(g_count).to(dev),
        vtx_words=index.vtx_words, lab_slot=index.lab_slot,
        fixpoint_rounds=int(rounds), disc=index.disc,
        base_v=base_v2, base_l=base_l2, base_r=base_r2,
        r_vtx=r_vtx2, r_lab=r_lab2, r_in=r_in2,
        d_vtx=d_vtx2, d_lab=d_lab2)
    idx2._engines[eng.backend] = eng
    idx2._vtx_packed = vtx_w
    if index._comp:
        chg_fwd = np.flatnonzero(changed)
        chg_rev = np.flatnonzero(
            (r_in2 != index.r_in).any(dim=1).cpu().numpy())
        idx2._comp = _carry_compressed(
            index._comp, idx2,
            {"h_vtx": rows, "h_lab": rows, "v_vtx": rows, "v_lab": rows,
             "n_out": rows, "n_in": chg_rev, "r_vtx": chg_fwd,
             "r_lab": chg_fwd, "r_in": chg_rev})
    st.wall_s = time.perf_counter() - t0
    return idx2
