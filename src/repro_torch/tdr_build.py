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

import numpy as np
import torch

from . import bitset
from . import compressed as compressed_mod
from . import engine as engine_mod
from .graph import Graph


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
    # plane name -> compressed_mod.CompressedPlanes (summary_flags)
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

    def summary_flags(self) -> dict:
        """Host row-summary flags, level 1 of the two-level compressed
        ``n_out``/``n_in`` planes (built once, cached on the index):
        ``sat_out[u]`` / ``sat_in[v]`` mark vertices whose global Bloom row
        is ALL_ONE — their membership filter passes for every counterpart
        and their query corridor is the whole vertex set."""
        for name in ("n_out", "n_in"):
            if name not in self._comp:
                self._comp[name] = compressed_mod.compress(
                    bitset.words_to_np(getattr(self, name)),
                    nbits=self.cfg.vtx_bits)
        one = compressed_mod.ALL_ONE
        return {"sat_out": self._comp["n_out"].row_states == one,
                "sat_in": self._comp["n_in"].row_states == one}

    def summary_flags_dev(self) -> tuple:
        """Device (sat_out, sat_in) bool [V] for the filter cascade."""
        if self._sat_dev is None:
            flags = self.summary_flags()
            self._sat_dev = (torch.from_numpy(flags["sat_out"]).to(
                self.device), torch.from_numpy(flags["sat_in"]).to(
                self.device))
        return self._sat_dev


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
                device="cuda") -> TDRIndex:
    """Construct the full TDR index for every vertex of ``graph``.

    ``device`` defaults to the card and raises when there is none; pass
    ``device="cpu"`` to build on the CPU.  ``backend`` (or
    ``engine_config``) selects ``segment`` / ``matmul`` / ``auto``.
    ``layout`` pins the discovery-order hash layout (int32 ``[V]``,
    normally ``TDRIndex.disc`` of an earlier build over the same vertex
    set) instead of deriving it from this graph's DFS forest; push/pop
    intervals are always recomputed from ``graph``.
    """
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
