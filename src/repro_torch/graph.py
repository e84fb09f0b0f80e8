"""Edge-labeled digraphs (paper Def. 1) + the generators used in §VI.

Host-side numpy, kept byte-for-byte in step with the JAX package's
``graph`` module so that the same seed gives the same graph.  A multigraph
edge with several labels is stored as several parallel edges, exactly as
the paper prescribes.  Host representation is CSR (sorted by source) with
a parallel label array; reverse CSR is derived lazily.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable

import numpy as np


@dataclasses.dataclass(frozen=True)
class Graph:
    """CSR edge-labeled digraph."""
    n_vertices: int
    n_labels: int
    indptr: np.ndarray    # int32 [V+1]
    indices: np.ndarray   # int32 [E]   destination of each edge
    labels: np.ndarray    # int32 [E]   label of each edge

    @property
    def n_edges(self) -> int:
        """Edge count |E| (parallel-labeled edges counted separately)."""
        return int(self.indices.shape[0])

    @property
    def src(self) -> np.ndarray:
        """Edge source array [E] (expanded from indptr)."""
        return np.repeat(np.arange(self.n_vertices, dtype=np.int32),
                         np.diff(self.indptr))

    def out_degree(self) -> np.ndarray:
        """Per-vertex out-degree int32 [V]."""
        return np.diff(self.indptr).astype(np.int32)

    def successors(self, u: int) -> np.ndarray:
        """Destination ids of u's out-edges (int32 view into the CSR)."""
        return self.indices[self.indptr[u]:self.indptr[u + 1]]

    def out_edges(self, u: int) -> tuple[np.ndarray, np.ndarray]:
        """(destinations, labels) of u's out-edges (int32 CSR views)."""
        s, e = self.indptr[u], self.indptr[u + 1]
        return self.indices[s:e], self.labels[s:e]

    def reverse(self) -> "Graph":
        """Edge-reversed CSR (sorted by destination)."""
        src = self.src
        order = np.argsort(self.indices, kind="stable")
        rsrc = self.indices[order]
        rdst = src[order]
        rlab = self.labels[order]
        rptr = np.zeros(self.n_vertices + 1, dtype=np.int64)
        np.add.at(rptr, rsrc + 1, 1)
        rptr = np.cumsum(rptr)
        return Graph(self.n_vertices, self.n_labels,
                     rptr.astype(np.int32), rdst.astype(np.int32),
                     rlab.astype(np.int32))

    @staticmethod
    def from_edges(n_vertices: int, n_labels: int,
                   edges: Iterable[tuple[int, int, int]]) -> "Graph":
        """Build from an iterable of ``(src, dst, label)`` triples.

        Duplicates collapse (the graph is an edge *set*); parallel edges
        with different labels are distinct edges, as the paper prescribes.
        """
        arr = np.asarray(sorted(set(edges)), dtype=np.int64)
        if arr.size == 0:
            arr = np.zeros((0, 3), dtype=np.int64)
        src, dst, lab = arr[:, 0], arr[:, 1], arr[:, 2]
        order = np.lexsort((dst, src))
        return Graph._from_sorted(n_vertices, n_labels, src[order],
                                  dst[order], lab[order])

    @staticmethod
    def _from_sorted(n_vertices: int, n_labels: int, src: np.ndarray,
                     dst: np.ndarray, lab: np.ndarray) -> "Graph":
        """CSR assembly from already (src, dst, lab)-sorted, deduped
        int64 edge arrays (the fast path ``apply_updates`` uses)."""
        indptr = np.zeros(n_vertices + 1, dtype=np.int64)
        np.add.at(indptr, src + 1, 1)
        indptr = np.cumsum(indptr)
        return Graph(n_vertices, n_labels, indptr.astype(np.int32),
                     dst.astype(np.int32), lab.astype(np.int32))

    # ------------------------------------------------------------- updates
    def _edge_keys(self, arr: np.ndarray) -> np.ndarray:
        """Encode ``[N, 3]`` (src, dst, lab) rows as sortable int64 keys
        ordered exactly like the CSR edge order (src-major, then dst,
        then label)."""
        v = np.int64(max(self.n_vertices, 1))
        l = np.int64(max(self.n_labels, 1))
        return (arr[:, 0] * v + arr[:, 1]) * l + arr[:, 2]

    def _decode_keys(self, keys: np.ndarray) -> tuple[np.ndarray,
                                                      np.ndarray,
                                                      np.ndarray]:
        v = np.int64(max(self.n_vertices, 1))
        l = np.int64(max(self.n_labels, 1))
        lab = keys % l
        uv = keys // l
        return uv // v, uv % v, lab

    def apply_updates(self, edges_added: Iterable = (),
                      edges_removed: Iterable = ()) -> "GraphDelta":
        """Apply a batch of edge insertions/deletions; returns a
        ``GraphDelta`` holding the post-update graph plus the *effective*
        delta (int64 ``[N, 3]`` (src, dst, label) rows).

        Set semantics: removals are applied first, then additions —
        adding an existing edge or removing a missing one is a no-op, and
        an edge both removed and added survives.  ``delta.added`` /
        ``delta.removed`` record only real changes (``new - old`` /
        ``old - new``), so ``tdr_build.update_index`` never
        over-invalidates on no-ops.  Vertex and label universes are
        fixed: endpoints must lie in ``[0, n_vertices)`` and labels in
        ``[0, n_labels)``.
        """
        def as_rows(edges):
            rows = np.asarray(list(edges), dtype=np.int64)
            rows = rows.reshape(-1, 3) if rows.size else np.zeros(
                (0, 3), dtype=np.int64)
            if rows.size and (
                    rows[:, :2].min(initial=0) < 0
                    or rows[:, :2].max(initial=0) >= self.n_vertices
                    or rows[:, 2].min(initial=0) < 0
                    or rows[:, 2].max(initial=0) >= self.n_labels):
                raise ValueError(
                    f"edge update outside the graph's universe "
                    f"(|V|={self.n_vertices}, |L|={self.n_labels})")
            return rows

        add = as_rows(edges_added)
        rem = as_rows(edges_removed)
        old_k = self._edge_keys(
            np.stack([self.src.astype(np.int64),
                      self.indices.astype(np.int64),
                      self.labels.astype(np.int64)], axis=1)
            if self.n_edges else np.zeros((0, 3), np.int64))
        new_k = np.union1d(np.setdiff1d(old_k, self._edge_keys(rem)),
                           self._edge_keys(add))
        added_eff = np.setdiff1d(new_k, old_k)
        removed_eff = np.setdiff1d(old_k, new_k)
        src, dst, lab = self._decode_keys(new_k)   # union1d is sorted
        g2 = Graph._from_sorted(self.n_vertices, self.n_labels, src, dst,
                                lab)
        return GraphDelta(
            graph=g2,
            added=np.stack(self._decode_keys(added_eff), axis=1),
            removed=np.stack(self._decode_keys(removed_eff), axis=1))


@dataclasses.dataclass(frozen=True)
class GraphDelta:
    """Effective result of one ``Graph.apply_updates`` call.

    ``graph`` is the post-update graph; ``added``/``removed`` are int64
    ``[N, 3]`` (src, dst, label) rows of the edges that actually changed
    (no-op adds/removes are filtered out).  This is the unit
    ``tdr_build.update_index`` consumes.
    """
    graph: Graph
    added: np.ndarray     # int64 [Na, 3]
    removed: np.ndarray   # int64 [Nr, 3]

    @property
    def n_changes(self) -> int:
        return int(self.added.shape[0] + self.removed.shape[0])


# ------------------------------------------------- subgraph/layout helpers
def csr_row_edges(indptr: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """Edge-index array (int64) of all CSR slots belonging to ``rows`` —
    the vectorized form of ``concat(arange(indptr[r], indptr[r+1]) for r
    in rows)``."""
    starts = indptr[rows].astype(np.int64)
    counts = (indptr[rows + 1] - indptr[rows]).astype(np.int64)
    tot = int(counts.sum())
    return np.repeat(starts, counts) + (
        np.arange(tot) - np.repeat(np.cumsum(counts) - counts, counts))


def pad_pow2(n: int, lo: int = 1) -> int:
    """Smallest power of two >= max(n, lo) (stable-shape bucketing)."""
    p = lo
    while p < n:
        p *= 2
    return p


def pad_bucket(n: int, lo: int = 1) -> int:
    """Smallest value >= max(n, lo) on the {2^k, 3·2^(k-1)} grid
    (powers of two plus midpoints: 32, 48, 64, 96, 128, ...)."""
    p = lo
    while p < n:
        q = p + p // 2
        if q >= n and q > p:
            return q
        p *= 2
    return p


def induced_edges(graph: Graph, active: np.ndarray, src: np.ndarray | None
                  = None) -> tuple[np.ndarray, np.ndarray, np.ndarray,
                                   np.ndarray, np.ndarray]:
    """Renumbered edge list of the subgraph induced by ``active`` (bool [V]).

    Returns ``(sub_ids, renum, sub_src, sub_dst, sub_lab)``: the active
    vertex ids, the V-sized old->new map (-1 outside), and the edges whose
    endpoints both lie in the active set, renumbered."""
    sub_ids = np.flatnonzero(active).astype(np.int32)
    renum = np.full(graph.n_vertices, -1, dtype=np.int32)
    renum[sub_ids] = np.arange(sub_ids.shape[0], dtype=np.int32)
    s = graph.src if src is None else src
    keep = active[s] & active[graph.indices]
    return (sub_ids, renum, renum[s[keep]], renum[graph.indices[keep]],
            graph.labels[keep])


def padded_incidence(keys: np.ndarray, n_segments: int, sentinel: int,
                     lo: int = 8) -> np.ndarray:
    """Group edge indices by ``keys`` into a padded ``[n_segments, D]``
    gather matrix (empty slots hold ``sentinel``, which callers point at an
    appended zero row)."""
    e_n = int(keys.shape[0])
    counts = np.bincount(keys, minlength=n_segments) if e_n else np.zeros(
        n_segments, dtype=np.int64)
    d = int(counts.max()) if e_n else 0
    ids = np.full((n_segments, pad_bucket(max(d, 1), lo)), sentinel,
                  dtype=np.int32)
    if e_n:
        order = np.argsort(keys, kind="stable").astype(np.int32)
        sk = keys[order]
        pos = np.arange(e_n) - np.repeat(np.cumsum(counts) - counts, counts)
        ids[sk, pos] = order
    return ids


def incidence_plan(keys: np.ndarray, n_segments: int, sentinel: int,
                   cap: int = 16, lo: int = 8) -> tuple:
    """One- or two-level padded incidence, chosen by degree skew: ``(ids,)``
    for low skew, else ``(ids1 [n_virt, cap], ids2 [n_segments, D2])``
    splitting heavy groups into virtual rows of at most ``cap`` edges."""
    e_n = int(keys.shape[0])
    counts = np.bincount(keys, minlength=n_segments) if e_n else np.zeros(
        n_segments, dtype=np.int64)
    d = int(counts.max()) if e_n else 0
    if pad_bucket(max(d, 1), lo) <= 2 * cap:
        return (padded_incidence(keys, n_segments, sentinel, lo),)
    ngrp = np.maximum(1, -(-counts // cap))
    n_virt = int(ngrp.sum())
    base = np.cumsum(ngrp) - ngrp
    ids1 = np.full((pad_bucket(n_virt + 1, lo), cap), sentinel,
                   dtype=np.int32)
    order = np.argsort(keys, kind="stable").astype(np.int32)
    sk = keys[order]
    pos = np.arange(e_n) - np.repeat(np.cumsum(counts) - counts, counts)
    ids1[base[sk] + pos // cap, pos % cap] = order
    d2 = pad_bucket(int(ngrp.max()), 2)
    ids2 = np.full((n_segments, d2), n_virt, dtype=np.int32)
    grp = np.repeat(np.arange(n_segments), ngrp)
    gpos = np.arange(n_virt) - np.repeat(base, ngrp)
    ids2[grp, gpos] = np.arange(n_virt, dtype=np.int32)
    return (ids1, ids2)


# -------------------------------------------------------------- generators
def erdos_renyi(n_vertices: int, avg_degree: float, n_labels: int,
                seed: int = 0) -> Graph:
    """ER digraph (§VI-A): ~uniform out-degree, labels uniform on edges."""
    rng = np.random.default_rng(seed)
    n_edges = int(n_vertices * avg_degree)
    src = rng.integers(0, n_vertices, size=n_edges)
    dst = rng.integers(0, n_vertices, size=n_edges)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    lab = rng.integers(0, n_labels, size=src.shape[0])
    return Graph.from_edges(n_vertices, n_labels,
                            zip(src.tolist(), dst.tolist(), lab.tolist()))


def preferential_attachment(n_vertices: int, avg_degree: float,
                            n_labels: int, seed: int = 0) -> Graph:
    """PA digraph (§VI-A): skewed out-degree (Barabási–Albert flavoured).

    Each new vertex attaches ``m = avg_degree/2`` out-edges to targets drawn
    proportionally to in-degree+1, plus receives edges from random earlier
    vertices.
    """
    rng = np.random.default_rng(seed)
    m = max(1, int(round(avg_degree / 2)))
    edges: list[tuple[int, int, int]] = []
    weight = np.ones(n_vertices, dtype=np.float64)
    for v in range(1, n_vertices):
        w = weight[:v] / weight[:v].sum()
        k = min(m, v)
        targets = rng.choice(v, size=k, replace=False, p=w)
        for t in targets:
            edges.append((v, int(t), int(rng.integers(0, n_labels))))
            weight[t] += 1.0
        sources = rng.integers(0, v, size=m)
        for s in sources:
            edges.append((int(s), v, int(rng.integers(0, n_labels))))
            weight[v] += 1.0
    return Graph.from_edges(n_vertices, n_labels, edges)


def fig2_example() -> Graph:
    """A 10-vertex, 5-label digraph consistent with the paper's Fig. 2 /
    Examples 1–3 (labels a..e = 0..4)."""
    a, b, c, d, e = range(5)
    edges = [
        (0, 1, a), (0, 2, a), (0, 2, b), (0, 8, e),
        (1, 3, d),
        (2, 5, c),
        (3, 5, b),
        (4, 6, b),
        (5, 9, c),
        (7, 2, a), (7, 8, a), (7, 9, b), (7, 9, e),
        (8, 4, b),
    ]
    return Graph.from_edges(10, 5, edges)


def random_graph(kind: str, n_vertices: int, avg_degree: float,
                 n_labels: int, seed: int = 0) -> Graph:
    """Synthetic-graph dispatcher: ``kind`` is "er" (Erdős–Rényi) or
    "pa" (preferential attachment), matching the paper's §VI-A sweep."""
    if kind == "er":
        return erdos_renyi(n_vertices, avg_degree, n_labels, seed)
    if kind == "pa":
        return preferential_attachment(n_vertices, avg_degree, n_labels, seed)
    raise ValueError(f"unknown graph kind {kind!r}")
