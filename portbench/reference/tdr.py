"""The TDR index planes of paper Alg. 1, worked out in plain NumPy.

The host pieces (DFS intervals and discovery order, Bloom hash positions,
label slots, way assignment) are frozen copies of the published design;
the closures, the k-level vertical propagation and the per-way
projections are written here over uint32 words, with no device and no
code of the program.  ``build_planes`` returns every plane the benchmark
compares, plus the closure's fixpoint round count.
"""
from __future__ import annotations

import numpy as np

from .graphs import EdgeGraph

PLANES = ("h_vtx", "h_lab", "v_vtx", "v_lab", "n_out", "n_in", "r_vtx",
          "r_lab", "r_in", "push", "pop", "g_count")
DEFAULTS = dict(vtx_bits=256, lab_slots=63, g_max=4, succ_per_way=4, k=3,
                n_hashes=2, hash_scheme="dfs-block", max_fixpoint_iters=0)
WORD = 32


def n_words(bits: int) -> int:
    return -(-bits // WORD)


def set_bits(words: np.ndarray, rows: np.ndarray, pos: np.ndarray) -> None:
    pos = pos.astype(np.int64)
    np.bitwise_or.at(words, (rows, pos >> 5),
                     (np.int64(1) << (pos & 31)).astype(np.uint32))


# ------------------------------------------------------------ host pieces
def dfs_intervals(g: EdgeGraph):
    """Iterative DFS forest, roots with no predecessors first: push/pop
    counters and discovery order."""
    v_n = g.n_vertices
    indptr, indices = g.indptr, g.indices
    push = np.full(v_n, -1, dtype=np.int64)
    pop = np.full(v_n, -1, dtype=np.int64)
    disc = np.full(v_n, -1, dtype=np.int64)
    t = d = 0
    in_deg = np.bincount(indices, minlength=v_n)
    order = np.concatenate([np.flatnonzero(in_deg == 0),
                            np.flatnonzero(in_deg != 0)])
    for root in order:
        if push[root] >= 0:
            continue
        stack = [(int(root), int(indptr[root]))]
        push[root] = t
        t += 1
        disc[root] = d
        d += 1
        while stack:
            u, i = stack[-1]
            if i < indptr[u + 1]:
                stack[-1] = (u, i + 1)
                w = int(indices[i])
                if push[w] < 0:
                    push[w] = t
                    t += 1
                    disc[w] = d
                    d += 1
                    stack.append((w, int(indptr[w])))
            else:
                stack.pop()
                pop[u] = t
                t += 1
    return push, pop, disc


def _hash_keys(n: int) -> list:
    ks = [0x9E3779B97F4A7C15, 0xC2B2AE3D27D4EB4F, 0x165667B19E3779F9]
    mask = (1 << 64) - 1
    x = ks[-1]
    while len(ks) < n:
        x = (x + 0x9E3779B97F4A7C15) & mask
        z = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & mask
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & mask
        ks.append((z ^ (z >> 31)) | 1)
    return [np.uint64(k) for k in ks[:n]]


def vertex_words(cfg: dict, disc: np.ndarray) -> np.ndarray:
    """Packed Bloom row of every vertex, uint32 [V, Wv]."""
    v_n, bits = disc.shape[0], cfg["vtx_bits"]
    ids = np.arange(v_n, dtype=np.uint64)
    if cfg["hash_scheme"] == "dfs-block":
        h0 = (disc.astype(np.uint64) * np.uint64(bits)) // np.uint64(
            max(v_n, 1))
    else:
        h0 = ((ids + 1) * np.uint64(2654435761)) % np.uint64(bits)
    positions = [h0.astype(np.int64) % bits]
    ks = _hash_keys(max(cfg["n_hashes"] - 1, 0))
    for i in range(1, cfg["n_hashes"]):
        h = (((ids + 1) * ks[i - 1]) >> np.uint64(17)) % np.uint64(bits)
        positions.append(h.astype(np.int64))
    words = np.zeros((v_n, n_words(bits)), dtype=np.uint32)
    for pos in positions:
        set_bits(words, np.arange(v_n), pos)
    return words


def label_slots(cfg: dict, n_labels: int) -> np.ndarray:
    ids = np.arange(n_labels, dtype=np.uint64)
    if n_labels <= cfg["lab_slots"]:
        return ids.astype(np.int64)
    return (((ids + 1) * np.uint64(0x9E3779B97F4A7C15)) >> np.uint64(13)
            ).astype(np.int64).astype(np.int32).astype(np.int64) % \
        cfg["lab_slots"]


def way_assignment(cfg: dict, g: EdgeGraph, disc: np.ndarray):
    """``g(u) = min(next_pow2(ceil(deg / succ_per_way)), g_max)`` ways per
    vertex; an edge's way is its target's discovery order mod g(u)."""
    deg = np.diff(g.indptr)
    gc = np.zeros_like(deg)
    nz = deg > 0
    tgt = np.maximum(1, -(-deg[nz] // cfg["succ_per_way"]))
    gc[nz] = np.minimum(2 ** np.ceil(np.log2(tgt)).astype(np.int64),
                        cfg["g_max"])
    way = disc[g.indices] % np.maximum(gc[g.src], 1)
    return gc, way


# ------------------------------------------------------------ word algebra
def segment_or(values: np.ndarray, seg: np.ndarray, n: int) -> np.ndarray:
    """``out[s] = OR of values[i] with seg[i] == s`` (zero where none)."""
    out = np.zeros((n,) + values.shape[1:], dtype=np.uint32)
    if seg.shape[0] == 0:
        return out
    order = np.argsort(seg, kind="stable")
    s = seg[order]
    starts = np.flatnonzero(np.r_[True, s[1:] != s[:-1]])
    out[s[starts]] = np.bitwise_or.reduceat(values[order], starts, axis=0)
    return out


class Edges:
    """One direction of propagation: ``out[a] = OR over edges (a, b) of
    x[b]`` (forward), or over edges (b, a) (reverse)."""

    def __init__(self, g: EdgeGraph, reverse: bool):
        gather, scatter = (g.src, g.indices) if reverse else (g.indices,
                                                              g.src)
        order = np.argsort(scatter, kind="stable")
        self.gather = gather[order]
        s = scatter[order]
        self.starts = np.flatnonzero(np.r_[True, s[1:] != s[:-1]]) \
            if s.shape[0] else np.zeros(0, np.int64)
        self.rows = s[self.starts]
        self.n = g.n_vertices

    def propagate(self, x: np.ndarray) -> np.ndarray:
        out = np.zeros((self.n,) + x.shape[1:], dtype=np.uint32)
        if self.starts.shape[0]:
            out[self.rows] = np.bitwise_or.reduceat(x[self.gather],
                                                    self.starts, axis=0)
        return out

    def closure(self, base: np.ndarray, max_rounds: int,
                cut: int | None = None) -> tuple[np.ndarray, int]:
        """Least fixpoint of ``R = base | propagate(R)`` and its rounds
        (the round that changes nothing counts); ``cut`` stops early."""
        r, rounds, changed = base, 0, True
        limit = max_rounds if cut is None else min(max_rounds, cut)
        while changed and rounds < limit:
            nxt = r | self.propagate(r)
            changed = bool((nxt != r).any())
            r = nxt
            rounds += 1
        return r, rounds


# ------------------------------------------------------------ the planes
def build_planes(g: EdgeGraph, tdr_config: dict,
                 rounds_cut: int | None = None) -> dict:
    """Every plane of ``PLANES`` (packed planes as uint32 words) and
    ``fixpoint_rounds``; ``rounds_cut`` cuts every closure short."""
    cfg = {**DEFAULTS, **tdr_config}
    v_n, k, gmax = g.n_vertices, cfg["k"], cfg["g_max"]
    lab_bits = cfg["lab_slots"] + 1
    push, pop, disc = dfs_intervals(g)
    vtx_w = vertex_words(cfg, disc)
    lab_w = np.zeros((g.n_edges, n_words(lab_bits)), dtype=np.uint32)
    set_bits(lab_w, np.arange(g.n_edges),
             label_slots(cfg, g.n_labels)[g.labels])
    null_w = np.zeros(n_words(lab_bits), dtype=np.uint32)
    null_w[cfg["lab_slots"] >> 5] = np.uint32(1) << np.uint32(
        cfg["lab_slots"] & 31)
    g_count, way = way_assignment(cfg, g, disc)
    fwd, rev = Edges(g, False), Edges(g, True)
    max_rounds = cfg["max_fixpoint_iters"] or v_n
    src, dst = g.src, g.indices

    base_v = fwd.propagate(vtx_w)
    r_vtx, rounds = fwd.closure(base_v, max_rounds, rounds_cut)
    base_l = segment_or(lab_w, src, v_n)
    r_lab, _ = fwd.closure(base_l, max_rounds, rounds_cut)
    r_in, _ = rev.closure(rev.propagate(vtx_w), max_rounds, rounds_cut)

    leaf = (np.diff(g.indptr) == 0)[:, None]
    cur_lab = np.where(leaf, null_w[None, :], base_l)
    cur_vtx = base_v
    d_lab, d_vtx = [cur_lab], [cur_vtx]
    for _ in range(1, k):
        cur_lab = np.where(leaf, null_w[None, :], fwd.propagate(cur_lab))
        cur_vtx = np.where(leaf, np.uint32(0), fwd.propagate(cur_vtx))
        d_lab.append(cur_lab)
        d_vtx.append(cur_vtx)

    seg, n_seg = src * gmax + way, v_n * gmax
    h_vtx = segment_or(vtx_w[dst] | r_vtx[dst], seg, n_seg)
    h_lab = segment_or(lab_w | r_lab[dst], seg, n_seg)
    v_lab = [segment_or(lab_w, seg, n_seg)]
    v_vtx = [segment_or(vtx_w[dst], seg, n_seg)]
    for lv in range(1, k):
        v_lab.append(segment_or(d_lab[lv - 1][dst], seg, n_seg))
        v_vtx.append(segment_or(d_vtx[lv - 1][dst], seg, n_seg))
    wv, wl = vtx_w.shape[1], lab_w.shape[1]
    h_vtx = h_vtx.reshape(v_n, gmax, wv)
    used = np.arange(gmax)[None, :] < g_count[:, None]
    h_vtx = h_vtx | np.where(used[:, :, None], vtx_w[:, None, :],
                             np.uint32(0))
    return {
        "h_vtx": h_vtx, "h_lab": h_lab.reshape(v_n, gmax, wl),
        "v_vtx": np.stack(v_vtx, axis=1).reshape(v_n, gmax, k, wv),
        "v_lab": np.stack(v_lab, axis=1).reshape(v_n, gmax, k, wl),
        "n_out": np.bitwise_or.reduce(h_vtx, axis=1) | vtx_w,
        "n_in": r_in | vtx_w,
        "r_vtx": r_vtx, "r_lab": r_lab, "r_in": r_in,
        "push": push, "pop": pop, "g_count": g_count,
        "fixpoint_rounds": rounds}


def equal(got: np.ndarray, want: np.ndarray) -> bool:
    """Same shape and bits (packed int32 planes read as uint32)."""
    got = np.asarray(got)
    if got.dtype == np.int32 and want.dtype == np.uint32:
        got = got.view(np.uint32)
    return got.shape == want.shape and bool(
        (got.astype(np.int64) == want.astype(np.int64)).all())
