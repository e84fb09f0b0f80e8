"""Pattern-constrained reachability by plain search, in NumPy.

A query ``(u, v, family, labels)`` asks for a u→v path whose *set* of edge
labels satisfies a boolean pattern.  ``terms`` writes each family the
benchmark sends as a disjunction of ``(require, forbid)`` terms; a path
satisfies a term when its label set holds every required label and no
forbidden one.  Each term is searched over the states ``(vertex, subset
of the required labels seen so far)``, with the forbidden labels' edges
removed.  ``u == v`` is answered by the empty path when a term requires
nothing (its label set is empty).

Answers: ``reach`` (bool), ``distance`` (fewest hops, -1 when none, and
-1 past an optional bound), ``count_walks`` (walks of at most ``hops``
edges, each labelled edge counted, every sum saturating at ``cap``) and
``check_witness`` (a served path replays on the graph, satisfies the
pattern and is as short as ``distance``).
"""
from __future__ import annotations

import numpy as np

from .graphs import EdgeGraph


def terms(family: str, labels, n_labels: int) -> list[tuple[frozenset,
                                                           frozenset]]:
    """The ``(require, forbid)`` terms of one pattern family."""
    labs = [int(x) for x in labels]
    if family == "all_of":
        return [(frozenset(labs), frozenset())]
    if family == "any_of":
        return [(frozenset([x]), frozenset()) for x in labs]
    if family == "none_of":
        return [(frozenset(), frozenset(labs))]
    if family == "or_not":          # (a | b) & !c
        a, b, c = labs
        return [(frozenset([a]), frozenset([c])),
                (frozenset([b]), frozenset([c]))]
    if family == "or_all":          # (a & b) | (c & d)
        a, b, c, d = labs
        return [(frozenset([a, b]), frozenset()),
                (frozenset([c, d]), frozenset())]
    if family == "lcr":             # only the listed labels
        return [(frozenset(), frozenset(range(n_labels)) - set(labs))]
    raise ValueError(f"unknown pattern family {family!r}")


def _edge_ranges(indptr: np.ndarray, rows: np.ndarray) -> tuple:
    """Edge ids of every row in ``rows`` and the position of its row."""
    starts = indptr[rows]
    counts = indptr[rows + 1] - starts
    total = int(counts.sum())
    owner = np.repeat(np.arange(rows.shape[0]), counts)
    offs = np.arange(total) - np.repeat(np.cumsum(counts) - counts, counts)
    return starts[owner] + offs, owner


class _Term:
    """Per-edge operands of one term: allowed edges and the subset bit each
    edge sets."""

    def __init__(self, g: EdgeGraph, require: frozenset, forbid: frozenset):
        req = sorted(require)
        self.n_sub = 1 << len(req)
        self.full = self.n_sub - 1
        bit = np.zeros(max(g.n_labels, 1), dtype=np.int64)
        for i, lab in enumerate(req):
            bit[lab] = 1 << i
        allow = np.ones(max(g.n_labels, 1), dtype=bool)
        allow[[x for x in forbid if x < g.n_labels]] = False
        self.edge_bit = bit[g.labels]
        self.edge_ok = allow[g.labels]


def _term_search(g: EdgeGraph, t: _Term, u: int, v: int,
                 bound: int | None, path: bool = False):
    """Fewest hops from ``(u, 0)`` to ``(v, full)`` (-1 when none within
    ``bound``) and, with ``path``, the edges of one shortest path."""
    s = t.n_sub
    if u == v and t.full == 0:
        return 0, []
    goal = v * s + t.full
    seen = np.zeros(g.n_vertices * s, dtype=bool)
    seen[u * s] = True
    if path:        # per state: the state it was reached from, and the edge
        from_state = np.full(g.n_vertices * s, -1, dtype=np.int64)
        from_edge = np.full(g.n_vertices * s, -1, dtype=np.int64)
    frontier = np.array([u * s], dtype=np.int64)
    depth = 0
    while frontier.size and (bound is None or depth < bound):
        depth += 1
        edges, owner = _edge_ranges(g.indptr, frontier // s)
        keep = t.edge_ok[edges]
        edges, prev = edges[keep], frontier[owner[keep]]
        nxt = g.indices[edges] * s + ((prev % s) | t.edge_bit[edges])
        hit = np.flatnonzero(nxt == goal)
        if hit.size:
            if not path:
                return depth, None
            out, state = [int(edges[hit[0]])], int(prev[hit[0]])
            while state != u * s:
                out.append(int(from_edge[state]))
                state = int(from_state[state])
            src = g.src
            return depth, [(int(src[e]), int(g.indices[e]), int(g.labels[e]))
                           for e in out[::-1]]
        fresh = ~seen[nxt]
        nxt, first = np.unique(nxt[fresh], return_index=True)
        seen[nxt] = True
        if path:
            from_state[nxt] = prev[fresh][first]
            from_edge[nxt] = edges[fresh][first]
        frontier = nxt
    return -1, None


def shortest_path(g: EdgeGraph, u: int, v: int, family: str, labels,
                  bound: int | None = None):
    """One shortest pattern-constrained path as ``(x, y, label)`` edges,
    ``[]`` for the empty path, ``None`` when none (within ``bound``)."""
    best = None
    for req, forb in terms(family, labels, g.n_labels):
        d, p = _term_search(g, _Term(g, req, forb), u, v, bound, path=True)
        if d >= 0 and (best is None or d < len(best)):
            best = p
    return best


def _term_distance(g: EdgeGraph, t: _Term, u: int, v: int,
                   bound: int | None) -> int:
    return _term_search(g, t, u, v, bound)[0]


def distance(g: EdgeGraph, u: int, v: int, family: str, labels,
             bound: int | None = None) -> int:
    """Shortest pattern-constrained hop distance, -1 if unreachable (or
    farther than ``bound``)."""
    best = -1
    for req, forb in terms(family, labels, g.n_labels):
        d = _term_distance(g, _Term(g, req, forb), u, v, bound)
        if d >= 0 and (best < 0 or d < best):
            best = d
    return best


def reach(g: EdgeGraph, u: int, v: int, family: str, labels) -> bool:
    """Whether some u→v path's label set satisfies the pattern."""
    return any(_term_distance(g, _Term(g, req, forb), u, v, None) >= 0
               for req, forb in terms(family, labels, g.n_labels))


def count_walks(g: EdgeGraph, u: int, v: int, family: str, labels, *,
                hops: int, cap: int) -> int:
    """Walks u→v of 1..``hops`` edges (plus the empty walk when u == v and
    nothing is required) satisfying a single-term pattern; each labelled
    edge is its own step, and every sum saturates at ``cap``."""
    ts = terms(family, labels, g.n_labels)
    if len(ts) != 1:
        raise ValueError("route counts take single-term patterns")
    t = _Term(g, *ts[0])
    s, n = t.n_sub, g.n_vertices * t.n_sub
    src = g.src[t.edge_ok]
    dst = g.indices[t.edge_ok]
    ebit = t.edge_bit[t.edge_ok]
    w = np.zeros(n, dtype=np.float64)
    w[u * s] = 1.0
    total = 1 if (u == v and t.full == 0) else 0
    for _ in range(hops):
        nw = np.zeros(n, dtype=np.float64)
        for m in range(s):
            nw += np.bincount(dst * s + (m | ebit), weights=w[src * s + m],
                              minlength=n)
        w = np.minimum(nw, cap)
        total = min(total + int(w[v * s + t.full]), cap)
    return total


def check_witness(g: EdgeGraph, keys: np.ndarray, u: int, v: int,
                  family: str, labels, path) -> bool:
    """A served witness is right when it is ``None`` exactly where no path
    exists, and otherwise chains u→v over edges of the graph (``keys``:
    ``g.edge_keys()``), satisfies the pattern and has the shortest
    length."""
    d = distance(g, u, v, family, labels)
    if path is None or d < 0:
        return path is None and d < 0
    if len(path) != d:
        return False
    cur, seen = u, set()
    nv, nl = g.n_vertices, g.n_labels
    for x, y, lab in path:
        key = (int(x) * nv + int(y)) * nl + int(lab)
        pos = int(np.searchsorted(keys, key))
        if int(x) != cur or pos >= keys.shape[0] or keys[pos] != key:
            return False
        seen.add(int(lab))
        cur = int(y)
    return cur == v and any(req <= seen and not (forb & seen)
                            for req, forb in terms(family, labels, nl))
