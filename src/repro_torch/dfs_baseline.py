"""The paper's DFS comparison baseline (§VI-A) — also the exact oracle.

Answering a PCR query exactly is a search over the *pattern product graph*:
states are ``(vertex, subset-of-required-labels-seen)`` for one DNF term,
with edges carrying a forbidden label deleted.  The DFS explores it with
memoisation and terminates exactly on cyclic graphs.  Host-only Python,
kept in step with the JAX package's oracle; ``chip_smoke.py`` holds the
port's answers against it.  ``shortest_pcr`` (BFS over the same product
graph), ``count_routes`` (the layered walk-count DP) and
``verify_witness`` are the oracles of the distance, route-count and
witness query kinds; ``answer_rpq`` (BFS over the graph times a Glushkov
NFA) is the oracle of regular path queries.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from . import pattern as pat
from . import rpq as rpq_mod
from .graph import Graph


@dataclasses.dataclass
class SearchStats:
    states_visited: int = 0
    edges_scanned: int = 0


def answer_pcr(graph: Graph, u: int, v: int, p: pat.Pattern,
               stats: SearchStats | None = None) -> bool:
    """Exact PCR answer by product-graph DFS (no index)."""
    stats = stats or SearchStats()
    for term in pat.to_dnf(p):
        if _answer_term(graph, u, v, term, stats):
            return True
    return False


def _answer_term(graph: Graph, u: int, v: int, term: pat.DnfTerm,
                 stats: SearchStats) -> bool:
    req = sorted(term.require)
    slot = {l: i for i, l in enumerate(req)}
    full = (1 << len(req)) - 1
    forbid = term.forbid

    if u == v and full == 0:
        return True  # empty path, empty label set

    # iterative DFS over (vertex, mask) states
    start = (u, 0)
    seen = {start}
    stack = [start]
    indptr, indices, labels = graph.indptr, graph.indices, graph.labels
    while stack:
        x, m = stack.pop()
        stats.states_visited += 1
        for i in range(indptr[x], indptr[x + 1]):
            stats.edges_scanned += 1
            l = int(labels[i])
            if l in forbid:
                continue
            nm = m | (1 << slot[l]) if l in slot else m
            y = int(indices[i])
            if y == v and nm == full:
                return True
            st = (y, nm)
            if st not in seen:
                seen.add(st)
                stack.append(st)
    return False


def reachable_set(graph: Graph, u: int) -> np.ndarray:
    """Plain topological closure of ``u`` (bool [V])."""
    out = np.zeros(graph.n_vertices, dtype=bool)
    stack = [u]
    while stack:
        x = stack.pop()
        for y in graph.successors(x):
            if not out[y]:
                out[y] = True
                stack.append(int(y))
    return out


def shortest_pcr(graph: Graph, u: int, v: int, p: pat.Pattern,
                 stats: SearchStats | None = None) -> int:
    """Exact shortest pattern-constrained path length (hops), or -1.

    BFS over the same product graph ``answer_pcr`` searches; the min over
    DNF terms.  The oracle for ``tdr_query.dist`` / ``witness``."""
    stats = stats or SearchStats()
    best = -1
    for term in pat.to_dnf(p):
        d = _shortest_term(graph, u, v, term, stats)
        if d >= 0 and (best < 0 or d < best):
            best = d
    return best


def _shortest_term(graph: Graph, u: int, v: int, term: pat.DnfTerm,
                   stats: SearchStats) -> int:
    req = sorted(term.require)
    slot = {l: i for i, l in enumerate(req)}
    full = (1 << len(req)) - 1
    forbid = term.forbid

    if u == v and full == 0:
        return 0  # empty path, empty label set

    indptr, indices, labels = graph.indptr, graph.indices, graph.labels
    frontier = [(u, 0)]
    seen = {(u, 0)}
    depth = 0
    while frontier:
        depth += 1
        nxt = []
        for x, m in frontier:
            stats.states_visited += 1
            for i in range(indptr[x], indptr[x + 1]):
                stats.edges_scanned += 1
                l = int(labels[i])
                if l in forbid:
                    continue
                nm = m | (1 << slot[l]) if l in slot else m
                y = int(indices[i])
                if y == v and nm == full:
                    return depth
                st = (y, nm)
                if st not in seen:
                    seen.add(st)
                    nxt.append(st)
        frontier = nxt
    return -1


def count_routes(graph: Graph, u: int, v: int, p: pat.Pattern, *,
                 hops: int, cap: int,
                 stats: SearchStats | None = None) -> int:
    """Reference bounded route count with saturating add.

    Number of walks u→v of length <= ``hops`` satisfying the (single-term)
    pattern, every partial sum clamped at ``cap`` — the exact semantics of
    ``tdr_query.count_routes`` (per-round clamping equals clamping the
    total: saturating add of non-negative values is associative).  Walks,
    not simple paths: a cycle re-entering a vertex counts each traversal,
    matching the product-graph DP.  Multi-term patterns are rejected —
    terms overlap, so a per-term sum would double-count.
    """
    stats = stats or SearchStats()
    terms = pat.to_dnf(p)
    if len(terms) != 1:
        raise ValueError(
            f"count_routes needs a single-DNF-term pattern, got "
            f"{len(terms)} terms")
    term = terms[0]
    req = sorted(term.require)
    slot = {l: i for i, l in enumerate(req)}
    full = (1 << len(req)) - 1
    forbid = term.forbid
    indptr, indices, labels = graph.indptr, graph.indices, graph.labels

    # walk-count DP over (vertex, mask), one layer per hop, clamped
    w = {(u, 0): 1}
    total = 1 if (u == v and full == 0) else 0
    for _ in range(hops):
        nw: dict = {}
        for (x, m), c in w.items():
            stats.states_visited += 1
            for i in range(indptr[x], indptr[x + 1]):
                stats.edges_scanned += 1
                l = int(labels[i])
                if l in forbid:
                    continue
                nm = m | (1 << slot[l]) if l in slot else m
                st = (int(indices[i]), nm)
                nw[st] = min(nw.get(st, 0) + c, cap)
        w = nw
        if not w:
            break
        total = min(total + w.get((v, full), 0), cap)
    return total


def verify_witness(graph: Graph, u: int, v: int, p: pat.Pattern,
                   path) -> bool:
    """Check a witness path: edges exist in the graph, endpoints chain
    u→v, and the label sequence satisfies some DNF term of ``p``."""
    if path is None:
        return False
    cur = u
    seen_labels: set[int] = set()
    for (x, y, l) in path:
        if x != cur:
            return False
        lo, hi = graph.indptr[x], graph.indptr[x + 1]
        hit = any(int(graph.indices[i]) == y and int(graph.labels[i]) == l
                  for i in range(lo, hi))
        if not hit:
            return False
        seen_labels.add(int(l))
        cur = y
    if cur != v:
        return False
    return any(t.satisfied_by(seen_labels) for t in pat.to_dnf(p))


def answer_rpq(graph: Graph, u: int, v: int, r,
               stats: SearchStats | None = None) -> bool:
    """Exact RPQ answer: BFS over the product of the graph with the
    Glushkov NFA of ``r`` (states ``(vertex, nfa_state)``), the oracle
    every RPQ executor is tested against.  A u→v path answers True iff
    its label *sequence* is a word of ``L(r)``; ``u == v`` answers True
    iff ε ∈ L(r) (``rpq.nullable``)."""
    stats = stats or SearchStats()
    nfa = rpq_mod.compile_nfa(r, graph.n_labels)
    if u == v and nfa.nullable:
        return True  # empty path, empty word
    tab = nfa.tab
    indptr, indices, labels = graph.indptr, graph.indices, graph.labels
    # Glushkov has no ε-transitions: the seed is the start state alone
    start = (int(u), 0)
    seen = {start}
    stack = [start]
    while stack:
        x, q = stack.pop()
        stats.states_visited += 1
        row = tab[:, q]
        for i in range(indptr[x], indptr[x + 1]):
            stats.edges_scanned += 1
            nxt = int(row[int(labels[i])])
            if not nxt:
                continue
            y = int(indices[i])
            for p in range(nfa.n_states):
                if not (nxt >> p) & 1:
                    continue
                if y == v and (nfa.accept >> p) & 1:
                    return True
                st = (y, p)
                if st not in seen:
                    seen.add(st)
                    stack.append(st)
    return False
