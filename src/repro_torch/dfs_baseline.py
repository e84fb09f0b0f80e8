"""The paper's DFS comparison baseline (§VI-A) — also the exact oracle.

Answering a PCR query exactly is a search over the *pattern product graph*:
states are ``(vertex, subset-of-required-labels-seen)`` for one DNF term,
with edges carrying a forbidden label deleted.  The DFS explores it with
memoisation and terminates exactly on cyclic graphs.  Host-only Python,
kept in step with the JAX package's oracle; ``chip_smoke.py`` holds the
port's answers against it.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from . import pattern as pat
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
