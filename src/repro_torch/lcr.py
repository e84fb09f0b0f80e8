"""LCR queries on top of the PCR engine (+ a P2H-style full-index baseline).

LCR(u, v, A) — "is v reachable from u using only labels in A?" — is the PCR
pattern ``⋀_{l ∉ A} ¬l``.  The baseline, ``P2HLite``, stores what P2H+
stores: for every vertex, every reachable vertex with the *minimal* label
sets of the paths to it.  It answers exactly at once and is exponential
to build, the cost the paper's Table IV compares against.
"""
from __future__ import annotations

import dataclasses
from typing import FrozenSet, Sequence

import numpy as np

from . import pattern as pat
from . import tdr_query
from .graph import Graph
from .tdr_build import TDRIndex


def answer_lcr_batch(index: TDRIndex,
                     queries: Sequence[tuple[int, int, Sequence[int]]],
                     **kw) -> np.ndarray:
    """Answer LCR queries (u, v, allowed-labels) via the PCR engine; ``kw``
    goes to ``tdr_query.answer_batch`` (``device`` defaults to the card)."""
    n_labels = index.graph.n_labels
    pcr = [(u, v, pat.lcr(sorted(allowed), n_labels))
           for (u, v, allowed) in queries]
    return tdr_query.answer_batch(index, pcr, **kw)


# ------------------------------------------------------------ P2H baseline
def _minimal(sets: set[FrozenSet[int]]) -> set[FrozenSet[int]]:
    """The antichain of ``sets``: those with no (other) subset in it."""
    out: set[FrozenSet[int]] = set()
    for s in sorted(sets, key=len):
        if not any(t <= s for t in out):
            out.add(s)
    return out


@dataclasses.dataclass
class P2HLite:
    """Full reachability index: per source, minimal label sets per target.

    ``out[u][v]`` is the antichain of minimal label sets of u→v paths.
    The build is a label-set worklist fixpoint on the host: complete, and
    as expensive as full indices are."""
    out: list[dict[int, set[FrozenSet[int]]]]

    @staticmethod
    def build(graph: Graph, max_sets_per_pair: int = 64) -> "P2HLite":
        v_n = graph.n_vertices
        out: list[dict[int, set[FrozenSet[int]]]] = [
            dict() for _ in range(v_n)]
        for u in range(v_n):                 # direct edges
            dsts, labs = graph.out_edges(u)
            for v, l in zip(dsts.tolist(), labs.tolist()):
                out[u].setdefault(v, set()).add(frozenset((l,)))
            for v in out[u]:
                out[u][v] = _minimal(out[u][v])
        # out[u] <- minimal(out[u] ∪ {l ∪ s : (u, w, l), s ∈ out[w]})
        changed = True
        while changed:
            changed = False
            for u in range(v_n):
                dsts, labs = graph.out_edges(u)
                new: dict[int, set[FrozenSet[int]]] = {}
                for w, l in zip(dsts.tolist(), labs.tolist()):
                    for v, sets in out[w].items():
                        for s in sets:
                            new.setdefault(v, set()).add(s | {l})
                for v, sets in new.items():
                    cur = out[u].setdefault(v, set())
                    before = frozenset(cur)
                    merged = _minimal(cur | sets)
                    if len(merged) > max_sets_per_pair:
                        merged = set(sorted(merged, key=len)
                                     [:max_sets_per_pair])
                    if frozenset(merged) != before:
                        out[u][v] = merged
                        changed = True
        return P2HLite(out)

    def query(self, u: int, v: int, allowed: Sequence[int]) -> bool:
        if u == v:
            return True      # the empty path, as in the PCR semantics
        a = frozenset(allowed)
        return any(s <= a for s in self.out[u].get(v, ()))

    def size_bytes(self) -> int:
        total = 0
        for d in self.out:
            for sets in d.values():
                total += 8   # vertex id + header
                total += sum(8 + 4 * len(s) for s in sets)
        return total
