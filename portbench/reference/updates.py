"""The graph at every log position (LSN) of a run that takes writes.

A served index that takes edge inserts and deletes answers each read on
the graph of the LSN it stamps on the answer.  ``chain`` works those
graphs out again from the run's own arrays: the seed's graph at the
first LSN, then each drawn ``(added, removed)`` delta in turn.  A delta
has set semantics, as the program's ``Graph.apply_updates`` states them:
removals first, then additions; adding an edge that is there or removing
one that is not changes nothing.

Edges are the ``(src, dst, label)`` rows of an int64 ``[N, 3]`` array, or
the keys of ``EdgeGraph.edge_keys``.
"""
from __future__ import annotations

import numpy as np

from .graphs import EdgeGraph, from_triples


def keys_of(rows, n_vertices: int, n_labels: int) -> np.ndarray:
    """Sorted distinct keys ``(src * V + dst) * L + label`` of edge rows."""
    rows = np.asarray(rows, dtype=np.int64).reshape(-1, 3)
    return np.unique((rows[:, 0] * n_vertices + rows[:, 1]) * n_labels
                     + rows[:, 2])


def rows_of(keys, n_vertices: int, n_labels: int) -> np.ndarray:
    """The ``[N, 3]`` ``(src, dst, label)`` rows of edge keys."""
    keys = np.asarray(keys, dtype=np.int64)
    pair = keys // n_labels
    return np.stack([pair // n_vertices, pair % n_vertices,
                     keys % n_labels], axis=1)


def apply(keys: np.ndarray, added: np.ndarray,
          removed: np.ndarray) -> np.ndarray:
    """The sorted edge keys after removing, then adding, the given keys."""
    return np.union1d(np.setdiff1d(keys, removed), added)


def chain(g: EdgeGraph, deltas) -> list[EdgeGraph]:
    """``[g, g + delta_1, g + delta_1 + delta_2, ...]``: the graph at each
    LSN from the first, one per delta ``(added_rows, removed_rows)``."""
    v, l = g.n_vertices, g.n_labels
    keys = g.edge_keys()
    out = [g]
    for added, removed in deltas:
        keys = apply(keys, keys_of(added, v, l), keys_of(removed, v, l))
        src, dst, lab = rows_of(keys, v, l).T
        out.append(from_triples(v, l, src, dst, lab))
    return out
