"""The graph the reference reads: plain NumPy edge arrays in CSR form.

The generators (``portbench/generators/``) make one from a run's seed;
``from_triples`` collapses duplicate ``(src, dst, label)`` triples and
sorts the CSR by source, then target, then label.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class EdgeGraph:
    """CSR edge-labelled digraph: ``indices[indptr[u]:indptr[u+1]]`` are
    u's targets and ``labels`` the matching edge labels."""
    n_vertices: int
    n_labels: int
    indptr: np.ndarray    # int64 [V + 1]
    indices: np.ndarray   # int64 [E]
    labels: np.ndarray    # int64 [E]

    @property
    def n_edges(self) -> int:
        return int(self.indices.shape[0])

    @property
    def src(self) -> np.ndarray:
        return np.repeat(np.arange(self.n_vertices, dtype=np.int64),
                         np.diff(self.indptr))

    def edge_keys(self) -> np.ndarray:
        """Sorted int64 keys ``(src * V + dst) * L + label``, one per edge."""
        v, l = self.n_vertices, self.n_labels
        return (self.src * v + self.indices) * l + self.labels


def from_triples(n_vertices: int, n_labels: int, src, dst,
                 lab) -> EdgeGraph:
    """CSR of the distinct ``(src, dst, label)`` triples."""
    v, l = np.int64(n_vertices), np.int64(n_labels)
    keys = np.unique((np.asarray(src, np.int64) * v
                      + np.asarray(dst, np.int64)) * l
                     + np.asarray(lab, np.int64))
    lab_s = keys % l
    pair = keys // l
    src_s, dst_s = pair // v, pair % v
    indptr = np.zeros(n_vertices + 1, dtype=np.int64)
    np.add.at(indptr, src_s + 1, 1)
    return EdgeGraph(int(n_vertices), int(n_labels), np.cumsum(indptr),
                     dst_s, lab_s)
