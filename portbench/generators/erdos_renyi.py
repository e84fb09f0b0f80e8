"""The paper's §VI-A Erdős–Rényi generator (a frozen copy).

Draws exactly what the program's ``graph.erdos_renyi`` draws for the same
integer seed (one ``default_rng(seed)``: sources, targets, then labels):
``V * avg_degree`` uniform (src, dst) draws, uniform labels, self-loops
dropped, duplicate triples collapsed.

Configuration keys: ``n_vertices``, ``avg_degree``, ``n_labels``.
"""
from __future__ import annotations

import numpy as np

from portbench.reference.graphs import EdgeGraph, from_triples


def erdos_renyi(n_vertices: int, avg_degree: float, n_labels: int,
                seed: int) -> EdgeGraph:
    rng = np.random.default_rng(seed)
    n_edges = int(n_vertices * avg_degree)
    src = rng.integers(0, n_vertices, size=n_edges)
    dst = rng.integers(0, n_vertices, size=n_edges)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    lab = rng.integers(0, n_labels, size=src.shape[0])
    return from_triples(n_vertices, n_labels, src, dst, lab)


def make(cfg: dict, seed: int) -> EdgeGraph:
    """The configuration's graph for the integer ``seed``."""
    return erdos_renyi(cfg["n_vertices"], cfg["avg_degree"],
                       cfg["n_labels"], seed)
