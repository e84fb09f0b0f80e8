"""LCR queries on top of the PCR engine.

LCR(u, v, A) — "is v reachable from u using only labels in A?" — is the PCR
pattern ``⋀_{l ∉ A} ¬l``.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from . import pattern as pat
from . import tdr_query
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
