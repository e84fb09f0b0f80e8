"""Index state and LM params as plain numpy arrays, in both directions.

``index_to_numpy`` flattens a ``TDRIndex`` into a dict of numpy arrays
(packed planes as ``uint32``, the CSR graph, the config as a dict);
``index_from_numpy`` builds a ``TDRIndex`` on a device from such a dict.
The planes cross as zero-copy ``view(np.int32)`` of the ``uint32`` words,
so an index built by the JAX package (its arrays taken with
``np.asarray``) answers queries through this package unchanged, and query
faults show up apart from build faults.

``lm_params_from_numpy`` / ``lm_params_to_numpy`` carry an LM param or
train-state tree (nested dicts, the reference's names and stacked
``[L, ...]`` shapes) across the same way, so both packages compute from
the same weights.  bfloat16 leaves cross as float32 arrays (lossless):
numpy has no bfloat16 of its own.
"""
from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from . import pytree
from .engine import resolve_device
from .graph import Graph
from .tdr_build import TDRConfig, TDRIndex

PLANES = ("h_vtx", "h_lab", "v_vtx", "v_lab", "n_out", "n_in")
AUX_PLANES = ("base_v", "base_l", "base_r", "r_vtx", "r_lab", "r_in",
              "d_vtx", "d_lab")
INT_ROWS = ("push", "pop", "g_count")
GRAPH_FIELDS = ("n_vertices", "n_labels", "indptr", "indices", "labels")


def index_to_numpy(idx: TDRIndex) -> dict:
    """``{"cfg": dict, "graph": dict, "fixpoint_rounds": int, plane name:
    uint32 array, ...}`` — the inverse of ``index_from_numpy``."""
    g = idx.graph
    state = {"cfg": dataclasses.asdict(idx.cfg),
             "graph": {f: getattr(g, f) for f in GRAPH_FIELDS},
             "fixpoint_rounds": int(idx.fixpoint_rounds),
             "vtx_words": idx.vtx_words, "lab_slot": idx.lab_slot,
             "disc": idx.disc}
    for name in PLANES + AUX_PLANES:
        t = getattr(idx, name)
        if t is not None:
            state[name] = t.cpu().contiguous().numpy().view(np.uint32)
    for name in INT_ROWS:
        state[name] = getattr(idx, name).cpu().numpy()
    return state


def index_from_numpy(state: dict, device="cuda") -> TDRIndex:
    """A ``TDRIndex`` on ``device`` (default: the card) from a dict laid
    out like ``index_to_numpy``'s; absent aux planes stay ``None``."""
    dev = resolve_device(device)

    def words(a):
        a = np.ascontiguousarray(np.asarray(a, dtype=np.uint32))
        with warnings.catch_warnings():
            # arrays taken from JAX are read-only; the port never writes
            # an index plane in place, so sharing their memory is safe
            warnings.filterwarnings("ignore", "The given NumPy array is "
                                    "not writable")
            return torch.from_numpy(a.view(np.int32)).to(dev)

    gd = state["graph"]
    graph = Graph(int(gd["n_vertices"]), int(gd["n_labels"]),
                  *(np.asarray(gd[f], dtype=np.int32)
                    for f in ("indptr", "indices", "labels")))
    planes = {n: words(state[n]) for n in PLANES}
    aux = {n: words(state[n]) for n in AUX_PLANES
           if state.get(n) is not None}
    rows = {n: torch.from_numpy(np.asarray(state[n], dtype=np.int32)).to(dev)
            for n in INT_ROWS}
    disc = state.get("disc")
    return TDRIndex(
        cfg=TDRConfig(**state["cfg"]), graph=graph, **planes, **rows,
        vtx_words=np.asarray(state["vtx_words"], dtype=np.uint32),
        lab_slot=np.asarray(state["lab_slot"], dtype=np.int32),
        fixpoint_rounds=int(state.get("fixpoint_rounds", 0)),
        disc=None if disc is None else np.asarray(disc, dtype=np.int32),
        **aux)


def lm_params_from_numpy(tree: dict, device="cuda") -> dict:
    """A nested dict of numpy arrays (JAX arrays pass through
    ``np.asarray``) as tensors on ``device`` (default: the card), each
    leaf at its own dtype; ``bfloat16`` leaves stay ``bfloat16``."""
    dev = resolve_device(device)

    def leaf(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.astype(np.float32)).to(
                device=dev, dtype=torch.bfloat16)
        return torch.from_numpy(np.array(a)).to(dev)
    return pytree.tree_map(leaf, tree)


def lm_params_to_numpy(tree: dict) -> dict:
    """The inverse of ``lm_params_from_numpy``: numpy arrays on the host,
    ``bfloat16`` leaves widened to float32."""
    def leaf(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return pytree.tree_map(leaf, tree)
