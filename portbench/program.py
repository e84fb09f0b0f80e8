"""The benchmark's one door into the system under test, ``repro_torch``.

Everything the harness hands the program passes through here: the graph
as the program's ``Graph``, query specs as its pattern and regex objects,
and the configuration's build, engine and server settings.  The program is
imported from ``src/`` of the checkout, and only when a run asks for it,
so the rest of the benchmark imports without it.
"""
from __future__ import annotations

import dataclasses
import importlib
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = "repro_torch"


def load(root: Path = ROOT):
    """Import the program's modules from ``<root>/src``; raises
    ``ImportError`` when the checkout does not hold it."""
    src = str(Path(root) / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    names = ("graph", "pattern", "rpq", "tdr_build", "tdr_query", "engine",
             "kernels.ops", "launch.serve")
    mods = {n: importlib.import_module(f"{PACKAGE}.{n}") for n in names}
    return Program(mods)


class Program:
    """Thin adapter over the program's public entry points."""

    package = PACKAGE

    def __init__(self, mods: dict):
        self.mods = mods
        self.graph_mod = mods["graph"]
        self.pat = mods["pattern"]
        self.rpq = mods["rpq"]
        self.tdr_build = mods["tdr_build"]
        self.tdr_query = mods["tdr_query"]
        self.engine = mods["engine"]
        self.ops = mods["kernels.ops"]
        self.serve = mods["launch.serve"]

    # ------------------------------------------------------------ inputs
    def graph(self, eg):
        """The program's ``Graph`` over the benchmark's edge arrays."""
        return self.graph_mod.Graph(
            eg.n_vertices, eg.n_labels, eg.indptr.astype(np.int32),
            eg.indices.astype(np.int32), eg.labels.astype(np.int32))

    def pattern(self, family: str, labels, n_labels: int):
        p, labs = self.pat, list(labels)
        if family == "all_of":
            return p.all_of(labs)
        if family == "any_of":
            return p.any_of(labs)
        if family == "none_of":
            return p.none_of(labs)
        if family == "or_not":
            a, b, c = labs
            return p.and_(p.or_(p.label(a), p.label(b)), p.not_(p.label(c)))
        if family == "or_all":
            a, b, c, d = labs
            return p.or_(p.all_of([a, b]), p.all_of([c, d]))
        if family == "lcr":
            return p.lcr(labs, n_labels)
        raise ValueError(f"unknown pattern family {family!r}")

    def query(self, spec, n_labels: int) -> tuple:
        """``(u, v, pattern-or-regex)`` of one spec."""
        kind, u, v, family, labels = spec
        if kind == "rpq":
            return u, v, self.rpq.parse(family)
        return u, v, self.pattern(family, labels, n_labels)

    # ------------------------------------------------------------ system
    def tdr_config(self, cfg: dict):
        return self.tdr_build.TDRConfig(**cfg.get("tdr_config", {}))

    def engine_config(self, cfg: dict):
        """``None`` keeps ``build_index``'s own default engine settings."""
        over = cfg.get("engine_config") or {}
        return self.engine.EngineConfig(**over) if over else None

    def build(self, g, cfg: dict, device: str):
        return self.tdr_build.build_index(
            g, self.tdr_config(cfg), backend=cfg.get("backend"),
            engine_config=self.engine_config(cfg), device=device)

    def answer_batch(self, index, queries, cfg: dict, device: str,
                     stats=None):
        return self.tdr_query.answer_batch(
            index, queries, backend=cfg.get("backend"), stats=stats,
            engine_config=self.engine_config(cfg), device=device)

    def server(self, index, cfg: dict, mix: dict):
        sc = self.serve.ServeConfig(**mix.get("server", {}))
        if cfg.get("backend") is not None:
            sc = dataclasses.replace(sc, backend=cfg["backend"])
        return self.serve.QueryServer(index, sc)

    # ---------------------------------------------------------- counters
    def counters(self, server=None, qstats=None) -> dict:
        """A flat snapshot of the program's own counters."""
        out = {f"launches.{k}": int(v)
               for k, v in self.ops.KERNEL_LAUNCHES.items()}
        out.update({f"class_packs.{k}": int(v)
                    for k, v in self.engine.LABEL_CLASS_PACKS.items()})
        out["jit_cache_entries"] = int(self.engine.jit_cache_entries())
        if server is not None:
            st = server.stats
            for f in dataclasses.fields(st):
                val = getattr(st, f.name)
                if isinstance(val, (int, float)):
                    out[f"serve.{f.name}"] = val
            qstats = st.query_stats
        if qstats is not None:
            for f in dataclasses.fields(qstats):
                val = getattr(qstats, f.name)
                if isinstance(val, (int, float)) and not f.name.startswith(
                        "_"):
                    out[f"query.{f.name}"] = val
            out["query.exact_rounds"] = int(qstats.exact_rounds)
        return out
