"""The one generator every traffic mix goes through.

A mix file (``traffic/<mix>.json``) holds parameters only: query kinds
and their shares, pattern families and how many labels each takes, regex
templates, how endpoints are drawn, bounds, batch sizes.  This module
turns them, with the run's seed, into query specs: plain tuples that the
reference reads as they are and ``program.py`` turns into the program's
pattern objects.

Every share is dealt in blocks: a block holds each kind (family,
template, way of drawing endpoints) as many times as its weight, in an
order drawn from the seed.  So every seed gets the same amount of each
kind of work, in another order.

Endpoints are uniform, or, where the mix's ``walk_endpoints`` deals a
kind a walk, ``v`` is where a label-matching walk from ``u`` ends: the
pairs a knowledge-graph service asks about, joined by a route of the
pattern or the regex, so that those answers are true and counts are not
0.  A walk that finds no such route in its tries falls back to uniform
endpoints.

A spec is ``(kind, u, v, family, labels)``: ``family`` is a pattern family
of ``reference.pcr.terms`` or, for kind ``rpq``, the regex text.
"""
from __future__ import annotations

import functools

import numpy as np

from . import discover
from .reference import pcr, rpq
from .reference.graphs import EdgeGraph

SEED_SPACE = 1 << 64


def rng(seed: int, *stream: int) -> np.random.Generator:
    """Generator for one purpose (``stream``) of one run's seed."""
    return np.random.default_rng([int(seed) % SEED_SPACE, *stream])


# stream ids: one per purpose, so adding a purpose changes no other draw
GRAPH, WARM, WINDOW, CHECK, BUILD_CHECK = 1, 2, 3, 4, 5


def graph_seed(seed: int) -> int:
    """The integer seed handed to the graph generator."""
    return int(np.random.SeedSequence([int(seed) % SEED_SPACE, GRAPH])
               .generate_state(1)[0])


def make_graph(cfg: dict, seed: int, pkg=discover.PKG) -> EdgeGraph:
    """The configuration's graph for this run's seed, by the generator
    file its ``"generator"`` names."""
    make = discover.load("generators", cfg["generator"], "make", pkg)
    return make(cfg, graph_seed(seed))


def dealt(r: np.random.Generator, weights: dict, n: int) -> list:
    """``n`` keys of ``weights`` dealt in shuffled blocks of
    ``sum(weights)``."""
    block = [k for k, w in weights.items() for _ in range(int(w))]
    out: list = []
    while len(out) < n:
        out += [block[i] for i in r.permutation(len(block))]
    return out[:n]


def distinct_labels(r: np.random.Generator, n: int, k: int,
                    n_labels: int) -> np.ndarray:
    """``n`` rows of ``k`` distinct labels."""
    return np.argsort(r.random((n, n_labels)), axis=1)[:, :k]


def _out_edges(g: EdgeGraph, x: int) -> tuple:
    s, e = int(g.indptr[x]), int(g.indptr[x + 1])
    return g.indices[s:e], g.labels[s:e]


def walk_pattern(r, g: EdgeGraph, family: str, labels, walk: dict):
    """``(u, v)`` joined by a walk of ``min_hops``..``max_hops`` edges
    whose label set satisfies one term of the pattern (its required
    labels at steps drawn at random, no forbidden label on any step);
    ``None`` when ``tries`` walks find none."""
    ts = pcr.terms(family, labels, g.n_labels)
    for _ in range(walk["tries"]):
        req, forb = ts[int(r.integers(len(ts)))]
        req = sorted(req)
        lo = max(walk["min_hops"], len(req), 1)
        if lo > walk["max_hops"]:
            continue
        n = int(r.integers(lo, walk["max_hops"] + 1))
        at = dict(zip(r.choice(n, len(req), replace=False).tolist(), req))
        forbid = np.zeros(g.n_labels, dtype=bool)
        forbid[[x for x in forb if x < g.n_labels]] = True
        u = x = int(r.integers(g.n_vertices))
        for step in range(n):
            dst, lab = _out_edges(g, x)
            ok = np.flatnonzero(lab == at[step] if step in at
                                else ~forbid[lab])
            if not ok.size:
                break
            x = int(dst[ok[int(r.integers(ok.size))]])
        else:
            return u, x
    return None


@functools.lru_cache(maxsize=None)
def _automaton(text: str, n_labels: int) -> rpq.Automaton:
    """A regex's automaton, built once for all its walks."""
    return rpq.Automaton(text, n_labels)


def walk_regex(r, g: EdgeGraph, text: str, walk: dict):
    """``(u, v)`` joined by a walk that spells a word of the regex: each
    try walks the product of graph and automaton for a length drawn from
    ``min_hops``..``max_hops``, one live edge at a time, and ends where it
    last accepted; the first try that accepts at its drawn length wins,
    else the one that accepted deepest.  ``None`` when no try accepted
    after ``min_hops`` edges."""
    a = _automaton(text, g.n_labels)
    best = None
    for _ in range(walk["tries"]):
        n = int(r.integers(walk["min_hops"], walk["max_hops"] + 1))
        u = x = int(r.integers(g.n_vertices))
        states = np.asarray(a.start, dtype=np.int64)
        last = None
        for step in range(1, n + 1):
            dst, lab = _out_edges(g, x)
            nxt = a.step[states][:, lab, :]           # [|Q|, deg, width]
            live = np.flatnonzero((nxt >= 0).any(axis=(0, 2)))
            if not live.size:
                break
            j = int(live[int(r.integers(live.size))])
            states = np.unique(nxt[:, j, :][nxt[:, j, :] >= 0])
            x = int(dst[j])
            if a.accept in states:
                last = (step, x)
        if last is not None and last[0] == n:
            return u, x
        if last is not None and last[0] >= walk["min_hops"] and (
                best is None or last[0] > best[0]):
            best = (last[0], u, last[1])
    return None if best is None else best[1:]


def _ways(r, mix: dict, kind: str, n: int) -> list:
    """How each of ``n`` specs of ``kind`` draws its endpoints: ``walk``
    or ``uniform``, dealt by the mix's ``walk_endpoints``."""
    walk = mix.get("walk_endpoints", {}).get(kind)
    if not walk:
        return ["uniform"] * n
    return dealt(r, {"walk": walk["walk"], "uniform": walk["uniform"]}, n)


def _pattern_specs(r, kind: str, families: list, mix: dict,
                   g: EdgeGraph) -> list:
    n = len(families)
    ends = r.integers(0, g.n_vertices, size=(n, 2))
    labs = distinct_labels(r, n, max(mix["family_labels"].values()),
                           g.n_labels)
    ways = _ways(r, mix, kind, n)
    out = []
    for i, fam in enumerate(families):
        lab = tuple(int(x) for x in labs[i, :mix["family_labels"][fam]])
        u, v = int(ends[i, 0]), int(ends[i, 1])
        if ways[i] == "walk":
            got = walk_pattern(r, g, fam, lab, mix["walk_endpoints"][kind])
            u, v = got if got is not None else (u, v)
        out.append((kind, u, v, fam, lab))
    return out


def _rpq_specs(r, templates: list, mix: dict, g: EdgeGraph) -> list:
    n = len(templates)
    ends = r.integers(0, g.n_vertices, size=(n, 2))
    labs = distinct_labels(r, n, 4, g.n_labels)
    ways = _ways(r, mix, "rpq", n)
    out = []
    for i, t in enumerate(templates):
        text = t["regex"].format(*labs[i].tolist(), L=g.n_labels)
        u = int(ends[i, 0])
        v = u if t.get("same_endpoints") else int(ends[i, 1])
        if ways[i] == "walk" and t.get("walk"):
            got = walk_regex(r, g, text, mix["walk_endpoints"]["rpq"])
            u, v = got if got is not None else (u, v)
        out.append(("rpq", u, v, text, ()))
    return out


def kind_shares(mix: dict, n_edges: int) -> dict:
    """The mix's kind weights for a graph of ``n_edges`` edges: where route
    counts are refused (``count_max_edges``), their share goes to
    ``count_fallback``."""
    kinds = dict(mix["kinds"])
    cap = mix.get("count_max_edges")
    if "count" in kinds and cap is not None and n_edges > cap:
        fb = mix["count_fallback"]
        kinds[fb] = kinds.get(fb, 0) + kinds.pop("count")
    return kinds


def requests(mix: dict, n: int, r: np.random.Generator, g: EdgeGraph,
             kinds: dict) -> list:
    """``n`` request specs of a served mix, kinds dealt in blocks."""
    order = dealt(r, kinds, n)
    by_kind: dict = {}
    for kind in kinds:
        m = sum(1 for k in order if k == kind)
        if kind == "rpq":
            tmpl = dealt(r, {i: t["weight"] for i, t in
                             enumerate(mix["rpq"])}, m)
            by_kind[kind] = iter(_rpq_specs(
                r, [mix["rpq"][i] for i in tmpl], mix, g))
        else:
            fams = dealt(r, mix["families"][kind], m)
            by_kind[kind] = iter(_pattern_specs(r, kind, fams, mix, g))
    return [next(by_kind[k]) for k in order]


def bool_queries(mix: dict, n: int, r: np.random.Generator,
                 g: EdgeGraph) -> list:
    """``n`` boolean query specs over the mix's ``families``."""
    fams = dealt(r, mix["families"]["bool"], n)
    return _pattern_specs(r, "bool", fams, mix, g)
