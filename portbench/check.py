"""The comparison that decides ``correct``.

Each served or batch answer is judged against ``reference``, which works
it out again from the benchmark's own graph arrays and query specs.  A
check is ``(name, value, limit)`` and passes when ``value <= limit``.
Each kind of answer is its own number, ``<kind>_wrong``.  Every limit
here is 0: an answer of a reachability index is exact, so one wrong
answer, or one request that never got its answer (counted among the
wrong ones of its kind), fails the run.

The control (``python3 -m portbench.control``) is the reference in the
program's place with each kind's searches cut at the mix's
``control_depth[kind]`` hops: the approximate answer a bounded search
gives, which breaks the exactness the configurations state.
"""
from __future__ import annotations

import collections
import dataclasses

from .reference import pcr, rpq


@dataclasses.dataclass(frozen=True)
class Check:
    name: str
    value: int
    limit: int

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


def reference_answer(g, spec, mix: dict, depth: int | None = None):
    """The reference's answer to one spec; with ``depth``, the control's:
    every search cut at ``depth`` hops."""
    kind, u, v, family, labels = spec
    if kind == "bool":
        if depth is None:
            return pcr.reach(g, u, v, family, labels)
        return pcr.distance(g, u, v, family, labels, bound=depth) >= 0
    if kind == "dist":
        k = mix["dist_k"] if depth is None else min(mix["dist_k"], depth)
        return pcr.distance(g, u, v, family, labels, bound=k)
    if kind == "count":
        hops = mix["count_hops"] if depth is None else min(
            mix["count_hops"], depth)
        return pcr.count_walks(g, u, v, family, labels, hops=hops,
                               cap=mix["count_cap"])
    if kind == "rpq":
        return rpq.reach(g, u, v, family, depth=depth)
    raise ValueError(f"no reference answer for kind {kind!r}")


def control_answer(g, spec, mix: dict):
    """The control's answer: the reference with the kind's searches cut at
    the mix's ``control_depth[kind]`` hops (a witness is its cut search's
    path)."""
    kind, u, v, family, labels = spec
    depth = mix["control_depth"][kind]
    if kind == "witness":
        return pcr.shortest_path(g, u, v, family, labels, bound=depth)
    return reference_answer(g, spec, mix, depth)


def wrong_answers(g, items, mix: dict, control: bool = False) -> dict:
    """Per kind, how many ``(spec, answer)`` items the reference finds
    wrong; with ``control``, the control answers the same specs in the
    program's place."""
    keys = g.edge_keys()
    wrong = collections.Counter()
    for spec, answer in items:
        kind, u, v, family, labels = spec
        if control:
            answer = control_answer(g, spec, mix)
        if kind == "witness":
            ok = pcr.check_witness(g, keys, u, v, family, labels, answer)
        else:
            ok = reference_answer(g, spec, mix) == answer
        wrong[kind] += 0 if ok else 1
    return wrong


def kind_checks(g, items, mix: dict, kinds, failed: dict,
                control: bool = False) -> list[Check]:
    """One number per kind in ``kinds``, ``<kind>_wrong``: the wrong
    answers among the sampled ``items`` plus the requests of that kind
    that raised or never answered (``failed``); an answer that never
    comes is a wrong one."""
    wrong = wrong_answers(g, items, mix, control)
    wrong.update(failed)
    return [Check(f"{kind}_wrong", int(wrong[kind]), 0) for kind in kinds]


def sample(r, items: list, n: int) -> list:
    """``n`` of ``items`` drawn by ``r`` (all of them when fewer)."""
    if len(items) <= n:
        return list(items)
    return [items[i] for i in sorted(r.choice(len(items), n, replace=False))]
