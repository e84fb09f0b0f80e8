"""Regular path queries by plain search, in NumPy.

A query ``(u, v, regex)`` asks for a u→v path whose label *sequence* is a
word of the regex; ``u == v`` is answered by the empty path when the
regex accepts the empty word.  The regex text uses ``l<int>`` for a label,
juxtaposition for concatenation, ``|``, ``*``, ``+``, ``?`` and
parentheses.  It is parsed here, turned into a Thompson automaton, and
searched over the states ``(vertex, automaton state)``.
"""
from __future__ import annotations

import re

import numpy as np

from .graphs import EdgeGraph
from .pcr import _edge_ranges

_TOKEN = re.compile(r"\s*(l\d+|[|*+?()])")


def _tokens(text: str) -> list[str]:
    out, pos = [], 0
    text = text.strip()
    while pos < len(text):
        m = _TOKEN.match(text, pos)
        if not m:
            raise ValueError(f"bad regex {text!r} at {pos}")
        out.append(m.group(1))
        pos = m.end()
    return out


class _Nfa:
    """Thompson automaton: ``eps[q]`` and ``moves[q]`` (label, target)."""

    def __init__(self):
        self.eps: list[list[int]] = []
        self.moves: list[list[tuple[int, int]]] = []

    def state(self) -> int:
        self.eps.append([])
        self.moves.append([])
        return len(self.eps) - 1


def _parse(tokens: list[str], nfa: _Nfa) -> tuple[int, int]:
    """Recursive descent; returns the (start, accept) fragment."""
    pos = [0]

    def peek():
        return tokens[pos[0]] if pos[0] < len(tokens) else None

    def alt():
        s, a = cat()
        while peek() == "|":
            pos[0] += 1
            s2, a2 = cat()
            ns, na = nfa.state(), nfa.state()
            nfa.eps[ns] += [s, s2]
            nfa.eps[a].append(na)
            nfa.eps[a2].append(na)
            s, a = ns, na
        return s, a

    def cat():
        frag = post()
        while peek() is not None and peek() not in ("|", ")"):
            s2, a2 = post()
            nfa.eps[frag[1]].append(s2)
            frag = (frag[0], a2)
        return frag

    def post():
        s, a = atom()
        while peek() in ("*", "+", "?"):
            op = tokens[pos[0]]
            pos[0] += 1
            ns, na = nfa.state(), nfa.state()
            nfa.eps[ns].append(s)
            nfa.eps[a].append(na)
            if op in ("*", "+"):
                nfa.eps[a].append(s)
            if op in ("*", "?"):
                nfa.eps[ns].append(na)
            s, a = ns, na
        return s, a

    def atom():
        tok = peek()
        if tok is None:
            raise ValueError("regex ends early")
        pos[0] += 1
        if tok == "(":
            frag = alt()
            if peek() != ")":
                raise ValueError("unbalanced parenthesis")
            pos[0] += 1
            return frag
        if not tok.startswith("l"):
            raise ValueError(f"unexpected {tok!r}")
        s, a = nfa.state(), nfa.state()
        nfa.moves[s].append((int(tok[1:]), a))
        return s, a

    frag = alt()
    if pos[0] != len(tokens):
        raise ValueError("trailing regex tokens")
    return frag


class Automaton:
    """ε-free form: ``step[q, label]`` lists the closed target states."""

    def __init__(self, text: str, n_labels: int):
        nfa = _Nfa()
        start, accept = _parse(_tokens(text), nfa)
        n = len(nfa.eps)
        close = []
        for q in range(n):
            seen, stack = {q}, [q]
            while stack:
                for r in nfa.eps[stack.pop()]:
                    if r not in seen:
                        seen.add(r)
                        stack.append(r)
            close.append(seen)
        self.n_states = n
        self.start = sorted(close[start])
        self.accept = accept
        targets = [[set() for _ in range(n_labels)] for _ in range(n)]
        for q in range(n):
            for lab, r in nfa.moves[q]:
                if lab < n_labels:
                    targets[q][lab] |= close[r]
        width = max((len(t) for row in targets for t in row), default=0)
        self.step = np.full((n, max(n_labels, 1), max(width, 1)), -1,
                            dtype=np.int64)
        for q in range(n):
            for lab in range(n_labels):
                ts = sorted(targets[q][lab])
                self.step[q, lab, :len(ts)] = ts


def reach(g: EdgeGraph, u: int, v: int, text: str,
          depth: int | None = None) -> bool:
    """Whether some u→v path spells a word of the regex (of at most
    ``depth`` edges, when given)."""
    a = Automaton(text, g.n_labels)
    q_n = a.n_states
    if u == v and a.accept in a.start:
        return True
    goal = v * q_n + a.accept
    seen = np.zeros(g.n_vertices * q_n, dtype=bool)
    frontier = np.array([u * q_n + q for q in a.start], dtype=np.int64)
    seen[frontier] = True
    hops = 0
    while frontier.size and (depth is None or hops < depth):
        hops += 1
        edges, owner = _edge_ranges(g.indptr, frontier // q_n)
        nxt_q = a.step[(frontier % q_n)[owner], g.labels[edges]]
        dst = np.repeat(g.indices[edges], nxt_q.shape[1])
        nxt_q = nxt_q.reshape(-1)
        ok = nxt_q >= 0
        nxt = dst[ok] * q_n + nxt_q[ok]
        if (nxt == goal).any():
            return True
        nxt = np.unique(nxt[~seen[nxt]])
        seen[nxt] = True
        frontier = nxt
    return False
