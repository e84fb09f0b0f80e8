"""Regular path queries (RPQ) — AST, parser, Glushkov NFA, DNF lowering.

Where ``pattern.py`` constrains the *set* of labels on a path, an RPQ
constrains their *order*: a path answers ``(u, v, r)`` iff the label
word ``L(p) = l_1 l_2 … l_k`` read along some u→v path is a member of
the regular language of ``r``.  This strictly extends the paper's LCR
comparison — the LCR allowed-set A is exactly the single-star regex
``(a_1|…|a_m)*`` — and matches the product-automaton formulation of
BitPath (Atre et al.) and the recursive label-concatenated index
fragment analysis of Zhang et al.

Two executors share this module:

* the **index-expressible fragment** — alternations of single-atom
  stars, ``A_1* | A_2* | …`` with each ``A_i`` a label alternation —
  lowers *exactly* onto ``pattern.py`` DNF terms via ``lower_to_pattern``
  (``w ∈ A* ⟺ set(w) ⊆ A``), so those queries ride the existing TDR
  filter cascade and phase-2 subset-state engine untouched;
* everything else compiles to a **Glushkov NFA** (``compile_nfa``: no
  ε-transitions, ≤ 32 states packed one ``uint32`` per (vertex, job)
  lane) and runs the automaton-product bidirectional expansion in
  ``tdr_query.rpq_batch``, pruned by the *over-approximation*
  ``approx_pattern`` — a single DNF term that is implied by (but does
  not imply) the RPQ, so only cascade-FALSE verdicts are sound.

Canonicalization mirrors ``pattern.py``: flatten/dedup/sort where the
algebra allows (alternation — but *not* concatenation, which is ordered),
star-absorption rewrites (``(x*)* → x*``, ``(x?)* → x*``,
``(a*|b)* → (a|b)*``), hash-consing behind an interning cap, and a
stable ``canonical_key`` string the serving layer uses for its
kind-keyed plan/result caches.

The JAX package's ``rpq`` module, forked (it needs only numpy and
``pattern``): the NFA tables stay numpy ``uint32`` here, and
``tdr_query`` carries them on the device as int32 words of the same bits.
"""
from __future__ import annotations

import dataclasses
from typing import FrozenSet, Union

import numpy as np

from . import pattern as pat

#: hard ceiling on Glushkov states (start + one per label occurrence) so
#: an NFA subset fits one uint32 lane in the product-graph planes.
MAX_STATES = 32


# ------------------------------------------------------------------- AST
@dataclasses.dataclass(frozen=True)
class Sym:
    """One edge with label ``index`` (an atom of the regex)."""
    index: int


@dataclasses.dataclass(frozen=True)
class Cat:
    """Concatenation ``r_1 · r_2 · …`` — ordered, never commuted."""
    children: tuple


@dataclasses.dataclass(frozen=True)
class Alt:
    """Alternation ``r_1 | r_2 | …`` — flattened/deduped/sorted."""
    children: tuple


@dataclasses.dataclass(frozen=True)
class Star:
    child: "Rpq"


@dataclasses.dataclass(frozen=True)
class Plus:
    child: "Rpq"


@dataclasses.dataclass(frozen=True)
class Opt:
    child: "Rpq"


Rpq = Union[Sym, Cat, Alt, Star, Plus, Opt]


def sym(i: int) -> Rpq:
    return Sym(int(i))


def cat(*rs: Rpq) -> Rpq:
    rs = tuple(rs)
    return rs[0] if len(rs) == 1 else Cat(rs)


def alt(*rs: Rpq) -> Rpq:
    rs = tuple(rs)
    return rs[0] if len(rs) == 1 else Alt(rs)


def star(r: Rpq) -> Rpq:
    return Star(r)


def plus(r: Rpq) -> Rpq:
    return Plus(r)


def opt(r: Rpq) -> Rpq:
    return Opt(r)


def lcr(allowed, n_labels: int) -> Rpq:
    """The LCR allowed-set ``A`` as a regex: ``(a_1|…|a_m)*``."""
    del n_labels  # symmetry with pattern.lcr; the star needs no alphabet
    return Star(alt(*[Sym(int(a)) for a in sorted(set(allowed))]))


def alphabet(r: Rpq) -> FrozenSet[int]:
    """Every label that can appear in some word of ``L(r)``."""
    if isinstance(r, Sym):
        return frozenset((r.index,))
    if isinstance(r, (Cat, Alt)):
        out: FrozenSet[int] = frozenset()
        for c in r.children:
            out |= alphabet(c)
        return out
    return alphabet(r.child)


def nullable(r: Rpq) -> bool:
    """True iff the empty word ε ∈ L(r) — i.e. ``u == v`` answers True."""
    if isinstance(r, Sym):
        return False
    if isinstance(r, Cat):
        return all(nullable(c) for c in r.children)
    if isinstance(r, Alt):
        return any(nullable(c) for c in r.children)
    if isinstance(r, Plus):
        return nullable(r.child)
    return True  # Star, Opt


def required_alphabet(r: Rpq) -> FrozenSet[int]:
    """Labels present in *every* word of ``L(r)`` (structural lower
    bound, used as the require-side of ``approx_pattern``).  Sound by
    construction: Cat unions (every factor contributes), Alt intersects
    (any branch may be taken), Star/Opt require nothing (ε is a word),
    Plus requires what its body requires."""
    if isinstance(r, Sym):
        return frozenset((r.index,))
    if isinstance(r, Cat):
        out: FrozenSet[int] = frozenset()
        for c in r.children:
            out |= required_alphabet(c)
        return out
    if isinstance(r, Alt):
        sets = [required_alphabet(c) for c in r.children]
        out = sets[0]
        for s in sets[1:]:
            out &= s
        return out
    if isinstance(r, Plus):
        return required_alphabet(r.child)
    return frozenset()  # Star, Opt: ε kills every requirement


# --------------------------------------------- canonical form + interning
_intern: dict = {}
_INTERN_CAP = 1 << 16


def _strip_closure(c: Rpq) -> Rpq:
    """Inside a star, one top-level closure/option is absorbed:
    ``(x*)* = (x?)* = (x+)* = x*`` and ``(…|x*|…)* = (…|x|…)*``."""
    if isinstance(c, (Star, Plus, Opt)):
        return _strip_closure(c.child)
    if isinstance(c, Alt):
        return Alt(tuple(_strip_closure(g) for g in c.children))
    return c


def _canon(r: Rpq):
    """Canonical (node, key) of ``r``.  Keys: ``l3`` / ``.(k,…)`` /
    ``|(k,…)`` / ``*(k)`` / ``+(k)`` / ``?(k)``."""
    if isinstance(r, Sym):
        if r.index < 0:
            raise ValueError(f"negative label {r.index}")
        return r, f"l{r.index}"
    if isinstance(r, Cat):
        kids = []
        for c in r.children:
            cc, _ = _canon(c)
            if isinstance(cc, Cat):             # flatten, order preserved
                kids.extend(cc.children)
            else:
                kids.append(cc)
        if not kids:
            raise ValueError("empty concatenation")
        if len(kids) == 1:
            return _canon(kids[0])
        keys = [_canon(c)[1] for c in kids]
        return Cat(tuple(kids)), f".({','.join(keys)})"
    if isinstance(r, Alt):
        kids: dict = {}
        for c in r.children:
            cc, ck = _canon(c)
            if isinstance(cc, Alt):             # flatten nested same-op
                for gc in cc.children:
                    kids.setdefault(_canon(gc)[1], gc)
            else:
                kids.setdefault(ck, cc)         # dedup by key
        if not kids:
            raise ValueError("empty alternation")
        if len(kids) == 1:
            (ck, cc), = kids.items()            # single child unwraps
            return cc, ck
        keys = sorted(kids)
        return Alt(tuple(kids[k] for k in keys)), f"|({','.join(keys)})"
    if isinstance(r, Star):
        cc, _ = _canon(r.child)
        cc, ck = _canon(_strip_closure(cc))     # (x*)* → x*, (a*|b)* → (a|b)*
        return Star(cc), f"*({ck})"
    if isinstance(r, Plus):
        cc, ck = _canon(r.child)
        if isinstance(cc, (Star, Opt)):         # (x*)+ = x*, (x?)+ = x*
            return _canon(Star(cc.child))
        if isinstance(cc, Plus):                # (x+)+ = x+
            cc, ck = cc.child, _canon(cc.child)[1]
        return Plus(cc), f"+({ck})"
    if isinstance(r, Opt):
        cc, ck = _canon(r.child)
        if isinstance(cc, Star):                # (x*)? = x*
            return cc, ck
        if isinstance(cc, Plus):                # (x+)? = x*
            return _canon(Star(cc.child))
        if isinstance(cc, Opt):                 # (x?)? = x?
            cc, ck = cc.child, _canon(cc.child)[1]
        return Opt(cc), f"?({ck})"
    raise TypeError(r)


def canonicalize(r: Rpq) -> Rpq:
    """Canonical, hash-consed form of ``r`` (same language as ``r``)."""
    node, key = _canon(r)
    hit = _intern.get(key)
    if hit is not None:
        return hit
    if len(_intern) < _INTERN_CAP:
        _intern[key] = node
    return node


def canonical_key(r: Rpq) -> str:
    """Stable string key of the canonical form (plan/result cache key)."""
    return _canon(r)[1]


# ------------------------------------------------------------ wire format
def unparse(r: Rpq) -> str:
    """Infix text ``parse`` accepts: ``(l0|l1)* . l2+``.  Parenthesizes
    by precedence (alternation < concatenation < postfix closures), so
    ``parse(unparse(r))`` is structurally equal to ``r`` up to
    canonicalization — the fleet wire contract."""
    def go(r: Rpq, prec: int) -> str:
        if isinstance(r, Sym):
            return f"l{r.index}"
        if isinstance(r, Alt):
            s = " | ".join(go(c, 1) for c in r.children)
            return f"({s})" if prec > 0 else s
        if isinstance(r, Cat):
            s = " . ".join(go(c, 2) for c in r.children)
            return f"({s})" if prec > 1 else s
        mark = {Star: "*", Plus: "+", Opt: "?"}[type(r)]
        return f"{go(r.child, 3)}{mark}"
    return go(r, 0)


def _tokenise(text: str):
    tokens, i = [], 0
    while i < len(text):
        ch = text[i]
        if ch.isspace():
            i += 1
        elif ch in "|.*+?()":
            tokens.append(ch)
            i += 1
        elif ch == "l" and i + 1 < len(text) and text[i + 1].isdigit():
            j = i + 1
            while j < len(text) and text[j].isdigit():
                j += 1
            tokens.append(text[i:j])
            i = j
        elif ch.isdigit():
            j = i
            while j < len(text) and text[j].isdigit():
                j += 1
            tokens.append("l" + text[i:j])
            i = j
        else:
            raise ValueError(f"bad character {ch!r} in RPQ {text!r}")
    return tokens


def parse(text: str) -> Rpq:
    """Parse ``"(l0 | l1)* . l2"`` into an AST.  Concatenation binds
    tighter than ``|``; postfix ``*``/``+``/``?`` tighter still; the
    ``.`` separator is optional (``l0 l1`` ≡ ``l0 . l1``)."""
    tokens = _tokenise(text)
    pos = 0

    def peek():
        return tokens[pos] if pos < len(tokens) else None

    def take(expected=None):
        nonlocal pos
        if pos >= len(tokens):
            raise ValueError("unexpected end of RPQ")
        tok = tokens[pos]
        if expected is not None and tok != expected:
            raise ValueError(f"expected {expected!r}, got {tok!r}")
        pos += 1
        return tok

    def parse_alt():
        parts = [parse_cat()]
        while peek() == "|":
            take("|")
            parts.append(parse_cat())
        return parts[0] if len(parts) == 1 else Alt(tuple(parts))

    def parse_cat():
        parts = [parse_postfix()]
        while True:
            tok = peek()
            if tok == ".":
                take(".")
                parts.append(parse_postfix())
            elif tok == "(" or (tok is not None and tok.startswith("l")):
                parts.append(parse_postfix())   # juxtaposition
            else:
                break
        return parts[0] if len(parts) == 1 else Cat(tuple(parts))

    def parse_postfix():
        node = parse_atom()
        while peek() in ("*", "+", "?"):
            node = {"*": Star, "+": Plus, "?": Opt}[take()](node)
        return node

    def parse_atom():
        tok = peek()
        if tok == "(":
            take("(")
            node = parse_alt()
            take(")")
            return node
        if tok is None:
            raise ValueError("unexpected end of RPQ")
        take()
        if tok.startswith("l") and tok[1:].isdigit():
            return Sym(int(tok[1:]))
        raise ValueError(f"bad token {tok!r}")

    node = parse_alt()
    if pos != len(tokens):
        raise ValueError(f"trailing tokens: {tokens[pos:]}")
    return node


# ------------------------------------------------------------ Glushkov NFA
@dataclasses.dataclass(frozen=True)
class Nfa:
    """Glushkov automaton of one RPQ, dense-table form for the engine.

    States are ``0`` (start) plus one per ``Sym`` occurrence, ``n_states
    <= 32`` so a state subset packs into one uint32.  ``tab[a][q]`` is
    the bitmask of states reached from ``q`` on label ``a``;
    ``rtab[a][p]`` the reverse relation (states that reach ``p`` on
    ``a``) for the backward frontier.  No ε-transitions: ``nullable``
    alone decides the empty word (``u == v`` queries)."""
    n_states: int
    n_labels: int
    nullable: bool
    accept: int                 # uint32 bitmask of accepting states
    tab: np.ndarray             # [n_labels, 32] uint32
    rtab: np.ndarray            # [n_labels, 32] uint32

    @property
    def start(self) -> int:
        return 1                # bit 0


def compile_nfa(r: Rpq, n_labels: int) -> Nfa:
    """Glushkov construction: position automaton over the ``Sym``
    occurrences of ``r``.  Raises if ``r`` has 32+ occurrences (a subset
    must fit one uint32 plane lane).  Labels ``>= n_labels`` cannot
    label any graph edge, so their transitions are simply dropped —
    the sub-language using them is unmatchable."""
    positions: list = []        # position id-1 -> label

    def build(r: Rpq):
        """Return (nullable, first, last, follow-pairs) with positions
        numbered 1.. in occurrence order."""
        if isinstance(r, Sym):
            positions.append(r.index)
            p = len(positions)  # ids start at 1; 0 is the start state
            return False, {p}, {p}, []
        if isinstance(r, Cat):
            nul, first, last, fol = True, set(), set(), []
            for c in r.children:
                cn, cf, cl, cfol = build(c)
                fol += cfol
                fol += [(q, p) for q in last for p in cf]
                if nul:
                    first |= cf
                last = (last | cl) if cn else cl
                nul = nul and cn
            return nul, first, last, fol
        if isinstance(r, Alt):
            nul, first, last, fol = False, set(), set(), []
            for c in r.children:
                cn, cf, cl, cfol = build(c)
                nul = nul or cn
                first |= cf
                last |= cl
                fol += cfol
            return nul, first, last, fol
        cn, cf, cl, cfol = build(r.child)
        if isinstance(r, Opt):
            return True, cf, cl, cfol
        loop = [(q, p) for q in cl for p in cf]
        if isinstance(r, Star):
            return True, cf, cl, cfol + loop
        return cn, cf, cl, cfol + loop      # Plus

    nul, first, last, fol = build(r)
    n_states = len(positions) + 1
    if n_states > MAX_STATES:
        raise ValueError(
            f"RPQ has {len(positions)} label occurrences; the packed "
            f"product executor supports at most {MAX_STATES - 1}")
    tab = np.zeros((n_labels, MAX_STATES), dtype=np.uint32)
    rtab = np.zeros((n_labels, MAX_STATES), dtype=np.uint32)

    def link(q: int, p: int) -> None:
        a = positions[p - 1]
        if a < n_labels:
            tab[a][q] |= np.uint32(1 << p)
            rtab[a][p] |= np.uint32(1 << q)

    for p in first:
        link(0, p)
    for q, p in set(fol):
        link(q, p)
    accept = (1 if nul else 0)
    for p in last:
        accept |= 1 << p
    return Nfa(n_states=n_states, n_labels=int(n_labels), nullable=nul,
               accept=accept, tab=tab, rtab=rtab)


# --------------------------------------------- reference matcher (oracle)
def matches(r: Rpq, word) -> bool:
    """Span-based regex membership, independent of ``compile_nfa`` —
    the cross-check the NFA (and everything downstream of it) is tested
    against.  O(|r| · |word|²) sets of end positions."""
    word = tuple(int(a) for a in word)
    n = len(word)

    def ends(r: Rpq, starts: frozenset) -> frozenset:
        """End positions of matches of ``r`` beginning at any of
        ``starts``."""
        if isinstance(r, Sym):
            return frozenset(i + 1 for i in starts
                             if i < n and word[i] == r.index)
        if isinstance(r, Cat):
            cur = starts
            for c in r.children:
                cur = ends(c, cur)
            return cur
        if isinstance(r, Alt):
            out: frozenset = frozenset()
            for c in r.children:
                out |= ends(c, starts)
            return out
        if isinstance(r, Opt):
            return starts | ends(r.child, starts)
        # Star / Plus: closure of the child relation
        seen = ends(r.child, starts)
        frontier = seen
        while frontier:
            nxt = ends(r.child, frontier) - seen
            seen |= nxt
            frontier = nxt
        return seen | starts if isinstance(r, Star) else seen

    return n in ends(r, frozenset((0,)))


# ------------------------------------------------------- DNF lowering
def _star_body_labels(body: Rpq):
    """Labels of a star body that is a ``Sym`` or an ``Alt`` of ``Sym``s;
    None if the body is anything richer."""
    if isinstance(body, Sym):
        return (body.index,)
    if isinstance(body, Alt) and all(isinstance(c, Sym)
                                     for c in body.children):
        return tuple(c.index for c in body.children)
    return None


def lower_to_pattern(r: Rpq, n_labels: int):
    """Exact DNF lowering of the index-expressible fragment, or None.

    Expressible: ``A_1* | A_2* | … | A_k*`` (each ``A_i`` a label or a
    label alternation), including the bare single star — the RPQ
    spelling of (a union of) LCR queries.  Exactness: a word lies in
    ``A*`` iff its letter *set* is a subset of ``A``, which is precisely
    ``pattern.lcr(A)``'s one DNF term (require=∅, forbid=ζ∖A); order
    never matters inside a single star of atoms, so nothing richer than
    set logic is being smuggled through.  Labels >= ``n_labels`` cannot
    label a graph edge and are dropped from the allowed set (the words
    using them are unmatchable).  Anything outside the fragment returns
    None and must run the automaton-product executor."""
    r = canonicalize(r)
    stars = r.children if isinstance(r, Alt) else (r,)
    terms = []
    for s in stars:
        if not isinstance(s, Star):
            return None
        labs = _star_body_labels(s.child)
        if labs is None:
            return None
        allowed = sorted(a for a in set(labs) if a < n_labels)
        terms.append(pat.lcr(allowed, n_labels))
    return pat.canonicalize(terms[0] if len(terms) == 1
                            else pat.Or(tuple(terms)))


def approx_pattern(r: Rpq, n_labels: int, max_require: int | None = None):
    """Set-logic over-approximation of ``r`` for the TDR filter cascade:
    a single-term pattern implied by the RPQ, so a FALSE verdict on it
    refutes the RPQ (order-blind, so TRUE proves nothing).  Returns
    ``(pattern, feasible)``: ``feasible=False`` means some *required*
    label cannot exist on any edge (``>= n_labels``) — no non-empty
    path matches, and only ε (``u == v`` + nullable) can answer True."""
    req = sorted(required_alphabet(r))
    if any(a >= n_labels for a in req):
        return pat.And(()), False
    if max_require is not None and len(req) > max_require:
        req = req[:max_require]     # dropping requirements is sound
    allowed = {a for a in alphabet(r) if a < n_labels}
    banned = sorted(set(range(n_labels)) - allowed)
    parts = [pat.label(a) for a in req] + \
        [pat.not_(pat.label(b)) for b in banned]
    return pat.canonicalize(pat.And(tuple(parts))), True
