"""Composite patterns (paper Def. 3) — AST, parser, DNF compiler.

Framework-free; kept in step with the JAX package's ``pattern`` module so
both packages plan the same DNF terms from the same pattern.

A pattern is a propositional formula over edge labels; a path ``p`` satisfies
it iff the *set* ``S(L(p))`` of labels on the path makes the formula true
(labels present = true).  Answering PCR queries is NP-hard (paper Thm. 1,
reduction from SAT — each SAT variable maps to the presence/absence of a
label on the solution path), which is why the engine uses a lossy index as a
refutation cascade and reserves exact product-graph search for survivors.

The DNF compiler normalises any pattern into ``⋁ terms``, each term a pair
``(require, forbid)`` of label sets: a set S satisfies the term iff
``require ⊆ S`` and ``forbid ∩ S = ∅``.  The paper's query families map to:

* AND-query  ``AND{l_i}``  -> one term, require={l_i}, forbid=∅
* OR-query   ``OR{l_i}``   -> one term per label
* NOT-query  ``NOT{l_i}``  -> one term, require=∅, forbid={l_i}
  (the paper reads ``NOT`` as "all listed labels absent")
* LCR(allowed A)           -> one term, require=∅, forbid=ζ∖A

Canonicalization / hash-consing: ``canonicalize`` rewrites any pattern
into a structurally canonical form (children flattened, deduped, sorted;
double negation removed; single-child And/Or unwrapped) and interns the
result, so two syntactically different spellings of the same composite
pattern share one AST object and one ``canonical_key`` string.  The
serving layer keys its plan and result caches on that string, and
``to_dnf`` memoizes per canonical form — repeated query shapes skip DNF
expansion (and, one layer up, planning) entirely.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import FrozenSet, Sequence, Union


# ------------------------------------------------------------------- AST
@dataclasses.dataclass(frozen=True)
class Label:
    index: int


@dataclasses.dataclass(frozen=True)
class Not:
    child: "Pattern"


@dataclasses.dataclass(frozen=True)
class And:
    children: tuple


@dataclasses.dataclass(frozen=True)
class Or:
    children: tuple


Pattern = Union[Label, Not, And, Or]


def label(i: int) -> Pattern:
    """Atomic pattern: a path must carry an edge with label id ``i``."""
    return Label(i)


def and_(*ps: Pattern) -> Pattern:
    """Conjunction node over already-built pattern ASTs."""
    return And(tuple(ps))


def or_(*ps: Pattern) -> Pattern:
    """Disjunction node over already-built pattern ASTs."""
    return Or(tuple(ps))


def not_(p: Pattern) -> Pattern:
    """Negation node (the NOT operator of the paper's pattern algebra)."""
    return Not(p)


def all_of(labels: Sequence[int]) -> Pattern:
    """AND-query: the path must carry *every* label id in ``labels``."""
    return And(tuple(Label(i) for i in labels))


def any_of(labels: Sequence[int]) -> Pattern:
    """OR-query: the path must carry *some* label id in ``labels``."""
    return Or(tuple(Label(i) for i in labels))


def none_of(labels: Sequence[int]) -> Pattern:
    """NOT-query: the path must avoid *every* label id in ``labels``."""
    return And(tuple(Not(Label(i)) for i in labels))


def lcr(allowed: Sequence[int], n_labels: int) -> Pattern:
    """LCR(allowed) as a PCR pattern: every non-allowed label is forbidden."""
    banned = sorted(set(range(n_labels)) - set(allowed))
    if not banned:
        return And(())  # trivially true
    return none_of(banned)


# ------------------------------------------------------------------ eval
def evaluate(p: Pattern, present: FrozenSet[int]) -> bool:
    """Truth value of the pattern under a label-set assignment (oracle)."""
    if isinstance(p, Label):
        return p.index in present
    if isinstance(p, Not):
        return not evaluate(p.child, present)
    if isinstance(p, And):
        return all(evaluate(c, present) for c in p.children)
    if isinstance(p, Or):
        return any(evaluate(c, present) for c in p.children)
    raise TypeError(p)


def labels_of(p: Pattern) -> FrozenSet[int]:
    """Set of label ids mentioned anywhere in the pattern AST."""
    if isinstance(p, Label):
        return frozenset((p.index,))
    if isinstance(p, Not):
        return labels_of(p.child)
    return frozenset(itertools.chain.from_iterable(
        labels_of(c) for c in p.children))


# ------------------------------------------------- canonical form / intern
# key -> interned canonical AST.  Bounded: past the cap new forms are
# still canonicalized but returned un-interned (correctness is structural
# equality, interning only makes repeats cheap), so adversarial traffic
# cannot grow the table without bound.
_INTERN_CAP = 1 << 16
_intern: dict = {}


def _canon(p: Pattern) -> tuple[Pattern, str]:
    """(canonical node, canonical key).  Keys are unambiguous serialized
    forms — ``l3``, ``!(k)``, ``&(k1,k2)``, ``|(k1,k2)`` — usable both as
    cache keys and as the total order for sorting And/Or children."""
    if isinstance(p, Label):
        return p, f"l{p.index}"
    if isinstance(p, Not):
        child, ck = _canon(p.child)
        if isinstance(child, Not):          # ¬¬x = x
            return _canon(child.child)
        return Not(child), f"!({ck})"
    if isinstance(p, (And, Or)):
        op, mark = (And, "&") if isinstance(p, And) else (Or, "|")
        kids: dict[str, Pattern] = {}
        for c in p.children:
            cc, ck = _canon(c)
            if isinstance(cc, op):          # flatten nested same-op
                for gc in cc.children:
                    gcc, gck = _canon(gc)
                    kids.setdefault(gck, gcc)
            else:
                kids.setdefault(ck, cc)     # dedup by key
        if len(kids) == 1:
            (ck, cc), = kids.items()        # single child unwraps
            return cc, ck
        keys = sorted(kids)
        node = op(tuple(kids[k] for k in keys))
        return node, f"{mark}({','.join(keys)})"
    raise TypeError(p)


def canonicalize(p: Pattern) -> Pattern:
    """Canonical, hash-consed form of ``p`` (semantically equal to ``p``).

    Repeated calls with structurally equal inputs return the *same*
    object, so identity comparison and dict hashing over canonical
    patterns are cheap."""
    node, key = _canon(p)
    hit = _intern.get(key)
    if hit is not None:
        return hit
    if len(_intern) < _INTERN_CAP:
        _intern[key] = node
    return node


def canonical_key(p: Pattern) -> str:
    """Stable string key of the canonical form (plan/result cache key)."""
    return _canon(p)[1]


def unparse(p: Pattern) -> str:
    """Render ``p`` as infix text that ``parse`` accepts —
    ``parse(unparse(p))`` is structurally equal to ``p`` up to
    canonicalization, which is what wire protocols (the fleet's
    replica pipes) need to ship patterns between processes."""
    if isinstance(p, Label):
        return f"l{p.index}"
    if isinstance(p, Not):
        return f"!({unparse(p.child)})"
    if isinstance(p, (And, Or)):
        sep = " & " if isinstance(p, And) else " | "
        return "(" + sep.join(unparse(c) for c in p.children) + ")"
    raise TypeError(p)


# ---------------------------------------------------------------- parser
def parse(text: str) -> Pattern:
    """Parse ``"0 & !(1 | 2)"`` / ``"l0 AND NOT (l1 OR l2)"`` into an AST."""
    tokens = _tokenise(text)
    pos = 0

    def peek():
        return tokens[pos] if pos < len(tokens) else None

    def take(expected=None):
        nonlocal pos
        if pos >= len(tokens):
            raise ValueError("unexpected end of pattern")
        tok = tokens[pos]
        if expected is not None and tok != expected:
            raise ValueError(f"expected {expected!r}, got {tok!r}")
        pos += 1
        return tok

    def parse_or():
        node = parse_and()
        parts = [node]
        while peek() == "|":
            take("|")
            parts.append(parse_and())
        return parts[0] if len(parts) == 1 else Or(tuple(parts))

    def parse_and():
        node = parse_unary()
        parts = [node]
        while peek() == "&":
            take("&")
            parts.append(parse_unary())
        return parts[0] if len(parts) == 1 else And(tuple(parts))

    def parse_unary():
        tok = peek()
        if tok == "!":
            take("!")
            return Not(parse_unary())
        if tok == "(":
            take("(")
            node = parse_or()
            take(")")
            return node
        if tok is None:
            raise ValueError("unexpected end of pattern")
        take()
        if tok.startswith("l") and tok[1:].isdigit():
            return Label(int(tok[1:]))
        if tok.isdigit():
            return Label(int(tok))
        raise ValueError(f"bad token {tok!r}")

    node = parse_or()
    if pos != len(tokens):
        raise ValueError(f"trailing tokens: {tokens[pos:]}")
    return node


def _tokenise(text: str) -> list[str]:
    subst = {"AND": "&", "OR": "|", "NOT": "!", "and": "&", "or": "|",
             "not": "!"}
    out, i = [], 0
    while i < len(text):
        ch = text[i]
        if ch.isspace():
            i += 1
        elif ch in "&|!()":
            out.append(ch)
            i += 1
        else:
            j = i
            while j < len(text) and (text[j].isalnum() or text[j] == "_"):
                j += 1
            if j == i:      # non-word, non-operator char: never advances
                raise ValueError(f"bad character {ch!r} in pattern {text!r}")
            word = text[i:j]
            out.append(subst.get(word, word))
            i = j
    return out


# ------------------------------------------------------------------- DNF
@dataclasses.dataclass(frozen=True)
class DnfTerm:
    require: FrozenSet[int]
    forbid: FrozenSet[int]

    def satisfied_by(self, present: FrozenSet[int]) -> bool:
        return self.require <= present and not (self.forbid & present)


_DNF_CACHE_CAP = 4096
_dnf_cache: dict = {}


def to_dnf(p: Pattern, max_terms: int = 256) -> list[DnfTerm]:
    """Disjunctive normal form as (require, forbid) terms.

    Contradictory terms are dropped; terms subsumed by a weaker term are
    pruned.  ``max_terms`` bounds the classical DNF blow-up.  Results are
    memoized per canonical form, so repeated query shapes expand once.
    """
    key = (canonical_key(p), max_terms)
    hit = _dnf_cache.get(key)
    if hit is not None:
        return list(hit)
    out = _to_dnf_uncached(canonicalize(p), max_terms)
    if len(_dnf_cache) >= _DNF_CACHE_CAP:
        _dnf_cache.clear()
    _dnf_cache[key] = tuple(out)
    return out


def _to_dnf_uncached(p: Pattern, max_terms: int) -> list[DnfTerm]:
    terms = _dnf(p)
    # drop contradictions
    terms = [t for t in terms if not (t.require & t.forbid)]
    # subsumption: t1 subsumes t2 if t1.require ⊆ t2.require and
    # t1.forbid ⊆ t2.forbid (t1 is weaker -> keep t1, drop t2)
    kept: list[DnfTerm] = []
    for t in sorted(terms, key=lambda t: (len(t.require), len(t.forbid))):
        if not any(k.require <= t.require and k.forbid <= t.forbid
                   for k in kept):
            kept.append(t)
    if len(kept) > max_terms:
        raise ValueError(f"DNF blow-up: {len(kept)} terms > {max_terms}")
    return kept


def _dnf(p: Pattern) -> list[DnfTerm]:
    if isinstance(p, Label):
        return [DnfTerm(frozenset((p.index,)), frozenset())]
    if isinstance(p, Not):
        c = p.child
        if isinstance(c, Label):
            return [DnfTerm(frozenset(), frozenset((c.index,)))]
        if isinstance(c, Not):
            return _dnf(c.child)
        if isinstance(c, And):   # ¬(A∧B) = ¬A ∨ ¬B
            return _dnf(Or(tuple(Not(x) for x in c.children)))
        if isinstance(c, Or):    # ¬(A∨B) = ¬A ∧ ¬B
            return _dnf(And(tuple(Not(x) for x in c.children)))
        raise TypeError(c)
    if isinstance(p, Or):
        out: list[DnfTerm] = []
        for c in p.children:
            out.extend(_dnf(c))
        return out if p.children else [  # empty OR == false
        ]
    if isinstance(p, And):
        acc = [DnfTerm(frozenset(), frozenset())]
        for c in p.children:
            nxt: list[DnfTerm] = []
            for t1 in acc:
                for t2 in _dnf(c):
                    nxt.append(DnfTerm(t1.require | t2.require,
                                       t1.forbid | t2.forbid))
            acc = nxt
        return acc
    raise TypeError(p)


def dnf_equivalent(p: Pattern, terms: Sequence[DnfTerm],
                   n_labels: int) -> bool:
    """Brute-force equivalence check (used by property tests)."""
    labels = sorted(labels_of(p))
    for bits in itertools.product((False, True), repeat=len(labels)):
        present = frozenset(l for l, b in zip(labels, bits) if b)
        want = evaluate(p, present)
        got = any(t.satisfied_by(present) for t in terms)
        if want != got:
            return False
    return True
