"""The port's pattern AST / parser / DNF compiler: the reference's pattern
tests run against ``repro_torch.pattern``, and random patterns compile to
the same DNF terms and canonical keys in both packages."""
import pytest

try:
    import hypothesis as hp
    import hypothesis.strategies as st
except ImportError:  # clean container: vendored fallback (see _minihyp.py)
    import _minihyp as hp
    st = hp.strategies

from repro.core import pattern as rpat
from repro_torch import pattern as pat


def test_parse_basic():
    p = pat.parse("l0 & !(l1 | l2)")
    assert pat.evaluate(p, frozenset({0})) is True
    assert pat.evaluate(p, frozenset({0, 1})) is False
    assert pat.evaluate(p, frozenset()) is False


def test_parse_words():
    p = pat.parse("0 AND NOT (1 OR 2)")
    q = pat.parse("l0 & !(l1 | l2)")
    for bits in range(8):
        present = frozenset(i for i in range(3) if bits & (1 << i))
        assert pat.evaluate(p, present) == pat.evaluate(q, present)


def test_parse_errors():
    with pytest.raises(ValueError):
        pat.parse("l0 &")
    with pytest.raises(ValueError):
        pat.parse("(l0")


def test_dnf_simple():
    terms = pat.to_dnf(pat.parse("l0 & l1"))
    assert len(terms) == 1
    assert terms[0].require == frozenset({0, 1})
    assert terms[0].forbid == frozenset()


def test_dnf_not_of_and():
    # ¬(a ∧ b) = ¬a ∨ ¬b
    terms = pat.to_dnf(pat.parse("!(l0 & l1)"))
    assert len(terms) == 2
    assert all(not t.require for t in terms)


def test_dnf_drops_contradictions():
    assert pat.to_dnf(pat.parse("l0 & !l0")) == []


def test_lcr_pattern():
    p = pat.lcr([0, 2], 4)           # allowed {0,2} of 4 labels
    assert pat.evaluate(p, frozenset({0, 2})) is True
    assert pat.evaluate(p, frozenset({0, 1})) is False


@st.composite
def patterns(draw, depth=0):
    """A random pattern as text, so each package parses its own."""
    if depth > 3 or draw(st.booleans()):
        lbl = f"l{draw(st.integers(0, 4))}"
        return f"!{lbl}" if draw(st.booleans()) else lbl
    kind = draw(st.sampled_from(["and", "or", "not"]))
    if kind == "not":
        return f"!({draw(patterns(depth=depth + 1))})"
    kids = draw(st.lists(patterns(depth=depth + 1), min_size=1, max_size=3))
    return "(" + (" & " if kind == "and" else " | ").join(kids) + ")"


@hp.given(patterns())
@hp.settings(max_examples=100, deadline=None)
def test_dnf_equivalent_to_pattern(txt):
    """The DNF is equivalent to the pattern, and it, the canonical key
    and the unparsed text equal the JAX package's."""
    p, rp = pat.parse(txt), rpat.parse(txt)
    terms = pat.to_dnf(p)
    assert pat.dnf_equivalent(p, terms, 5)
    assert [(t.require, t.forbid) for t in terms] == \
        [(t.require, t.forbid) for t in rpat.to_dnf(rp)]
    assert pat.unparse(p) == rpat.unparse(rp)
    assert pat.unparse(pat.canonicalize(p)) == \
        rpat.unparse(rpat.canonicalize(rp))


def test_unparse_roundtrip():
    for txt in ("l0", "!(l1)", "l0 & !(l1 | l2)", "(l0 | l1) & l2"):
        p = pat.parse(txt)
        assert pat.canonical_key(pat.parse(pat.unparse(p))) == \
            pat.canonical_key(p)


def test_helper_constructors():
    p = pat.and_(pat.label(0), pat.or_(pat.label(1), pat.label(2)))
    assert pat.evaluate(p, frozenset({0, 2})) is True
    assert pat.evaluate(p, frozenset({0})) is False


def test_non_pattern_rejected():
    with pytest.raises(TypeError):
        pat.evaluate("l0", frozenset())
    with pytest.raises(TypeError):
        pat.canonicalize(42)
    with pytest.raises(TypeError):
        pat.unparse(None)


def test_parse_error_messages():
    with pytest.raises(ValueError, match="bad character"):
        pat.parse("l0 & %")
    with pytest.raises(ValueError, match="trailing"):
        pat.parse("l0 l1")
    with pytest.raises(ValueError, match="expected"):
        pat.parse("(l0 | l1 l2)")
    with pytest.raises(ValueError, match="unexpected end"):
        pat.parse("(l0 & l1")


def test_dnf_blowup_capped():
    # (l0|l1) & (l2|l3) & … distributes to 2^9 = 512 incomparable terms
    p = pat.And(tuple(pat.Or((pat.Label(2 * i), pat.Label(2 * i + 1)))
                      for i in range(9)))
    with pytest.raises(ValueError, match="blow-up"):
        pat.to_dnf(p, max_terms=256)
