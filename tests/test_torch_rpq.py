"""Port regular path queries against the JAX package: the ``rpq`` front end
(parser, canonical form, Glushkov NFA, DNF lowering, over-approximation),
the product-BFS oracle ``dfs_baseline.answer_rpq`` and the executor
``tdr_query.rpq_batch``.  The same numpy-seeded regexes go through both
packages; keys, texts, NFA tables, lowerings, answers and
``QueryStats.exact_rounds`` are compared exactly, and answers equal the
port's oracle.  Where the JAX package reaches Pallas it runs as its own
tests run it on the CPU (``backend="pallas"``)."""
import functools
import itertools

import numpy as np
import pytest
import torch

try:
    import hypothesis as hp
    import hypothesis.strategies as st
except ImportError:  # clean container: vendored fallback (see _minihyp.py)
    import _minihyp as hp
    st = hp.strategies

import _qgen
from repro.core import (graph as RG, pattern as RP, rpq as RR,
                        tdr_build as RB, tdr_query as RQ)
from repro_torch import (dfs_baseline, graph as G, pattern as pat, rpq,
                         tdr_build, tdr_query)

CFG = tdr_build.TDRConfig(vtx_bits=64, g_max=4, k=3)
RCFG = RB.TDRConfig(vtx_bits=64, g_max=4, k=3)
# port backend -> the JAX package's backend running the same core
BACKENDS = {"segment": "segment", "matmul": "pallas"}
GRAPH_SPECS = (("er", 40, 2.0, 4, 7), ("pa", 30, 2.5, 3, 11))


def to_port(r):
    """A JAX-package regex AST rebuilt from the port's classes."""
    name = type(r).__name__
    if name == "Sym":
        return rpq.Sym(r.index)
    if name in ("Cat", "Alt"):
        return getattr(rpq, name)(tuple(to_port(c) for c in r.children))
    return getattr(rpq, name)(to_port(r.child))


def _port_qs(qs):
    return [(u, v, to_port(r)) for (u, v, r) in qs]


@functools.lru_cache(maxsize=None)
def _graphs(gi):
    """(JAX-package graph, port graph) of test graph gi."""
    kind, n, deg, n_l, seed = GRAPH_SPECS[gi]
    return (RG.random_graph(kind, n, deg, n_l, seed=seed),
            G.random_graph(kind, n, deg, n_l, seed=seed))


@functools.lru_cache(maxsize=None)
def _index(gi, backend):
    return tdr_build.build_index(_graphs(gi)[1], CFG, backend=backend,
                                 device="cpu")


@functools.lru_cache(maxsize=None)
def _ref_index(gi, backend):
    return RB.build_index(_graphs(gi)[0], RCFG, backend=BACKENDS[backend])


def _case_pool(gi, seed, n):
    """The reference's case pool (JAX-package ASTs), edge cases included."""
    rg = _graphs(gi)[0]
    rng = np.random.default_rng(seed)
    qs = _qgen.rpq_queries(rng, rg, n)
    qs.append((0, 0, RR.parse("l0*")))                  # ε at u == v
    qs.append((0, 0, RR.parse("l0 . l1")))              # u == v, no ε
    qs.append((0, rg.n_vertices - 1, RR.Sym(rg.n_labels)))  # unmatchable
    qs.append((1, 2, RR.Star(RR.Sym(rg.n_labels))))     # ε-only language
    return qs


# ------------------------------------------------- 1. the oracle itself
def _enumerate_words(g, u, v, max_len):
    """Every label word along some u→v walk of length <= max_len."""
    words = set()
    stack = [(u, ())]
    while stack:
        x, w = stack.pop()
        if x == v:
            words.add(w)
        if len(w) == max_len:
            continue
        for i in range(int(g.indptr[x]), int(g.indptr[x + 1])):
            stack.append((int(g.indices[i]), w + (int(g.labels[i]),)))
    return words


@hp.given(seed=st.integers(0, 10_000))
@hp.settings(max_examples=20, deadline=None)
def test_oracle_vs_brute_force_enumeration(seed):
    """answer_rpq on tiny graphs == "some enumerated path word matches"
    (a True past the length-6 horizon is re-checked at length 10), and
    equals the JAX package's oracle."""
    from repro.core import dfs_baseline as rdfs
    rng = np.random.default_rng(seed)
    n, gseed = int(rng.integers(4, 13)), int(rng.integers(1000))
    g = G.random_graph("er", n, 1.5, 3, seed=gseed)
    r = to_port(_qgen.random_rpq(rng, g.n_labels, depth=2))
    u, v = int(rng.integers(g.n_vertices)), int(rng.integers(g.n_vertices))
    got = dfs_baseline.answer_rpq(g, u, v, r)
    assert got == rdfs.answer_rpq(RG.random_graph("er", n, 1.5, 3,
                                                  seed=gseed),
                                  u, v, RR.parse(rpq.unparse(r)))
    if any(rpq.matches(r, w) for w in _enumerate_words(g, u, v, 6)):
        assert got, f"oracle missed a short witness for {rpq.unparse(r)}"
    elif got:
        assert any(rpq.matches(r, w)
                   for w in _enumerate_words(g, u, v, 10)), \
            f"oracle claims True with no witness <= 10 ({rpq.unparse(r)})"


def test_oracle_fixed_cases():
    """Hand-checkable product-BFS cases: order sensitivity, ε, cycles."""
    g = G.Graph.from_edges(4, 2, [(0, 1, 0), (1, 2, 1), (2, 0, 0)])
    assert dfs_baseline.answer_rpq(g, 0, 2, rpq.parse("l0 . l1"))
    assert not dfs_baseline.answer_rpq(g, 0, 2, rpq.parse("l1 . l0"))
    assert dfs_baseline.answer_rpq(g, 0, 0, rpq.parse("l0*"))      # ε
    assert not dfs_baseline.answer_rpq(g, 0, 0, rpq.parse("l1+"))
    assert dfs_baseline.answer_rpq(g, 0, 0, rpq.parse("(l0.l1.l0)+"))
    assert not dfs_baseline.answer_rpq(g, 0, 2, rpq.parse("l0 . l0"))


# --------------------------------------- 2. front-end algebra + the NFA
@hp.given(seed=st.integers(0, 100_000))
@hp.settings(max_examples=100, deadline=None)
def test_parse_unparse_roundtrip(seed):
    rng = np.random.default_rng(seed)
    r = to_port(_qgen.random_rpq(rng, 4, depth=4))
    text = rpq.unparse(r)
    back = rpq.parse(text)
    assert back == r, f"{text!r} reparsed as {rpq.unparse(back)!r}"
    assert rpq.canonical_key(back) == rpq.canonical_key(r)


def test_parse_precedence_and_parens():
    assert rpq.parse("l0 | l1 . l2") == rpq.Alt(
        (rpq.Sym(0), rpq.Cat((rpq.Sym(1), rpq.Sym(2)))))
    assert rpq.parse("(l0 | l1) . l2") == rpq.Cat(
        (rpq.Alt((rpq.Sym(0), rpq.Sym(1))), rpq.Sym(2)))
    assert rpq.parse("l0 . l1*") == rpq.Cat(
        (rpq.Sym(0), rpq.Star(rpq.Sym(1))))
    assert rpq.parse("(l0 . l1)*") == rpq.Star(
        rpq.Cat((rpq.Sym(0), rpq.Sym(1))))
    assert rpq.parse("l0*+?") == rpq.Opt(rpq.Plus(rpq.Star(rpq.Sym(0))))
    assert rpq.parse("l0 l1") == rpq.parse("l0 . l1")   # juxtaposition
    assert rpq.parse("0 1") == rpq.parse("l0 . l1")     # bare digits
    for bad in ("", "l0 |", "(l0", "l0)", "*l0", "l0 & l1", "lx"):
        with pytest.raises(ValueError):
            rpq.parse(bad)


@hp.given(seed=st.integers(0, 100_000))
@hp.settings(max_examples=60, deadline=None)
def test_canonicalize_idempotent_language_preserving(seed):
    rng = np.random.default_rng(seed)
    r = to_port(_qgen.random_rpq(rng, 3, depth=3))
    c = rpq.canonicalize(r)
    assert rpq.canonicalize(c) is rpq.canonicalize(r)   # interned + stable
    assert rpq.canonical_key(c) == rpq.canonical_key(r)
    for n in range(4):
        for w in itertools.product(range(3), repeat=n):
            assert rpq.matches(c, w) == rpq.matches(r, w), \
                f"canonicalize changed L({rpq.unparse(r)}) at {w}"


@hp.given(seed=st.integers(0, 100_000))
@hp.settings(max_examples=60, deadline=None)
def test_nfa_equals_span_matcher(seed):
    """compile_nfa (what every executor runs) vs the independent span
    matcher, all words up to length 4."""
    rng = np.random.default_rng(seed)
    r = to_port(_qgen.random_rpq(rng, 3, depth=3))
    nfa = rpq.compile_nfa(r, 3)
    assert nfa.nullable == rpq.matches(r, ())
    assert bool(nfa.accept & 1) == nfa.nullable
    for n in range(5):
        for w in itertools.product(range(3), repeat=n):
            s = np.uint32(nfa.start)
            for a in w:
                ns = np.uint32(0)
                for q in range(nfa.n_states):
                    if (int(s) >> q) & 1:
                        ns |= nfa.tab[a][q]
                s = ns
            assert bool(int(s) & nfa.accept) == rpq.matches(r, w)


def test_nfa_state_cap():
    wide = rpq.Cat(tuple(rpq.Sym(0) for _ in range(40)))
    with pytest.raises(ValueError, match="at most"):
        rpq.compile_nfa(wide, 2)


@pytest.mark.parametrize("seed", range(4))
def test_front_end_equals_reference(seed):
    """On random regexes (out-of-alphabet atoms included) both packages
    give the same canonical key, text, NFA tables and accept mask,
    lowering and over-approximation."""
    rng = np.random.default_rng(300 + seed)
    n_l = 4
    for _ in range(50):
        rr = _qgen.random_rpq(rng, n_l, depth=4)
        r = to_port(rr)
        assert rpq.canonical_key(r) == RR.canonical_key(rr)
        assert rpq.unparse(r) == RR.unparse(rr)
        assert rpq.alphabet(r) == RR.alphabet(rr)
        assert rpq.required_alphabet(r) == RR.required_alphabet(rr)
        try:
            want = RR.compile_nfa(rr, n_l)
        except ValueError:
            with pytest.raises(ValueError, match="at most"):
                rpq.compile_nfa(r, n_l)
            continue
        got = rpq.compile_nfa(r, n_l)
        assert (got.n_states, got.nullable, got.accept) == \
            (want.n_states, want.nullable, want.accept)
        assert got.tab.dtype == np.uint32 == want.tab.dtype
        assert np.array_equal(got.tab, want.tab)
        assert np.array_equal(got.rtab, want.rtab)
        low, rlow = rpq.lower_to_pattern(r, n_l), RR.lower_to_pattern(rr, n_l)
        assert (low is None) == (rlow is None)
        if low is not None:
            assert pat.canonical_key(low) == RP.canonical_key(rlow)
        for mr in (None, 2):
            (ap, feas), (rap, rfeas) = (rpq.approx_pattern(r, n_l, mr),
                                        RR.approx_pattern(rr, n_l, mr))
            assert feas == rfeas
            assert pat.canonical_key(ap) == RP.canonical_key(rap)


# ------------------------------------------------------- 3. the rewriter
@hp.given(seed=st.integers(0, 100_000))
@hp.settings(max_examples=80, deadline=None)
def test_rewriter_language_equality(seed):
    """Whenever the rewriter claims a regex is index-expressible, the
    lowering is language-EQUAL on every word up to length 4."""
    rng = np.random.default_rng(seed)
    n_l = 3
    r = to_port(_qgen.random_rpq(rng, n_l, depth=3))
    p = rpq.lower_to_pattern(r, n_l)
    if p is None:
        return
    for n in range(5):
        for w in itertools.product(range(n_l), repeat=n):
            assert pat.evaluate(p, frozenset(w)) == rpq.matches(r, w), \
                f"lowering {pat.unparse(p)!r} of {rpq.unparse(r)!r} " \
                f"differs at word {w}"


def test_rewriter_fragment_boundaries():
    """The expressible fragment is exactly unions of single-atom stars;
    order/count-constrained shapes route to the product executor."""
    n_l = 4
    for s in ["l0*", "(l0|l1)*", "(l0|l1)* | l2*", "(l0*)*",
              "(l0* | l1)*", "l0* | l0*"]:
        assert rpq.lower_to_pattern(rpq.parse(s), n_l) is not None, s
    for s in ["l0", "l0 . l1", "(l0.l1)*", "l0+", "l0?", "l0* . l1*",
              "l0 | l1*", "(l0|l1.l2)*"]:
        assert rpq.lower_to_pattern(rpq.parse(s), n_l) is None, s
    g = G.Graph.from_edges(3, 2, [(0, 1, 0), (1, 2, 1)])
    idx = tdr_build.build_index(g, CFG, device="cpu")
    assert tdr_query.answer_rpq(idx, 0, 2, rpq.parse("l0 . l1"),
                                device="cpu")
    assert not tdr_query.answer_rpq(idx, 0, 2, rpq.parse("l1 . l0"),
                                    device="cpu")


def test_lcr_as_rpq_bit_for_bit():
    """(a|b|…)* asked as an RPQ returns the same array as the LCR pattern
    path, the oracle and the JAX package."""
    for gi in range(len(GRAPH_SPECS)):
        rg, g = _graphs(gi)
        idx = _index(gi, "segment")
        rng = np.random.default_rng(100 + gi)
        rpq_qs, pat_qs, ref_qs = [], [], []
        for _ in range(20):
            u = int(rng.integers(g.n_vertices))
            v = int(rng.integers(g.n_vertices))
            labs = sorted(set(rng.integers(0, g.n_labels, size=2).tolist()))
            rpq_qs.append((u, v, rpq.lcr(labs, g.n_labels)))
            pat_qs.append((u, v, pat.lcr(labs, g.n_labels)))
            ref_qs.append((u, v, RR.lcr(labs, rg.n_labels)))
        got = tdr_query.rpq_batch(idx, rpq_qs, device="cpu")
        want = tdr_query.answer_batch(idx, pat_qs, device="cpu")
        assert got.tolist() == want.tolist()
        assert got.tolist() == [dfs_baseline.answer_pcr(g, u, v, p)
                                for u, v, p in pat_qs]
        ref = RQ.rpq_batch(_ref_index(gi, "segment"), ref_qs)
        assert got.tolist() == ref.tolist()


# ------------------------------------------------------ 4. the executors
@functools.lru_cache(maxsize=None)
def _reference_run(gi, backend):
    """The JAX package's answers and rounds on the case pool (default
    mode and unroll), and the port's oracle."""
    qs = _case_pool(gi, seed=1000 + gi, n=110)
    stats = RQ.QueryStats()
    ans = RQ.rpq_batch(_ref_index(gi, backend), qs,
                       backend=BACKENDS[backend], stats=stats)
    g = _graphs(gi)[1]
    oracle = [dfs_baseline.answer_rpq(g, u, v, r) for u, v, r in
              _port_qs(qs)]
    return qs, ans.tolist(), stats.exact_rounds, oracle


@pytest.mark.parametrize("exact_mode", ["auto", "compact", "full"])
@pytest.mark.parametrize("backend", ["segment", "matmul"])
def test_executor_vs_oracle_200_cases(backend, exact_mode):
    """The acceptance sweep: >= 200 generated (graph, query) cases per
    backend and exact mode, at every ``q_unroll``: answers equal the
    oracle and the JAX package's, and on the default mode and unroll so
    do the phase-2 round counts."""
    total = 0
    for gi in range(len(GRAPH_SPECS)):
        qs, ref, ref_rounds, oracle = _reference_run(gi, backend)
        assert ref == oracle
        idx = _index(gi, backend)
        for q_u in (None, 4, 8, 16, 32):
            stats = tdr_query.QueryStats()
            got = tdr_query.rpq_batch(idx, _port_qs(qs), backend=backend,
                                      exact_mode=exact_mode, q_unroll=q_u,
                                      stats=stats, device="cpu")
            assert got.tolist() == oracle, \
                [(u, v, RR.unparse(r)) for (u, v, r), a, b in zip(
                    qs, got.tolist(), oracle) if a != b][:5]
            if exact_mode == "auto" and q_u is None:
                assert stats.exact_rounds == ref_rounds
        total += len(qs)
    assert total >= 200


def test_exact_modes_agree():
    """Every mode equals the oracle; "legacy", which the JAX package
    refuses for rpq too, raises."""
    gi = 0
    qs = _port_qs(_case_pool(gi, seed=5, n=24))
    g = _graphs(gi)[1]
    idx = _index(gi, "segment")
    want = [dfs_baseline.answer_rpq(g, u, v, r) for u, v, r in qs]
    for mode in ("auto", "compact", "full"):
        assert tdr_query.rpq_batch(idx, qs, exact_mode=mode,
                                   device="cpu").tolist() == want, mode
    with pytest.raises(ValueError, match="exact_mode"):
        tdr_query.rpq_batch(idx, qs, exact_mode="legacy", device="cpu")
    with pytest.raises(ValueError, match="q_unroll"):
        tdr_query.rpq_batch(idx, qs, q_unroll=12, device="cpu")


def test_dense_cap_on_the_cpu_warns_and_keeps_answers():
    """On the CPU a product chunk whose label-class stack is over
    ``max_dense_bytes`` warns and runs the segment core, with the same
    answers and rounds (on a card it raises; ``test_torch_cuda.py``)."""
    from repro_torch import bitset, engine
    gi = 0
    qs, ref, ref_rounds, oracle = _reference_run(gi, "matmul")
    g = _graphs(gi)[1]
    ecfg = engine.EngineConfig(
        backend="matmul",
        max_dense_bytes=g.n_vertices * bitset.n_words(g.n_vertices) * 4)
    idx = tdr_build.build_index(g, CFG, engine_config=ecfg, device="cpu")
    st = tdr_query.QueryStats()
    with pytest.warns(engine.DenseCapWarning):
        got = tdr_query.rpq_batch(idx, _port_qs(qs), engine_config=ecfg,
                                  stats=st, device="cpu")
    assert got.tolist() == oracle
    assert st.exact_rounds == ref_rounds


@pytest.mark.parametrize("backend", ["segment", "matmul"])
def test_thirty_two_state_nfa_uses_bit_31(backend):
    """A regex with 31 label occurrences has 32 NFA states, so state 31
    is the sign bit of the int32 planes and of ``accept``; a chain graph
    spelling the word answers True through it, one letter short False."""
    word = [i % 3 for i in range(31)]
    edges = [(i, i + 1, a) for i, a in enumerate(word)] + [(31, 0, 3)]
    g = G.Graph.from_edges(33, 4, edges)
    r = rpq.Cat(tuple(rpq.Sym(a) for a in word))
    nfa = rpq.compile_nfa(r, 4)
    assert nfa.n_states == 32 and nfa.accept == 1 << 31
    idx = tdr_build.build_index(g, CFG, backend=backend, device="cpu")
    short = rpq.Cat(tuple(rpq.Sym(a) for a in word[:30]))
    qs = [(0, 31, r), (0, 30, r), (0, 30, short), (1, 31, r),
          (31, 30, rpq.Cat((rpq.Sym(3),) + short.children))]
    want = [dfs_baseline.answer_rpq(g, u, v, x) for u, v, x in qs]
    assert want == [True, False, True, False, True]
    for mode in ("auto", "full"):
        got = tdr_query.rpq_batch(idx, qs, backend=backend, exact_mode=mode,
                                  device="cpu")
        assert got.tolist() == want, mode
    ref = RQ.rpq_batch(RB.build_index(RG.Graph.from_edges(33, 4, edges),
                                      RCFG, backend=BACKENDS[backend]),
                       [(u, v, RR.parse(rpq.unparse(x))) for u, v, x in qs],
                       backend=BACKENDS[backend])
    assert ref.tolist() == want


@pytest.mark.parametrize("q_u", [4, 8, 16, 32])
def test_nfa_byte_lookup_equals_unroll(q_u):
    """The executors' byte-lookup NFA step equals the reference's plain
    q_u-way unroll bit for bit, on words with every bit live (bit 31
    included) and tables of random words, per label row and per class
    row."""
    rng = np.random.default_rng(q_u)
    r_n, j_n, e_n = 5, 7, 300
    tabs = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (r_n, j_n, 32),
                                         dtype=np.int64).astype(np.int32))
    masks = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (e_n, j_n),
                                          dtype=np.int64).astype(np.int32))
    masks[0] = -1                               # every bit
    masks[1] = -2 ** 31                         # bit 31 alone
    masks[2] = 0
    rows = torch.from_numpy(rng.integers(0, r_n, e_n))
    nb = -(-q_u // 8)
    lut = tdr_query._nfa_luts(tabs, q_u).reshape(-1)
    got = tdr_query._nfa_apply_lut(
        masks, tdr_query._lut_bases(rows, j_n, nb), lut)
    want = tdr_query._nfa_apply(masks, tabs[rows], q_u)
    assert torch.equal(got, want)
    # stacked class rows [C, V, J] with a class-row base [C, 1, J]
    stacked = masks[:r_n * 60].reshape(r_n, 60, j_n)
    got_c = tdr_query._nfa_apply_lut(
        stacked, tdr_query._lut_bases(torch.arange(r_n)[:, None], j_n, nb),
        lut)
    want_c = tdr_query._nfa_apply(stacked, tabs[:, None], q_u)
    assert torch.equal(got_c, want_c)
    assert torch.equal(tdr_query._or_reduce0(got_c),
                       functools.reduce(torch.bitwise_or, got_c.unbind(0)))


def test_nfa_meet_equals_sup_need_meet():
    """The executors' one-AND meet equals the reference's ``_meet`` with
    ``_rpq_sup_need``'s table, bit 31 included."""
    rng = np.random.default_rng(3)
    f = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (50, 9),
                                      dtype=np.int64).astype(np.int32))
    b = torch.from_numpy((1 << rng.integers(0, 32, (50, 9))).astype(
        np.int64).astype(np.uint32).view(np.int32))
    f[:, 0] = 0
    f[:, 1] = -2 ** 31
    b[:, 1] = -2 ** 31
    want = tdr_query._meet(f, b, tdr_query._rpq_sup_need(9))
    assert torch.equal(tdr_query._rpq_meet(f, b), want)
    assert not want[0] and want[1]


def test_compile_queries_rejects_rpq_kind():
    idx = _index(0, "segment")
    with pytest.raises(ValueError, match="rpq"):
        tdr_query.compile_queries(idx, [(0, 1, pat.label(0), "rpq")])


def test_rpq_rows_cached():
    idx = _index(0, "segment")
    stats = tdr_query.QueryStats()
    r1 = rpq.parse("l0 . (l1 | l2)*")
    r2 = rpq.parse("l0 (l2 | l1)*")     # same canonical form
    tdr_query.rpq_rows(idx, r1, stats=stats)
    tdr_query.rpq_rows(idx, r2, stats=stats)
    assert stats.plan_lookups == 2
    assert stats.plan_misses <= 1
    rows = tdr_query.rpq_rows(idx, r1)
    assert rows.lowered is None and rows.feasible
    assert rows.n_terms == 1
    # the kind-keyed LRU: a pattern and a regex with one key text stay
    # two entries
    tdr_query.pattern_rows(idx, pat.label(0))
    tdr_query.rpq_rows(idx, rpq.parse("l0"))
    keys = [k for k in idx._plan_cache if k[0] == "l0"]
    assert sorted(k[2] for k in keys) == ["bool", "rpq"]


# --------------------------------------------------- API edges & errors
def test_constructor_helpers_and_nullable():
    assert rpq.cat(rpq.sym(0)) == rpq.Sym(0)
    r2 = rpq.cat(rpq.sym(0), rpq.sym(1))
    assert isinstance(r2, rpq.Cat) and not rpq.nullable(r2)
    assert rpq.nullable(rpq.star(rpq.sym(0)))
    assert rpq.nullable(rpq.opt(rpq.sym(1)))
    assert not rpq.nullable(rpq.plus(rpq.sym(1)))
    assert rpq.nullable(rpq.plus(rpq.star(rpq.sym(0))))
    assert not rpq.nullable(rpq.sym(0))
    assert rpq.nullable(rpq.cat(rpq.star(rpq.sym(0)), rpq.opt(rpq.sym(1))))
    assert rpq.nullable(rpq.alt(rpq.sym(0), rpq.star(rpq.sym(1))))


def test_canonicalize_error_branches():
    with pytest.raises(ValueError, match="negative"):
        rpq.canonicalize(rpq.Sym(-1))
    with pytest.raises(ValueError, match="empty concat"):
        rpq.canonicalize(rpq.Cat(()))
    with pytest.raises(ValueError, match="empty alt"):
        rpq.canonicalize(rpq.Alt(()))
    with pytest.raises(TypeError):
        rpq.canonicalize("l0")
    assert rpq.canonicalize(rpq.Cat((rpq.Sym(3),))) == rpq.Sym(3)


def test_parse_truncated_input():
    with pytest.raises(ValueError, match="unexpected end"):
        rpq.parse("(l0 | l1")
    with pytest.raises(ValueError, match="bad character"):
        rpq.parse("l0 & l1")


def test_approx_pattern_max_require_truncates_soundly():
    r = rpq.parse("l0 . l1 . l2 . l3")
    full, feas = rpq.approx_pattern(r, 6)
    trunc, feas2 = rpq.approx_pattern(r, 6, max_require=2)
    assert feas and feas2
    for bits in range(1 << 6):
        w = frozenset(i for i in range(6) if bits & (1 << i))
        if pat.evaluate(full, w):
            assert pat.evaluate(trunc, w)
