"""Port semiring kinds against the JAX package: the semiring algebra, the
lane closure, and ``dist_batch`` / ``witness`` / ``count_routes`` /
``answer_mixed`` on the reference's own 48-vertex test graphs.  The same
numpy-seeded queries go through both packages; answers, witness paths and
``QueryStats.exact_rounds`` are compared exactly (the values are
integers), and equal the port's own ``dfs_baseline`` oracles.  Where the
JAX package reaches Pallas it runs as its own tests run it on the CPU
(``backend="pallas"``)."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _qgen import mixed_queries, rpq_queries
from repro.core import (bitset as rbitset, engine as reng, graph as RG,
                        pattern as RP, rpq as RR, semiring as RS,
                        tdr_build as RB, tdr_query as RQ)
from repro.kernels import ops as rops
from repro_torch import (bitset, dfs_baseline, engine, graph as G, pattern,
                         rpq, tdr_build, tdr_query)
from repro_torch.kernels import ops
from repro_torch.semiring import (BOOLEAN, COUNT, COUNT_CAP, DIST8, DIST16,
                                  by_name)

# port backend -> the JAX package's backend running the same core
BACKENDS = {"segment": "segment", "matmul": "pallas"}
LANE_SRS = [DIST16, DIST8, COUNT]


def to_port(p):
    """The reference pattern AST rebuilt from the port's classes."""
    name = type(p).__name__
    if name == "Label":
        return pattern.Label(p.index)
    if name == "Not":
        return pattern.Not(to_port(p.child))
    return getattr(pattern, name)(tuple(to_port(c) for c in p.children))


def _port_qs(qs):
    return [(u, v, to_port(p)) + tuple(rest) for (u, v, p, *rest) in qs]


GRAPH_SPECS = (("er", 1.6, 1), ("er", 2.4, 2), ("pa", 2.0, 3),
               ("pa", 3.0, 4))


@functools.lru_cache(maxsize=None)
def _case(gi):
    """(ref graph, ref index, port graph, port index) of test graph gi."""
    kind, deg, seed = GRAPH_SPECS[gi]
    rg = RG.random_graph(kind, 48, deg, 4, seed=seed)
    g = G.random_graph(kind, 48, deg, 4, seed=seed)
    return (rg, RB.build_index(rg), g,
            tdr_build.build_index(g, device="cpu"))


def _lanes_np(t: torch.Tensor, sr) -> np.ndarray:
    """Stored port lanes -> numpy array of the reference's lane dtype
    (``sr`` a semiring or a dtype name)."""
    return t.numpy().view(np.dtype(getattr(sr, "dtype_name", sr)))


def _lanes_t(a: np.ndarray) -> torch.Tensor:
    """numpy unsigned lanes -> the port's stored lanes (same bits)."""
    view = {np.uint8: np.uint8, np.uint16: np.int16, np.uint32: np.int32}
    return torch.from_numpy(np.ascontiguousarray(a).view(
        view[a.dtype.type]))


# --------------------------------------------------------------- algebra
def test_semiring_registry_and_scalars():
    assert by_name("boolean") is BOOLEAN
    assert by_name("count") is COUNT
    with pytest.raises(ValueError):
        by_name("tropical-float")
    assert DIST16.inf == 65535 and DIST8.inf == 255
    assert DIST16.zero == DIST16.inf and DIST16.one == 0
    assert COUNT.zero == 0 and COUNT.one == 1 and COUNT.cap == COUNT_CAP
    with pytest.raises(ValueError):
        BOOLEAN.inf
    with pytest.raises(ValueError):
        COUNT.accumulate(torch.zeros(2, dtype=torch.int32),
                         torch.ones(2, dtype=torch.int32))
    for sr in (BOOLEAN, DIST16, DIST8, COUNT):
        rsr = RS.by_name(sr.name)
        for f in ("op", "dtype_name", "packed", "idempotent", "cap", "zero",
                  "one"):
            assert getattr(sr, f) == getattr(rsr, f), (sr.name, f)
        assert torch.empty(0, dtype=sr.dtype).element_size() == \
            rsr.dtype.itemsize


@pytest.mark.parametrize("sr", [BOOLEAN, DIST16, DIST8, COUNT],
                         ids=lambda s: s.name)
def test_init_defaults_to_the_card(sr):
    """``init`` makes its plane on the card unless the caller passes
    ``device="cpu"``, as every entry point does; without a card the
    default raises.  The CPU plane equals the JAX package's."""
    if torch.cuda.is_available():
        assert sr.init((2, 3)).is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sr.init((2, 3))
    got = sr.init((4, 3), device="cpu")
    assert got.dtype == sr.dtype
    np.testing.assert_array_equal(_lanes_np(got, sr),
                                  np.asarray(RS.by_name(sr.name).init((4, 3))))


@pytest.mark.parametrize("sr", LANE_SRS, ids=lambda s: s.name)
def test_lane_algebra_matches_reference_at_saturation(sr):
    """combine / extend / segment_combine / accumulate equal the JAX
    package's on lanes at 0, INF-1, INF and the COUNT cap."""
    hi = sr.zero if sr.op == "min" else sr.cap
    rng = np.random.default_rng(len(sr.name))
    edge = np.array([0, 1, hi - 1, hi], dtype=np.int64)
    a = np.concatenate([edge, rng.integers(0, hi + 1, 12)]).astype(
        sr.dtype_name)
    b = np.concatenate([edge[::-1], rng.integers(0, hi + 1, 12)]).astype(
        sr.dtype_name)
    rsr = RS.by_name(sr.name)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ta, tb = _lanes_t(a), _lanes_t(b)
    np.testing.assert_array_equal(_lanes_np(sr.combine(ta, tb), sr),
                                  np.asarray(rsr.combine(ja, jb)))
    np.testing.assert_array_equal(_lanes_np(sr.extend(ta), sr),
                                  np.asarray(rsr.extend(ja)))
    seg = rng.integers(-1, 6, a.shape[0])   # -1 and 5 are dropped
    got = sr.segment_combine(ta[:, None], torch.from_numpy(seg),
                             num_segments=5)
    want = rsr.segment_combine(ja[:, None], jnp.asarray(seg),
                               num_segments=5)
    np.testing.assert_array_equal(_lanes_np(got, sr), np.asarray(want))
    if sr.idempotent:
        r, ch = sr.accumulate(ta, tb)
        rr, rch = rsr.accumulate(ja, jb)
        np.testing.assert_array_equal(_lanes_np(r, sr), np.asarray(rr))
        assert bool(ch) == bool(rch)
    if sr.op == "min":   # INF-1 saturates to INF, INF stays INF
        assert _lanes_np(sr.extend(_lanes_t(edge[2:].astype(
            sr.dtype_name))), sr).tolist() == [hi, hi]


@pytest.mark.parametrize("backend", list(BACKENDS))
def test_boolean_closure_bit_identical(backend):
    """closure(sr=BOOLEAN) == closure() == the reference's closure plane."""
    rg = RG.random_graph("pa", 50, 2.0, 4, seed=5)
    g = G.random_graph("pa", 50, 2.0, 4, seed=5)
    eng = engine.make_engine(g, backend=backend, device="cpu")
    v_n = g.n_vertices
    kw = bitset.n_words(v_n)
    base_np = rbitset.pack_bits_np(np.eye(v_n, kw * 32, dtype=bool))
    base = bitset.np_to_words(base_np, "cpu")
    dflt, rounds = eng.closure(base)
    gen, rounds_sr = eng.closure(base, sr=BOOLEAN)
    assert torch.equal(dflt, gen) and rounds == rounds_sr
    reng_ = reng.make_engine(rg, backend=BACKENDS[backend])
    want, want_rounds = reng_.closure(jnp.asarray(base_np))
    np.testing.assert_array_equal(bitset.words_to_np(dflt),
                                  np.asarray(want))
    for u in range(0, v_n, 11):
        reach = dfs_baseline.reachable_set(g, u)
        reach[u] = True   # closure seeds the diagonal
        bits = bitset.unpack_bits(dflt[u], v_n).numpy()
        np.testing.assert_array_equal(bits, reach)


# ----------------------------------------------------------- lane kernel
@pytest.mark.parametrize("sr", LANE_SRS + ["or"],
                         ids=lambda s: getattr(s, "name", s))
def test_lane_matmul_matches_ref(sr):
    """The port's lane product (its plain version on the CPU) equals the
    reference's Pallas kernel (interpret mode) and jnp oracle, and a dense
    numpy evaluation, with lanes at INF, INF-1 and the cap."""
    op, dt = (sr.op, sr.dtype_name) if sr != "or" else ("or", "uint8")
    cap = sr.cap if sr != "or" else 0
    rng = np.random.default_rng(cap + len(dt))
    m, k, w = 24, 37, 6
    a = rbitset.pack_bits_np(rng.random((m, k)) < 0.3)
    hi = {"min": np.iinfo(dt).max, "sum": max(cap, 1),
          "or": np.iinfo(dt).max}[op]
    x = rng.integers(0, hi + 1, size=(k, w)).astype(dt)
    x[0], x[1], x[2] = hi, hi - 1, cap   # INF, INF-1 and the cap
    xp = np.pad(x, ((0, a.shape[1] * 32 - k), (0, 0)))
    got = _lanes_np(ops.frontier_step_lanes(
        bitset.np_to_words(a, "cpu"), _lanes_t(xp), op=op, cap=cap), dt)
    for mode in ("interpret", "ref"):
        want = rops.frontier_step_lanes(jnp.asarray(a), jnp.asarray(xp),
                                        op=op, cap=cap, mode=mode)
        np.testing.assert_array_equal(got, np.asarray(want), err_msg=mode)
    ab = np.unpackbits(a.view(np.uint8), axis=1,
                       bitorder="little")[:, :k].astype(bool)
    dense = np.zeros((m, w), dtype=x.dtype)
    for i in range(m):
        sel = x[ab[i]].astype(np.uint64)
        if op == "min":
            dense[i] = sel.min(axis=0) if sel.size else hi
        elif op == "or":
            dense[i] = np.bitwise_or.reduce(sel, axis=0) if sel.size else 0
        else:
            dense[i] = np.minimum(sel.sum(axis=0), cap) if sel.size else 0
    np.testing.assert_array_equal(got, dense)


@pytest.mark.parametrize("sr", [DIST16, COUNT], ids=lambda s: s.name)
def test_closure_matmul_rows_extend(sr):
    """_matmul_rows applies extend after the lane reduce: for DIST the
    result is 1 + min over the selected rows (saturating, so INF-1 gives
    INF); for COUNT it is the capped sum unchanged."""
    a = rbitset.pack_bits_np(np.array([[1, 1, 0, 0], [0, 0, 0, 0],
                                       [0, 0, 0, 1]], dtype=bool))
    top = sr.zero - 1 if sr.op == "min" else sr.cap
    x = np.array([[3], [5], [9], [top]], dtype=sr.dtype_name)
    out = engine._matmul_rows(bitset.np_to_words(a, "cpu"), _lanes_t(x),
                              sr=sr)
    got = _lanes_np(out, sr)
    want = reng._matmul_rows(jnp.asarray(a), jnp.asarray(x), "ref",
                             sr=RS.by_name(sr.name))
    np.testing.assert_array_equal(got, np.asarray(want))
    if sr.op == "min":
        assert got.tolist() == [[4], [sr.zero], [sr.zero]]
    else:
        assert got.tolist() == [[8], [0], [sr.cap]]


@pytest.mark.parametrize("backend", list(BACKENDS))
@pytest.mark.parametrize("sr", [DIST16, DIST8], ids=lambda s: s.name)
def test_lane_closure_matches_reference(backend, sr):
    """closure(sr=DIST*) converges to the reference's distance plane in
    the reference's rounds, on both backends (all-pairs hop distances
    from a diagonal of zeros)."""
    rg = RG.random_graph("er", 40, 2.0, 3, seed=7)
    g = G.random_graph("er", 40, 2.0, 3, seed=7)
    base = np.full((40, 40), sr.zero, dtype=sr.dtype_name)
    np.fill_diagonal(base, 0)
    eng = engine.make_engine(g, backend=backend, device="cpu")
    got, rounds = eng.closure(_lanes_t(base), sr=sr)
    rsr = RS.by_name(sr.name)
    want, want_rounds = reng.make_engine(
        rg, backend=BACKENDS[backend]).closure(jnp.asarray(base), sr=rsr)
    np.testing.assert_array_equal(_lanes_np(got, sr), np.asarray(want))
    assert rounds == int(want_rounds)
    one = eng.propagate(_lanes_t(base), sr=sr)
    np.testing.assert_array_equal(
        _lanes_np(one, sr), np.asarray(reng.make_engine(
            rg, backend=BACKENDS[backend]).propagate(jnp.asarray(base),
                                                     sr=rsr)))


def test_closure_refuses_count():
    g = G.erdos_renyi(10, 1.0, 2, seed=0)
    eng = engine.make_engine(g, backend="segment", device="cpu")
    with pytest.raises(ValueError, match="idempotent"):
        eng.closure(torch.zeros((10, 1), dtype=torch.int32), sr=COUNT)


# ------------------------------------------------------------------ dist
def _dist_both(gi, qs, **kw):
    """(port answers, port stats, ref answers, ref stats)."""
    rg, ridx, g, idx = _case(gi)
    backend = kw.pop("backend", "segment")
    st, rst = tdr_query.QueryStats(), RQ.QueryStats()
    got = tdr_query.dist_batch(idx, _port_qs(qs), backend=backend,
                               stats=st, device="cpu", **kw)
    want = RQ.dist_batch(ridx, qs, backend=BACKENDS[backend], stats=rst,
                         **kw)
    return got.tolist(), st, want.tolist(), rst


@pytest.mark.parametrize("backend", list(BACKENDS))
def test_dist_matches_bfs_oracle(backend):
    gi = 0 if backend == "segment" else 2
    rg, _, g, _ = _case(gi)
    qs = mixed_queries(np.random.default_rng(21), rg, 40)
    oracle = [dfs_baseline.shortest_pcr(g, u, v, p)
              for (u, v, p) in _port_qs(qs)]
    got, st, want, rst = _dist_both(gi, qs, backend=backend)
    assert got == want == oracle
    assert st.exact_rounds == rst.exact_rounds > 0
    assert (st.n_jobs, st.corridor_active) == (rst.n_jobs,
                                               rst.corridor_active)
    # k-hop bound: answers prune to -1 beyond k, never change below it
    for k in (0, 1, 3):
        got, st, want, rst = _dist_both(gi, qs, backend=backend, k=k)
        assert got == want == [d if 0 <= d <= k else -1 for d in oracle]
        assert st.exact_rounds == rst.exact_rounds


def test_dist_exact_modes_agree():
    rg, _, g, _ = _case(1)
    qs = mixed_queries(np.random.default_rng(8), rg, 24)
    oracle = [dfs_baseline.shortest_pcr(g, u, v, p)
              for (u, v, p) in _port_qs(qs)]
    for mode in ("full", "auto", "compact"):
        for backend in BACKENDS:
            got, st, want, rst = _dist_both(1, qs, exact_mode=mode,
                                            backend=backend)
            assert got == want == oracle, (mode, backend)
            assert st.exact_rounds == rst.exact_rounds, (mode, backend)
            assert st.corridor_active == rst.corridor_active


def test_dist_edge_cases():
    rg, ridx, g, idx = _case(0)
    true_p = pattern.none_of([])
    assert tdr_query.dist(idx, 3, 3, true_p, device="cpu") == 0
    assert tdr_query.dist(idx, 3, 3, pattern.all_of([0]),
                          device="cpu") == RQ.dist(ridx, 3, 3,
                                                   RP.all_of([0])) != 0
    never = pattern.none_of(list(range(g.n_labels)))
    for backend in BACKENDS:
        assert tdr_query.dist(idx, 0, 1, never, backend=backend,
                              device="cpu") == -1
    with pytest.raises(ValueError, match="exact_mode"):
        tdr_query.dist(idx, 0, 1, true_p, exact_mode="legacy", device="cpu")
    assert tdr_query.dist_batch(idx, [], device="cpu").tolist() == []


def test_dist_dense_cap_on_the_cpu_warns_and_keeps_answers():
    """On the CPU a class stack over ``max_dense_bytes`` warns and the
    chunk runs the segment core, with the same answers and rounds."""
    rg, _, g, _ = _case(2)
    idx = tdr_build.build_index(g, device="cpu")   # engines are cached
    qs = mixed_queries(np.random.default_rng(3), rg, 16)
    adj_bytes = 48 * bitset.n_words(48) * 4
    ecfg = engine.EngineConfig(backend="matmul", max_dense_bytes=adj_bytes)
    st = tdr_query.QueryStats()
    with pytest.warns(engine.DenseCapWarning):
        got = tdr_query.dist_batch(idx, _port_qs(qs), engine_config=ecfg,
                                   stats=st, device="cpu")
    _, _, want, rst = _dist_both(2, qs, backend="segment")
    assert got.tolist() == want
    assert st.exact_rounds == rst.exact_rounds


# --------------------------------------------------------------- witness
def test_witness_matches_oracle_200_cases():
    """Every witness equals the reference's path, replays edge by edge
    through the graph and has exactly the oracle's shortest length;
    unreachable pairs return None.  4 graphs x 60 queries = 240 cases."""
    rng = np.random.default_rng(99)
    reachable = 0
    for gi in range(len(GRAPH_SPECS)):
        rg, ridx, g, idx = _case(gi)
        backend = "matmul" if gi == 3 else "segment"
        for (u, v, rp), (_, _, p) in zip(*(lambda q: (q, _port_qs(q)))(
                mixed_queries(rng, rg, 60))):
            want = dfs_baseline.shortest_pcr(g, u, v, p)
            path = tdr_query.witness(idx, u, v, p, backend=backend,
                                     exact_mode="full", device="cpu")
            assert path == RQ.witness(ridx, u, v, rp, exact_mode="full",
                                      backend=BACKENDS[backend])
            if want < 0:
                assert path is None, (gi, u, v, p)
            else:
                reachable += 1
                assert len(path) == want, (gi, u, v, p)
                assert dfs_baseline.verify_witness(g, u, v, p, path)
    assert reachable >= 40


def test_witness_trivial_and_compact():
    rg, ridx, g, idx = _case(2)
    assert tdr_query.witness(idx, 7, 7, pattern.none_of([]),
                             device="cpu") == []
    qs = mixed_queries(np.random.default_rng(12), rg, 12)
    for (u, v, rp), (_, _, p) in zip(qs, _port_qs(qs)):
        full = tdr_query.witness(idx, u, v, p, exact_mode="full",
                                 device="cpu")
        auto = tdr_query.witness(idx, u, v, p, exact_mode="auto",
                                 device="cpu")
        assert auto == RQ.witness(ridx, u, v, rp, exact_mode="auto")
        if full is None:
            assert auto is None
        else:
            assert len(auto) == len(full)
            assert dfs_baseline.verify_witness(g, u, v, p, auto)


# ----------------------------------------------------------------- count
def _single_term_queries(rng, g, n):
    out = []
    while len(out) < n:
        for (u, v, p) in mixed_queries(rng, g, n):
            if len(RP.to_dnf(p)) == 1:
                out.append((u, v, p))
    return out[:n]


@pytest.mark.parametrize("backend", list(BACKENDS))
def test_count_routes_matches_oracle(backend):
    gi = 1 if backend == "segment" else 3
    rg, ridx, g, idx = _case(gi)
    qs = _single_term_queries(np.random.default_rng(31), rg, 20)
    for (u, v, rp), (_, _, p) in zip(qs, _port_qs(qs)):
        for hops in (0, 2, 5):
            want = dfs_baseline.count_routes(g, u, v, p, hops=hops,
                                             cap=COUNT_CAP)
            got = tdr_query.count_routes(idx, u, v, p, hops=hops,
                                         backend=backend, device="cpu")
            assert got == want == RQ.count_routes(
                ridx, u, v, rp, hops=hops, backend=BACKENDS[backend]), \
                (u, v, p, hops)


def test_count_saturates_at_cap():
    """A tiny cap forces clamping; the clamped DP equals the oracle's
    clamped total on every query, and the cap bites somewhere."""
    rg, ridx, g, idx = _case(3)
    qs = _single_term_queries(np.random.default_rng(44), rg, 15)
    sat = 0
    for (u, v, rp), (_, _, p) in zip(qs, _port_qs(qs)):
        want = dfs_baseline.count_routes(g, u, v, p, hops=8, cap=7)
        got = tdr_query.count_routes(idx, u, v, p, hops=8, cap=7,
                                     device="cpu")
        assert got == want == RQ.count_routes(ridx, u, v, rp, hops=8, cap=7)
        sat += want == 7
    assert sat >= 1


def test_count_rejects_multi_term():
    _, _, _, idx = _case(0)
    with pytest.raises(ValueError, match="single"):
        tdr_query.count_routes(idx, 0, 1, pattern.any_of([0, 1]), hops=3,
                               device="cpu")


def test_count_refuses_a_cap_that_could_wrap():
    """The same E'·cap < 2^32 guard as the reference's uint32
    accumulator, so both refuse the same inputs."""
    rg, ridx, g, idx = _case(0)
    cap = (1 << 32) // 64
    with pytest.raises(ValueError, match="wrap"):
        RQ.count_routes(ridx, 0, 1, RP.all_of([0]), hops=3, cap=cap,
                        exact_mode="full")
    with pytest.raises(ValueError, match="wrap"):
        tdr_query.count_routes(idx, 0, 1, pattern.all_of([0]), hops=3,
                               cap=cap, exact_mode="full", device="cpu")


# ----------------------------------------------------------- mixed kinds
def test_answer_mixed_aligns_kinds():
    rg, ridx, g, idx = _case(2)
    base = mixed_queries(np.random.default_rng(55), rg, 24)
    kinds = ["bool", "dist", "witness", "count"]
    queries = []
    for i, (u, v, p) in enumerate(base):
        kd = kinds[i % 4]
        if kd == "count" and len(RP.to_dnf(p)) != 1:
            kd = "dist"
        queries.append((u, v, p, kd))
    got = tdr_query.answer_mixed(idx, _port_qs(queries), hops=6,
                                 device="cpu")
    assert got == RQ.answer_mixed(ridx, queries, hops=6)
    for (u, v, p, kd), a in zip(_port_qs(queries), got):
        if kd == "bool":
            assert a == dfs_baseline.answer_pcr(g, u, v, p)
        elif kd == "dist":
            assert a == dfs_baseline.shortest_pcr(g, u, v, p)
        elif kd == "witness":
            w = dfs_baseline.shortest_pcr(g, u, v, p)
            assert (a is None) if w < 0 else (
                len(a) == w and dfs_baseline.verify_witness(g, u, v, p, a))
        else:
            assert a == dfs_baseline.count_routes(g, u, v, p, hops=6,
                                                  cap=COUNT_CAP)


def test_answer_mixed_routes_rpq():
    """Kind "rpq" (a regex AST in place of the pattern) batches through
    ``rpq_batch`` beside bool and dist queries: every result equals its
    oracle and the JAX package's ``answer_mixed``.  An unknown kind
    raises."""
    rg, ridx, g, idx = _case(0)
    rng = np.random.default_rng(9)
    mixed = [(u, v, p, ("bool", "dist")[i % 2])
             for i, (u, v, p) in enumerate(mixed_queries(rng, rg, 12))]
    mixed += [(u, v, r, "rpq") for (u, v, r) in rpq_queries(rng, rg, 12)]
    port = [(u, v, rpq.parse(RR.unparse(x)) if kd == "rpq" else to_port(x),
             kd) for (u, v, x, kd) in mixed]
    got = tdr_query.answer_mixed(idx, port, device="cpu")
    assert got == RQ.answer_mixed(ridx, mixed)
    for (u, v, x, kd), a in zip(port, got):
        if kd == "bool":
            assert a == dfs_baseline.answer_pcr(g, u, v, x)
        elif kd == "dist":
            assert a == dfs_baseline.shortest_pcr(g, u, v, x)
        else:
            assert a == dfs_baseline.answer_rpq(g, u, v, x)
    with pytest.raises(ValueError, match="kind"):
        tdr_query.answer_mixed(idx, [(0, 1, pattern.all_of([0]), "fuzzy")],
                               device="cpu")


def test_compile_queries_validates_kind():
    rg, ridx, g, idx = _case(0)
    with pytest.raises(ValueError, match="kind"):
        tdr_query.compile_queries(idx, [(0, 1, pattern.all_of([0]),
                                         "fuzzy")])
    qs = [(0, 1, RP.all_of([0]), "dist"), (1, 2, RP.all_of([1]))]
    plan = tdr_query.compile_queries(idx, _port_qs(qs))
    rplan = RQ.compile_queries(ridx, qs)
    assert plan.kinds == rplan.kinds and plan.kinds[-1] == "bool"
    assert plan.pad_to(8).kinds == plan.kinds
    with pytest.raises(ValueError, match="answer_mixed"):
        tdr_query.answer_plan(idx, plan)
    with pytest.raises(ValueError, match="rpq"):
        tdr_query.compile_queries(idx, [(0, 1, pattern.all_of([0]), "rpq")])
