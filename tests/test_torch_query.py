"""Port query path against the JAX package's ``answer_batch`` and the DFS
oracle: both port backends, every exact mode, LCR, and answers on an index
built by the JAX package and converted.  Exact equality throughout."""
import dataclasses
import functools

import numpy as np
import pytest

from repro.core import (dfs_baseline as RD, graph as RG, lcr as RL,
                        pattern as RP, tdr_build as RB, tdr_query as RQ)
from repro_torch import (bitset, convert, dfs_baseline, engine, graph as G,
                         lcr, pattern, tdr_build, tdr_query)

CFG = dict(vtx_bits=64, g_max=4, k=3)
BACKENDS = ("segment", "matmul")
STAT_FIELDS = ("n_queries", "n_jobs", "filter_false", "filter_true",
               "exact_jobs", "corridor_active", "corridor_total",
               "saturated_chunks", "exact_rounds", "exact_qids")


def _specs(rng, n_vertices, n_labels, n):
    """Endpoint and pattern specs; each package builds its own pattern."""
    out = []
    for _ in range(n):
        u, v = int(rng.integers(n_vertices)), int(rng.integers(n_vertices))
        if rng.integers(5) == 0:
            v = u   # self-queries: only cycles through u can satisfy
        kind = int(rng.integers(5))
        labs = rng.choice(n_labels, size=min(2, n_labels),
                          replace=False).tolist()
        out.append((u, v, kind, labs))
    return out


def _patterns(mod, specs, n_labels):
    def one(kind, labs):
        if kind == 0:
            return mod.all_of(labs)
        if kind == 1:
            return mod.any_of(labs)
        if kind == 2:
            return mod.none_of(labs)
        if kind == 3:
            return mod.parse(f"l{labs[0]} & !l{labs[-1]}")
        return mod.lcr(labs, n_labels)
    return [(u, v, one(kind, labs)) for u, v, kind, labs in specs]


@functools.lru_cache(maxsize=None)
def _case(kind, n, deg, seed, n_queries):
    """(ref graph, ref index, port graph, port index, specs, oracle)."""
    rg = RG.random_graph(kind, n, deg, 4, seed=seed)
    g = G.random_graph(kind, n, deg, 4, seed=seed)
    ridx = RB.build_index(rg, RB.TDRConfig(**CFG), backend="segment")
    idx = tdr_build.build_index(g, tdr_build.TDRConfig(**CFG), device="cpu")
    specs = _specs(np.random.default_rng(seed), n, 4, n_queries)
    want = [RD.answer_pcr(rg, u, v, p)
            for u, v, p in _patterns(RP, specs, 4)]
    return rg, ridx, g, idx, specs, want


def _stats_tuple(st):
    return tuple(getattr(st, f) for f in STAT_FIELDS)


@pytest.mark.parametrize("seed", [0, 5, 11])
@pytest.mark.parametrize("kind", ["er", "pa"])
def test_answer_batch_matches_oracle_both_backends(seed, kind):
    rg, ridx, g, idx, specs, want = _case(kind, 40, 2.0, seed, 20)
    rq = _patterns(RP, specs, 4)
    assert RQ.answer_batch(ridx, rq, backend="segment").tolist() == want
    pq = _patterns(pattern, specs, 4)
    assert [dfs_baseline.answer_pcr(g, u, v, p) for u, v, p in pq] == want
    for backend in BACKENDS:
        got = tdr_query.answer_batch(idx, pq, backend=backend, device="cpu")
        assert got.tolist() == want, backend


@pytest.mark.parametrize("seed", [1, 7])
@pytest.mark.parametrize("kind", ["er", "pa"])
@pytest.mark.parametrize("mode", ["auto", "compact", "full"])
def test_exact_modes_bit_equal(seed, kind, mode):
    """Every exact mode on both backends equals the oracle, and its
    QueryStats (phase-1 counts, corridor sizes, phase-2 rounds) equal the
    reference's."""
    rg, ridx, g, idx, specs, want = _case(kind, 45, 2.3, seed, 20)
    rst = RQ.QueryStats()
    RQ.answer_batch(ridx, _patterns(RP, specs, 4), backend="segment",
                    exact_mode=mode, stats=rst)
    for backend in BACKENDS:
        st = tdr_query.QueryStats()
        got = tdr_query.answer_batch(idx, _patterns(pattern, specs, 4),
                                     backend=backend, exact_mode=mode,
                                     stats=st, device="cpu")
        assert got.tolist() == want, (backend, mode)
        assert _stats_tuple(st) == _stats_tuple(rst), (backend, mode)


@pytest.mark.parametrize("backend", BACKENDS)
def test_self_cycle_queries_exact(backend):
    """u==v with required labels is satisfiable only by a cycle through u
    collecting them — exact on every executor path."""
    g = G.Graph.from_edges(5, 2, [(0, 1, 0), (1, 2, 1), (2, 0, 0),
                                  (3, 4, 1)])
    idx = tdr_build.build_index(g, tdr_build.TDRConfig(vtx_bits=32),
                                device="cpu")
    for mode in ("auto", "compact", "full"):
        assert tdr_query.answer(idx, 0, 0, pattern.all_of([0, 1]),
                                exact_mode=mode, backend=backend,
                                device="cpu") is True
        assert tdr_query.answer(idx, 3, 3, pattern.all_of([1]),
                                exact_mode=mode, backend=backend,
                                device="cpu") is False


@pytest.mark.parametrize("backend", BACKENDS)
def test_corridor_compaction_prunes_and_lazy_stats(backend):
    """On a sparse graph the corridor shrinks the expansion (occupancy <
    1), as in the reference, and the round counters sum to an int."""
    rg, ridx, g, idx, specs, want = _case("er", 120, 1.2, 5, 40)
    rst = RQ.QueryStats()
    RQ.answer_batch(ridx, _patterns(RP, specs, 4), backend="segment",
                    stats=rst)
    st = tdr_query.QueryStats()
    got = tdr_query.answer_batch(idx, _patterns(pattern, specs, 4),
                                 backend=backend, stats=st, device="cpu")
    assert got.tolist() == want
    assert st.exact_jobs > 0 and st.corridor_total > 0
    assert st.corridor_occupancy < 1.0
    assert st.compacted_chunks > 0
    assert isinstance(st.exact_rounds, int) and st.exact_rounds > 0
    assert st.phase1_s > 0 and st.phase2_s > 0
    assert _stats_tuple(st) == _stats_tuple(rst)


@pytest.mark.parametrize("seed", [2, 9])
def test_answer_lcr_batch_matches_reference(seed):
    rg, ridx, g, idx, _, _ = _case("pa", 40, 2.5, seed, 1)
    rng = np.random.default_rng(seed)
    qs = [(int(rng.integers(40)), int(rng.integers(40)),
           sorted(rng.choice(4, size=int(rng.integers(1, 4)),
                             replace=False).tolist())) for _ in range(20)]
    want = RL.answer_lcr_batch(ridx, qs).tolist()
    assert want == [RD.answer_lcr(rg, u, v, set(a)) for u, v, a in qs]
    for backend in BACKENDS:
        got = lcr.answer_lcr_batch(idx, qs, backend=backend, device="cpu")
        assert got.tolist() == want, backend


def test_p2h_lite_matches_oracle():
    """The full-index baseline equals the LCR oracle and the JAX
    package's ``P2HLite`` (the same minimal label sets) on one graph."""
    rg = RG.erdos_renyi(25, 1.5, 3, seed=4)
    g = G.erdos_renyi(25, 1.5, 3, seed=4)
    full = lcr.P2HLite.build(g)
    rfull = RL.P2HLite.build(rg)
    assert full.out == rfull.out
    assert full.size_bytes() == rfull.size_bytes()
    rng = np.random.default_rng(2)
    for _ in range(30):
        u, v = int(rng.integers(25)), int(rng.integers(25))
        allowed = rng.choice(3, size=2, replace=False).tolist()
        want = RD.answer_lcr(rg, u, v, set(allowed))
        assert full.query(u, v, allowed) == want
        assert rfull.query(u, v, allowed) == want


@pytest.mark.parametrize("over", ["adjacency", "label_classes"])
def test_dense_cap_on_the_cpu_warns_and_keeps_answers(over):
    """On the CPU a dense operand over ``max_dense_bytes`` warns and its
    work runs on the segment path with the same answers: the whole engine
    when the adjacency is over the cap, a chunk when only its label-class
    stack is."""
    rg, ridx, g, _, specs, want = _case("er", 45, 2.3, 1, 20)
    adj_bytes = g.n_vertices * bitset.n_words(g.n_vertices) * 4
    ecfg = engine.EngineConfig(
        backend="matmul",
        max_dense_bytes=adj_bytes - (over == "adjacency"))
    st = tdr_query.QueryStats()
    with pytest.warns(engine.DenseCapWarning):
        idx = tdr_build.build_index(g, tdr_build.TDRConfig(**CFG),
                                    engine_config=ecfg, device="cpu")
        got = tdr_query.answer_batch(idx, _patterns(pattern, specs, 4),
                                     engine_config=ecfg, stats=st,
                                     device="cpu")
    assert got.tolist() == want
    assert st.exact_jobs > 0
    assert idx.engine(config=ecfg).backend == (
        "segment" if over == "adjacency" else "matmul")


def _ref_state(ridx) -> dict:
    """A reference index's arrays, laid out for ``index_from_numpy``."""
    state = {"cfg": dataclasses.asdict(ridx.cfg),
             "graph": {f: getattr(ridx.graph, f)
                       for f in convert.GRAPH_FIELDS},
             "fixpoint_rounds": ridx.fixpoint_rounds,
             "vtx_words": ridx.vtx_words, "lab_slot": ridx.lab_slot,
             "disc": ridx.disc}
    for name in convert.PLANES + convert.AUX_PLANES + convert.INT_ROWS:
        state[name] = np.asarray(getattr(ridx, name))
    return state


@pytest.mark.parametrize("kind,seed", [("er", 3), ("pa", 4)])
def test_answers_on_converted_reference_index(kind, seed):
    """A reference-built index answers through the port's query path
    exactly like the reference, and converts back bit-identically."""
    rg, ridx, g, idx, specs, want = _case(kind, 45, 2.3, seed, 20)
    conv = convert.index_from_numpy(_ref_state(ridx), device="cpu")
    for backend in BACKENDS:
        got = tdr_query.answer_batch(conv, _patterns(pattern, specs, 4),
                                     backend=backend, device="cpu")
        assert got.tolist() == want, backend
    back = convert.index_to_numpy(conv)
    for name in convert.PLANES + convert.AUX_PLANES + convert.INT_ROWS:
        np.testing.assert_array_equal(back[name], np.asarray(
            getattr(ridx, name)), err_msg=name)
    again = convert.index_to_numpy(convert.index_from_numpy(
        convert.index_to_numpy(idx), device="cpu"))
    for name in convert.PLANES:
        np.testing.assert_array_equal(again[name], back[name], err_msg=name)


def test_query_plan_matches_reference():
    rg, ridx, g, idx, specs, _ = _case("er", 40, 2.0, 0, 20)
    rplan = RQ.compile_queries(ridx, _patterns(RP, specs, 4))
    plan = tdr_query.compile_queries(idx, _patterns(pattern, specs, 4))
    for f in ("qid", "u", "v", "req_w", "forb_w", "forb_raw_w",
              "req_labels", "full_mask"):
        np.testing.assert_array_equal(getattr(plan, f), getattr(rplan, f),
                                      err_msg=f)
    padded = plan.pad_to(64)
    assert padded.n_jobs == 64 and padded.qid[-1] == -1


# ------------------------------------- twins of the reference's query tests
@pytest.fixture(scope="module")
def fig2():
    g = G.fig2_example()
    return g, tdr_build.build_index(g, tdr_build.TDRConfig(vtx_bits=32,
                                                           g_max=2, k=2),
                                    device="cpu")


def test_paper_example1(fig2):
    g, idx = fig2
    # v0 -(b AND d)-> v5 : true via path a,d,b
    assert tdr_query.answer(idx, 0, 5, pattern.all_of([1, 3]),
                            device="cpu") is True
    # v0 -NOT{a,b}-> v4 : false (all paths to v4 carry b)
    assert tdr_query.answer(idx, 0, 4, pattern.none_of([0, 1]),
                            device="cpu") is False


def test_paper_example3(fig2):
    g, idx = fig2
    assert tdr_query.answer(idx, 7, 4, pattern.none_of([0]),
                            device="cpu") is False
    assert tdr_query.answer(idx, 0, 6, pattern.all_of([1, 4]),
                            device="cpu") is True


def test_self_query(fig2):
    g, idx = fig2
    assert tdr_query.answer(idx, 3, 3, pattern.none_of([0]),
                            device="cpu") is True
    assert tdr_query.answer(idx, 3, 3, pattern.all_of([0]),
                            device="cpu") is False


@pytest.mark.parametrize("seed,kind", [(0, "er"), (17, "pa"), (301, "er"),
                                       (4242, "pa")])
def test_tdr_matches_oracle(seed, kind):
    rng = np.random.default_rng(seed)
    g = G.random_graph(kind, 40, 2.0, 4, seed=seed)
    idx = tdr_build.build_index(g, tdr_build.TDRConfig(**CFG), device="cpu")
    qs = _patterns(pattern, _specs(rng, 40, 4, 20), 4)
    got = tdr_query.answer_batch(idx, qs, device="cpu")
    assert got.tolist() == [dfs_baseline.answer_pcr(g, u, v, p)
                            for u, v, p in qs]


@pytest.mark.parametrize("seed", [0, 1, 23, 977])
def test_filters_are_sound(seed):
    """Phase-1 filters alone (UNKNOWN -> true) over-approximate: never
    reject a truly reachable query; and the upper bound, with its phase-1
    counts, equals the JAX package's ``filters_only`` on both backends."""
    rng = np.random.default_rng(seed)
    g = G.erdos_renyi(40, 2.5, 4, seed=seed)
    rg = RG.erdos_renyi(40, 2.5, 4, seed=seed)
    idx = tdr_build.build_index(g, tdr_build.TDRConfig(**CFG), device="cpu")
    ridx = RB.build_index(rg, RB.TDRConfig(**CFG), backend="segment")
    specs = _specs(rng, 40, 4, 20)
    rst = RQ.QueryStats()
    r_upper = RQ.answer_batch(ridx, _patterns(RP, specs, 4),
                              filters_only=True, stats=rst)
    want = [dfs_baseline.answer_pcr(g, u, v, p)
            for u, v, p in _patterns(pattern, specs, 4)]
    for backend in BACKENDS:
        st = tdr_query.QueryStats()
        upper = tdr_query.answer_batch(idx, _patterns(pattern, specs, 4),
                                       filters_only=True, backend=backend,
                                       stats=st, device="cpu")
        assert upper.tolist() == r_upper.tolist(), backend
        for ub, w in zip(upper.tolist(), want):
            if w:
                assert ub, "filter cascade produced a false negative"
        assert (st.filter_false, st.filter_true, st.exact_jobs) == \
            (rst.filter_false, rst.filter_true, rst.exact_jobs) == \
            (st.filter_false, st.filter_true, 0)


def test_stats_pruning_happens():
    g = G.erdos_renyi(60, 1.2, 4, seed=3)   # sparse -> most pairs failing
    idx = tdr_build.build_index(g, tdr_build.TDRConfig(**CFG), device="cpu")
    qs = _patterns(pattern, _specs(np.random.default_rng(0), 60, 4, 60), 4)
    stats = tdr_query.QueryStats()
    tdr_query.answer_batch(idx, qs, stats=stats, device="cpu")
    assert stats.filter_false > 0          # the index prunes something
    assert stats.exact_jobs < stats.n_jobs


@pytest.fixture(scope="module")
def medium():
    g = G.erdos_renyi(300, 2.0, 8, seed=42)
    return g, tdr_build.build_index(
        g, tdr_build.TDRConfig(vtx_bits=128, g_max=4, k=3), device="cpu")


def test_end_to_end_mixed_batch(medium):
    g, idx = medium
    rng = np.random.default_rng(0)
    queries = []
    for i in range(60):
        u = int(rng.integers(g.n_vertices))
        v = int(rng.integers(g.n_vertices))
        labs = rng.choice(g.n_labels, size=3, replace=False).tolist()
        p = [pattern.all_of(labs[:2]), pattern.any_of(labs),
             pattern.none_of(labs[:1]),
             pattern.parse(f"(l{labs[0]} | l{labs[1]}) & !l{labs[2]}")
             ][i % 4]
        queries.append((u, v, p))
    stats = tdr_query.QueryStats()
    got = tdr_query.answer_batch(idx, queries, stats=stats, device="cpu")
    assert got.tolist() == [dfs_baseline.answer_pcr(g, u, v, p)
                            for u, v, p in queries]
    assert stats.n_queries == 60


def test_index_is_refutation_machine(medium):
    """Paper §VI-C: the filter cascade resolves a large share of
    unreachable pairs without any exact search."""
    g, idx = medium
    rng = np.random.default_rng(1)
    queries = [(int(rng.integers(g.n_vertices)),
                int(rng.integers(g.n_vertices)), pattern.none_of([0]))
               for _ in range(100)]
    stats = tdr_query.QueryStats()
    tdr_query.answer_batch(idx, queries, stats=stats, device="cpu")
    assert stats.filter_false >= stats.n_jobs * 0.3, stats


def test_fixpoint_rounds_bounded(medium):
    g, idx = medium
    assert 0 < idx.fixpoint_rounds <= g.n_vertices


def test_special_labels_multiword():
    """The forbidden-label extraction reads every word of the packed raw
    plane (labels >= 32 live past the first word)."""
    g = G.erdos_renyi(30, 2.0, 70, seed=0)
    idx = tdr_build.build_index(g, tdr_build.TDRConfig(vtx_bits=64),
                                device="cpu")
    qs = [(0, 5, pattern.none_of([0, 33, 69])),
          (1, 7, pattern.all_of([2, 40])),
          (2, 9, pattern.parse("l5 & !l64"))]
    plan = tdr_query.compile_queries(idx, qs)
    ex = tdr_query.ExactExecutor(idx, idx.engine("segment"))
    jobs = np.arange(plan.n_jobs)
    assert ex.special_labels(plan, jobs) == (0, 2, 5, 33, 40, 64, 69)
    # single-job slices see only their own labels
    assert ex.special_labels(plan, np.array([0])) == (0, 33, 69)


def test_segment_backend_launches_no_kernel():
    """The segment backend is plain torch: build and answer launch no
    kernel (``ops.KERNEL_LAUNCHES`` stays as it was)."""
    from repro_torch.kernels import ops
    g = G.erdos_renyi(40, 2.0, 4, seed=1)
    before = dict(ops.KERNEL_LAUNCHES)
    idx = tdr_build.build_index(g, tdr_build.TDRConfig(**CFG),
                                backend="segment", device="cpu")
    tdr_query.answer_batch(
        idx, _patterns(pattern, _specs(np.random.default_rng(1), 40, 4, 10),
                       4), backend="segment", device="cpu")
    assert dict(ops.KERNEL_LAUNCHES) == before
