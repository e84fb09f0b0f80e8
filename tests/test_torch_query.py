"""Port query path against the JAX package's ``answer_batch`` and the DFS
oracle: both port backends, every exact mode, LCR, and answers on an index
built by the JAX package and converted.  Exact equality throughout."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro.core import (dfs_baseline as RD, graph as RG, lcr as RL,
                        pattern as RP, tdr_build as RB, tdr_query as RQ)
from repro_torch import (bitset, convert, dfs_baseline, engine, graph as G,
                         lcr, pattern, rpq, tdr_build, tdr_query)
from repro_torch.kernels import ops

CFG = dict(vtx_bits=64, g_max=4, k=3)
BACKENDS = ("segment", "matmul")
STAT_FIELDS = ("n_queries", "n_jobs", "filter_false", "filter_true",
               "exact_jobs", "corridor_active", "corridor_total",
               "saturated_chunks", "exact_rounds", "exact_qids")


@pytest.fixture
def one_thread():
    """One intra-op thread for the test: its ops are small, and parallel
    test workers then do not oversubscribe the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
@pytest.mark.parametrize("mode", ["auto", "compact", "full", "legacy"])
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
    for mode in ("auto", "compact", "full", "legacy"):
        assert tdr_query.answer(idx, 0, 0, pattern.all_of([0, 1]),
                                exact_mode=mode, backend=backend,
                                device="cpu") is True
        assert tdr_query.answer(idx, 3, 3, pattern.all_of([1]),
                                exact_mode=mode, backend=backend,
                                device="cpu") is False


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("seed", [2, 9])
def test_legacy_on_matmul_matches_the_oracle(seed):
    """The legacy leg of the reference's pallas bit-equality test: the
    one-directional executor on ``matmul`` (one B1 product per label class
    per round on the reverse class stack) equals the DFS oracle, the
    reference's pallas legacy run and the port's segment form, rounds
    included."""
    rg, ridx, g, idx, specs, want = _case("pa", 40, 2.5, seed, 15)
    rst = RQ.QueryStats()
    ref = RQ.answer_batch(ridx, _patterns(RP, specs, 4), backend="pallas",
                          exact_mode="legacy", stats=rst)
    assert ref.tolist() == want
    stats = {}
    for backend in BACKENDS:
        st = tdr_query.QueryStats()
        got = tdr_query.answer_batch(idx, _patterns(pattern, specs, 4),
                                     backend=backend, exact_mode="legacy",
                                     stats=st, device="cpu")
        assert got.tolist() == want, backend
        stats[backend] = _stats_tuple(st)
    assert stats["matmul"] == stats["segment"] == _stats_tuple(rst)
    assert rst.exact_jobs > 0


@pytest.mark.usefixtures("one_thread")
def test_legacy_falls_back_when_class_set_blows_cap():
    """The legacy leg of the reference's class-set cap test: a cap that
    fits the adjacency but not the C+1 class matrices warns on the CPU
    and runs the segment form, with the same answers and rounds."""
    g = G.erdos_renyi(40, 2.5, 6, seed=3)
    rg = RG.erdos_renyi(40, 2.5, 6, seed=3)
    idx = tdr_build.build_index(g, tdr_build.TDRConfig(**CFG), device="cpu")
    ridx = RB.build_index(rg, RB.TDRConfig(**CFG))
    specs = _specs(np.random.default_rng(3), 40, 6, 15)
    want = RQ.answer_batch(ridx, _patterns(RP, specs, 6), backend="segment",
                           exact_mode="legacy").tolist()
    cap = 2 * g.n_vertices * bitset.n_words(g.n_vertices) * 4
    ecfg = engine.EngineConfig(backend="matmul", max_dense_bytes=cap)
    st, st_seg = tdr_query.QueryStats(), tdr_query.QueryStats()
    with pytest.warns(engine.DenseCapWarning, match="segment path"):
        got = tdr_query.answer_batch(idx, _patterns(pattern, specs, 6),
                                     engine_config=ecfg, stats=st,
                                     exact_mode="legacy", device="cpu")
    assert idx.engine(config=ecfg).backend == "matmul"
    seg = tdr_query.answer_batch(idx, _patterns(pattern, specs, 6),
                                 backend="segment", stats=st_seg,
                                 exact_mode="legacy", device="cpu")
    assert got.tolist() == seg.tolist() == want
    assert st.exact_rounds == st_seg.exact_rounds > 0


@pytest.mark.usefixtures("one_thread")
def test_legacy_ignores_pin_m_and_refuses_wide_terms():
    """A legacy chunk runs at the plan's whole state width, so a serving
    pin changes nothing; five required labels fit its 32 states, six do
    not, with the reference's message."""
    rg, ridx, g, idx, specs, want = _case("er", 45, 2.3, 1, 20)
    kw = dict(exact_mode="legacy", device="cpu")
    plan = tdr_query.compile_queries(idx, _patterns(pattern, specs, 4))
    st0, st1 = tdr_query.QueryStats(), tdr_query.QueryStats()
    a0 = tdr_query.answer_plan(idx, plan, stats=st0, exact_mode="legacy")
    a1 = tdr_query.answer_plan(idx, plan, stats=st1, exact_mode="legacy",
                               pin_m=1)
    assert a0.tolist() == a1.tolist() == want
    assert _stats_tuple(st0) == _stats_tuple(st1)
    g6 = G.erdos_renyi(30, 3.0, 6, seed=1)
    idx6 = tdr_build.build_index(g6, tdr_build.TDRConfig(**CFG),
                                 device="cpu")
    five = [(0, 1, pattern.all_of([0, 1, 2, 3, 4]))]
    assert tdr_query.answer_batch(idx6, five, max_m=5, **kw).tolist() == [
        dfs_baseline.answer_pcr(g6, 0, 1, five[0][2])]
    with pytest.raises(ValueError, match="max_m=6"):
        tdr_query.answer_batch(
            idx6, [(0, 1, pattern.all_of([0, 1, 2, 3, 4, 5]))], max_m=6,
            **kw)


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


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("mode", ["auto", "full"])
def test_boolean_batch_on_matmul_reads_lists_not_stacks(mode):
    """A boolean ``answer_batch`` on ``matmul`` (CPU) packs no dense class
    stack: its rounds read the edge lists, which a second batch finds
    cached in the engine (nothing packed at all).  Answers,
    ``exact_rounds`` and host syncs equal the segment backend's."""
    rg, ridx, g, idx, specs, want = _case("er", 45, 2.3, 6, 24)
    pq = _patterns(pattern, specs, 4)
    st_s = tdr_query.QueryStats()
    seg = tdr_query.answer_batch(idx, pq, backend="segment",
                                 exact_mode=mode, stats=st_s, device="cpu")
    assert seg.tolist() == want
    for trip in range(2):
        before = dict(engine.LABEL_CLASS_PACKS)
        st = tdr_query.QueryStats()
        got = tdr_query.answer_batch(idx, pq, backend="matmul",
                                     exact_mode=mode, stats=st,
                                     device="cpu")
        moved = {k: engine.LABEL_CLASS_PACKS[k] - before.get(k, 0)
                 for k in ("stacks", "bytes", "lists")}
        assert got.tolist() == want, trip
        assert (st.exact_rounds, st.host_syncs) == (st_s.exact_rounds,
                                                    st_s.host_syncs), trip
        assert st.exact_rounds > 0 and st.operand_bytes > 0
        assert moved["stacks"] == moved["bytes"] == 0, trip
        if trip:
            assert moved["lists"] == 0


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("mode", ["auto", "full"])
@pytest.mark.parametrize("chunk", [8, 32])
def test_grouped_full_chunks_keep_each_chunks_rounds(mode, chunk,
                                                     monkeypatch):
    """On ``matmul`` a batch's full-graph chunks run as one lockstep group
    (one ``class_round`` call and one host read a round for all of them):
    every chunk's rounds (``_round_parts``) equal the segment backend's,
    chunk by chunk, the answers equal the DFS oracle's, and the calls
    are the group's longest chunk's rounds + 1 (a compacted chunk's own
    rounds + 1)."""
    g = G.random_graph("er", 64, 2.3, 4, seed=6)
    idx = tdr_build.build_index(g, tdr_build.TDRConfig(**CFG), device="cpu")
    specs = _specs(np.random.default_rng(6), 64, 4, 96)
    pq = _patterns(pattern, specs, 4)
    want = [dfs_baseline.answer_pcr(g, u, v, p) for u, v, p in pq]
    st_s = tdr_query.QueryStats()
    seg = tdr_query.answer_batch(idx, pq, backend="segment", stats=st_s,
                                 exact_mode=mode, exact_chunk=chunk,
                                 device="cpu")
    real, calls = ops.class_round, []

    def spy(*args):
        calls.append(args[-2:])
        return real(*args)

    monkeypatch.setattr(ops, "class_round", spy)
    st = tdr_query.QueryStats()
    got = tdr_query.answer_batch(idx, pq, backend="matmul", stats=st,
                                 exact_mode=mode, exact_chunk=chunk,
                                 device="cpu")
    assert seg.tolist() == got.tolist() == want
    assert st._round_parts == st_s._round_parts
    assert (st.full_chunks, st.compacted_chunks) == (st_s.full_chunks,
                                                     st_s.compacted_chunks)
    assert st.full_chunks >= 2 and st.grouped_chunks == st.full_chunks
    assert st_s.grouped_chunks == 0
    assert len(calls) == st.host_syncs < st_s.host_syncs
    assert calls.count((False, False)) == st.compacted_chunks + 1


@pytest.mark.usefixtures("one_thread")
def test_operand_bytes_count_each_active_direction(monkeypatch):
    """``QueryStats.operand_bytes`` adds, for each ``class_round`` launch
    of a round, the bytes of the lists of each direction it runs: rounds
    × active directions × the full graph's lists (row pointers and two
    words an edge); a chunk's first meet runs none."""
    rg, ridx, g, idx, specs, want = _case("er", 45, 2.3, 6, 24)
    real, seen = ops.class_round, []

    def spy(lists_rev, lists_fwd, *rest):
        cf, cb = rest[-2:]
        seen.append((int(cf) + int(cb), lists_rev.nbytes, lists_fwd.nbytes))
        return real(lists_rev, lists_fwd, *rest)

    monkeypatch.setattr(ops, "class_round", spy)
    st = tdr_query.QueryStats()
    got = tdr_query.answer_batch(idx, _patterns(pattern, specs, 4),
                                 backend="matmul", exact_mode="full",
                                 stats=st, device="cpu")
    assert got.tolist() == want
    list_bytes = 4 * (g.n_vertices + 1) + 8 * g.n_edges
    assert {b for _, *bs in seen for b in bs} == {list_bytes}
    assert sum(n > 0 for n, _, _ in seen) == st.exact_rounds > 0
    assert st.operand_bytes == list_bytes * sum(n for n, _, _ in seen)
    assert any(n == 2 for n, _, _ in seen)


RPQ_TEXTS = ("l0 . l1", "l1 . (l0 | l2)*", "(l0 . l1)+ . l3", "l2 . l2?",
             "l3* . l0 . l1*")


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("exact_mode", ["compact", "full"])
@pytest.mark.parametrize("kind", ["bool", "rpq"])
def test_gather_cap_route_keeps_answers_and_rounds(kind, exact_mode,
                                                   monkeypatch):
    """Past ``ExactExecutor.GATHER_BYTES_CAP`` (here 0) the segment rounds
    of the boolean and the RPQ cores reduce by packed segment-ORs, not
    over the padded incidence: answers and ``exact_rounds`` equal the
    uncapped run's and the oracle's.  Chunks of 8 jobs pad a tail."""
    rg, ridx, g, idx, specs, want = _case("er", 45, 2.3, 3, 24)
    if kind == "bool":
        qs, run = _patterns(pattern, specs, 4), tdr_query.answer_batch
    else:
        qs = [(u, v, rpq.parse(RPQ_TEXTS[i % len(RPQ_TEXTS)]))
              for i, (u, v, _, _) in enumerate(specs)]
        want = [dfs_baseline.answer_rpq(g, u, v, r) for u, v, r in qs]
        run = tdr_query.rpq_batch
    real, capped = tdr_query._reduce_edges, []

    def spy(val, scatter_idx, ids, *rest):
        capped.append(ids is None)
        return real(val, scatter_idx, ids, *rest)

    monkeypatch.setattr(tdr_query, "_reduce_edges", spy)
    rounds = []
    for cap in (tdr_query.ExactExecutor.GATHER_BYTES_CAP, 0):
        monkeypatch.setattr(tdr_query.ExactExecutor, "GATHER_BYTES_CAP", cap)
        capped.clear()
        st = tdr_query.QueryStats()
        got = run(idx, qs, backend="segment", exact_mode=exact_mode,
                  exact_chunk=8, stats=st, device="cpu")
        assert got.tolist() == want, cap
        assert set(capped) == {cap == 0}, cap
        rounds.append(st.exact_rounds)
    assert rounds[0] == rounds[1] > 0


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


def test_lcr_translation_matches_oracle():
    """The twin of ``tests/test_tdr.py``'s: LCR through the pattern
    engine against the port's own LCR oracle, which agrees with the
    reference's."""
    g = G.erdos_renyi(40, 2.0, 4, seed=9)
    rg = RG.Graph(g.n_vertices, g.n_labels, g.indptr, g.indices, g.labels)
    idx = tdr_build.build_index(g, tdr_build.TDRConfig(**CFG), device="cpu")
    rng = np.random.default_rng(1)
    queries = []
    for _ in range(20):
        u, v = int(rng.integers(40)), int(rng.integers(40))
        allowed = rng.choice(4, size=2, replace=False).tolist()
        queries.append((u, v, allowed))
    got = lcr.answer_lcr_batch(idx, queries, device="cpu")
    want = [dfs_baseline.answer_lcr(g, u, v, set(a)) for u, v, a in queries]
    assert got.tolist() == want
    assert want == [RD.answer_lcr(rg, u, v, set(a)) for u, v, a in queries]
    assert any(want) and not all(want)
