"""The port's micro-batching ``QueryServer`` (``repro_torch.launch.serve``)
against direct calls and the JAX package's server.

Twins of the reference's serving tests (any batch split, dedup, cache,
threaded submits, admission control, pins, every query kind with nothing
materialised after warmup), of its server update tests (no stale answer
across ``submit_update``) and of its durability tests (crash at every I/O
boundary, retries, degraded mode, barrier withdrawal, snapshot fallback,
SIGKILL).  Answers are compared exactly with direct calls, the JAX
package's answers and the DFS oracles; recovered indexes bit for bit with
layout-pinned rebuilds.  Every wait has a timeout, and a fixture stops
every server a test starts.

Run as a script, this module is the SIGKILL test's worker:
``python tests/test_torch_serving.py --worker DIR SEED BACKEND``.
"""
import itertools
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

try:
    import hypothesis as hp
    import hypothesis.strategies as st
except ImportError:  # clean container: vendored fallback (see _minihyp.py)
    import _minihyp as hp
    st = hp.strategies

import faultinject
from repro.core import (graph as RG, pattern as RP, rpq as RR,
                        tdr_build as RB, tdr_query as RQ)
from repro.launch import serve as rserve
from repro_torch import (deltalog, dfs_baseline, engine, graph as G,
                         pattern as pat, rpq, snapshot, tdr_build, tdr_query)
from repro_torch.launch import serve

CFG = tdr_build.TDRConfig(vtx_bits=64, g_max=4, k=3)
RCFG = RB.TDRConfig(vtx_bits=64, g_max=4, k=3)
PLANES = ("h_vtx", "h_lab", "v_vtx", "v_lab", "n_out", "n_in", "push",
          "pop", "g_count", "base_v", "base_l", "base_r", "r_vtx",
          "r_lab", "r_in", "d_vtx", "d_lab")
REF_BACKEND = {"segment": "segment", "matmul": "pallas"}
# randomized build/update/crash interleavings per backend, as many as the
# JAX package's (its acceptance floor is 100 across both)
N_CRASH_TRIALS = {"segment": 70, "matmul": 35}
N_V, N_L = 24, 4
WAIT_S = 60


@pytest.fixture
def one_thread():
    """One intra-op thread for the test: its ops are small, and parallel
    test workers then do not oversubscribe the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def servers():
    """Register each server a test makes; every one is stopped (without
    draining) and detached from its log at teardown, so one failure
    cannot leave a scheduler thread behind."""
    live = []
    yield lambda srv: live.append(srv) or srv
    for srv in live:
        t = threading.Thread(target=srv.stop, kwargs={"drain": False},
                             daemon=True)
        t.start()
        t.join(WAIT_S)
        srv.close_persistence()
        assert not t.is_alive(), "a server did not stop"


def assert_planes_equal(a, b, ctx=""):
    """Two indexes, of either package, hold the same bits everywhere."""
    def arr(x):
        return x.cpu().numpy() if isinstance(x, torch.Tensor) \
            else np.asarray(x)
    for p in PLANES:
        x, y = arr(getattr(a, p)), arr(getattr(b, p))
        assert x.shape == y.shape and np.array_equal(
            x.view(np.uint32), y.view(np.uint32)), f"{ctx}: plane {p}"
    assert np.array_equal(a.vtx_words, b.vtx_words), ctx
    assert np.array_equal(np.asarray(a.disc), np.asarray(b.disc)), ctx
    for f in ("indptr", "indices", "labels"):
        assert np.array_equal(getattr(a.graph, f), getattr(b.graph, f)), f


def _query_pool(P, g, seed: int, n: int = 24):
    """The reference's mixed pool, built with pattern module ``P`` (the
    port's or the JAX package's): all families, u == v self-queries,
    repeated patterns."""
    rng = np.random.default_rng(seed)
    pool = []
    for i in range(n):
        u = int(rng.integers(g.n_vertices))
        v = u if i % 6 == 5 else int(rng.integers(g.n_vertices))
        labs = rng.choice(g.n_labels, size=2, replace=False).tolist()
        p = [P.all_of(labs), P.any_of(labs), P.none_of(labs),
             P.parse(f"l{labs[0]} & !l{labs[1]}"),
             P.lcr(labs, g.n_labels)][i % 5]
        pool.append((u, v, p))
    return pool


_CACHE: dict = {}


def _served():
    """(reference index, port graph, port index) of the served graph,
    built once per module (the property tests cannot take fixtures)."""
    if "gi" not in _CACHE:
        rg = RG.random_graph("er", 40, 2.0, 4, seed=7)
        g = G.random_graph("er", 40, 2.0, 4, seed=7)
        _CACHE["gi"] = (RB.build_index(rg, RCFG), g,
                        tdr_build.build_index(g, CFG, device="cpu"))
    return _CACHE["gi"]


def _drive(server, batches):
    """Feed requests through the scheduler core on explicit batch
    boundaries (deterministic, no timing): returns per-request answers."""
    futs = []
    for batch in batches:
        reqs = []
        for (u, v, p) in batch:
            rows = tdr_query.pattern_rows(server.index, p,
                                          server.config.max_m)
            req = serve._Request(u, v, p, (u, v, pat.canonical_key(p)),
                                 rows.n_terms)
            reqs.append(req)
            futs.append(req.future)
        server._serve_batch(reqs)
    return [f.result(timeout=WAIT_S) for f in futs]


# ------------------------------------------------------------ scheduling
@hp.given(seed=st.integers(0, 10_000),
          splits=st.lists(st.integers(1, 8), min_size=1, max_size=6),
          dup=st.booleans(), cache=st.booleans())
@hp.settings(max_examples=12, deadline=None)
def test_any_split_matches_direct(seed, splits, dup, cache):
    """Arrival order + batch-boundary splits + cache state never change
    answers vs one direct answer_batch call, nor vs the JAX package."""
    ridx, g, idx = _served()
    rng = np.random.default_rng(seed)
    pool, rpool = _query_pool(pat, g, seed), _query_pool(RP, g, seed)
    order = rng.permutation(len(pool)).tolist()
    if dup:
        order = order + order[::2]
    queries = [pool[i] for i in order]
    server = serve.QueryServer(idx, result_cache=64 if cache else 0)
    batches, i, si = [], 0, 0
    while i < len(queries):
        n = splits[si % len(splits)]
        batches.append(queries[i:i + n])
        i += n
        si += 1
    got = _drive(server, batches)
    want = tdr_query.answer_batch(idx, queries, device="cpu").tolist()
    assert got == want
    assert want == RQ.answer_batch(ridx, [rpool[i] for i in order]).tolist()
    if cache:
        assert _drive(server, [queries]) == want


def test_dedup_and_cache_counted():
    _, g, idx = _served()
    q = _query_pool(pat, g, 3)[0]
    server = serve.QueryServer(idx, result_cache=16)
    got = _drive(server, [[q, q, q]])
    assert got == [got[0]] * 3
    assert server.stats.dedup_hits == 2
    before = server.stats.cache_hits
    assert _drive(server, [[q]]) == [got[0]]
    assert server.stats.cache_hits == before + 1


def test_threaded_submit_matches_direct(servers):
    """End to end through submit(): concurrent clients, the real
    scheduler thread, mixed duplicates — equal to the direct call."""
    _, g, idx = _served()
    pool = _query_pool(pat, g, 11, n=30)
    want = tdr_query.answer_batch(idx, pool, device="cpu").tolist()
    srv = servers(serve.QueryServer(idx, max_wait_ms=1.0, result_cache=32))
    srv.start()
    srv.warmup(pool[:8])
    results, lock = {}, threading.Lock()

    def client(ids):
        for i in ids:
            got = srv.submit(*pool[i]).result(timeout=WAIT_S)
            with lock:
                results.setdefault(i, []).append(got)

    threads = [threading.Thread(target=client, args=(
        list(range(j, len(pool), 4)) + [0, 1],)) for j in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(WAIT_S)
    assert not any(t.is_alive() for t in threads)
    assert len(results) == len(pool)
    for i, vals in results.items():
        assert all(v == want[i] for v in vals), (i, vals, want[i])


def test_stress_many_clients_short_switch_interval(servers):
    """More client threads than cores, with the interpreter switching
    threads every microsecond: every answer still equals the direct call,
    and no counter update is lost (each submit is served, deduplicated or
    a cache hit, exactly once)."""
    _, g, idx = _served()
    pool = _query_pool(pat, g, 13, n=40)
    want = tdr_query.answer_batch(idx, pool, device="cpu").tolist()
    srv = servers(serve.QueryServer(idx, max_wait_ms=0.2, result_cache=8))
    srv.start()
    n_threads = 2 * (os.cpu_count() or 4)
    bad, lock = [], threading.Lock()

    def client(j):
        for i in range(j, j + 3 * len(pool), 7):
            got = srv.submit(*pool[i % len(pool)]).result(timeout=WAIT_S)
            if got != want[i % len(pool)]:
                with lock:
                    bad.append(i)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=client, args=(j,), daemon=True)
                   for j in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(WAIT_S)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not bad
    st_ = srv.stats
    assert st_.submitted == n_threads * len(range(0, 3 * len(pool), 7))
    assert st_.submitted == st_.served + st_.cache_hits


def test_admission_control(servers):
    _, g, idx = _served()
    q = _query_pool(pat, g, 5)[0]
    server = servers(serve.QueryServer(idx, max_queue=2, result_cache=0))
    # scheduler not started: the queue fills and non-blocking submits shed
    f1 = server.submit(*q, block=False)
    f2 = server.submit(*q, block=False)
    with pytest.raises(serve.QueueFull):
        server.submit(*q, block=False)
    assert server.stats.rejected == 1
    with pytest.raises(serve.QueueFull):
        server.submit(*q, block=True, timeout=0.01)
    # draining on start answers the backlog
    server.start()
    assert f1.result(timeout=WAIT_S) == f2.result(timeout=WAIT_S)
    server.stop(drain=True)
    with pytest.raises(RuntimeError, match="stopped"):
        server.submit(*q)


def test_pinned_plan_matches_unpinned():
    """pin_m / special_labels pins change shapes, never answers, on both
    backends; the JAX package's pinned answer_plan agrees."""
    ridx, g, idx = _served()
    pool, rpool = _query_pool(pat, g, 17), _query_pool(RP, g, 17)
    plan = tdr_query.compile_queries(idx, pool)
    rplan = RQ.compile_queries(ridx, rpool)
    want = tdr_query.answer_plan(idx, plan).tolist()
    for backend, pin_m in itertools.product(("segment", "matmul"),
                                            (1, 2, 4)):
        kw = dict(pin_m=pin_m, special_labels=tuple(range(g.n_labels)),
                  exact_mode="full")
        got = tdr_query.answer_plan(idx, plan, backend=backend, pad_lo=8,
                                    **kw).tolist()
        assert got == want, (backend, pin_m)
        assert RQ.answer_plan(ridx, rplan, backend=REF_BACKEND[backend],
                              pad_lo=8, **kw).tolist() == want
    assert want == [dfs_baseline.answer_pcr(g, u, v, p) for u, v, p in pool]


@pytest.mark.parametrize("backend", ["segment", "matmul"])
def test_pins_on_the_kind_paths(backend):
    """The serving pins on dist_batch, witness, count_routes and
    rpq_batch: equal answers with and without them, and equal to the JAX
    package under the same pins.  A pin_m over the plan's max_m is
    capped, as in the reference."""
    ridx, g, idx = _served()
    pool, rpool = _query_pool(pat, g, 29, n=10), _query_pool(RP, g, 29, n=10)
    pins = dict(pin_m=3, special_labels=tuple(range(g.n_labels)))
    rb = REF_BACKEND[backend]
    d0 = tdr_query.dist_batch(idx, pool, backend=backend, device="cpu")
    d1 = tdr_query.dist_batch(idx, pool, backend=backend, device="cpu",
                              **pins)
    assert d0.tolist() == d1.tolist() == RQ.dist_batch(
        ridx, rpool, backend=rb, **pins).tolist()
    for (u, v, p), (_, _, rp) in zip(pool[:4], rpool[:4]):
        for pin_m in (None, 3, 9):
            w = tdr_query.witness(idx, u, v, p, backend=backend,
                                  pin_m=pin_m, device="cpu")
            assert w == RQ.witness(ridx, u, v, rp, backend=rb, pin_m=pin_m)
        if len(pat.to_dnf(p)) == 1:
            c = tdr_query.count_routes(idx, u, v, p, hops=4, pin_m=3,
                                       backend=backend, device="cpu")
            assert c == RQ.count_routes(ridx, u, v, rp, hops=4, pin_m=3,
                                        backend=rb)
    texts = ["(l0 | l1)*", "l0 . (l1 | l2)*", "l3 . l0", "l1 . l2 . l3",
             "(l0 | l1 | l2 | l3)+", "l2+ l1?"]
    rq = [(i, (3 * i + 5) % 40, rpq.parse(t)) for i, t in enumerate(texts)]
    want = [dfs_baseline.answer_rpq(g, u, v, r) for u, v, r in rq]
    got = tdr_query.rpq_batch(idx, rq, backend=backend, q_unroll=32,
                              pad_lo=8, device="cpu", **pins)
    assert got.tolist() == want
    assert RQ.rpq_batch(ridx, [(u, v, RR.parse(t)) for (u, v, _), t in zip(
        rq, texts)], backend=rb, q_unroll=32, pad_lo=8,
        **pins).tolist() == want


def test_canonicalize_equivalence():
    """Hash-consing: canonical form is interned, key-stable, and
    semantically identical to the original pattern."""
    rng = np.random.default_rng(0)

    def rand_pat(depth=3):
        k = int(rng.integers(4)) if depth else 0
        if k == 0:
            return pat.label(int(rng.integers(4)))
        if k == 1:
            return pat.not_(rand_pat(depth - 1))
        kids = tuple(rand_pat(depth - 1)
                     for _ in range(int(rng.integers(1, 4))))
        return pat.And(kids) if k == 2 else pat.Or(kids)

    for _ in range(60):
        p = rand_pat()
        c = pat.canonicalize(p)
        assert pat.canonicalize(c) is pat.canonicalize(p)
        assert pat.canonical_key(c) == pat.canonical_key(p)
        labs = sorted(pat.labels_of(p))
        for bits in itertools.product((False, True), repeat=len(labs)):
            present = frozenset(l for l, b in zip(labs, bits) if b)
            assert pat.evaluate(p, present) == pat.evaluate(c, present)


def test_mixed_kind_load_no_recompile(servers):
    """After a warmup pool covering every query kind, sustained mixed-kind
    traffic (bool/dist/witness/count/rpq, duplicate and fresh keys) on the
    matmul backend moves ``engine.jit_cache_entries`` by zero — no kernel
    build or load, no label-class stack packed — and every answer equals
    its oracle.  The per-kind result-cache key holds: a dist hit never
    serves a bool request for the same (u, v, pattern)."""
    _, g, _ = _served()
    idx = tdr_build.build_index(g, CFG, device="cpu")   # fresh engine LRU
    pool = _query_pool(pat, g, 23, n=20)
    single = [q for q in pool if len(pat.to_dnf(q[2])) == 1]
    rpq_pool = [
        (0, 7, rpq.parse("(l0 | l1)*")),
        (3, 3, rpq.parse("l2*")),
        (1, 9, rpq.parse("l0 . (l1 | l2)*")),
        (5, 5, rpq.parse("l3 . l0")),
        (2, 11, rpq.parse("(l0 | l1 | l2 | l3)+")),
        (4, 8, rpq.parse("l1 . l2 . l3")),
        (6, 6, rpq.parse("l0?")),
        (0, 13, rpq.Sym(g.n_labels)),          # unmatchable atom
    ]
    srv = servers(serve.QueryServer(idx, backend="matmul", max_wait_ms=1.0,
                                    result_cache=64))
    srv.start()
    assert srv.warmup(pool) >= 2        # the pinned class stacks, packed
    assert srv.warmup(pool) == 0
    n0 = engine.jit_cache_entries()
    rng = np.random.default_rng(23)
    futs = []
    for i in range(60):
        u, v, p = pool[int(rng.integers(len(pool)))]
        kd = ("bool", "dist", "witness")[i % 3]
        futs.append(((u, v, p, kd), srv.submit(u, v, p, kind=kd)))
    for (u, v, p) in single[:6]:
        futs.append(((u, v, p, "count"),
                     srv.submit(u, v, p, kind="count", hops=4)))
    for i in range(20):
        u, v, r = rpq_pool[int(rng.integers(len(rpq_pool)))]
        futs.append(((u, v, r, "rpq"), srv.submit(u, v, r, kind="rpq")))
    for (u, v, p, kd), f in futs:
        got = f.result(timeout=WAIT_S)
        if kd == "bool":
            assert got == dfs_baseline.answer_pcr(g, u, v, p)
        elif kd == "dist":
            assert got == dfs_baseline.shortest_pcr(g, u, v, p)
        elif kd == "witness":
            want = dfs_baseline.shortest_pcr(g, u, v, p)
            if want < 0:
                assert got is None
            else:
                assert len(got) == want
                assert dfs_baseline.verify_witness(g, u, v, p, got)
        elif kd == "rpq":
            assert got == dfs_baseline.answer_rpq(g, u, v, p), \
                (u, v, rpq.unparse(p))
        else:
            assert got == dfs_baseline.count_routes(g, u, v, p, hops=4,
                                                    cap=32767)
    assert engine.jit_cache_entries() == n0, \
        "mixed-kind load materialised something after warmup"
    assert srv.stats.unpinned_batches == 0
    assert srv.stats.overflow_batches == 0
    with pytest.raises(ValueError, match="rpq"):
        srv.submit(0, 1, pat.label(0), kind="rpq")
    u, v, p = pool[0]
    b = srv.submit(u, v, p, kind="bool").result(timeout=WAIT_S)
    d = srv.submit(u, v, p, kind="dist").result(timeout=WAIT_S)
    assert isinstance(b, (bool, np.bool_)) and isinstance(d, int)
    assert b == (d >= 0)
    multi = next(q for q in pool if len(pat.to_dnf(q[2])) > 1)
    with pytest.raises(ValueError, match="single"):
        srv.submit(*multi, kind="count", hops=2)
    with pytest.raises(ValueError, match="kind"):
        srv.submit(u, v, p, kind="fuzzy")


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("backend", ["segment", "matmul"])
def test_legacy_server_answers_every_kind(servers, backend):
    """``exact_mode="legacy"`` on a server: bool requests run the legacy
    executor, the other kinds (whose executors refuse it) run "full".
    Bool, dist and rpq answers equal direct calls in those modes, the
    oracles and the JAX package's server in the same config."""
    ridx, g, idx = _served()
    pool, rpool = _query_pool(pat, g, 31, n=12), _query_pool(RP, g, 31, n=12)
    texts = ["(l0 | l1)*", "l0 . (l1 | l2)*", "l3 . l0", "(l1 | l2)+"]
    rq = [(i, (5 * i + 3) % 40, rpq.parse(t)) for i, t in enumerate(texts)]
    rrq = [(u, v, RR.parse(t)) for (u, v, _), t in zip(rq, texts)]
    srv = servers(serve.QueryServer(idx, backend=backend,
                                    exact_mode="legacy", max_wait_ms=1.0))
    rsrv = rserve.QueryServer(ridx, backend=REF_BACKEND[backend],
                              exact_mode="legacy", max_wait_ms=1.0)
    assert srv._kind_mode() == rsrv._kind_mode() == "full"
    assert srv._kind_mode("bool") == "legacy"
    got = {}
    for name, server, qs, rqs in (("port", srv, pool, rq),
                                  ("reference", rsrv, rpool, rrq)):
        server.start()
        try:
            server.warmup(qs[:4])
            futs = [server.submit(*q) for q in qs]
            futs += [server.submit(*q, kind="dist") for q in qs]
            futs += [server.submit(*q, kind="rpq") for q in rqs]
            got[name] = [f.result(timeout=WAIT_S) for f in futs]
        finally:
            server.stop()
    n = len(pool)
    kw = dict(backend=backend, device="cpu")
    want = (tdr_query.answer_batch(idx, pool, exact_mode="legacy",
                                   **kw).tolist()
            + tdr_query.dist_batch(idx, pool, exact_mode="full",
                                   **kw).tolist()
            + tdr_query.rpq_batch(idx, rq, exact_mode="full", **kw).tolist())
    assert [bool(a) for a in got["port"][:n]] == want[:n]
    assert [int(d) for d in got["port"][n:2 * n]] == want[n:2 * n]
    assert [bool(a) for a in got["port"][2 * n:]] == want[2 * n:]
    assert got["port"] == got["reference"]
    assert want[:n] == [dfs_baseline.answer_pcr(g, u, v, p)
                        for u, v, p in pool]
    assert want[2 * n:] == [dfs_baseline.answer_rpq(g, u, v, r)
                            for u, v, r in rq]


def test_plan_cache_hits():
    _, _, idx = _served()
    p = pat.all_of([0, 1])
    stats = tdr_query.QueryStats()
    tdr_query.compile_queries(idx, [(0, 1, p), (2, 3, p), (1, 1, p)],
                              stats=stats)
    assert stats.plan_lookups == 3
    assert stats.plan_misses <= 1


def test_scheduler_error_reaches_the_future(servers):
    """An executor error on the scheduler thread (a CUDA fault on the
    card) fails the batch's futures with that error and the scheduler
    keeps serving."""
    _, g, idx = _served()
    srv = servers(serve.QueryServer(idx, result_cache=0))
    answer_keys = srv._answer_keys
    boom = RuntimeError("CUDA error: an illegal memory access")
    srv._answer_keys = lambda keys, uniq: (_ for _ in ()).throw(boom)
    srv.start()
    q = _query_pool(pat, g, 2)[0]
    fut = srv.submit(*q)
    assert fut.exception(timeout=WAIT_S) is boom
    srv._answer_keys = answer_keys
    assert srv.submit(*q).result(timeout=WAIT_S) == \
        dfs_baseline.answer_pcr(g, *q)


# --------------------------------------------------------------- updates
def _edges_of(g):
    return list(zip(g.src.tolist(), g.indices.tolist(), g.labels.tolist()))


def _random_step(rng, g):
    """One random update batch: inserts, deletes, label changes."""
    add, rem = [], []
    edges = _edges_of(g)
    for _ in range(int(rng.integers(1, 4))):
        kind = int(rng.integers(4))
        if kind <= 1 or not edges:
            u, v = int(rng.integers(g.n_vertices)), \
                int(rng.integers(g.n_vertices))
            if u != v:
                add.append((u, v, int(rng.integers(g.n_labels))))
        elif kind == 2:
            rem.append(edges[int(rng.integers(len(edges)))])
        else:
            u, v, l = edges[int(rng.integers(len(edges)))]
            rem.append((u, v, l))
            add.append((u, v, int((l + 1) % g.n_labels)))
    return add, rem


def _oracle_queries(rng, g, n=8):
    qs = []
    for i in range(n):
        u, v = int(rng.integers(g.n_vertices)), \
            int(rng.integers(g.n_vertices))
        labs = rng.choice(g.n_labels, size=2, replace=False).tolist()
        p = [pat.all_of(labs), pat.any_of(labs), pat.none_of(labs),
             pat.parse(f"l{labs[0]} & !l{labs[1]}")][i % 4]
        qs.append((u, v, p))
    return qs


def test_served_stream_straddling_update_never_stale(servers):
    """Requests submitted before submit_update see the old graph;
    requests submitted after it see the new one — checked against the
    DFS oracle on each graph, with the result cache on so a stale hit
    would show."""
    g0 = G.random_graph("er", 48, 1.8, N_L, seed=21)
    idx = tdr_build.build_index(g0, CFG, device="cpu")
    rng = np.random.default_rng(22)
    pool = _oracle_queries(rng, g0, n=24)
    add = [(int(rng.integers(48)), int(rng.integers(48)),
            int(rng.integers(N_L))) for _ in range(4)]
    add = [(u, v, l) for (u, v, l) in add if u != v]
    rem = _edges_of(g0)[:2]
    g1 = g0.apply_updates(add, rem).graph
    srv = servers(serve.QueryServer(idx, result_cache=64, max_wait_ms=0.5))
    srv.start()
    pre = [srv.submit(u, v, p) for (u, v, p) in pool]
    st_ = srv.submit_update(add, rem, timeout=WAIT_S)
    assert st_.mode in ("incremental", "rebuild")
    post = [srv.submit(u, v, p) for (u, v, p) in pool]
    pre_ans = [f.result(timeout=WAIT_S) for f in pre]
    post_ans = [f.result(timeout=WAIT_S) for f in post]
    again = [srv.submit(u, v, p).result(timeout=WAIT_S)
             for (u, v, p) in pool]
    assert srv.stats.updates == 1
    assert srv.index.device == torch.device("cpu")
    assert pre_ans == [dfs_baseline.answer_pcr(g0, u, v, p)
                       for (u, v, p) in pool]
    want1 = [dfs_baseline.answer_pcr(g1, u, v, p) for (u, v, p) in pool]
    assert post_ans == want1
    assert again == want1


def test_update_on_unstarted_server_with_queued_requests_raises(servers):
    """Requests queued before the first start() are owed pre-update
    answers; with no scheduler to quiesce, submit_update refuses.  An
    idle stopped server swaps inline."""
    g = G.fig2_example()
    idx = tdr_build.build_index(g, CFG, device="cpu")
    srv = servers(serve.QueryServer(idx))
    fut = srv.submit(0, 5, pat.all_of([1, 3]))   # queues unserved
    with pytest.raises(RuntimeError):
        srv.submit_update([(4, 0, 3)], [])
    assert srv.index is idx and not fut.done()
    srv.start()
    assert fut.result(timeout=WAIT_S) is True
    srv.stop()
    srv.submit_update([(4, 0, 3)], [])
    assert srv.index.graph.n_edges == g.n_edges + 1


def test_sequential_updates_through_server(servers):
    """Several submit_update calls in a row keep serving correct (each
    chains off the previously swapped index)."""
    g = G.random_graph("er", 40, 1.5, N_L, seed=31)
    idx = tdr_build.build_index(g, CFG, device="cpu")
    rng = np.random.default_rng(32)
    srv = servers(serve.QueryServer(idx, result_cache=32))
    srv.start()
    curg = g
    for step in range(3):
        add, rem = _random_step(rng, curg)
        curg = curg.apply_updates(add, rem).graph
        srv.submit_update(add, rem, timeout=WAIT_S)
        qs = _oracle_queries(rng, curg, n=8)
        got = [srv.submit(u, v, p).result(timeout=WAIT_S)
               for (u, v, p) in qs]
        assert got == [dfs_baseline.answer_pcr(curg, u, v, p)
                       for (u, v, p) in qs], f"step {step}"
    assert srv.stats.updates == 3


def test_with_lsn_stamps_the_read_position(servers, tmp_path):
    """``with_lsn=True`` resolves to ``(answer, lsn)``; each answer equals
    a direct call on the index of that LSN, also for cache hits, and
    ``wait_for_lsn`` sees every applied LSN."""
    g = G.random_graph("er", N_V, 2.0, N_L, seed=41)
    idx = tdr_build.build_index(g, CFG, device="cpu")
    srv = servers(serve.QueryServer(idx, result_cache=16, max_wait_ms=0.5))
    srv.persist_to(str(tmp_path / "p"))
    srv.start()
    rng = np.random.default_rng(42)
    qs = _oracle_queries(rng, g, n=6)
    by_lsn = {0: idx}
    stamped = []
    for step in range(2):
        stamped += [(q, srv.submit(*q, with_lsn=True)) for q in qs]
        srv.submit_update(*_random_step(rng, srv.index.graph),
                          timeout=WAIT_S)
        assert srv.wait_for_lsn(step + 1, timeout=WAIT_S)
        by_lsn[step + 1] = srv.index
    stamped += [(q, srv.submit(*q, with_lsn=True)) for q in qs]
    assert not srv.wait_for_lsn(3, timeout=0.01)
    for (u, v, p), f in stamped:
        ans, lsn = f.result(timeout=WAIT_S)
        assert ans == tdr_query.answer(by_lsn[lsn], u, v, p, device="cpu")
    hits = srv.stats.cache_hits
    for (u, v, p) in qs:    # now cached: resolved inside submit
        ans, lsn = srv.submit(u, v, p, with_lsn=True).result(timeout=WAIT_S)
        assert lsn == 2 and ans == tdr_query.answer(by_lsn[2], u, v, p,
                                                    device="cpu")
    assert srv.stats.cache_hits == hits + len(qs)


def test_swap_in_at_the_barrier(servers):
    """``_swap_in`` (the replica's apply step) swaps at the scheduler's
    barrier when it runs, inline when it does not, notes the LSN, and a
    swap that would move the LSN backwards is refused."""
    g = G.random_graph("er", N_V, 2.0, N_L, seed=43)
    idx = tdr_build.build_index(g, CFG, device="cpu")
    d = g.apply_updates([(0, 1, 2)], [])
    new = tdr_build.update_index(idx, d, device="cpu")
    srv = servers(serve.QueryServer(idx))
    with srv._update_lock:
        assert srv._swap_in(new, 1)             # inline: no scheduler
    assert srv.index is new and srv.stats.applied_lsn == 1
    srv.start()
    with srv._update_lock:
        assert srv._swap_in(idx, 2)             # through the barrier
        assert not srv._swap_in(new, 2)         # not past applied_lsn
    assert srv.index is idx and srv.stats.applied_lsn == 2
    assert srv.wait_for_lsn(2, timeout=WAIT_S)


# ----------------------------------------------------------- durability
@pytest.fixture
def port_seams(monkeypatch):
    """Point the fault-injection harness at the port's two modules."""
    monkeypatch.setattr(faultinject, "_MODULES", (snapshot, deltalog))


def _same_graph(a, b):
    return a.n_edges == b.n_edges and np.array_equal(
        a.indices, b.indices) and np.array_equal(a.labels, b.labels)


def _run_crash_trial(backend, trial, workdir):
    """One randomized build/update/crash interleaving; returns True if
    the injected fault actually fired."""
    rng = np.random.default_rng(7000 + trial)
    g = G.random_graph(["er", "pa"][trial % 2], N_V, 2.0, N_L, seed=trial)
    idx = tdr_build.build_index(g, CFG, backend=backend, device="cpu")
    d = os.path.join(workdir, f"t{trial}")
    srv = serve.QueryServer(idx, backend=backend, update_retries=0,
                            compact_every=int(rng.integers(0, 3)))
    graphs, acked, persist_ok = [g], 0, False
    plan = faultinject.FaultPlan(nth=int(rng.integers(1, 15)), kind="kill")
    with faultinject.inject(plan):
        try:
            srv.persist_to(d)
            persist_ok = True
            for _ in range(int(rng.integers(1, 5))):
                add, rem = _random_step(rng, graphs[-1])
                graphs.append(graphs[-1].apply_updates(add, rem).graph)
                srv.submit_update(add, rem)
                acked += 1
        except (serve.UpdateFailed, OSError):
            pass
    srv.close_persistence()

    if not persist_ok:
        # crash in the first checkpoint: nothing durable (typed refusal)
        # or exactly the initial graph, never anything in between
        try:
            rec = serve.QueryServer.recover(d, backend=backend,
                                            device="cpu")
        except (serve.RecoveryError, deltalog.LogCorrupt):
            return plan.fired
        try:
            ref = tdr_build.build_index(g, CFG, layout=idx.disc,
                                        backend=backend, device="cpu")
            assert_planes_equal(rec.index, ref, f"trial {trial} (persist)")
        finally:
            rec.close_persistence()
        return plan.fired

    rec = serve.QueryServer.recover(d, backend=backend, device="cpu")
    try:
        # acked state always survives; the one in-flight update may too
        allowed = [acked] + ([acked + 1] if plan.fired
                             and len(graphs) > acked + 1 else [])
        match = next((k for k in allowed
                      if _same_graph(rec.index.graph, graphs[k])), None)
        assert match is not None, \
            f"trial {trial}: recovered graph is none of {allowed}"
        ref = tdr_build.build_index(graphs[match], CFG, layout=idx.disc,
                                    backend=backend, device="cpu")
        assert_planes_equal(rec.index, ref,
                            f"trial {trial} (k={match}, acked={acked})")
        assert rec.stats.applied_lsn == match
        if trial % 10 == 0:
            qs = _oracle_queries(rng, graphs[match], n=6)
            got = tdr_query.answer_batch(rec.index, qs, backend=backend,
                                         device="cpu")
            assert got.tolist() == [dfs_baseline.answer_pcr(
                graphs[match], u, v, p) for u, v, p in qs]
    finally:
        rec.close_persistence()
    return plan.fired


@pytest.mark.parametrize("backend", ["segment", "matmul"])
def test_crash_interleavings_recover_bit_identical(backend, tmp_path,
                                                   port_seams):
    fired = 0
    n = N_CRASH_TRIALS[backend]
    for trial in range(n):
        fired += bool(_run_crash_trial(backend, trial, str(tmp_path)))
    assert fired > n // 3, f"only {fired}/{n} trials crashed"


@pytest.mark.parametrize("backend", ["segment", "matmul"])
def test_kill_at_every_io_boundary(backend, tmp_path, port_seams):
    """The same persist + update + checkpoint pipeline is killed at every
    mutating I/O call it makes; every recovery lands on an acked (or
    acked+1) prefix, bit-identically."""
    g = G.random_graph("er", 20, 2.0, N_L, seed=42)
    idx = tdr_build.build_index(g, CFG, backend=backend, device="cpu")
    rng = np.random.default_rng(43)
    steps = [_random_step(rng, g) for _ in range(2)]

    def scenario(d, plan):
        srv = serve.QueryServer(idx, backend=backend, update_retries=0)
        graphs, acked, persist_ok = [g], 0, False
        with faultinject.inject(plan):
            try:
                srv.persist_to(d)
                persist_ok = True
                for add, rem in steps:
                    graphs.append(graphs[-1].apply_updates(add, rem).graph)
                    srv.submit_update(add, rem)
                    acked += 1
                srv.checkpoint()
            except (serve.UpdateFailed, OSError):
                pass
        srv.close_persistence()
        return graphs, acked, persist_ok

    probe = faultinject.FaultPlan(kind="count")
    scenario(str(tmp_path / "probe"), probe)
    total = probe.count
    assert total >= 6, f"scenario only made {total} I/O calls"
    for nth in range(1, total + 1):
        d = str(tmp_path / f"n{nth}")
        plan = faultinject.FaultPlan(nth=nth, kind="kill")
        graphs, acked, persist_ok = scenario(d, plan)
        assert plan.fired, f"nth={nth} never fired (total={total})"
        try:
            rec = serve.QueryServer.recover(d, backend=backend,
                                            device="cpu")
        except (serve.RecoveryError, deltalog.LogCorrupt):
            assert not persist_ok, f"nth={nth}: acked state lost"
            continue
        try:
            allowed = [0] if not persist_ok else [acked] + (
                [acked + 1] if len(graphs) > acked + 1 else [])
            match = next((k for k in allowed
                          if _same_graph(rec.index.graph, graphs[k])), None)
            assert match is not None, f"nth={nth}: not a valid prefix"
            ref = tdr_build.build_index(graphs[match], CFG, layout=idx.disc,
                                        backend=backend, device="cpu")
            assert_planes_equal(rec.index, ref, f"nth={nth}")
        finally:
            rec.close_persistence()


def test_transient_fault_absorbed_by_retry(tmp_path, port_seams):
    """A single transient I/O failure is retried away: the update acks,
    nothing degrades, and the log position is exactly one ahead."""
    g = G.random_graph("er", N_V, 2.0, N_L, seed=5)
    idx = tdr_build.build_index(g, CFG, backend="segment", device="cpu")
    srv = serve.QueryServer(idx, backend="segment", update_retries=2,
                            retry_backoff_s=0.001)
    srv.persist_to(str(tmp_path / "p"))
    plan = faultinject.FaultPlan(nth=1, kind="fail")
    with faultinject.inject(plan):
        srv.submit_update([(0, 1, 0)], [])
    assert plan.fired
    assert srv.stats.update_retries >= 1
    assert not srv.stats.degraded and srv.stats.update_failures == 0
    assert srv.stats.applied_lsn == 1 and srv._log.last_lsn == 1
    srv.close_persistence()


def test_degraded_mode_keeps_serving_last_good(tmp_path, port_seams,
                                               servers):
    """An update that exhausts its retries raises ``UpdateFailed`` and
    flips degraded; reads keep answering on the last-good index; the
    next successful update clears degraded and recovery agrees with the
    live server."""
    rng = np.random.default_rng(6)
    g = G.random_graph("er", N_V, 2.0, N_L, seed=6)
    idx = tdr_build.build_index(g, CFG, backend="segment", device="cpu")
    srv = servers(serve.QueryServer(idx, backend="segment",
                                    update_retries=1, retry_backoff_s=0.001))
    d = str(tmp_path / "p")
    srv.persist_to(d)
    srv.start()
    plan = faultinject.FaultPlan(nth=1, kind="kill")
    with faultinject.inject(plan):
        with pytest.raises(serve.UpdateFailed):
            srv.submit_update([(0, 1, 0)], [])
    assert srv.stats.degraded and srv.stats.update_failures == 1
    qs = _oracle_queries(rng, g, n=6)
    got = [srv.submit(u, v, p).result(timeout=WAIT_S) for u, v, p in qs]
    assert got == [dfs_baseline.answer_pcr(g, u, v, p) for u, v, p in qs]
    assert srv.stats.applied_lsn == 0
    srv.submit_update([(0, 1, 0)], [])
    assert not srv.stats.degraded
    assert srv.stats.applied_lsn == 1
    live = srv.index
    srv.stop()
    srv.close_persistence()
    rec = serve.QueryServer.recover(d, backend="segment", device="cpu")
    assert_planes_equal(rec.index, live, "recover-after-degraded")
    assert rec.stats.applied_lsn == 1
    rec.close_persistence()


def _wait_until(pred, what, timeout=WAIT_S):
    """Poll ``pred`` every 5 ms until it holds or the deadline passes."""
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.005)


def test_barrier_withdrawal_no_deadlock_no_reorder(tmp_path, servers):
    """A timed-out (withdrawn) update barrier frees its queue slot
    (unblocking backpressured submits), pops its write-ahead record, and
    leaves LSN order intact for the next update.  A stale-LSN barrier
    smuggled into the queue is refused.  Every wait here is on an event
    or a deadline (never a fixed number of polls), and the update's own
    timeout leaves the fill two seconds, so a slow host cannot reorder
    the steps."""
    g = G.random_graph("er", N_V, 2.0, N_L, seed=8)
    idx = tdr_build.build_index(g, CFG, backend="segment", device="cpu")
    srv = servers(serve.QueryServer(idx, backend="segment", max_queue=4,
                                    max_wait_ms=0.5))
    d = str(tmp_path / "p")
    srv.persist_to(d)
    gate, entered = threading.Event(), threading.Event()
    orig_serve = srv._serve_batch

    def gated(batch):
        entered.set()
        gate.wait(WAIT_S)
        return orig_serve(batch)

    srv._serve_batch = gated
    p0 = pat.any_of([0, 1])
    srv.start()
    try:
        first = srv.submit(0, 1, p0)        # the scheduler blocks in gated
        assert entered.wait(WAIT_S)
        upd_err: list = []

        def slow_update():
            try:
                srv.submit_update([(2, 3, 1)], [], timeout=2.0)
            except BaseException as e:   # noqa: BLE001
                upd_err.append(e)

        t_upd = threading.Thread(target=slow_update, daemon=True)
        t_upd.start()

        def barrier_queued():
            with srv._lock:
                return any(isinstance(r, serve._UpdateBarrier)
                           for r in srv._queue)

        _wait_until(barrier_queued, "the barrier to take its queue slot")
        filled = 0
        while True:
            try:
                srv.submit(filled % N_V, (filled + 1) % N_V, p0, block=False)
                filled += 1
            except serve.QueueFull:
                break
        assert filled == srv.config.max_queue - 1
        blocked_done = threading.Event()

        def blocked_submit():
            srv.submit(1, 2, p0, block=True, timeout=WAIT_S)
            blocked_done.set()

        t_blk = threading.Thread(target=blocked_submit, daemon=True)
        t_blk.start()
        t_upd.join(WAIT_S)
        assert not t_upd.is_alive(), "submit_update deadlocked"
        assert upd_err and isinstance(upd_err[0], TimeoutError)
        assert srv._log.last_lsn == 0       # the record was popped
        assert blocked_done.wait(WAIT_S), \
            "backpressured submit deadlocked after withdrawal"
    finally:
        gate.set()
    first.result(timeout=WAIT_S)
    srv.submit_update([(2, 3, 1)], [], timeout=WAIT_S)
    assert srv.stats.applied_lsn == 1
    stale = serve._UpdateBarrier(srv.index, lsn=srv.stats.applied_lsn)
    with srv._lock:
        srv._queue.append(stale)
        srv._not_empty.notify()
    assert stale.event.wait(WAIT_S)
    assert stale.exc is not None
    live = srv.index
    srv.stop()
    srv.close_persistence()
    rec = serve.QueryServer.recover(d, backend="segment", device="cpu")
    assert_planes_equal(rec.index, live, "recover-after-withdrawal")
    rec.close_persistence()


def _corrupt(path):
    data = bytearray(open(path, "rb").read())
    data[len(data) // 2] ^= 0x5A
    with open(path, "wb") as f:
        f.write(bytes(data))


def test_recover_falls_back_to_older_snapshot(tmp_path):
    """Corrupting the newest snapshot falls recovery back to the retained
    previous one + a longer replay; corrupting both raises
    ``RecoveryError``."""
    g = G.random_graph("er", N_V, 2.0, N_L, seed=10)
    idx = tdr_build.build_index(g, CFG, backend="segment", device="cpu")
    srv = serve.QueryServer(idx, backend="segment")
    d = str(tmp_path / "p")
    srv.persist_to(d)
    rng = np.random.default_rng(11)
    for _ in range(3):
        srv.submit_update(*_random_step(rng, srv.index.graph))
    srv.checkpoint()   # retains snapshot lsn=0 and snapshot lsn=3
    live = srv.index
    srv.close_persistence()
    snaps = serve._snapshot_files(d)
    assert len(snaps) == 2
    _corrupt(snaps[-1][1])
    rec = serve.QueryServer.recover(d, backend="segment", device="cpu")
    assert_planes_equal(rec.index, live, "fallback-snapshot")
    assert rec.stats.applied_lsn == 3
    rec.close_persistence()
    _corrupt(snaps[0][1])
    with pytest.raises(serve.RecoveryError):
        serve.QueryServer.recover(d, backend="segment", device="cpu")


def test_recover_refuses_compaction_gap(tmp_path):
    """A snapshot older than the log's compacted base cannot seed a
    replay: typed refusal, not a silently wrong index."""
    idx = tdr_build.build_index(G.fig2_example(), CFG, device="cpu")
    d = tmp_path / "p"
    d.mkdir()
    snapshot.save_index(idx, str(d / "snapshot-0000000000000000.tdr"),
                        lsn=0)
    log = deltalog.DeltaLog(str(d / serve.LOG_NAME))
    for _ in range(3):
        log.append(np.array([[0, 1, 0]], np.int64),
                   np.zeros((0, 3), np.int64))
    log.truncate_upto(2)       # base_lsn=2 > snapshot lsn=0: gap
    log.close()
    with pytest.raises(serve.RecoveryError):
        serve.QueryServer.recover(str(d), device="cpu")


def test_recover_empty_dir(tmp_path):
    with pytest.raises(serve.RecoveryError):
        serve.QueryServer.recover(str(tmp_path / "nowhere"), device="cpu")


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_persist_dir_crosses_packages(writer, tmp_path):
    """One package's server persists an index and three updates; both
    packages write the same bytes, and the other package's
    ``QueryServer.recover`` rebuilds the same index from the directory."""
    rng = np.random.default_rng(12)
    g = G.random_graph("er", N_V, 2.0, N_L, seed=12)
    rg = RG.random_graph("er", N_V, 2.0, N_L, seed=12)
    steps, cur = [], g
    for _ in range(3):
        steps.append(_random_step(rng, cur))
        cur = cur.apply_updates(*steps[-1]).graph
    port = serve.QueryServer(tdr_build.build_index(g, CFG, device="cpu"))
    ref = rserve.QueryServer(RB.build_index(rg, RCFG))
    dirs = {"port": tmp_path / "port", "reference": tmp_path / "ref"}
    for srv, name in ((port, "port"), (ref, "reference")):
        srv.persist_to(str(dirs[name]))
        for add, rem in steps:
            srv.submit_update(add, rem)
        srv.close_persistence()
    names = sorted(os.listdir(dirs["port"]))
    assert names == sorted(os.listdir(dirs["reference"]))
    for n in names:
        assert (dirs["port"] / n).read_bytes() == \
            (dirs["reference"] / n).read_bytes(), n
    if writer == "port":
        rec = rserve.QueryServer.recover(str(dirs["port"]))
        assert_planes_equal(rec.index, port.index, "reference recovers")
    else:
        rec = serve.QueryServer.recover(str(dirs["reference"]),
                                        device="cpu")
        assert_planes_equal(rec.index, ref.index, "port recovers")
    assert rec.stats.applied_lsn == 3
    rec.close_persistence()


# ------------------------------------------------------------- SIGKILL
N_STEPS, KILL_AFTER_LSN = 40, 3


def _kill_plan(seed: int):
    """Deterministic update stream: graphs after each step, and the
    steps; identical in the test and its worker."""
    g = G.random_graph("er", N_V, 2.0, N_L, seed=seed)
    rng = np.random.default_rng(seed + 1)
    graphs, steps = [g], []
    for _ in range(N_STEPS):
        cur = graphs[-1]
        edges = _edges_of(cur)
        add, rem = [], []
        for _ in range(int(rng.integers(1, 4))):
            if int(rng.integers(3)) <= 1 or not edges:
                u, v = int(rng.integers(N_V)), int(rng.integers(N_V))
                if u != v:
                    add.append((u, v, int(rng.integers(N_L))))
            else:
                rem.append(edges[int(rng.integers(len(edges)))])
        steps.append((add, rem))
        graphs.append(cur.apply_updates(add, rem).graph)
    return graphs, steps


def _kill_worker(directory: str, seed: int, backend: str) -> None:
    graphs, steps = _kill_plan(seed)
    idx = tdr_build.build_index(graphs[0], CFG, backend=backend,
                                device="cpu")
    srv = serve.QueryServer(idx, backend=backend, compact_every=3)
    srv.persist_to(directory)
    print("READY", flush=True)
    for add, rem in steps:
        srv.submit_update(add, rem)
        print(f"LSN {srv.stats.applied_lsn}", flush=True)
    print("DONE", flush=True)   # the parent should have killed us by now


@pytest.mark.slow
@pytest.mark.parametrize("backend", ["segment"])
def test_sigkill_subprocess_recovers(backend, tmp_path):
    """Real process death: a worker (this module run as a script) persists
    and applies a deterministic update stream and is SIGKILLed after LSN
    3; recovery lands on an acked prefix bit-identically and answers equal
    the DFS oracle."""
    here = os.path.abspath(__file__)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.path.join(os.path.dirname(os.path.dirname(here)),
                                     "src") + os.pathsep + \
        env.get("PYTHONPATH", "")
    d, seed = str(tmp_path / "crash"), 12
    proc = subprocess.Popen([sys.executable, here, "--worker", d, str(seed),
                             backend], env=env, stdout=subprocess.PIPE,
                            text=True)
    killed = False
    try:
        deadline = time.monotonic() + 600
        for line in proc.stdout:
            line = line.strip()
            if line.startswith("LSN") and \
                    int(line.split()[1]) >= KILL_AFTER_LSN:
                proc.send_signal(signal.SIGKILL)
                killed = True
                break
            if line == "DONE" or time.monotonic() > deadline:
                break
    finally:
        if not killed:
            proc.kill()
        proc.wait(timeout=WAIT_S)
    assert killed, "the worker finished before the kill"
    graphs, _ = _kill_plan(seed)
    rec = serve.QueryServer.recover(d, backend=backend, device="cpu")
    try:
        k = rec.stats.applied_lsn
        assert k >= KILL_AFTER_LSN, f"lost acked updates: lsn={k}"
        assert _same_graph(rec.index.graph, graphs[k])
        idx0 = tdr_build.build_index(graphs[0], CFG, backend=backend,
                                     device="cpu")
        ref = tdr_build.build_index(graphs[k], CFG, layout=idx0.disc,
                                    backend=backend, device="cpu")
        assert_planes_equal(rec.index, ref, f"lsn {k}")
        qs = _oracle_queries(np.random.default_rng(seed + 2), graphs[k])
        got = tdr_query.answer_batch(rec.index, qs, backend=backend,
                                     device="cpu")
        assert got.tolist() == [dfs_baseline.answer_pcr(graphs[k], u, v, p)
                                for u, v, p in qs]
    finally:
        rec.close_persistence()


if __name__ == "__main__":
    if len(sys.argv) == 5 and sys.argv[1] == "--worker":
        _kill_worker(sys.argv[2], int(sys.argv[3]), sys.argv[4])
