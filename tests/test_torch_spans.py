"""The port's spans and counters (``repro_torch.utils.spans``).

A span adds its seconds to the stats field it is given and, only while
``torch.profiler`` runs, records ``repro_torch.<name>`` as a plain CPU op
(no user annotation, so the profiler makes no device event of it).  The
query, server and build counters the spans and round loops fill are
checked on small graphs on the CPU, and answers, planes and round counts
are checked unchanged under a running profiler.
"""
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import engine, graph as G, pattern as pat, tdr_build, \
    tdr_query
from repro_torch.launch import serve
from repro_torch.utils import spans

CFG = tdr_build.TDRConfig(vtx_bits=64, g_max=4, k=3)
BACKENDS = ("segment", "matmul")
PLANES = ("h_vtx", "h_lab", "v_vtx", "v_lab", "n_out", "n_in", "push",
          "pop", "g_count")
WAIT_S = 60


@pytest.fixture
def one_thread():
    """One intra-op thread for the test: its ops are small, and parallel
    test workers then do not oversubscribe the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Acc:
    seconds = 0.0
    other = 0.0


def _graph(seed=3, n=60):
    return G.erdos_renyi(n, 2.5, 5, seed=seed)


def _queries(g, n=40, seed=0):
    rng = np.random.default_rng(seed)
    qs = []
    for i in range(n):
        u, v = (int(x) for x in rng.integers(g.n_vertices, size=2))
        a, b = (int(x) for x in rng.choice(g.n_labels, 2, replace=False))
        p = (pat.all_of([a, b]), pat.any_of([a, b]), pat.none_of([a]),
             pat.and_(pat.label(a), pat.not_(pat.label(b))))[i % 4]
        qs.append((u, v, p))
    return qs


def _host_ops(prof) -> list:
    """``(name, is_user_annotation, device type)`` of every event."""
    return [(e.name(), e.is_user_annotation(), str(e.device_type()))
            for e in prof.profiler.kineto_results.events()]


def _span_names(prof) -> set:
    return {n for n, _, _ in _host_ops(prof) if n.startswith(spans.PREFIX)}


def _spans_of(prof, name: str) -> list:
    """``(start_ns, end_ns)`` of every event named ``name``."""
    return [(e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.name() == name]


# ------------------------------------------------------------- the helper
def test_span_adds_its_seconds_and_nests():
    acc = Acc()
    with spans.span("outer", acc, "seconds") as outer:
        with spans.span("inner", acc, "other") as inner:
            sum(range(10000))
        with spans.span("inner", acc, "other"):
            pass
    assert outer.seconds > 0 and inner.seconds > 0
    assert acc.seconds == outer.seconds
    assert inner.seconds <= acc.other <= outer.seconds
    before = acc.seconds
    with spans.span("outer", acc, "seconds") as again:
        pass
    assert acc.seconds == before + again.seconds
    with spans.span("no_stats") as free:       # no field: times only
        pass
    assert free.seconds >= 0


def test_span_adds_even_when_its_block_raises():
    acc = Acc()
    with pytest.raises(ValueError):
        with spans.span("raises", acc, "seconds"):
            raise ValueError("planted")
    assert acc.seconds > 0


def test_span_is_a_plain_cpu_op_under_the_profiler():
    acc = Acc()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("test.outer", acc, "seconds"):
            with spans.span("test.inner"):
                torch.ones(4).add_(1)
    ops = [o for o in _host_ops(prof) if o[0].startswith(spans.PREFIX)]
    assert sorted(n for n, _, _ in ops) == ["repro_torch.test.inner",
                                            "repro_torch.test.outer"]
    assert all(not user and "CPU" in dev for _, user, dev in ops)
    events = {e.name: e for e in prof.events()}
    outer, inner = events["repro_torch.test.outer"], \
        events["repro_torch.test.inner"]
    assert outer.time_range.start <= inner.time_range.start
    assert inner.time_range.end <= outer.time_range.end
    assert acc.seconds > 0


def test_no_record_function_without_a_profiler(monkeypatch):
    opened = []

    class Counting:
        def __init__(self, name):
            opened.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", Counting)
    acc = Acc()
    with spans.span("quiet", acc, "seconds"):
        spans.Syncs().read(torch.tensor([True, False]))
    assert opened == [] and acc.seconds > 0
    with profile(activities=[ProfilerActivity.CPU]):
        with spans.span("loud"):
            pass
    assert opened == ["repro_torch.loud"]


def test_syncs_count_each_read_and_its_wait():
    syncs = spans.Syncs()
    assert syncs.read(torch.tensor(True)) is True
    assert syncs.read(torch.stack([torch.tensor(True),
                                   torch.tensor(False)])) == [True, False]
    assert syncs.n == 2 and syncs.wait_s > 0


# ----------------------------------------------------------- query phases
@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("mode", ["auto", "full", "legacy"])
def test_phase2_syncs_cover_every_round(backend, mode, monkeypatch):
    """One host read per round and one before the first: per chunk on
    segment and in legacy mode; on matmul per lockstep group (the
    full-graph chunks side by side; a compacted chunk alone), whose
    rounds are its longest chunk's."""
    g = _graph()
    idx = tdr_build.build_index(g, CFG, device="cpu")
    groups, real = [], tdr_query._bidi_matmul_core

    def spy(*args):
        out = real(*args)
        groups.append(out[1])        # each chunk's rounds in the launch
        return out

    monkeypatch.setattr(tdr_query, "_bidi_matmul_core", spy)
    st = tdr_query.QueryStats()
    tdr_query.answer_batch(idx, _queries(g), backend=backend,
                           exact_mode=mode, exact_chunk=8, stats=st,
                           device="cpu")
    assert st.exact_rounds > 0
    n_chunks = st.compacted_chunks + st.full_chunks
    if backend == "segment" or mode == "legacy":
        assert groups == []
        assert st.host_syncs == st.exact_rounds + n_chunks
    else:
        assert sorted(r for rs in groups for r in rs) == sorted(
            st._round_parts)
        assert st.host_syncs == sum(max(rs) + 1 for rs in groups)
        assert st.grouped_chunks == (st.full_chunks
                                     if st.full_chunks > 1 else 0)
    if backend == "matmul" and mode == "full":
        assert len(groups) == 1 and st.grouped_chunks == n_chunks > 1
        assert st.host_syncs == max(st._round_parts) + 1
    assert 0 <= st.sync_wait_s <= st.phase2_s
    assert st.phase1_s > 0


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("backend", BACKENDS)
def test_dist_and_rpq_count_their_syncs(backend):
    from repro_torch import rpq
    g = _graph()
    idx = tdr_build.build_index(g, CFG, device="cpu")
    qs = _queries(g, 12)
    st = tdr_query.QueryStats()
    tdr_query.dist_batch(idx, qs, backend=backend, exact_chunk=4,
                         stats=st, device="cpu")
    assert st.host_syncs >= st.exact_rounds > 0
    assert 0 <= st.sync_wait_s <= st.phase2_s
    st = tdr_query.QueryStats()
    regex = rpq.parse("l0 (l1 | l2)* l3")
    tdr_query.rpq_batch(idx, [(u, v, regex) for u, v, _ in qs],
                        backend=backend, exact_chunk=4, stats=st,
                        device="cpu")
    assert st.host_syncs >= st.exact_rounds
    assert 0 <= st.sync_wait_s <= st.phase2_s


@pytest.mark.usefixtures("one_thread")
def test_query_spans_name_the_phases_and_the_reduce_route():
    g = _graph()
    idx = tdr_build.build_index(g, CFG, device="cpu")
    names = {}
    for backend in BACKENDS:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            tdr_query.answer_batch(idx, _queries(g), backend=backend,
                                   exact_mode="full", device="cpu")
        names[backend] = _span_names(prof)
    want = {"repro_torch." + n for n in
            ("query.compile", "query.phase1", "query.phase2", "sync")}
    assert want <= names["segment"] and want <= names["matmul"]
    assert "repro_torch.query.class_stacks" in names["matmul"]
    assert "repro_torch.query.reduce_gather" in names["segment"]
    assert "repro_torch.query.class_stacks" not in names["segment"]


# ----------------------------------------------------------------- server
@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("backend", BACKENDS)
def test_server_counts_queue_wait_and_batch_time(backend):
    g = _graph()
    idx = tdr_build.build_index(g, CFG, device="cpu")
    qs = _queries(g, 24)
    srv = serve.QueryServer(idx, backend=backend, max_jobs=8)
    # queued before the scheduler starts: none is a submit-time cache hit
    futs = [srv.submit(u, v, p) for u, v, p in qs + qs[:6]]
    futs.append(srv.submit(qs[0][0], qs[0][1], qs[0][2], kind="dist"))
    srv.start()
    try:
        want = tdr_query.answer_batch(idx, qs, backend=backend,
                                      device="cpu").tolist()
        got = [f.result(timeout=WAIT_S) for f in futs]
        assert got[:len(qs)] == want and got[len(qs):-1] == want[:6]
    finally:
        srv.stop()
    st = srv.stats
    assert st.dequeued == len(futs) == st.served + st.cache_hits
    assert st.batches > 1 and st.batch_s > 0 and st.queue_wait_s > 0
    assert st.query_stats.host_syncs >= st.query_stats.exact_rounds


@pytest.mark.usefixtures("one_thread")
def test_server_spans_name_each_kind():
    g = _graph()
    idx = tdr_build.build_index(g, CFG, device="cpu")
    (u, v, p), (u2, v2, p2) = _queries(g, 2)
    srv = serve.QueryServer(idx, backend="segment")
    futs = [srv.submit(u, v, p), srv.submit(u, v, p, kind="dist"),
            srv.submit(u2, v2, pat.all_of([0]), kind="count", hops=3),
            srv.submit(u2, v2, pat.all_of([1]), kind="witness")]
    # the scheduler's two calls, run in this (the profiled) thread
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        srv._serve_batch(srv._next_batch())
    assert all(f.done() for f in futs)
    names = _span_names(prof)
    assert {"repro_torch.serve." + n for n in
            ("next_batch", "batch", "bool", "dist", "count",
             "witness")} <= names
    assert srv.stats.batches == 1 and srv.stats.batch_s > 0
    assert srv.stats.dequeued == 4


def test_server_queue_wait_is_each_requests_time_in_the_queue():
    g = _graph()
    idx = tdr_build.build_index(g, CFG, device="cpu")
    (u, v, p), = _queries(g, 1)
    srv = serve.QueryServer(idx, backend="segment")
    fut = srv.submit(u, v, p)
    gate = threading.Event()
    gate.wait(0.05)                      # the request waits 50 ms queued
    srv.start()
    try:
        fut.result(timeout=WAIT_S)
    finally:
        srv.stop()
    assert srv.stats.dequeued == 1
    assert srv.stats.queue_wait_s >= 0.05


# ------------------------------------------------------------------ build
@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("sparse", [False, True])
def test_build_stats_pieces_fill_the_build(backend, sparse, monkeypatch):
    g = _graph(n=80)
    if sparse:      # the block-sparse closures, as on a card
        monkeypatch.setattr(engine.Engine, "_sparse",
                            lambda self, s: True if s is None else s)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        idx = tdr_build.build_index(g, CFG, backend=backend, device="cpu")
    st = idx.build_stats
    pieces = (st.dfs_s, st.layout_s, st.pack_s, st.closure_s, st.levels_s,
              st.projections_s)
    assert all(x > 0 for x in pieces)
    assert sum(pieces) <= st.wall_s + 1e-9
    names = _span_names(prof)
    want = {"repro_torch." + n for n in
            ("build", "build.dfs_intervals", "build.layout",
             "build.closure", "build.levels", "build.projections",
             "sync")}
    assert want <= names
    # the operands are packed in the build's own pack spans, one a
    # direction, and never inside a closure
    packs = _spans_of(prof, "repro_torch.engine.pack")
    assert len(packs) == (backend == "matmul") * (4 if sparse else 2)
    outer = _spans_of(prof, "repro_torch.build.pack")
    assert len(outer) == 2
    assert all(any(a <= s and e <= b for a, b in outer) for s, e in packs)


def test_class_stack_packs_are_counted():
    g = _graph()
    eng = engine.make_engine(g, backend="matmul", device="cpu")
    n0 = engine.LABEL_CLASS_PACKS["stacks"]
    jit0 = engine.jit_cache_entries()
    eng.label_class_adjacency((0, 2))
    eng.label_class_adjacency((0, 2))            # an LRU hit packs nothing
    assert engine.LABEL_CLASS_PACKS["stacks"] == n0 + 1
    assert engine.jit_cache_entries() == jit0 + 1


# ------------------------------------------ nothing changes under a trace
@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("backend", BACKENDS)
def test_a_running_profiler_changes_no_result(backend):
    g = _graph(seed=5)
    qs = _queries(g, 40, seed=2)
    runs = []
    for traced in (False, True):
        prof = profile(activities=[ProfilerActivity.CPU])
        if traced:
            prof.__enter__()
        try:
            idx = tdr_build.build_index(g, CFG, backend=backend,
                                        device="cpu")
            st = tdr_query.QueryStats()
            ans = tdr_query.answer_batch(idx, qs, backend=backend,
                                         exact_chunk=8, stats=st,
                                         device="cpu")
        finally:
            if traced:
                prof.__exit__(None, None, None)
        runs.append((ans.tolist(), st._round_parts, st.host_syncs,
                     idx.fixpoint_rounds,
                     [getattr(idx, n).numpy().tobytes() for n in PLANES]))
        if traced:
            assert "repro_torch.query.phase2" in _span_names(prof)
            assert not any(n.startswith(spans.PREFIX) and "CPU" not in dev
                           for n, _, dev in _host_ops(prof))
    assert runs[0] == runs[1]
