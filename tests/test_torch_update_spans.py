"""Spans and counters of the port's live updates, and reads under them.

``QueryServer.submit_update`` times its maintenance (``serve.update``,
``ServeStats.update_s``), its write-ahead append (``serve.wal``) and the
swap at its barrier (``serve.swap``; ``ServeStats.swap_wait_s`` from the
barrier queued to the swap), and counts the updates that fell back to a
rebuild (``ServeStats.update_rebuilds``).  ``update_index`` names its
pieces (``update.scope``, ``update.operands``, ``update.closure``,
``update.planes``, ``update.rebuild``).  ``LABEL_CLASS_PACKS["bytes"]``
counts the device bytes of every label-class stack packed, and
``["copied_bytes"]`` those of every cached stack ``Engine.apply_delta``
copies to patch.  A persisted server under interleaved inserts and
deletes answers every stamped read as ``dfs_baseline`` does on the graph
of its LSN; ``ServeConfig.count_cap`` saturates its route counts.  CPU,
small graphs.
"""
import collections
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch import bitset, dfs_baseline, engine, graph as G, \
    pattern as pat, tdr_build, tdr_query
from repro_torch.launch import serve
from repro_torch.utils import spans

CFG = tdr_build.TDRConfig(vtx_bits=64, g_max=4, k=3)
WAIT_S = 60


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def span_counts(monkeypatch):
    """Every span opened, by name, from any thread."""
    seen = collections.Counter()
    lock = threading.Lock()
    real = spans.span

    class counted(real):
        def __enter__(self):
            with lock:
                seen[self.name] += 1
            return super().__enter__()

    monkeypatch.setattr(spans, "span", counted)
    return seen


def _fresh_edges(rng, g, n):
    """``n`` distinct ``(u, v, l)`` triples, u != v, absent from ``g``."""
    have = set(zip(g.src.tolist(), g.indices.tolist(), g.labels.tolist()))
    out = []
    while len(out) < n:
        u, v = (int(x) for x in rng.integers(g.n_vertices, size=2))
        e = (u, v, int(rng.integers(g.n_labels)))
        if u != v and e not in have:
            have.add(e)
            out.append(e)
    return out


def _present_edges(rng, g, n):
    """``n`` distinct edges of ``g``."""
    pick = rng.choice(g.n_edges, n, replace=False)
    return [(int(g.src[i]), int(g.indices[i]), int(g.labels[i]))
            for i in pick]


@pytest.mark.usefixtures("one_thread")
def test_update_spans_and_counters_move_once_per_update(tmp_path,
                                                        span_counts):
    g = G.erdos_renyi(200, 3.0, 6, seed=1)
    idx = tdr_build.build_index(g, CFG, backend="matmul", device="cpu")
    srv = serve.QueryServer(idx, backend="matmul")
    srv.persist_to(str(tmp_path / "p"))
    srv.start()
    rng = np.random.default_rng(2)
    # (inserted, deleted, rebuild_threshold): an insert runs incremental,
    # a delete at threshold 0 rebuilds, one at 1 never does
    steps = [("add", None), ("del", 0.0), ("add", None), ("del", 1.0)]
    modes = []
    try:
        srv.submit(0, 1, pat.all_of([0])).result(timeout=WAIT_S)
        for i, (what, thr) in enumerate(steps):
            before = dict(vars(srv.stats))
            cur = srv.index.graph
            add = _fresh_edges(rng, cur, 12) if what == "add" else ()
            rem = _present_edges(rng, cur, 6) if what == "del" else ()
            st = srv.submit_update(add, rem, rebuild_threshold=thr,
                                   timeout=WAIT_S)
            modes.append(st.mode)
            after = vars(srv.stats)
            assert after["updates"] == before["updates"] + 1
            assert after["applied_lsn"] == i + 1
            assert after["update_s"] > before["update_s"]
            assert after["swap_wait_s"] > before["swap_wait_s"]
            assert after["update_rebuilds"] == before["update_rebuilds"] \
                + (st.mode == "rebuild")
    finally:
        srv.stop()
        srv.close_persistence()
    assert modes == ["incremental", "rebuild", "incremental", "incremental"]
    n, rebuilds = len(steps), modes.count("rebuild")
    assert srv.stats.update_rebuilds == rebuilds
    for name in ("serve.update", "serve.wal", "serve.swap", "update.scope"):
        assert span_counts[name] == n, name
    assert span_counts["update.rebuild"] == rebuilds
    for name in ("update.operands", "update.closure", "update.planes"):
        assert span_counts[name] == n - rebuilds, name


def test_class_stack_bytes_count_every_pack():
    g = G.erdos_renyi(150, 3.0, 6, seed=3)
    eng = engine.make_engine(g, backend="matmul", device="cpu")
    special = (0, 2, 5)
    c1 = len(special) + 1

    def packed(*args):
        b0 = engine.LABEL_CLASS_PACKS["bytes"]
        jit0 = engine.jit_cache_entries()
        stacks = tdr_query._class_stacks(eng, special, *args)
        assert stacks is not None
        return (engine.LABEL_CLASS_PACKS["bytes"] - b0,
                engine.jit_cache_entries() - jit0)

    v = g.n_vertices
    # the full graph's stacks, both directions from the engine's LRU
    assert packed(v) == (2 * c1 * v * bitset.n_words(v) * 4, 2)
    assert packed(v) == (0, 0)                     # LRU hits
    # a compacted chunk: its own pack, never in the LRU
    keep = (g.src < 64) & (g.indices < 64)
    edges = (g.src[keep], g.indices[keep], g.labels[keep])
    for _ in range(2):
        assert packed(64, edges) == (
            2 * c1 * 64 * bitset.n_words(64) * 4, 0)


def test_class_list_bytes_count_every_pack():
    """``_edge_lists`` counts each list it makes under ``lists`` /
    ``list_bytes``, the engine's builds and a compacted chunk's own, and
    no dense stack: ``class_stack_mb`` keeps reading the stacks."""
    g = G.erdos_renyi(150, 3.0, 6, seed=3)
    eng = engine.make_engine(g, backend="matmul", device="cpu")
    special = (0, 2, 5)

    def packed(*args):
        before = dict(engine.LABEL_CLASS_PACKS)
        jit0 = engine.jit_cache_entries()
        lists = tdr_query._edge_lists(eng, special, *args)
        assert lists is not None
        moved = {k: engine.LABEL_CLASS_PACKS[k] - before.get(k, 0)
                 for k in ("stacks", "bytes", "lists", "list_bytes")}
        return moved, engine.jit_cache_entries() - jit0

    v, e = g.n_vertices, g.n_edges
    # the full graph's lists, both directions the engine's own
    assert packed(v) == ({"stacks": 0, "bytes": 0, "lists": 2,
                          "list_bytes": 2 * (4 * (v + 1) + 8 * e)}, 2)
    assert packed(v) == ({"stacks": 0, "bytes": 0, "lists": 0,
                          "list_bytes": 0}, 0)      # cache hits
    # a compacted chunk: its own lists, never cached
    keep = (g.src < 64) & (g.indices < 64)
    edges = (g.src[keep], g.indices[keep], g.labels[keep])
    for _ in range(2):
        assert packed(64, edges) == (
            {"stacks": 0, "bytes": 0, "lists": 0,
             "list_bytes": 2 * (4 * 65 + 8 * int(keep.sum()))}, 0)


def test_stack_copies_of_an_update_are_counted_apart_from_packs():
    g = G.erdos_renyi(150, 3.0, 6, seed=7)
    eng = engine.make_engine(g, backend="matmul", device="cpu")
    special = (1, 4)
    for reverse in (True, False):
        eng.label_class_adjacency(special, reverse=reverse)
    c1, v = len(special) + 1, g.n_vertices
    delta = g.apply_updates(_fresh_edges(np.random.default_rng(8), g, 5), ())
    before = dict(engine.LABEL_CLASS_PACKS)
    eng.apply_delta(delta.graph, delta.added, delta.removed, device="cpu")
    moved = {k: engine.LABEL_CLASS_PACKS[k] - before.get(k, 0)
             for k in ("stacks", "bytes", "copied_bytes")}
    # both directions' stacks touched and copied whole; nothing packed
    assert moved == {"stacks": 0, "bytes": 0,
                     "copied_bytes": 2 * c1 * v * bitset.n_words(v) * 4}


@pytest.mark.usefixtures("one_thread")
def test_served_route_counts_saturate_at_the_configured_cap():
    g = G.erdos_renyi(60, 6.0, 2, seed=9)
    idx = tdr_build.build_index(g, CFG, backend="matmul", device="cpu")
    srv = serve.QueryServer(idx, backend="matmul", count_cap=5)
    srv.start()
    p = pat.none_of([1])
    try:
        futs = {(u, v): srv.submit(u, v, p, kind="count", hops=4)
                for u in range(6) for v in range(6) if u != v}
        got = {k: f.result(timeout=WAIT_S) for k, f in futs.items()}
    finally:
        srv.stop()
    for (u, v), n in got.items():
        assert n == dfs_baseline.count_routes(g, u, v, p, hops=4, cap=5)
    assert max(got.values()) == 5


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("backend", ("segment", "matmul"))
def test_stamped_reads_under_interleaved_updates(tmp_path, backend):
    g = G.erdos_renyi(120, 2.5, 5, seed=4)
    idx = tdr_build.build_index(g, CFG, backend=backend, device="cpu")
    srv = serve.QueryServer(idx, backend=backend, max_wait_ms=0.5)
    graphs = {srv.persist_to(str(tmp_path / "p")): g}
    srv.start()
    rng = np.random.default_rng(5)
    stop = threading.Event()
    reads = []

    def client():
        r = np.random.default_rng(6)
        while not stop.is_set():
            u, v = (int(x) for x in r.integers(g.n_vertices, size=2))
            a, b = (int(x) for x in r.choice(g.n_labels, 2, replace=False))
            p = (pat.all_of([a]), pat.none_of([a, b]),
                 pat.lcr([a], g.n_labels))[len(reads) % 3]
            reads.append(((u, v, p), srv.submit(u, v, p, with_lsn=True)))
            reads[-1][1].result(timeout=WAIT_S)

    t = threading.Thread(target=client)
    t.start()
    probes = []

    def reads_past(n):
        """Wait until the client has sent ``n`` reads."""
        deadline = time.perf_counter() + WAIT_S
        while len(reads) < n and time.perf_counter() < deadline:
            time.sleep(0.001)

    try:
        for i in range(4):
            reads_past(len(reads) + 8)
            cur = srv.index.graph
            add = _fresh_edges(rng, cur, 8) if i % 2 == 0 else []
            rem = _present_edges(rng, cur, 8) if i % 2 else []
            srv.submit_update(add, rem, timeout=WAIT_S)
            lsn = srv.stats.applied_lsn
            graphs[lsn] = cur.apply_updates(add, rem).graph
            # each edge of the update read back by label-constrained
            # reachability: only its own label, so its presence decides
            probes += [(lsn, (u, v, pat.lcr([l], g.n_labels)),
                        srv.submit(u, v, pat.lcr([l], g.n_labels),
                                   with_lsn=True)) for u, v, l in add + rem]
        reads_past(len(reads) + 8)
    finally:
        stop.set()
        t.join(WAIT_S)
        srv.stop()
        srv.close_persistence()
    assert not t.is_alive()
    assert sorted(graphs) == list(range(5))
    assert len(reads) >= 40
    seen = set()
    for (u, v, p), fut in reads:
        ans, lsn = fut.result(timeout=WAIT_S)
        seen.add(lsn)
        assert ans == dfs_baseline.answer_pcr(graphs[lsn], u, v, p)
    assert len(seen) >= 2
    for want, (u, v, p), fut in probes:
        ans, lsn = fut.result(timeout=WAIT_S)
        assert lsn >= want
        assert ans == dfs_baseline.answer_pcr(graphs[lsn], u, v, p)
