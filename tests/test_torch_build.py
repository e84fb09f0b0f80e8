"""Port index build against the JAX package's, plane for plane: both port
backends, sparse closures on and off, ER and PA graphs.  Exact equality
throughout (packed bits, integer rows, round counts)."""
import functools

import numpy as np
import pytest
import torch

from repro.core import (compressed as rcomp, engine as reng, graph as RG,
                        tdr_build as RB)
from repro_torch import bitset, compressed, engine, graph as G, tdr_build

CFG = dict(vtx_bits=64, g_max=4, k=3)
GRAPHS = [("er", 40, 0), ("er", 60, 3), ("pa", 50, 1), ("pa", 60, 2)]
PLANES = ("h_vtx", "h_lab", "v_vtx", "v_lab", "n_out", "n_in")
AUX = ("base_v", "base_l", "base_r", "r_vtx", "r_lab", "r_in", "d_vtx",
       "d_lab")


@functools.lru_cache(maxsize=None)
def _ref_index(kind, n, seed):
    g = RG.random_graph(kind, n, 2.2, 5, seed=seed)
    return RB.build_index(g, RB.TDRConfig(**CFG), backend="segment")


def _port_graph(kind, n, seed):
    return G.random_graph(kind, n, 2.2, 5, seed=seed)


@pytest.mark.parametrize("kind,n,seed", GRAPHS)
@pytest.mark.parametrize("backend", ["segment", "matmul"])
@pytest.mark.parametrize("sparse", [True, False])
def test_build_index_matches_reference(kind, n, seed, backend, sparse):
    ridx = _ref_index(kind, n, seed)
    ecfg = engine.EngineConfig(backend=backend, sparse=sparse)
    idx = tdr_build.build_index(_port_graph(kind, n, seed),
                                tdr_build.TDRConfig(**CFG),
                                engine_config=ecfg, device="cpu")
    for f in PLANES + AUX:
        np.testing.assert_array_equal(
            bitset.words_to_np(getattr(idx, f)),
            np.asarray(getattr(ridx, f)), err_msg=f)
    for f in ("push", "pop", "g_count"):
        np.testing.assert_array_equal(getattr(idx, f).numpy(),
                                      np.asarray(getattr(ridx, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(idx.vtx_words, ridx.vtx_words)
    np.testing.assert_array_equal(idx.lab_slot, ridx.lab_slot)
    np.testing.assert_array_equal(idx.disc, ridx.disc)
    assert idx.fixpoint_rounds == ridx.fixpoint_rounds
    flags, rflags = idx.summary_flags(), ridx.summary_flags()
    for f in ("sat_out", "sat_in"):
        np.testing.assert_array_equal(flags[f], rflags[f], err_msg=f)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("kind,n,seed", GRAPHS)
def test_closure_rounds_match_reference_per_path(kind, n, seed, reverse):
    """Every port closure path — dense, block-sparse, segment, frontier —
    converges to the reference's planes in the reference's rounds."""
    rg, g = RG.random_graph(kind, n, 2.2, 5, seed=seed), \
        _port_graph(kind, n, seed)
    base = bitset.pack_bits_np(
        np.random.default_rng(seed).random((n, 40)) < 0.1)
    reng_ = reng.make_engine(rg, backend="pallas")
    want, want_rounds = reng_.closure(np.asarray(base), reverse=reverse,
                                      sparse=False)
    for backend in ("segment", "matmul"):
        for sparse in (True, False):
            eng = engine.make_engine(g, backend=backend, device="cpu")
            got, rounds = eng.closure(bitset.np_to_words(base, "cpu"),
                                      reverse=reverse, sparse=sparse)
            np.testing.assert_array_equal(bitset.words_to_np(got),
                                          np.asarray(want))
            assert rounds == int(want_rounds), (backend, sparse)


@pytest.mark.parametrize("kind,n,seed", GRAPHS)
def test_generators_and_operands_match_reference(kind, n, seed):
    rg = RG.random_graph(kind, n, 2.2, 5, seed=seed)
    g = _port_graph(kind, n, seed)
    for f in ("indptr", "indices", "labels"):
        np.testing.assert_array_equal(getattr(g, f), getattr(rg, f))
    np.testing.assert_array_equal(g.src, rg.src)
    for reverse in (False, True):
        a = engine.pack_adjacency_np(g, reverse=reverse)
        np.testing.assert_array_equal(
            a, reng.pack_adjacency_np(rg, reverse=reverse))
        comp = compressed.compress_blocks(a, nbits=n, device="cpu")
        rc = rcomp.compress_blocks(a, nbits=n)
        np.testing.assert_array_equal(comp.states.numpy(),
                                      np.asarray(rc.states))
        np.testing.assert_array_equal(comp.slots.numpy(),
                                      np.asarray(rc.slots))
        np.testing.assert_array_equal(bitset.words_to_np(comp.pool),
                                      np.asarray(rc.pool))
        np.testing.assert_array_equal(comp.mix_bi.numpy(),
                                      np.asarray(rc.mix_bi))
        assert comp.n_mixed == rc.n_mixed
    special = (0, 3)
    np.testing.assert_array_equal(
        engine.pack_label_class_edges_np(g.src, g.indices, g.labels, n,
                                         special),
        reng.pack_label_class_edges_np(rg.src, rg.indices, rg.labels, n,
                                       special))


def _live_list_walk(comp):
    """(bi, bj, slot) of every MIXED entry and (bi, bj) of every ONE entry,
    walked row-block by row-block through the offsets."""
    mix_off, one_off = comp.mix_off.tolist(), comp.one_off.tolist()
    mix_bj, one_bj = comp.mix_bj.tolist(), comp.one_bj.tolist()
    mixed = [(bi, mix_bj[s], s) for bi in range(comp.grid[0])
             for s in range(mix_off[bi], mix_off[bi + 1])]
    ones = [(bi, one_bj[e]) for bi in range(comp.grid[0])
            for e in range(one_off[bi], one_off[bi + 1])]
    return mixed, ones


@pytest.mark.parametrize("kind,n,seed", GRAPHS + [("ones", 70, 0)])
@pytest.mark.parametrize("br,bw", [(8, 1), (4, 2), (16, 1)])
def test_block_live_lists_walk_the_states(kind, n, seed, br, bw):
    """Walking ``mix_off``/``mix_bj`` and ``one_off``/``one_bj`` row by row
    gives exactly the blocks whose state is MIXED (resp. ONE), in order,
    and each MIXED entry's position is its slot.  ``n`` leaves ragged row
    and column tails at every block shape; "ones" adds ONE blocks."""
    if kind == "ones":
        bits = np.random.default_rng(seed).random((n, n)) < 0.05
        bits[:24] = True
        bits[40:56, 32:64] = True
        a = bitset.pack_bits_np(bits)
    else:
        a = engine.pack_adjacency_np(_port_graph(kind, n, seed))
    comp = compressed.compress_blocks(a, br=br, bw=bw, nbits=n, device="cpu")
    states = comp.states.numpy()
    mixed, ones = _live_list_walk(comp)
    mi, mj = np.nonzero(states == compressed.MIXED)
    assert [(bi, bj) for bi, bj, _ in mixed] == list(zip(mi.tolist(),
                                                         mj.tolist()))
    assert [s for _, _, s in mixed] == list(range(comp.n_mixed))
    assert all(comp.slots[bi, bj] == s for bi, bj, s in mixed)
    oi, oj = np.nonzero(states == compressed.ALL_ONE)
    assert ones == list(zip(oi.tolist(), oj.tolist()))
    if kind == "ones":
        assert ones and mixed
    for f in ("mix_off", "one_off", "one_bj"):
        assert getattr(comp, f).dtype == torch.int32, f


def test_compress_matches_reference():
    rng = np.random.default_rng(0)
    plane = rng.integers(0, 2 ** 32, (30, 4, 3), dtype=np.uint32)
    plane[:10] = 0
    plane[10:20, :, :2] = 0xFFFFFFFF
    plane[10:20, :, 2] = 0xFF                 # nbits = 72: tail word full
    got = compressed.compress(plane, nbits=72)
    want = rcomp.compress(plane, nbits=72)
    for f in ("row_states", "mix_rows", "word_states", "pool", "pool_off"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    np.testing.assert_array_equal(got.decompress(), plane)


def test_edgeless_and_layout_pinned_build():
    g = G.Graph.from_edges(6, 2, [])
    idx = tdr_build.build_index(g, tdr_build.TDRConfig(vtx_bits=32),
                                device="cpu")
    assert idx.fixpoint_rounds == 1
    assert not bitset.words_to_np(idx.h_vtx).any()
    g2 = _port_graph("er", 40, 0)
    layout = np.arange(40, dtype=np.int32)[::-1].copy()
    pinned = tdr_build.build_index(g2, tdr_build.TDRConfig(**CFG),
                                   layout=layout, device="cpu")
    ref = RB.build_index(RG.random_graph("er", 40, 2.2, 5, seed=0),
                         RB.TDRConfig(**CFG), layout=layout)
    np.testing.assert_array_equal(bitset.words_to_np(pinned.n_out),
                                  np.asarray(ref.n_out))


# ------------------------------------- twins of the reference's index tests
@pytest.mark.parametrize("backend", ["segment", "matmul"])
def test_index_size_accounting(backend):
    """``size_bytes`` (both accountings) and ``index_memory_stats`` equal
    the JAX package's for the same graph, and logical <= dense."""
    g = G.erdos_renyi(100, 3.0, 4, seed=0)
    rg = RG.erdos_renyi(100, 3.0, 4, seed=0)
    idx = tdr_build.build_index(g, tdr_build.TDRConfig(**CFG),
                                backend=backend, device="cpu")
    ridx = RB.build_index(rg, RB.TDRConfig(**CFG), backend="segment")
    logical = idx.size_bytes(logical=True)
    dense = idx.size_bytes(logical=False)
    assert 0 < logical <= dense
    assert (logical, dense) == (ridx.size_bytes(logical=True),
                                ridx.size_bytes(logical=False))
    assert idx.index_memory_stats() == ridx.index_memory_stats()
    # summary flags and memory stats read one compressed-plane cache
    comp = idx.compressed_planes()
    assert set(comp) == set(idx.plane_specs()) == {
        "h_vtx", "h_lab", "v_vtx", "v_lab", "n_out", "n_in", "r_vtx",
        "r_lab", "r_in"}
    assert set(idx.aux_plane_specs()) == {"base_v", "base_l", "base_r",
                                          "d_vtx", "d_lab"}
    assert idx._comp["n_out"] is comp["n_out"]
    flags = idx.summary_flags()
    assert (flags["sat_out"] == (comp["n_out"].row_states
                                 == compressed.ALL_ONE)).all()


def test_index_size_scales_linearly():
    """O(V) index against the O(V^2) closure: doubling V grows the index
    about 2x (not 4x)."""
    cfg = tdr_build.TDRConfig(vtx_bits=128, g_max=4, k=3)
    s1 = tdr_build.build_index(G.erdos_renyi(300, 2.0, 8, seed=1), cfg,
                               device="cpu").size_bytes()
    s2 = tdr_build.build_index(G.erdos_renyi(600, 2.0, 8, seed=1), cfg,
                               device="cpu").size_bytes()
    assert s2 < 2.8 * s1
    v_paper = 200_000
    assert s2 / 600 * v_paper < v_paper * v_paper / 8 / 100


def test_hash_schedule_never_wraps():
    """All n_hashes Bloom position arrays are pairwise distinct and equal
    the JAX package's; the first three keys are the historical ones."""
    disc = np.arange(200, dtype=np.int64)
    for scheme in ("dfs-block", "mult"):
        cfg = tdr_build.TDRConfig(vtx_bits=256, n_hashes=8,
                                  hash_scheme=scheme)
        pos = tdr_build._vertex_hash_positions(cfg, disc)
        want = RB._vertex_hash_positions(
            RB.TDRConfig(vtx_bits=256, n_hashes=8, hash_scheme=scheme), disc)
        assert len(pos) == 8
        for i in range(len(pos)):
            np.testing.assert_array_equal(pos[i], want[i])
            for j in range(i + 1, len(pos)):
                assert not np.array_equal(pos[i], pos[j]), (scheme, i, j)
    ks = tdr_build._hash_keys(3)
    assert [int(k) for k in ks] == [0x9E3779B97F4A7C15, 0xC2B2AE3D27D4EB4F,
                                    0x165667B19E3779F9]
    assert [int(k) for k in tdr_build._hash_keys(9)] == \
        [int(k) for k in RB._hash_keys(9)]


def test_backend_env_override(monkeypatch):
    """``REPRO_ENGINE_BACKEND`` replaces the default resolution only, with
    the port's backend names; a backend asked for by name always wins."""
    cpu = torch.device("cpu")
    monkeypatch.setenv(engine.ENV_BACKEND, "matmul")
    assert engine.resolve_backend("auto", cpu) == "matmul"
    assert engine.resolve_backend("", cpu) == "matmul"
    assert engine.resolve_backend(None, cpu) == "matmul"
    assert engine.resolve_backend("segment", cpu) == "segment"
    g = G.erdos_renyi(20, 2.0, 3, seed=0)
    idx = tdr_build.build_index(g, tdr_build.TDRConfig(vtx_bits=32),
                                device="cpu")
    assert idx.engine().backend == "matmul"
    monkeypatch.setenv(engine.ENV_BACKEND, "segment")
    assert engine.resolve_backend("matmul", cpu) == "matmul"
    assert engine.resolve_backend("auto", cpu) == "segment"
    assert engine.resolve_backend("auto", torch.device("cuda")) == "segment"
    monkeypatch.setenv(engine.ENV_BACKEND, "pallas")
    with pytest.raises(ValueError):
        engine.resolve_backend("auto", cpu)
    monkeypatch.delenv(engine.ENV_BACKEND)
    assert engine.resolve_backend("auto", cpu) == "segment"
    assert engine.resolve_backend("auto", torch.device("cuda")) == "matmul"
    with pytest.raises(ValueError):
        engine.resolve_backend("mxu", cpu)


def test_incidence_plan_matches_bruteforce():
    """One- and two-level padded incidence reduce to the same segment OR
    (two-level triggers on the pa graph's hub tail)."""
    rng = np.random.default_rng(0)
    levels_seen = set()
    for kind in ("er", "pa"):
        g = G.random_graph(kind, 400, 4.0, 4, seed=0)
        keys = np.asarray(g.indices)
        plan = G.incidence_plan(keys, g.n_vertices, g.n_edges)
        levels_seen.add(len(plan))
        val = rng.integers(0, 2 ** 32, (g.n_edges + 1, 2), dtype=np.uint32)
        val[-1] = 0
        cur = val
        for level in plan:
            nxt = np.zeros((level.shape[0], 2), np.uint32)
            ok = level < cur.shape[0]
            for i in range(level.shape[0]):
                nxt[i] = np.bitwise_or.reduce(cur[level[i][ok[i]]], axis=0)
            cur = np.concatenate([nxt, np.zeros((1, 2), np.uint32)])
        want = np.zeros((g.n_vertices, 2), np.uint32)
        np.bitwise_or.at(want, keys, val[:g.n_edges])
        np.testing.assert_array_equal(cur[:g.n_vertices], want, err_msg=kind)
    assert levels_seen == {1, 2}, \
        "expected er to stay one-level and pa's hubs to trigger two-level"


def test_label_adjacency_cache_is_bounded():
    g = G.erdos_renyi(40, 2.0, 8, seed=0)
    eng = engine.make_engine(g, backend="matmul", device="cpu")
    for l in range(8):
        eng.label_class_adjacency((l,))
    assert len(eng._label_adj) <= engine.Engine.LABEL_ADJ_CACHE


def test_label_adjacency_makes_room_when_the_device_runs_out(monkeypatch):
    """A class stack whose copy to the device runs out of memory (another
    process on the card took what the cap saw free) drops the cached
    stacks and is copied again; the stack is the one packed."""
    g = G.erdos_renyi(40, 2.0, 8, seed=0)
    eng = engine.make_engine(g, backend="matmul", device="cpu")
    for l in range(3):
        eng.label_class_adjacency((l,))
    real, calls = bitset.np_to_words, []

    def once_out_of_memory(a, device):
        calls.append(len(eng._label_adj))
        if len(calls) == 1:
            raise torch.OutOfMemoryError("out of memory")
        return real(a, device)

    monkeypatch.setattr(bitset, "np_to_words", once_out_of_memory)
    got = eng.label_class_adjacency((5, 6))
    assert calls == [3, 0] and list(eng._label_adj) == [((5, 6), True)]
    want = engine.pack_label_class_edges_np(g.src, g.indices, g.labels,
                                            g.n_vertices, (5, 6))
    np.testing.assert_array_equal(bitset.words_to_np(got), want)


@pytest.mark.parametrize("backend", ["segment", "matmul"])
def test_dropped_index_frees_its_engine_without_the_collector(backend):
    """An index that answered queries (its engine caches a phase-2
    executor) is freed, engine and device operands with it, as soon as
    the last reference goes: no cycle waits for the cyclic collector.  A
    server drops its pre-update index at every swap."""
    import gc
    import weakref
    from repro_torch import pattern, tdr_query
    g = G.erdos_renyi(120, 3.0, 6, seed=0)
    gc.disable()
    try:
        idx = tdr_build.build_index(g, tdr_build.TDRConfig(**CFG),
                                    backend=backend, device="cpu")
        qs = [(u, (u * 7) % 120, pattern.all_of([u % 6]))
              for u in range(24)]
        tdr_query.answer_batch(idx, qs, backend=backend, device="cpu",
                               exact_mode="full")
        tdr_query.dist_batch(idx, qs[:4], backend=backend, device="cpu")
        eng = idx.engine(backend)
        assert eng._executor.index is idx
        alive = (weakref.ref(idx), weakref.ref(eng))
        del idx, eng
        assert [r() for r in alive] == [None, None]
    finally:
        gc.enable()


def test_index_caches_engines_and_adjacency():
    g = G.erdos_renyi(30, 2.0, 4, seed=0)
    idx = tdr_build.build_index(g, tdr_build.TDRConfig(**CFG),
                                backend="matmul", device="cpu")
    assert idx.engine("matmul") is idx.engine("matmul")
    adj = idx.engine("matmul").adjacency()
    assert adj is idx.engine("matmul").adjacency()
    # adjacency row u holds exactly u's successors
    bits = np.unpackbits(bitset.words_to_np(adj).view(np.uint8), axis=1,
                         bitorder="little")
    for u in range(g.n_vertices):
        np.testing.assert_array_equal(
            np.flatnonzero(bits[u][:g.n_vertices]),
            np.unique(g.successors(u)))
