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
