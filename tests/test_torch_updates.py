"""Port live index against its own layout-pinned rebuild and against the
JAX package's update chain: ``Graph.apply_updates``, ``update_index`` on
both port backends (and ``matmul`` with block-sparse closures forced, so
the warm closures run over a ``patch_blocks`` operand on the CPU),
``Engine.apply_delta``, the row and block patch codecs, and the
compressed-plane cache carried across updates.  Exact equality
throughout: planes are bits."""
import functools

import numpy as np
import pytest
import torch

from repro.core import (compressed as rcomp, graph as RG,
                        tdr_build as RB)
from repro_torch import (bitset, compressed as C, convert, dfs_baseline,
                         engine, graph as G, pattern as pat, tdr_build,
                         tdr_query)
from test_torch_query import _ref_state

import _class_round_cases as rounds

CFG = tdr_build.TDRConfig(vtx_bits=64, g_max=4, k=3)
RCFG = RB.TDRConfig(vtx_bits=64, g_max=4, k=3)

# every array the index stores: the query-visible planes plus the
# incremental-maintenance state the next update chains from
PLANES = ("h_vtx", "h_lab", "v_vtx", "v_lab", "n_out", "n_in", "push",
          "pop", "g_count", "base_v", "base_l", "base_r", "r_vtx",
          "r_lab", "r_in", "d_vtx", "d_lab")
BLOCK_FIELDS = ("states", "slots", "pool", "mix_bi", "mix_bj", "mix_off",
                "one_off", "one_bj")
STAT_FIELDS = ("mode", "tail", "n_added", "n_removed", "dirty_fwd",
               "dirty_rev", "changed_rows", "patch_rows", "rounds")
REF_BACKEND = {"segment": "segment", "matmul": "pallas"}
N_V, N_L = 28, 4


def assert_planes_equal(a, b, ctx=""):
    """Two port indexes hold the same bits in every stored array."""
    for p in PLANES:
        x, y = getattr(a, p), getattr(b, p)
        assert x.dtype == y.dtype and torch.equal(x, y), \
            f"{ctx}: plane {p} differs ({int((x != y).sum())} cells)"
    assert np.array_equal(a.vtx_words, b.vtx_words), ctx
    assert np.array_equal(a.disc, b.disc), ctx


def assert_matches_reference(idx, ridx, ctx=""):
    """A port index holds the JAX package's index's bits."""
    for p in PLANES:
        got, want = getattr(idx, p).numpy(), np.asarray(getattr(ridx, p))
        assert np.array_equal(got.view(want.dtype), want), f"{ctx}: {p}"
    assert np.array_equal(idx.vtx_words, ridx.vtx_words), ctx
    assert np.array_equal(idx.disc, np.asarray(ridx.disc)), ctx


def assert_blocks_equal(a, b, ctx=""):
    """Every field of two block operands, the kernel's live lists too."""
    assert (a.shape, a.nbits, a.br, a.bw, a.n_mixed) == \
        (b.shape, b.nbits, b.br, b.bw, b.n_mixed), ctx
    for f in BLOCK_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and torch.equal(x.cpu(), y.cpu()), \
            f"{ctx}: {f}"


def _edges_of(g):
    return list(zip(g.src.tolist(), g.indices.tolist(), g.labels.tolist()))


def _random_step(rng, g):
    """One random update step: a mix of inserts, deletes, re-inserts,
    label changes, and deliberate no-ops."""
    add, rem = [], []
    edges = _edges_of(g)
    for _ in range(int(rng.integers(1, 4))):
        kind = int(rng.integers(5))
        if kind <= 1 or not edges:            # plain insert
            u, v = int(rng.integers(N_V)), int(rng.integers(N_V))
            if u != v:
                add.append((u, v, int(rng.integers(N_L))))
        elif kind == 2:                        # plain delete
            rem.append(edges[int(rng.integers(len(edges)))])
        elif kind == 3:                        # label change on one edge
            u, v, l = edges[int(rng.integers(len(edges)))]
            rem.append((u, v, l))
            add.append((u, v, int((l + 1) % N_L)))
        else:                                  # no-op add of existing edge
            add.append(edges[int(rng.integers(len(edges)))])
    if rng.integers(4) == 0 and rem:           # re-insertion
        add.append(rem[0])
    return add, rem


def _mixed_queries(rng, g, n=8):
    qs = []
    for i in range(n):
        u, v = int(rng.integers(g.n_vertices)), int(rng.integers(
            g.n_vertices))
        labs = rng.choice(g.n_labels, size=2, replace=False).tolist()
        p = [pat.all_of(labs), pat.any_of(labs), pat.none_of(labs),
             pat.parse(f"l{labs[0]} & !l{labs[1]}")][i % 4]
        qs.append((u, v, p))
    return qs


@pytest.fixture
def force_sparse(monkeypatch):
    """Boolean closures take the block-sparse path on every backend and
    device (on the CPU ``auto`` runs them dense, as the reference's
    interpret mode does), so ``apply_delta`` has block operands to
    patch."""
    orig = engine.Engine.closure

    def closure(self, base, *, sparse=None, **kw):
        return orig(self, base, sparse=True if sparse is None else sparse,
                    **kw)
    monkeypatch.setattr(engine.Engine, "closure", closure)


def _build(g, backend, **kw):
    return tdr_build.build_index(g, CFG, backend=backend, device="cpu",
                                 **kw)


def _fresh_block_operand(g, reverse, comp):
    return C.compress_blocks(engine.pack_adjacency_np(g, reverse=reverse),
                             br=comp.br, bw=comp.bw, nbits=g.n_vertices,
                             device="cpu")


# ------------------------------------------------------------ update chains
N_INTERLEAVINGS = {"segment": 30, "matmul": 14, "matmul-sparse": 10}


@pytest.mark.parametrize("leg", list(N_INTERLEAVINGS))
def test_update_interleavings_bit_identical(leg, request):
    """update_index over random insert/delete interleavings ==
    build_index(final graph, layout=frozen) on every plane; answers on the
    updated index match the DFS oracle.  The sparse leg also holds every
    patched block operand equal to ``compress_blocks`` of the new graph."""
    backend = leg.split("-")[0]
    sparse = leg.endswith("sparse")
    if sparse:
        request.getfixturevalue("force_sparse")
    for trial in range(N_INTERLEAVINGS[leg]):
        rng = np.random.default_rng(1000 + trial)
        g = G.random_graph(["er", "pa"][trial % 2], N_V, 2.0, N_L,
                           seed=trial)
        idx0 = _build(g, backend)
        cur, curg = idx0, g
        for _ in range(int(rng.integers(1, 4))):
            add, rem = _random_step(rng, curg)
            delta = curg.apply_updates(add, rem)
            # threshold 2.0 forces the incremental path (the rebuild
            # fallback has its own test below)
            cur = tdr_build.update_index(cur, delta, backend=backend,
                                         rebuild_threshold=2.0,
                                         device="cpu")
            curg = delta.graph
            if sparse and delta.n_changes:
                bcomp = cur.engine(backend)._bcomp
                assert set(bcomp) == {False, True}
                for rev, comp in bcomp.items():
                    assert_blocks_equal(
                        comp, _fresh_block_operand(curg, rev, comp),
                        f"{leg} trial={trial} reverse={rev}")
        ref = _build(curg, backend, layout=idx0.disc)
        assert_planes_equal(cur, ref, f"{leg} trial={trial}")
        if trial % 5 == 0:
            qs = _mixed_queries(rng, curg)
            got = tdr_query.answer_batch(cur, qs, backend=backend,
                                         device="cpu")
            want = [dfs_baseline.answer_pcr(curg, u, v, p)
                    for u, v, p in qs]
            assert got.tolist() == want, f"{leg} trial={trial}"


@functools.lru_cache(maxsize=None)
def _reference_chain(kind, seed, backend, thresh):
    """The JAX package's update chain: (deltas, indexes, stats)."""
    rng = np.random.default_rng(500 + seed)
    rg = RG.random_graph(kind, N_V, 2.0, N_L, seed=seed)
    ridx = RB.build_index(rg, RCFG, backend=REF_BACKEND[backend])
    steps = []
    for _ in range(4):
        add, rem = _random_step(rng, rg)
        delta = rg.apply_updates(add, rem)
        st = RB.UpdateStats()
        ridx = RB.update_index(ridx, delta, backend=REF_BACKEND[backend],
                               rebuild_threshold=thresh, stats=st)
        steps.append((add, rem, delta, ridx, st))
        rg = delta.graph
    return steps


@pytest.mark.parametrize("thresh", [0.5, 2.0, 0.02])
@pytest.mark.parametrize("backend", ["segment", "matmul"])
@pytest.mark.parametrize("kind,seed", [("er", 3), ("pa", 4)])
def test_update_chain_matches_reference(kind, seed, backend, thresh):
    """Step by step, the port's chain equals the JAX package's on the same
    deltas: the effective delta, all 17 planes and every ``UpdateStats``
    counter (mode, tail, rounds, dirty, changed and patched rows).  The
    three thresholds reach rebuild, row patch and full tail."""
    g = G.random_graph(kind, N_V, 2.0, N_L, seed=seed)
    cur = _build(g, backend)
    for i, (add, rem, rdelta, ridx, rst) in enumerate(
            _reference_chain(kind, seed, backend, thresh)):
        delta = g.apply_updates(add, rem)
        assert np.array_equal(delta.added, rdelta.added)
        assert np.array_equal(delta.removed, rdelta.removed)
        st = tdr_build.UpdateStats()
        cur = tdr_build.update_index(cur, delta, backend=backend,
                                     rebuild_threshold=thresh, stats=st,
                                     device="cpu")
        g = delta.graph
        ctx = f"{kind} {backend} thresh={thresh} step={i}"
        for f in STAT_FIELDS:
            assert getattr(st, f) == getattr(rst, f), f"{ctx}: {f}"
        assert_matches_reference(cur, ridx, ctx)


@pytest.mark.parametrize("backend", ["segment", "matmul"])
def test_update_threshold_paths_agree(backend):
    """Row patch, full tail and rebuild fallback all give the same bits;
    UpdateStats reports which path ran."""
    g = G.random_graph("er", N_V, 2.0, N_L, seed=5)
    idx = _build(g, backend)
    delta = g.apply_updates([(0, 7, 1), (3, 11, 2), (20, 5, 0)], [])
    outs = {}
    for name, thresh in [("patch", 2.0), ("full", 0.02), ("rebuild", 0.0)]:
        st = tdr_build.UpdateStats()
        outs[name] = tdr_build.update_index(idx, delta, backend=backend,
                                            rebuild_threshold=thresh,
                                            stats=st, device="cpu")
        want = ("rebuild", "") if name == "rebuild" else \
            ("incremental", name)
        assert (st.mode, st.tail) == want, st
    ref = _build(delta.graph, backend, layout=idx.disc)
    for name, out in outs.items():
        assert_planes_equal(out, ref, name)


def test_update_noop_and_validation():
    g = G.fig2_example()
    idx = _build(g, None)
    st = tdr_build.UpdateStats()
    # adding an existing edge / removing a missing one is a no-op and
    # returns the index object unchanged
    same = tdr_build.update_index(idx, edges_added=[(0, 1, 0)],
                                  edges_removed=[(9, 0, 0)], stats=st,
                                  device="cpu")
    assert same is idx and st.mode == "noop"
    with pytest.raises(ValueError):
        g.apply_updates([(0, 99, 0)])
    with pytest.raises(ValueError):
        g.apply_updates([(0, 1, 99)])
    with pytest.raises(TypeError):
        tdr_build.update_index(idx, delta=[(0, 1, 0)], device="cpu")
    # a foreign-universe delta is rejected
    other = G.erdos_renyi(5, 1.0, 2, seed=0)
    with pytest.raises(ValueError):
        tdr_build.update_index(idx, other.apply_updates([(0, 1, 0)]),
                               device="cpu")


def test_apply_updates_set_semantics():
    g = G.fig2_example()
    # remove + re-add the same edge in one batch -> net no-op
    d = g.apply_updates([(0, 1, 0)], [(0, 1, 0)])
    assert d.n_changes == 0 and d.graph.n_edges == g.n_edges
    # effective delta filters no-ops; duplicates collapse
    d = g.apply_updates([(2, 7, 3), (2, 7, 3), (0, 1, 0)], [(5, 9, 2)])
    assert d.added.tolist() == [[2, 7, 3]]
    assert d.removed.tolist() == [[5, 9, 2]]
    # parallel labels are distinct edges: removing one keeps the other
    d2 = g.apply_updates([], [(0, 2, 0)])
    assert (0, 2, 1) in _edges_of(d2.graph)
    assert (0, 2, 0) not in _edges_of(d2.graph)
    assert g.out_edges(0)[0].tolist() == [1, 2, 2, 8]


@pytest.mark.parametrize("seed", range(4))
def test_apply_updates_matches_reference(seed):
    """The same batch gives the same CSR and effective delta as the JAX
    package's ``Graph.apply_updates``."""
    rng = np.random.default_rng(seed)
    g = G.random_graph("pa", N_V, 2.0, N_L, seed=seed)
    rg = RG.random_graph("pa", N_V, 2.0, N_L, seed=seed)
    for _ in range(3):
        add, rem = _random_step(rng, g)
        d, rd = g.apply_updates(add, rem), rg.apply_updates(add, rem)
        for f in ("indptr", "indices", "labels"):
            got, want = getattr(d.graph, f), getattr(rd.graph, f)
            assert got.dtype == want.dtype and np.array_equal(got, want), f
        for f in ("added", "removed"):
            got, want = getattr(d, f), getattr(rd, f)
            assert got.dtype == want.dtype and np.array_equal(got, want), f
        g, rg = d.graph, rd.graph


def test_layout_pin_matches_chain_from_empty_regions():
    """Chained updates through structurally drastic states (vertex loses
    all out-edges, then regains) stay bit-identical."""
    g = G.fig2_example()
    idx0 = _build(g, None)
    out0 = [(0, v, l) for v, l in zip(*g.out_edges(0))]
    d1 = g.apply_updates([], out0)            # strip all of v0's edges
    i1 = tdr_build.update_index(idx0, d1, rebuild_threshold=2.0,
                                device="cpu")
    d2 = d1.graph.apply_updates(out0, [])     # regain them
    i2 = tdr_build.update_index(i1, d2, rebuild_threshold=2.0, device="cpu")
    assert_planes_equal(i1, _build(d1.graph, None, layout=idx0.disc),
                        "stripped")
    assert_planes_equal(i2, _build(d2.graph, None, layout=idx0.disc),
                        "regained")


# ------------------------------------------------------- engine operands
@pytest.mark.parametrize("seed", [11, 12, 13])
def test_engine_apply_delta_carries_edge_lists(seed):
    """Cached edge lists carry over an update rebuilt from the new graph:
    each direction's equals the lists a fresh engine builds, holds the new
    class stacks' edges, the old engine's lists are unchanged, the new
    engine keeps the reverse CSR the rebuild read, and nothing counts as
    a miss or in ``engine.jit_cache_entries``."""
    rng = np.random.default_rng(seed)
    g = G.random_graph("er", N_V, 2.0, N_L, seed=seed)
    eng = engine.make_engine(g, backend="matmul", device="cpu")
    before = {r: tuple(t.clone() for t in eng.edge_lists(reverse=r)[:3])
              for r in (True, False)}
    add, rem = _random_step(rng, g)
    add.append((0, 1, 2))                      # at least one real change
    delta = g.apply_updates(add, rem)
    n0, packs0 = engine.jit_cache_entries(), dict(engine.LABEL_CLASS_PACKS)
    eng2 = eng.apply_delta(delta.graph, delta.added, delta.removed,
                           device="cpu")
    assert engine.jit_cache_entries() == n0
    assert dict(engine.LABEL_CLASS_PACKS) == packs0
    assert list(eng2._edge_lists) == list(eng._edge_lists) == [True, False]
    h = delta.graph
    want_rev = h.reverse()
    assert np.array_equal(eng2._rev_graph.indptr, want_rev.indptr)
    assert np.array_equal(eng2._rev_graph.indices, want_rev.indices)
    fresh = engine.make_engine(h, backend="matmul", device="cpu")
    for rev, old in before.items():
        got = eng2._edge_lists[rev]
        want = fresh.edge_lists(reverse=rev)
        for a, b in zip(got[:3], want[:3]):
            assert torch.equal(a, b), rev
        assert got.n_labels == want.n_labels
        for labels in ((0, 2), (1,)):
            stack = engine.pack_label_class_edges_np(
                h.src, h.indices, h.labels, h.n_vertices, labels,
                reverse=rev)
            assert np.array_equal(bitset.words_to_np(
                rounds.stacks_of_lists(got, labels)), stack), (labels, rev)
        for a, b in zip(eng._edge_lists[rev][:3], old):
            assert torch.equal(a, b), rev


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_engine_apply_delta_patches_label_class_stacks(seed):
    """Cached label-class stacks carry over an update patched, not
    repacked: each equals packing the new graph's classes, the old
    engine's stacks are unchanged, their LRU order is kept, and nothing
    counts as a pack in ``engine.jit_cache_entries``."""
    rng = np.random.default_rng(seed)
    g = G.random_graph("er", N_V, 2.0, N_L, seed=seed)
    eng = engine.make_engine(g, backend="matmul", device="cpu")
    keys = [((0, 2), True), ((0, 2), False), ((1,), True)]
    before = [eng.label_class_adjacency(l, reverse=r).clone()
              for l, r in keys]
    add, rem = _random_step(rng, g)
    add.append((0, 1, 2))                      # at least one real change
    delta = g.apply_updates(add, rem)
    n0 = engine.jit_cache_entries()
    eng2 = eng.apply_delta(delta.graph, delta.added, delta.removed,
                           device="cpu")
    assert engine.jit_cache_entries() == n0
    assert list(eng2._label_adj) == list(eng._label_adj) == keys
    h = delta.graph
    for (labels, rev), old in zip(keys, before):
        want = engine.pack_label_class_edges_np(
            h.src, h.indices, h.labels, h.n_vertices, labels, reverse=rev)
        assert np.array_equal(bitset.words_to_np(
            eng2._label_adj[(labels, rev)]), want), (labels, rev)
        assert torch.equal(eng._label_adj[(labels, rev)], old)


@pytest.mark.parametrize("operand", ["dense", "block"])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("seed", [11, 12, 13])
def test_engine_apply_delta_patches_adjacency(seed, reverse, operand):
    """Engine.apply_delta's patched dense adjacency == repacking the new
    graph; its patched block operand == ``compress_blocks`` of the new
    graph in every field, the live lists included.  The old engine's
    operands are unchanged, and the new engine has every attribute a
    fresh one has."""
    rng = np.random.default_rng(seed)
    g = G.random_graph("er", N_V, 2.0, N_L, seed=seed)
    eng = engine.make_engine(g, backend="matmul", device="cpu")
    if operand == "dense":
        old = eng.adjacency(reverse=reverse)
    else:
        old = eng.block_adjacency(reverse=reverse)
    before = [t.clone() for t in ((old,) if operand == "dense" else
                                  (getattr(old, f) for f in BLOCK_FIELDS))]
    add, rem = _random_step(rng, g)
    add.append((0, 1, 2))                      # at least one real change
    delta = g.apply_updates(add, rem)
    eng2 = eng.apply_delta(delta.graph, delta.added, delta.removed,
                           device="cpu")
    assert set(vars(eng2)) == set(vars(engine.make_engine(
        delta.graph, backend="matmul", device="cpu")))
    assert eng2.backend == eng.backend and eng2.config is eng.config
    assert eng2.device == eng.device and not eng2._label_adj
    if operand == "dense":
        got = bitset.words_to_np(eng2._adj[reverse])
        want = engine.pack_adjacency_np(delta.graph, reverse=reverse)
        assert np.array_equal(got, want)
        assert torch.equal(eng.adjacency(reverse=reverse), before[0])
    else:
        comp2 = eng2._bcomp[reverse]
        assert_blocks_equal(comp2, _fresh_block_operand(delta.graph,
                                                        reverse, comp2))
        np.testing.assert_array_equal(
            C.decompress_blocks(comp2),
            engine.pack_adjacency_np(delta.graph, reverse=reverse))
        for f, t in zip(BLOCK_FIELDS, before):
            assert torch.equal(getattr(old, f), t), f


def test_update_leaves_old_index_and_jax_arrays_untouched():
    """update_index writes no plane of the index it starts from, nor the
    JAX arrays a converted index shares its memory with, on the row-patch
    and the full-tail paths."""
    rg = RG.random_graph("er", N_V, 2.0, N_L, seed=8)
    ridx = RB.build_index(rg, RCFG, backend="segment")
    jax_before = {p: np.array(getattr(ridx, p)) for p in PLANES}
    idx = convert.index_from_numpy(_ref_state(ridx), device="cpu")
    before = {p: getattr(idx, p).clone() for p in PLANES}
    add = [(0, 9, 1), (4, 17, 3)]
    # a removal re-seeds its source, which the full-tail leg's threshold
    # would send to a rebuild, so that leg only inserts
    for thresh, tail, rem in ((2.0, "patch", [_edges_of(idx.graph)[0]]),
                              (0.03, "full", [])):
        st = tdr_build.UpdateStats()
        tdr_build.update_index(idx, idx.graph.apply_updates(add, rem),
                               rebuild_threshold=thresh, stats=st,
                               device="cpu")
        assert st.tail == tail, st
        for p in PLANES:
            assert torch.equal(getattr(idx, p), before[p]), p
            assert np.array_equal(np.asarray(getattr(ridx, p)),
                                  jax_before[p]), p


# -------------------------------------------------------- patch codecs
def _mix_rows(rng, n, w, nbits, p_zero=0.3, p_one=0.3):
    """Random packed rows with a heavy mix of all-zero / all-one rows."""
    masks = C._valid_masks(w, nbits)
    rows = (rng.integers(0, 2 ** 32, size=(n, w), dtype=np.uint32)
            & masks[None, :])
    u = rng.random(n)
    rows[u < p_zero] = 0
    rows[u > 1 - p_one] = masks[None, :]
    return rows


@pytest.mark.parametrize("seed", range(12))
def test_patch_rows_matches_fresh_compress(seed):
    """A patched plane is in the canonical form of a fresh compression,
    and equals the JAX package's ``patch_rows`` of the same patch."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 40))
    w = int(rng.integers(1, 5))
    nbits = int(rng.integers(1, w * 32 + 1))
    rows = _mix_rows(rng, n, w, nbits)
    c = C.compress(rows, nbits=nbits)
    sel = rng.choice(n, size=int(rng.integers(0, n + 1)), replace=False)
    new = _mix_rows(rng, sel.size, w, nbits)
    rows2 = rows.copy()
    rows2[sel] = new
    c2 = c.patch_rows(sel, new)
    np.testing.assert_array_equal(c2.decompress(), rows2)
    assert c2.same_as(C.compress(rows2, nbits=nbits))
    r2 = rcomp.compress(rows, nbits=nbits).patch_rows(sel, new)
    for f in ("row_states", "mix_rows", "word_states", "pool", "pool_off"):
        got, want = getattr(c2, f), getattr(r2, f)
        assert got.dtype == want.dtype and np.array_equal(got, want), f
    assert (c2.nbytes, c2.dense_nbytes, c2.ratio) == \
        (r2.nbytes, r2.dense_nbytes, r2.ratio)


@pytest.mark.parametrize("m,kw,nbits,br,bw", [
    (1, 1, 1, 8, 1),     # single row, single valid bit
    (5, 2, 37, 8, 1),    # row tail: m not a multiple of br
    (16, 4, 128, 4, 2),  # multi-word blocks, exact grid
    (9, 3, 70, 8, 1),    # both tails partial
])
def test_blocks_roundtrip(m, kw, nbits, br, bw):
    rng = np.random.default_rng(m * 31 + kw)
    a = _mix_rows(rng, m, kw, nbits)
    c = C.compress_blocks(a, br=br, bw=bw, nbits=nbits, device="cpu")
    np.testing.assert_array_equal(C.decompress_blocks(c), a)
    zeros = np.zeros_like(a)
    cz = C.compress_blocks(zeros, br=br, bw=bw, nbits=nbits, device="cpu")
    np.testing.assert_array_equal(C.decompress_blocks(cz), zeros)
    assert cz.n_mixed == 0


@pytest.mark.parametrize("seed", range(16))
def test_patch_blocks_matches_fresh(seed):
    """``patch_blocks`` == ``compress_blocks`` of the patched matrix in
    every field (states, slots, pool, MIXED list and the kernel's live
    lists ``mix_off``/``one_off``/``one_bj``), and equals the JAX
    package's ``patch_blocks`` on the fields both have."""
    rng = np.random.default_rng(seed)
    m = int(rng.integers(1, 40))
    kw = int(rng.integers(1, 4))
    nbits = int(rng.integers(1, kw * 32 + 1))
    br, bw = [(8, 1), (4, 2), (2, 1), (16, 1)][seed % 4]
    a = _mix_rows(rng, m, kw, nbits)
    c = C.compress_blocks(a, br=br, bw=bw, nbits=nbits, device="cpu")
    sel = np.sort(rng.choice(m, size=int(rng.integers(1, m + 1)),
                             replace=False))
    new = _mix_rows(rng, sel.size, kw, nbits)
    a2 = a.copy()
    a2[sel] = new
    c2 = C.patch_blocks(c, sel, new)
    np.testing.assert_array_equal(C.decompress_blocks(c2), a2)
    assert_blocks_equal(c2, C.compress_blocks(a2, br=br, bw=bw, nbits=nbits,
                                              device="cpu"))
    rc2 = rcomp.patch_blocks(rcomp.compress_blocks(a, br=br, bw=bw,
                                                   nbits=nbits), sel, new)
    assert c2.n_mixed == int(rc2.n_mixed)
    for f in ("states", "slots", "pool", "mix_bi", "mix_bj"):
        want = np.asarray(getattr(rc2, f))
        got = getattr(c2, f).numpy().view(want.dtype)
        assert np.array_equal(got, want), f
    # patching with a tensor of the new words gives the same operand
    assert_blocks_equal(C.patch_blocks(c, sel, bitset.np_to_words(new,
                                                                  "cpu")),
                        c2)


# ------------------------------------------ cache carry across update chains
N_TRIALS = {"segment": 16, "matmul": 8}


@pytest.mark.parametrize("backend", ["segment", "matmul"])
def test_compressed_cache_tracks_update_interleavings(backend):
    """Seed the compressed-plane cache, then chain random update steps:
    after every ``update_index`` the carried cache decompresses to, and
    is in the canonical form of, a fresh compression of every plane."""
    for trial in range(N_TRIALS[backend]):
        rng = np.random.default_rng(7000 + trial)
        g = G.random_graph(["er", "pa"][trial % 2], N_V, 2.0, N_L,
                           seed=trial)
        cur = _build(g, backend)
        cur.compressed_planes()       # seed the cache so updates carry it
        curg = g
        for _ in range(int(rng.integers(1, 4))):
            add, rem = _random_step(rng, curg)
            delta = curg.apply_updates(add, rem)
            cur = tdr_build.update_index(cur, delta, backend=backend,
                                         rebuild_threshold=2.0,
                                         device="cpu")
            curg = delta.graph
            comp = cur.compressed_planes()
            for name, (arr, nbits) in cur.plane_specs().items():
                dense = bitset.words_to_np(arr)
                np.testing.assert_array_equal(
                    comp[name].decompress(), dense,
                    err_msg=f"{backend} trial={trial} plane={name}")
                assert comp[name].same_as(C.compress(dense, nbits=nbits)), \
                    f"{backend} trial={trial} plane={name}: non-canonical"


def test_device_with_and_without_index_agree():
    """A device named with an index matches the same device named
    without one (an index's tensors report ``cuda:0`` where an engine
    was made for ``cuda``); a different device type is refused."""
    g = G.fig2_example()
    idx = _build(g, "matmul")
    delta = g.apply_updates([(4, 0, 3)], [])
    out = tdr_build.update_index(idx, delta, device="cpu:0")
    eng = idx.engine("matmul").apply_delta(delta.graph, delta.added,
                                           delta.removed, device="cpu:0")
    assert out.device.type == eng.device.type == "cpu"
    with pytest.raises(ValueError, match="asked to run on meta"):
        tdr_build.update_index(idx, delta, device="meta")
