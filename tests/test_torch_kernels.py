"""Port kernels: plain PyTorch versions against the JAX package's Pallas
kernels (interpret mode) and jnp oracles.  All comparisons are exact: the
data is bits.  The CUDA kernels against these plain versions on a card
are in ``test_torch_cuda.py``, which imports no JAX."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitset as rbitset, compressed as rcomp
from repro.kernels import block_sparse as rbs, ops as rops, ref as rref
from repro_torch import bitset, compressed, graph as G
from repro_torch.kernels import ops, ref

import _class_round_cases as rounds

B1_SHAPES = [
    (8, 32, 1), (16, 64, 2), (50, 96, 3), (130, 256, 5), (1, 32, 1),
    (257, 160, 7), (64, 1024, 4), (128, 128, 128), (100, 224, 40),
    (70, 64, 33),
]
# the ragged shapes also run the Pallas kernel itself (interpret mode);
# the reference's own tests hold it equal to its jnp oracle on the rest
B1_INTERPRET = {(1, 32, 1), (100, 224, 40), (70, 64, 33), (16, 64, 2)}
B2_SHAPES = [(5, 2, 1, 1, 1), (37, 4, 3, 3, 2), (128, 4, 2, 8, 2),
             (1, 1, 4, 2, 2)]
# (m, kw, w, br, bw, nbits): block grids with ragged row / column tails
B3_SHAPES = [(96, 3, 5, 8, 1, 90), (64, 4, 2, 8, 1, 128),
             (37, 5, 3, 4, 2, 150), (200, 8, 32, 8, 1, 250)]


@pytest.fixture
def one_thread():
    """One intra-op thread for the test: its ops are small, and parallel
    test workers then do not oversubscribe the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a: np.ndarray, device="cpu") -> torch.Tensor:
    return bitset.np_to_words(a, device)


def _np(t: torch.Tensor) -> np.ndarray:
    return bitset.words_to_np(t)


def _b1_inputs(m, k, w, density, seed):
    rng = np.random.default_rng(seed)
    a = rbitset.pack_bits_np(rng.random((m, k)) < density)
    x = rng.integers(0, 2 ** 32, size=(k, w), dtype=np.uint32)
    return a, x


def _b2_inputs(j, g, k, wv, wl, seed):
    rng = np.random.default_rng(seed)

    def words(*shape):
        return rng.integers(0, 2 ** 32, shape, dtype=np.uint32)

    vb = words(j, wv) & words(j, wv) & words(j, wv)
    rq = words(j, wl) & words(j, wl)
    npl = np.zeros(wl, np.uint32)
    npl[-1] = 1 << 31
    return [words(j, g, wv), words(j, g, wl), words(j, g, k, wv),
            words(j, g, k, wl), vb, rq, words(j, wl), npl]


def _b3_inputs(m, kw, w, nbits, seed):
    """A with ZERO, ONE and MIXED blocks; X with dead k-blocks."""
    rng = np.random.default_rng(seed)
    a = rng.random((m, kw * 32)) < 0.05
    a[:16] = True                      # ONE blocks (valid columns)
    a[20:28, 32:64] = True
    a[32:40, :] = False                # ZERO strip
    a[:, nbits:] = False
    x = rng.integers(0, 2 ** 32, (nbits, w), dtype=np.uint32)
    x[:40] = 0                         # a dead leading k-block
    return rbitset.pack_bits_np(a), x


# ------------------------------------------------------------- bitset.py
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_segment_or_words_matches_reference(seed):
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, 2 ** 32, (64, 3), dtype=np.uint32)
    seg = rng.integers(0, 17, size=64)
    want = np.asarray(rbitset.segment_or_words(
        jnp.asarray(vals), jnp.asarray(seg), num_segments=17, chunk_words=2))
    got = _np(bitset.segment_or_words(_t(vals), torch.from_numpy(seg),
                                      num_segments=17, chunk_words=2))
    np.testing.assert_array_equal(got, want)


def test_pack_unpack_roundtrip_sign_bit():
    bits = np.zeros((3, 70), dtype=bool)
    bits[0, 31] = bits[1, 63] = bits[2, :] = True
    packed = bitset.pack_bits(torch.from_numpy(bits))
    np.testing.assert_array_equal(_np(packed), rbitset.pack_bits_np(bits))
    assert int(packed[0, 0]) == -2 ** 31          # bit 31 is the sign bit
    np.testing.assert_array_equal(
        bitset.unpack_bits(packed, 70).numpy(), bits)
    np.testing.assert_array_equal(
        _np(bitset.or_reduce(packed, axis=0)), rbitset.pack_bits_np(
            bits.any(axis=0)))


# ---------------------------------------------------------------- B1
@pytest.mark.parametrize("m,k,w", B1_SHAPES)
@pytest.mark.parametrize("density", [0.02, 0.3])
def test_bitset_matmul_plain_matches_reference(m, k, w, density):
    a, x = _b1_inputs(m, k, w, density, seed=m * 7 + k + w)
    got = _np(ops.frontier_step(_t(a), _t(x)))
    want_ref = np.asarray(rref.bitset_matmul_ref(jnp.asarray(a),
                                                 jnp.asarray(x)))
    np.testing.assert_array_equal(got, want_ref)
    if (m, k, w) in B1_INTERPRET:
        want_kernel = np.asarray(rops.frontier_step(
            jnp.asarray(a), jnp.asarray(x), mode="interpret"))
        np.testing.assert_array_equal(got, want_kernel)


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("m,k,w", [(8, 32, 1), (50, 96, 3), (70, 64, 33),
                                   (130, 256, 5)])
def test_frontier_step_mxu_matches_reference(m, k, w):
    """The unpacked bf16 lowering equals the reference's and the packed
    product bit for bit."""
    a, x = _b1_inputs(m, k, w, 0.3, seed=m + k + w)
    got = _np(ops.frontier_step_mxu(_t(a), _t(x)))
    want = np.asarray(rops.frontier_step_mxu(jnp.asarray(a),
                                             jnp.asarray(x)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _np(ops.frontier_step(_t(a), _t(x))))


def test_frontier_step_is_one_bfs_round():
    """One expansion round == one BFS frontier step on a real graph."""
    g = G.erdos_renyi(64, 3.0, 2, seed=0)
    adj = np.zeros((64, 64), dtype=bool)
    adj[g.src, g.indices] = True
    eye = bitset.pack_bits(torch.eye(64, dtype=torch.bool))
    out = ops.frontier_step(bitset.pack_bits(torch.from_numpy(adj)), eye)
    np.testing.assert_array_equal(bitset.unpack_bits(out, 64).numpy(), adj)


# ---------------------------------------------------------------- B2
@pytest.mark.parametrize("j,g,k,wv,wl", B2_SHAPES)
def test_way_filter_plain_matches_reference(j, g, k, wv, wl):
    arrs = _b2_inputs(j, g, k, wv, wl, seed=j + g + k)
    got = ops.filter_ways(*(_t(a) for a in arrs)).numpy()
    rargs = [jnp.asarray(a) for a in arrs]
    np.testing.assert_array_equal(
        got, np.asarray(rops.filter_ways(*rargs, mode="ref")))
    np.testing.assert_array_equal(
        got, np.asarray(rops.filter_ways(*rargs, mode="interpret")))


def _b2_plane_inputs(n, j, g, k, wv, wl, seed):
    """Index planes over ``n`` vertices, dense enough (and target bits
    sparse enough) that ways both pass and fail; job endpoints with a
    repeated ``u`` and a padding job (vertex 0, empty pattern) last."""
    rng = np.random.default_rng(seed)

    def words(*shape, ors=1, ands=1):
        w = rng.integers(0, 2 ** 32, shape, dtype=np.uint32)
        for _ in range(ors - 1):
            w |= rng.integers(0, 2 ** 32, shape, dtype=np.uint32)
        for _ in range(ands - 1):
            w &= rng.integers(0, 2 ** 32, shape, dtype=np.uint32)
        return w

    npl = np.zeros(wl, np.uint32)
    npl[-1] = 1 << 31
    planes = [words(n, wv, ands=4), words(n, g, wv, ors=3),
              words(n, g, wl, ors=3), words(n, g, k, wv, ors=3),
              words(n, g, k, wl, ands=3)]
    u, v = rng.integers(0, n, j), rng.integers(0, n, j)
    u[: j // 2] = u[0]
    rq, fb = words(j, wl, ands=3), words(j, wl, ors=2)
    u[-1] = v[-1] = 0
    rq[-1] = fb[-1] = 0
    return u, v, rq, fb, npl, planes


@pytest.mark.parametrize("j,g,k,wv,wl", B2_SHAPES + [(40, 3, 3, 8, 2)])
def test_way_filter_at_plain_matches_reference(j, g, k, wv, wl):
    """The fused entry on the index planes and job endpoints equals the
    JAX ``filter_ways`` on the rows gathered with numpy."""
    u, v, rq, fb, npl, (vtx, hv, hl, vv, vl) = _b2_plane_inputs(
        11, j, g, k, wv, wl, seed=j * g + k)
    got = ops.filter_ways_at(torch.from_numpy(u), torch.from_numpy(v),
                             _t(rq), _t(fb), _t(npl), _t(vtx), _t(hv),
                             _t(hl), _t(vv), _t(vl)).numpy()
    if j * g >= 40:
        assert 0 < got.sum() < got.size       # ways both pass and fail
    rargs = [jnp.asarray(a) for a in (hv[u], hl[u], vv[u], vl[u], vtx[v],
                                      rq, fb, npl)]
    np.testing.assert_array_equal(
        got, np.asarray(rops.filter_ways(*rargs, mode="ref")))
    np.testing.assert_array_equal(
        got, np.asarray(rops.filter_ways(*rargs, mode="interpret")))


# ---------------------------------------------------------------- B3
@pytest.mark.parametrize("m,kw,w,br,bw,nbits", B3_SHAPES)
def test_block_sparse_plain_matches_reference(m, kw, w, br, bw, nbits):
    a, x = _b3_inputs(m, kw, w, nbits, seed=m + kw)
    comp = compressed.compress_blocks(a, br=br, bw=bw, nbits=nbits,
                                      device="cpu")
    rc = rcomp.compress_blocks(a, br=br, bw=bw, nbits=nbits)
    np.testing.assert_array_equal(comp.states.numpy(), np.asarray(rc.states))
    np.testing.assert_array_equal(comp.slots.numpy(), np.asarray(rc.slots))
    np.testing.assert_array_equal(_np(comp.pool), np.asarray(rc.pool))
    assert {0, 1, 2} <= set(np.unique(comp.states.numpy()).tolist())
    got = _np(ops.frontier_step_sparse(comp, _t(x)))
    xj = jnp.asarray(x)
    np.testing.assert_array_equal(
        got, np.asarray(rbs.block_sparse_matmul_ref(rc, xj)))
    if bw > 1 or w > 8:
        np.testing.assert_array_equal(
            got, np.asarray(rbs.block_sparse_matmul(rc, xj, interpret=True)))
    dense = np.asarray(rref.bitset_matmul_ref(
        jnp.asarray(a), jnp.asarray(np.pad(x, ((0, kw * 32 - nbits),
                                               (0, 0))))))
    np.testing.assert_array_equal(got, dense)


# ---------------------------------------------------------------- B4
# (m, k, w): the reference's test shape and ragged ones (k off the word
# grid, w off every tile)
B4_SHAPES = [(24, 37, 6), (70, 64, 33), (1, 32, 1), (130, 200, 7)]
# (op, lane dtype, cap): every op at every lane width the semirings use
B4_CASES = [("min", "uint16", 0), ("min", "uint8", 0),
            ("sum", "uint32", (1 << 15) - 1), ("sum", "uint16", 1000),
            ("or", "uint8", 0), ("or", "uint32", 0)]
_STORED = {"uint8": np.uint8, "uint16": np.int16, "uint32": np.int32}


def _lanes(a: np.ndarray) -> torch.Tensor:
    """numpy unsigned lanes -> the port's stored lanes (same bits)."""
    return torch.from_numpy(np.ascontiguousarray(a).view(
        _STORED[a.dtype.name]))


def _lane_inputs(m, k, w, op, dt, cap, seed):
    """A with ~30% bits; X lanes with rows at INF, INF-1 and the cap."""
    rng = np.random.default_rng(seed)
    a = rbitset.pack_bits_np(rng.random((m, k)) < 0.3)
    hi = cap if op == "sum" else int(np.iinfo(dt).max)
    x = rng.integers(0, hi + 1, size=(k, w)).astype(dt)
    x[0] = hi
    if k > 2:
        x[1], x[2] = hi - 1, cap
    return a, x


@pytest.mark.parametrize("m,k,w", B4_SHAPES)
@pytest.mark.parametrize("op,dt,cap", B4_CASES)
def test_lane_matmul_plain_matches_reference(m, k, w, op, dt, cap):
    a, x = _lane_inputs(m, k, w, op, dt, cap, seed=m + k + w)
    xp = np.pad(x, ((0, a.shape[1] * 32 - k), (0, 0)))
    got = ops.frontier_step_lanes(_t(a), _lanes(xp), op=op, cap=cap)
    assert got.dtype == _lanes(xp).dtype
    got = got.numpy().view(dt)
    args = (jnp.asarray(a), jnp.asarray(xp))
    np.testing.assert_array_equal(got, np.asarray(rops.frontier_step_lanes(
        *args, op=op, cap=cap, mode="ref")))
    if (m, k, w) == (24, 37, 6):
        np.testing.assert_array_equal(got, np.asarray(
            rops.frontier_step_lanes(*args, op=op, cap=cap,
                                     mode="interpret")))


def test_lane_matmul_rejects_bad_operands():
    a = _t(rbitset.pack_bits_np(np.ones((2, 32), bool)))
    with pytest.raises(ValueError, match="lane op"):
        ops.frontier_step_lanes(a, torch.zeros((32, 1), dtype=torch.int16),
                                op="max")
    with pytest.raises(ValueError, match="shape"):
        ops.frontier_step_lanes(a, torch.zeros((31, 1), dtype=torch.int16),
                                op="min")


# ---------------------------------------------------------------- B5
@pytest.mark.parametrize("n,w", [(1, 1), (77, 9), (600, 3), (33, 40)])
def test_popcount_plain_matches_reference(n, w):
    x = np.random.default_rng(n).integers(0, 2 ** 32, (n, w),
                                          dtype=np.uint32)
    x[0, 0] = 0xFFFFFFFF                   # every bit, bit 31 included
    got = ops.popcount(_t(x))
    assert got.dtype == torch.int32
    want = np.asarray(rops.popcount(jnp.asarray(x), mode="ref"))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        rops.popcount(jnp.asarray(x), mode="interpret")))
    expect = np.array([bin(int(v)).count("1") for row in x for v in row]
                      ).reshape(n, w).sum(-1)
    np.testing.assert_array_equal(got.numpy(), expect)


# ---------------------------------------------------------------- B6
# each op on two block grids; the bw = 2 grid also runs the Pallas kernel
B6_CASES = [(op, shape) for op, i in (("min", (0, 2)), ("sum", (1, 2)),
                                      ("or", (3, 2)))
            for shape in (B3_SHAPES[i[0]], B3_SHAPES[i[1]])]
_B6_LANES = {"min": ("uint16", 0), "sum": ("uint32", (1 << 15) - 1),
             "or": ("uint8", 0)}


@pytest.mark.parametrize("op,shape", B6_CASES)
def test_block_sparse_lane_plain_matches_reference(op, shape):
    m, kw, w, br, bw, nbits = shape
    dt, cap = _B6_LANES[op]
    a, _ = _b3_inputs(m, kw, w, nbits, seed=m + kw)
    _, x = _lane_inputs(nbits, nbits, w, op, dt, cap, seed=m + w)
    ident = int(np.iinfo(dt).max) if op == "min" else 0
    x[40:72] = ident                       # a dead k-block
    comp = compressed.compress_blocks(a, br=br, bw=bw, nbits=nbits,
                                      device="cpu")
    rc = rcomp.compress_blocks(a, br=br, bw=bw, nbits=nbits)
    got = ops.block_sparse_lane_matmul(comp, _lanes(x), op=op, cap=cap)
    got = got.numpy().view(dt)
    np.testing.assert_array_equal(got, np.asarray(
        rbs.block_sparse_lane_matmul_ref(rc, jnp.asarray(x), op=op,
                                         cap=cap)))
    xp = np.pad(x, ((0, kw * 32 - nbits), (0, 0)))
    dense = ops.frontier_step_lanes(_t(a), _lanes(xp), op=op, cap=cap)
    np.testing.assert_array_equal(got, dense.numpy().view(dt))
    if bw > 1:
        np.testing.assert_array_equal(got, np.asarray(
            rbs.block_sparse_lane_matmul(rc, jnp.asarray(x), op=op, cap=cap,
                                         interpret=True)))


def _direct_round(c, cf, cb, full_mask, dense):
    """The round of ``round_case``'s operands ``c`` written out on the
    dense label-class stacks packed from the same edges: one
    ``bitset_matmul_ref`` per class and direction, each class's subset
    transition (the neutral class's ``has = ~0, sh = 0`` too), on the
    passes whose flag and gate run the direction, the corridor and
    live-column mask, the new bits, and a meet searched over every state
    pair against the queries' full masks -> ``(f_next, b_next, new_f,
    new_b, done)``."""
    adj_rev, adj_fwd = dense["adj_rev"], dense["adj_fwd"]
    f, b, cor, state = c["f"], c["b"], c["cor_w"], c["state"]
    v_p, q = f.shape
    n_states = c["sup_need"].shape[0]
    done = bitset.unpack_bits(state[2], q)
    mask = cor & torch.where(done, 0, -1).to(torch.int32)[None, :]

    def push(adj, x):
        xk = torch.cat([x, x.new_zeros((adj.shape[2] * 32 - v_p, q))])
        upd = torch.zeros_like(x)
        for k in range(adj.shape[0]):
            t = ref.bitset_matmul_ref(adj[k], xk) & dense["allow"][k]
            h, sh = dense["has"][k], dense["sh"][k]
            upd |= (t & h) | ((t & ~h) << sh)
        return upd

    new_f = push(adj_rev, f) & mask & ~f & rounds.run_mask(state[0], q, cf)
    new_b = push(adj_fwd, b) & mask & ~b & rounds.run_mask(state[1], q, cb)
    want_f, want_b = f | new_f, b | new_b
    shifts = np.arange(n_states, dtype=np.uint32)
    bf = (bitset.words_to_np(want_f)[..., None] >> shifts) & 1   # [V, Q, S]
    bb = (bitset.words_to_np(want_b)[..., None] >> shifts) & 1
    pairs = np.einsum("xqs,xqt->qst", bf.astype(np.int64),
                      bb.astype(np.int64)) > 0
    st = np.arange(n_states)
    fills = ((st[:, None] | st[None, :])[None] & full_mask[:, None, None]) \
        == full_mask[:, None, None]
    want_done = done.numpy() | (pairs & fills).any(axis=(1, 2))
    return want_f, want_b, new_f, new_b, want_done


@pytest.mark.parametrize("name", rounds.SMALL + rounds.SMALL_GROUPS)
def test_class_round_plain_matches_direct_composition(name, one_thread):
    """``ops.class_round`` on the CPU (``ref.class_round_ref`` on the
    edge lists with every label's operands) equals the round written out
    on the dense label-class stacks packed from the same edges
    (``_direct_round``), with the per-pass state: each direction's
    "added" flag (a gated-off one keeps the flag it was given) and the
    done words.  A lockstep group (``rounds.GROUPS``) equals, on each
    chunk's columns and passes, the chunk launched alone, and leaves the
    columns between its chunks empty."""
    if name in rounds.GROUPS:
        group, cf, cb, chunks = rounds.group_case(name, "cpu")
        got_f, got_b, state = ops.class_round(**group, cf=cf, cb=cb)
        seen = np.zeros(got_f.shape[1], bool)
        for c, cols, passes in chunks:
            alone = ops.class_round(**c, cf=cf, cb=cb)
            for g_, a_ in zip((got_f[:, cols], got_b[:, cols],
                               state[:, passes]), alone):
                assert torch.equal(g_, a_)
            seen[cols] = True
        assert not got_f[:, ~seen].any() and not got_b[:, ~seen].any()
        assert not bitset.unpack_bits(state[2], len(seen))[~seen].any()
        assert state[:2].any() or not (cf or cb)
        return
    c, cf, cb, full_mask, dense = rounds.round_case(name, "cpu")
    q = c["f"].shape[1]
    want_f, want_b, new_f, new_b, want_done = _direct_round(
        c, cf, cb, full_mask, dense)

    n0 = ops.KERNEL_LAUNCHES["class_round"]
    got_f, got_b, state = ops.class_round(**c, cf=cf, cb=cb)
    assert ops.KERNEL_LAUNCHES["class_round"] == n0   # counted on a card
    assert torch.equal(got_f, want_f) and torch.equal(got_b, want_b)
    words = bitset.words_to_np(state)
    assert words.shape == (3, bitset.n_words(q))
    for row, new, gate in ((0, new_f, cf), (1, new_b, cb)):
        per_pass = [int(bool((new[:, p * 32:(p + 1) * 32] != 0).any()))
                    if gate else 1 for p in range(words.shape[1])]
        assert words[row].tolist() == per_pass
    np.testing.assert_array_equal(words[2], bitset.pack_bits_np(want_done))
    assert 0 < int(want_done.sum()) < q or name in ("neutral-only",
                                                    "meet-only")
    # the dense composition through ``ref.class_push_ref``
    for g_, w_ in zip((got_f, got_b, state),
                      rounds.dense_round(dense, c, cf, cb)):
        assert torch.equal(g_, w_)


@pytest.mark.parametrize("name", rounds.SMALL)
def test_class_lists_hold_the_stacks_edges(name, one_thread):
    """Each direction's ``EdgeLists`` holds the edges of the dense class
    stack packed from the same edges, every class and row: packed back
    into a stack under the same special labels
    (``rounds.stacks_of_lists``) it equals the stack on its first ``V'``
    columns, and its bytes are the row pointers' and two words an
    edge."""
    c, _, _, _, dense = rounds.round_case(name, "cpu")
    v_p = c["f"].shape[0]
    special = tuple(range(dense["allow"].shape[0] - 1))
    for key in ("lists_rev", "lists_fwd"):
        lists, adj = c[key], dense["adj_" + key[-3:]]
        got = rounds.stacks_of_lists(lists, special)
        kw = bitset.n_words(v_p)
        assert torch.equal(got, adj[:, :, :kw]), key
        assert lists.n_labels == rounds.N_LABELS
        assert lists.nbytes == 4 * (v_p + 1 + 2 * lists.cols.numel())
        assert int(lists.row_ptr[-1]) == lists.labels.numel()
    if name == "empty-rows":
        deg = [np.diff(bitset.words_to_np(c[k].row_ptr).astype(np.int64))
               for k in ("lists_rev", "lists_fwd")]
        assert (deg[0][:v_p // 4] == 0).all() and (deg[1][v_p // 2:] == 0
                                                   ).all()


@pytest.mark.parametrize("bad", ["lists", "frontier", "classes", "states",
                                 "done", "flat_state", "row_ptr", "n_labels",
                                 "column", "label"])
def test_class_round_rejects_bad_operands(bad):
    """The card wrapper's shape check refuses what the kernel cannot take;
    an edge whose column is not below ``V'`` or whose label is not below
    ``L`` is refused where the lists are made (``compressed.edge_lists``),
    so no launch reads them back."""
    from repro_torch.kernels import class_round
    c, _, _, _, _ = rounds.round_case("compact-96", "cpu")
    lists = c["lists_fwd"]
    v_p = c["f"].shape[0]

    def check():
        class_round.check_round(**c)

    if bad == "lists":
        c["lists_fwd"] = lists._replace(labels=lists.labels[:-1])
    elif bad == "frontier":
        c["b"] = c["b"][:, :16]
    elif bad == "classes":
        c["sh"] = c["sh"][:-1]
    elif bad == "states":
        c["sup_need"] = torch.zeros((33, 32), dtype=torch.int32)
    elif bad == "done":          # passes for 64 columns, not 32
        c["state"] = torch.zeros((3, 2), dtype=torch.int32)
    elif bad == "flat_state":    # flags and done words in one flat row
        c["state"] = torch.zeros(3, dtype=torch.int32)
    elif bad == "row_ptr":
        c["lists_rev"] = c["lists_rev"]._replace(
            row_ptr=c["lists_rev"].row_ptr[:-1])
    elif bad == "n_labels":
        c["lists_fwd"] = lists._replace(n_labels=lists.n_labels + 1)
    else:
        src = np.array([0, 5, v_p - 1])
        dst, lab = np.array([1, 2, 3]), np.zeros(3)
        if bad == "column":
            dst[1] = v_p
        else:
            lab[2] = rounds.N_LABELS

        def check():
            compressed.edge_lists(src, dst, lab, v_p, rounds.N_LABELS,
                                  "cpu")
    with pytest.raises(ValueError):
        check()
    c_ok, _, _, _, _ = rounds.round_case("compact-96", "cpu")
    class_round.check_round(**c_ok)
