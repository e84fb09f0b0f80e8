"""Card legs of the port: each hand-written CUDA kernel against its plain
PyTorch version, and the main path on the card against the segment
backend and the DFS oracle.  Exact equality (the data is bits).

These tests import no JAX, so they run where the card is:
``python -m pytest tests/test_torch_cuda.py -q``.  Without a card they
skip."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import (bitset, compressed, deltalog, dfs_baseline, engine,
                         graph as G, pattern, snapshot, tdr_build, tdr_query)
from repro_torch.kernels import ops, ref
from repro_torch.semiring import COUNT, COUNT_CAP, DIST8, DIST16

import _class_round_cases as rounds

PLANES = ("h_vtx", "h_lab", "v_vtx", "v_lab", "n_out", "n_in")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode")
    return torch.device("cuda")


def _words(rng, *shape):
    return rng.integers(0, 2 ** 32, shape, dtype=np.uint32)


def _both(a: np.ndarray, dev):
    """(CPU tensor, card tensor) of the same uint32 words."""
    return bitset.np_to_words(a, "cpu"), bitset.np_to_words(a, dev)


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,w", [(1, 32, 1), (100, 224, 40),
                                   (70, 64, 33), (4096, 4096, 8),
                                   (4096, 4096, 2), (4096, 4096, 32)])
@pytest.mark.parametrize("density", [0.001, 0.3])
def test_bitset_matmul_kernel_matches_plain(cuda, m, k, w, density):
    rng = np.random.default_rng(m + w)
    a_h, a_d = _both(bitset.pack_bits_np(rng.random((m, k)) < density), cuda)
    x_h, x_d = _both(_words(rng, k, w), cuda)
    n0 = ops.KERNEL_LAUNCHES["bitset_matmul"]
    got = ops.frontier_step(a_d, x_d)
    assert ops.KERNEL_LAUNCHES["bitset_matmul"] == n0 + 1
    assert torch.equal(got.cpu(), ref.bitset_matmul_ref(a_h, x_h))


@pytest.mark.gpu
@pytest.mark.parametrize("j,g,k,wv,wl", [(5, 2, 1, 1, 1), (37, 4, 3, 3, 2),
                                         (128, 4, 2, 8, 2), (1, 1, 4, 2, 2),
                                         (768, 4, 3, 8, 2)])
def test_way_filter_kernel_matches_plain(cuda, j, g, k, wv, wl):
    rng = np.random.default_rng(j)
    npl = np.zeros(wl, np.uint32)
    npl[-1] = 1 << 31
    arrs = [_words(rng, j, g, wv), _words(rng, j, g, wl),
            _words(rng, j, g, k, wv), _words(rng, j, g, k, wl),
            _words(rng, j, wv) & _words(rng, j, wv) & _words(rng, j, wv),
            _words(rng, j, wl) & _words(rng, j, wl), _words(rng, j, wl), npl]
    pairs = [_both(a, cuda) for a in arrs]
    got = ops.filter_ways(*(d for _, d in pairs))
    assert torch.equal(got.cpu(), ref.way_filter_ref(*(h for h, _ in pairs)))


@pytest.mark.gpu
@pytest.mark.parametrize("m,kw,w,br,bw,nbits", [
    (96, 3, 5, 8, 1, 90), (64, 4, 2, 8, 1, 128), (37, 5, 3, 4, 2, 150),
    (200, 8, 32, 8, 1, 250), (2048, 64, 8, 8, 1, 2048)])
def test_block_sparse_kernel_matches_plain(cuda, m, kw, w, br, bw, nbits):
    rng = np.random.default_rng(m)
    a = rng.random((m, kw * 32)) < 0.05
    a[:16] = True                      # ONE blocks
    a[32:40] = False                   # ZERO strip
    a[:, nbits:] = False
    a_p = bitset.pack_bits_np(a)
    x = _words(rng, nbits, w)
    x[:40] = 0                         # a dead leading k-block
    x_h, x_d = _both(x, cuda)
    comp_h = compressed.compress_blocks(a_p, br=br, bw=bw, nbits=nbits,
                                        device="cpu")
    comp_d = compressed.compress_blocks(a_p, br=br, bw=bw, nbits=nbits,
                                        device=cuda)
    got = ops.frontier_step_sparse(comp_d, x_d)
    want = ref.block_sparse_matmul_ref(comp_h, x_h)
    assert torch.equal(got.cpu(), want)
    dense = ref.bitset_matmul_ref(bitset.np_to_words(a_p, "cpu"),
                                  ref.pad_k(x_h, kw * 32))
    assert torch.equal(want, dense)


def _dense_words(rng, *shape, ors=1, ands=1):
    w = _words(rng, *shape)
    for _ in range(ors - 1):
        w |= _words(rng, *shape)
    for _ in range(ands - 1):
        w &= _words(rng, *shape)
    return w


@pytest.mark.gpu
@pytest.mark.parametrize("j,g,k,wv,wl", [(37, 3, 3, 8, 2), (5, 4, 1, 1, 1),
                                         (100, 4, 3, 3, 2), (1, 1, 4, 4, 2),
                                         (768, 4, 3, 8, 2)])
def test_way_filter_at_kernel_matches_plain(cuda, j, g, k, wv, wl):
    """The fused entry gathers the index rows itself: repeated ``u``, a
    padding job (vertex 0, empty pattern) and J·G off the block size."""
    rng = np.random.default_rng(j + wv)
    n = 50
    npl = np.zeros(wl, np.uint32)
    npl[-1] = 1 << 31
    planes = [_dense_words(rng, n, wv, ands=4),
              _dense_words(rng, n, g, wv, ors=3),
              _dense_words(rng, n, g, wl, ors=3),
              _dense_words(rng, n, g, k, wv, ors=3),
              _dense_words(rng, n, g, k, wl, ands=3)]
    u, v = rng.integers(0, n, j), rng.integers(0, n, j)
    u[: j // 2] = u[0]
    rq = _dense_words(rng, j, wl, ands=3)
    fb = _dense_words(rng, j, wl, ors=2)
    u[-1] = v[-1] = 0
    rq[-1] = fb[-1] = 0
    words = [_both(a, cuda) for a in [rq, fb, npl] + planes]
    idx = [(torch.from_numpy(a), torch.from_numpy(a).to(cuda)) for a in (u, v)]
    n0 = ops.KERNEL_LAUNCHES["way_filter"]
    got = ops.filter_ways_at(*(d for _, d in idx + words))
    assert ops.KERNEL_LAUNCHES["way_filter"] == n0 + 1
    assert got.dtype == torch.bool and got.shape == (j, g)
    assert torch.equal(got.cpu(), ref.way_filter_at_ref(
        *(h for h, _ in idx + words)))


def _b3_operand(m, kw, br, bw, nbits, w, frontier, dev):
    """(A packed, CPU and card operands, X on both) for one B3 case."""
    rng = np.random.default_rng(m + kw + w)
    a = rng.random((m, kw * 32)) < 0.05
    if frontier != "no_one":
        a[:16] = True                  # ONE blocks
    a[32:40] = False                   # ZERO strip
    if frontier == "one_rows":         # row-blocks full of ONE blocks
        a[: min(m, 48)] = True
    a[:, nbits:] = False
    a_p = bitset.pack_bits_np(a)
    x = _words(rng, nbits, w)
    x[:40] = 0                         # a dead leading k-block
    if frontier == "empty":
        x[:] = 0
    elif frontier == "single":         # one live k-block, one set word
        x[:] = 0
        x[min(nbits - 1, bw * 32 + 3), w // 2] = 0x80000001
    comp_h = compressed.compress_blocks(a_p, br=br, bw=bw, nbits=nbits,
                                        device="cpu")
    comp_d = compressed.compress_blocks(a_p, br=br, bw=bw, nbits=nbits,
                                        device=dev)
    x_h, x_d = _both(x, dev)
    if frontier == "unaligned":        # X 4 bytes off a 16-byte boundary
        x_d = torch.cat([x_d.new_zeros(w + 1), x_d.reshape(-1)])[1:]
        x_d = x_d[w:].reshape(nbits, w)
        assert x_d.data_ptr() % 16 and x_d.is_contiguous()
    return a_p, comp_h, comp_d, x_h, x_d


# W = 136 and 133 take two and three W tiles (133 with scalar loads)
B3_GRID = [(br, bw, w) for br in (4, 8, 16) for bw in (1, 2)
           for w in (1, 2, 8, 32)] + [(8, 1, 136), (16, 2, 133)]


@pytest.mark.gpu
@pytest.mark.parametrize("br,bw,w", B3_GRID)
@pytest.mark.parametrize("frontier", ["dense", "no_one", "empty", "single",
                                      "one_rows", "unaligned"])
def test_block_sparse_live_list_kernel(cuda, br, bw, w, frontier):
    """The live-list kernel on ragged row and column tails (``nbits`` off
    every ``32·bw``), with and without ONE blocks (the column-OR pre-pass
    runs only with them): bit-equal to the plain version and to dense B1,
    one counted launch per call."""
    m, kw, nbits = 203, 7, 210
    a_p, comp_h, comp_d, x_h, x_d = _b3_operand(m, kw, br, bw, nbits, w,
                                                frontier, cuda)
    n0 = ops.KERNEL_LAUNCHES["block_sparse_matmul"]
    got = ops.frontier_step_sparse(comp_d, x_d)
    assert ops.KERNEL_LAUNCHES["block_sparse_matmul"] == n0 + 1
    want = ref.block_sparse_matmul_ref(comp_h, x_h)
    assert torch.equal(got.cpu(), want)
    dense = ref.bitset_matmul_ref(bitset.np_to_words(a_p, "cpu"),
                                  ref.pad_k(x_h, kw * 32))
    assert torch.equal(want, dense)
    if frontier == "empty":
        assert not want.any()
    assert (comp_h.one_bj.numel() == 0) == (frontier == "no_one")


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(rounds.CASES) + list(rounds.GROUPS))
def test_class_round_kernel_matches_plain(cuda, name):
    """One phase-2 round through the ``class_round`` kernel on the edge
    lists equals its plain version on the same card inputs and the dense
    composition on the label-class stacks packed from the same edges: the
    new frontiers, each pass's two flags and the done words, bit for bit.
    A lockstep group's launch equals, on each chunk's columns and passes,
    the chunk launched alone (and its plain version), and leaves the
    columns between its chunks empty."""
    if name in rounds.GROUPS:
        group, cf, cb, chunks = rounds.group_case(name, cuda)
        n0 = ops.KERNEL_LAUNCHES["class_round"]
        got = ops.class_round(**group, cf=cf, cb=cb)
        assert ops.KERNEL_LAUNCHES["class_round"] == n0 + 1
        want = ref.class_round_ref(**group, cf=cf, cb=cb)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        seen = np.zeros(got[0].shape[1], bool)
        for c, cols, passes in chunks:
            alone = ops.class_round(**c, cf=cf, cb=cb)
            cols_t = torch.from_numpy(cols).to(cuda)
            for g, a, what in zip(
                    (got[0][:, cols_t], got[1][:, cols_t],
                     got[2][:, torch.from_numpy(passes).to(cuda)]), alone,
                    ("f_next", "b_next", "state")):
                assert torch.equal(g, a), what
            seen[cols] = True
        rest = torch.from_numpy(~seen).to(cuda)
        assert not got[0][:, rest].any() and not got[1][:, rest].any()
        return
    c, cf, cb, _, dense_ops = rounds.round_case(name, cuda)
    n0 = ops.KERNEL_LAUNCHES["class_round"]
    got = ops.class_round(**c, cf=cf, cb=cb)
    assert ops.KERNEL_LAUNCHES["class_round"] == n0 + 1
    want = ref.class_round_ref(**c, cf=cf, cb=cb)
    dense = rounds.dense_round(dense_ops, c, cf, cb)
    for g, w, d, what in zip(got, want, dense,
                             ("f_next", "b_next", "state")):
        assert torch.equal(g, w), what
        assert torch.equal(g, d), what


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["er", "pa"])
@pytest.mark.parametrize("width", [2, 4])
def test_main_path_on_card_matches_segment_and_oracle(cuda, kind, width):
    """Build + answer on the card with the default backend (matmul, all
    its kernels) equals the plain-torch segment backend and the DFS
    oracle, and its phase 2 (one ``class_round`` launch a round) the
    matmul backend on the CPU in answers, rounds and host syncs.  Patterns
    of ``width`` labels run 4 (2 labels) and 16 (4) subset states."""
    g = G.random_graph(kind, 300, 3.0, 6, seed=1)
    cfg = tdr_build.TDRConfig(vtx_bits=64)
    ops.KERNEL_LAUNCHES.clear()
    idx = tdr_build.build_index(g, cfg)
    seg = tdr_build.build_index(g, cfg, backend="segment")
    host = tdr_build.build_index(g, cfg, backend="matmul", device="cpu")
    for f in PLANES:
        assert torch.equal(getattr(idx, f), getattr(seg, f)), f
    assert idx.fixpoint_rounds == seg.fixpoint_rounds
    rng = np.random.default_rng(1 if width == 2 else width)
    fams = (pattern.all_of, pattern.any_of, pattern.none_of)
    qs = [(int(rng.integers(300)), int(rng.integers(300)),
           fams[int(rng.integers(3))](
               rng.choice(6, width, replace=False).tolist()))
          for _ in range(64)]
    want = [dfs_baseline.answer_pcr(g, u, v, p) for u, v, p in qs]
    for mode in ("auto", "compact", "full"):
        st, st_h, st_s = (tdr_query.QueryStats() for _ in range(3))
        got = tdr_query.answer_batch(idx, qs, exact_mode=mode, stats=st)
        assert got.tolist() == want, mode
        got = tdr_query.answer_batch(host, qs, exact_mode=mode,
                                     backend="matmul", stats=st_h,
                                     device="cpu")
        assert got.tolist() == want, mode
        got = tdr_query.answer_batch(seg, qs, exact_mode=mode,
                                     backend="segment", stats=st_s)
        assert got.tolist() == want, mode
        assert st.exact_rounds > 0, mode
        assert (st.exact_rounds, st.host_syncs) == (
            st_h.exact_rounds, st_h.host_syncs), mode
        assert st.fused_rounds == st.exact_rounds, mode
        assert st_h.fused_rounds == st_s.fused_rounds == 0, mode
    for name in ("bitset_matmul", "way_filter", "block_sparse_matmul",
                 "class_round"):
        assert ops.KERNEL_LAUNCHES[name] > 0, name


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["auto", "full"])
@pytest.mark.parametrize("chunk", [8, 32])
def test_grouped_chunks_on_card_match_the_cpu(cuda, mode, chunk,
                                              monkeypatch):
    """A batch's full-graph chunks (at least 3) run on the card as one
    lockstep group: answers equal the DFS oracle and the matmul backend
    on the CPU, every chunk's rounds (``_round_parts``) the CPU's, and
    ``class_round`` launches once a round of each group's longest chunk
    and once before it (a compacted chunk is a group of one)."""
    g = G.random_graph("er", 300, 3.0, 6, seed=4)
    cfg = tdr_build.TDRConfig(vtx_bits=64)
    idx = tdr_build.build_index(g, cfg)
    host = tdr_build.build_index(g, cfg, backend="matmul", device="cpu")
    rng = np.random.default_rng(4)
    fams = (pattern.all_of, pattern.any_of, pattern.none_of)
    qs = [(int(rng.integers(300)), int(rng.integers(300)),
           fams[int(rng.integers(3))](rng.choice(6, 2, replace=False)
                                      .tolist())) for _ in range(192)]
    want = [dfs_baseline.answer_pcr(g, u, v, p) for u, v, p in qs]
    groups, real = [], tdr_query._bidi_matmul_core

    def spy(*args):
        out = real(*args)
        groups.append(out[1])
        return out

    monkeypatch.setattr(tdr_query, "_bidi_matmul_core", spy)
    st, st_h = tdr_query.QueryStats(), tdr_query.QueryStats()
    n0 = ops.KERNEL_LAUNCHES["class_round"]
    got = tdr_query.answer_batch(idx, qs, exact_mode=mode,
                                 exact_chunk=chunk, stats=st)
    launched = ops.KERNEL_LAUNCHES["class_round"] - n0
    on_card = list(groups)
    got_h = tdr_query.answer_batch(host, qs, exact_mode=mode,
                                   exact_chunk=chunk, backend="matmul",
                                   stats=st_h, device="cpu")
    assert got.tolist() == got_h.tolist() == want
    assert st._round_parts == st_h._round_parts
    assert st.full_chunks >= 3 and st.grouped_chunks == st.full_chunks
    assert launched == st.host_syncs == st_h.host_syncs == sum(
        max(rs) + 1 for rs in on_card)
    assert st.fused_rounds == st.exact_rounds


@pytest.mark.gpu
def test_dense_cap_on_the_card_raises(cuda):
    """On the card an operand over the dense cap raises: the matmul path
    never falls back to plain torch there."""
    g = G.random_graph("er", 300, 3.0, 6, seed=1)
    adj_bytes = 300 * bitset.n_words(300) * 4
    with pytest.raises(engine.DenseCapError):
        engine.Engine(g, engine.EngineConfig(max_dense_bytes=adj_bytes - 1))
    ecfg = engine.EngineConfig(max_dense_bytes=adj_bytes)
    idx = tdr_build.build_index(g, tdr_build.TDRConfig(vtx_bits=64),
                                engine_config=ecfg)
    assert idx.engine(config=ecfg).backend == "matmul"
    qs = [(u, (u * 7 + 3) % 300, pattern.all_of([0, 1])) for u in range(64)]
    with pytest.raises(engine.DenseCapError):
        tdr_query.answer_batch(idx, qs, engine_config=ecfg)


_STORED = {"uint8": np.uint8, "uint16": np.int16, "uint32": np.int32}
LANE_CASES = [("min", "uint16", 0), ("min", "uint8", 0),
              ("min", "uint32", 0), ("sum", "uint32", (1 << 15) - 1),
              ("sum", "uint16", 1000), ("sum", "uint8", 200),
              ("or", "uint8", 0), ("or", "uint16", 0), ("or", "uint32", 0)]


def _lane_pair(a: np.ndarray, dev):
    """(CPU tensor, card tensor) of the same unsigned lanes, stored."""
    t = torch.from_numpy(np.ascontiguousarray(a).view(_STORED[a.dtype.name]))
    return t, t.to(dev)


def _lane_x(rng, k, w, op, dt, cap):
    """Lanes with rows at INF, INF-1 and the cap (values <= cap for sum)."""
    hi = cap if op == "sum" else int(np.iinfo(dt).max)
    x = rng.integers(0, hi + 1, size=(k, w)).astype(dt)
    x[0], x[1], x[2] = hi, hi - 1, cap
    return x


def _offset_by_one(t: torch.Tensor) -> torch.Tensor:
    """The same values in a row slice of a larger tensor, one element
    past its start: contiguous, but not 16-byte aligned."""
    big = t.new_empty(t.numel() + 1)
    big[1:] = t.flatten()
    out = big[1:].view(t.shape)
    assert out.is_contiguous() and out.data_ptr() % 16 != 0
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,w,shift", [
    (1, 32, 1, ""), (24, 64, 6, ""), (70, 64, 33, ""), (100, 224, 130, ""),
    (4096, 4096, 128, ""), (100, 224, 256, ""), (70, 96, 384, ""),
    (40, 4096, 130, ""), (70, 256, 128, "x"), (70, 256, 256, "x"),
    (70, 256, 128, "ax"), (70, 256, 256, "ax"), (70, 256, 8, "ax")])
@pytest.mark.parametrize("op,dt,cap", LANE_CASES)
def test_lane_matmul_kernel_matches_plain(cuda, m, k, w, shift, op, dt,
                                          cap):
    """W = 256 and 384 take several 128-lane passes; (40, 4096, 130)
    has rows of ~1,200 set bits, more than one warp's list holds.
    ``shift`` puts X ("x"), or A and X ("ax"), one element past a 16-byte
    boundary: the kernel takes its 4-lane and 4-byte loads there."""
    rng = np.random.default_rng(m + w)
    density = 0.001 if m >= 4096 else 0.3
    a_h, a_d = _both(bitset.pack_bits_np(rng.random((m, k)) < density), cuda)
    x_h, x_d = _lane_pair(_lane_x(rng, k, w, op, dt, cap), cuda)
    if "x" in shift:
        x_d = _offset_by_one(x_d)
    if "a" in shift:
        a_d = _offset_by_one(a_d)
    n0 = ops.KERNEL_LAUNCHES["lane_matmul"]
    got = ops.frontier_step_lanes(a_d, x_d, op=op, cap=cap)
    assert ops.KERNEL_LAUNCHES["lane_matmul"] == n0 + 1
    assert got.dtype == x_d.dtype
    assert torch.equal(got.cpu(), ref.lane_matmul_ref(a_h, x_h, op=op,
                                                      cap=cap))


@pytest.mark.gpu
@pytest.mark.parametrize("n,w", [(1, 1), (77, 9), (600, 3), (33, 40),
                                 (131072, 8), (4096, 1024), (1000, 4),
                                 (999, 8), (257, 1024), (70001, 7),
                                 (5, 12), (300, 33)])
def test_popcount_kernel_matches_plain(cuda, n, w):
    rng = np.random.default_rng(n)
    words = _words(rng, n, w)
    words[0, 0] = 0xFFFFFFFF
    h, d = _both(words, cuda)
    n0 = ops.KERNEL_LAUNCHES["popcount_rows"]
    got = ops.popcount(d)
    assert ops.KERNEL_LAUNCHES["popcount_rows"] == n0 + 1
    assert torch.equal(got.cpu(), ref.popcount_rows_ref(h))


@pytest.mark.gpu
@pytest.mark.parametrize("n,w", [(999, 4), (4097, 8), (300, 1024),
                                 (77, 9)])
def test_popcount_kernel_misaligned_rows(cuda, n, w):
    """Words one word off a 16-byte boundary take the one-word loads."""
    rng = np.random.default_rng(n + w)
    words = _words(rng, n, w)
    h, d = _both(words, cuda)
    d = torch.cat([d.new_zeros(1), d.reshape(-1)])[1:].reshape(n, w)
    assert d.data_ptr() % 16 and d.is_contiguous()
    n0 = ops.KERNEL_LAUNCHES["popcount_rows"]
    got = ops.popcount(d)
    assert ops.KERNEL_LAUNCHES["popcount_rows"] == n0 + 1
    assert torch.equal(got.cpu(), ref.popcount_rows_ref(h))


@pytest.mark.gpu
@pytest.mark.parametrize("m,kw,w,br,bw,nbits", [
    (96, 3, 5, 8, 1, 90), (37, 5, 3, 4, 2, 150), (200, 8, 32, 8, 1, 250),
    (2048, 64, 128, 8, 1, 2048)])
@pytest.mark.parametrize("op,dt,cap", [("min", "uint16", 0),
                                       ("sum", "uint32", (1 << 15) - 1),
                                       ("or", "uint8", 0),
                                       ("min", "uint8", 0)])
def test_block_sparse_lane_kernel_matches_plain(cuda, m, kw, w, br, bw,
                                                nbits, op, dt, cap):
    rng = np.random.default_rng(m)
    a = rng.random((m, kw * 32)) < 0.05
    a[:16] = True                      # ONE blocks
    a[32:40] = False                   # ZERO strip
    a[:, nbits:] = False
    a_p = bitset.pack_bits_np(a)
    x = _lane_x(rng, nbits, w, op, dt, cap)
    x[40:72] = int(np.iinfo(dt).max) if op == "min" else 0   # dead block
    x_h, x_d = _lane_pair(x, cuda)
    comp_h = compressed.compress_blocks(a_p, br=br, bw=bw, nbits=nbits,
                                        device="cpu")
    comp_d = compressed.compress_blocks(a_p, br=br, bw=bw, nbits=nbits,
                                        device=cuda)
    n0 = ops.KERNEL_LAUNCHES["block_sparse_lane_matmul"]
    got = ops.block_sparse_lane_matmul(comp_d, x_d, op=op, cap=cap)
    assert ops.KERNEL_LAUNCHES["block_sparse_lane_matmul"] == n0 + 1
    want = ref.block_sparse_lane_matmul_ref(comp_h, x_h, op=op, cap=cap)
    assert torch.equal(got.cpu(), want)
    dense = ref.lane_matmul_ref(
        bitset.np_to_words(a_p, "cpu"),
        ref.pad_k_lanes(x_h, kw * 32, op), op=op, cap=cap)
    assert torch.equal(want, dense)


def _b6_operand(br, bw, w, frontier, op, dt, cap, dev):
    """(A packed, CPU and card operands, X on both) for one B6 case; the
    k-block width is ``32·bw`` and ``nbits`` is off it."""
    m, kw, nbits = 203, 7, 210
    rng = np.random.default_rng(br * 100 + bw * 10 + w)
    a = rng.random((m, kw * 32)) < 0.05
    if frontier != "no_one":
        a[:16] = True                  # ONE blocks
    a[32:40] = False                   # ZERO strip
    a[:, nbits:] = False
    a_p = bitset.pack_bits_np(a)
    # short_v: A selects rows of X past V, which read as the identity
    v = nbits - 37 if frontier == "short_v" else nbits
    x = _lane_x(rng, v, w, op, dt, cap)
    ident = int(np.iinfo(dt).max) if op == "min" else 0
    x[40:72] = ident                   # a dead k-block
    if frontier == "empty":
        x[:] = ident
    comp_h = compressed.compress_blocks(a_p, br=br, bw=bw, nbits=nbits,
                                        device="cpu")
    comp_d = compressed.compress_blocks(a_p, br=br, bw=bw, nbits=nbits,
                                        device=dev)
    x_h, x_d = _lane_pair(x, dev)
    if frontier == "unaligned":        # X one lane off a 16-byte boundary
        x_d = torch.cat([x_d.new_zeros(1), x_d.reshape(-1)])[1:]
        x_d = x_d.reshape(v, w)
        assert x_d.data_ptr() % 16 and x_d.is_contiguous()
    return a_p, kw, comp_h, comp_d, x_h, x_d


def _b6_check(a_p, kw, comp_h, comp_d, x_h, x_d, op, cap, dense=True):
    """One counted launch, equal to the plain version and (``dense``) to
    dense B4; returns the plain result."""
    n0 = ops.KERNEL_LAUNCHES["block_sparse_lane_matmul"]
    got = ops.block_sparse_lane_matmul(comp_d, x_d, op=op, cap=cap)
    assert ops.KERNEL_LAUNCHES["block_sparse_lane_matmul"] == n0 + 1
    assert got.dtype == x_d.dtype and got.shape == (comp_h.shape[0],
                                                    x_d.shape[1])
    want = ref.block_sparse_lane_matmul_ref(comp_h, x_h, op=op, cap=cap)
    assert torch.equal(got.cpu(), want)
    if dense:
        assert torch.equal(want, ref.lane_matmul_ref(
            bitset.np_to_words(a_p, "cpu"), ref.pad_k_lanes(x_h, kw * 32, op),
            op=op, cap=cap))
    return want


# (br, bw, W): W = 128 is the main path's; 133 is off every 16-byte
# vector; 264 takes two or three W tiles (one for uint8 lanes)
B6_GRID = [(8, 1, 128), (4, 2, 133), (16, 2, 264), (3, 1, 8), (8, 1, 1)]


@pytest.mark.gpu
@pytest.mark.parametrize("br,bw,w", B6_GRID)
@pytest.mark.parametrize("frontier", ["one", "no_one", "short_v", "empty",
                                      "unaligned"])
@pytest.mark.parametrize("op,dt,cap", LANE_CASES)
def test_block_sparse_lane_live_list_kernel(cuda, br, bw, w, frontier, op,
                                            dt, cap):
    """The live-list lane kernel on ragged row and column tails, with and
    without ONE blocks (the column-(+) pre-pass runs only with them), rows
    of X past V, and the packed and scalar paths: bit-equal to the plain
    version and to dense B4, one counted launch per call."""
    a_p, kw, comp_h, comp_d, x_h, x_d = _b6_operand(br, bw, w, frontier, op,
                                                    np.dtype(dt).type, cap,
                                                    cuda)
    want = _b6_check(a_p, kw, comp_h, comp_d, x_h, x_d, op, cap)
    assert (comp_h.one_bj.numel() == 0) == (frontier == "no_one")
    if frontier == "empty":
        ident = int(np.iinfo(dt).max) if op == "min" else 0
        assert (want.numpy().view(dt) == ident).all()


@pytest.mark.gpu
@pytest.mark.parametrize("dt,cap,w", [("uint32", 2 ** 32 - 2, 8),
                                      ("uint32", 2 ** 32 - 2, 5),
                                      ("uint32", 3_000_000_000, 128),
                                      ("uint16", 65535, 8),
                                      ("uint16", 70000, 8),
                                      ("uint8", 255, 16),
                                      ("uint8", 300, 16)])
def test_block_sparse_lane_sum_saturates(cuda, dt, cap, w):
    """A saturating sum whose unsaturated totals pass the lane and 2^32:
    every step clamps at ``cap`` and nothing wraps.  A ``cap`` over the
    lane maximum keeps the block plain version's truncation, which narrows
    its column summaries, so dense B4 differs there and is not compared."""
    m, kw, nbits = 64, 4, 120
    rng = np.random.default_rng(w + kw)
    a = rng.random((m, kw * 32)) < 0.5
    a[:8] = True
    a[:, nbits:] = False
    a_p = bitset.pack_bits_np(a)
    hi = int(np.iinfo(dt).max)
    x = rng.integers(hi // 2, hi + 1, size=(nbits, w)).astype(dt)
    comp_h = compressed.compress_blocks(a_p, nbits=nbits, device="cpu")
    comp_d = compressed.compress_blocks(a_p, nbits=nbits, device=cuda)
    x_h, x_d = _lane_pair(x, cuda)
    assert int(x.astype(np.uint64).sum(0).max()) > min(cap, hi)
    want = _b6_check(a_p, kw, comp_h, comp_d, x_h, x_d, "sum", cap,
                     dense=cap <= hi)
    assert (want.numpy().view(dt) == np.array(cap).astype(dt)).any()


def _kind_queries(rng, n_vertices, n_labels, n):
    fams = (pattern.all_of, pattern.any_of, pattern.none_of,
            lambda labs: pattern.lcr(labs, n_labels))
    return [(int(rng.integers(n_vertices)), int(rng.integers(n_vertices)),
             fams[i % 4](rng.choice(n_labels, 2, replace=False).tolist()))
            for i in range(n)]


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["er", "pa"])
def test_dist_on_card_matches_segment_and_oracle(cuda, kind):
    """dist_batch on the card with the default backend (matmul, the
    lane_matmul core) equals the segment backend and the BFS oracle, in
    every exact mode, with equal rounds; witness and count_routes on the
    card equal their oracles."""
    g = G.random_graph(kind, 300, 3.0, 6, seed=2)
    idx = tdr_build.build_index(g, tdr_build.TDRConfig(vtx_bits=64))
    qs = _kind_queries(np.random.default_rng(4), 300, 6, 48)
    want = [dfs_baseline.shortest_pcr(g, u, v, p) for u, v, p in qs]
    for mode in ("auto", "compact", "full"):
        ops.KERNEL_LAUNCHES.clear()
        st, st_s = tdr_query.QueryStats(), tdr_query.QueryStats()
        got = tdr_query.dist_batch(idx, qs, exact_mode=mode, stats=st)
        assert ops.KERNEL_LAUNCHES["lane_matmul"] > 0, mode
        seg = tdr_query.dist_batch(idx, qs, exact_mode=mode, stats=st_s,
                                   backend="segment")
        assert got.tolist() == seg.tolist() == want, mode
        assert st.exact_rounds == st_s.exact_rounds, mode
    for u, v, p in qs[:8]:
        path = tdr_query.witness(idx, u, v, p)
        d = dfs_baseline.shortest_pcr(g, u, v, p)
        assert (path is None) if d < 0 else len(path) == d
        if len(pattern.to_dnf(p)) == 1:
            assert tdr_query.count_routes(idx, u, v, p, hops=5) == \
                dfs_baseline.count_routes(g, u, v, p, hops=5,
                                          cap=(1 << 15) - 1)


def _pairs_merged(g):
    """``g`` with its parallel edges (same vertex pair, other labels)
    merged into one: the packed adjacency holds one bit per pair."""
    pair = g.src.astype(np.int64) * g.n_vertices + g.indices
    _, first = np.unique(pair, return_index=True)
    return G.Graph.from_edges(g.n_vertices, g.n_labels, zip(
        g.src[first].tolist(), g.indices[first].tolist(),
        g.labels[first].tolist()))


@pytest.mark.gpu
@pytest.mark.parametrize("reverse", [False, True])
def test_engine_lane_rounds_on_card_match_segment(cuda, reverse):
    """The engine's lane rounds on ``matmul`` (B4 on the full adjacency)
    equal ``segment``: ``propagate(sr=COUNT)`` at W = 128 and 300 (the
    sum counts a vertex pair once, so ``segment`` runs on the graph with
    parallel edges merged), ``closure(sr=DIST8 / DIST16)`` over 256
    sources with equal rounds, one launch per round."""
    g = _pairs_merged(G.erdos_renyi(3000, 4.0, 8, seed=5))
    eng = engine.make_engine(g, backend="matmul", device=cuda)
    eng_s = engine.make_engine(g, backend="segment", device=cuda)
    rng = np.random.default_rng(6)
    for w in (128, 300):
        x = torch.from_numpy(rng.integers(
            0, COUNT_CAP + 1, (3000, w)).astype(np.int32)).to(cuda)
        n0 = ops.KERNEL_LAUNCHES["lane_matmul"]
        got = eng.propagate(x, reverse=reverse, sr=COUNT)
        assert ops.KERNEL_LAUNCHES["lane_matmul"] == n0 + 1
        assert torch.equal(got, eng_s.propagate(x, reverse=reverse,
                                                sr=COUNT))
    src = rng.choice(3000, 256, replace=False)
    for sr in (DIST8, DIST16):
        base = np.full((3000, 256), sr.zero, dtype=sr.dtype_name)
        base[src, np.arange(256)] = 0
        base_t = torch.from_numpy(base.view(
            np.int16 if sr.dtype_name == "uint16" else np.uint8)).to(cuda)
        n0 = ops.KERNEL_LAUNCHES["lane_matmul"]
        got, rounds = eng.closure(base_t, reverse=reverse, sr=sr)
        assert ops.KERNEL_LAUNCHES["lane_matmul"] == n0 + rounds
        want, want_rounds = eng_s.closure(base_t, reverse=reverse, sr=sr)
        assert rounds == want_rounds > 2
        assert torch.equal(got, want)


@pytest.mark.gpu
def test_dist_dense_cap_on_the_card_raises(cuda):
    """On the card a dist chunk's class stack over the dense cap raises
    DenseCapError: the lane kernel path never falls back to segment."""
    g = G.random_graph("er", 300, 3.0, 6, seed=1)
    adj_bytes = 300 * bitset.n_words(300) * 4
    ecfg = engine.EngineConfig(max_dense_bytes=adj_bytes)
    idx = tdr_build.build_index(g, tdr_build.TDRConfig(vtx_bits=64),
                                engine_config=ecfg)
    qs = [(u, (u * 7 + 3) % 300, pattern.all_of([0, 1])) for u in range(64)]
    with pytest.raises(engine.DenseCapError):
        tdr_query.dist_batch(idx, qs, engine_config=ecfg, exact_mode="full")


# ------------------------------------------------------------ live index
BLOCK_FIELDS = ("states", "slots", "pool", "mix_bi", "mix_bj", "mix_off",
                "one_off", "one_bj")
ALL_PLANES = PLANES + ("push", "pop", "g_count", "base_v", "base_l",
                       "base_r", "r_vtx", "r_lab", "r_in", "d_vtx", "d_lab")


def _assert_blocks_equal(a, b):
    assert (a.shape, a.nbits, a.br, a.bw, a.n_mixed) == \
        (b.shape, b.nbits, b.br, b.bw, b.n_mixed)
    for f in BLOCK_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.device == y.device and x.dtype == y.dtype, f
        assert torch.equal(x, y), f


def _patch_case(seed, br, bw, dev):
    """A matrix with ONE, ZERO and MIXED blocks, a patch of some of its
    rows (some rows zeroed, some filled) and the patched matrix."""
    rng = np.random.default_rng(seed)
    m, kw, nbits = 203, 7, 210
    a = rng.random((m, kw * 32)) < 0.05
    a[:16] = True
    a[32:40] = False
    a[:, nbits:] = False
    sel = np.sort(rng.choice(m, size=int(rng.integers(1, 60)),
                             replace=False))
    new = rng.random((sel.size, kw * 32)) < 0.05
    new[::3] = True
    new[1::5] = False
    new[:, nbits:] = False
    a2 = a.copy()
    a2[sel] = new
    a_p, new_p, a2_p = (bitset.pack_bits_np(x) for x in (a, new, a2))
    comp = compressed.compress_blocks(a_p, br=br, bw=bw, nbits=nbits,
                                      device=dev)
    return comp, sel, new_p, a2_p, nbits


@pytest.mark.gpu
@pytest.mark.parametrize("br,bw", [(8, 1), (4, 2), (16, 1)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_patch_blocks_on_card_matches_compress(cuda, br, bw, seed):
    """``patch_blocks`` on the card == ``compress_blocks`` of the patched
    matrix on the card, in every field (the kernel's live lists too), and
    B3 over the patched operand equals its plain version and dense B1."""
    comp, sel, new_p, a2_p, nbits = _patch_case(seed, br, bw, cuda)
    got = compressed.patch_blocks(comp, sel, new_p)
    _assert_blocks_equal(got, compressed.compress_blocks(
        a2_p, br=br, bw=bw, nbits=nbits, device=cuda))
    rng = np.random.default_rng(seed + 10)
    x = bitset.np_to_words(_words(rng, nbits, 8), cuda)
    n0 = ops.KERNEL_LAUNCHES["block_sparse_matmul"]
    out = ops.frontier_step_sparse(got, x)
    assert ops.KERNEL_LAUNCHES["block_sparse_matmul"] == n0 + 1
    got_h = dataclasses.replace(got, **{f: getattr(got, f).cpu()
                                        for f in BLOCK_FIELDS})
    want = ref.block_sparse_matmul_ref(got_h, x.cpu())
    assert torch.equal(out.cpu(), want)
    assert torch.equal(want, ref.bitset_matmul_ref(
        bitset.np_to_words(a2_p, "cpu"), ref.pad_k(x.cpu(),
                                                   a2_p.shape[1] * 32)))


@pytest.mark.gpu
@pytest.mark.parametrize("backend", ["matmul", "segment"])
def test_update_interleavings_on_card(cuda, backend):
    """A few ``update_index`` chains on the card (matmul: warm block-sparse
    closures over the patched operands) == pinned rebuilds on the card;
    the patched block operands == fresh ones; answers == the oracle."""
    n_v, n_l = 300, 6
    for trial in range(4):
        rng = np.random.default_rng(40 + trial)
        g = G.random_graph(["er", "pa"][trial % 2], n_v, 1.5, n_l,
                           seed=trial)
        cfg = tdr_build.TDRConfig(vtx_bits=64)
        idx0 = cur = tdr_build.build_index(g, cfg, backend=backend)
        n_b3 = 0   # launches inside update_index alone
        for step in range(3):
            edges = list(zip(cur.graph.src.tolist(),
                             cur.graph.indices.tolist(),
                             cur.graph.labels.tolist()))
            add = [(int(rng.integers(n_v)), int(rng.integers(n_v)),
                    int(rng.integers(n_l))) for _ in range(6)]
            add = [e for e in add if e[0] != e[1]]
            rem = [edges[int(i)] for i in rng.integers(len(edges), size=2)] \
                if step == 2 else []
            delta = cur.graph.apply_updates(add, rem)
            st = tdr_build.UpdateStats()
            before = ops.KERNEL_LAUNCHES["block_sparse_matmul"]
            cur = tdr_build.update_index(cur, delta, backend=backend,
                                         rebuild_threshold=2.0, stats=st)
            n_b3 += ops.KERNEL_LAUNCHES["block_sparse_matmul"] - before
            assert st.mode == "incremental", st
            if backend == "matmul":
                for rev, comp in cur.engine(backend)._bcomp.items():
                    _assert_blocks_equal(comp, compressed.compress_blocks(
                        engine.pack_adjacency_np(cur.graph, reverse=rev),
                        nbits=n_v, device=cuda))
        ref_idx = tdr_build.build_index(cur.graph, cfg, backend=backend,
                                        layout=idx0.disc)
        for f in ALL_PLANES:
            assert torch.equal(getattr(cur, f), getattr(ref_idx, f)), f
        if backend == "matmul":
            assert n_b3 > 0
        qs = [(int(rng.integers(n_v)), int(rng.integers(n_v)),
               pattern.all_of(rng.choice(n_l, 2, replace=False).tolist()))
              for _ in range(24)]
        got = tdr_query.answer_batch(cur, qs, backend=backend)
        assert got.tolist() == [dfs_baseline.answer_pcr(cur.graph, u, v, p)
                                for u, v, p in qs]


@pytest.mark.gpu
def test_snapshot_roundtrip_on_card(cuda, tmp_path):
    """A snapshot saved from the card loads back onto the card
    bit-identically; replaying a logged update through it equals the live
    update."""
    g = G.random_graph("er", 300, 3.0, 6, seed=2)
    idx = tdr_build.build_index(g, tdr_build.TDRConfig(vtx_bits=64))
    path = str(tmp_path / "snap.tdr")
    snapshot.save_index(idx, path, lsn=0)
    back, lsn = snapshot.load_index(path)
    assert lsn == 0
    for f in ALL_PLANES:
        t = getattr(back, f)
        assert t.is_cuda and t.dtype == torch.int32, f
        assert torch.equal(t, getattr(idx, f)), f
    delta = g.apply_updates([(0, 5, 1), (7, 9, 2)], [])
    with deltalog.DeltaLog(str(tmp_path / "wal")) as log:
        log.append(delta.added, delta.removed)
        (_, a, r), = log.replay(lsn)
    live = tdr_build.update_index(idx, delta)
    rec = tdr_build.update_index(back, back.graph.apply_updates(a, r))
    for f in ALL_PLANES:
        assert torch.equal(getattr(rec, f), getattr(live, f)), f


# ------------------------------------------------- regular path queries
RPQ_TEXTS = ("(l0 | l3)*", "l0 (l1 | l2)* l3", "(l0 l1)+", "l2+ l5?",
             "l1 . l4 . (l0 | l5)*", "(l0 | l1 | l2 | l3 | l4 | l5)+", "l6",
             "l3* l0")


def _rpq_queries(rng, n_vertices, n):
    from repro_torch import rpq
    out = []
    for i in range(n):
        u = int(rng.integers(n_vertices))
        v = u if i % 7 == 0 else int(rng.integers(n_vertices))
        out.append((u, v, rpq.parse(RPQ_TEXTS[i % len(RPQ_TEXTS)])))
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["er", "pa"])
@pytest.mark.parametrize("exact_mode", ["auto", "compact", "full"])
def test_rpq_on_card_matches_cpu_segment(cuda, kind, exact_mode):
    """rpq_batch on the card with the default backend (matmul: one
    bitset_matmul per label class per direction per round) and with
    segment equals a CPU segment run and the oracle, with equal rounds."""
    g = G.random_graph(kind, 300, 3.0, 6, seed=5)
    cfg = tdr_build.TDRConfig(vtx_bits=64)
    idx = tdr_build.build_index(g, cfg)
    idx_h = tdr_build.build_index(g, cfg, device="cpu")
    qs = _rpq_queries(np.random.default_rng(6), 300, 64)
    st_h = tdr_query.QueryStats()
    want = tdr_query.rpq_batch(idx_h, qs, exact_mode=exact_mode, stats=st_h,
                               device="cpu")
    assert want.tolist() == [dfs_baseline.answer_rpq(g, u, v, r)
                             for u, v, r in qs]
    for backend in ("auto", "segment"):
        ops.KERNEL_LAUNCHES.clear()
        st = tdr_query.QueryStats()
        got = tdr_query.rpq_batch(idx, qs, backend=backend,
                                  exact_mode=exact_mode, stats=st)
        assert got.tolist() == want.tolist(), backend
        assert st.exact_rounds == st_h.exact_rounds, backend
        if backend == "auto":
            assert ops.KERNEL_LAUNCHES["bitset_matmul"] > 0


@pytest.mark.gpu
def test_rpq_dense_cap_on_the_card_raises(cuda):
    """On the card a product chunk's class stack over the dense cap
    raises DenseCapError: rpq_batch never falls back to segment."""
    g = G.random_graph("er", 300, 3.0, 6, seed=5)
    ecfg = engine.EngineConfig(
        max_dense_bytes=300 * bitset.n_words(300) * 4)
    idx = tdr_build.build_index(g, tdr_build.TDRConfig(vtx_bits=64),
                                engine_config=ecfg)
    qs = _rpq_queries(np.random.default_rng(6), 300, 64)
    with pytest.raises(engine.DenseCapError):
        tdr_query.rpq_batch(idx, qs, engine_config=ecfg, exact_mode="full")


@pytest.mark.gpu
def test_query_server_on_card_matches_direct(cuda, tmp_path):
    """A small QueryServer on a card index (matmul) answers every kind
    equal to direct CPU segment calls, materialises nothing after warmup,
    swaps an update in on the card, and recovers onto the card."""
    from repro_torch.launch import serve
    g = G.random_graph("er", 300, 3.0, 6, seed=8)
    cfg = tdr_build.TDRConfig(vtx_bits=64)
    idx = tdr_build.build_index(g, cfg)
    idx_h = tdr_build.build_index(g, cfg, device="cpu")
    pool = serve.mixed_pool(g, 48, seed=9)
    rqs = _rpq_queries(np.random.default_rng(10), 300, 16)
    srv = serve.QueryServer(idx, backend="matmul", max_wait_ms=1.0)
    try:
        srv.persist_to(str(tmp_path / "p"))
        srv.start()
        srv.warmup(pool)
        n0 = engine.jit_cache_entries()
        futs = [(q + ("bool",), srv.submit(*q)) for q in pool]
        futs += [(q + ("dist",), srv.submit(*q, kind="dist", k=8))
                 for q in pool[:16]]
        futs += [(q + ("rpq",), srv.submit(*q, kind="rpq")) for q in rqs]
        for (u, v, p, kd), f in futs:
            got = f.result(timeout=120)
            if kd == "bool":
                assert got == tdr_query.answer(idx_h, u, v, p, device="cpu")
            elif kd == "dist":
                assert got == int(tdr_query.dist_batch(
                    idx_h, [(u, v, p)], k=8, device="cpu")[0])
            else:
                assert got == tdr_query.answer_rpq(idx_h, u, v, p,
                                                   device="cpu")
        assert engine.jit_cache_entries() == n0
        assert srv.stats.unpinned_batches == srv.stats.overflow_batches == 0
        srv.submit_update([(0, 5, 1), (7, 9, 2)], [], timeout=120)
        assert srv.index.device.type == "cuda"
        live = srv.index
    finally:
        srv.stop(drain=False)
        srv.close_persistence()
    rec = serve.QueryServer.recover(str(tmp_path / "p"), backend="matmul")
    try:
        assert rec.index.device.type == "cuda"
        for f in ALL_PLANES:
            assert torch.equal(getattr(rec.index, f), getattr(live, f)), f
    finally:
        rec.close_persistence()


@pytest.mark.gpu
def test_label_stack_eviction_returns_memory_to_the_card(cuda):
    """A class stack evicted from the engine's LRU on the card gives its
    memory back to the device, where processes sharing the card (fleet
    replicas) can allocate it, instead of to this process's allocator
    cache: evicting an 8-class stack for a 2-class one shrinks what the
    process reserves by the difference."""
    g = G.random_graph("er", 8192, 3.0, 8, seed=22)
    eng = engine.Engine(g, engine.EngineConfig(backend="matmul"))
    one = 8192 * bitset.n_words(8192) * 4          # one class matrix
    eng.label_class_adjacency(tuple(range(7)))     # 8 classes, oldest
    for k in range(1, eng.LABEL_ADJ_CACHE):
        eng.label_class_adjacency((k,), reverse=False)
    torch.cuda.synchronize()
    before = torch.cuda.memory_reserved()
    eng.label_class_adjacency((7,))                # 2 classes: evicts
    torch.cuda.synchronize()
    assert len(eng._label_adj) == eng.LABEL_ADJ_CACHE
    assert tuple(range(7)) not in {k for k, _ in eng._label_adj}
    assert before - torch.cuda.memory_reserved() >= 6 * one - (2 << 20)


# ---------------------------------------------------- replicated fleet
def _fleet_steps(g, rng, n):
    """``n`` update batches (inserts, deletions, label changes) and the
    graph after each, the first entry being ``g``."""
    graphs, steps = [g], []
    for _ in range(n):
        cur = graphs[-1]
        e = rng.choice(cur.n_edges, size=3, replace=False)
        rem = [(int(cur.src[i]), int(cur.indices[i]), int(cur.labels[i]))
               for i in e]
        add = [(u, v, (lab + 1) % cur.n_labels) for u, v, lab in rem[:1]]
        add += [(int(rng.integers(cur.n_vertices)),
                 int(rng.integers(cur.n_vertices)),
                 int(rng.integers(cur.n_labels))) for _ in range(4)]
        add = [a for a in add if a[0] != a[1]]
        steps.append((add, rem[1:]))
        graphs.append(cur.apply_updates(add, rem[1:]).graph)
    return graphs, steps


@pytest.mark.gpu
@pytest.mark.parametrize("backend", ["matmul", "segment"])
def test_follower_on_card_matches_cpu_follower(cuda, backend, tmp_path):
    """A follower on the card tails a small store through update_index
    on the card, and its answers (bool, dist, rpq) equal a CPU
    follower's at every LSN; both stamp the same LSN."""
    from repro_torch.launch import fleet, serve
    g = G.random_graph("er", 300, 3.0, 6, seed=14)
    cfg = tdr_build.TDRConfig(vtx_bits=64)
    d = str(tmp_path / "store")
    fleet.init_store(tdr_build.build_index(g, cfg, device="cpu"), d)
    writer = fleet.FleetWriter(d)
    card = serve.QueryServer.follow(d, backend=backend, poll_s=0.01)
    host = serve.QueryServer.follow(d, poll_s=0.01, device="cpu")
    pool = serve.mixed_pool(g, 24, seed=15)
    rqs = _rpq_queries(np.random.default_rng(16), 300, 8)
    graphs, steps = _fleet_steps(g, np.random.default_rng(17), 4)
    try:
        assert card.index.device.type == "cuda"
        card.start()
        host.start()
        for lsn in range(len(graphs)):
            if lsn:
                assert writer.publish(*steps[lsn - 1]) == lsn
            answers = []
            for srv in (card, host):
                assert srv.wait_for_lsn(lsn, timeout=120)
                futs = [srv.submit(*q, with_lsn=True) for q in pool]
                futs += [srv.submit(*q, kind="dist", k=6, with_lsn=True)
                         for q in pool[:8]]
                futs += [srv.submit(*q, kind="rpq", with_lsn=True)
                         for q in rqs]
                answers.append([f.result(timeout=120) for f in futs])
            assert answers[0] == answers[1], lsn
            assert {s for _, s in answers[0]} == {lsn}
        assert card.index.device.type == "cuda"
    finally:
        card.stop(drain=False)
        host.stop(drain=False)
        writer.close()


@pytest.mark.gpu
def test_fleet_on_card_matches_direct_cpu_calls(cuda, tmp_path,
                                                monkeypatch):
    """Two replica processes on the card behind a FleetRouter: every
    routed answer (bool, dist, rpq, witness length) equals a direct CPU
    call on the graph of its stamped LSN, and consistent reads carry at
    least the pinned LSN."""
    from repro_torch.launch import fleet, serve
    monkeypatch.setenv("OMP_NUM_THREADS", "2")   # the replicas' pools
    from repro_torch.launch.router import FleetRouter
    g = G.random_graph("er", 300, 3.0, 6, seed=18)
    cfg = tdr_build.TDRConfig(vtx_bits=64)
    d = str(tmp_path / "store")
    idx0 = tdr_build.build_index(g, cfg, device="cpu")
    fleet.init_store(idx0, d)
    writer = fleet.FleetWriter(d)
    graphs, steps = _fleet_steps(g, np.random.default_rng(19), 3)
    pool = serve.mixed_pool(g, 24, seed=20)
    rqs = _rpq_queries(np.random.default_rng(21), 300, 8)
    sent, at_lsn = [], {0: idx0}
    try:
        with fleet.Fleet(d, 2, backend="matmul", hb_s=0.1,
                         hb_timeout_s=300) as flt:
            assert len(flt.members()) == 2
            router = FleetRouter(flt)
            for lsn in range(len(graphs)):
                if lsn:
                    writer.publish(*steps[lsn - 1])
                pin = {"min_lsn": lsn, "lsn_timeout": 120} if lsn else {}
                sent += [(q, "bool", router.submit(*q, **pin))
                         for q in pool]
                sent += [(q, "dist", router.submit(*q, kind="dist", k=6,
                                                   **pin))
                         for q in pool[:6]]
                sent += [(q, "witness", router.submit(*q, kind="witness",
                                                      **pin))
                         for q in pool[6:10]]
                sent += [(q, "rpq", router.submit(*q, kind="rpq", **pin))
                         for q in rqs]
                results = [(q, kd, f.result(timeout=300))
                           for q, kd, f in sent[-len(pool) - 18:]]
                for q, kd, (ans, at) in results:
                    assert at >= lsn, (kd, at, lsn)
                    if at not in at_lsn:
                        at_lsn[at] = tdr_build.build_index(
                            graphs[at], cfg, layout=idx0.disc, device="cpu")
                    sent_at = at_lsn[at]
                    u, v, p = q
                    if kd == "bool":
                        want = tdr_query.answer(sent_at, u, v, p,
                                                device="cpu")
                    elif kd == "rpq":
                        want = tdr_query.answer_rpq(sent_at, u, v, p,
                                                    device="cpu")
                    else:
                        want = int(tdr_query.dist_batch(
                            sent_at, [q], k=6 if kd == "dist" else None,
                            device="cpu")[0])
                        if kd == "witness":
                            ans = -1 if ans is None else len(ans)
                    assert ans == want, (kd, q, at)
    finally:
        writer.close()


@pytest.fixture
def card_mesh(cuda):
    """A one-rank gloo group on the card, for the test's duration."""
    import torch.distributed as dist
    from repro_torch import distributed
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield distributed.ShardMesh()
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
@pytest.mark.parametrize("budget", [None, 1, 64])
def test_sharded_build_on_card_matches_single(card_mesh, budget):
    """In process, one gloo rank on the card: the sharded build equals the
    single-device card build, the closure at every row budget equals
    ``r_vtx``, and sharded answers equal the meshless ones with
    ``class_round`` and B2 launched."""
    from repro_torch import distributed
    g = G.random_graph("pa", 257, 2.5, 5, seed=2)
    cfg = tdr_build.TDRConfig(vtx_bits=64)
    single = tdr_build.build_index(g, cfg)
    got = tdr_build.build_index(g, cfg, mesh=card_mesh)
    assert got.device == single.device
    for f in PLANES + ("push", "pop", "g_count"):
        assert torch.equal(getattr(got, f), getattr(single, f)), f
    assert got.fixpoint_rounds == single.fixpoint_rounds
    r = distributed.distributed_closure(g, single.vtx_words, card_mesh,
                                        row_budget=budget)
    assert torch.equal(r, single.r_vtx)
    qs = _kind_queries(np.random.default_rng(3), 257, 5, 40)
    want = tdr_query.answer_batch(single, qs, exact_chunk=4)
    n1, n2 = (ops.KERNEL_LAUNCHES[k] for k in ("class_round",
                                               "way_filter"))
    ans = tdr_query.answer_batch(got, qs, exact_chunk=4, mesh=card_mesh)
    assert ans.tolist() == want.tolist()
    assert ops.KERNEL_LAUNCHES["class_round"] > n1
    assert ops.KERNEL_LAUNCHES["way_filter"] > n2


@pytest.mark.gpu
def test_two_gloo_ranks_on_card(cuda):
    """Two gloo ranks on cuda:0 (``tests/torch_multidevice_check.py
    --card 2``): the sharded build equals the single-device card build and
    ``answer_batch(mesh=)`` launches ``class_round`` and B2."""
    import os
    import subprocess
    import sys
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(os.path.dirname(here), "src") + \
        os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run(
        [sys.executable, os.path.join(here, "torch_multidevice_check.py"),
         "--card", "2"], env=env, capture_output=True, text=True,
        timeout=600)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    assert "torch multidevice check OK" in r.stdout


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["er", "pa"])
def test_legacy_on_card_matches_segment_and_oracle(cuda, kind):
    """``exact_mode="legacy"`` on the card: the matmul form launches B1
    once per label class per round and equals the segment form (answers
    and rounds) and the DFS oracle."""
    g = G.random_graph(kind, 300, 3.0, 6, seed=1)
    idx = tdr_build.build_index(g, tdr_build.TDRConfig(vtx_bits=64))
    qs = _kind_queries(np.random.default_rng(4), 300, 6, 48)
    want = [dfs_baseline.answer_pcr(g, u, v, p) for u, v, p in qs]
    st_m, st_s = tdr_query.QueryStats(), tdr_query.QueryStats()
    n0 = ops.KERNEL_LAUNCHES["bitset_matmul"]
    got = tdr_query.answer_batch(idx, qs, exact_mode="legacy", stats=st_m)
    assert ops.KERNEL_LAUNCHES["bitset_matmul"] > n0
    seg = tdr_query.answer_batch(idx, qs, exact_mode="legacy",
                                 backend="segment", stats=st_s)
    assert got.tolist() == seg.tolist() == want
    assert st_m.exact_rounds == st_s.exact_rounds > 0


@pytest.mark.gpu
def test_legacy_dense_cap_on_the_card_raises(cuda):
    """A legacy class stack over the dense cap raises on the card."""
    g = G.random_graph("er", 300, 3.0, 6, seed=1)
    adj_bytes = 300 * bitset.n_words(300) * 4
    ecfg = engine.EngineConfig(max_dense_bytes=2 * adj_bytes)
    idx = tdr_build.build_index(g, tdr_build.TDRConfig(vtx_bits=64),
                                engine_config=ecfg)
    qs = [(u, (u * 7 + 3) % 300, pattern.all_of([0, 1])) for u in range(64)]
    with pytest.raises(engine.DenseCapError):
        tdr_query.answer_batch(idx, qs, engine_config=ecfg,
                               exact_mode="legacy")


@pytest.mark.gpu
def test_frontier_step_mxu_on_card_matches_the_kernel(cuda):
    rng = np.random.default_rng(5)
    a = bitset.np_to_words(bitset.pack_bits_np(rng.random((300, 512))
                                               < 0.05), cuda)
    x = bitset.np_to_words(_words(rng, 512, 9), cuda)
    assert torch.equal(ops.frontier_step_mxu(a, x), ops.frontier_step(a, x))


@pytest.mark.gpu
@pytest.mark.parametrize("rounds", [0, 2, 40])
def test_closure_2d_on_card_keeps_the_seeds(card_mesh, rounds):
    """One gloo rank on the card: the 2-D closure equals ``seeds | the 1-D
    closure`` at the same round count, and at the fixpoint
    ``seeds | r_vtx``."""
    from repro_torch import distributed
    g = G.random_graph("pa", 257, 2.5, 5, seed=2)
    idx = tdr_build.build_index(g, tdr_build.TDRConfig(vtx_bits=128))
    _, ed = distributed.partition_graph(g, 1)
    args = (bitset.np_to_words(idx.vtx_words, card_mesh.device),
            *(torch.from_numpy(a[0]).to(card_mesh.device) for a in (
                ed.local.astype(np.int64), ed.remote.astype(np.int64),
                ed.valid)))
    e_max = ed.local.shape[1]
    got = distributed.lower_distributed_closure_2d(
        card_mesh, 257, e_max, 128, rounds, word_shards=1)(*args)
    one = distributed.lower_distributed_closure(
        card_mesh, 257, e_max, 128, rounds)(*args)
    assert torch.equal(got, args[0] | one)
    if rounds >= idx.fixpoint_rounds:
        assert torch.equal(got, args[0] | idx.r_vtx)


# ------------------------------------------------------- the LM substrate
# The reduced archs in float32 on the card against the port on the CPU
# from the same weights and batch, TF32 off for matmuls and cuDNN.  The
# sums run in another order on the card, nothing else differs: logits
# O(4) within 1e-4, and a train step's params within a tenth of lr (Adam
# moves a leaf whose grad is near 0 by a fraction of lr that a last-bit
# grad difference changes).
LM_ARCHS = ("dbrx-132b", "deepseek-v2-236b", "gemma3-27b", "musicgen-large",
            "phi-3-vision-4.2b", "phi3-mini-3.8b", "rwkv6-3b", "zamba2-1.2b")


@pytest.fixture
def cuda_fp32(cuda):
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield cuda
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


def _lm_case(arch, dev, s=40):
    from repro_torch import configs, pytree
    from repro_torch.models import init_params
    cfg = configs.get(arch).reduced()
    params = init_params(cfg, 0, device="cpu")
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, s)))
    media = (torch.from_numpy(rng.standard_normal(
        (2, cfg.n_media_tokens, cfg.d_model)).astype(np.float32))
        if cfg.n_media_tokens else None)
    on = pytree.tree_map(lambda t: t.to(dev), params)
    return cfg, params, on, toks, media


@pytest.mark.gpu
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_forward_and_decode_on_card_match_cpu(cuda_fp32, arch):
    from repro_torch.models import decode_step, forward, prefill
    cfg, params, on, toks, media = _lm_case(arch, cuda_fp32)
    med = None if media is None else media.to(cuda_fp32)
    want, aux_h, _ = forward(cfg, params, toks, media)
    got, aux_d, _ = forward(cfg, on, toks.to(cuda_fp32), med)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(aux_d.cpu(), aux_h, rtol=1e-5, atol=1e-7)
    s0 = toks.shape[1] - 3
    lh, ch = prefill(cfg, params, toks[:, :s0], media, max_len=toks.shape[1])
    ld, cd = prefill(cfg, on, toks[:, :s0].to(cuda_fp32), med,
                     max_len=toks.shape[1])
    torch.testing.assert_close(ld.cpu(), lh, rtol=1e-4, atol=1e-4)
    for t in range(s0, toks.shape[1]):
        lh, ch = decode_step(cfg, params, ch, toks[:, t])
        ld, cd = decode_step(cfg, on, cd, toks[:, t].to(cuda_fp32))
        torch.testing.assert_close(ld.cpu(), lh, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(ld.cpu(), want[:, t], rtol=5e-3,
                                   atol=5e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_train_step_on_card_matches_cpu(cuda_fp32, arch):
    from repro_torch import pytree
    from repro_torch.train import (AdamWConfig, init_train_state,
                                   make_train_step)
    cfg, params, _, toks, media = _lm_case(arch, cuda_fp32)
    step = make_train_step(cfg, AdamWConfig(lr=1e-3), remat=True,
                           remat_policy="dots")
    out = {}
    for dev in ("cpu", cuda_fp32):
        batch = {"tokens": toks.to(dev)}
        if media is not None:
            batch["media"] = media.to(dev)
        out[str(dev)] = step(init_train_state(cfg, params, device=dev),
                             batch)
    (sh, mh), (sd, md) = out["cpu"], out[str(cuda_fp32)]
    torch.testing.assert_close(md["loss"].cpu(), mh["loss"], rtol=1e-5,
                               atol=0)
    torch.testing.assert_close(md["grad_norm"].cpu(), mh["grad_norm"],
                               rtol=1e-4, atol=0)
    for (name, a), b in zip(pytree.leaves_with_paths(sh["params"]),
                            pytree.leaves(sd["params"])):
        torch.testing.assert_close(b.cpu(), a, rtol=0, atol=1e-4, msg=name)


@pytest.mark.gpu
def test_lm_bf16_checkpoint_on_card(cuda, tmp_path):
    """A bf16 train state on the card saves and restores onto the card
    bit for bit."""
    import dataclasses as dc
    from repro_torch import configs, pytree
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.models import init_params
    from repro_torch.train import init_train_state
    cfg = dc.replace(configs.get("phi3-mini-3.8b").reduced(),
                     dtype="bfloat16")
    state = init_train_state(cfg, init_params(cfg, 0))
    assert pytree.leaves(state["params"])[0].dtype == torch.bfloat16
    Checkpointer(str(tmp_path)).save(1, state)
    _, got = Checkpointer(str(tmp_path)).restore(state)
    for a, b in zip(pytree.leaves(state), pytree.leaves(got)):
        assert b.device.type == "cuda" and a.dtype == b.dtype
        assert torch.equal(a, b)


@pytest.mark.parametrize("entry", ["init_params", "init_cache",
                                   "init_train_state", "batch_for_step",
                                   "restore", "train_loop", "train_main",
                                   "lm_params_from_numpy"])
def test_lm_entry_points_refuse_the_cpu_by_default(entry, tmp_path,
                                                   monkeypatch):
    """Without a card the LM entry points raise unless asked for the CPU
    (a no-card check: it skips where a card is)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    import sys
    from repro_torch import configs, convert
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.data import DataConfig, batch_for_step
    from repro_torch.launch import train as train_cli
    from repro_torch.models import init_cache, init_params
    from repro_torch.train import AdamWConfig, init_train_state
    cfg = configs.get("phi3-mini-3.8b").reduced()
    params = init_params(cfg, 0, device="cpu")
    ck = Checkpointer(str(tmp_path / "ck"))
    ck.save(1, params)
    dc = DataConfig(vocab=cfg.vocab, seq_len=8, global_batch=2)
    monkeypatch.setattr(sys, "argv", ["train", "--steps", "1",
                                      "--ckpt-dir", str(tmp_path / "cli")])
    call = {"init_params": lambda: init_params(cfg),
            "init_cache": lambda: init_cache(cfg, 1, 8),
            "init_train_state": lambda: init_train_state(cfg, params),
            "batch_for_step": lambda: batch_for_step(dc, 0),
            "restore": lambda: ck.restore(params),
            "train_loop": lambda: train_cli.train_loop(
                cfg, dc, AdamWConfig(), 1, Checkpointer(str(tmp_path / "t"))),
            "train_main": train_cli.main,
            "lm_params_from_numpy": lambda: convert.lm_params_from_numpy(
                convert.lm_params_to_numpy(params))}[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
