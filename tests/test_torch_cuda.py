"""Card legs of the port: each hand-written CUDA kernel against its plain
PyTorch version, and the main path on the card against the segment
backend and the DFS oracle.  Exact equality (the data is bits).

These tests import no JAX, so they run where the card is:
``python -m pytest tests/test_torch_cuda.py -q``.  Without a card they
skip."""
import numpy as np
import pytest
import torch

from repro_torch import (bitset, compressed, dfs_baseline, engine,
                         graph as G, pattern, tdr_build, tdr_query)
from repro_torch.kernels import ops, ref

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


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["er", "pa"])
def test_main_path_on_card_matches_segment_and_oracle(cuda, kind):
    """Build + answer on the card with the default backend (matmul, all
    three kernels) equals the plain-torch segment backend and the DFS
    oracle."""
    g = G.random_graph(kind, 300, 3.0, 6, seed=1)
    cfg = tdr_build.TDRConfig(vtx_bits=64)
    ops.KERNEL_LAUNCHES.clear()
    idx = tdr_build.build_index(g, cfg)
    seg = tdr_build.build_index(g, cfg, backend="segment")
    for f in PLANES:
        assert torch.equal(getattr(idx, f), getattr(seg, f)), f
    assert idx.fixpoint_rounds == seg.fixpoint_rounds
    rng = np.random.default_rng(1)
    fams = (pattern.all_of, pattern.any_of, pattern.none_of)
    qs = [(int(rng.integers(300)), int(rng.integers(300)),
           fams[int(rng.integers(3))](
               rng.choice(6, 2, replace=False).tolist()))
          for _ in range(64)]
    want = [dfs_baseline.answer_pcr(g, u, v, p) for u, v, p in qs]
    for mode in ("auto", "compact", "full"):
        got = tdr_query.answer_batch(idx, qs, exact_mode=mode)
        assert got.tolist() == want, mode
        got = tdr_query.answer_batch(seg, qs, exact_mode=mode,
                                     backend="segment")
        assert got.tolist() == want, mode
    for name in ("bitset_matmul", "way_filter", "block_sparse_matmul"):
        assert ops.KERNEL_LAUNCHES[name] > 0, name


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
