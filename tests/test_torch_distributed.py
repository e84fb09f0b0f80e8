"""The port's sharded path (``repro_torch.distributed``) against the JAX
package's single-device build and answers, the port's meshless path and
the DFS oracle.  Exact equality throughout.

The in-process legs run on a one-rank ``gloo`` group (a ``HashStore``, set
up and torn down per test); the multi-rank leg spawns
``tests/torch_multidevice_check.py``, which runs 4 ``gloo`` ranks on the
CPU.  The JAX package's own sharded tests do not run on this jax, so its
single-device results are the target: its contract makes them equal to
its sharded ones."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.core import (dfs_baseline as RD, distributed as RDist,
                        graph as RG, pattern as RP, tdr_build as RB,
                        tdr_query as RQ)
from repro_torch import (bitset, dfs_baseline, distributed, engine,
                         graph as G, pattern, tdr_build, tdr_query)
from torch_multidevice_check import ARRAYS, mixed_queries, stat_dict

CFG = dict(vtx_bits=64, g_max=4, k=3)


@pytest.fixture
def one_thread():
    """One intra-op thread for the test: its ops are small, and parallel
    test workers then do not oversubscribe the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def mesh():
    """A one-rank gloo group on the CPU, for the test's duration."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield distributed.ShardMesh(device="cpu")
    finally:
        dist.destroy_process_group()


def _pair(kind, n, deg, n_labels, seed):
    return (RG.random_graph(kind, n, deg, n_labels, seed=seed),
            G.random_graph(kind, n, deg, n_labels, seed=seed))


def _assert_index_equal(got, ref, single=None):
    """Port index ``got`` against a reference index (and a port one) on
    the nine index arrays, the host tables and the round count."""
    for f in ARRAYS:
        want = np.asarray(getattr(ref, f))
        assert np.array_equal(getattr(got, f).numpy().view(want.dtype),
                              want), f
        if single is not None:
            assert torch.equal(getattr(got, f), getattr(single, f)), f
    assert np.array_equal(got.vtx_words, ref.vtx_words)
    assert np.array_equal(got.lab_slot, ref.lab_slot)
    assert got.fixpoint_rounds == ref.fixpoint_rounds


@pytest.mark.parametrize("kind,n,deg,seed", [("pa", 57, 2.3, 3),
                                             ("er", 48, 2.2, 7)])
def test_sharded_build_bit_identical(mesh, kind, n, deg, seed):
    rg, g = _pair(kind, n, deg, 4, seed)
    ref = RB.build_index(rg, RB.TDRConfig(**CFG), backend="segment")
    single = tdr_build.build_index(g, tdr_build.TDRConfig(**CFG),
                                   backend="segment", device="cpu")
    got = tdr_build.build_index(g, tdr_build.TDRConfig(**CFG), mesh=mesh)
    _assert_index_equal(got, ref, single)
    assert got.device == torch.device("cpu")
    # like the reference's: no maintenance planes, the layout pinned
    assert got.r_vtx is None and got.base_v is None and got.d_vtx is None
    assert np.array_equal(got.disc, single.disc)


@pytest.mark.parametrize("backend", ["segment", "matmul"])
def test_sharded_answer_batch_matches_oracle(mesh, backend):
    rg, g = _pair("er", 48, 2.2, 4, 7)
    idx = tdr_build.build_index(g, tdr_build.TDRConfig(**CFG), mesh=mesh)
    rqs = mixed_queries(RP, np.random.default_rng(7), rg, 24)
    qs = mixed_queries(pattern, np.random.default_rng(7), g, 24)
    want = [RD.answer_pcr(rg, u, v, p) for u, v, p in rqs]
    got = distributed.answer_batch(idx, qs, mesh=mesh, backend=backend)
    assert got.tolist() == want
    local = tdr_query.answer_batch(idx, qs, backend=backend, device="cpu")
    assert got.tolist() == local.tolist()


@pytest.mark.parametrize("backend", ["segment", "matmul"])
@pytest.mark.parametrize("exact_mode", ["auto", "compact", "full",
                                        "legacy"])
def test_sharded_query_stats_equal_meshless(mesh, backend, exact_mode):
    """Every counter of ``QueryStats`` (rounds in chunk order included)
    equals the meshless run's and the reference's on a fresh index."""
    rg, g = _pair("pa", 57, 2.3, 4, 3)
    cfg = tdr_build.TDRConfig(**CFG)
    rqs = mixed_queries(RP, np.random.default_rng(0), rg, 24)
    qs = mixed_queries(pattern, np.random.default_rng(0), g, 24)
    kw = dict(backend=backend, exact_mode=exact_mode, exact_chunk=4)
    runs = []
    for use_mesh in (True, False):
        idx = tdr_build.build_index(g, cfg, backend="segment", device="cpu")
        st = tdr_query.QueryStats()
        extra = {"mesh": mesh} if use_mesh else {"device": "cpu"}
        ans = tdr_query.answer_batch(idx, qs, stats=st, **kw, **extra)
        runs.append((ans.tolist(), stat_dict(st), st.plan_lookups,
                     st.plan_misses))
    assert runs[0] == runs[1]
    rst = RQ.QueryStats()
    ridx = RB.build_index(rg, RB.TDRConfig(**CFG), backend="segment")
    rans = RQ.answer_batch(ridx, rqs, stats=rst, backend="segment",
                           exact_mode=exact_mode, exact_chunk=4)
    assert runs[0][0] == rans.tolist()
    assert rst.exact_rounds == runs[0][1]["exact_rounds"]
    assert rst.exact_jobs == runs[0][1]["exact_jobs"]


def test_filter_cascade_sharded_matches_local(mesh):
    import jax.numpy as jnp
    rg, g = _pair("er", 40, 2.0, 4, 5)
    ridx = RB.build_index(rg, RB.TDRConfig(**CFG), backend="segment")
    idx = tdr_build.build_index(g, tdr_build.TDRConfig(**CFG),
                                backend="segment", device="cpu")
    rplan = RQ.compile_queries(
        ridx, mixed_queries(RP, np.random.default_rng(5), rg, 20))
    plan = tdr_query.compile_queries(
        idx, mixed_queries(pattern, np.random.default_rng(5), g, 20))
    rplan_p, plan_p = rplan.pad_to(16 * 2), plan.pad_to(16 * 2)
    sat_out, sat_in = ridx.summary_flags_dev()
    want = np.asarray(RQ._filter_cascade(
        jnp.asarray(rplan_p.u), jnp.asarray(rplan_p.v),
        jnp.asarray(rplan_p.req_w), jnp.asarray(rplan_p.forb_w),
        RQ._null_words_dev(ridx.cfg),
        ridx.vtx_packed, ridx.h_vtx, ridx.h_lab, ridx.v_vtx, ridx.v_lab,
        ridx.n_out, ridx.n_in, sat_out, sat_in, ridx.push, ridx.pop,
        k=ridx.cfg.k, mode="ref"))
    got = distributed.filter_cascade_sharded(idx, plan_p, mesh)
    np.testing.assert_array_equal(got, want)
    local = tdr_query._cascade_rows(idx, plan_p, slice(None)).numpy()
    np.testing.assert_array_equal(got, local)


def test_filter_cascade_sharded_rejects_a_ragged_job_axis(mesh,
                                                          monkeypatch):
    g = G.erdos_renyi(20, 2.0, 3, seed=0)
    idx = tdr_build.build_index(g, tdr_build.TDRConfig(vtx_bits=32),
                                device="cpu")
    plan = tdr_query.compile_queries(idx, [(0, 1, pattern.all_of([0]))])
    monkeypatch.setattr(distributed.ShardMesh, "size", property(
        lambda self: 2))
    with pytest.raises(ValueError, match="not divisible"):
        distributed.filter_cascade_sharded(idx, plan.pad_to(3), mesh)


def test_sharded_build_edgeless_graph(mesh):
    """An edgeless graph builds (every shard slot is padding) and equals
    the single-device planes."""
    ref = RB.build_index(RG.Graph.from_edges(6, 2, []), RB.TDRConfig(**CFG),
                         backend="segment")
    got = tdr_build.build_index(G.Graph.from_edges(6, 2, []),
                                tdr_build.TDRConfig(**CFG), mesh=mesh)
    _assert_index_equal(got, ref)


def test_partition_graph_covers_every_edge():
    rg, g = _pair("pa", 33, 2.5, 3, 1)
    for by in ("src", "dst"):
        v_pad, ed = distributed.partition_graph(g, 4, by=by)
        r_pad, red = RDist.partition_graph(rg, 4, by=by)
        assert v_pad == r_pad
        for f in ("local", "remote", "eidx", "valid"):
            assert np.array_equal(getattr(ed, f), getattr(red, f)), f
        per = v_pad // 4
        own = g.src if by == "src" else np.asarray(g.indices)
        other = np.asarray(g.indices) if by == "src" else g.src
        seen = set()
        for s in range(4):
            for k in np.flatnonzero(ed.valid[s]):
                e = int(ed.eidx[s, k])
                assert e not in seen
                seen.add(e)
                assert own[e] == ed.local[s, k] + s * per
                assert other[e] == ed.remote[s, k]
        assert len(seen) == g.n_edges


def test_distributed_closure_matches_oracle(mesh):
    """The converged closure is the build fixpoint's: R[u] = OR of bits(v)
    over v with u →+ v (a vertex's own bits only on a cycle)."""
    g = G.erdos_renyi(50, 2.0, 4, seed=1)
    cfg = tdr_build.TDRConfig(vtx_bits=64)
    _, _, disc = tdr_build.dfs_intervals(g)
    words = tdr_build._vertex_bit_words(cfg, disc)
    rows = np.unpackbits(words.view(np.uint8), axis=1,
                         bitorder="little")[:, :64].astype(bool)
    rvec = bitset.words_to_np(distributed.distributed_closure(g, words,
                                                              mesh))
    for u in range(0, 50, 7):
        want = rows[dfs_baseline.reachable_set(g, u)].any(axis=0)
        got = np.unpackbits(rvec[u].view(np.uint8),
                            bitorder="little")[:64].astype(bool)
        assert (want == got).all()


@pytest.mark.parametrize("budget", [None, 1, 3, 64])
def test_distributed_closure_matches_reference_engine(mesh, budget):
    """Dense and at every row budget: the reference's single-device
    engine closure."""
    import jax.numpy as jnp
    rg, g = _pair("pa", 57, 2.3, 4, 3)
    cfg = RB.TDRConfig(vtx_bits=64)
    _, _, disc = RB.dfs_intervals(rg)
    words = RB._vertex_bit_words(cfg, disc)
    eng = RB.build_index(rg, cfg, backend="segment").engine("segment")
    want = np.asarray(eng.closure(eng.propagate(jnp.asarray(words)))[0])
    got = distributed.distributed_closure(g, words, mesh, row_budget=budget)
    assert got.dtype == torch.int32
    assert np.array_equal(bitset.words_to_np(got), want)


def test_distributed_closure_rejects_bool_planes(mesh):
    """Packed uint32 words only, never a bool plane."""
    g = G.erdos_renyi(10, 1.5, 2, seed=0)
    with pytest.raises(TypeError, match="packed uint32"):
        distributed.distributed_closure(g, np.zeros((10, 32), dtype=bool),
                                        mesh)


def test_exchange_payloads_are_int32_words(mesh, monkeypatch):
    """Every payload of a sharded build, closure and answer batch crosses
    as an int32 ``[rows, W]`` block (the reference checks its HLO)."""
    seen = []
    real = engine.all_gather_words

    def spy(x, m):
        seen.append((x.dtype, x.dim()))
        return real(x, m)

    monkeypatch.setattr(engine, "all_gather_words", spy)
    g = G.random_graph("pa", 57, 2.3, 4, seed=3)
    cfg = tdr_build.TDRConfig(**CFG)
    idx = tdr_build.build_index(g, cfg, mesh=mesh)
    distributed.distributed_closure(g, idx.vtx_words, mesh, row_budget=3)
    qs = mixed_queries(pattern, np.random.default_rng(0), g, 12)
    distributed.answer_batch(idx, qs, mesh=mesh, backend="segment")
    assert len(seen) > 10
    assert set(seen) == {(torch.int32, 2)}


@pytest.mark.parametrize("backend", ["segment", "matmul"])
def test_update_index_on_sharded_index_rebuilds(mesh, backend):
    """A sharded-built index keeps no maintenance planes, so
    ``update_index`` takes the layout-pinned rebuild through its ``disc``:
    equal to the reference's update of its single-device index and to the
    pinned rebuild."""
    rg, g = _pair("er", 48, 2.2, 4, 7)
    rcfg, cfg = RB.TDRConfig(**CFG), tdr_build.TDRConfig(**CFG)
    idx = tdr_build.build_index(g, cfg, mesh=mesh)
    ridx = RB.build_index(rg, rcfg, backend="segment")
    rng = np.random.default_rng(11)
    add = [(int(a), int(b), int(c)) for a, b, c in zip(
        rng.integers(48, size=6), rng.integers(48, size=6),
        rng.integers(4, size=6))]
    rem = [tuple(int(x) for x in e) for e in
           zip(g.src[:3], g.indices[:3], g.labels[:3])]
    st = tdr_build.UpdateStats()
    got = tdr_build.update_index(idx, edges_added=add, edges_removed=rem,
                                 backend=backend, stats=st, device="cpu")
    assert st.mode == "rebuild" and st.tail == ""
    rst = RB.UpdateStats()
    want = RB.update_index(ridx, edges_added=add, edges_removed=rem,
                           backend="segment", stats=rst)
    _assert_index_equal(got, want)
    pinned = tdr_build.build_index(got.graph, cfg, layout=idx.disc,
                                   backend=backend, device="cpu")
    for f in ARRAYS:
        assert torch.equal(getattr(got, f), getattr(pinned, f)), f


def test_mesh_checks_its_pairing(mesh):
    """A tensor on another device cannot cross the mesh; a mixed backend
    map names a backend per device type; a mesh needs a group."""
    with pytest.raises(ValueError, match="cannot cross"):
        engine.all_gather_words(torch.zeros((2, 1), dtype=torch.int32,
                                            device="meta"), mesh)
    with pytest.raises(TypeError, match="int32"):
        engine.all_reduce_max(torch.zeros(2, dtype=torch.bool), mesh)
    assert distributed._backend_for("cpu:gloo,cuda:nccl", "cuda") == "nccl"
    assert distributed._backend_for("cpu:gloo,cuda:nccl", "cpu") == "gloo"
    assert distributed._backend_for("gloo", "cuda") == "gloo"
    assert (mesh.rank, mesh.size) == (0, 1)


@pytest.mark.usefixtures("one_thread")
def test_shard_mesh_from_a_device_mesh(mesh):
    """A one-rank ``DeviceMesh`` gives the default group in shard order;
    ``ranks`` must be the group's."""
    from torch.distributed.device_mesh import DeviceMesh
    dm = DeviceMesh("cpu", torch.zeros((1, 1), dtype=torch.int64),
                    mesh_dim_names=("vtx", "word"))
    sm = distributed.ShardMesh.from_device_mesh(dm)
    assert (sm.rank, sm.size, sm.ranks, sm.gather_perm) == (0, 1, (0,),
                                                            None)
    assert sm.group is None and sm.device == torch.device("cpu")
    assert sm.global_ranks() == mesh.global_ranks() == (0,)
    with pytest.raises(ValueError, match="not the group's"):
        distributed.ShardMesh(device="cpu", ranks=(1,))


def test_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="process group"):
        distributed.ShardMesh(device="cpu")


def test_build_index_refuses_layout_with_mesh(mesh):
    g = G.erdos_renyi(20, 2.0, 3, seed=0)
    with pytest.raises(ValueError, match="layout"):
        tdr_build.build_index(g, tdr_build.TDRConfig(vtx_bits=32),
                              mesh=mesh, layout=np.arange(20))


def _fixpoint_rounds(g, words, ed, mesh) -> int:
    """Rounds of the converged 1-D closure of ``words`` on ``mesh``."""
    rows = bitset.np_to_words(words, "cpu")
    loc, rem, okw = distributed._shard_edges(ed, 0, "cpu")

    def step(r):
        return engine.propagate_sharded(r, rem, loc, okw, mesh,
                                        num_segments=g.n_vertices,
                                        chunk_words=2)
    return engine.closure_sharded(step(rows), step, mesh,
                                  max_iters=g.n_vertices)[1]


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("nbits", [64, 32])
def test_closure_2d_matches_reference_lowering(mesh, nbits):
    """``lower_distributed_closure_2d`` at ``word_shards=1`` equals the
    reference's 2-D lowering, compiled and run on a one-device mesh, at
    R = 0, 1, 2 and the fixpoint's round count; it keeps the seeds
    (``seeds | the 1-D closure``), where the 1-D form does not."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    g = G.erdos_renyi(60, 2.0, 4, seed=3)
    cfg = tdr_build.TDRConfig(vtx_bits=nbits)
    _, _, disc = tdr_build.dfs_intervals(g)
    words = tdr_build._vertex_bit_words(cfg, disc)
    _, ed = distributed.partition_graph(g, 1, by="src")
    e_max = ed.local.shape[1]
    jmesh = Mesh(np.array(jax.devices()[:1]), ("d",))
    seeds = bitset.np_to_words(words, "cpu")
    args = (seeds, torch.from_numpy(ed.local[0].astype(np.int64)),
            torch.from_numpy(ed.remote[0].astype(np.int64)),
            torch.from_numpy(ed.valid[0]))
    fix = _fixpoint_rounds(g, words, ed, mesh)
    for rounds in (0, 1, 2, fix):
        low = distributed.lower_distributed_closure_2d(
            mesh, 60, e_max, nbits, rounds, word_shards=1)
        assert (low.v_shards, low.per_v, low.per_w, low.coords) == (
            1, 60, nbits // 32, (0, 0))
        got = low(*args)
        want = np.asarray(RDist.lower_distributed_closure_2d(
            jmesh, 60, e_max, nbits, rounds, word_shards=1).compile()(
            jnp.asarray(words[None]), jnp.asarray(ed.local),
            jnp.asarray(ed.remote), jnp.asarray(ed.valid)))
        assert np.array_equal(got.numpy().view(np.uint32),
                              want.reshape(60, -1)), rounds
        one = distributed.lower_distributed_closure(
            mesh, 60, e_max, nbits, rounds)(*args)
        assert torch.equal(got, seeds | one), rounds
        assert not torch.equal(got, one), rounds
    assert [tuple(t.shape) for t in low.inputs()] == [
        (60, nbits // 32), (e_max,), (e_max,), (e_max,)]


@pytest.mark.usefixtures("one_thread")
def test_closure_2d_refuses_bad_word_shards(mesh):
    """``ValueError`` (the reference asserts) where ``word_shards`` does
    not divide the rank count (the words' case needs more ranks:
    ``test_torch_dryrun.py``)."""
    with pytest.raises(ValueError, match="ranks"):
        distributed.lower_distributed_closure_2d(mesh, 60, 8, 64, 2,
                                                 word_shards=2)
    with pytest.raises(ValueError, match="ranks"):
        distributed.lower_distributed_closure_2d(mesh, 60, 8, 64, 2,
                                                 word_shards=0)


@pytest.mark.slow
def test_multidevice_subprocess():
    """The multi-rank leg: 4 gloo ranks on the CPU in fresh processes."""
    here = os.path.dirname(os.path.abspath(__file__))
    src = os.path.join(os.path.dirname(here), "src")
    env = dict(os.environ)
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run(
        [sys.executable, os.path.join(here, "torch_multidevice_check.py")],
        env=env, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    assert "torch multidevice check OK" in r.stdout
