"""The port stands alone: it imports neither JAX nor the ``repro``
reference package, and its entry points refuse to run on the CPU unless
asked to."""
import pathlib
import re
import subprocess
import sys

import pytest
import torch

from repro_torch import (compressed, engine, graph as G, pattern, snapshot,
                         tdr_build, tdr_query)

ROOT = pathlib.Path(__file__).resolve().parents[1]
MODULES = ("repro_torch", "repro_torch.bitset", "repro_torch.compressed",
           "repro_torch.convert", "repro_torch.deltalog",
           "repro_torch.dfs_baseline", "repro_torch.distributed",
           "repro_torch.engine", "repro_torch.graph", "repro_torch.lcr",
           "repro_torch.launch", "repro_torch.launch.fleet",
           "repro_torch.launch.router", "repro_torch.launch.serve",
           "repro_torch.pattern", "repro_torch.rpq", "repro_torch.semiring",
           "repro_torch.snapshot",
           "repro_torch.tdr_build", "repro_torch.tdr_query",
           "repro_torch.kernels", "repro_torch.kernels._build",
           "repro_torch.kernels.bitset_matmul",
           "repro_torch.kernels.block_sparse",
           "repro_torch.kernels.lane_matmul", "repro_torch.kernels.ops",
           "repro_torch.kernels.pattern_filter",
           "repro_torch.kernels.popcount", "repro_torch.kernels.ref")
FORBIDDEN = re.compile(r"^\s*(import\s+jax|from\s+jax|import\s+repro\b(?!_)"
                       r"|from\s+repro(\.|\s)(?!_))", re.M)


def test_import_loads_no_jax_and_no_reference():
    code = ("import sys\n"
            f"for m in {MODULES!r}:\n"
            "    __import__(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.'))\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=120,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("path", sorted(
    [ROOT / "chip_smoke.py"]
    + list((ROOT / "src" / "repro_torch").rglob("*.py"))),
    ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_import_no_jax_or_reference(path):
    assert not FORBIDDEN.search(path.read_text()), path


def test_entry_points_refuse_the_cpu_by_default(tmp_path):
    """The main path and the replicated tier (a follower, the fleet's
    writer, the fleet itself, which spawns nothing) default to the
    card; each runs on the CPU when asked to."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    from repro_torch.launch import fleet, serve
    g = G.erdos_renyi(20, 2.0, 3, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdr_build.build_index(g, tdr_build.TDRConfig(vtx_bits=32))
    idx = tdr_build.build_index(g, tdr_build.TDRConfig(vtx_bits=32),
                                device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdr_query.answer_batch(idx, [(0, 1, pattern.all_of([0]))])
    d = str(tmp_path / "store")
    fleet.init_store(idx, d)
    for call in (lambda: serve.QueryServer.follow(d),
                 lambda: fleet.FleetWriter(d),
                 lambda: fleet.Fleet(d, 2)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    srv = serve.QueryServer.follow(d, device="cpu")
    assert srv.index.device == torch.device("cpu")
    writer = fleet.FleetWriter(d, device="cpu")
    assert writer.graph.n_edges == g.n_edges
    writer.close()
    assert fleet.Fleet(d, 2, device="cpu").members() == []


@pytest.mark.parametrize("ctor", ["Engine", "make_engine", "compress_blocks"])
def test_engine_constructors_refuse_the_cpu_by_default(ctor):
    """The engine and its block operand default to the card too."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    g = G.erdos_renyi(20, 2.0, 3, seed=0)
    build = {"Engine": lambda: engine.Engine(g),
             "make_engine": lambda: engine.make_engine(g),
             "compress_blocks": lambda: compressed.compress_blocks(
                 engine.pack_adjacency_np(g))}[ctor]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build()


def test_every_module_is_checked():
    """MODULES names every module of the package, so a new one cannot
    escape the import check."""
    pkg = ROOT / "src" / "repro_torch"
    found = {".".join(("repro_torch",) + p.relative_to(pkg).with_suffix(
        "").parts).removesuffix(".__init__") for p in pkg.rglob("*.py")}
    assert found == set(MODULES)


@pytest.mark.parametrize("entry", ["dist_batch", "witness", "count_routes",
                                   "answer_mixed"])
def test_kind_entry_points_refuse_the_cpu_by_default(entry):
    """The semiring query kinds default to the card, as answer_batch."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    g = G.erdos_renyi(20, 2.0, 3, seed=0)
    idx = tdr_build.build_index(g, tdr_build.TDRConfig(vtx_bits=32),
                                device="cpu")
    p = pattern.all_of([0])
    call = {"dist_batch": lambda: tdr_query.dist_batch(idx, [(0, 1, p)]),
            "witness": lambda: tdr_query.witness(idx, 0, 1, p),
            "count_routes": lambda: tdr_query.count_routes(idx, 0, 1, p,
                                                           hops=3),
            "answer_mixed": lambda: tdr_query.answer_mixed(
                idx, [(0, 1, p, "dist")])}[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()


@pytest.mark.parametrize("entry", ["load_index", "update_index",
                                   "apply_delta"])
def test_live_index_entry_points_refuse_the_cpu_by_default(entry, tmp_path):
    """The live index defaults to the card too: a snapshot loads onto it,
    and an update or an engine patch runs where the index lives only when
    that is the card, unless the CPU is asked for."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    g = G.erdos_renyi(20, 2.0, 3, seed=0)
    idx = tdr_build.build_index(g, tdr_build.TDRConfig(vtx_bits=32),
                                backend="matmul", device="cpu")
    path = str(tmp_path / "snap.tdr")
    snapshot.save_index(idx, path)
    delta = g.apply_updates([(0, 1, 2)], [])
    eng = idx.engine("matmul")
    call = {"load_index": lambda **kw: snapshot.load_index(path, **kw)[0],
            "update_index": lambda **kw: tdr_build.update_index(
                idx, delta, backend="matmul", **kw),
            "apply_delta": lambda **kw: eng.apply_delta(
                delta.graph, delta.added, delta.removed, **kw)}[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
    out = call(device="cpu")
    assert out.device == torch.device("cpu")


@pytest.mark.parametrize("entry", ["rpq_batch", "answer_rpq",
                                   "answer_mixed", "recover", "serve_main"])
def test_rpq_and_serving_entry_points_refuse_the_cpu_by_default(
        entry, tmp_path, monkeypatch):
    """Regular path queries, server recovery and the serving demo default
    to the card too; the server itself runs where its index lives."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    from repro_torch import rpq
    from repro_torch.launch import serve
    g = G.erdos_renyi(20, 2.0, 3, seed=0)
    idx = tdr_build.build_index(g, tdr_build.TDRConfig(vtx_bits=32),
                                device="cpu")
    r = rpq.parse("l0 . l1*")
    srv = serve.QueryServer(idx)
    srv.persist_to(str(tmp_path / "p"))
    srv.close_persistence()
    monkeypatch.setattr(sys, "argv", ["serve", "--vertices", "20",
                                      "--requests", "4", "--clients", "2"])
    call = {"rpq_batch": lambda: tdr_query.rpq_batch(idx, [(0, 1, r)]),
            "answer_rpq": lambda: tdr_query.answer_rpq(idx, 0, 1, r),
            "answer_mixed": lambda: tdr_query.answer_mixed(
                idx, [(0, 1, r, "rpq")]),
            "recover": lambda: serve.QueryServer.recover(
                str(tmp_path / "p")),
            "serve_main": serve.main}[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
    rec = serve.QueryServer.recover(str(tmp_path / "p"), device="cpu")
    assert rec.index.device == torch.device("cpu")
    rec.close_persistence()


@pytest.mark.parametrize("entry", ["ShardMesh", "build_index(mesh=)"])
def test_sharded_entry_points_refuse_the_cpu_by_default(entry):
    """A ``ShardMesh`` defaults to the card, so a sharded build does too;
    on a CPU gloo group it runs on the CPU when asked to."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    import torch.distributed as dist
    from repro_torch import distributed
    g = G.erdos_renyi(20, 2.0, 3, seed=0)
    cfg = tdr_build.TDRConfig(vtx_bits=32)
    call = {"ShardMesh": lambda **kw: distributed.ShardMesh(**kw),
            "build_index(mesh=)": lambda **kw: tdr_build.build_index(
                g, cfg, mesh=distributed.ShardMesh(**kw))}[entry]
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
        assert call(device="cpu").device == torch.device("cpu")
    finally:
        dist.destroy_process_group()
