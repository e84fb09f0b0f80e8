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
           "repro_torch.dfs_baseline",
           "repro_torch.engine", "repro_torch.graph", "repro_torch.lcr",
           "repro_torch.pattern", "repro_torch.semiring",
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


def test_entry_points_refuse_the_cpu_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    g = G.erdos_renyi(20, 2.0, 3, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdr_build.build_index(g, tdr_build.TDRConfig(vtx_bits=32))
    idx = tdr_build.build_index(g, tdr_build.TDRConfig(vtx_bits=32),
                                device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdr_query.answer_batch(idx, [(0, 1, pattern.all_of([0]))])


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
