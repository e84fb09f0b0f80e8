"""The port's cost accounting (``utils/cost``, ``utils/roofline``,
``utils/report``, ``launch/dryrun``) and its static-round TDR closure, on
the CPU.

The dry-run needs a ``"fake"`` process group, which a process cannot hold
beside another, so every fake-rank leg runs in a subprocess of its own,
at the reduced configs; the JAX side compiles the same reduced step on
the CPU for ``repro.utils.hlo.analyze``.
"""
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist

import repro.configs as RC
from repro.configs.base import SHAPES
from repro.models import init_params as j_init
from repro.train import AdamWConfig as JAdamW
from repro.train import init_train_state as j_init_state
from repro.train import make_train_step as j_make_step
from repro.utils import hlo as j_hlo
from repro.utils import report as j_report
from repro.utils import roofline as j_roof

from repro_torch import bitset, distributed, engine
from repro_torch import graph as G
from repro_torch import tdr_build
from repro_torch.utils import report, roofline
from repro_torch.utils.cost import StepCost

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH = "phi3-mini-3.8b"
N_MICRO = 2       # train_4k's step at 2 microbatches (the table says 8)


def _run(code: str, timeout: int = 300) -> str:
    """``code`` in a fresh interpreter (one thread); its stdout."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=timeout, cwd=ROOT, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


@pytest.fixture(scope="module")
def cells():
    """Reduced phi3 x train_4k on fake 2x1 and 1x1 meshes, and the TDR
    closure on a fake 2x2 mesh, in one subprocess (a fake group of 4)."""
    code = f"""
import json, torch
torch.set_num_threads(1)
from repro_torch.launch import dryrun
from repro_torch.configs.tdr_graph import TDRGraphConfig
dryrun.init_fake_world(4)
kw = dict(device="cpu", reduced=True, extra={{"n_microbatches": {N_MICRO}}})
out = {{"2x1": dryrun.run_cell("{ARCH}", "train_4k", "single",
                               mesh_shape=(2, 1), **kw),
        "1x1": dryrun.run_cell("{ARCH}", "train_4k", "single",
                               mesh_shape=(1, 1), **kw),
        "tdr": dryrun.run_tdr_cell("single", device="cpu", mesh_shape=(2, 2),
                                   gcfg=TDRGraphConfig(n_vertices=4096,
                                   n_edges=16384, vtx_bits=256, rounds=4))}}
print(json.dumps(out))
"""
    return json.loads(_run(code).strip().splitlines()[-1])


def test_roofline_matches_reference_formulas(monkeypatch):
    """``Roofline.from_cost`` and ``model_flops_*`` are the reference's
    formulas; only the constants are the H100's."""
    for name in ("PEAK_FLOPS", "HBM_BW", "LINK_BW"):
        monkeypatch.setattr(j_roof, name, getattr(roofline, name))
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW) == (
        989e12, 3.35e12, 450e9)
    for flops, hbm, coll in ((3.1e14, 9.5e12, 2.5e11), (1e9, 1e13, 0.0),
                             (0.0, 2e8, 7e11)):
        got = roofline.Roofline.from_cost(
            StepCost(flops=flops, hbm_bytes=hbm, collective_bytes=coll),
            chips=256, model_flops=2.4e16).as_dict()
        want = j_roof.Roofline.from_cost(
            j_hlo.HloCost(flops=flops, hbm_bytes=hbm, collective_bytes=coll),
            chips=256, model_flops=2.4e16).as_dict()
        assert got == want
    for n, d in ((3_821_079_552, 1_048_576), (7, 3)):
        assert roofline.model_flops_train(n, d) == j_roof.model_flops_train(
            n, d)
        assert roofline.model_flops_forward(n, d) == \
            j_roof.model_flops_forward(n, d)


def test_step_flops_match_the_hlo_count(cells):
    """The counted FLOPs of the reduced train_4k step on a 1x1 mesh are
    within 10% of the reference's loop-aware HLO count of the same step
    compiled by JAX on the CPU; a 2-way data mesh halves them."""
    rcfg = RC.get(ARCH).reduced()
    sh = SHAPES["train_4k"]
    key = jax.random.PRNGKey(0)
    state = jax.eval_shape(lambda k: j_init_state(rcfg, j_init(rcfg, k)),
                           key)
    batch = {"tokens": jax.ShapeDtypeStruct((sh.global_batch, sh.seq_len),
                                            jnp.int32)}
    step = j_make_step(rcfg, JAdamW(), n_microbatches=N_MICRO, remat=True)
    text = jax.jit(step).lower(state, batch).compile().as_text()
    want = j_hlo.analyze(text).flops
    one, two = (cells[m]["hlo"]["flops_per_chip"] for m in ("1x1", "2x1"))
    print(f"counted / HLO FLOPs: {one / want:.4f} ({one:.4e} / {want:.4e})")
    assert abs(one / want - 1) < 0.10
    assert two == pytest.approx(one / 2, rel=1e-9)
    assert cells["2x1"]["chips"] == 2


def test_dryrun_records_keep_the_reference_schema(cells):
    rec = cells["2x1"]
    assert set(rec) >= {"arch", "shape", "mesh", "chips", "lower_s",
                        "compile_s", "memory", "hlo", "roofline"}
    assert "xla_cost" not in rec
    assert set(rec["memory"]) == {"argument_gb", "output_gb", "temp_gb",
                                  "peak_gb"}
    assert rec["memory"]["peak_gb"] >= rec["memory"]["argument_gb"] > 0
    h = rec["hlo"]
    assert h["collective_bytes_per_chip"] > 0
    assert h["collective_bytes_per_chip"] == pytest.approx(
        sum(h["collectives"].values()))
    # CommDebugMode counts the same collectives the ring model prices
    assert sum(rec["comm_counts"].values()) == sum(
        h["collective_counts"].values())
    tdr = cells["tdr"]
    assert tdr["hlo"]["flops_per_chip"] == 0.0        # ORs, no matmul
    # 1 + 4 rounds, each gathers the [4096, 8] int32 table
    assert tdr["hlo"]["collectives"] == {"all-gather": 5 * 4096 * 8 * 4}


def test_reduced_cell_end_to_end_and_report(tmp_path):
    """The CLI on a fake 2x2 mesh in a subprocess; ``report`` renders its
    JSON in the reference's table layout (the dry-run table is the
    reference's text; the roofline table its layout in H100 terms)."""
    out = tmp_path / "dryrun.json"
    _run(f"""
from repro_torch.launch import dryrun
dryrun.main(["--arch", "{ARCH}", "--shape", "decode_32k,long_500k",
             "--mesh", "single", "--mesh-shape", "2x2", "--reduced",
             "--device", "cpu", "--out", "{out}"])
""")
    results = json.loads(out.read_text())["results"]
    assert [r.get("skipped") is not None for r in results] == [False, True]
    assert results[0]["chips"] == 4
    assert report.dryrun_table(results) == j_report.dryrun_table(results)
    got = report.roofline_table(results).splitlines()
    want = j_report.roofline_table(results).splitlines()
    assert got[:2] == want[:2] and len(got) == len(want) == 3
    h = results[0]["hlo"]
    assert got[2].split(" | ")[2] == f"{h['flops_per_chip'] / 989e12:.3f}"
    assert "## Dry-run (single-pod" in report.render(results)


def test_expand_branch_on_a_16_wide_model_axis():
    """dbrx's 48 heads over 8 KV heads on a 16-wide model axis: KV is
    expanded to the 48 heads, which shard 3 to a rank; a 40-head dim
    stays whole."""
    code = """
import dataclasses, torch
from torch._subclasses.fake_tensor import FakeTensorMode
import repro_torch.configs as C
from repro_torch.launch import dryrun, sharding
from repro_torch.models import attention, pspec
dryrun.init_fake_world(16)
mesh = dryrun.small_mesh(1, 16, device="cpu")
cfg = dataclasses.replace(C.get("dbrx-132b").reduced(), d_model=384,
                          n_heads=48, n_kv_heads=8)
seen = []
local = attention._sdpa_local
attention._sdpa_local = lambda q, k, v, **kw: (seen.append(
    (q.shape[2], k.shape[2])), local(q, k, v, **kw))[1]
with FakeTensorMode(allow_non_fake_inputs=True):
    gen = torch.Generator().manual_seed(0)
    p = attention.init_gqa(gen, cfg, torch.float32)
    p = sharding.distribute_tree(p, {k: pspec.P("data", "model")
                                     for k in p}, mesh)
    x = torch.empty(2, 16, 384)
    pos = torch.arange(16)[None].repeat(2, 1)
with pspec.use_mesh(mesh, pspec.default_mapping(False)):
    assert pspec.logical_axis_size("heads") == 16
    attention.gqa_forward(p, cfg, x, pos)
    y = pspec.constrain(torch.empty(2, 4, 40, 8), "batch", None, "heads",
                        None)
print(seen, type(y.placements[1]).__name__)
"""
    out = _run(code).strip().splitlines()[-1]
    assert out == "[(3, 3)] Replicate"


@pytest.fixture
def mesh1():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield distributed.ShardMesh(device="cpu")
    finally:
        dist.destroy_process_group()


def test_lowered_closure_equals_distributed_closure(mesh1):
    """At the fixpoint's round count the static-round closure is the
    converged one."""
    g = G.erdos_renyi(60, 2.0, 4, seed=3)
    cfg = tdr_build.TDRConfig(vtx_bits=64)
    _, _, disc = tdr_build.dfs_intervals(g)
    words = tdr_build._vertex_bit_words(cfg, disc)
    want = distributed.distributed_closure(g, words, mesh1)
    v_pad, ed = distributed.partition_graph(g, 1, by="src")
    rows = bitset.np_to_words(words, "cpu")
    loc, rem, okw = distributed._shard_edges(ed, 0, "cpu")
    lowered = distributed.lower_distributed_closure(
        mesh1, g.n_vertices, ed.local.shape[1], 64, rounds=0)

    def step(r):
        return engine.propagate_sharded(r, rem, loc, okw, mesh1,
                                        num_segments=lowered.per,
                                        chunk_words=lowered.chunk_words)
    _, rounds = engine.closure_sharded(step(rows), step, mesh1,
                                       max_iters=v_pad)
    lowered = distributed.lower_distributed_closure(
        mesh1, g.n_vertices, ed.local.shape[1], 64, rounds=rounds)
    valid = torch.from_numpy(ed.valid[0])
    got = lowered(rows, loc, rem, valid)
    assert torch.equal(got, want)
    assert [tuple(t.shape) for t in lowered.inputs()] == [
        (60, 2), (ed.local.shape[1],), (ed.local.shape[1],),
        (ed.local.shape[1],)]


# the reference's figures at this size on 8 host devices (a 1-axis mesh:
# XLA's count of the 1-D gather on a 2-axis mesh is 1.5x, 983,040)
TDR_SMALL = dict(n_vertices=4096, n_edges=16384, vtx_bits=256, rounds=4)
TDR_BYTES = {"tdr-1d": 655_360, "tdr-2d-w4": 163_840, "tdr-2d": 81_920}


@pytest.fixture(scope="module")
def tdr_variants():
    """The three tdr-* iterations on a fake 2x4 mesh (8 ranks) at V =
    4,096, 256 bits and 4 rounds, and the 2-D lowering's refusal of 8
    word shards on a 64-bit row, in one subprocess."""
    code = f"""
import json, torch
torch.set_num_threads(1)
from repro_torch import distributed
from repro_torch.configs.tdr_graph import TDRGraphConfig
from repro_torch.launch import dryrun, perf
dryrun.init_fake_world(8)
g = TDRGraphConfig(**{TDR_SMALL!r})
out = {{it: perf.run_tdr_variant(*perf.TDR_ITERATIONS[it], device="cpu",
                                 mesh_shape=(2, 4), gcfg=g)
        for it in perf.TDR_ITERATIONS}}
mesh = distributed.ShardMesh(device="cpu")
try:
    distributed.lower_distributed_closure_2d(mesh, 4096, 1000, 64, 4)
except ValueError as e:
    out["refused"] = str(e)
print(json.dumps(out))
"""
    return json.loads(_run(code).strip().splitlines()[-1])


def test_tdr_variant_gather_bytes_match_the_hlo_count(tdr_variants):
    """Counted all-gather bytes per rank of the 1-D closure and of the
    2-D closure at 4 and 8 word shards equal ``repro.utils.hlo``'s count
    of the reference's lowerings compiled on 8 host devices:
    ``(rounds + 1) × V × (W / word_shards) × 4``."""
    code = f"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"
import json, jax, numpy as np
from jax.sharding import Mesh
from repro.core import distributed
from repro.utils import hlo
mesh = Mesh(np.array(jax.devices()), ("data",))
s = {TDR_SMALL!r}
args = (mesh, s["n_vertices"], 1000, s["vtx_bits"], s["rounds"])
low = {{"tdr-1d": distributed.lower_distributed_closure(*args),
       "tdr-2d-w4": distributed.lower_distributed_closure_2d(
           *args, word_shards=4),
       "tdr-2d": distributed.lower_distributed_closure_2d(
           *args, word_shards=8)}}
print(json.dumps({{k: dict(hlo.analyze(v.compile().as_text()).collectives)
                  for k, v in low.items()}}))
"""
    ref = json.loads(_run(code).strip().splitlines()[-1])
    for it, want in TDR_BYTES.items():
        got = tdr_variants[it]["hlo"]
        assert ref[it] == {"all-gather": want}, it
        assert got["collectives"] == {"all-gather": want}, it
        assert got["collective_bytes_per_chip"] == want, it


def test_tdr_variant_records_keep_the_reference_schema(tdr_variants):
    for it in TDR_BYTES:
        rec = tdr_variants[it]
        assert set(rec) == {"cell", "variant", "compile_s", "memory", "hlo",
                            "roofline"}, it
        assert (rec["cell"], rec["variant"]) == (
            "tdr-graph", "1d" if it == "tdr-1d" else "2d")
        assert set(rec["memory"]) == {"temp_gb", "argument_gb"}
        assert set(rec["hlo"]) == {"flops_per_chip", "hbm_bytes_per_chip",
                                   "collective_bytes_per_chip",
                                   "collectives"}
        assert rec["hlo"]["flops_per_chip"] == 0.0
        assert rec["roofline"]["model_flops"] == 16384 * 8 * 4
    assert "does not divide the 2 words" in tdr_variants["refused"]
