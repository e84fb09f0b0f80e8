"""Multi-rank check of the port's sharded path on the CPU (not collected
by pytest directly: ``tests/test_torch_distributed.py`` spawns it).

    PYTHONPATH=src python tests/torch_multidevice_check.py [n_ranks]

The parent computes the JAX package's single-device results (its segment
build, engine closure, answers and the DFS oracle) on the CPU, writes them
to a scratch directory, and spawns ``n_ranks`` (default 4) rank processes
of this script, which form a ``gloo`` group through a file store there.
The ranks import no JAX.  Each asserts:

* the vertex-sharded ``build_index(graph, cfg, mesh=...)`` equals the
  reference's and the port's single-device builds on the nine index
  arrays, ``vtx_words``, ``lab_slot`` and ``fixpoint_rounds``, with V = 57
  not a multiple of the rank count (the padding path);
* ``distributed_closure`` equals the single-device engine closure dense
  and at row budgets 1, 3 and 64;
* ``answer_batch(mesh=...)`` on both backends equals the DFS oracle, the
  reference's answers and the port's meshless answers, with equal
  ``QueryStats``, at several phase-2 chunks per batch (so compacted chunks
  are dealt over the ranks);
* every payload that crosses ``engine.all_gather_words`` is an int32
  ``[rows, W]`` block, never a bool or uint8 plane (a spy on the call).

With ``--card``, the ranks share ``cuda:0`` on ``gloo`` (NCCL refuses two
ranks on one device) and no JAX is imported anywhere:

    PYTHONPATH=src python tests/torch_multidevice_check.py --card [n_ranks]

Each rank asserts that the sharded build on the card equals the
single-device card build, that ``answer_batch(mesh=...)`` equals the
meshless answers (with equal ``QueryStats``) and the DFS oracle, and
reports its kernel launches; the parent asserts that ``bitset_matmul``
(B1) and ``way_filter`` (B2) ran on some rank.

A rank that fails makes the parent kill the others and exit non-zero.
"""
from __future__ import annotations

import datetime
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

N_RANKS = 4
CFG = dict(vtx_bits=64, g_max=4, k=3)
GRAPH = ("pa", 57, 2.3, 4, 3)          # kind, V, degree, labels, seed
CARD_GRAPH = ("er", 301, 3.0, 6, 1)   # --card: V odd, so a padding row
ARRAYS = ("h_vtx", "h_lab", "v_vtx", "v_lab", "n_out", "n_in", "push",
          "pop", "g_count")
BUDGETS = (None, 1, 3, 64)
MODES = ("auto", "compact")
EXACT_CHUNK = 4
N_QUERIES = 24
STAT_FIELDS = ("n_queries", "n_jobs", "filter_false", "filter_true",
               "exact_jobs", "exact_qids", "corridor_active",
               "corridor_total", "compacted_chunks", "full_chunks",
               "saturated_chunks", "exact_rounds")


def mixed_queries(pat, rng, g, n):
    """``tests/_qgen.mixed_queries`` with the same draws, patterns built
    by ``pat`` (either package's pattern module)."""
    qs = []
    for _ in range(n):
        u = int(rng.integers(g.n_vertices))
        v = u if rng.integers(5) == 0 else int(rng.integers(g.n_vertices))
        labs = rng.choice(g.n_labels, size=2, replace=False).tolist()
        p = [pat.all_of(labs), pat.any_of(labs), pat.none_of(labs),
             pat.parse(f"l{labs[0]} & !l{labs[1]}")][int(rng.integers(4))]
        qs.append((u, v, p))
    return qs


def stat_dict(st) -> dict:
    return {f: getattr(st, f) for f in STAT_FIELDS}


def reference(path: str) -> None:
    """The JAX package's single-device results, saved to ``path``."""
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax.numpy as jnp
    from repro.core import (dfs_baseline as RD, graph as RG,
                            pattern as RP, tdr_build as RB,
                            tdr_query as RQ)
    kind, n, deg, n_labels, seed = GRAPH
    g = RG.random_graph(kind, n, deg, n_labels, seed=seed)
    cfg = RB.TDRConfig(**CFG)
    ref = RB.build_index(g, cfg, backend="segment")
    out = {f: np.asarray(getattr(ref, f)) for f in ARRAYS}
    out.update(vtx_words=ref.vtx_words, lab_slot=ref.lab_slot,
               rounds=ref.fixpoint_rounds)
    eng = ref.engine("segment")
    _, _, disc = RB.dfs_intervals(g)
    words = RB._vertex_bit_words(cfg, disc)
    out["seed_words"] = words
    out["closure"] = np.asarray(eng.closure(eng.propagate(
        jnp.asarray(words)))[0])
    qs = mixed_queries(RP, np.random.default_rng(0), g, N_QUERIES)
    out["oracle"] = np.array([RD.answer_pcr(g, u, v, p) for u, v, p in qs])
    out["answers"] = RQ.answer_batch(ref, qs, backend="segment")
    np.savez(path, **out)


def rank_main(rank: int, world: int, tmp: str) -> None:
    import torch
    import torch.distributed as dist
    from repro_torch import (distributed, engine, graph as G, pattern,
                             tdr_build, tdr_query)

    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(tmp, "store"), world),
        rank=rank, world_size=world, timeout=datetime.timedelta(seconds=120))
    ref = np.load(os.path.join(tmp, "ref.npz"))
    payloads = []
    gather = engine.all_gather_words

    def spy(x, mesh):
        payloads.append((x.dtype, x.dim()))
        return gather(x, mesh)

    engine.all_gather_words = spy
    mesh = distributed.ShardMesh(device="cpu")
    assert (mesh.rank, mesh.size) == (rank, world)
    kind, n, deg, n_labels, seed = GRAPH
    g = G.random_graph(kind, n, deg, n_labels, seed=seed)
    cfg = tdr_build.TDRConfig(**CFG)
    single = tdr_build.build_index(g, cfg, backend="segment", device="cpu")
    got = tdr_build.build_index(g, cfg, mesh=mesh)
    for f in ARRAYS:
        a = getattr(got, f).numpy()
        assert np.array_equal(a.view(ref[f].dtype), ref[f]), f
        assert torch.equal(getattr(got, f), getattr(single, f)), f
    assert np.array_equal(got.vtx_words, ref["vtx_words"])
    assert np.array_equal(got.lab_slot, ref["lab_slot"])
    assert got.fixpoint_rounds == single.fixpoint_rounds == int(ref["rounds"])
    print(f"[rank {rank}] sharded build equals both single-device builds",
          file=sys.stderr)

    for budget in BUDGETS:
        r = distributed.distributed_closure(g, ref["seed_words"], mesh,
                                            row_budget=budget)
        assert np.array_equal(r.numpy().view(np.uint32), ref["closure"]), \
            f"closure at row_budget={budget}"
    print(f"[rank {rank}] distributed_closure equal at budgets {BUDGETS}",
          file=sys.stderr)

    qs = mixed_queries(pattern, np.random.default_rng(0), g, N_QUERIES)
    dealt = 0
    for backend in ("segment", "matmul"):
        for mode in MODES:
            kw = dict(backend=backend, exact_mode=mode,
                      exact_chunk=EXACT_CHUNK)
            st_m, st_l = tdr_query.QueryStats(), tdr_query.QueryStats()
            ans = distributed.answer_batch(got, qs, mesh=mesh, stats=st_m,
                                           **kw)
            local = tdr_query.answer_batch(single, qs, stats=st_l,
                                           device="cpu", **kw)
            assert ans.tolist() == ref["oracle"].tolist(), (backend, mode)
            assert ans.tolist() == ref["answers"].tolist(), (backend, mode)
            assert ans.tolist() == local.tolist(), (backend, mode)
            assert stat_dict(st_m) == stat_dict(st_l), (backend, mode)
            dealt = max(dealt, st_m.compacted_chunks)
    assert dealt >= world, f"only {dealt} compacted chunks to deal"
    print(f"[rank {rank}] answer_batch(mesh=) equals the oracle, the "
          f"reference and the meshless answers ({dealt} compacted chunks)",
          file=sys.stderr)

    bad = [p for p in payloads if p != (torch.int32, 2)]
    assert payloads and not bad, f"gathered payloads {sorted(set(bad))}"
    print(json.dumps({"rank": rank, "gathers": len(payloads)}), flush=True)
    dist.destroy_process_group()


def card_rank_main(rank: int, world: int, tmp: str) -> None:
    import torch
    import torch.distributed as dist
    from repro_torch import (dfs_baseline, distributed, graph as G, pattern,
                             tdr_build, tdr_query)
    from repro_torch.kernels import ops

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(tmp, "store"), world),
        rank=rank, world_size=world, timeout=datetime.timedelta(seconds=120))
    mesh = distributed.ShardMesh(device=dev)
    kind, n, deg, n_labels, seed = CARD_GRAPH
    g = G.random_graph(kind, n, deg, n_labels, seed=seed)
    cfg = tdr_build.TDRConfig(**CFG)
    single = tdr_build.build_index(g, cfg)
    got = tdr_build.build_index(g, cfg, mesh=mesh)
    for f in ARRAYS:
        assert torch.equal(getattr(got, f), getattr(single, f)), f
    assert got.fixpoint_rounds == single.fixpoint_rounds
    assert np.array_equal(got.vtx_words, single.vtx_words)

    qs = mixed_queries(pattern, np.random.default_rng(seed), g, 2 * N_QUERIES)
    kw = dict(exact_chunk=EXACT_CHUNK, exact_mode="compact")
    st_l, st_m = tdr_query.QueryStats(), tdr_query.QueryStats()
    local = tdr_query.answer_batch(single, qs, stats=st_l, **kw)
    torch.cuda.synchronize()
    ops.KERNEL_LAUNCHES.clear()
    ans = tdr_query.answer_batch(got, qs, mesh=mesh, stats=st_m, **kw)
    torch.cuda.synchronize()
    launches = dict(ops.KERNEL_LAUNCHES)
    assert ans.tolist() == local.tolist()
    assert stat_dict(st_m) == stat_dict(st_l)
    assert ans.tolist() == [dfs_baseline.answer_pcr(g, u, v, p)
                            for u, v, p in qs]
    print(json.dumps({"rank": rank, "launches": launches,
                      "compacted_chunks": st_m.compacted_chunks}),
          flush=True)
    dist.destroy_process_group()


def main(world: int, card: bool) -> int:
    tmp = tempfile.mkdtemp(prefix="torch_mdc_")
    procs = []
    try:
        if not card:
            reference(os.path.join(tmp, "ref.npz"))
        env = dict(os.environ, OMP_NUM_THREADS="1")
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__),
             "--card-rank" if card else "--rank", str(r), str(world), tmp],
            env=env, stdout=subprocess.PIPE, text=True)
            for r in range(world)]
        deadline = time.monotonic() + 600
        while time.monotonic() < deadline:   # until all exit, or one fails
            codes = [p.poll() for p in procs]
            if None not in codes or any(c not in (None, 0) for c in codes):
                break
            time.sleep(0.1)
        failed = [r for r, p in enumerate(procs) if p.poll() != 0]
        if failed:
            print(f"ranks {failed} failed or timed out", file=sys.stderr)
            return 1
        reports = [json.loads(p.stdout.read().strip().splitlines()[-1])
                   for p in procs]
        for rep in reports:
            print(json.dumps(rep))
        if card:
            for name in ("bitset_matmul", "way_filter"):
                if not sum(rep["launches"].get(name, 0) for rep in reports):
                    print(f"{name} was not launched on any rank",
                          file=sys.stderr)
                    return 1
        print("torch multidevice check OK")
        return 0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    args = sys.argv[1:]
    if args[:1] in (["--rank"], ["--card-rank"]):
        fn = rank_main if args[0] == "--rank" else card_rank_main
        fn(int(args[1]), int(args[2]), args[3])
    else:
        card = args[:1] == ["--card"]
        args = args[1:] if card else args
        sys.exit(main(int(args[0]) if args else N_RANKS, card))
