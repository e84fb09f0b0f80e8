#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``
(at first use, into ``build/torch_kernels/``), then:

1. Main path at full width, through the user entry points with their
   defaults (``device="cuda"``, ``backend="auto"`` -> ``matmul`` with
   block-sparse closures): ``build_index`` then ``answer_batch`` over an
   ER graph of 32,768 vertices (average degree 4, 16 labels, seed 0),
   ``TDRConfig()`` defaults and 512 queries, 128 each of all_of / any_of /
   none_of / lcr over 2 random labels.  The kernel launch counts are set
   to 0 just before and read just after.  The main path runs first so
   that the kernel checks below use its real operands.
2. Each kernel against its plain PyTorch version at the main path's
   shapes (bit-equal, tolerance 0): ``bitset_matmul`` on the real forward
   adjacency with W = 8, 2 and 32; ``way_filter`` through the fused entry
   ``ops.filter_ways_at`` on the run's own plan (``u``, ``v``, required
   and forbidden rows) and the index planes, and through ``filter_ways``
   on the same rows gathered; ``block_sparse_matmul`` on the real
   block-compressed adjacency at two frontiers of the build's own
   closures, the first (``base_v``) and the late delta frontier with the
   fewest live k-blocks (recorded by a spy on ``ops.frontier_step_sparse``
   during the main path's build), each also against dense
   ``bitset_matmul`` on the same adjacency.  Times are medians of CUDA
   event timings after a warm-up.
3. Cross-checks: the same graph built and answered with
   ``backend="segment"`` (plain torch, no kernels) gives identical planes,
   fixpoint rounds and answers; 32 answers (at least 16 from phase 2)
   equal the DFS oracle; every kernel launched on the main path.  The
   engine runs with its default dense cap (the card's free memory); on a
   card an operand over the cap raises, and the CPU's dense-cap warning is
   an error here, so no part of the path can leave the kernels unseen.
4. Semiring kinds on the same index: ``dist_batch`` over 128 queries
   (32 each of all_of / any_of / none_of / lcr over 2 random labels,
   ``default_rng(1)``) with the default backend, launch counts set to 0
   just before and read just after (``lane_matmul`` must have run), then
   with ``backend="segment"``: equal answers and rounds; 16 answers equal
   the BFS oracle; 4 ``witness`` paths replay through ``verify_witness``
   at the ``dist`` length; 4 ``count_routes`` at ``hops=6`` equal the
   walk-count oracle.  Then ``ops.popcount`` and
   ``ops.block_sparse_lane_matmul``, the entry points of the two kernels
   no query path calls yet, with their own launch counts.
5. ``lane_matmul``, ``popcount_rows`` and ``block_sparse_lane_matmul``
   against their plain versions (tolerance 0): B4 on the class matrix and
   DIST16 plane of one ``dist_batch`` call (``min``), and at 4096 x 4096
   for ``sum``/uint32 and ``or``/uint8; B5 on ``h_vtx`` as [rows, words];
   B6 on the forward block adjacency with the same DIST16 plane, also
   against B4 on the decompressed matrix, and the device kernels one B6
   call launches (one without ONE blocks); ``torch.profiler`` gives the
   kernel-only device time of B3, B5 and B6.
6. Where the time goes: the host pieces of build and query timed alone,
   and ``build_index``, ``answer_batch`` and ``dist_batch`` run again
   under ``torch.profiler`` for the device-busy share and the top kernels.
7. The live index, with launch counts set to 0 just before each call of
   the live path (``update_index`` on ``matmul``, the answers,
   ``filters_only``) and read just after it, so the pinned rebuilds and
   the segment chain count nothing: three update batches from ``default_rng(2)`` (256 inserted
   edges; 64 label changes, remove ``(u, v, l)`` and add
   ``(u, v, l + 1)``; 64 deletions) chained through ``update_index`` with
   the default backend (``matmul``: warm block-sparse closures over the
   operands ``Engine.apply_delta`` patched) and with ``segment``; each
   step's 17 planes, ``vtx_words`` and ``disc`` equal the layout-pinned
   rebuild and the segment chain, and batch (a) must run incremental with
   ``block_sparse_matmul`` launched over the block operand it patched.  Then the 512 queries on the updated
   index (matmul equals segment, 32 equal the DFS oracle on the new
   graph, one ``filters_only`` call bounds them); B3 on the patched
   forward block operand, whose every field equals ``compress_blocks`` of
   the new adjacency, against its plain version; and durability:
   ``save_index`` of the built index at LSN 0 under ``build/``, the three
   deltas in a ``DeltaLog``, ``load_index`` onto the card and replay
   through ``update_index`` equal to the chained index.

Prints the card and its power limit, timings, a JSON line of per-kernel
numbers and, last, ``{"ok": true, "device": {...}}``.  Exits non-zero
without a result when there is no CUDA card or no ``src/repro_torch``
beside this file.  Imports nothing from JAX or the ``repro`` package.
"""
from __future__ import annotations

import collections
import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np

N_VERTICES = 32768
AVG_DEGREE = 4.0
N_LABELS = 16
N_PER_FAMILY = 128
N_DIST_PER_FAMILY = 32
N_DIST_ORACLE = 16
N_WITNESS = 4
N_COUNT = 4
COUNT_HOPS = 6
SPY_CALL = 200                 # the lane_matmul call whose operands B4/B6 use
EXACT_CHUNK = 32
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
INT32_OPS_PER_S = 67e12        # data-sheet non-tensor 32-bit rate
KERNEL_REPS = 20
PLAIN_REPS = 5
SLEEP_CYCLES = 20_000_000      # ~10 ms of device sleep per timed call
PLANES = ("h_vtx", "h_lab", "v_vtx", "v_lab", "n_out", "n_in")
# every array an index stores: the planes and the maintenance state
ALL_PLANES = PLANES + ("push", "pop", "g_count", "base_v", "base_l",
                       "base_r", "r_vtx", "r_lab", "r_in", "d_vtx", "d_lab")
N_INSERTS = 256                # live-index batch (a)
N_RELABELS = 64                # live-index batch (b)
N_DELETES = 64                 # live-index batch (c)


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    return 1


def make_queries(pat, n_vertices: int, n_labels: int, seed: int = 0,
                 per_family: int = N_PER_FAMILY):
    """``per_family`` each of all_of / any_of / none_of / lcr over 2
    random labels, uniform random endpoints."""
    rng = np.random.default_rng(seed)
    fams = (pat.all_of, pat.any_of, pat.none_of,
            lambda labs: pat.lcr(labs, n_labels))
    queries = []
    for fam in fams:
        for _ in range(per_family):
            u, v = (int(x) for x in rng.integers(0, n_vertices, size=2))
            labs = sorted(int(x) for x in rng.choice(n_labels, size=2,
                                                     replace=False))
            queries.append((u, v, fam(labs)))
    return queries


def time_ms(torch, fn, reps: int, *, queued: bool = True) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` calls, after warm-up.

    ``queued``: a sleep kernel ahead of each start event keeps the device
    busy while the host enqueues ``fn``, so the events bracket device work
    only (host syncs inside ``fn`` still count).  Without it the time also
    holds the host's launch overhead."""
    fn()
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def profile(torch, fn):
    """(wall s, device-busy s, top kernels, device kernels launched) of one
    call of ``fn`` under ``torch.profiler``; device time is the sum of self
    device times."""
    from torch.profiler import ProfilerActivity, profile as prof_ctx
    torch.cuda.synchronize()
    with prof_ctx(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # kernel entries only: an operator's self device time repeats the
    # time of the kernels it launched
    evs = [e for e in prof.key_averages()
           if str(e.device_type).endswith("CUDA")
           and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in evs) / 1e6
    top = sorted(evs, key=lambda e: -e.self_device_time_total)[:6]
    return wall, busy, [(e.key[:60], e.self_device_time_total / 1e3,
                         e.count) for e in top], sum(e.count for e in evs)


def words_err(torch, got, want) -> int:
    """Largest |got - want| over the unsigned values (0 = bit-equal):
    32-bit words, or the stored 8/16-bit lanes of the semiring kernels."""
    mask = (1 << (8 * got.element_size())) - 1
    g = got.to(torch.int64) & mask
    w = want.to(torch.int64) & mask
    if g.shape != w.shape:
        return mask
    return int((g - w).abs().max()) if g.numel() else 0


def update_batches(rng, g):
    """The live-index phase's three batches as functions of the graph they
    apply to: 256 inserted edges with random labels, 64 label changes
    (remove ``(u, v, l)``, add ``(u, v, l + 1)``), 64 deletions."""
    def inserts(cur):
        uv = rng.integers(0, cur.n_vertices, size=(N_INSERTS, 2))
        uv = uv[uv[:, 0] != uv[:, 1]]
        lab = rng.integers(0, cur.n_labels, size=uv.shape[0])
        return [tuple(int(x) for x in e) for e in zip(*uv.T, lab)], []

    def picked(cur, n):
        e = rng.choice(cur.n_edges, size=n, replace=False)
        return [(int(u), int(v), int(l)) for u, v, l in zip(
            cur.src[e], cur.indices[e], cur.labels[e])]

    def relabels(cur):
        rem = picked(cur, N_RELABELS)
        return [(u, v, (l + 1) % cur.n_labels) for u, v, l in rem], rem

    def deletions(cur):
        return [], picked(cur, N_DELETES)

    return [("a: inserts", inserts), ("b: label changes", relabels),
            ("c: deletions", deletions)]


def live_index_phase(torch, g, cfg, idx, idx_s, seg_cfg, queries, b3_row,
                     kw) -> str | None:
    """Phase 7: three update batches chained through ``update_index`` on
    ``matmul`` and on ``segment``, each equal to the layout-pinned rebuild
    on every plane; B3 on the patched block operand; the 512 queries on
    the updated index; snapshot + delta-log recovery.  Returns a failure
    message, or None."""
    import shutil
    import tempfile
    from repro_torch import (bitset, compressed, deltalog, dfs_baseline,
                             engine, snapshot, tdr_build, tdr_query)
    from repro_torch.kernels import ops

    def same_index(a, b):
        bad = [p for p in ALL_PLANES if not torch.equal(getattr(a, p),
                                                        getattr(b, p))]
        if not np.array_equal(a.vtx_words, b.vtx_words):
            bad.append("vtx_words")
        if not np.array_equal(a.disc, b.disc):
            bad.append("disc")
        return bad

    path = collections.Counter()   # launches of the live path's own calls

    def on_path(fn, *args, **kwargs):
        """One call of the live path, with the counts set to 0 just before
        it and added into ``path`` just after.  The pinned rebuilds, the
        segment chain and the checks run outside these windows."""
        ops.KERNEL_LAUNCHES.clear()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        path.update(ops.KERNEL_LAUNCHES)
        return out

    rng = np.random.default_rng(2)
    cur_m, cur_s, cur_g = idx, idx_s, g
    deltas, idx_a, n_patched = [], None, 0
    torch.cuda.synchronize()
    for name, make in update_batches(rng, g):
        add, rem = make(cur_g)
        delta = cur_g.apply_updates(add, rem)
        warm = cur_m._engines.get("matmul")
        warm = warm is not None and False in warm._bcomp
        n_b3 = path["block_sparse_matmul"]
        st = tdr_build.UpdateStats()
        cur_m = on_path(tdr_build.update_index, cur_m, delta, stats=st)
        n_b3 = path["block_sparse_matmul"] - n_b3
        if st.mode == "incremental" and warm:
            n_patched += n_b3   # warm closures over the patched operand
        st_s = tdr_build.UpdateStats()
        cur_s = tdr_build.update_index(cur_s, delta, engine_config=seg_cfg,
                                       stats=st_s)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pinned = tdr_build.build_index(delta.graph, cfg, layout=idx.disc)
        torch.cuda.synchronize()
        rebuild_s = time.perf_counter() - t0
        cur_g = delta.graph
        deltas.append(delta)
        print(f"update {name}: +{st.n_added} -{st.n_removed} edges; "
              f"matmul mode={st.mode} tail={st.tail or '-'} dirty_fwd="
              f"{st.dirty_fwd} dirty_rev={st.dirty_rev} changed_rows="
              f"{st.changed_rows} patch_rows={st.patch_rows} rounds="
              f"{st.rounds} wall {st.wall_s:.3f} s, block_sparse_matmul "
              f"launches {n_b3}; segment mode={st_s.mode} tail="
              f"{st_s.tail or '-'} wall {st_s.wall_s:.3f} s; layout-pinned "
              f"rebuild {rebuild_s:.3f} s")
        for other, what in ((pinned, "the pinned rebuild"),
                            (cur_s, "the segment chain")):
            bad = same_index(cur_m, other)
            if bad:
                return f"after update {name}, planes {bad} differ from {what}"
        if idx_a is None:
            if st.mode != "incremental" or n_b3 < 1 or not warm:
                return (f"update {name} ran mode={st.mode} with {n_b3} "
                        "block_sparse_matmul launches (block operand cached "
                        f"before: {warm}); expected incremental through the "
                        "kernel over a patched operand")
            idx_a = cur_m
        del pinned

    # the 512 queries on the updated index, and one filters_only call
    stats = tdr_query.QueryStats()
    t0 = time.perf_counter()
    answers = on_path(tdr_query.answer_batch, cur_m, queries,
                      exact_chunk=EXACT_CHUNK, stats=stats)
    answer_s = time.perf_counter() - t0
    upper = on_path(tdr_query.answer_batch, cur_m, queries, filters_only=True)
    print(f"live-index path kernel launches (update_index on matmul, the "
          f"answers, filters_only): {dict(path)}; block_sparse_matmul over "
          f"patched operands: {n_patched}")
    for kname in ("bitset_matmul", "way_filter", "block_sparse_matmul"):
        if path[kname] <= 0:
            return f"{kname} was not launched on the live-index path"
    answers_s = tdr_query.answer_batch(cur_s, queries, exact_chunk=EXACT_CHUNK,
                                       engine_config=seg_cfg)
    print(f"answer_batch on the updated index: {answer_s:.3f} s, "
          f"{len(queries) / answer_s:.1f} queries/s; {int(answers.sum())} "
          f"TRUE; phase 2 jobs={stats.exact_jobs} rounds="
          f"{stats.exact_rounds}; filters_only upper bound "
          f"{int(upper.sum())} TRUE")
    if not np.array_equal(answers, answers_s):
        return "answers on the updated index differ between the backends"
    if (answers & ~upper).any():
        return "filters_only rejected a reachable query"
    exact = list(stats.exact_qids)
    pick = exact[:16] + [q for q in range(len(queries))
                         if q not in set(exact)][:16]
    for qi in pick:
        uq, vq, p = queries[qi]
        if dfs_baseline.answer_pcr(cur_g, uq, vq, p) != bool(answers[qi]):
            return f"query {qi} on the updated index differs from the oracle"
    print(f"oracle: {len(pick)} answers on the updated graph "
          f"({len(exact[:16])} from phase 2) equal the DFS oracle")

    # B3 on the block operand that patch_blocks produced in batch (a)
    eng_a = idx_a.engine()
    comp_p = eng_a.block_adjacency()
    fresh = compressed.compress_blocks(
        engine.pack_adjacency_np(idx_a.graph), br=comp_p.br, bw=comp_p.bw,
        nbits=idx_a.graph.n_vertices)
    stale = [f for f in ("states", "slots", "pool", "mix_bi", "mix_bj",
                         "mix_off", "one_off", "one_bj")
             if not torch.equal(getattr(comp_p, f), getattr(fresh, f))]
    if stale or comp_p.n_mixed != fresh.n_mixed:
        return f"patched block operand fields {stale} differ from fresh"
    print(f"patched block operand: {comp_p.n_mixed} MIXED blocks (fresh "
          f"compress_blocks: {fresh.n_mixed}), every field equal")
    del fresh
    adj_p = eng_a.adjacency()
    a_unp_p = bitset.unpack_bits(adj_p, kw * 32).to(torch.bfloat16)
    if not b3_row("patched", comp_p, idx_a.base_v, adj_p, a_unp_p, False,
                  n_launches=n_patched):
        return "block_sparse_matmul disagrees on the patched operand"
    del a_unp_p

    # durability: snapshot at LSN 0, the three deltas logged, recovery
    root = Path(__file__).resolve().parent / "build"
    root.mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="live_", dir=root)
    try:
        path, wal = f"{tmp}/snap.tdr", f"{tmp}/delta.wal"
        t0 = time.perf_counter()
        n_bytes = snapshot.save_index(idx, path, lsn=0)
        save_s = time.perf_counter() - t0
        with deltalog.DeltaLog(wal) as log:
            for d in deltas:
                log.append(d.added, d.removed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rec, lsn = snapshot.load_index(path)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        with deltalog.DeltaLog(wal, create=False) as log:
            for _, a, r in log.replay(lsn):
                rec = tdr_build.update_index(rec,
                                             rec.graph.apply_updates(a, r))
        torch.cuda.synchronize()
        replay_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    mem = idx.index_memory_stats()
    print(f"snapshot: {n_bytes} bytes, save {save_s:.3f} s, load "
          f"{load_s:.3f} s, replay of {len(deltas)} log records "
          f"{replay_s:.3f} s; the nine query-side planes: "
          f"{mem['dense_bytes']} bytes dense, {mem['compressed_bytes']} "
          f"compressed (ratio {mem['ratio']}), per plane "
          + ", ".join(f"{k} {v['ratio']}" for k, v in mem["planes"].items()))
    bad = same_index(rec, cur_m)
    if bad:
        return f"snapshot + replay planes {bad} differ from the chained index"
    if rec.device.type != "cuda":
        return f"the snapshot loaded onto {rec.device}"
    return None


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        return fail("no CUDA device is available")
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        return fail(f"no src/repro_torch beside {Path(__file__).name}")
    sys.path.insert(0, str(src))
    from repro_torch import (bitset, dfs_baseline, engine, graph, pattern,
                             tdr_build, tdr_query)
    from repro_torch.kernels import _build, ops, ref

    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions exact
    warnings.simplefilter("error", engine.DenseCapWarning)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip())
    t0 = time.perf_counter()
    lib = _build.library()
    print(f"kernel build: {lib.build_seconds:.3f} s nvcc, "
          f"{time.perf_counter() - t0:.3f} s to load ({lib.path.name})")

    g = graph.erdos_renyi(N_VERTICES, AVG_DEGREE, N_LABELS, seed=0)
    cfg = tdr_build.TDRConfig()
    queries = make_queries(pattern, g.n_vertices, g.n_labels)
    print(f"graph: V={g.n_vertices} E={g.n_edges} L={g.n_labels}; "
          f"{len(queries)} queries")

    # ---- 1. main path ---------------------------------------------------
    sparse_fn = ops.frontier_step_sparse
    sparse_calls = []

    def sparse_spy(comp, x):   # observes one call's operands; computes nothing
        sparse_calls.append((comp, x))
        return sparse_fn(comp, x)

    torch.cuda.synchronize()
    ops.frontier_step_sparse = sparse_spy
    ops.KERNEL_LAUNCHES.clear()
    t0 = time.perf_counter()
    idx = tdr_build.build_index(g, cfg)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    ops.frontier_step_sparse = sparse_fn
    mem_after_build = torch.cuda.memory_allocated()
    stats = tdr_query.QueryStats()
    t0 = time.perf_counter()
    answers = tdr_query.answer_batch(idx, queries, exact_mode="auto",
                                     exact_chunk=EXACT_CHUNK, stats=stats)
    torch.cuda.synchronize()
    answer_s = time.perf_counter() - t0
    launches = dict(ops.KERNEL_LAUNCHES)
    eng = idx.engine()
    print(f"build_index[{eng.backend}]: {build_s:.3f} s, "
          f"fixpoint_rounds={idx.fixpoint_rounds}; device memory in use "
          f"after build: {mem_after_build / 2**20:.1f} MiB")
    unknown = stats.n_jobs - stats.filter_false - stats.filter_true
    print(f"answer_batch[{eng.backend}]: {answer_s:.3f} s, "
          f"{len(queries) / answer_s:.1f} queries/s; {stats.n_jobs} jobs, "
          f"phase 1 FALSE={stats.filter_false} TRUE={stats.filter_true} "
          f"UNKNOWN={unknown}; phase 2 jobs={stats.exact_jobs}, "
          f"rounds={stats.exact_rounds}, chunks compacted="
          f"{stats.compacted_chunks} full={stats.full_chunks} "
          f"(saturated {stats.saturated_chunks}); "
          f"{int(answers.sum())} TRUE answers")
    print(f"main-path kernel launches: {launches}")
    if answers.shape != (len(queries),) or answers.dtype != bool:
        return fail(f"answers have shape {answers.shape} {answers.dtype}")
    if eng.backend != "matmul":
        return fail(f"auto backend resolved to {eng.backend}")

    # ---- 2. kernels against their plain versions ------------------------
    dev = idx.device
    rows = []

    def record(name, source, replaces, got, want, k_fn, p_fn, nbytes, nops,
               lib_fn=None, n_launches=None, err=None):
        err = words_err(torch, got, want) if err is None else err
        ms = time_ms(torch, k_fn, KERNEL_REPS)
        call_ms = time_ms(torch, k_fn, KERNEL_REPS, queued=False)
        plain = time_ms(torch, p_fn, PLAIN_REPS)
        lib_ms = time_ms(torch, lib_fn, PLAIN_REPS) if lib_fn else None
        b_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        b_ops = nops / INT32_OPS_PER_S * 1e3
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": n_launches if n_launches is not None
            else launches.get(name.split("[")[0], 0),
            "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": max(b_bytes, b_ops),
            "bound_by": "bytes" if b_bytes >= b_ops else "operations",
            "library_ms": lib_ms})
        print(f"{name}: max_abs_err={err} ms={ms:.4f} (one call with host "
              f"launch: {call_ms:.4f}) plain_ms={plain:.4f} "
              f"bound_ms={max(b_bytes, b_ops):.4f} library_ms={lib_ms}")
        return err == 0

    def print_profiled(name, fn):
        """Kernel-only device time per launch over KERNEL_REPS calls;
        returns the device kernels one call launched (the profiler may
        miss the first kernel it traces, hence the rounding)."""
        _, _, top, n_kernels = profile(torch, lambda: [
            fn() for _ in range(KERNEL_REPS)])
        print(f"{name} profiled: " + "; ".join(
            f"{k} {1e3 * ms / n:.4f} us x{n}" for k, ms, n in top))
        return round(n_kernels / KERNEL_REPS)

    ok = True
    one = torch.zeros(1, dtype=torch.int32, device=dev)
    print(f"single-launch floor (one 4-byte zero_, same timing): "
          f"{time_ms(torch, one.zero_, KERNEL_REPS):.4f} ms")
    adj = eng.adjacency()                                  # [V, V/32]
    m, kw = adj.shape
    a_bits = int(np.unique(g.src.astype(np.int64) * g.n_vertices
                           + g.indices).size)          # set bits of A
    xs = {8: idx.vtx_packed, 2: idx.d_lab[:, 0].contiguous(),
          32: torch.cat([idx.r_vtx, idx.n_in, idx.n_out, idx.base_r],
                        dim=1).contiguous()}
    # library yardstick of B1 and B3 (timed only): one bf16 matmul of the
    # unpacked operands
    a_unp = bitset.unpack_bits(adj, kw * 32).to(torch.bfloat16)
    for w, x in xs.items():
        x = ref.pad_k(x, kw * 32).contiguous()
        got = ops.frontier_step(adj, x)
        want = ref.bitset_matmul_ref(adj, x)
        x_unp = bitset.unpack_bits(x, w * 32).to(torch.bfloat16)
        ok &= record(
            f"bitset_matmul[W={w}]",
            "src/repro_torch/kernels/csrc/bitset_matmul.cu",
            "src/repro/kernels/bitset_matmul.py:45", got, want,
            lambda: ops.frontier_step(adj, x),
            lambda: ref.bitset_matmul_ref(adj, x),
            (m * kw + x.numel() + m * w) * 4, m * kw + 2 * a_bits * w,
            lambda: torch.matmul(a_unp, x_unp))
        del x_unp

    plan = tdr_query.compile_queries(idx, queries)
    plan_p = plan.pad_to(graph.pad_bucket(plan.n_jobs, lo=16))
    u = torch.from_numpy(plan_p.u.astype(np.int64)).to(dev)
    v = torch.from_numpy(plan_p.v.astype(np.int64)).to(dev)
    rfn = [bitset.np_to_words(a, dev) for a in (
        plan_p.req_w, plan_p.forb_w, tdr_build._null_words(cfg))]
    fat = (u, v, *rfn, idx.vtx_packed, idx.h_vtx, idx.h_lab, idx.v_vtx,
           idx.v_lab)
    fargs = (idx.h_vtx[u], idx.h_lab[u], idx.v_vtx[u], idx.v_lab[u],
             idx.vtx_packed[v], *rfn)
    j, gw = fargs[0].shape[:2]
    fused = ops.filter_ways_at(*fat)
    gathered_err = max(words_err(torch, ops.filter_ways(*fargs), fused),
                       words_err(torch, ref.way_filter_ref(*fargs), fused))
    n_u, n_v = int(u.unique().numel()), int(v.unique().numel())
    way_row_words = sum(t[0].numel() for t in fat[6:])  # one u's plane rows
    print(f"way_filter: {j} jobs x {gw} ways, {n_u} distinct u, {n_v} "
          f"distinct v; max_abs_err of filter_ways on the gathered rows "
          f"{gathered_err}; {int(fused.sum())} viable ways")
    ok &= gathered_err == 0
    ok &= record(
        "way_filter", "src/repro_torch/kernels/csrc/way_filter.cu",
        "src/repro/kernels/pattern_filter.py:29",
        fused, ref.way_filter_at_ref(*fat),
        lambda: ops.filter_ways_at(*fat),
        lambda: ref.way_filter_at_ref(*fat),
        n_u * way_row_words * 4 + n_v * idx.vtx_packed.shape[1] * 4
        + j * 8 * 2 + sum(t.numel() for t in rfn) * 4 + j * gw,
        j * way_row_words * 2)

    # B3 at the first closure frontier and at the build's late delta
    # frontier with the fewest live k-blocks (ties: the later call)
    comp_f = eng.block_adjacency()
    kb, bk = comp_f.grid[1], comp_f.bw * 32
    live_ks = [int(ref.k_block_summaries(x, c.grid[1], c.bw * 32)[1].sum())
               for c, x in sparse_calls]
    late = min((n, -i) for i, n in enumerate(live_ks) if n > 0)
    late_i = -late[1]
    print(f"block_sparse_matmul: {len(sparse_calls)} main-path calls, live "
          f"k-blocks per call {live_ks}; late frontier = call {late_i}")
    frontiers = [("first", comp_f, idx.base_v),
                 ("late", *sparse_calls[late_i])]

    def b3_row(label, bcomp, x, adj_c, a_unp_c, reverse, n_launches=None):
        """B3 on one operand and frontier against its plain version and
        dense B1 on the same matrix, with its bounds and profiled time."""
        xany = ref.k_block_summaries(x, kb, bk)[1] != 0
        mix_live = xany[bcomp.mix_bj[:bcomp.n_mixed].long()]
        one_live = xany[bcomp.one_bj.long()]
        n_mixed_live, n_one_live = int(mix_live.sum()), int(one_live.sum())
        live_bits = int(bitset.popcount(
            bcomp.pool[:bcomp.n_mixed][mix_live].reshape(-1, 1)).sum())
        w = x.shape[1]
        out_bytes = bcomp.shape[0] * w * 4
        # least bytes: X once, the live lists (offsets and every entry's
        # k-block id), the live MIXED pool blocks, the output
        bs_bytes = (x.numel() * 4 + 2 * (bcomp.grid[0] + 1) * 4
                    + (bcomp.n_mixed + bcomp.one_bj.numel()) * 4
                    + n_mixed_live * bcomp.br * bcomp.bw * 4 + out_bytes)
        # the count over the state grid in place of the lists (the
        # earlier kernel's bound)
        grid_bytes = (bcomp.states.numel() + (n_mixed_live + n_one_live) * 4
                      + n_mixed_live * bcomp.br * bcomp.bw * 4
                      + kb * (1 + w) * 4 + int(xany.sum()) * bk * w * 4
                      + bcomp.grid[0] * bcomp.br * w * 4)
        got = ops.frontier_step_sparse(bcomp, x)
        err = max(words_err(torch, got, ref.block_sparse_matmul_ref(bcomp, x)),
                  words_err(torch, got, ops.frontier_step(
                      adj_c, ref.pad_k(x, kw * 32).contiguous())))
        x_unp = bitset.unpack_bits(ref.pad_k(x, kw * 32), w * 32).to(
            torch.bfloat16)
        print(f"block_sparse_matmul[{label}]: "
              f"{'reverse' if reverse else 'forward'} adjacency, X "
              f"{tuple(x.shape)}, {int(xany.sum())} of {kb} "
              f"k-blocks live, {n_mixed_live} of {bcomp.n_mixed} MIXED and "
              f"{n_one_live} of {bcomp.one_bj.numel()} ONE blocks live, "
              f"{live_bits} live set bits; bound counted over the state grid "
              f"{grid_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms")
        good = record(
            f"block_sparse_matmul[{label}]",
            "src/repro_torch/kernels/csrc/block_sparse.cu",
            "src/repro/kernels/block_sparse.py:55", got, got,
            lambda: ops.frontier_step_sparse(bcomp, x),
            lambda: ref.block_sparse_matmul_ref(bcomp, x),
            bs_bytes, x.numel() + live_bits * w + n_one_live * bcomp.br * w,
            lambda: torch.matmul(a_unp_c, x_unp), n_launches=n_launches,
            err=err)
        print_profiled(f"block_sparse_matmul[{label}]",
                       lambda: ops.frontier_step_sparse(bcomp, x))
        return good

    for label, bcomp, x in frontiers:
        rev = bcomp is eng.block_adjacency(reverse=True)
        adj_c = eng.adjacency(reverse=rev)
        a_unp_c = a_unp if not rev else bitset.unpack_bits(
            adj_c, kw * 32).to(torch.bfloat16)
        ok &= b3_row(label, bcomp, x, adj_c, a_unp_c, rev)
        del a_unp_c
    comp = comp_f
    del a_unp
    if not ok:
        return fail("a kernel disagrees with its plain version")

    # ---- 3. cross-checks -------------------------------------------------
    for name in ("bitset_matmul", "way_filter", "block_sparse_matmul"):
        if launches.get(name, 0) <= 0:
            return fail(f"{name} was not launched on the main path")
    seg_cfg = engine.EngineConfig(backend="segment",
                                  bit_chunk=cfg.bit_chunk)
    t0 = time.perf_counter()
    idx_s = tdr_build.build_index(g, cfg, engine_config=seg_cfg)
    torch.cuda.synchronize()
    print(f"build_index[segment]: {time.perf_counter() - t0:.3f} s, "
          f"fixpoint_rounds={idx_s.fixpoint_rounds}")
    for f in PLANES:
        if not torch.equal(getattr(idx, f), getattr(idx_s, f)):
            return fail(f"plane {f} differs between matmul and segment")
    if idx.fixpoint_rounds != idx_s.fixpoint_rounds:
        return fail("fixpoint_rounds differ between matmul and segment")
    stats_s = tdr_query.QueryStats()
    t0 = time.perf_counter()
    answers_s = tdr_query.answer_batch(idx_s, queries, exact_chunk=EXACT_CHUNK,
                                       stats=stats_s, engine_config=seg_cfg)
    seg_s = time.perf_counter() - t0
    print(f"answer_batch[segment]: {seg_s:.3f} s, "
          f"{len(queries) / seg_s:.1f} queries/s, "
          f"rounds={stats_s.exact_rounds}")
    if not np.array_equal(answers, answers_s):
        return fail("answers differ between matmul and segment")
    if stats_s.exact_rounds != stats.exact_rounds:
        return fail("phase-2 rounds differ between matmul and segment")

    exact = [q for q in stats.exact_qids]
    others = [q for q in range(len(queries)) if q not in set(exact)]
    pick = exact[:24] + others[:32 - len(exact[:24])]
    if len(exact[:24]) < 16:
        return fail(f"only {len(exact)} queries reached phase 2")
    t0 = time.perf_counter()
    for qi in pick:
        uq, vq, p = queries[qi]
        if dfs_baseline.answer_pcr(g, uq, vq, p) != bool(answers[qi]):
            return fail(f"query {qi} differs from the DFS oracle")
    print(f"oracle: {len(pick)} answers ({len(exact[:24])} from phase 2) "
          f"equal the DFS oracle ({time.perf_counter() - t0:.1f} s)")

    # ---- 4. semiring kinds on the same index -----------------------------
    from repro_torch import semiring
    dq = make_queries(pattern, g.n_vertices, g.n_labels, seed=1,
                      per_family=N_DIST_PER_FAMILY)
    spied = {"n": 0}
    lanes_fn = ops.frontier_step_lanes

    def spy(a, x, **kw):   # observes one call's operands; computes nothing
        spied["n"] += 1
        if spied["n"] == SPY_CALL or "a" not in spied:
            spied["a"], spied["x"] = a, x
        return lanes_fn(a, x, **kw)

    torch.cuda.synchronize()
    ops.frontier_step_lanes = spy
    ops.KERNEL_LAUNCHES.clear()
    dstats = tdr_query.QueryStats()
    t0 = time.perf_counter()
    dists = tdr_query.dist_batch(idx, dq, exact_chunk=EXACT_CHUNK,
                                 stats=dstats)
    torch.cuda.synchronize()
    dist_s = time.perf_counter() - t0
    dist_launches = dict(ops.KERNEL_LAUNCHES)
    ops.frontier_step_lanes = lanes_fn
    print(f"dist_batch[{eng.backend}]: {dist_s:.3f} s, "
          f"{len(dq) / dist_s:.1f} queries/s; {dstats.n_jobs} jobs, "
          f"rounds={dstats.exact_rounds}, corridor occupancy "
          f"{dstats.corridor_occupancy:.3f}; {int((dists >= 0).sum())} "
          f"reachable; launches {dist_launches}")
    if dists.shape != (len(dq),) or dists.dtype != np.int64:
        return fail(f"distances have shape {dists.shape} {dists.dtype}")
    if dist_launches.get("lane_matmul", 0) <= 0:
        return fail("lane_matmul was not launched by dist_batch")
    dstats_s = tdr_query.QueryStats()
    t0 = time.perf_counter()
    dists_s = tdr_query.dist_batch(idx, dq, exact_chunk=EXACT_CHUNK,
                                   stats=dstats_s, backend="segment")
    torch.cuda.synchronize()
    dist_seg_s = time.perf_counter() - t0
    print(f"dist_batch[segment]: {dist_seg_s:.3f} s, "
          f"{len(dq) / dist_seg_s:.1f} queries/s, "
          f"rounds={dstats_s.exact_rounds}")
    if not np.array_equal(dists, dists_s):
        return fail("distances differ between matmul and segment")
    if dstats.exact_rounds != dstats_s.exact_rounds:
        return fail("dist rounds differ between matmul and segment")
    t0 = time.perf_counter()
    for qi in range(N_DIST_ORACLE):
        uq, vq, p = dq[qi * len(dq) // N_DIST_ORACLE]
        if dfs_baseline.shortest_pcr(g, uq, vq, p) != int(
                dists[qi * len(dq) // N_DIST_ORACLE]):
            return fail(f"dist query {qi} differs from the BFS oracle")
    print(f"oracle: {N_DIST_ORACLE} distances equal the BFS oracle "
          f"({time.perf_counter() - t0:.1f} s)")
    reach = [i for i in np.argsort(-dists, kind="stable") if dists[i] > 0]
    t0 = time.perf_counter()
    for qi in reach[:N_WITNESS]:
        uq, vq, p = dq[qi]
        path = tdr_query.witness(idx, uq, vq, p)
        if path is None or len(path) != int(dists[qi]) or not \
                dfs_baseline.verify_witness(g, uq, vq, p, path):
            return fail(f"witness of dist query {qi} does not replay at "
                        f"length {int(dists[qi])}")
    witness_s = time.perf_counter() - t0
    # single-term queries, those reachable within the hop bound first
    single = sorted(
        (i for i in range(len(dq)) if len(pattern.to_dnf(dq[i][2])) == 1),
        key=lambda i: (not 0 < dists[i] <= COUNT_HOPS, -int(dists[i])))
    single = [dq[i] for i in single[:N_COUNT]]
    t0 = time.perf_counter()
    counts = [tdr_query.count_routes(idx, uq, vq, p, hops=COUNT_HOPS)
              for uq, vq, p in single]
    count_s = time.perf_counter() - t0
    want_counts = [dfs_baseline.count_routes(
        g, uq, vq, p, hops=COUNT_HOPS, cap=semiring.COUNT_CAP)
        for uq, vq, p in single]
    if counts != want_counts:
        return fail(f"route counts {counts} differ from the oracle "
                    f"{want_counts}")
    print(f"witness: {N_WITNESS} paths of lengths "
          f"{[int(dists[i]) for i in reach[:N_WITNESS]]} replay "
          f"({witness_s:.3f} s); count_routes[hops={COUNT_HOPS}]: "
          f"{counts} equal the oracle ({count_s:.3f} s)")

    # the entry points of the two kernels that no query path calls yet
    h_rows = idx.h_vtx.reshape(-1, idx.h_vtx.shape[-1])
    x_dist = spied["x"]
    torch.cuda.synchronize()
    ops.KERNEL_LAUNCHES.clear()
    ops.popcount(h_rows)
    ops.block_sparse_lane_matmul(comp, x_dist, op="min")
    torch.cuda.synchronize()
    aux_launches = dict(ops.KERNEL_LAUNCHES)
    print(f"kernel entry points: launches {aux_launches}")
    for name in ("popcount_rows", "block_sparse_lane_matmul"):
        if aux_launches.get(name, 0) <= 0:
            return fail(f"{name} was not launched by its entry point")

    # ---- 5. the semiring kernels against their plain versions ------------
    a_dist = spied["a"]
    lanes_b = x_dist.element_size()
    a_rows, a_cols = ref.set_bits(a_dist)
    w_d = x_dist.shape[1]
    print(f"B4 operand (lane_matmul call {min(SPY_CALL, spied['n'])} of "
          f"{spied['n']}): A {tuple(a_dist.shape)} with {a_rows.numel()} "
          f"set bits, X {tuple(x_dist.shape)} {x_dist.dtype} with "
          f"{int((semiring.widen(x_dist) < semiring.DIST16.inf).sum())} "
          f"finite lanes")
    ok &= record(
        "lane_matmul[min,u16]", "src/repro_torch/kernels/csrc/lane_matmul.cu",
        "src/repro/kernels/bitset_matmul.py:143",
        ops.frontier_step_lanes(a_dist, x_dist, op="min"),
        ref.lane_matmul_ref(a_dist, x_dist, op="min"),
        lambda: ops.frontier_step_lanes(a_dist, x_dist, op="min"),
        lambda: ref.lane_matmul_ref(a_dist, x_dist, op="min"),
        a_dist.numel() * 4 + (int(a_cols.unique().numel())
                              + a_dist.shape[0]) * w_d * lanes_b,
        a_dist.numel() + a_rows.numel() * w_d,
        n_launches=dist_launches.get("lane_matmul", 0))
    rng = np.random.default_rng(2)
    a_sq = bitset.np_to_words(bitset.pack_bits_np(
        rng.random((4096, 4096)) < 1 / 1024), dev)
    sq_rows, sq_cols = ref.set_bits(a_sq)
    a_csr = torch.sparse_coo_tensor(
        torch.stack([sq_rows, sq_cols]),
        torch.ones(sq_rows.numel(), device=dev), (4096, 4096)).to_sparse_csr()
    for op, np_dt, cap in (("sum", np.uint32, semiring.COUNT_CAP),
                           ("or", np.uint8, 0)):
        hi = cap if op == "sum" else 255
        x_np = rng.integers(0, hi + 1, (4096, 128)).astype(np_dt)
        x_sq = torch.from_numpy(x_np.view(
            np.int32 if np_dt == np.uint32 else np.uint8)).to(dev)
        lib = None
        if op == "sum":   # the unsaturated sum: one CSR product in float32
            x_f = semiring.widen(x_sq).to(torch.float32)
            lib = (lambda x_f=x_f: torch.sparse.mm(a_csr, x_f))
        ok &= record(
            f"lane_matmul[{op},u{8 * x_sq.element_size()},4096]",
            "src/repro_torch/kernels/csrc/lane_matmul.cu",
            "src/repro/kernels/bitset_matmul.py:143",
            ops.frontier_step_lanes(a_sq, x_sq, op=op, cap=cap),
            ref.lane_matmul_ref(a_sq, x_sq, op=op, cap=cap),
            lambda x_sq=x_sq, op=op, cap=cap: ops.frontier_step_lanes(
                a_sq, x_sq, op=op, cap=cap),
            lambda x_sq=x_sq, op=op, cap=cap: ref.lane_matmul_ref(
                a_sq, x_sq, op=op, cap=cap),
            a_sq.numel() * 4 + (int(sq_cols.unique().numel()) + 4096)
            * 128 * x_sq.element_size(),
            a_sq.numel() + sq_rows.numel() * 128, lib_fn=lib,
            n_launches=dist_launches.get("lane_matmul", 0))
    ok &= record(
        "popcount_rows", "src/repro_torch/kernels/csrc/popcount.cu",
        "src/repro/kernels/popcount.py:17",
        ops.popcount(h_rows), ref.popcount_rows_ref(h_rows),
        lambda: ops.popcount(h_rows), lambda: ref.popcount_rows_ref(h_rows),
        h_rows.numel() * 4 + h_rows.shape[0] * 4, h_rows.numel() * 2,
        n_launches=aux_launches.get("popcount_rows", 0))
    print_profiled("popcount_rows", lambda: ops.popcount(h_rows))
    b6 = ops.block_sparse_lane_matmul(comp, x_dist, op="min")
    b6_plain = ref.block_sparse_lane_matmul_ref(comp, x_dist, op="min")
    b4_dense = ops.frontier_step_lanes(
        adj, ref.pad_k_lanes(x_dist, kw * 32, "min"), op="min")
    mb6, kb6 = comp.grid
    n_mixed6, n_one6 = comp.n_mixed, comp.one_bj.numel()
    blk_words = comp.br * comp.bw
    bits6 = bitset.popcount(comp.pool[:n_mixed6].reshape(n_mixed6, -1))
    n_bits6 = int(bits6.sum())
    out6_bytes = comp.shape[0] * w_d * lanes_b
    # least bytes: X once, the live lists (offsets and every entry's
    # k-block id), the MIXED pool blocks, the output
    b6_bytes = (x_dist.numel() * lanes_b + 2 * (mb6 + 1) * 4
                + (n_mixed6 + n_one6) * 4 + n_mixed6 * blk_words * 4
                + out6_bytes)
    # the count over the state grid of the earlier kernel's bound, and
    # what an x_any skip of dead k-blocks (no non-INF lane) would drop
    _, xany6 = ref.k_block_lane_summaries(x_dist, kb6, bk, "min", 0)
    live6 = (comp.states != 0) & (xany6 != 0)[None, :]
    n_mixed_live6 = int((live6 & (comp.states == 2)).sum())
    live_k6 = int((xany6 != 0).sum())
    grid6_bytes = (comp.states.numel() + int(live6.sum()) * 4
                   + n_mixed_live6 * blk_words * 4 + kb6 * 4
                   + live_k6 * (1 + bk) * w_d * lanes_b + out6_bytes)
    dead6 = xany6[comp.mix_bj[:n_mixed6].long()] == 0
    b4_err = words_err(torch, b6, b4_dense)
    print(f"block_sparse_lane_matmul: {n_mixed6} MIXED blocks ({n_bits6} "
          f"set bits) and {n_one6} ONE blocks; bound counted over the state "
          f"grid {grid6_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms; {live_k6} of "
          f"{kb6} k-blocks live: an x_any skip would drop "
          f"{int(dead6.sum())} MIXED entries and {int(bits6[dead6].sum())} "
          f"row gathers; max_abs_err against B4 on the decompressed "
          f"matrix {b4_err}")
    ok &= record(
        "block_sparse_lane_matmul[min,u16]",
        "src/repro_torch/kernels/csrc/block_sparse_lane.cu",
        "src/repro/kernels/block_sparse.py:172", b6, b6_plain,
        lambda: ops.block_sparse_lane_matmul(comp, x_dist, op="min"),
        lambda: ref.block_sparse_lane_matmul_ref(comp, x_dist, op="min"),
        b6_bytes, n_bits6 * w_d + n_one6 * comp.br * w_d,
        n_launches=aux_launches.get("block_sparse_lane_matmul", 0),
        err=max(words_err(torch, b6, b6_plain), b4_err))
    n_dev6 = print_profiled(
        "block_sparse_lane_matmul[min,u16]",
        lambda: ops.block_sparse_lane_matmul(comp, x_dist, op="min"))
    print(f"block_sparse_lane_matmul: one call launched {n_dev6} device "
          f"kernel(s)")
    ok &= n_dev6 == (2 if n_one6 else 1)
    del b6, b6_plain, b4_dense, a_csr
    if not ok:
        return fail("a semiring kernel disagrees with its plain version")

    # ---- 6. where the time goes (a second, profiled run) -----------------
    t0 = time.perf_counter()
    tdr_build.dfs_intervals(g)
    t_dfs = time.perf_counter() - t0
    t0 = time.perf_counter()
    engine.pack_adjacency_np(g)
    t_pack = time.perf_counter() - t0
    t0 = time.perf_counter()
    from repro_torch import compressed
    compressed.compress_blocks(engine.pack_adjacency_np(g), nbits=N_VERTICES,
                               device="cpu")
    t_comp = time.perf_counter() - t0 - t_pack
    special = tdr_query.ExactExecutor(idx, eng).special_labels(
        plan_p, np.flatnonzero(plan_p.qid >= 0))
    t0 = time.perf_counter()
    engine.pack_label_class_edges_np(g.src, g.indices, g.labels,
                                     N_VERTICES, special)
    t_cls = time.perf_counter() - t0
    print(f"host pieces: dfs_intervals {t_dfs:.3f} s, pack_adjacency "
          f"{t_pack:.3f} s, compress_blocks {t_comp:.3f} s, one "
          f"label-class stack ({len(special) + 1} classes) {t_cls:.3f} s")
    for what, fn in (
            ("build_index", lambda: tdr_build.build_index(g, cfg)),
            ("answer_batch", lambda: (eng._label_adj.clear(),
                                      tdr_query.answer_batch(
                idx, queries, exact_chunk=EXACT_CHUNK))),
            ("dist_batch", lambda: (eng._label_adj.clear(),
                                    tdr_query.dist_batch(
                idx, dq, exact_chunk=EXACT_CHUNK)))):
        wall, busy, top, _ = profile(torch, fn)
        print(f"profile {what}: wall {wall:.3f} s, device busy {busy:.3f} s "
              f"({100 * (1 - busy / wall):.1f}% idle); top device time: "
              + "; ".join(f"{k} {ms:.1f} ms x{n}" for k, ms, n in top))

    # ---- 7. live index: updates, answers on the new graph, durability ---
    msg = live_index_phase(torch, g, cfg, idx, idx_s, seg_cfg, queries,
                           b3_row, kw)
    if msg:
        return fail(msg)

    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
