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
   ``bitset_matmul`` on the same adjacency; ``class_round`` on the
   operands (each direction's edge lists) of one mid-group round of the
   main path's ``answer_batch`` (its full-graph chunks side by side in
   one lockstep group, 4 subset states) and of ``answer_plan`` with
   ``pin_m=4`` on the same queries (16 states), each recorded by a spy on
   ``ops.class_round``, also against the dense composition it replaced
   on the per-label stacks of the same edges (one ``bitset_matmul`` per
   label and direction and the round's torch ops), whose device and wall
   times are printed beside it, and against the group's chunks launched
   one at a time, both timed.  Times are medians of CUDA
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
   just before and read just after (``lane_matmul`` must have run; the
   lane widths W of its calls are printed), then
   with ``backend="segment"``: equal answers and rounds; 16 answers equal
   the BFS oracle; 4 ``witness`` paths replay through ``verify_witness``
   at the ``dist`` length; 4 ``count_routes`` at ``hops=6`` equal the
   walk-count oracle.  Then ``ops.popcount`` and
   ``ops.block_sparse_lane_matmul``, the entry points of the two kernels
   no query path calls yet, with their own launch counts.
5. ``lane_matmul``, ``popcount_rows`` and ``block_sparse_lane_matmul``
   against their plain versions (tolerance 0): B4 (``lane_rows``) on the
   class matrix and DIST16 plane of one ``dist_batch`` call (``min``), in
   the engine's lane rounds on the full forward adjacency
   (``propagate(sr=COUNT)``, ``sum``/uint32 at W = 128, and a round of
   ``closure(sr=DIST8)`` over 256 sources, ``min``/uint8 at W = 256; both
   rounds on ``matmul`` equal ``segment``'s planes and rounds), and at
   4096 x 4096 for ``sum``/uint32 and ``or``/uint8, each with one device
   kernel a call under ``torch.profiler`` (rows 1-2 also timed on
   an all-zero A, the stream of A alone);
   B5 on ``h_vtx`` as [rows, words];
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
8. Regular path queries on the built index: 128 regexes from
   ``default_rng(3)`` (32 in the lowered fragment ``(la | lb)*``, 64 on
   the product route ``la (lb | lc)* ld`` / ``(la lb)+`` / ``lc+ ld?``,
   16 nullable ``(la lb)*`` at ``u == v``, 16 infeasible
   ``la l16 lb``) through ``rpq_batch`` with the default backend
   (``matmul``) and with ``segment``, at ``exact_mode`` ``auto`` and
   ``full``, launch counts set to 0 just before each matmul run and read
   just after: equal answers everywhere, 24 equal the product-BFS oracle
   (16 from the product route), ``bitset_matmul`` launched; the product
   route alone for its rounds, with a spy recording one NFA-state
   frontier ``[32768, 32]`` and its class matrix, on which B1 is checked
   against its plain version; ``torch.profiler`` for the idle share.
9. Serving: a ``QueryServer`` on the built index (``backend="matmul"``,
   ``ServeConfig()`` defaults), persisted under ``build/``, warmed up on
   ``mixed_pool(g, 256, seed=4)``; 32 closed-loop clients submit 2,048
   requests with ``with_lsn`` (1,536 bool, 192 dist with k = 8, 192
   rpq, 64 witness, 64 count with hops = 6) while phase 7's batch (a)
   goes through ``submit_update`` midway, launch counts set to 0 just
   before the traffic and read just after (B1, B2, B3 and B4 must have
   run).  Every answer equals a direct segment-backend call on the index
   of its LSN (a witness replays at the segment distance);
   ``engine.jit_cache_entries`` does not move after warmup, and no batch
   is unpinned or overflows; ``QueryServer.recover`` onto the card
   equals the live index on every plane.  The count requests are dealt
   first: past 131,072 edges (after the update) ``count_routes`` refuses
   the default cap, by the reference's rule.  A profiled burst of a
   quarter of the mix, without count requests, gives the device's idle
   share.
10. The replicated fleet: the built index as a shared store under
   ``build/`` (``fleet.init_store``, a ``FleetWriter``), three replica
   processes on the card (``Fleet(dir, 3, backend="matmul",
   device="cuda")``, each its own CUDA context, the parent's class
   stacks freed first) behind a ``FleetRouter``, warmed on
   ``mixed_pool(g, 64, seed=6)``.  16 closed-loop clients route 992
   requests (768 bool, 96 dist with k = 8, 96 rpq from phase 8's
   generator, 32 witness; no count: past 131,072 edges ``count_routes``
   refuses the default cap) while the writer publishes phase 7's batch
   (b), (c), (a) and (b) again on the new graph, and the busiest replica
   is SIGKILLed with requests in flight after the second record.  An
   in-process ``QueryServer.follow`` on the card tails the same log,
   with launch counts set to 0 just before its bootstrap and read after
   its tail applies and reads (B1, B2 and B3 must have run, and B4 on
   its 8 dist reads); it answers 8 probes after each record and the 64
   reads (16 rpq) that the router sends at ``min_lsn`` = the tip, which
   must carry the tip or later and equal the follower's.  Every answer
   equals a direct segment call on a layout-pinned segment index of its
   LSN, 32 equal the DFS/BFS oracles, the victim is evicted and a
   replacement reaches ready.  Prints spawn-to-ready and warm seconds,
   requests/s, p50/p99 and first-request latency per kind, the router's
   and the fleet's counters, kill-to-ready seconds, publish-to-replicas
   lag per record from the heartbeats, the follower's ``UpdateStats``
   per record, and the card's free memory around ``Fleet.start``.
11. The vertex-sharded build and answers: three rank processes of this
   script (``--shard-rank R 3 DIR``; ``OMP_NUM_THREADS`` at their share
   of the cores) form a process group through a file store under
   ``build/``: ``nccl`` with one card each when there are three or more,
   else ``gloo`` with all three on ``cuda:0`` (NCCL refuses two ranks on
   one device); 32,768 = 3 x 10,923 - 1, so a padding row takes part.
   Each rank regenerates the smoke graph and the 512 queries from their
   seeds and checks, by sha256 against phase 1: ``build_index(g,
   TDRConfig(), mesh=...)`` on the nine index arrays, ``vtx_words``,
   ``lab_slot`` and ``fixpoint_rounds``; ``distributed_closure`` dense and
   at ``row_budget=1024`` against the single-device engine closure
   (phase 1's ``r_vtx``); ``answer_batch(mesh=...)`` with the default
   backend against phase 1's answers and every ``QueryStats`` counter.
   Then the paper's §VI-A size, ``erdos_renyi(200000, 4.0, 16, seed=0)``,
   built sharded against a single-device ``backend="segment"`` build on
   the card (the parent's), array for array.  Launch counts are set to 0
   before and read after each rank's build and answers; B1 and B2 must
   each have run on some rank.  Prints per rank the build, closure and
   answer seconds, gathers per build with their bytes, the time of one
   dense round's gather, and the card's free memory.  A rank that fails
   or runs past the group's timeout fails the phase; the others are
   killed.
12. The LM substrate (``repro_torch.configs/models/train/data/checkpoint``
   and ``launch/train.py``), which reaches no hand-written kernel (the
   reference's LM path reaches no ``pallas_call``).  (a) Each of the 8
   registry archs, reduced, float32 with TF32 off: forward, one train
   step and prefill plus 3 decode steps on the card against the port on
   the CPU from the same weights and batch (logits within 1e-4 + 1e-4 of
   their size, train-step params within a tenth of lr), and decode
   against the card's forward (5e-3).  (b) phi3-mini-3.8b, the train
   CLI's default arch, at its published widths in bf16 (d_model 3072, 32
   heads, d_ff 8192, vocab 32,064), depth cut to 4 of 32 layers, seq_len
   4,096 (train_4k) and batch 2 (train_4k's is 256), remat on: 3 steps of
   ``train_loop`` with its checkpoint under ``build/``, then 2 timed
   steps (loss finite, every param changed); prefill of 4,080 tokens and
   16 ``decode_step``s, each logit within 0.125 (4 bf16 ulps at the
   largest logits) of ``forward``'s.  Prints ms per step, tokens/s,
   6·N·D FLOP/s as a share of the card's dense bf16 peak (989 TFLOP/s),
   peak memory, checkpoint save seconds and decode ms per token.  (c) A
   reduced ``train_loop`` with ``fail_at_step`` ends with the params of
   an uninterrupted run within 1e-6 (deterministic algorithms on).

13. The LM mesh layer and cost accounting (``repro_torch.models.pspec``,
   ``launch/mesh``, ``launch/sharding``, ``launch/dryrun``,
   ``utils/cost``, ``utils/roofline``), which reaches no hand-written
   kernel either.  (a) phi3-mini-3.8b as in 12 (b), three train steps
   from seed 0's state on the same batch, unmeshed and then under
   ``pspec.use_mesh`` on a 1x1 ``DeviceMesh`` over the card (nccl, world
   1) with the state placed by ``distribute_tree(state_specs(...))``,
   both under deterministic algorithms: losses and params equal within
   12 (c)'s 1e-6 (0 expected); ms per step after the first, tokens/s and
   peak memory of both, DTensor's overhead, phase 12's step beside them.  (b) One meshed
   ``decode_step`` after a 256-token prefill against the unmeshed one
   (within 12's 0.125; 0 expected).  (c) A subprocess runs ``python -m
   repro_torch.launch.dryrun`` for phi3-mini-3.8b x train_4k and x
   decode_32k and for ``tdr-graph`` on the single-pod 16x16 mesh of
   fake ranks on the card: per-rank peak memory, FLOPs, HBM and
   collective bytes, the three H100 roofline terms, ``dominant``, MFU
   and the trace time of each, held to finite, positive counts and a
   train step whose counted FLOPs over 256 ranks are 0.3-1.2 of 6·N·D's
   ratio to them.  With four or more cards, (a) also runs on a 2x2 mesh
   of four nccl rank processes of this script, one card each (a figure,
   not a check).
14. The last of the JAX package's surface: the retained one-directional
   executor and the 2-axis TDR meshes.  (a) ``answer_batch(exact_mode=
   "legacy")`` on phase 1's 512 queries on ``matmul`` (launch counts set
   to 0 just before and read just after; B1 must have run, once per
   label class per round on the full graph's reverse class stack) and
   on ``segment``: answers equal phase 1's and the rounds agree; B1 on
   one legacy frontier ``[32768, 32]`` against its plain version; a
   profiled run for the idle share.  (b) Four rank processes of this
   script (``--tdr2d-rank R 4 DIR``; ``nccl`` with a card each when
   there are four cards, else ``gloo`` on ``cuda:0``) run the 1-D
   ``LoweredClosure`` and the 2-D ``LoweredClosure2D`` of the smoke
   graph's 256-bit seeds at the vtx x word layouts 4x1, 2x2 and 1x4, at
   R = 2 and at phase 1's fixpoint round count; each rank's 2-D block
   equals ``seeds | the 1-D result`` by sha256, and the 1-D result at the
   fixpoint equals phase 1's ``r_vtx``.  Prints per layout the bytes
   gathered per round per rank and the ms per round.  (c) One
   subprocess records the ``tdr-1d``, ``tdr-2d`` and ``tdr-2d-w4`` perf iterations
   (``launch/perf.py``) on 256 fake ranks of the card: their all-gather
   bytes per rank must be exactly 22,658,949,120, 2,832,353,408 and
   5,664,711,168.  ``python3 tools/chip_tdr2d.py`` runs phase 1 and this
   phase alone.

The (c) subprocesses of phases 13 and 14 trace fake ranks on the host and
do no work on the card, so the run starts both first and they run beside
phases 1-13 (one host core each); their phases read and check their
records.  Run alone (``tools/chip_mesh.py``, ``tools/chip_tdr2d.py``), a
phase starts its own beside its (a) and (b).

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
LANE_WIDTH = 128               # B4's propagate(sr=COUNT) row: X [V, 128]
LANE_SOURCES = 256             # B4's closure(sr=DIST8) row: X [V, 256]
COUNT_APART = 9                # rows where propagate(sr=COUNT) on matmul
                               # differs from segment on the smoke graph:
                               # a pair's parallel edges count once there
                               # (ROADMAP C, the reference does the same)
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
INT32_OPS_PER_S = 67e12        # data-sheet non-tensor 32-bit rate
KERNEL_REPS = 20
PLAIN_REPS = 5
CLASS_ROUND_CALL = 5   # call 0 is a group's first meet; 1.. its rounds
SLEEP_CYCLES = 20_000_000      # ~10 ms of device sleep per timed call
PLANES = ("h_vtx", "h_lab", "v_vtx", "v_lab", "n_out", "n_in")
# every array an index stores: the planes and the maintenance state
ALL_PLANES = PLANES + ("push", "pop", "g_count", "base_v", "base_l",
                       "base_r", "r_vtx", "r_lab", "r_in", "d_vtx", "d_lab")
N_INSERTS = 256                # live-index batch (a)
N_RELABELS = 64                # live-index batch (b)
N_DELETES = 64                 # live-index batch (c)
N_RPQ_ORACLE = 24              # rpq answers held to the product-BFS oracle
N_CLIENTS = 32                 # serving phase: closed-loop client threads
SERVE_MIX = (("bool", 1536), ("dist", 192), ("rpq", 192), ("witness", 64),
             ("count", 64))    # serving phase: requests per kind
SERVE_HOPS, SERVE_K = 6, 8
N_REPLICAS = 3                 # fleet phase: replica processes on the card
N_FLEET_CLIENTS = 16           # fleet phase: closed-loop client threads
FLEET_MIX = (("bool", 768), ("dist", 96), ("rpq", 96), ("witness", 32))
N_PINNED, N_PINNED_RPQ = 64, 16    # fleet phase: reads at min_lsn = tip
N_FOLLOWER_DIST = 8            # fleet phase: dist reads of the follower
N_FLEET_ORACLE = 32            # fleet phase: answers held to the oracles
N_RANKS = 3                    # sharded phase: ranks (V = 3 x 10,923 - 1)
SHARD_BUDGET = 1024            # sharded phase: delta-exchange row budget
N_PAPER = 200_000              # sharded phase: the paper's §VI-A V
SHARD_TIMEOUT_S = 420          # sharded phase: process group and wait
LM_ARCH = "phi3-mini-3.8b"      # LM phase: the train CLI's default arch
LM_LAYERS = 4                  # of its 32: the cut depth
LM_SEQ, LM_BATCH = 4096, 2     # train_4k's seq_len; its batch is 256
LM_STEPS, LM_TIMED_STEPS = 3, 2
LM_PREFILL, LM_DECODE = 4080, 16
LM_PREFILL_CHUNK = 1020        # a query chunk that divides the prompt
LM_FP32_TOL = 1e-4             # reduced archs, card against CPU (+ rel.)
LM_BF16_TOL = 0.125            # decode against forward: 4 bf16 ulps at 4-8
BF16_PEAK_FLOPS = 989e12       # H100 SXM dense bf16, data sheet
MESH_PROMPT = 256               # mesh phase (b): prompt before the decode
MESH_STEP_TOL = 1e-6           # mesh phase (a): 12 (c)'s rerun bound
MESH_RANKS = 4                 # mesh phase: 2 x 2 ranks with four cards
DRYRUN_TIMEOUT_S = 600         # mesh phase (c): the dry-run subprocess
TDR2D_RANKS = 4                # 2-D phase: ranks (4 x 8,192 rows)
TDR2D_LAYOUTS = ((4, 1), (2, 2), (1, 4))   # (vtx, word) shards
TDR2D_TIMEOUT_S = 300          # 2-D phase: process group and wait
# 2-D phase (c): each perf iteration's counted gather bytes per rank at
# configs.TDR_GRAPH on 256 fake ranks: (rounds + 1) x v_pad x W/ws x 4
PERF_GATHER_BYTES = {"tdr-1d": 22_658_949_120, "tdr-2d": 2_832_353_408,
                     "tdr-2d-w4": 5_664_711_168}
PERF_TIMEOUT_S = 300           # 2-D phase (c): the perf subprocesses
SHARD_FIELDS = ("n_queries", "n_jobs", "filter_false", "filter_true",
                "exact_jobs", "exact_qids", "plan_lookups", "plan_misses",
                "corridor_active", "corridor_total", "compacted_chunks",
                "full_chunks", "saturated_chunks", "exact_rounds")


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


def profiled_kernels(torch, name: str, fn, want: int | None = None) -> int:
    """Prints the kernel-only device time per launch over KERNEL_REPS
    calls of ``fn``; returns the device kernels one call launched, the
    profiler's count over the calls rounded (it may miss a few events it
    traces, most often the first, and now and then a whole trace).  With
    ``want``, a trace whose count is not ``want`` is taken again, up to
    three traces in all; the caller checks the last one's count."""
    for _ in range(3):
        _, _, top, n_kernels = profile(torch, lambda: [
            fn() for _ in range(KERNEL_REPS)])
        print(f"{name} profiled: " + "; ".join(
            f"{k} {1e3 * ms / n:.4f} us x{n}" for k, ms, n in top))
        per_call = round(n_kernels / KERNEL_REPS)
        if want is None or per_call == want:
            break
    return per_call


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
    from repro_torch.kernels import ops, ref

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
    a_unp_p = ref.unpacked_bf16(adj_p, kw * 32)
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


def make_rpq_queries(rpq, n_vertices: int, n_labels: int, seed: int):
    """128 regexes with uniform random endpoints: 32 in the lowered
    fragment, 64 on the product route, 16 nullable at ``u == v`` and 16
    needing a label no edge carries."""
    rng = np.random.default_rng(seed)

    def labs(k):
        return [int(x) for x in rng.choice(n_labels, size=k, replace=False)]

    def ends():
        return tuple(int(x) for x in rng.integers(0, n_vertices, size=2))

    qs = [ends() + (rpq.parse("(l{} | l{})*".format(*labs(2))),)
          for _ in range(32)]
    product = ("l{} (l{} | l{})* l{}", "(l{} l{})+", "l{}+ l{}?")
    qs += [ends() + (rpq.parse(product[i % 3].format(*labs(4))),)
           for i in range(64)]
    for _ in range(16):
        u = int(rng.integers(n_vertices))
        qs.append((u, u, rpq.parse("(l{} l{})*".format(*labs(2)))))
    qs += [ends() + (rpq.parse("l{} l%d l{}".format(*labs(2)) % n_labels),)
           for _ in range(16)]
    return qs


def rpq_phase(torch, g, idx, record) -> str | None:
    """Phase 8: ``rpq_batch`` on both backends and two exact modes, the
    oracle, the product route's rounds, B1 on one NFA-state frontier.
    Returns a failure message, or None."""
    from repro_torch import bitset, dfs_baseline, rpq, tdr_query
    from repro_torch.kernels import ops, ref
    qs = make_rpq_queries(rpq, g.n_vertices, g.n_labels, seed=3)
    rows = [tdr_query.rpq_rows(idx, r) for _, _, r in qs]
    route = ["lowered" if rw.lowered is not None
             else "nullable" if u == v and rw.nullable
             else "product" if rw.feasible else "infeasible"
             for (u, v, _), rw in zip(qs, rows)]
    print("rpq: routes " + ", ".join(
        f"{k} {route.count(k)}" for k in ("lowered", "product", "nullable",
                                          "infeasible")))
    runs = {}
    for backend in (None, "segment"):
        for mode in ("auto", "full"):
            st = tdr_query.QueryStats()
            torch.cuda.synchronize()
            ops.KERNEL_LAUNCHES.clear()
            t0 = time.perf_counter()
            ans = tdr_query.rpq_batch(idx, qs, backend=backend,
                                      exact_mode=mode,
                                      exact_chunk=EXACT_CHUNK, stats=st)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            name = f"{backend or 'matmul'}/{mode}"
            runs[name] = (ans, st, dict(ops.KERNEL_LAUNCHES), wall)
            print(f"rpq_batch[{name}]: {wall:.3f} s, "
                  f"{len(qs) / wall:.1f} queries/s; {int(ans.sum())} TRUE; "
                  f"phase-2 jobs {st.exact_jobs} (product jobs after the "
                  f"cascade plus lowered), rounds {st.exact_rounds}; "
                  f"launches {runs[name][2]}")
    ans0 = runs["matmul/auto"][0]
    if ans0.shape != (len(qs),) or ans0.dtype != bool:
        return f"rpq answers have shape {ans0.shape} {ans0.dtype}"
    for name, (ans, _, launched, _) in runs.items():
        if not np.array_equal(ans, ans0):
            return f"rpq answers of {name} differ from matmul/auto"
        if name.startswith("matmul") and launched.get("bitset_matmul", 0) \
                <= 0:
            return f"bitset_matmul was not launched by rpq_batch[{name}]"
    prod = [i for i, k in enumerate(route) if k == "product"]
    pick = prod[:16] + [i for i, k in enumerate(route)
                        if k != "product"][::6][:N_RPQ_ORACLE - 16]
    t0 = time.perf_counter()
    for i in pick:
        u, v, r = qs[i]
        if dfs_baseline.answer_rpq(g, u, v, r) != bool(ans0[i]):
            return f"rpq query {i} ({rpq.unparse(r)}) differs from the oracle"
    print(f"rpq oracle: {len(pick)} answers ({len(prod[:16])} from the "
          f"product route) equal the product-BFS oracle "
          f"({time.perf_counter() - t0:.1f} s)")

    # the product route alone: its rounds, and one NFA-state frontier
    step = ops.frontier_step
    seen = {"n": 0}

    def spy(a, x):   # observes one call's operands; computes nothing
        seen["n"] += 1
        if seen["n"] <= SPY_CALL // 2 and bool((a != 0).any()):
            seen["a"], seen["x"] = a, x     # a class that has edges
        return step(a, x)

    st = tdr_query.QueryStats()
    torch.cuda.synchronize()
    ops.frontier_step = spy
    ops.KERNEL_LAUNCHES.clear()
    t0 = time.perf_counter()
    tdr_query.rpq_batch(idx, [qs[i] for i in prod], exact_mode="full",
                        exact_chunk=EXACT_CHUNK, stats=st)
    torch.cuda.synchronize()
    ops.frontier_step = step
    print(f"rpq product route alone (full): {len(prod)} queries, "
          f"{st.exact_jobs} after the cascade, {len(st._round_parts)} "
          f"chunks, rounds {st._round_parts}, "
          f"{time.perf_counter() - t0:.3f} s, launches "
          f"{dict(ops.KERNEL_LAUNCHES)}")
    wall, busy, top, _ = profile(torch, lambda: tdr_query.rpq_batch(
        idx, qs, exact_chunk=EXACT_CHUNK))
    print(f"profile rpq_batch: wall {wall:.3f} s, device busy {busy:.3f} s "
          f"({100 * (1 - busy / wall):.1f}% idle); top device time: "
          + "; ".join(f"{k} {ms:.1f} ms x{n}" for k, ms, n in top))
    if "a" not in seen:
        return "no NFA-state frontier reached bitset_matmul"
    a, x = seen["a"], seen["x"]
    m, kw = a.shape
    x = ref.pad_k(x, kw * 32).contiguous()
    a_bits = int(bitset.popcount(a).sum())
    w = x.shape[1]
    a_unp = ref.unpacked_bf16(a, kw * 32)
    x_unp = ref.unpacked_bf16(x, w * 32)
    print(f"bitset_matmul[rpq]: class matrix {tuple(a.shape)} with {a_bits} "
          f"set bits, NFA-state frontier {tuple(x.shape)} with "
          f"{int((x != 0).sum())} non-zero words (the last class with "
          f"edges in the first {SPY_CALL // 2} of {seen['n']} calls of the "
          f"product run)")
    good = record(
        "bitset_matmul[rpq,W=32]",
        "src/repro_torch/kernels/csrc/bitset_matmul.cu",
        "src/repro/kernels/bitset_matmul.py:45", ops.frontier_step(a, x),
        ref.bitset_matmul_ref(a, x), lambda: ops.frontier_step(a, x),
        lambda: ref.bitset_matmul_ref(a, x), (m * kw + x.numel() + m * w) * 4,
        m * kw + 2 * a_bits * w, lambda: torch.matmul(a_unp, x_unp),
        n_launches=runs["matmul/auto"][2].get("bitset_matmul", 0))
    del a_unp, x_unp
    return None if good else "bitset_matmul disagrees on an RPQ frontier"


def serve_traffic(rpq, serve, g, seed: int, mix: dict):
    """Closed-loop request mix: ``mix[kind]`` (u, v, pattern or regex,
    kind) tuples per kind, the count requests first and the rest
    shuffled.  ``run_clients`` deals them round-robin, so every count
    request is among its client's first: after phase 7's batch (a) the
    graph has 131,317 edges, past the 131,072 at which ``count_routes``
    refuses the default cap (the reference's rule, ``E'·cap < 2^32``)."""
    from repro_torch import pattern
    kind_pool = serve.mixed_pool(g, 4 * max(mix.values()), seed + 1)
    single = [q for q in kind_pool if len(pattern.to_dnf(q[2])) == 1]
    n_w, n_c = mix.get("witness", 0), mix.get("count", 0)
    rq = make_rpq_queries(rpq, g.n_vertices, g.n_labels, seed + 2) + \
        make_rpq_queries(rpq, g.n_vertices, g.n_labels, seed + 3)
    rest = [q + ("bool",) for q in serve.mixed_pool(g, mix["bool"], seed)]
    rest += [q + ("dist",) for q in kind_pool[:mix["dist"]]]
    rest += [q + ("witness",) for q in single[:n_w]]
    rest += [q + ("rpq",) for q in rq[:mix["rpq"]]]
    order = np.random.default_rng(seed + 4).permutation(len(rest))
    return [q + ("count",) for q in single[n_w:n_w + n_c]] + \
        [rest[i] for i in order]


def run_clients(submit, reqs, n_clients=N_CLIENTS, marks=()):
    """``n_clients`` closed-loop threads send ``reqs`` (dealt round-robin)
    through ``submit(u, v, x, kind, **bounds)``, a future of ``(answer,
    lsn)``; each ``(fraction, fn)`` of ``marks`` runs, in order, once that
    fraction of the requests is answered.  Returns the wall time and per
    request ``(answer, lsn, seconds)``; a request that raised holds its
    exception and lsn None."""
    import threading
    out = [None] * len(reqs)
    done = [0]
    cond = threading.Condition()

    def client(ids):
        for i in ids:
            u, v, x, kind = reqs[i]
            kw = {"k": SERVE_K} if kind == "dist" else \
                {"hops": SERVE_HOPS} if kind == "count" else {}
            t = time.perf_counter()
            try:
                ans, lsn = submit(u, v, x, kind, **kw).result(timeout=600)
            except Exception as exc:   # noqa: BLE001 — checked by the caller
                ans, lsn = exc, None
            out[i] = (ans, lsn, time.perf_counter() - t)
            with cond:
                done[0] += 1
                cond.notify_all()

    threads = [threading.Thread(target=client,
                                args=(range(j, len(reqs), n_clients),),
                                daemon=True) for j in range(n_clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for frac, fn in marks:
        with cond:
            cond.wait_for(lambda: done[0] >= frac * len(reqs), 600)
        fn()
    for t in threads:
        t.join(600)
    if any(t.is_alive() for t in threads) or None in out:
        raise RuntimeError("a serving client did not finish")
    return time.perf_counter() - t0, out


def direct_mismatch(ix, lsn, items) -> str | None:
    """Served requests ``(u, v, x, kind, answer)`` of one LSN against
    direct segment-backend calls on ``ix``, the index of that LSN (a
    witness replays on its graph at the segment distance).  Returns a
    message for the first that differs, or None."""
    from repro_torch import dfs_baseline, tdr_query
    by = collections.defaultdict(list)
    for j, it in enumerate(items):
        by[it[3]].append(j)
    want = {}
    for kind, fn in (
            ("bool", lambda q: tdr_query.answer_batch(
                ix, q, backend="segment")),
            ("dist", lambda q: tdr_query.dist_batch(
                ix, q, k=SERVE_K, backend="segment")),
            ("rpq", lambda q: tdr_query.rpq_batch(
                ix, q, backend="segment"))):
        if by[kind]:
            got = fn([items[j][:3] for j in by[kind]])
            want.update(zip(by[kind], got.tolist()))
    for j in by["count"]:
        want[j] = tdr_query.count_routes(
            ix, *items[j][:3], hops=SERVE_HOPS, backend="segment")
    if by["witness"]:
        dw = tdr_query.dist_batch(
            ix, [items[j][:3] for j in by["witness"]], backend="segment")
        for j, d in zip(by["witness"], dw.tolist()):
            path = items[j][4]
            ok = (path is None) if d < 0 else (
                len(path) == d and dfs_baseline.verify_witness(
                    ix.graph, *items[j][:3], path))
            if not ok:
                return (f"witness request {items[j][:2]} at lsn {lsn} is "
                        "wrong")
    for j, w in want.items():
        if items[j][4] != w:
            return (f"{items[j][3]} request {items[j][:2]} at lsn {lsn}: "
                    f"served {items[j][4]}, direct {w}")
    return None


def serve_phase(torch, g, idx) -> str | None:
    """Phase 9: a ``QueryServer`` under closed-loop mixed traffic with an
    update midway; answers against direct segment calls at their LSN,
    nothing materialised after warmup, recovery onto the card.  Returns a
    failure message, or None."""
    import shutil
    import tempfile
    from repro_torch import engine, rpq
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    root = Path(__file__).resolve().parent / "build"
    root.mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="serve_", dir=root)
    srv = serve.QueryServer(idx, backend="matmul")
    try:
        srv.persist_to(tmp)
        srv.start()
        t0 = time.perf_counter()
        n_warm = srv.warmup(serve.mixed_pool(g, 256, seed=4))
        print(f"serve: warmup {time.perf_counter() - t0:.3f} s, "
              f"jit_cache_entries +{n_warm}; pins m={srv._pin_m}, "
              f"{len(srv._special or ())} special labels")
        n0 = engine.jit_cache_entries()
        reqs = serve_traffic(rpq, serve, g, seed=5, mix=dict(SERVE_MIX))
        add, rem = update_batches(np.random.default_rng(2), g)[0][1](g)
        upd = {}

        def update():
            upd["stats"] = srv.submit_update(add, rem, timeout=600)
            upd["index"] = srv.index

        torch.cuda.synchronize()
        ops.KERNEL_LAUNCHES.clear()
        def submit(u, v, x, kind, **kw):
            return srv.submit(u, v, x, kind=kind, with_lsn=True, **kw)

        wall, out = run_clients(submit, reqs, marks=[(0.5, update)])
        torch.cuda.synchronize()
        launched = dict(ops.KERNEL_LAUNCHES)
        moved = engine.jit_cache_entries() - n0
        raised = [(reqs[i][3], o[0]) for i, o in enumerate(out)
                  if o[1] is None]
        if raised:
            return (f"{len(raised)} requests raised, the first a "
                    f"{raised[0][0]}: {raised[0][1]!r}")
        st = srv.stats
        lat = collections.defaultdict(list)
        for (_, _, _, kind), (_, _, sec) in zip(reqs, out):
            lat[kind].append(sec * 1e3)
        print(f"serve: {len(reqs)} requests from {N_CLIENTS} clients in "
              f"{wall:.3f} s = {len(reqs) / wall:.1f} requests/s; mean "
              f"batch {st.mean_batch:.2f} over {st.batches} batches; cache "
              f"hits {st.cache_hits}, dedup hits {st.dedup_hits}; unpinned "
              f"{st.unpinned_batches}, overflow {st.overflow_batches}; "
              f"jit_cache_entries moved {moved} after warmup")
        print("serve latency ms (p50 / p99): " + "; ".join(
            f"{k} {np.percentile(v, 50):.2f} / {np.percentile(v, 99):.2f}"
            for k, v in lat.items()))
        us = upd["stats"]
        print(f"serve: submit_update midway: +{us.n_added} edges, mode "
              f"{us.mode}, tail {us.tail or '-'}, {us.wall_s:.3f} s; "
              f"traffic launches {launched}")
        for kname in ("bitset_matmul", "way_filter", "block_sparse_matmul",
                      "lane_matmul"):
            if launched.get(kname, 0) <= 0:
                return f"{kname} was not launched on the serving path"
        if moved or st.unpinned_batches or st.overflow_batches:
            return (f"serving after warmup materialised {moved}, unpinned "
                    f"{st.unpinned_batches}, overflow {st.overflow_batches}")

        # every answer against a direct segment call at its LSN
        at = {0: idx, 1: upd["index"]}
        t0 = time.perf_counter()
        for lsn, ix in at.items():
            msg = direct_mismatch(ix, lsn, [
                reqs[i] + (o[0],) for i, o in enumerate(out) if o[1] == lsn])
            if msg:
                return msg
        n_at = collections.Counter(o[1] for o in out)
        print(f"serve: every answer equals a direct segment call on the "
              f"index of its LSN ({dict(n_at)} requests per LSN; "
              f"{time.perf_counter() - t0:.1f} s)")
        if sorted(n_at) != [0, 1]:
            return f"requests were served at LSNs {dict(n_at)}, not 0 and 1"

        # the device's idle share over a profiled burst of fresh requests
        burst = serve_traffic(rpq, serve, g, seed=12, mix={
            k: c // 4 for k, c in SERVE_MIX if k != "count"})
        wall_p, busy, top, _ = profile(torch, lambda: run_clients(submit, burst))
        print(f"profile serve burst ({len(burst)} requests): wall "
              f"{wall_p:.3f} s, device busy {busy:.3f} s "
              f"({100 * (1 - busy / wall_p):.1f}% idle); top device time: "
              + "; ".join(f"{k} {ms:.1f} ms x{n}" for k, ms, n in top))
        live = srv.index
        srv.stop()
        srv.close_persistence()
        t0 = time.perf_counter()
        rec = serve.QueryServer.recover(tmp, backend="matmul")
        torch.cuda.synchronize()
        rec_s = time.perf_counter() - t0
        rec.close_persistence()
        bad = [p for p in ALL_PLANES if not torch.equal(
            getattr(rec.index, p), getattr(live, p))]
        print(f"serve: recover onto {rec.index.device} at lsn "
              f"{rec.stats.applied_lsn} in {rec_s:.3f} s; planes differing "
              f"from the live index: {bad}")
        if bad or rec.index.device.type != "cuda" or \
                rec.stats.applied_lsn != 1:
            return f"recovered server differs from the live one: {bad}"
    finally:
        srv.stop(drain=False)
        srv.close_persistence()
        shutil.rmtree(tmp, ignore_errors=True)
    return None


def fleet_phase(torch, g, cfg, idx) -> str | None:
    """Phase 10: a store of the built index, a ``FleetWriter``, three
    replica processes on the card behind a ``FleetRouter``, closed-loop
    traffic with four published records and a replica SIGKILLed, pinned
    reads against an in-process follower on the card, every answer
    against a direct segment call at its LSN.  Returns a failure
    message, or None."""
    import gc
    import os
    import shutil
    import tempfile
    import threading
    from repro_torch import dfs_baseline, engine, rpq, tdr_build
    from repro_torch.kernels import ops
    from repro_torch.launch import fleet, serve
    from repro_torch.launch.router import FleetRouter

    gib = 2.0 ** 30
    # the replicas and the follower are four more CUDA contexts with
    # their own class stacks: give back the parent's first
    for eng in idx._engines.values():
        eng._label_adj.clear()
    gc.collect()   # earlier phases' servers and indexes
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated() / gib
    print(f"fleet: this process holds {held:.2f} GiB of the card before "
          "the fleet starts")
    root = Path(__file__).resolve().parent / "build"
    root.mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="fleet_", dir=root)
    cond = threading.Condition()
    spawned, ready = {}, {}    # replica name -> perf_counter at spawn/ready
    published, lag = {}, {}    # lsn -> perf_counter at publish / lag s
    flt = fleet.Fleet(tmp, N_REPLICAS, backend="matmul", device="cuda",
                      hb_s=0.1, hb_timeout_s=300)
    spawn = flt._spawn_locked

    def spawn_timed():
        r = spawn()
        spawned[r.name] = time.perf_counter()
        return r

    def on_membership():
        """Heartbeats, ready events and deaths: note when each replica
        became ready and when every ready one reached a published LSN."""
        now = time.perf_counter()
        members = flt.members()
        with cond:
            for r in members:
                ready.setdefault(r.name, now)
            for lsn, t in published.items():
                if lsn not in lag and members and \
                        all(r.lsn >= lsn for r in members):
                    lag[lsn] = now - t
            cond.notify_all()

    flt._spawn_locked = spawn_timed
    flt.on_membership = on_membership
    # the replicas share the host's cores with this process: each gets an
    # OpenMP pool of its share (oversubscribed pools spin, not wait)
    omp = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = str(
        max(1, (os.cpu_count() or 1) // (N_REPLICAS + 1)))
    real_update = tdr_build.update_index
    applies = []   # the in-process follower's (UpdateStats, wall s)

    def update_spy(*args, stats=None, **kwargs):
        st = tdr_build.UpdateStats() if stats is None else stats
        t0 = time.perf_counter()
        out = real_update(*args, stats=st, **kwargs)
        torch.cuda.synchronize()
        applies.append((st, time.perf_counter() - t0))
        return out

    writer = fol = None
    stopped = False
    try:
        free0 = torch.cuda.mem_get_info()[0]
        fleet.init_store(idx, tmp)
        writer = fleet.FleetWriter(tmp)
        torch.cuda.empty_cache()   # the index the writer loaded is gone
        graphs = [writer.graph]
        if not np.array_equal(graphs[0].indices, g.indices):
            return "the fleet writer reconstructed another graph"
        t0 = time.perf_counter()
        flt.start(ready_timeout_s=300)
        start_s = time.perf_counter() - t0
        free1 = torch.cuda.mem_get_info()[0]
        router = FleetRouter(flt)
        t0 = time.perf_counter()
        flt.warm(serve.mixed_pool(g, 64, seed=6))
        warm_s = time.perf_counter() - t0
        print(f"fleet: {N_REPLICAS} replicas ready in {start_s:.3f} s "
              f"(spawn to ready: " + ", ".join(
                  f"{n} {ready[n] - spawned[n]:.3f} s" for n in spawned)
              + f"); warm on 64 boolean patterns {warm_s:.3f} s; card "
              f"memory free {free0 / gib:.2f} GiB before Fleet.start, "
              f"{free1 / gib:.2f} GiB after")

        # the in-process follower: bootstrap, tail applies and reads
        tdr_build.update_index = update_spy
        torch.cuda.synchronize()
        ops.KERNEL_LAUNCHES.clear()
        t0 = time.perf_counter()
        fol = serve.QueryServer.follow(tmp, backend="matmul",
                                       device="cuda", poll_s=0.02)
        fol.start()
        boot_s = time.perf_counter() - t0

        reqs = serve_traffic(rpq, serve, g, seed=7, mix=dict(FLEET_MIX))
        batches = update_batches(np.random.default_rng(2), g)
        records = [batches[1], batches[2], batches[0], batches[1]]
        probes = serve.mixed_pool(g, 8, seed=8)
        fol_reads, kill, packs = [], {}, []

        def publish(j):
            def fn():
                add, rem = records[j][1](graphs[-1])
                lsn = writer.publish(add, rem)
                with cond:
                    published[lsn] = time.perf_counter()
                graphs.append(writer.graph)
                if j == 1:   # SIGKILL the busiest replica, mid-stream
                    victim = max(flt.members(), key=lambda r: len(r.pending))
                    kill.update(name=victim.name, inflight=len(
                        victim.pending), names=set(spawned),
                        t=time.perf_counter())
                    victim.kill()
                # the follower answers the probes at this LSN, over the
                # class stacks its tail apply patched or rebuilt
                if not fol.wait_for_lsn(lsn, timeout=600):
                    raise RuntimeError(f"follower stuck below lsn {lsn}")
                n0 = engine.LABEL_CLASS_PACKS["stacks"]
                futs = [fol.submit(*q, with_lsn=True) for q in probes]
                for f in futs:
                    f.result(timeout=600)
                packs.append(engine.LABEL_CLASS_PACKS["stacks"] - n0)
                fol_reads.extend(zip((q + ("bool",) for q in probes), futs))
            return fn

        def submit(u, v, x, kind, **kw):
            return router.submit(u, v, x, kind=kind, **kw)

        marks = [((j + 1) / (len(records) + 1), publish(j))
                 for j in range(len(records))]
        # the card's busy share: the replicas are other processes, which
        # torch.profiler here cannot see; nvidia-smi samples the card
        smi, done = [], threading.Event()

        def sample():
            while not done.wait(1.0):
                r = subprocess.run(
                    ["nvidia-smi", "--query-gpu=utilization.gpu,memory.used",
                     "--format=csv,noheader,nounits"],
                    capture_output=True, text=True)
                if r.returncode == 0:
                    smi.append([int(x) for x in
                                r.stdout.splitlines()[0].split(",")])

        sampler = threading.Thread(target=sample, daemon=True)
        sampler.start()
        try:
            wall, out = run_clients(submit, reqs, N_FLEET_CLIENTS, marks)
        finally:
            done.set()
            sampler.join()
        free2 = torch.cuda.mem_get_info()[0]
        raised = [(reqs[i][3], o[0]) for i, o in enumerate(out)
                  if o[1] is None]
        if raised:
            return (f"{len(raised)} routed requests raised, the first a "
                    f"{raised[0][0]}: {raised[0][1]!r}")
        with cond:
            if not cond.wait_for(lambda: any(
                    n not in kill["names"] for n in ready), 300):
                return "the replacement replica never became ready"
        new = next(n for n in ready if n not in kill["names"])

        # consistent reads at the tip, against the in-process follower
        tip = writer.last_lsn
        pick = {k: [q for q in reqs if q[3] == k] for k, _ in FLEET_MIX}
        pinned = pick["bool"][:N_PINNED - N_PINNED_RPQ] + \
            pick["rpq"][:N_PINNED_RPQ]
        dist_reads = pick["dist"][:N_FOLLOWER_DIST]
        rfuts = [router.submit(u, v, x, kind=kind, min_lsn=tip,
                               lsn_timeout=300,
                               **({"k": SERVE_K} if kind == "dist" else {}))
                 for u, v, x, kind in pinned + dist_reads]
        if not fol.wait_for_lsn(tip, timeout=600):
            return f"the follower never reached lsn {tip}"
        n_b4 = ops.KERNEL_LAUNCHES["lane_matmul"]
        ffuts = [fol.submit(u, v, x, kind=kind, with_lsn=True,
                            **({"k": SERVE_K} if kind == "dist" else {}))
                 for u, v, x, kind in pinned + dist_reads]
        routed = [f.result(timeout=600) for f in rfuts]
        direct = [f.result(timeout=600) for f in ffuts]
        probed = [(q, f.result(timeout=600)) for q, f in fol_reads]
        torch.cuda.synchronize()
        launched = dict(ops.KERNEL_LAUNCHES)
        b4_dist = launched.get("lane_matmul", 0) - n_b4
        tdr_build.update_index = real_update
        n_redirected = router.redirected
        for q, (a, la), (b, lb) in zip(pinned + dist_reads, routed, direct):
            if la < tip or lb < tip:
                return (f"pinned {q[3]} read served at lsn {la} / follower "
                        f"{lb}, below the tip {tip}")
            if a != b:
                return (f"pinned {q[3]} read {q[:2]}: fleet {a}, in-process "
                        f"follower {b}")
        print(f"fleet: {len(pinned)} reads at min_lsn={tip} ({N_PINNED_RPQ} "
              f"rpq) and {len(dist_reads)} dist reads equal the in-process "
              f"follower's; follower bootstrap {boot_s:.3f} s, launches over "
              f"its bootstrap, tail applies and reads {launched}, "
              f"lane_matmul on its dist reads {b4_dist}")
        for kname in ("bitset_matmul", "way_filter", "block_sparse_matmul"):
            if launched.get(kname, 0) <= 0:
                return f"{kname} was not launched by the in-process follower"
        if b4_dist <= 0:
            return "lane_matmul was not launched on the follower's dist reads"

        # membership, latency and lag
        lat = collections.defaultdict(list)
        first = {}
        for (_, _, _, kind), (_, _, sec) in zip(reqs, out):
            lat[kind].append(sec * 1e3)
            first.setdefault(kind, sec * 1e3)
        print(f"fleet: {len(reqs)} routed requests from {N_FLEET_CLIENTS} "
              f"clients in {wall:.3f} s = {len(reqs) / wall:.1f} requests/s;"
              f" card memory free {free2 / gib:.2f} GiB after the stream; "
              f"nvidia-smi over the stream ({len(smi)} samples, 1 s apart): "
              + (f"utilization mean {np.mean([u for u, _ in smi]):.1f}%, "
                 f"memory used peak {max(m for _, m in smi)} MiB" if smi
                 else "not measured"))
        print("fleet latency ms (p50 / p99; first request): " + "; ".join(
            f"{k} {np.percentile(v, 50):.2f} / {np.percentile(v, 99):.2f}; "
            f"{first[k]:.2f}" for k, v in lat.items()))
        print(f"fleet: redispatched {router.redispatched}, redirected "
              f"{n_redirected}, evictions {flt.evictions}, respawns "
              f"{flt.respawns}; SIGKILL of {kill['name']} with "
              f"{kill['inflight']} requests in flight, {new} ready "
              f"{ready[new] - kill['t']:.3f} s after the kill (spawn to "
              f"ready {ready[new] - spawned[new]:.3f} s)")
        print("fleet: publish to every ready replica at the LSN (from the "
              "heartbeats): " + ", ".join(
                  f"lsn {k} ({records[k - 1][0]}) {v * 1e3:.1f} ms"
                  for k, v in sorted(lag.items())))
        print("fleet: in-process follower's update_index per record: "
              + "; ".join(f"{name}: mode {st.mode}, tail {st.tail or '-'}, "
                          f"{sec:.3f} s, class stacks its 8 probes packed "
                          f"after it {n}" for (name, _), (st, sec), n in zip(
                              records, applies, packs)))
        if flt.evictions < 1 or flt.respawns < 1:
            return (f"evictions {flt.evictions}, respawns {flt.respawns}: "
                    "the SIGKILLed replica was not replaced")
        if kill["inflight"] < 1:
            return "the SIGKILLed replica had no request in flight"
        if len(applies) != len(records):
            return (f"the follower applied {len(applies)} records, not "
                    f"{len(records)}")
        # the card back for the checks: the follower and the replicas go
        fol.stop(drain=False)
        fol = None
        flt.stop()
        stopped = True
        torch.cuda.empty_cache()
        free3 = torch.cuda.mem_get_info()[0]
        print(f"fleet: card memory free {free3 / gib:.2f} GiB after the "
              "fleet and the follower stopped")

        # every answer against a direct segment call at its LSN
        items = collections.defaultdict(list)
        for q, (a, lsn, _) in zip(reqs, out):
            items[lsn].append(q + (a,))
        for q, (a, lsn) in zip(pinned + dist_reads, routed + direct):
            items[lsn].append(q + (a,))
        for q, (a, lsn) in probed:
            items[lsn].append(q + (a,))
        t0 = time.perf_counter()
        for lsn in sorted(items):
            ix = idx if lsn == 0 else tdr_build.build_index(
                graphs[lsn], cfg, layout=idx.disc, backend="segment")
            msg = direct_mismatch(ix, lsn, items[lsn])
            if msg:
                return "fleet: " + msg
            del ix
            torch.cuda.empty_cache()
        print(f"fleet: every answer (routed, pinned, follower) equals a "
              f"direct segment call on the index of its LSN (" + ", ".join(
                  f"lsn {k}: {len(v)}" for k, v in sorted(items.items()))
              + f"; {time.perf_counter() - t0:.1f} s)")
        if len(items) < 3:
            return f"answers came from LSNs {sorted(items)} only"

        # a sample against the DFS/BFS oracles on the graph of its LSN
        flat = [(it, lsn) for lsn in sorted(items) for it in items[lsn]]
        share = {"bool": 16, "dist": 8, "rpq": 4, "witness": 4}
        sample = []
        for kind, n in share.items():
            of = [f for f in flat if f[0][3] == kind]
            sample += of[::max(1, len(of) // n)][:n]
        for (u, v, x, kind, ans), lsn in sample:
            gl = graphs[lsn]
            if kind == "bool":
                ok = ans == dfs_baseline.answer_pcr(gl, u, v, x)
            elif kind == "rpq":
                ok = ans == dfs_baseline.answer_rpq(gl, u, v, x)
            else:
                d = dfs_baseline.shortest_pcr(gl, u, v, x)
                if kind == "dist":
                    ok = ans == (d if 0 <= d <= SERVE_K else -1)
                else:
                    ok = (ans is None) if d < 0 else (
                        len(ans) == d and dfs_baseline.verify_witness(
                            gl, u, v, x, ans))
            if not ok:
                return (f"fleet: {kind} request {(u, v)} at lsn {lsn} "
                        f"differs from the oracle: served {ans}")
        print(f"fleet oracle: {len(sample)} answers ("
              + ", ".join(f"{n} {k}" for k, n in share.items())
              + ") equal the DFS/BFS oracles at their LSNs")
        if len(sample) != N_FLEET_ORACLE:
            return f"the oracle sample holds {len(sample)} answers"
    finally:
        tdr_build.update_index = real_update
        if omp is None:
            os.environ.pop("OMP_NUM_THREADS", None)
        else:
            os.environ["OMP_NUM_THREADS"] = omp
        if fol is not None:
            fol.stop(drain=False)
        if not stopped:
            flt.stop()
        if writer is not None:
            writer.close()
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
    return None


def digest(a) -> str:
    """sha256 of a tensor's or an array's bytes."""
    import hashlib
    a = a.cpu().numpy() if hasattr(a, "cpu") else np.asarray(a)
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def index_digests(idx) -> dict:
    """``digest`` of each index array, ``vtx_words`` and ``lab_slot``."""
    return {f: digest(getattr(idx, f)) for f in PLANES + (
        "push", "pop", "g_count", "vtx_words", "lab_slot")}


def shard_rank(rank: int, world: int, tmp: str) -> int:
    """One rank of phase 11 (``chip_smoke.py --shard-rank R N DIR``):
    joins the group through a file store in ``DIR``, builds, closes and
    answers sharded, checks each result against the parent's digests, and
    prints one JSON line of its figures.  Exits non-zero on a mismatch."""
    import datetime
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch import (bitset, distributed, engine, graph, pattern,
                             tdr_build, tdr_query)
    from repro_torch.kernels import ops

    spec = json.loads((Path(tmp) / "spec.json").read_text())
    dev = torch.device(spec["devices"][rank])
    torch.cuda.set_device(dev)
    dist.init_process_group(
        spec["backend"], store=dist.FileStore(str(Path(tmp) / "store"),
                                              world),
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=SHARD_TIMEOUT_S))
    mesh = distributed.ShardMesh(device=dev)
    gathers = []
    gather = engine.all_gather_words

    def spy(x, m):   # counts the exchange; computes nothing
        gathers.append(x.numel() * x.element_size() * m.size)
        return gather(x, m)

    engine.all_gather_words = spy   # for the life of this process
    cfg = tdr_build.TDRConfig()
    bad = []
    out = {"rank": rank, "device": str(dev)}

    def sync_time(fn):
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    g = graph.erdos_renyi(N_VERTICES, AVG_DEGREE, N_LABELS, seed=0)
    queries = make_queries(pattern, g.n_vertices, g.n_labels)
    ops.KERNEL_LAUNCHES.clear()
    gathers.clear()
    sidx, out["build_s"] = sync_time(
        lambda: tdr_build.build_index(g, cfg, mesh=mesh))
    out["build_launches"] = dict(ops.KERNEL_LAUNCHES)
    out["build_gathers"] = len(gathers)
    out["build_gather_bytes"] = sum(gathers)
    digests = index_digests(sidx)
    bad += [f"smoke index {f}" for f, h in digests.items()
            if h != spec["smoke"][f]]
    if sidx.fixpoint_rounds != spec["smoke_rounds"]:
        bad.append(f"fixpoint_rounds {sidx.fixpoint_rounds}")
    for budget in (None, SHARD_BUDGET):
        r, sec = sync_time(lambda: distributed.distributed_closure(
            g, sidx.vtx_words, mesh, row_budget=budget))
        out[f"closure_s[{budget}]"] = sec
        if digest(r) != spec["closure"]:
            bad.append(f"distributed_closure at row_budget={budget}")
        del r

    st = tdr_query.QueryStats()
    ops.KERNEL_LAUNCHES.clear()
    ans, out["answer_s"] = sync_time(lambda: tdr_query.answer_batch(
        sidx, queries, mesh=mesh, exact_chunk=EXACT_CHUNK, stats=st))
    out["answer_launches"] = dict(ops.KERNEL_LAUNCHES)
    if ans.tolist() != spec["answers"]:
        bad.append("answers")
    got = {f: getattr(st, f) for f in SHARD_FIELDS}
    bad += [f"QueryStats.{f} {got[f]} != {v}"
            for f, v in spec["stats"].items() if got[f] != v]
    out["compacted_chunks"] = st.compacted_chunks
    del sidx            # and rank 0's class stacks with its engine
    torch.cuda.empty_cache()

    # one dense round's exchange at the smoke size, alone
    per = -(-N_VERTICES // world)
    blk = torch.zeros((per, bitset.n_words(cfg.vtx_bits)),
                      dtype=torch.int32, device=dev)
    for _ in range(3):
        gather(blk, mesh)
    _, sec = sync_time(lambda: [gather(blk, mesh) for _ in range(20)])
    out["gather_ms"] = sec / 20 * 1e3
    out["gather_bytes"] = blk.numel() * 4 * world

    g2 = graph.erdos_renyi(N_PAPER, AVG_DEGREE, N_LABELS, seed=0)
    gathers.clear()
    idx2, out["paper_build_s"] = sync_time(
        lambda: tdr_build.build_index(g2, cfg, mesh=mesh))
    out["paper_gathers"] = len(gathers)
    out["paper_gather_bytes"] = sum(gathers)
    bad += [f"V={N_PAPER} index {f}"
            for f, h in index_digests(idx2).items()
            if h != spec["paper"][f]]
    if idx2.fixpoint_rounds != spec["paper_rounds"]:
        bad.append(f"V={N_PAPER} fixpoint_rounds "
                   f"{idx2.fixpoint_rounds}")
    out["free_gib"] = torch.cuda.mem_get_info(dev)[0] / 2.0 ** 30
    dist.barrier()
    out["bad"] = bad
    print(json.dumps(out), flush=True)
    dist.destroy_process_group()
    return 1 if bad else 0


def rank_devices(torch, n: int = N_RANKS) -> tuple[str, list[str]]:
    """The backend and each rank's device for ``n`` rank processes:
    ``nccl`` with a card per rank when there are enough cards, else
    ``gloo`` on ``cuda:0`` (NCCL refuses two ranks on one device)."""
    if torch.cuda.device_count() >= n:
        return "nccl", [f"cuda:{r}" for r in range(n)]
    return "gloo", ["cuda:0"] * n


def rank_command(rank: int, tmp: str) -> list[str]:
    """The command line of one phase-11 rank: this script again."""
    return [sys.executable, str(Path(__file__).resolve()), "--shard-rank",
            str(rank), str(N_RANKS), tmp]


def shard_phase(torch, cfg, idx, answers, stats) -> str | None:
    """Phase 11: the smoke graph and the paper's V = 200,000 built
    vertex-sharded by ``N_RANKS`` rank processes of this script (one card
    each on nccl with enough cards, else all on ``cuda:0`` on gloo), the
    closure dense and at a row budget, and the 512 queries answered
    sharded; every result against phase 1 and a single-device segment
    build by digest.  Returns a failure message, or None."""
    import gc
    import os
    import shutil
    import tempfile
    from repro_torch import graph, tdr_build

    backend, devices = rank_devices(torch)
    print(f"shard: {N_RANKS} ranks on {backend}, devices {devices} ("
          + ("one card each" if backend == "nccl" else "one card shared: "
             "NCCL refuses two ranks on one device") + ")")
    spec = {"backend": backend, "devices": devices,
            "smoke": index_digests(idx),
            "smoke_rounds": idx.fixpoint_rounds,
            # the single-device engine closure of the vertex seeds
            "closure": digest(idx.r_vtx),
            "answers": answers.tolist(),
            "stats": {f: getattr(stats, f) for f in SHARD_FIELDS}}
    g2 = graph.erdos_renyi(N_PAPER, AVG_DEGREE, N_LABELS, seed=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    idx2 = tdr_build.build_index(g2, cfg, backend="segment")
    torch.cuda.synchronize()
    single_s = time.perf_counter() - t0
    spec["paper"] = index_digests(idx2)
    spec["paper_rounds"] = idx2.fixpoint_rounds
    print(f"shard: single-device segment build at V={N_PAPER} "
          f"(E={g2.n_edges}): {single_s:.3f} s, fixpoint_rounds="
          f"{idx2.fixpoint_rounds}")
    del idx2, g2
    for eng in idx._engines.values():
        eng._label_adj.clear()
    gc.collect()
    torch.cuda.empty_cache()
    gib = 2.0 ** 30
    free0 = torch.cuda.mem_get_info()[0] / gib
    root = Path(__file__).resolve().parent / "build"
    root.mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="shard_", dir=root)
    procs = []
    try:
        (Path(tmp) / "spec.json").write_text(json.dumps(spec))
        env = dict(os.environ, OMP_NUM_THREADS=str(
            max(1, (os.cpu_count() or 1) // (N_RANKS + 1))))
        t0 = time.perf_counter()
        procs = [subprocess.Popen(rank_command(r, tmp), env=env,
                                  stdout=subprocess.PIPE, text=True)
                 for r in range(N_RANKS)]
        deadline = time.monotonic() + SHARD_TIMEOUT_S
        while True:   # until every rank exits, or one fails
            codes = [p.poll() for p in procs]
            if None not in codes or any(c not in (None, 0) for c in codes):
                break
            if time.monotonic() > deadline:
                return f"a rank ran past {SHARD_TIMEOUT_S} s"
            time.sleep(0.2)
        wall = time.perf_counter() - t0
        failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
        if failed:   # the ranks still running wait on it: killed below
            r = failed[0]
            lines = procs[r].stdout.read().strip().splitlines()
            why = json.loads(lines[-1])["bad"] if lines else "no report"
            return f"rank {r} exited {codes[r]}: {why}"
        reports = [json.loads(p.stdout.read().strip().splitlines()[-1])
                   for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    for rep in reports:
        print(f"shard rank {rep['rank']} ({rep['device']}): build "
              f"{rep['build_s']:.3f} s ({rep['build_gathers']} gathers, "
              f"{rep['build_gather_bytes'] / 2**20:.1f} MiB), closure dense "
              f"{rep['closure_s[None]']:.3f} s / row_budget={SHARD_BUDGET} "
              f"{rep[f'closure_s[{SHARD_BUDGET}]']:.3f} s, answer_batch "
              f"{rep['answer_s']:.3f} s ({rep['compacted_chunks']} compacted "
              f"chunks; launches {rep['answer_launches']}; build launches "
              f"{rep['build_launches']}); V={N_PAPER} build "
              f"{rep['paper_build_s']:.3f} s ({rep['paper_gathers']} "
              f"gathers, {rep['paper_gather_bytes'] / 2**20:.1f} MiB); one "
              f"[{-(-N_VERTICES // N_RANKS)}, 8] gather "
              f"{rep['gather_bytes']} bytes {rep['gather_ms']:.4f} ms; card "
              f"memory free {rep['free_gib']:.2f} GiB")
    print(f"shard: {N_RANKS} ranks in {wall:.3f} s wall (spawn to exit); "
          f"card memory free {free0:.2f} GiB before the spawn; every rank's "
          f"index, closure (dense and row_budget={SHARD_BUDGET}), answers "
          f"and QueryStats equal phase 1's, and its V={N_PAPER} index the "
          f"single-device segment build's")
    for kname in ("class_round", "way_filter"):
        if sum(rep["answer_launches"].get(kname, 0) for rep in reports) <= 0:
            return f"{kname} was not launched by a rank's sharded answers"
    return None


def lm_phase(torch, figures: dict | None = None) -> str | None:
    """Phase 12: the LM substrate, reduced archs and phi3-mini-3.8b at
    full width (module docstring, item 12); ``figures`` receives the
    timed step's ms, tokens/s and peak GiB."""
    import dataclasses
    import shutil
    import tempfile
    from repro_torch import bitset, configs, pytree
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.data import DataConfig, batch_for_step
    from repro_torch.launch import train as train_cli
    from repro_torch.models import decode_step, forward, init_params, prefill
    from repro_torch.train import (AdamWConfig, init_train_state,
                                   make_train_step)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = bitset.resolve_device("cuda")

    def err(a, b):
        """max |a - b| (on the host)."""
        return float((a.detach().float().cpu()
                      - b.detach().float().cpu()).abs().max())

    def close(a, b):
        return torch.allclose(a.detach().float().cpu(),
                              b.detach().float().cpu(), rtol=LM_FP32_TOL,
                              atol=LM_FP32_TOL)

    # (a) every arch, reduced, float32: the card against the CPU
    s0, s = 37, 40
    for arch in configs.list_archs():
        cfg = configs.get(arch).reduced()
        params = init_params(cfg, 0, device="cpu")
        rng = np.random.default_rng(0)
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, s)))
        media = (torch.from_numpy(rng.standard_normal(
            (2, cfg.n_media_tokens, cfg.d_model)).astype(np.float32))
            if cfg.n_media_tokens else None)
        out = {}
        for name, d in (("cpu", "cpu"), ("card", card)):
            p = pytree.tree_map(lambda t: t.to(d), params)
            batch = {"tokens": toks.to(d)}
            if media is not None:
                batch["media"] = media.to(d)
            logits, aux, _ = forward(cfg, p, batch["tokens"],
                                     batch.get("media"))
            state, m = make_train_step(cfg, AdamWConfig(lr=1e-3))(
                init_train_state(cfg, p, device=d), batch)
            last, cache = prefill(cfg, p, batch["tokens"][:, :s0],
                                  batch.get("media"), max_len=s)
            dec = [last]
            for t in range(s0, s):
                lg, cache = decode_step(cfg, p, cache, batch["tokens"][:, t])
                dec.append(lg)
            out[name] = (logits, aux, m["loss"], state["params"], dec)
        (lh, ah, los_h, ph, dh), (ld, ad, los_d, pd, dd) = (out["cpu"],
                                                           out["card"])
        e_step = max(err(a, b) for a, b in zip(pytree.leaves(pd),
                                               pytree.leaves(ph)))
        e_df = max(err(dd[i], ld[:, s0 - 1 + i]) for i in range(len(dd)))
        e_loss = abs(float(los_d) - float(los_h))
        ok = (close(ld, lh) and all(close(a, b) for a, b in zip(dd, dh))
              and e_step <= 1e-4 and e_df <= 5e-3 and e_loss <= 1e-4
              and bool(torch.isfinite(ld).all()))
        print(f"LM (a) {arch} reduced fp32, card vs CPU: logits "
              f"{err(ld, lh):.2e}, aux {abs(float(ad) - float(ah)):.2e}, "
              f"loss {e_loss:.2e}, train-step params {e_step:.2e}, decode "
              f"{max(err(a, b) for a, b in zip(dd, dh)):.2e}; card decode "
              f"vs forward {e_df:.2e}")
        if not ok:
            return f"LM phase (a): {arch} on the card disagrees with the CPU"

    # (b) phi3-mini-3.8b at its published widths, depth cut
    cfg = dataclasses.replace(configs.get(LM_ARCH), n_layers=LM_LAYERS)
    n_params = cfg.n_params()
    print(f"LM (b) cuts: {LM_ARCH} depth {LM_LAYERS} of 32 layers, seq_len "
          f"{LM_SEQ} (train_4k), batch {LM_BATCH} (train_4k's is 256); "
          f"widths as published (d_model {cfg.d_model}, {cfg.n_heads} "
          f"heads, d_ff {cfg.d_ff}, vocab {cfg.vocab}), {cfg.dtype}, random "
          f"weights from seed 0, remat on; N = {n_params:,} params")
    dc = DataConfig(task="lm", vocab=cfg.vocab, seq_len=LM_SEQ,
                    global_batch=LM_BATCH)
    opt = AdamWConfig()
    root = Path(__file__).resolve().parent / "build"
    root.mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="lm_", dir=root)
    try:
        ck = Checkpointer(tmp, keep=1)
        saves = []
        save = ck.save

        def timed_save(step, st):
            t = time.perf_counter()
            save(step, st)
            saves.append(time.perf_counter() - t)
        ck.save = timed_save
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state = train_cli.train_loop(cfg, dc, opt, LM_STEPS, ck,
                                     log_every=1, remat=True)
        torch.cuda.synchronize()
        loop_s = time.perf_counter() - t0
        with open(Path(tmp) / f"step_{LM_STEPS}" / "manifest.json") as f:
            n_saved = len(json.load(f)["arrays"])
        init = init_params(cfg, 0)
        unchanged = [n for (n, a), b in zip(
            pytree.leaves_with_paths(init), pytree.leaves(state["params"]))
            if torch.equal(a, b)]
        del init
        step_fn = make_train_step(cfg, opt, remat=True)
        batch = batch_for_step(dc, LM_STEPS)
        times, losses = [], []
        for _ in range(LM_TIMED_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step_fn(state, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(float(m["loss"]))
        peak = torch.cuda.max_memory_allocated()
        step_s = float(np.median(times))
        if figures is not None:
            figures.update(step_ms=step_s * 1e3,
                           tokens_s=LM_BATCH * LM_SEQ / step_s,
                           peak_gib=peak / 2**30)
        tokens = LM_BATCH * LM_SEQ
        flops = 6 * n_params * tokens / step_s
        print(f"LM (b) train_loop {LM_STEPS} steps + checkpoint: "
              f"{loop_s:.3f} s (save {saves[0]:.3f} s, {n_saved} arrays); "
              f"timed steps {', '.join(f'{t * 1e3:.1f}' for t in times)} "
              f"ms, loss {', '.join(f'{x:.4f}' for x in losses)}")
        print(f"LM (b) {step_s * 1e3:.1f} ms per step, "
              f"{tokens / step_s:.1f} tokens/s, 6·N·D = "
              f"{flops / 1e12:.1f} TFLOP/s = {100 * flops / BF16_PEAK_FLOPS:.1f}"
              f"% of the bf16 dense peak; peak memory "
              f"{peak / 2**30:.2f} GiB")
        if unchanged or not all(np.isfinite(losses)):
            return (f"LM phase (b): losses {losses}, params unchanged by "
                    f"training: {unchanged}")
        held = []
        wall, busy, top, n_k = profile(
            torch, lambda: held.append(step_fn(state, batch)))
        print(f"LM (b) profile of one train step: wall {wall * 1e3:.1f} ms, "
              f"device busy {busy * 1e3:.1f} ms "
              f"({100 * (1 - busy / wall):.1f}% idle), {n_k} device "
              f"kernels; top device time: "
              + "; ".join(f"{k} {ms:.1f} ms x{n}" for k, ms, n in top))
        params = held[0][0]["params"]
        del state, m, held

        toks = batch_for_step(dc, LM_STEPS + 1)["tokens"]
        with torch.no_grad():
            full, _, _ = forward(cfg, params, toks)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        last, cache = prefill(cfg, params, toks[:, :LM_PREFILL],
                              max_len=LM_SEQ, q_chunk=LM_PREFILL_CHUNK)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        errs = [err(last, full[:, LM_PREFILL - 1])]
        dts = []
        for t in range(LM_PREFILL, LM_PREFILL + LM_DECODE - 1):
            t0 = time.perf_counter()
            lg, cache = decode_step(cfg, params, cache, toks[:, t])
            torch.cuda.synchronize()
            dts.append(time.perf_counter() - t0)
            errs.append(err(lg, full[:, t]))
        held = []
        t = LM_PREFILL + LM_DECODE - 1          # the last step, profiled
        wall, busy, top, n_k = profile(torch, lambda: held.append(
            decode_step(cfg, params, cache, toks[:, t])))
        errs.append(err(held[0][0], full[:, t]))
        decode_profile = (
              f"LM (b) profile of one decode step: wall {wall * 1e3:.2f} "
              f"ms, device busy {busy * 1e3:.2f} ms "
              f"({100 * (1 - busy / wall):.1f}% idle), {n_k} device "
              f"kernels; top device time: "
              + "; ".join(f"{k} {ms:.2f} ms x{n}" for k, ms, n in top))
        print(f"LM (b) prefill {LM_PREFILL} tokens x {LM_BATCH}: "
              f"{prefill_s * 1e3:.1f} ms; decode {LM_DECODE} steps (the "
              f"last profiled, untimed): median "
              f"{np.median(dts) * 1e3:.2f} ms per token (batch {LM_BATCH}), "
              f"first {dts[0] * 1e3:.2f} ms; |decode - forward| max "
              f"{max(errs):.4f} (bound {LM_BF16_TOL}), mean over steps "
              f"{np.mean(errs):.4f}; logits |max| "
              f"{float(full.abs().max()):.3f}")
        print(decode_profile)
        if max(errs) > LM_BF16_TOL or not bool(torch.isfinite(full).all()):
            return f"LM phase (b): decode drifts from forward by {errs}"
        del params, cache, full, held

        # (c) restart: an injected failure ends on the uninterrupted params
        cfg = configs.get(LM_ARCH).reduced()
        dc = DataConfig(task="copy", vocab=cfg.vocab, seq_len=32,
                        global_batch=8)
        opt = AdamWConfig(lr=1e-3)
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            with warnings.catch_warnings():
                warnings.filterwarnings("ignore", ".*deterministic.*")
                kw = dict(ckpt_every=4, log_every=100)
                ref = train_cli.train_loop(cfg, dc, opt, 8, Checkpointer(
                    str(Path(tmp) / "ref")), **kw)
                got = train_cli.train_loop(cfg, dc, opt, 8, Checkpointer(
                    str(Path(tmp) / "restart"), async_save=True),
                    fail_at_step=6, **kw)
        finally:
            torch.use_deterministic_algorithms(False)
        e = max(err(a, b) for a, b in zip(pytree.leaves(ref["params"]),
                                          pytree.leaves(got["params"])))
        print(f"LM (c) restart: fail_at_step=6, restored from step 4, params "
              f"vs uninterrupted {e:.2e} (bound 1e-6)")
        if e > 1e-6:
            return f"LM phase (c): restarted params differ by {e}"
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return None


def _lm_cut():
    """Phase 12's phi3-mini-3.8b: published widths, depth cut."""
    import dataclasses
    from repro_torch import configs
    return dataclasses.replace(configs.get(LM_ARCH), n_layers=LM_LAYERS)


def card_mesh(torch, data: int, model: int):
    """A ``("data", "model")`` ``DeviceMesh`` over the cards of the
    default process group."""
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh("cuda", torch.arange(data * model).reshape(
        data, model), mesh_dim_names=("data", "model"))


def _timed_steps(torch, step_fn, state, batch, n: int):
    """``n`` steps of ``step_fn``: (state, losses, seconds, peak bytes)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        loss = m["loss"]
        loss = loss.full_tensor() if hasattr(loss, "full_tensor") else loss
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
    return state, losses, times, torch.cuda.max_memory_allocated()


class Background:
    """A host-only subprocess (fake ranks, no card work) that a phase
    starts, or that the smoke run starts early so that it runs beside the
    phases before the one that reads it.  Its output goes to ``out``, its
    log to ``log``; ``close`` stops it if it still runs."""

    def __init__(self, cmd: list[str], out: Path, log: Path):
        import os
        root = Path(__file__).resolve().parent
        (root / "build").mkdir(exist_ok=True)
        self.out, self.log = out, log
        out.unlink(missing_ok=True)   # a perf record merges into a file
        self._log_f = open(log, "w")
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            cmd, cwd=root, stdout=self._log_f, stderr=subprocess.STDOUT,
            env=dict(os.environ, PYTHONPATH=str(root / "src"),
                     OMP_NUM_THREADS="1"))

    def wait(self, timeout: float, what: str) -> str | None:
        """Wait for the process; a failure message, or None."""
        try:
            self.proc.wait(timeout=max(
                1.0, timeout - (time.perf_counter() - self.t0)))
        except subprocess.TimeoutExpired:
            return f"{what} ran past {timeout} s"
        if self.proc.returncode:
            return f"{what} failed: " + "\n".join(
                self.log.read_text().strip().splitlines()[-8:])
        return None

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()
        self._log_f.close()


def start_dryrun() -> Background:
    """Phase 13 (c)'s dry-run subprocess."""
    build = Path(__file__).resolve().parent / "build"
    out = build / "dryrun_smoke.json"
    return Background(dryrun_command(out), out, build / "dryrun_smoke.log")


def start_perf() -> Background:
    """Phase 14 (c)'s perf subprocess."""
    build = Path(__file__).resolve().parent / "build"
    out = build / "perf_tdr.json"
    return Background(perf_command(out), out, build / "perf_tdr.log")


def dryrun_command(out: Path) -> list[str]:
    """Phase 13 (c): the port's dry-run of the named cells on 256 fake
    ranks of the card."""
    return [sys.executable, "-m", "repro_torch.launch.dryrun",
            "--arch", f"{LM_ARCH},tdr-graph", "--shape",
            "train_4k,decode_32k", "--mesh", "single", "--out", str(out)]


def check_dryrun(records: list) -> str | None:
    """Phase 13 (c)'s checks on the dry-run's records; prints each."""
    want = {(LM_ARCH, "train_4k"), (LM_ARCH, "decode_32k"), ("tdr-graph",)}
    got = set()
    for r in records:
        h, ro, m = r["hlo"], r["roofline"], r["memory"]
        key = (r["arch"],) if r["arch"] == "tdr-graph" else (r["arch"],
                                                            r["shape"])
        got.add(key)
        print(f"mesh (c) dry-run {r['arch']} x {r['shape']} on "
              f"{r['chips']} fake ranks of the card: per rank peak "
              f"{m['peak_gb'] * 1e9 / 2**30:.2f} GiB, "
              f"{h['flops_per_chip']:.4e} FLOP, "
              f"{h['hbm_bytes_per_chip']:.4e} HBM B, "
              f"{h['collective_bytes_per_chip']:.4e} collective B "
              f"{dict(h['collectives'])}; roofline compute "
              f"{ro['compute_s']:.6f} s, memory {ro['memory_s']:.6f} s, "
              f"collective {ro['collective_s']:.6f} s, dominant "
              f"{ro['dominant']}, MFU {ro['mfu']:.4f}, MODEL_FLOPS ratio "
              f"{ro['model_flops_ratio']:.3f}; inputs {r['lower_s']} s, "
              f"trace {r['compile_s']} s; replicated "
              f"{r.get('replicated', {})}")
        vals = [h["hbm_bytes_per_chip"], m["peak_gb"], ro["step_s"]]
        if not all(np.isfinite(v) and v > 0 for v in vals) \
                or h["collective_bytes_per_chip"] <= 0:
            return f"mesh phase (c): {key} has a count <= 0: {h}, {m}"
        if r["arch"] != "tdr-graph" and h["flops_per_chip"] <= 0:
            return f"mesh phase (c): {key} counted no FLOPs"
        if key == (LM_ARCH, "train_4k") and not (
                0.3 < ro["model_flops_ratio"] < 1.2):
            return (f"mesh phase (c): 6·N·D is {ro['model_flops_ratio']} "
                    "of the counted train FLOPs")
    if got != want:
        return f"mesh phase (c): dry-run cells {sorted(got)}, want {want}"
    return None


def mesh_rank(rank: int, world: int, tmp: str) -> int:
    """One rank of phase 13's 2x2 figure (``chip_smoke.py --mesh-rank R
    N DIR``): two train steps of phase 12's phi3-mini-3.8b on a 2x2
    ``DeviceMesh`` (nccl, one card per rank); prints one JSON line."""
    import datetime
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.data import DataConfig, batch_for_step
    from repro_torch.launch import sharding
    from repro_torch.models import init_params, pspec
    from repro_torch.train import (AdamWConfig, init_train_state,
                                   make_train_step)
    from repro_torch.utils.cost import CostCounter

    torch.cuda.set_device(rank)
    dist.init_process_group(
        "nccl", store=dist.FileStore(str(Path(tmp) / "store"), world),
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=SHARD_TIMEOUT_S))
    try:
        mesh = card_mesh(torch, 2, world // 2)
        cfg = _lm_cut()
        dc = DataConfig(task="lm", vocab=cfg.vocab, seq_len=LM_SEQ,
                        global_batch=LM_BATCH)
        state = init_train_state(cfg, init_params(cfg, 0))
        state = sharding.distribute_tree(
            state, sharding.state_specs(cfg, state, mesh), mesh)
        batch = sharding.distribute_tree(
            batch_for_step(dc, 0),
            sharding.batch_specs(cfg, mesh, with_media=False), mesh)
        step_fn = make_train_step(cfg, AdamWConfig(), remat=True)
        with pspec.use_mesh(mesh, pspec.default_mapping(False)):
            state, losses, times, peak = _timed_steps(
                torch, step_fn, state, batch, LM_TIMED_STEPS + 1)
            with CostCounter() as counter:
                step_fn(state, batch)
        cost = counter.cost
        print(json.dumps({
            "rank": rank, "losses": losses, "ms": [t * 1e3 for t in times],
            "peak_gib": peak / 2**30,
            "collective_bytes": cost.collective_bytes,
            "collectives": dict(cost.collectives),
            "collective_counts": dict(cost.collective_counts),
            "flops": cost.flops}), flush=True)
    finally:
        dist.destroy_process_group()
    return 0


def mesh_figure_2x2(torch) -> None:
    """Phase 13's 2x2 figure: ``MESH_RANKS`` rank processes of this script,
    a card each; prints rank 0's line (a figure, not a check)."""
    import shutil
    import tempfile
    root = Path(__file__).resolve().parent / "build"
    root.mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="mesh_", dir=root)
    logs = [(open(Path(tmp) / f"rank{r}.out", "w+"),
             open(Path(tmp) / f"rank{r}.err", "w+"))
            for r in range(MESH_RANKS)]
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--mesh-rank",
         str(r), str(MESH_RANKS), tmp], stdout=o, stderr=e)
        for r, (o, e) in enumerate(logs)]
    try:
        for p in procs:
            p.wait(timeout=SHARD_TIMEOUT_S)
        outs = []
        for o, e in logs:
            o.seek(0)
            e.seek(0)
            outs.append((o.read(), e.read()))
    except subprocess.TimeoutExpired:
        print("mesh (a) 2x2: timed out (a figure, not a check)")
        return
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for o, e in logs:
            o.close()
            e.close()
        shutil.rmtree(tmp, ignore_errors=True)
    lines = [o.strip().splitlines()[-1] if o.strip() else "" for o, _ in outs]
    if any(p.returncode for p in procs):
        err = next(e for p, (_, e) in zip(procs, outs) if p.returncode)
        print(f"mesh (a) 2x2: a rank failed (a figure, not a check): "
              f"{err.strip().splitlines()[-3:]}")
        return
    fig = json.loads(lines[0])
    step_ms = float(np.median(fig["ms"][1:]))
    print(f"mesh (a) 2x2 mesh of {MESH_RANKS} nccl ranks, a card each: "
          f"{step_ms:.1f} ms per step after the first "
          f"({', '.join(f'{t:.1f}' for t in fig['ms'])}), "
          f"{LM_BATCH * LM_SEQ / (step_ms / 1e3):.1f} tokens/s, loss "
          f"{', '.join(f'{x:.4f}' for x in fig['losses'])}, peak "
          f"{fig['peak_gib']:.2f} GiB per rank; rank 0's collectives per "
          f"step {fig['collective_bytes']:.4e} B {fig['collectives']} "
          f"{fig['collective_counts']}, {fig['flops']:.4e} FLOP")


def mesh_phase(torch, lm_figures: dict,
               dry: Background | None = None) -> str | None:
    """Phase 13: the mesh layer on the card and the fake-rank dry-run
    (module docstring, item 13).  ``dry`` is the dry-run subprocess when
    the smoke run started it early; else it starts here, beside (a) and
    (b)."""
    dry = dry or start_dryrun()
    try:
        msg = mesh_card(torch, lm_figures) or dry.wait(
            DRYRUN_TIMEOUT_S, "mesh phase (c): the dry-run")
        if msg:
            return msg
    finally:
        dry.close()
    print(f"mesh (c) dry-run subprocess: done within "
          f"{time.perf_counter() - dry.t0:.1f} s of its start")
    data = json.loads(dry.out.read_text())
    if data["failures"]:
        return f"mesh phase (c): dry-run failures {data['failures']}"
    msg = check_dryrun(data["results"])
    if msg:
        return msg
    if torch.cuda.device_count() >= MESH_RANKS:
        mesh_figure_2x2(torch)
    return None


def mesh_card(torch, lm_figures: dict) -> str | None:
    """Phase 13 (a) and (b) on a 1x1 mesh over the card."""
    import shutil
    import tempfile
    import torch.distributed as dist
    from repro_torch import pytree
    from repro_torch.data import DataConfig, batch_for_step
    from repro_torch.launch import sharding
    from repro_torch.models import decode_step, init_params, prefill, pspec
    from repro_torch.train import (AdamWConfig, init_train_state,
                                   make_train_step)

    cfg = _lm_cut()
    dc = DataConfig(task="lm", vocab=cfg.vocab, seq_len=LM_SEQ,
                    global_batch=LM_BATCH)
    batch = batch_for_step(dc, 0)
    step_fn = make_train_step(cfg, AdamWConfig(), remat=True)
    tmp = tempfile.mkdtemp(prefix="mesh1_", dir=Path(__file__).resolve()
                           .parent / "build")
    dist.init_process_group("nccl", store=dist.FileStore(
        str(Path(tmp) / "store"), 1), rank=0, world_size=1)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", ".*deterministic.*")
            warnings.filterwarnings("ignore", ".*sequential all_reduce.*")
            mesh = card_mesh(torch, 1, 1)
            mapping = pspec.default_mapping(False)
            # (a) the steps unmeshed, then the same under the mesh; the
            # first of each warms up, the others are timed
            n_steps = LM_TIMED_STEPS + 1
            state = init_train_state(cfg, init_params(cfg, 0))
            state, l_plain, t_plain, pk_plain = _timed_steps(
                torch, step_fn, state, batch, n_steps)
            want = state["params"]
            del state
            state = init_train_state(cfg, init_params(cfg, 0))
            state = sharding.distribute_tree(
                state, sharding.state_specs(cfg, state, mesh), mesh)
            dbatch = sharding.distribute_tree(
                batch, sharding.batch_specs(cfg, mesh, with_media=False),
                mesh)
            with pspec.use_mesh(mesh, mapping):
                state, l_mesh, t_mesh, pk_mesh = _timed_steps(
                    torch, step_fn, state, dbatch, n_steps)
            e_par = max(float((a.float() - b.full_tensor().float()).abs()
                              .max()) for a, b in zip(
                pytree.leaves(want), pytree.leaves(state["params"])))
            e_loss = max(abs(a - b) for a, b in zip(l_plain, l_mesh))
            del state, want
            tok = LM_BATCH * LM_SEQ
            ms_p, ms_m = (float(np.median(t[1:])) * 1e3 for t in (t_plain,
                                                                  t_mesh))
            p12 = (f"; phase 12's step {lm_figures['step_ms']:.1f} ms, "
                   f"{lm_figures['tokens_s']:.1f} tokens/s, peak "
                   f"{lm_figures['peak_gib']:.2f} GiB") if lm_figures \
                else ""
            print(f"mesh (a) {LM_ARCH} {LM_LAYERS} layers, {LM_BATCH} x "
                  f"{LM_SEQ} tokens, {n_steps} steps from seed 0's state, "
                  f"deterministic algorithms: losses unmeshed "
                  f"{', '.join(f'{x:.6f}' for x in l_plain)}, 1x1 mesh "
                  f"{', '.join(f'{x:.6f}' for x in l_mesh)}; max |loss "
                  f"diff| {e_loss:.3e}, max |param diff| {e_par:.3e} "
                  f"(bound {MESH_STEP_TOL})")
            print(f"mesh (a) unmeshed {ms_p:.1f} ms per step after the "
                  f"first ({', '.join(f'{t * 1e3:.1f}' for t in t_plain)}), "
                  f"{tok / ms_p * 1e3:.1f} tokens/s, peak "
                  f"{pk_plain / 2**30:.2f} GiB; 1x1 mesh {ms_m:.1f} ms per "
                  f"step ({', '.join(f'{t * 1e3:.1f}' for t in t_mesh)}), "
                  f"{tok / ms_m * 1e3:.1f} tokens/s, peak "
                  f"{pk_mesh / 2**30:.2f} GiB; DTensor overhead "
                  f"{100 * (ms_m / ms_p - 1):.1f}%{p12}")
            if e_par > MESH_STEP_TOL or e_loss > MESH_STEP_TOL \
                    or not all(np.isfinite(l_mesh)):
                return (f"mesh phase (a): the 1x1 mesh's step differs by "
                        f"{e_par} (params), {e_loss} (loss)")

            # (b) one decode step after a prefill, unmeshed and meshed
            params = init_params(cfg, 0)
            toks = batch["tokens"]
            with torch.no_grad():
                _, cache = prefill(cfg, params, toks[:, :MESH_PROMPT],
                                   max_len=2 * MESH_PROMPT)
            dcache = sharding.distribute_tree(
                pytree.tree_map(lambda t: t.clone() if torch.is_tensor(t)
                                else t, cache),
                sharding.cache_specs(cfg, cache, mesh, LM_BATCH), mesh)
            dparams = sharding.distribute_tree(
                params, sharding.param_specs(cfg, params, mesh), mesh)
            step_tok = toks[:, MESH_PROMPT]
            got_u, _ = decode_step(cfg, params, cache, step_tok)
            dtok = sharding.distribute_tree(
                {"t": step_tok}, {"t": pspec.P(("data",))}, mesh)["t"]
            with pspec.use_mesh(mesh, mapping):
                got_m, dcache = decode_step(cfg, dparams, dcache, dtok)
            e_dec = float((got_u.float() - got_m.full_tensor().float())
                          .abs().max())
            e_cache = max(float((a.float() - b.full_tensor().float())
                                .abs().max()) for a, b in zip(
                pytree.leaves(cache), pytree.leaves(dcache))
                if torch.is_tensor(a))
            print(f"mesh (b) decode_step after a {MESH_PROMPT}-token "
                  f"prefill, 1x1 mesh against unmeshed: logits max |diff| "
                  f"{e_dec:.3e}, cache {e_cache:.3e} (bound {LM_BF16_TOL}); "
                  f"replicated points {dict(pspec.REPLICATED)}")
            if e_dec > LM_BF16_TOL or e_cache > LM_BF16_TOL \
                    or not bool(torch.isfinite(got_u).all()):
                return f"mesh phase (b): the meshed decode differs by {e_dec}"
            del params, dparams, cache, dcache
    finally:
        torch.use_deterministic_algorithms(False)
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    return None


def tdr2d_rank(rank: int, world: int, tmp: str) -> int:
    """One rank of phase 14 (b) (``chip_smoke.py --tdr2d-rank R N DIR``):
    joins the group through a file store in ``DIR``, runs the 1-D
    ``LoweredClosure`` and the 2-D ``LoweredClosure2D`` at every layout of
    ``TDR2D_LAYOUTS`` on the smoke graph's 256-bit seeds at R = 2 and at
    the fixpoint's rounds, checks its 2-D block against ``seeds | 1-D``
    by digest, and prints one JSON line of its figures.  Exits non-zero
    on a mismatch."""
    import dataclasses
    import datetime
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch import bitset, distributed, engine, graph, tdr_build

    spec = json.loads((Path(tmp) / "spec.json").read_text())
    dev = torch.device(spec["devices"][rank])
    torch.cuda.set_device(dev)
    dist.init_process_group(
        spec["backend"], store=dist.FileStore(str(Path(tmp) / "store"),
                                              world),
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=TDR2D_TIMEOUT_S))
    mesh = distributed.ShardMesh(device=dev)
    g = graph.erdos_renyi(N_VERTICES, AVG_DEGREE, N_LABELS, seed=0)
    cfg = tdr_build.TDRConfig()
    _, _, disc = tdr_build.dfs_intervals(g)
    words = tdr_build._vertex_bit_words(cfg, disc)          # [V, 8]
    bad = [] if digest(words) == spec["seeds"] else ["seed words"]
    v_n, nbits = g.n_vertices, cfg.vtx_bits
    out = {"rank": rank, "device": str(dev), "runs": []}

    def edges(ed, s):
        return (torch.from_numpy(ed.local[s].astype(np.int64)).to(dev),
                torch.from_numpy(ed.remote[s].astype(np.int64)).to(dev),
                torch.from_numpy(ed.valid[s]).to(dev))

    def sync_time(fn):
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    seeds = bitset.np_to_words(words, dev)
    v_pad1, ed1 = distributed.partition_graph(g, world)
    per1 = v_pad1 // world
    rows1 = bitset.np_to_words(distributed._pad_to(words, v_pad1)[
        rank * per1:(rank + 1) * per1], dev)
    lows = {}
    for v_sh, w_sh in TDR2D_LAYOUTS:   # every rank makes every group
        v_pad, ed = distributed.partition_graph(g, v_sh)
        low = distributed.lower_distributed_closure_2d(
            mesh, v_n, ed.local.shape[1], nbits, 0, word_shards=w_sh)
        vi, wi = low.coords
        cols = slice(wi * low.per_w, (wi + 1) * low.per_w)
        rows = distributed._pad_to(words, v_pad)[
            vi * low.per_v:(vi + 1) * low.per_v, cols]
        lows[(v_sh, w_sh)] = (low, v_pad, cols,
                              bitset.np_to_words(rows, dev),
                              edges(ed, vi))
    for rounds in (2, spec["fix_rounds"]):
        low1 = distributed.lower_distributed_closure(
            mesh, v_n, ed1.local.shape[1], nbits, rounds)
        r1, sec1 = sync_time(lambda: low1(rows1, *edges(ed1, rank)))
        full1 = engine.all_gather_words(r1, mesh)[:v_n]
        if rounds == spec["fix_rounds"] and digest(full1) != spec["closure"]:
            bad.append(f"1-D closure at R={rounds} is not the fixpoint")
        want = seeds | full1
        out["runs"].append({"layout": "1-D", "rounds": rounds,
                            "s": sec1, "gather_bytes": v_pad1 * 8 * 4})
        for (v_sh, w_sh), (low, v_pad, cols, rows, ed_t) in lows.items():
            low = dataclasses.replace(low, rounds=rounds)
            got, sec = sync_time(lambda: low(rows, *ed_t))
            vi = low.coords[0]
            exp = torch.cat([want, want.new_zeros(
                (v_pad - v_n, want.shape[1]))])[
                vi * low.per_v:(vi + 1) * low.per_v, cols]
            if digest(got) != digest(exp):
                bad.append(f"2-D {v_sh}x{w_sh} at R={rounds}")
            out["runs"].append({
                "layout": f"{v_sh}x{w_sh}", "rounds": rounds, "s": sec,
                "gather_bytes": v_pad * low.per_w * 4})
        del r1, full1, want
    dist.barrier()
    out["bad"] = bad
    print(json.dumps(out), flush=True)
    dist.destroy_process_group()
    return 1 if bad else 0


def tdr2d_command(rank: int, world: int, tmp: str) -> list[str]:
    """The command line of one phase-14 rank: this script again."""
    return [sys.executable, str(Path(__file__).resolve()), "--tdr2d-rank",
            str(rank), str(world), tmp]


def perf_command(out: Path) -> list[str]:
    """Phase 14 (c): the ``tdr-*`` perf iterations on 256 fake ranks of
    the card, in one process (one fake group and production mesh), each
    recorded into ``out`` as ``python -m repro_torch.launch.perf --iter
    IT --out OUT`` records it."""
    code = ("from repro_torch.launch import perf\n"
            f"for it in {tuple(PERF_GATHER_BYTES)!r}:\n"
            "    perf.record(it, perf.run_tdr_variant("
            f"*perf.TDR_ITERATIONS[it]), {str(out)!r})\n")
    return [sys.executable, "-c", code]


def legacy_phase(torch, g, idx, queries, answers, record) -> str | None:
    """Phase 14 (a): ``answer_batch(exact_mode="legacy")`` on phase 1's
    queries, on ``matmul`` (launch counts set to 0 just before and read
    just after) and on ``segment``; B1 on one legacy frontier against its
    plain version; a profiled run for the idle share."""
    from repro_torch import bitset, tdr_query
    from repro_torch.kernels import ops, ref
    step = ops.frontier_step
    seen = {"n": 0}

    def spy(a, x):   # observes one call's operands; computes nothing
        seen["n"] += 1
        if seen["n"] <= SPY_CALL and bool((a != 0).any()):
            seen["a"], seen["x"] = a, x     # a class that has edges
        return step(a, x)

    runs = {}
    for backend in ("matmul", "segment"):
        st = tdr_query.QueryStats()
        torch.cuda.synchronize()
        if backend == "matmul":
            ops.frontier_step = spy
        ops.KERNEL_LAUNCHES.clear()
        t0 = time.perf_counter()
        try:
            ans = tdr_query.answer_batch(idx, queries, backend=backend,
                                         exact_mode="legacy",
                                         exact_chunk=EXACT_CHUNK, stats=st)
            torch.cuda.synchronize()
        finally:
            ops.frontier_step = step
        wall = time.perf_counter() - t0
        runs[backend] = (ans, st, dict(ops.KERNEL_LAUNCHES))
        print(f"legacy answer_batch[{backend}]: {wall:.3f} s, "
              f"{len(queries) / wall:.1f} queries/s; phase-2 jobs "
              f"{st.exact_jobs} in {len(st._round_parts)} full-graph chunks, "
              f"rounds {st.exact_rounds} ({st._round_parts}); launches "
              f"{runs[backend][2]}")
        if not np.array_equal(ans, answers):
            return f"legacy answers on {backend} differ from phase 1's"
    if runs["matmul"][1].exact_rounds != runs["segment"][1].exact_rounds:
        return "legacy rounds differ between matmul and segment"
    n_b1 = runs["matmul"][2].get("bitset_matmul", 0)
    if n_b1 <= 0:
        return "bitset_matmul was not launched by the legacy executor"
    wall, busy, top, _ = profile(torch, lambda: tdr_query.answer_batch(
        idx, queries, exact_mode="legacy", exact_chunk=EXACT_CHUNK))
    print(f"profile legacy answer_batch: wall {wall:.3f} s, device busy "
          f"{busy:.3f} s ({100 * (1 - busy / wall):.1f}% idle); top device "
          "time: " + "; ".join(f"{k} {ms:.1f} ms x{n}" for k, ms, n in top))
    if "a" not in seen:
        return "no legacy frontier reached bitset_matmul"
    a, x = seen["a"], seen["x"]
    m, kw = a.shape
    x = ref.pad_k(x, kw * 32).contiguous()
    a_bits = int(bitset.popcount(a).sum())
    w = x.shape[1]
    a_unp = ref.unpacked_bf16(a, kw * 32)
    x_unp = ref.unpacked_bf16(x, w * 32)
    print(f"bitset_matmul[legacy]: class matrix {tuple(a.shape)} with "
          f"{a_bits} set bits, subset-state frontier {tuple(x.shape)} with "
          f"{int((x != 0).sum())} non-zero words (the last class with edges "
          f"in the first {SPY_CALL} of {seen['n']} calls)")
    good = record(
        f"bitset_matmul[legacy,W={w}]",
        "src/repro_torch/kernels/csrc/bitset_matmul.cu",
        "src/repro/kernels/bitset_matmul.py:45", ops.frontier_step(a, x),
        ref.bitset_matmul_ref(a, x), lambda: ops.frontier_step(a, x),
        lambda: ref.bitset_matmul_ref(a, x), (m * kw + x.numel() + m * w) * 4,
        m * kw + 2 * a_bits * w, lambda: torch.matmul(a_unp, x_unp),
        n_launches=n_b1)
    del a_unp, x_unp
    return None if good else "bitset_matmul disagrees on a legacy frontier"


def tdr2d_phase(torch, g, idx, queries, answers, record,
                perf: Background | None = None) -> str | None:
    """Phase 14: the legacy executor (a), the 2-D closure on
    ``TDR2D_RANKS`` rank processes (b) and the ``tdr-*`` perf iterations
    on 256 fake ranks of the card (c).  ``perf`` is (c)'s subprocess when
    the smoke run started it early; else it starts here, beside (a) and
    (b).  Returns a failure message, or None."""
    import os
    import shutil
    import tempfile
    root = Path(__file__).resolve().parent
    perf = perf or start_perf()
    procs = []
    tmp = tempfile.mkdtemp(prefix="tdr2d_", dir=root / "build")
    try:
        msg = legacy_phase(torch, g, idx, queries, answers, record)
        if msg:
            return f"2-D phase (a): {msg}"

        # (b) the 2-D closure on rank processes
        backend, devices = rank_devices(torch, TDR2D_RANKS)
        print(f"tdr2d: {TDR2D_RANKS} ranks on {backend}, devices {devices}")
        spec = {"backend": backend, "devices": devices,
                "seeds": digest(idx.vtx_words), "closure": digest(idx.r_vtx),
                "fix_rounds": idx.fixpoint_rounds}
        (Path(tmp) / "spec.json").write_text(json.dumps(spec))
        renv = dict(os.environ, OMP_NUM_THREADS=str(
            max(1, (os.cpu_count() or 1) // (TDR2D_RANKS + 4))))
        t1 = time.perf_counter()
        procs = [subprocess.Popen(tdr2d_command(r, TDR2D_RANKS, tmp),
                                  env=renv, stdout=subprocess.PIPE, text=True)
                 for r in range(TDR2D_RANKS)]
        deadline = time.monotonic() + TDR2D_TIMEOUT_S
        while True:   # until every rank exits, or one fails
            codes = [p.poll() for p in procs]
            if None not in codes or any(c not in (None, 0) for c in codes):
                break
            if time.monotonic() > deadline:
                return f"2-D phase (b): a rank ran past {TDR2D_TIMEOUT_S} s"
            time.sleep(0.2)
        wall = time.perf_counter() - t1
        failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
        if failed:
            r = failed[0]
            lines = procs[r].stdout.read().strip().splitlines()
            why = json.loads(lines[-1])["bad"] if lines else "no report"
            return f"2-D phase (b): rank {r} exited {codes[r]}: {why}"
        reports = [json.loads(p.stdout.read().strip().splitlines()[-1])
                   for p in procs]
        for rep in reports:
            print(f"tdr2d rank {rep['rank']} ({rep['device']}): " + "; ".join(
                f"{run['layout']} R={run['rounds']} {run['s'] * 1e3:.1f} ms "
                f"({run['s'] * 1e3 / (run['rounds'] + 1):.2f} ms/round, "
                f"{run['gather_bytes']} B gathered/round)"
                for run in rep["runs"]))
        print(f"tdr2d: {TDR2D_RANKS} ranks in {wall:.3f} s wall (spawn to "
              f"exit); R = 2 and R = {idx.fixpoint_rounds} (the fixpoint); "
              f"every layout's block equals seeds | the 1-D closure")

        # (c) the perf iterations' records
        msg = perf.wait(PERF_TIMEOUT_S, "2-D phase (c): the iterations")
        if msg:
            return msg
        recs = json.loads(perf.out.read_text())["iterations"]
        for it in PERF_GATHER_BYTES:
            rec = recs[it]
            h, ro, m = rec["hlo"], rec["roofline"], rec["memory"]
            print(f"perf {it} on 256 fake ranks of the card: "
                  f"{h['collective_bytes_per_chip']:.0f} gather B, "
                  f"{h['hbm_bytes_per_chip']:.4e} HBM B per rank; roofline "
                  f"memory {ro['memory_s']:.6f} s, collective "
                  f"{ro['collective_s']:.6f} s, dominant {ro['dominant']}; "
                  f"temp {m['temp_gb']:.3f} GB, inputs {m['argument_gb']:.3f}"
                  f" GB; trace {rec['compile_s']} s")
            if h["collective_bytes_per_chip"] != PERF_GATHER_BYTES[it] or \
                    dict(h["collectives"]) != {
                        "all-gather": PERF_GATHER_BYTES[it]}:
                return (f"2-D phase (c): {it} gathers "
                        f"{h['collectives']}, want {PERF_GATHER_BYTES[it]}")
        print(f"tdr2d (c): the three perf iterations done within "
              f"{time.perf_counter() - perf.t0:.1f} s of their start")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        perf.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return None


def lane_rows(torch, g, eng, eng_s, a_dist, x_dist, n_dist: int, record,
              rows: list) -> str | None:
    """Phase 5's B4 rows: ``lane_matmul`` at every shape the port runs it,
    each against its plain version (tolerance 0) with the device kernels
    one call launches (must be one).

    1. The main-path operand: one ``dist_batch`` call's class matrix and
       DIST16 plane (``a_dist``, ``x_dist``; ``n_dist`` launches).
    2. ``eng.propagate(x, sr=COUNT)`` on the full forward adjacency of
       ``g``, X uint32 [V, 128] from ``default_rng(4)`` (values <=
       COUNT_CAP): one launch, equal to ``segment``'s on ``g`` with its
       parallel edges merged (the packed adjacency holds one bit per
       vertex pair; ``segment``'s sum counts each labelled edge), and
       differing from ``segment`` on ``g`` itself in exactly COUNT_APART
       rows, so that a change in that known difference shows; library time ``torch.sparse.mm`` of the adjacency as CSR by
       float32 X.
    3. ``eng.closure(base, sr=DIST8)`` over 256 sources (X uint8 [V, 256],
       W > 128): one launch a round, plane and rounds equal to ``eng_s``'s;
       the row is the middle round's call.  Its time per byte of A over
       row 2's shows whether A is read once whatever W is.
    4. ``sum``/uint32 and ``or``/uint8 at 4096 x 4096, W = 128, density
       1/1024 (``default_rng(2)``), kept for continuity; no path runs
       these shapes, so their rows count 0 launches.
    Rows 1 and 2 are also timed on an all-zero A of their shape (the
    stream of A and the output alone)."""
    from repro_torch import bitset, engine, graph, semiring
    from repro_torch.kernels import ops, ref
    src = "src/repro_torch/kernels/csrc/lane_matmul.cu"
    tpu = "src/repro/kernels/bitset_matmul.py:143"
    dev = a_dist.device
    if (eng.backend, eng_s.backend) != ("matmul", "segment"):
        return (f"lane_rows needs a matmul and a segment engine, got "
                f"{eng.backend} and {eng_s.backend}")
    ok = True

    def csr_mm(a, x):   # the library yardstick of a sum: CSR by float32
        r, c = ref.set_bits(a)
        a_csr = torch.sparse_coo_tensor(
            torch.stack([r, c]), torch.ones(r.numel(), device=dev),
            (a.shape[0], a.shape[1] * 32)).to_sparse_csr()
        x_f = semiring.widen(x).to(torch.float32)
        return lambda: torch.sparse.mm(a_csr, x_f)

    def row(name, a, x, op, cap=0, lib_fn=None, n_launches=0):
        a_r, a_c = ref.set_bits(a)
        w, lb = x.shape[1], x.element_size()
        want = ref.lane_matmul_ref(a, x, op=op, cap=cap)
        good = record(
            name, src, tpu, ops.frontier_step_lanes(a, x, op=op, cap=cap),
            want, lambda: ops.frontier_step_lanes(a, x, op=op, cap=cap),
            lambda: ref.lane_matmul_ref(a, x, op=op, cap=cap),
            a.numel() * 4 + (int(a_c.unique().numel()) + a.shape[0]) * w * lb,
            a.numel() + a_r.numel() * w, lib_fn=lib_fn,
            n_launches=n_launches)
        n_dev = profiled_kernels(
            torch, name, lambda: ops.frontier_step_lanes(a, x, op=op,
                                                         cap=cap), want=1)
        print(f"{name}: A {tuple(a.shape)} with {a_r.numel()} set bits, X "
              f"{tuple(x.shape)} {x.dtype}; one call launched {n_dev} "
              f"device kernel(s)")
        return good and n_dev == 1

    def stream_floor(name, a, x, op, cap=0):
        """B4 on an all-zero A of the same shape: the stream of A and the
        output writes alone, no gather or fold."""
        zero = torch.zeros_like(a)
        t = time_ms(torch, lambda: ops.frontier_step_lanes(
            zero, x, op=op, cap=cap), KERNEL_REPS)
        print(f"{name} on an all-zero A (stream floor): {t:.4f} ms, "
              f"{a.numel() * 4 / t / 1e9:.3f} TB/s of A")

    ok &= row("lane_matmul[min,u16]", a_dist, x_dist, "min",
              n_launches=n_dist)
    stream_floor("lane_matmul[min,u16]", a_dist, x_dist, "min")

    adj = eng.adjacency()
    n = adj.shape[1] * 32
    rng = np.random.default_rng(4)
    x_np = rng.integers(0, semiring.COUNT_CAP + 1, (n, LANE_WIDTH))
    x_cnt = torch.from_numpy(x_np.astype(np.uint32).view(np.int32)).to(dev)
    torch.cuda.synchronize()
    ops.KERNEL_LAUNCHES.clear()
    t0 = time.perf_counter()
    got = eng.propagate(x_cnt, sr=semiring.COUNT)
    torch.cuda.synchronize()
    prop_s = time.perf_counter() - t0
    n_prop = ops.KERNEL_LAUNCHES["lane_matmul"]
    pair = g.src.astype(np.int64) * g.n_vertices + g.indices
    _, first = np.unique(pair, return_index=True)
    merged = graph.Graph.from_edges(g.n_vertices, g.n_labels, zip(
        g.src[first].tolist(), g.indices[first].tolist(),
        g.labels[first].tolist()))
    same = torch.equal(got, engine.make_engine(
        merged, backend="segment", device=dev).propagate(
            x_cnt, sr=semiring.COUNT))
    apart = int((got != eng_s.propagate(x_cnt, sr=semiring.COUNT)).any(
        dim=1).sum())
    print(f"propagate(sr=COUNT)[{eng.backend}]: {prop_s * 1e3:.3f} ms, "
          f"{n_prop} lane_matmul launch(es); equals segment on the graph "
          f"with its {g.n_edges - first.size} parallel edges merged: "
          f"{same}; rows that differ from segment counting them apart: "
          f"{apart}")
    if not same or n_prop != 1:
        return "propagate(sr=COUNT) differs from segment or missed B4"
    if apart != COUNT_APART:
        return (f"propagate(sr=COUNT) differs from segment in {apart} rows, "
                f"not the {COUNT_APART} of the known multigraph difference")
    ok &= row("lane_matmul[sum,u32,propagate]", adj, x_cnt, "sum",
              semiring.COUNT_CAP, lib_fn=csr_mm(adj, x_cnt),
              n_launches=n_prop)
    t_prop = rows[-1]["ms"]
    stream_floor("lane_matmul[sum,u32,propagate]", adj, x_cnt, "sum",
                 semiring.COUNT_CAP)

    base_np = np.full((n, LANE_SOURCES), semiring.DIST8.zero, np.uint8)
    base_np[rng.choice(n, LANE_SOURCES, replace=False),
            np.arange(LANE_SOURCES)] = 0
    base = torch.from_numpy(base_np).to(dev)
    calls = []
    lanes_fn = ops.frontier_step_lanes

    def spy(a, x, **kw):   # observes each call's operand; computes nothing
        calls.append(x)
        return lanes_fn(a, x, **kw)

    torch.cuda.synchronize()
    ops.frontier_step_lanes = spy
    ops.KERNEL_LAUNCHES.clear()
    try:
        t0 = time.perf_counter()
        plane, rounds = eng.closure(base, sr=semiring.DIST8)
        torch.cuda.synchronize()
        clo_s = time.perf_counter() - t0
    finally:
        ops.frontier_step_lanes = lanes_fn
    n_clo = ops.KERNEL_LAUNCHES["lane_matmul"]
    plane_s, rounds_s = eng_s.closure(base, sr=semiring.DIST8)
    same = torch.equal(plane, plane_s) and rounds == rounds_s
    print(f"closure(sr=DIST8)[{eng.backend}] over {LANE_SOURCES} sources: "
          f"{clo_s:.3f} s, {rounds} rounds (segment {rounds_s}), {n_clo} "
          f"lane_matmul launches; equals segment: {same}")
    if not same or n_clo != rounds:
        return "closure(sr=DIST8) differs from segment or missed B4"
    ok &= row("lane_matmul[min,u8,closure]", adj, calls[len(calls) // 2],
              "min", n_launches=n_clo)
    print(f"B4 time per byte of A: closure (W={LANE_SOURCES}, uint8) over "
          f"propagate (W={LANE_WIDTH}, uint32) = "
          f"{rows[-1]['ms'] / t_prop:.3f} (same A)")
    del calls, plane, plane_s, got

    rng = np.random.default_rng(2)
    a_sq = bitset.np_to_words(bitset.pack_bits_np(
        rng.random((4096, 4096)) < 1 / 1024), dev)
    for op, np_dt, cap in (("sum", np.uint32, semiring.COUNT_CAP),
                           ("or", np.uint8, 0)):
        hi = cap if op == "sum" else 255
        x_np = rng.integers(0, hi + 1, (4096, 128)).astype(np_dt)
        x_sq = torch.from_numpy(x_np.view(
            np.int32 if np_dt == np.uint32 else np.uint8)).to(dev)
        ok &= row(f"lane_matmul[{op},u{8 * x_sq.element_size()},4096]",
                  a_sq, x_sq, op, cap,
                  lib_fn=csr_mm(a_sq, x_sq) if op == "sum" else None,
                  n_launches=0)
    return None if ok else "lane_matmul disagrees with its plain version"


def class_round_capture(ops, run):
    """Runs ``run()`` with a spy on ``ops.class_round`` -> ``(run()'s
    result, the operands of the first call from ``CLASS_ROUND_CALL`` on
    with both directions on (a mid-chunk round), the calls made)``."""
    real = ops.class_round
    calls = {"n": 0, "args": None}

    def spy(*args):   # observes one call's operands; computes nothing
        calls["n"] += 1
        if calls["n"] > CLASS_ROUND_CALL and calls["args"] is None \
                and all(args[-2:]):
            calls["args"] = args
        return real(*args)

    ops.class_round = spy
    try:
        out = run()
    finally:
        ops.class_round = real
    return out, calls["args"], calls["n"]


def eager_class_round(torch, engine, ref, bitset, args, done, stacks):
    """The round as the loop ran it before ``class_round``: one
    ``bitset_matmul`` launch per label class and direction on the dense
    class ``stacks`` of the round's edges, the subset transitions, the
    mask, the new bits (on the passes whose flag and gate run the
    direction) and the meet in torch ops, and the stack of the loop's
    three flags; ``done`` is the unpacked done words of ``state``."""
    _, _, allow, has, sh, sup_need, cor_w, f, b, state, cf, cb = args
    adj_rev, adj_fwd = stacks
    q = f.shape[1]

    def run(flags, gate):
        on = (flags != 0).repeat_interleave(32)[:q] & bool(gate)
        return bitset.full_words_where(on)[None, :]

    def push(adj, x):
        upd = torch.zeros_like(x)
        for c in range(adj.shape[0]):
            y = engine._matmul_rows(adj[c], x)[:x.shape[0]]
            upd = upd | ref.subset_transition(
                y & allow[c][None, :], has[c][None, :], sh[c][None, :])
        return upd

    mask = cor_w & bitset.full_words_where(~done)[None, :]
    new_f = push(adj_rev, f) & mask & ~f & run(state[0], cf) if cf \
        else torch.zeros_like(f)
    f = f | new_f
    new_b = push(adj_fwd, b) & mask & ~b & run(state[1], cb) if cb \
        else torch.zeros_like(b)
    b = b | new_b
    done = done | ref.subset_meet(f, b, sup_need)
    return f, b, torch.stack(
        [(new_f != 0).any(), (new_b != 0).any(), done.all()])


def label_stacks(bitset, lists):
    """The dense stack ``[L, V', ceil(V'/32)]`` of an ``EdgeLists``, one
    class a label (packed on the host), on the lists' device."""
    row_ptr, cols, labels = (t.cpu().numpy().astype(np.int64)
                             for t in lists[:3])
    v_p = row_ptr.shape[0] - 1
    rows = np.repeat(np.arange(v_p), np.diff(row_ptr))
    out = np.zeros((lists.n_labels, v_p, bitset.n_words(v_p)), np.uint32)
    bitset.set_bits_np(out, (labels, rows), cols)
    return bitset.np_to_words(out, lists.row_ptr.device)


def class_round_split(torch, ops, args, width: int):
    """The captured round of a lockstep group (``args``: its chunks side
    by side, ``width`` columns each, one 32-column pass apart) launched
    again one chunk at a time on each chunk's columns and passes ->
    ``(largest word difference from the grouped launch over f_next,
    b_next and the state, the grouped launch's ms, the chunks' launches'
    ms)``, each a median between CUDA events behind a sleep."""
    lists_rev, lists_fwd, allow, has, sh, sup_need, cor_w, f, b, state, \
        cf, cb = args
    stride = -(-width // 32) * 32
    subs = []
    for c0 in range(0, f.shape[1], stride):
        cols = slice(c0, c0 + width)
        p = slice(c0 // 32, c0 // 32 + -(-width // 32))
        subs.append((lists_rev, lists_fwd) + tuple(
            t[:, cols].contiguous() for t in (allow, has, sh, sup_need,
                                              cor_w, f, b))
            + (state[:, p].contiguous(), cf, cb))
    got = ops.class_round(*args)
    each = [ops.class_round(*sub) for sub in subs]
    err = 0
    for k, (sub, out) in enumerate(zip(subs, each)):
        c0 = k * stride
        err = max(err, words_err(torch, got[0][:, c0:c0 + width], out[0]),
                  words_err(torch, got[1][:, c0:c0 + width], out[1]),
                  words_err(torch, got[2][:, c0 // 32:c0 // 32
                                          + out[2].shape[1]], out[2]))
    group_ms = time_ms(torch, lambda: ops.class_round(*args), KERNEL_REPS)
    each_ms = time_ms(torch, lambda: [ops.class_round(*sub)
                                      for sub in subs], KERNEL_REPS)
    print(f"class_round group of {len(subs)} x {width}: against its chunks "
          f"launched one at a time max_abs_err={err}; one grouped launch "
          f"{group_ms:.4f} ms, {len(subs)} launches {each_ms:.4f} ms")
    return err, group_ms, each_ms


def class_round_row(torch, engine, ops, ref, bitset, record, args,
                    n_launches=None) -> bool:
    """``class_round`` on one captured round's operands (each direction's
    edge lists; since the main path groups its full-graph chunks, a
    lockstep group's) against ``ref.class_round_ref`` on them (tolerance
    0 in ``f_next``, ``b_next`` and the state words), against the eager
    dense round it replaced on the per-label stacks of the same edges
    (``f_next``, ``b_next`` and the two changed flags) and, for a group,
    against its chunks launched one at a time (``class_round_split``),
    with its row of the ``kernels`` line; then the kernel's profiled time
    and the eager round's device time (profiler), wall time between CUDA
    events with no sleep ahead (its launches included) and device
    kernels a round."""
    lists_rev, lists_fwd, allow, has, sh, sup_need, cor_w, f, b, state = \
        args[:10]
    v_p, q = f.shape
    n_states = sup_need.shape[0]
    n_chunks = -(-q // EXACT_CHUNK)
    name = f"class_round[S={n_states},{n_chunks}x{EXACT_CHUNK}]"
    done = bitset.unpack_bits(state[2], q)
    stacks = tuple(label_stacks(bitset, lists)
                   for lists in (lists_rev, lists_fwd))
    got = ops.class_round(*args)
    want = ref.class_round_ref(*args)
    eager = eager_class_round(torch, engine, ref, bitset, args, done, stacks)
    split_err = 0
    if n_chunks > 1:
        split_err, _, _ = class_round_split(torch, ops, args, EXACT_CHUNK)
    err = max([words_err(torch, g, w) for g, w in zip(got, want)]
              + [words_err(torch, g, w) for g, w in zip(got[:2], eager[:2])]
              + [words_err(torch, (got[2][:2] != 0).any(dim=1),
                           eager[2][:2]), split_err])
    n_edges = [int(lists.cols.numel()) for lists in (lists_rev, lists_fwd)]
    set_bits = sum(int(bitset.popcount(a.reshape(-1, 1)).sum())
                   for stack in stacks for a in stack)
    print(f"{name}: lists {n_edges} entries over {v_p} rows ({set_bits} set "
          f"bits in the dense stacks {tuple(stacks[0].shape)} x 2), Q = {q}, "
          f"{n_states} states; frontier rows "
          f"{int((f != 0).any(dim=1).sum())} forward, "
          f"{int((b != 0).any(dim=1).sum())} backward")
    # bytes: both directions' lists once (row pointers, columns, labels), f,
    # b and the corridor in, f_next and b_next out; operations: an AND,
    # the transition's five and an OR per entry and query column
    good = record(
        name, "src/repro_torch/kernels/csrc/class_round.cu",
        "none: src/repro/core/tdr_query.py:630 (_bidi_matmul_core)",
        got[0], want[0], lambda: ops.class_round(*args),
        lambda: ref.class_round_ref(*args),
        lists_rev.nbytes + lists_fwd.nbytes + 5 * v_p * q * 4,
        7 * sum(n_edges) * q, n_launches=n_launches, err=err)
    profiled_kernels(torch, name, lambda: ops.class_round(*args))
    wall = time_ms(torch, lambda: eager_class_round(
        torch, engine, ref, bitset, args, done, stacks), PLAIN_REPS,
        queued=False)
    _, busy, top, n_k = profile(torch, lambda: [
        eager_class_round(torch, engine, ref, bitset, args, done, stacks)
        for _ in range(PLAIN_REPS)])
    print(f"{name} eager round it replaced: device "
          f"{1e3 * busy / PLAIN_REPS:.4f} ms, wall {wall:.4f} ms between "
          f"CUDA events, {n_k / PLAIN_REPS:.1f} device kernels a round; top "
          + "; ".join(f"{k} {ms / PLAIN_REPS:.4f} ms x{n / PLAIN_REPS:g}"
                      for k, ms, n in top))
    return good


def make_record(torch, rows: list, launches: dict):
    """A function that checks one kernel call against its plain version
    (tolerance 0), times the kernel, the plain version and the library
    yardstick, appends the kernel's row of the ``kernels`` JSON line to
    ``rows`` and returns whether the two agreed.  A row's launches are
    ``n_launches`` or the main path's count of its kernel in
    ``launches``."""
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

    return record


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        return fail("no CUDA device is available")
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        return fail(f"no src/repro_torch beside {Path(__file__).name}")
    sys.path.insert(0, str(src))
    # the host-only subprocesses of phases 13 (c) and 14 (c) trace fake
    # ranks and touch no card memory: they run beside phases 1-13
    background = {"dry": start_dryrun(), "perf": start_perf()}
    try:
        return smoke(torch, background)
    finally:
        for job in background.values():
            job.close()


def smoke(torch, background: dict) -> int:
    """Phases 1-14 (module docstring); ``background`` holds the started
    subprocesses of 13 (c) and 14 (c)."""
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
    answers, round_main, _ = class_round_capture(
        ops, lambda: tdr_query.answer_batch(
            idx, queries, exact_mode="auto", exact_chunk=EXACT_CHUNK,
            stats=stats))
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

    record = make_record(torch, rows, launches)

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
    a_unp = ref.unpacked_bf16(adj, kw * 32)
    for w, x in xs.items():
        x = ref.pad_k(x, kw * 32).contiguous()
        got = ops.frontier_step(adj, x)
        want = ref.bitset_matmul_ref(adj, x)
        x_unp = ref.unpacked_bf16(x, w * 32)
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
        x_unp = ref.unpacked_bf16(ref.pad_k(x, kw * 32), w * 32)
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
        profiled_kernels(torch, f"block_sparse_matmul[{label}]",
                         lambda: ops.frontier_step_sparse(bcomp, x))
        return good

    for label, bcomp, x in frontiers:
        rev = bcomp is eng.block_adjacency(reverse=True)
        adj_c = eng.adjacency(reverse=rev)
        a_unp_c = a_unp if not rev else ref.unpacked_bf16(adj_c, kw * 32)
        ok &= b3_row(label, bcomp, x, adj_c, a_unp_c, rev)
        del a_unp_c
    comp = comp_f
    del a_unp

    # class_round at a mid-chunk round of the main path (4 subset states)
    # and of the same queries pinned to max_m = 4 as a server pins them
    # (16 states)
    plan_m4 = tdr_query.compile_queries(idx, queries, max_m=4)
    _, round_m4, n_m4 = class_round_capture(
        ops, lambda: tdr_query.answer_plan(idx, plan_m4, pin_m=4))
    ok &= class_round_row(torch, engine, ops, ref, bitset, record,
                          round_main)
    ok &= class_round_row(torch, engine, ops, ref, bitset, record, round_m4,
                          n_launches=n_m4)
    del round_main, round_m4
    if not ok:
        return fail("a kernel disagrees with its plain version")

    # ---- 3. cross-checks -------------------------------------------------
    for name in ("bitset_matmul", "way_filter", "block_sparse_matmul",
                 "class_round"):
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
    lanes_w = collections.Counter()    # lane width W of each B4 call
    lanes_fn = ops.frontier_step_lanes

    def spy(a, x, **kw):   # observes one call's operands; computes nothing
        spied["n"] += 1
        lanes_w[x.shape[1]] += 1
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
    print(f"dist_batch lane_matmul calls by lane width W: "
          f"{dict(sorted(lanes_w.items()))} (W > 128 in "
          f"{sum(n for w, n in lanes_w.items() if w > 128)})")
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
    msg = lane_rows(torch, g, eng, idx_s.engine("segment"), a_dist, x_dist,
                    dist_launches.get("lane_matmul", 0), record, rows)
    if msg:
        return fail(msg)
    ok &= record(
        "popcount_rows", "src/repro_torch/kernels/csrc/popcount.cu",
        "src/repro/kernels/popcount.py:17",
        ops.popcount(h_rows), ref.popcount_rows_ref(h_rows),
        lambda: ops.popcount(h_rows), lambda: ref.popcount_rows_ref(h_rows),
        h_rows.numel() * 4 + h_rows.shape[0] * 4, h_rows.numel() * 2,
        n_launches=aux_launches.get("popcount_rows", 0))
    profiled_kernels(torch, "popcount_rows", lambda: ops.popcount(h_rows))
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
    n_dev6 = profiled_kernels(
        torch, "block_sparse_lane_matmul[min,u16]",
        lambda: ops.block_sparse_lane_matmul(comp, x_dist, op="min"),
        want=2 if n_one6 else 1)
    print(f"block_sparse_lane_matmul: one call launched {n_dev6} device "
          f"kernel(s)")
    ok &= n_dev6 == (2 if n_one6 else 1)
    del b6, b6_plain, b4_dense
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
        if what == "dist_batch":
            b4 = [(ms, n) for k, ms, n in top if "lane_matmul" in k]
            print("profile dist_batch: lane_matmul " + (
                f"{b4[0][0]:.3f} ms device time over {b4[0][1]} launches"
                if b4 else "not among the top kernels"))

    # ---- 7. live index: updates, answers on the new graph, durability ---
    msg = live_index_phase(torch, g, cfg, idx, idx_s, seg_cfg, queries,
                           b3_row, kw)
    if msg:
        return fail(msg)

    # ---- 8. regular path queries -------------------------------------
    msg = rpq_phase(torch, g, idx, record)
    if msg:
        return fail(msg)

    # ---- 9. the micro-batching server ---------------------------------
    msg = serve_phase(torch, g, idx)
    if msg:
        return fail(msg)

    # ---- 10. the replicated fleet -------------------------------------
    # the kernel checks' operands go before four more processes share the
    # card (a class matrix keeps its whole label-class stack alive)
    del a_dist, x_dist, a_rows, a_cols
    spied.clear()
    sparse_calls.clear()
    msg = fleet_phase(torch, g, cfg, idx)
    if msg:
        return fail(msg)

    # ---- 11. the vertex-sharded build and answers ---------------------
    msg = shard_phase(torch, cfg, idx, answers, stats)
    if msg:
        return fail(msg)

    # ---- 12. the LM substrate -----------------------------------------
    t0 = time.perf_counter()
    lm_figures: dict = {}
    msg = lm_phase(torch, lm_figures)
    if msg:
        return fail(msg)
    print(f"LM phase: {time.perf_counter() - t0:.3f} s")

    # ---- 13. the LM mesh layer and the dry-run ------------------------
    t0 = time.perf_counter()
    msg = mesh_phase(torch, lm_figures, background["dry"])
    if msg:
        return fail(msg)
    print(f"mesh phase: {time.perf_counter() - t0:.3f} s")

    # ---- 14. the legacy executor and the 2-D closure --------------------
    t0 = time.perf_counter()
    msg = tdr2d_phase(torch, g, idx, queries, answers, record,
                      background["perf"])
    if msg:
        return fail(msg)
    print(f"2-D phase: {time.perf_counter() - t0:.3f} s")

    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--shard-rank"]:
        sys.exit(shard_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]))
    if sys.argv[1:2] == ["--mesh-rank"]:
        sys.exit(mesh_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]))
    if sys.argv[1:2] == ["--tdr2d-rank"]:
        sys.exit(tdr2d_rank(int(sys.argv[2]), int(sys.argv[3]),
                            sys.argv[4]))
    sys.exit(main())
