"""The readers of the program's spans and counters, and the names those
spans give a trace's idle time.

The readers are held to hand-made counter deltas and build stats, and
return nothing where the program has no such counter.  One traced run of
each cell on the CPU (the profiler's device sync stubbed: no card)
reports each metric in the cells its ``workloads`` name, and the trace's
idle time of an ``answer_batch`` falls under the program's span names
instead of ``host: no torch op``.
"""
from __future__ import annotations

import types

import numpy as np
import pytest

from portbench import harness, trace

from .test_portbench_metrics import read, run_of

NEW = ("serve_queue_wait_ms.serve", "serve_batch_ms.serve",
       "phase2_syncs.batch", "phase2_round_host_us.batch",
       "build_host_ms.build")


def test_serve_readers_take_window_deltas():
    run = run_of([], before={"serve.dequeued": 10, "serve.queue_wait_s": 1.0,
                             "serve.batches": 2, "serve.batch_s": 0.5},
                 after={"serve.dequeued": 60, "serve.queue_wait_s": 3.5,
                        "serve.batches": 7, "serve.batch_s": 1.5})
    assert read("serve_queue_wait_ms.serve", run) == pytest.approx(50.0)
    assert read("serve_batch_ms.serve", run) == pytest.approx(200.0)


def test_phase2_readers_take_window_deltas():
    recs = [((), 0, 1, [], True)] * 4 + [((), 1, 2, "x", False)]
    run = run_of(recs,
                 before={"query.host_syncs": 5, "query.exact_rounds": 4,
                         "query.phase2_s": 1.0, "query.sync_wait_s": 0.5},
                 after={"query.host_syncs": 545, "query.exact_rounds": 504,
                        "query.phase2_s": 2.5, "query.sync_wait_s": 1.0})
    assert read("phase2_syncs.batch", run) == pytest.approx(135.0)
    assert read("phase2_round_host_us.batch", run) == pytest.approx(2000.0)


def test_build_reader_takes_the_last_builds_stats():
    st = types.SimpleNamespace(dfs_s=0.25, layout_s=0.125, pack_s=0.0625,
                               closure_s=9.0, levels_s=9.0,
                               projections_s=9.0, wall_s=40.0)
    run = run_of([])
    run.driver.index = types.SimpleNamespace(build_stats=st)
    assert read("build_host_ms.build", run) == pytest.approx(437.5)


def test_readers_find_nothing_without_the_programs_counters():
    """A program without the counters (the parent of the change that
    added them) leaves each metric out: nothing raises."""
    recs = [((), 0, 1, [], True)] * 3
    old = {"serve.served": 70, "serve.batches": 5, "query.n_jobs": 300,
           "query.exact_rounds": 407, "query.phase2_s": 2.0}
    run = run_of(recs, before={k: 0 for k in old}, after=old)
    run.driver.index = types.SimpleNamespace()
    for name in NEW:
        assert read(name, run) is None, name
    idle = run_of([], before={"serve.dequeued": 3, "serve.queue_wait_s": 1,
                              "serve.batches": 1, "serve.batch_s": 1.0,
                              "query.exact_rounds": 9,
                              "query.sync_wait_s": 0.1},
                  after={"serve.dequeued": 3, "serve.queue_wait_s": 1,
                         "serve.batches": 1, "serve.batch_s": 1.0,
                         "query.exact_rounds": 9, "query.sync_wait_s": 0.1})
    for name in NEW:       # no work in the window, no build
        assert read(name, idle) is None, name


@pytest.fixture
def no_card_sync(monkeypatch):
    """The profiler's device syncs stubbed (the CPU has no card), and one
    intra-op thread: the window must hold a few whole units, and parallel
    test workers would otherwise oversubscribe the cores."""
    import torch
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.usefixtures("no_card_sync")
@pytest.mark.parametrize("cell", ["er32k-matmul.serve",
                                  "er200k-segment.serve",
                                  "er32k-matmul.batch",
                                  "er32k-matmul.build"])
def test_a_traced_run_reports_the_new_metrics_where_listed(cell, small,
                                                           prog):
    bench = harness.load_benchmark()
    listed = {m["name"] for m in bench["per_layer"]
              if m["name"] in NEW and cell in m["workloads"]}
    assert listed
    out = harness.run_cell(cell, 2**31 + 11, 4.0, True, device="cpu",
                           config=small(cell.split(".")[0], 256), prog=prog,
                           log=lambda m: None)
    assert out.correct
    assert listed <= set(out.metrics)
    assert not (set(NEW) - listed) & set(out.metrics)
    for name in listed:
        assert out.metrics[name]["value"] > 0, name
    gaps = dict(out.breakdown["idle_gaps"])
    assert any(n.startswith("repro_torch.") for n in gaps)


def test_idle_time_falls_under_the_programs_spans(prog):
    """Over a CPU profile of ``answer_batch`` (no device work: all of it
    is idle), the time no torch op covers is the Python inside the
    program's spans, and ``trace.idle_by_op`` names it by them."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    g = prog.graph_mod.erdos_renyi(200, 3.0, 6, seed=1)
    idx = prog.tdr_build.build_index(g, device="cpu")
    rng = np.random.default_rng(0)
    qs = [(int(rng.integers(200)), int(rng.integers(200)),
           prog.pat.all_of([int(a) for a in rng.choice(6, 2, False)]))
          for _ in range(64)]
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            prog.tdr_query.answer_batch(idx, qs, device="cpu",
                                        backend="segment")
    finally:
        torch.set_num_threads(n)
    host = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()]
    phases = [(s, e) for name, s, e in host
              if name in ("repro_torch.query.phase1",
                          "repro_torch.query.phase2")]
    lo, hi = min(s for s, _ in phases), max(e for _, e in phases)
    idle = trace.idle_by_op([(lo, hi)], trace.timeline(host))
    total = sum(idle.values())
    ours = sum(v for k, v in idle.items() if k.startswith("repro_torch."))
    assert total == pytest.approx((hi - lo) / 1e9)
    assert idle.get(trace.NO_OP, 0.0) < 0.1 * total
    assert ours > 0.2 * total
    assert {"repro_torch.query.phase2", "repro_torch.sync"} <= set(idle)
