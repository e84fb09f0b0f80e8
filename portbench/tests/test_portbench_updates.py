"""The live-index cell: reads stamped with their LSN beside a writer.

On the CPU at 700 vertices, with the mix's write schedule scaled to a
window of seconds (a 16-edge insert every second from 0.25 s, an 8-edge
delete every second from 0.75 s, so that every edge of an update is
probed).  The cell runs through ``harness.run_cell`` as new files only;
the reference's graph at each LSN equals the program's own
``Graph.apply_updates`` chain; three faults planted in the write path
come out not correct in ``write_wrong``; the control fails the cell; the
profiled stretch is the window's last seconds and ends after the last
update."""
from __future__ import annotations

import json
import shutil
import threading
import time

import numpy as np
import pytest

from portbench import control, discover, gen, harness, trace
from portbench.reference import updates as ref_updates

CELL = "er32k-matmul-live.serve-update"
NEW = ("configs/er32k-matmul-live.json", "traffic/serve-update.json",
       "drivers/serve_update.py", "reference/updates.py",
       "metrics/update_ms.py", "metrics/update_swap_wait_ms.py",
       "metrics/update_rebuild_share.py", "metrics/class_stack_mb.py")
SEED = 2**33 + 17
erdos_renyi = discover.load("generators", "erdos_renyi", "erdos_renyi")


def scaled(mix: dict) -> dict:
    mix = json.loads(json.dumps(mix))
    mix["updates"].update(
        insert={"edges": 16, "first_s": 0.25, "every_s": 1.0},
        delete={"edges": 8, "first_s": 0.75, "every_s": 1.0})
    mix.update(warm_seconds=0.3, trace_seconds=0.8)
    return mix


def digest(root):
    return {p.relative_to(root): p.read_bytes() for p in root.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


@pytest.fixture
def live(tmp_path, small):
    """``(root, pkg, config)``: a copy of the benchmark with the cell's
    schedule scaled, and its configuration at 700 vertices."""
    pkg = tmp_path / "portbench"
    shutil.copytree(harness.PKG, pkg,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    mix = scaled(harness.load_mix("serve-update"))
    (pkg / "traffic" / "serve-update.json").write_text(json.dumps(mix))
    return tmp_path, pkg, small("er32k-matmul-live", 700)


def run(live, prog, seconds=2.5):
    root, pkg, cfg = live
    return harness.run_cell(CELL, SEED, seconds, False, device="cpu",
                            root=root, pkg=pkg, config=cfg, prog=prog,
                            log=lambda m: None)


def failing(out) -> list:
    return [c.name for c in out.checks if not c.ok]


def test_the_cell_is_new_files_and_runs_correct(tmp_path, live, prog):
    """Without the cell's files and entries the benchmark is the accepted
    one; with them (the scaled mix aside) it runs the cell correct."""
    bench = harness.load_benchmark()
    old = tmp_path / "old"
    shutil.copytree(harness.PKG, old,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for f in NEW:
        (old / f).unlink()
    pkg = live[1]
    assert {k: v for k, v in digest(pkg).items() if str(k) not in NEW} \
        == digest(old)
    assert len(digest(pkg)) == len(digest(old)) + len(NEW)
    cells = [w["name"] for w in bench["workloads"]]
    assert cells[-1] == CELL
    assert [c["name"] for c in bench["configs"]][-1] == "er32k-matmul-live"
    out = run(live, prog)
    assert out.correct, out.checks
    assert set(out.metrics) == {"serve_qps", "setup_s"}
    assert [c.name for c in out.checks][-2:] == ["write_wrong",
                                                 "order_wrong"]
    assert out.failed == 0 and out.attempted > 200
    per_layer = [m["name"] for m in harness.cell_metrics(bench, CELL, True)]
    assert per_layer == ["serve_batch_size.serve", "device_idle.serve",
                         "bitset_matmul_roofline.serve",
                         "serve_queue_wait_ms.serve", "serve_batch_ms.serve",
                         "update_ms.serve-update",
                         "update_swap_wait_ms.serve-update",
                         "update_rebuild_share.serve-update",
                         "class_stack_mb.serve-update"]


def test_the_window_writes_and_reads_back(live, prog):
    """Inserts run incremental and deletes rebuild at this size too; each
    probe of an insert reads true and of a delete false, stamped at its
    update's LSN or later; the per-layer readers read the window."""
    root, pkg, cfg = live
    mix = harness.load_mix("serve-update", pkg)
    drv = harness.load_driver("serve_update", pkg)(prog, cfg, mix, SEED,
                                                   "cpu", pkg)
    drv.setup()
    try:
        drv.window(2.5)
        runobj = harness.Run({}, cfg, mix, 2.5, 1.0, drv)
        got = {m: harness.load_reader(m, pkg)(runobj) for m in (
            "update_ms.serve-update", "update_swap_wait_ms.serve-update",
            "update_rebuild_share.serve-update")}
    finally:
        drv.release()
    writes = drv.writes
    assert [w.kind for w in writes] == ["insert", "delete"] * 3 + ["insert"]
    assert [w.lsn for w in writes] == list(range(1, 8))
    assert [w.mode for w in writes] == [
        "incremental", "rebuild"] * 3 + ["incremental"]
    for w in writes:
        assert w.error is None and len(w.probes) == len(w.probe_rows) > 0
        assert all(lsn >= w.lsn for _, _, lsn in w.probes)
        assert {ans for _, ans, _ in w.probes} == {w.kind == "insert"}
    assert got["update_rebuild_share.serve-update"] == pytest.approx(
        100 * 2 / 5)
    assert got["update_ms.serve-update"] > 0
    assert got["update_swap_wait_ms.serve-update"] > 0
    assert {c.name: c.value for c in drv.checks()} == {
        f"{k}_wrong": 0 for k in ("bool", "dist", "rpq", "witness", "count",
                                  "write", "order")}


def test_counts_keep_their_share_on_every_graph_the_window_reaches(prog):
    """The server saturates counts where the reference does, at a cap that
    ``count_routes`` takes up to ``count_max_edges`` padded edges, past
    any graph the 32,768-vertex cell reaches (about 131,070 edges, 192
    more a cycle)."""
    mix = harness.load_mix("serve-update")
    cap = mix["count_cap"]
    assert prog.serve.ServeConfig(**mix["server"]).count_cap == cap
    assert mix["count_max_edges"] * cap < 2**32
    reached = 131_072 + 12 * mix["updates"]["insert"]["edges"]
    assert gen.kind_shares(mix, reached) == mix["kinds"]
    assert prog.mods["graph"].pad_bucket(reached, lo=32) \
        <= mix["count_max_edges"]


def test_the_reference_chain_is_the_programs(prog):
    g = erdos_renyi(300, 3.0, 6, seed=21)
    pg = prog.graph(g)
    r = np.random.default_rng(22)
    deltas = []
    for i in range(6):
        added = np.stack([r.integers(300, size=40), r.integers(300, size=40),
                          r.integers(6, size=40)], axis=1)
        pick = r.choice(pg.n_edges, 30, replace=False)
        removed = np.stack([pg.src[pick], pg.indices[pick],
                            pg.labels[pick]], axis=1)
        if i % 3 == 2:      # no-ops and an edge both removed and added
            added = np.concatenate([added, removed[:5]])
            removed = np.concatenate([removed, added[:5]])
        deltas.append((added, removed))
        pg = pg.apply_updates(added, removed).graph
        ref = ref_updates.chain(g, deltas)[-1]
        assert np.array_equal(ref.indptr, pg.indptr)
        assert np.array_equal(ref.indices, pg.indices)
        assert np.array_equal(ref.labels, pg.labels)


@pytest.fixture
def patch(monkeypatch):
    return monkeypatch.setattr


def test_an_ack_without_a_swap(live, prog, patch):
    """The update is logged and acknowledged, the index never swaps."""
    def logged_only(self, edges_added=(), edges_removed=(), **kw):
        delta = self.index.graph.apply_updates(edges_added, edges_removed)
        self._log.append(delta.added, delta.removed)
        self.stats.updates += 1
        return prog.tdr_build.UpdateStats(mode="incremental")

    patch(prog.serve.QueryServer, "submit_update", logged_only)
    out = run(live, prog)
    assert "write_wrong" in failing(out)


def test_reads_after_the_ack_on_the_pre_update_index(live, prog, patch):
    """The swap takes place at the update's LSN, but the index it swaps
    in is the one served before the update."""
    patch(prog.tdr_build, "update_index", lambda index, *a, **k: index)
    out = run(live, prog)
    assert "write_wrong" in failing(out)


def test_an_insert_dropped_from_the_swapped_index(live, prog, patch):
    real = prog.tdr_build.update_index

    def dropped(index, delta, **kw):
        if delta.added.shape[0]:
            delta = index.graph.apply_updates(delta.added[1:],
                                              delta.removed)
        return real(index, delta, **kw)

    patch(prog.tdr_build, "update_index", dropped)
    out = run(live, prog)
    assert failing(out) == ["write_wrong"]


def test_the_control_fails_the_cell(small, prog):
    """The real schedule, a window past the first insert: the program's
    numbers are 0, the control's answers break the kinds' numbers."""
    rec = control.readings(CELL, SEED, 3.0, device="cpu",
                           config=small("er32k-matmul-live", 700),
                           prog=prog)
    assert set(rec["program"].values()) == {0}
    assert rec["control"]["bool_wrong"] > 0
    assert any(rec["control"][k] for k in rec["control"])


def test_the_profiled_stretch_ends_after_the_last_update(live, prog):
    """A fake profiler, hosted by the scheduler thread: started in the
    window's last ``trace_seconds``, stopped after the last update's
    acknowledgement and the window's close."""
    root, pkg, cfg = live

    class FakeProfiler(trace.Tracer):
        def start(self):
            self.host_thread = threading.get_ident()
            self.started_at = time.perf_counter()
            self.active = True

        def stop(self):
            self.stopped_by = threading.get_ident()
            self.stopped_at = time.perf_counter()
            self.active = False

    mix = harness.load_mix("serve-update", pkg)
    drv = harness.load_driver("serve_update", pkg)(prog, cfg, mix, SEED,
                                                   "cpu", pkg)
    tracer = FakeProfiler()
    tracer.install(prog)
    try:
        drv.setup()
        drv.window(2.5, tracer)
    finally:
        tracer.uninstall()
        drv.release()
    assert not tracer.active
    assert tracer.host_thread == tracer.stopped_by != threading.get_ident()
    assert tracer.started_at >= drv.t0 + 2.5 - mix["trace_seconds"]
    assert tracer.stopped_at >= max(drv.t_end, drv.writes[-1].t_ack)
