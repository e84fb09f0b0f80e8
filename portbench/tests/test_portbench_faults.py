"""A run with the timed path broken underneath comes out not correct.

Each test plants one fault a cell can have in the program, drives the
rest of a run on the CPU at a small size (the look for a card is skipped)
and reads ``correct``.  Faults a cell cannot have are left out: no cell
exchanges data between chips."""
from __future__ import annotations

import numpy as np
import pytest

from portbench import harness


def run(cell, small, prog, n=512, seconds=1.0):
    return harness.run_cell(cell, 2**31 + 7, seconds, False, device="cpu",
                            config=small(cell.split(".")[0], n), prog=prog,
                            log=lambda m: None)


@pytest.fixture
def patch(monkeypatch):
    return monkeypatch.setattr


def test_served_answer_altered_where_produced(small, prog, patch):
    """Every served request of one kind answered through the server's
    executors; the boolean answers come back flipped."""
    real = prog.serve.QueryServer._answer

    def flipped(self, queries, stats=None):
        return ~np.asarray(real(self, queries, stats=stats), dtype=bool)

    patch(prog.serve.QueryServer, "_answer", flipped)
    out = run("er32k-matmul.serve", small, prog)
    assert not out.correct
    assert [c.name for c in out.checks if not c.ok] == ["bool_wrong"]


def test_served_distance_altered_where_produced(small, prog, patch):
    real = prog.tdr_query.dist_batch

    def off_by_one(*args, **kwargs):
        d = real(*args, **kwargs)
        return np.where(d >= 0, d + 1, d)

    patch(prog.tdr_query, "dist_batch", off_by_one)
    out = run("er200k-segment.serve", small, prog)
    assert [c.name for c in out.checks if not c.ok] == ["dist_wrong"]


def test_served_rpq_product_route_answers_false(small, prog, patch):
    """Every regex query with distinct endpoints answered False, as a
    product route that never expands would: the rpq number alone
    catches it."""
    real = prog.tdr_query.rpq_batch

    def never(index, queries, **kwargs):
        ans = np.asarray(real(index, queries, **kwargs), dtype=bool)
        return ans & np.array([u == v for u, v, _ in queries], dtype=bool)

    patch(prog.tdr_query, "rpq_batch", never)
    out = run("er32k-matmul.serve", small, prog)
    assert [c.name for c in out.checks if not c.ok] == ["rpq_wrong"]


def test_served_route_count_answers_zero(small, prog, patch):
    patch(prog.tdr_query, "count_routes", lambda *a, **k: 0)
    out = run("er32k-matmul.serve", small, prog)
    assert [c.name for c in out.checks if not c.ok] == ["count_wrong"]


def test_batch_answer_altered_where_produced(small, prog, patch):
    real = prog.tdr_query.answer_plan

    def one_flipped(*args, **kwargs):
        ans = np.array(real(*args, **kwargs), dtype=bool)
        ans[::7] = ~ans[::7]
        return ans

    patch(prog.tdr_query, "answer_plan", one_flipped)
    assert not run("er32k-matmul.batch", small, prog).correct


def test_batch_with_half_left_out(small, prog, patch):
    """Half of each batch is left out and the rest stands in for it."""
    real = prog.tdr_query.answer_batch

    def half(index, queries, **kwargs):
        n = len(queries)
        got = real(index, list(queries[: n // 2]), **kwargs)
        return np.concatenate([got, got])[:n]

    patch(prog.tdr_query, "answer_batch", half)
    assert not run("er32k-matmul.batch", small, prog).correct


def test_build_step_returns_its_state_unchanged(small, prog, patch):
    """Every closure round returns its input: the fixpoint stops at the
    one-hop base."""
    def unchanged(base, *args, **kwargs):
        return base, 1

    patch(prog.engine, "_fixpoint", unchanged)
    patch(prog.engine, "_closure_blocksparse", unchanged)
    patch(prog.engine.Engine, "_closure_segment_frontier",
          lambda self, base, **kw: (base, 1))
    out = run("er32k-matmul.build", small, prog)
    assert not out.correct
    assert "planes_wrong" in {c.name for c in out.checks if not c.ok}


def test_a_request_that_raises_is_counted_failed(small, prog, patch):
    """A served batch holding a regex raises: its requests fail, and each
    kind's number counts its own."""
    real = prog.serve.QueryServer._answer_keys

    def broken(self, keys, uniq):
        if any(uniq[k][3] == "rpq" for k in keys):
            raise RuntimeError("planted")
        return real(self, keys, uniq)

    patch(prog.serve.QueryServer, "_answer_keys", broken)
    out = run("er32k-matmul.serve", small, prog)
    assert out.failed > 0 and not out.correct
    assert "rpq_wrong" in [c.name for c in out.checks if not c.ok]


def test_the_server_thread_hosts_the_profiler(small, prog):
    """The serve window asks the server's scheduler thread to start and
    stop the profiler (a fake one here: no card), between two batches."""
    import threading

    from portbench import trace

    class FakeProfiler(trace.Tracer):
        def start(self):
            self.host_thread = threading.get_ident()
            self.active = True

        def stop(self):
            self.stopped_by = threading.get_ident()
            self.active = False

    cfg = small("er32k-matmul")
    drv = harness.load_driver("serve_closed_loop")(
        prog, cfg, harness.load_mix("serve"), 3, "cpu")
    tracer = FakeProfiler()
    tracer.install(prog)
    try:
        drv.setup()
        drv.window(2.0, tracer)
    finally:
        tracer.uninstall()
        drv.release()
    main = threading.get_ident()
    assert not tracer.active
    assert tracer.host_thread == tracer.stopped_by != main
    assert len(drv.records) > drv.mix["clients"]
