"""``serve_update``: ``serve_closed_loop``'s clients beside one writer.

The reads are ``serve_closed_loop``'s: ``clients`` closed-loop clients on
the mix, driven from one load thread.  Every read is submitted
``with_lsn=True``, so its answer comes back stamped with the log position
(LSN) of the index that answered it.  One writer thread submits the mix's
``updates`` through ``QueryServer.submit_update`` at fixed offsets from
the window's start, the way a writer client would: inserts of edges
drawn uniformly over V x V x labels (u != v, not present) and deletes of
edges drawn uniformly from the current graph, from a stream of the run's
seed that no other draw uses (``UPDATES``).  After each acknowledgement
it reads ``probes`` of the update's edges back, stamped like any other
read: label-constrained reachability over the edge's own label alone
(``probe_family``), which the edge's presence decides.  The probes stay
out of ``records``; the update in flight when the window closes is
waited for.

Set-up builds the index, starts the server, ``persist_to`` a fresh
temporary directory (a snapshot, then every update's delta appended and
fsync'd to the write-ahead log before its swap), runs
``QueryServer.warmup``, the mix's ``warm`` updates (their one-time costs
fall in set-up) and a burst of live traffic.  ``release`` stops the
server and removes the directory.

A traced window profiles its last ``trace_seconds``; the profiler's stop
is asked for only once the window has closed and the last update has
been acknowledged (a stop takes tens of seconds in the scheduler thread,
and an update's barrier queued behind it would wait that long).

``checks`` judges every answer on the graph at its own LSN
(``reference.updates.chain``): a sample of each kind's answers
(``<kind>_wrong``); ``write_wrong``, the probes answered otherwise than
the reference at their LSN or stamped older than the update they follow,
plus the updates and probes that failed; ``order_wrong``, the reads whose
stamp breaks the server's ordering: sent before an update was called
but stamped at or past it, or submitted after its acknowledgement but
stamped before it.  Records ``(spec, t_submit, t_done, (answer, lsn,
t_sent), ok)`` per read.
"""
from __future__ import annotations

import collections
import shutil
import tempfile
import threading
import time
from concurrent import futures

import numpy as np

from portbench import check, gen
from portbench.drivers import RESULT_TIMEOUT_S
from portbench.drivers.serve_closed_loop import ServeClosedLoop
from portbench.reference import updates as ref_updates

# the stream of the update draws, beside ``gen``'s (GRAPH ... BUILD_CHECK)
UPDATES = 6


class Write:
    """One update: what was drawn (its offset from the window's start and
    its int64 ``[N, 3]`` ``(src, dst, label)`` rows), the edges read back
    after its acknowledgement, the LSN the benchmark numbers it with, and
    what came back: the call and acknowledgement times, the maintenance
    mode, an error, and ``(spec, answer, lsn)`` per probe."""

    def __init__(self, kind: str, at: float, added, removed, probe_rows):
        self.kind, self.at = kind, at
        self.added, self.removed, self.probe_rows = added, removed, probe_rows
        self.lsn = 0
        self.t_call = self.t_ack = 0.0
        self.mode = ""
        self.error: str | None = None
        self.probes: list = []


def draw_insert(r, keys: np.ndarray, n: int, n_vertices: int,
                n_labels: int) -> np.ndarray:
    """``n`` distinct edge keys uniform over V x V x L with u != v, none
    in the sorted ``keys``."""
    out = np.zeros(0, dtype=np.int64)
    while out.size < n:
        m = 2 * (n - out.size) + 16
        u = r.integers(n_vertices, size=m)
        v = r.integers(n_vertices, size=m)
        k = (u * n_vertices + v) * n_labels + r.integers(n_labels, size=m)
        k = k[(u != v) & ~np.isin(k, keys) & ~np.isin(k, out)]
        _, first = np.unique(k, return_index=True)
        out = np.concatenate([out, k[np.sort(first)]])
    return out[:n]


class ServeUpdate(ServeClosedLoop):
    """Records ``(spec, t_submit, t_done, (answer, lsn, t_sent), ok)``
    per read; ``writes`` holds the updates."""

    def setup(self) -> None:
        mix, upd = self.mix, self.mix["updates"]
        self.make_graph()
        g = self.g
        self.writes: list[Write] = []
        self._draws = gen.rng(self.seed, UPDATES)
        self._keys = g.edge_keys()
        self._n_edges_max = g.n_edges
        warm = self._plan([(kind, 0.0) for kind in upd["warm"]])
        self.kinds = self._kinds()
        self.index = self.build()
        self.srv = self.prog.server(self.index, self.cfg, mix)
        self.dir = tempfile.mkdtemp(prefix="portbench-wal-")
        with self.phase("persist"):
            self.lsn0 = self.srv.persist_to(self.dir)
        self.srv.start()
        # as serve_closed_loop: where counts are refused, warm on
        # multi-term patterns as wide
        warm_mix = mix if "count" in self.kinds else dict(
            mix, families={"bool": mix["warm_families_without_count"]})
        sample = gen.bool_queries(warm_mix, mix["warmup_requests"],
                                  gen.rng(self.seed, gen.WARM), g)
        sample = [self.prog.query(s, g.n_labels) for s in sample]
        self.nudge = sample[0]
        with self.phase("warmup"):
            self.srv.warmup(sample)
        with self.phase("updates"):
            self._write(warm, time.perf_counter())
        with self.phase("burst"):
            self._loop(mix["warm_seconds"], gen.WARM, record=None)

    # ------------------------------------------------------------ writes
    def _plan(self, slots) -> list[Write]:
        """Draw the updates of ``(kind, offset)`` slots in order, each on
        the graph the ones before it leave."""
        upd = self.mix["updates"]
        v, l = self.g.n_vertices, self.g.n_labels
        r, out = self._draws, []
        for kind, at in slots:
            n = upd[kind]["edges"]
            if kind == "insert":
                add = draw_insert(r, self._keys, n, v, l)
                rem = np.zeros(0, dtype=np.int64)
            else:
                add = np.zeros(0, dtype=np.int64)
                rem = self._keys[np.sort(r.choice(self._keys.size, n,
                                                  replace=False))]
            self._keys = ref_updates.apply(self._keys, add, rem)
            rows = ref_updates.rows_of(np.concatenate([add, rem]), v, l)
            probe = rows[np.sort(r.choice(len(rows), min(upd["probes"],
                                                         len(rows)),
                                          replace=False))]
            out.append(Write(kind, at, ref_updates.rows_of(add, v, l),
                             ref_updates.rows_of(rem, v, l), probe))
            self._n_edges_max = max(self._n_edges_max, int(self._keys.size))
        return out

    def _slots(self, seconds: float) -> list:
        """``(kind, offset)`` of the window's updates, by offset."""
        upd, out = self.mix["updates"], []
        for kind in ("insert", "delete"):
            at = upd[kind]["first_s"]
            while at < seconds:
                out.append((at, kind))
                at += upd[kind]["every_s"]
        return [(kind, at) for at, kind in sorted(out)]

    def _kinds(self) -> dict:
        """The mix's kinds for the largest graph the drawn updates reach:
        past ``count_max_edges`` route counts are refused, and their share
        goes to ``count_fallback``."""
        return gen.kind_shares(self.mix, self._n_edges_max)

    def _write(self, plan: list[Write], t0: float) -> None:
        """Submit ``plan``'s updates at their offsets from ``t0``, each
        followed by its probes; the first failure ends the plan."""
        n_l = self.g.n_labels
        for w in plan:
            self.writes.append(w)
            w.lsn = self.lsn0 + len(self.writes)   # the log's next record
            wait = t0 + w.at - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            try:
                w.t_call = time.perf_counter()
                st = self.srv.submit_update(w.added, w.removed,
                                            timeout=RESULT_TIMEOUT_S)
                w.t_ack = time.perf_counter()
                w.mode = st.mode
                specs = [("bool", int(u), int(v),
                          self.mix["updates"]["probe_family"], (int(x),))
                         for u, v, x in w.probe_rows]
                futs = [self.srv.submit(*self.prog.query(s, n_l),
                                        with_lsn=True) for s in specs]
            except Exception as exc:  # noqa: BLE001 — counted in checks
                w.error = repr(exc)
                return
            for spec, fut in zip(specs, futs):
                try:
                    w.probes.append((spec, *fut.result(
                        timeout=RESULT_TIMEOUT_S)))
                except Exception as exc:  # noqa: BLE001 — counted
                    w.probes.append((spec, repr(exc), None))

    # ------------------------------------------------------------ reads
    def _loop(self, seconds: float, stream: int, record, tracer=None,
              plan=()):
        """``serve_closed_loop``'s clients, every read stamped, with the
        writer submitting ``plan`` from a thread of its own; a tracer
        profiles the last ``trace_seconds`` and is stopped after the
        window and the writer are done."""
        mix, n_l = self.mix, self.g.n_labels
        streams = [self._stream(c, stream) for c in range(mix["clients"])]
        pending: dict = {}
        done_at: dict = {}

        def landed(fut):
            done_at[fut] = time.perf_counter()

        def send(c: int) -> None:
            spec = next(streams[c])
            kind = spec[0]
            u, v, x = self.prog.query(spec, n_l)
            kw = ({"k": mix["dist_k"]} if kind == "dist" else
                  {"hops": mix["count_hops"]} if kind == "count" else {})
            t = time.perf_counter()
            fut = self.srv.submit(u, v, x, kind=kind, with_lsn=True, **kw)
            pending[fut] = (c, spec, t, time.perf_counter())
            fut.add_done_callback(landed)

        t0 = time.perf_counter()
        t_end = t0 + seconds
        trace_at = None if tracer is None else \
            t0 + max(seconds - mix["trace_seconds"], 0.0)
        writer = None
        if plan:
            writer = threading.Thread(target=self._write, args=(plan, t0),
                                      name="portbench-writer", daemon=True)
            writer.start()
        for c in range(mix["clients"]):
            send(c)
        while pending:
            ready, _ = futures.wait(pending, timeout=RESULT_TIMEOUT_S,
                                    return_when=futures.FIRST_COMPLETED)
            if not ready:
                raise RuntimeError("no served request landed in "
                                   f"{RESULT_TIMEOUT_S} s")
            for fut in ready:
                c, spec, t, t_sent = pending.pop(fut)
                try:
                    (ans, lsn), ok = fut.result(), True
                except Exception as exc:  # noqa: BLE001 — counted failed
                    ans, lsn, ok = repr(exc), None, False
                t_done = done_at.pop(fut, None) or time.perf_counter()
                if record is not None:
                    record.append((spec, t, t_done, (ans, lsn, t_sent), ok))
                if time.perf_counter() < t_end:
                    send(c)
            if trace_at is not None and time.perf_counter() >= trace_at:
                tracer.request("start", timeout=None)
                trace_at = None
        if writer is not None:
            writer.join(2 * RESULT_TIMEOUT_S)
            if writer.is_alive():
                raise RuntimeError("the writer's update never returned")
        if tracer is not None:
            if trace_at is not None:
                raise RuntimeError("the profiled stretch never started")
            if not tracer.active:     # the start waits for a batch
                self.srv.submit(*self.nudge).result(timeout=RESULT_TIMEOUT_S)
                tracer.wait(RESULT_TIMEOUT_S)
            tracer.request("stop", timeout=None)
            self.srv.submit(*self.nudge).result(timeout=RESULT_TIMEOUT_S)
            tracer.wait(RESULT_TIMEOUT_S)
        return t0, t_end

    def window(self, seconds: float, tracer=None) -> None:
        plan = self._plan(self._slots(seconds))
        self.kinds = self._kinds()
        self.before = self.counters()
        self.t0, self.t_end = self._loop(seconds, gen.WINDOW, self.records,
                                         tracer, plan)
        self.t_last = max((r[2] for r in self.records), default=self.t_end)
        self.after = self.counters()

    def release(self) -> None:
        try:
            self.srv.stop()
            self.srv.close_persistence()
        finally:
            self.srv = self.index = None
            shutil.rmtree(self.dir, ignore_errors=True)

    # ------------------------------------------------------------ checks
    def attempted(self) -> int:
        """Reads, updates and the probes sent."""
        return len(self.records) + sum(1 + len(w.probes)
                                       for w in self.writes)

    def failed(self) -> int:
        return super().failed() + self._failed_writes()

    def checks(self, control: bool = False) -> list:
        mix = self.mix
        graphs = ref_updates.chain(self.g, [(w.added, w.removed)
                                            for w in self.writes])

        def judged(items) -> collections.Counter:
            """Wrong ones per kind among ``(spec, answer, lsn)`` items,
            each on the graph at its LSN; an LSN with no graph is
            wrong."""
            by_lsn = collections.defaultdict(list)
            for spec, ans, lsn in items:
                by_lsn[lsn].append((spec, ans))
            wrong = collections.Counter()
            for lsn, group in by_lsn.items():
                at = None if lsn is None else lsn - self.lsn0
                if at is None or not 0 <= at < len(graphs):
                    for spec, _ in group:
                        wrong[spec[0]] += 1
                else:
                    wrong.update(check.wrong_answers(graphs[at], group, mix,
                                                     control))
            return wrong

        r = gen.rng(self.seed, gen.CHECK)
        items = []
        for kind in self.kinds:
            done = [(rec[0], rec[3][0], rec[3][1]) for rec in self.records
                    if rec[0][0] == kind and rec[4]]
            items += check.sample(r, done, mix["check"][kind])
        self.n_checked = len(items)
        wrong = judged(items)
        if not control:
            wrong.update(rec[0][0] for rec in self.records if not rec[4])
        out = [check.Check(f"{kind}_wrong", int(wrong[kind]), 0)
               for kind in self.kinds]
        # the writes: every probe on the graph at its LSN, and stamped no
        # older than its update; a failed update or probe is wrong
        probes = [p for w in self.writes for p in w.probes
                  if p[2] is not None]
        self.n_checked += len(probes)
        stale = sum(1 for w in self.writes for p in w.probes
                    if p[2] is not None and p[2] < w.lsn)
        out.append(check.Check(
            "write_wrong", int(sum(judged(probes).values()) + stale
                               + self._failed_writes()), 0))
        out.append(check.Check("order_wrong", self._out_of_order(), 0))
        return out

    def _failed_writes(self) -> int:
        """Updates that raised, and probes that raised."""
        return sum((w.error is not None)
                   + sum(1 for p in w.probes if p[2] is None)
                   for w in self.writes)

    def _out_of_order(self) -> int:
        """Reads stamped against the server's order: sent before an
        update's call yet stamped at or past its LSN, or submitted after
        its acknowledgement yet stamped before it."""
        done = [(rec[1], rec[3][2], rec[3][1]) for rec in self.records
                if rec[4]]
        if not done:
            return 0
        t_sub, t_sent, lsn = (np.asarray(x, dtype=float)
                              for x in zip(*done))
        bad = np.zeros(len(done), dtype=bool)
        for w in self.writes:
            if w.error is not None or not w.t_ack:
                continue
            bad |= (t_sent < w.t_call) & (lsn >= w.lsn)
            bad |= (t_sub > w.t_ack) & (lsn < w.lsn)
        return int(bad.sum())


DRIVER = ServeUpdate
