"""``serve_closed_loop``: closed-loop clients on ``QueryServer``.

``clients`` clients, driven from one load thread, each send their next
request when the last one's answer lands.  Each client deals its own
stream of the mix from the run's seed (``gen.requests``).  Set-up builds
the index, starts the server, runs ``QueryServer.warmup`` and a burst of
live traffic from a stream of its own.  Records ``(spec, t_submit,
t_done, answer, ok)`` per request; ``checks`` holds a sample of each
kind's answers, drawn from the seed, to the reference, one number a
kind.
"""
from __future__ import annotations

import collections
import time
from concurrent import futures

from portbench import check, gen
from portbench.drivers import RESULT_TIMEOUT_S, Driver


class ServeClosedLoop(Driver):
    """Records ``(spec, t_submit, t_done, answer, ok)`` per request."""

    def setup(self) -> None:
        mix = self.mix
        self.make_graph()
        g = self.g
        self.kinds = gen.kind_shares(mix, g.n_edges)
        self.index = self.build()
        self.srv = self.prog.server(self.index, self.cfg, mix)
        self.srv.start()
        # QueryServer.warmup probes count_routes with the sample's first
        # single-term pattern; where counts are refused it takes a sample
        # of multi-term patterns with as wide a require-set instead
        warm_mix = mix if "count" in self.kinds else dict(
            mix, families={"bool": mix["warm_families_without_count"]})
        warm = gen.bool_queries(warm_mix, mix["warmup_requests"],
                                gen.rng(self.seed, gen.WARM), g)
        warm = [self.prog.query(s, g.n_labels) for s in warm]
        self.nudge = warm[0]
        with self.phase("warmup"):
            self.srv.warmup(warm)
        # a burst of live traffic from its own streams: the result cache,
        # the allocator and the threads reach their steady state
        with self.phase("burst"):
            self._loop(mix["warm_seconds"], gen.WARM, record=None)

    def counters(self) -> dict:
        return self.prog.counters(server=self.srv)

    def _stream(self, c: int, stream: int):
        """Client ``c``'s endless request stream, dealt from its own
        generator: the same seed gives every client the same requests."""
        r = gen.rng(self.seed, stream, c)
        n = sum(self.kinds.values())
        while True:
            yield from gen.requests(self.mix, n, r, self.g, self.kinds)

    def _loop(self, seconds: float, stream: int, record, tracer=None):
        """``clients`` closed-loop clients driven from this one thread:
        each client's next request goes out when its last answer lands,
        until ``seconds`` have passed; the requests in flight then are
        waited for.  A request's latency runs from ``submit`` to its
        future's completion."""
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
            fut = self.srv.submit(u, v, x, kind=kind, **kw)
            pending[fut] = (c, spec, t)
            fut.add_done_callback(landed)

        t0 = time.perf_counter()
        t_end = t0 + seconds
        trace_at = trace_end = None
        if tracer is not None:
            # the server's scheduler thread starts and stops the profiler
            # between two batches; the stretch ends before the window does
            length = min(mix["trace_seconds"], seconds / 2)
            trace_at = t0 + (seconds - length) / 2
            trace_end = min(trace_at + length, t_end - 0.5)
        for c in range(mix["clients"]):
            send(c)
        while pending:
            ready, _ = futures.wait(pending, timeout=RESULT_TIMEOUT_S,
                                    return_when=futures.FIRST_COMPLETED)
            if not ready:
                raise RuntimeError("no served request landed in "
                                   f"{RESULT_TIMEOUT_S} s")
            for fut in ready:
                c, spec, t = pending.pop(fut)
                try:
                    ans, ok = fut.result(), True
                except Exception as exc:  # noqa: BLE001 — counted failed
                    ans, ok = repr(exc), False
                # the callback may not have run yet: it lands now
                t_done = done_at.pop(fut, None) or time.perf_counter()
                if record is not None:
                    record.append((spec, t, t_done, ans, ok))
                if time.perf_counter() < t_end:
                    send(c)
            now = time.perf_counter()
            if trace_at is not None and now >= trace_at:
                tracer.request("start", timeout=None)
                trace_at = None
            elif trace_end is not None and tracer.active and now >= trace_end:
                tracer.request("stop", timeout=None)
                trace_end = None
        if tracer is not None and (tracer.active or trace_at is not None):
            # the window closed before a batch carried the request out
            if trace_at is not None:
                raise RuntimeError("the profiled stretch never started")
            if trace_end is not None:
                tracer.request("stop", timeout=None)
            self.srv.submit(*self.nudge).result(timeout=RESULT_TIMEOUT_S)
            tracer.wait(RESULT_TIMEOUT_S)
        return t0, t_end

    def window(self, seconds: float, tracer=None) -> None:
        self.before = self.counters()
        self.t0, self.t_end = self._loop(seconds, gen.WINDOW, self.records,
                                         tracer)
        self.t_last = max((r[2] for r in self.records), default=self.t_end)
        self.after = self.counters()

    def release(self) -> None:
        self.srv.stop()
        self.srv = self.index = None

    def checks(self, control: bool = False) -> list:
        mix = self.mix
        r = gen.rng(self.seed, gen.CHECK)
        items = []
        for kind in self.kinds:
            done = [(rec[0], rec[3]) for rec in self.records
                    if rec[0][0] == kind and rec[4]]
            items += check.sample(r, done, mix["check"][kind])
        self.n_checked = len(items)
        failed = collections.Counter(rec[0][0] for rec in self.records
                                     if not rec[4])
        return check.kind_checks(self.g, items, mix, self.kinds,
                                 {} if control else failed, control)


DRIVER = ServeClosedLoop
