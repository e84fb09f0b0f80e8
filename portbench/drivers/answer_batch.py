"""``answer_batch``: back-to-back ``answer_batch`` calls of fresh queries.

Each call answers ``batch`` boolean queries dealt from the run's seed
(``gen.bool_queries``); set-up builds the index and runs ``warm_batches``
calls from a stream of their own.  Records ``(specs, t_start, t_end,
answers, ok)`` per call; ``checks`` holds ``check`` answers drawn from
the seed among every call of the window to the reference.
"""
from __future__ import annotations

import time

from portbench import check, gen
from portbench.drivers import Driver


class AnswerBatch(Driver):
    """Records ``(specs, t_start, t_end, answers, ok)`` per batch."""

    def setup(self) -> None:
        self.make_graph()
        self.index = self.build()
        r = gen.rng(self.seed, gen.WARM)
        with self.phase("warm batches"):
            for _ in range(self.mix["warm_batches"]):
                self._batch(r)

    def _batch(self, r, stats=None):
        g = self.g
        specs = gen.bool_queries(self.mix, self.mix["batch"], r, g)
        qs = [self.prog.query(s, g.n_labels) for s in specs]
        return specs, self.prog.answer_batch(self.index, qs, self.cfg,
                                             self.device, stats=stats)

    def counters(self) -> dict:
        return self.prog.counters(qstats=self.qstats)

    def window(self, seconds: float, tracer=None) -> None:
        self.qstats = self.prog.tdr_query.QueryStats()
        r = gen.rng(self.seed, gen.WINDOW)
        self.before = self.counters()

        def unit():
            t = time.perf_counter()
            try:
                specs, ans = self._batch(r, self.qstats)
                return (specs, t, time.perf_counter(), ans.tolist(), True)
            except Exception as exc:  # noqa: BLE001 — counted as failed
                return ((), t, time.perf_counter(), repr(exc), False)

        self._units(seconds, tracer, unit)
        self.t_last = self.records[-1][2]
        self.after = self.counters()

    def attempted(self) -> int:
        return sum(len(r[0]) if r[-1] else self.mix["batch"]
                   for r in self.records)

    def failed(self) -> int:
        return sum(self.mix["batch"] for r in self.records if not r[-1])

    def release(self) -> None:
        self.index = None

    def checks(self, control: bool = False) -> list:
        items = [(s, a) for specs, _, _, ans, ok in self.records if ok
                 for s, a in zip(specs, ans)]
        items = check.sample(gen.rng(self.seed, gen.CHECK), items,
                             self.mix["check"])
        self.n_checked = len(items)
        wrong = check.wrong_answers(self.g, items, self.mix, control)
        failed = 0 if control else self.failed()
        return [check.Check("bool_wrong", int(wrong["bool"] + failed), 0)]


DRIVER = AnswerBatch
