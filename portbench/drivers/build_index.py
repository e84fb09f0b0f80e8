"""``build_index``: back-to-back ``build_index`` of the configuration's
graph, each ending in a device synchronisation.

Set-up makes the graph and runs ``warm_builds`` builds.  Records
``(t_start, t_end, fixpoint_rounds, ok)`` per build and keeps the last
index a timed build produced: ``checks`` holds its planes and rounds to
the reference, and ``check_queries`` answers through it.
"""
from __future__ import annotations

import time

from portbench import check, gen
from portbench.drivers import Driver, sync
from portbench.reference import tdr


class BuildIndex(Driver):
    """Records ``(t_start, t_end, fixpoint_rounds, ok)`` per build and
    keeps the last index a timed build produced."""

    def setup(self) -> None:
        self.make_graph()
        for _ in range(self.mix["warm_builds"]):
            self.index = self.build()

    def window(self, seconds: float, tracer=None) -> None:
        self.before = self.counters()
        self.index = None

        def unit():
            t = time.perf_counter()
            try:
                self.index = None
                self.index = self.prog.build(self.pg, self.cfg, self.device)
                sync(self.device)
                return (t, time.perf_counter(), self.index.fixpoint_rounds,
                        True)
            except Exception as exc:  # noqa: BLE001 — counted as failed
                return (t, time.perf_counter(), repr(exc), False)

        self._units(seconds, tracer, unit)
        self.t_last = self.records[-1][1]
        self.after = self.counters()
        self.after["fixpoint_rounds"] = self.records[-1][2]

    def release(self) -> None:
        """Keep the last index's planes on the host and answers through
        it; drop the rest."""
        idx, g = self.index, self.g
        self.planes = {} if idx is None else {
            name: getattr(idx, name).cpu().numpy() for name in tdr.PLANES}
        self.queries = gen.bool_queries(
            self.mix, self.mix["check_queries"],
            gen.rng(self.seed, gen.BUILD_CHECK), g)
        self.answers = None
        if idx is not None:
            qs = [self.prog.query(s, g.n_labels) for s in self.queries]
            self.answers = self.prog.answer_batch(
                idx, qs, self.cfg, self.device).tolist()
        self.index = None

    def checks(self, control: bool = False) -> list:
        """With ``control``, the control stands in for the program's
        build: the reference with every closure stopped
        ``control_rounds_short`` productive rounds short of its fixpoint,
        and ``check.control_answer`` for the answers through it."""
        tcfg = self.cfg.get("tdr_config", {})
        want = tdr.build_planes(self.g, tcfg)
        got, rounds = self.planes, self.after.get("fixpoint_rounds")
        if control:
            # the last counted round of a fixpoint changes nothing
            got = tdr.build_planes(
                self.g, tcfg, rounds_cut=want["fixpoint_rounds"] - 1
                - self.mix["control_rounds_short"])
            rounds = got["fixpoint_rounds"]
        differ = sum(1 for name in tdr.PLANES
                     if name not in got or not tdr.equal(got[name],
                                                         want[name]))
        items = list(zip(self.queries, self.answers or []))
        self.n_checked = len(items)
        wrong = check.wrong_answers(self.g, items, self.mix, control)
        failed = 0 if control else self.failed()
        return [check.Check("planes_wrong", differ + failed, 0),
                check.Check("rounds_wrong",
                            int(rounds != want["fixpoint_rounds"]), 0),
                check.Check("bool_wrong", int(wrong["bool"]), 0)]


DRIVER = BuildIndex
