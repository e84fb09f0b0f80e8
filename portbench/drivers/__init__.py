"""How a traffic mix drives the program: the base of every driver.

A mix file names its driver (``"driver"``), and the harness loads
``drivers/<driver>.py`` by that name (``discover``); the file defines
``DRIVER``, a subclass of ``Driver``.  A driver has three steps, which
the harness times apart:

- ``setup()``: make the graph from the seed, build what the mix serves
  from, and warm every shape its traffic uses (counted in ``setup_s``);
- ``window(seconds, tracer)``: drive the program for ``seconds`` and
  record every unit of work with its host-clock times and answers; with a
  tracer, profile a steady stretch of it;
- ``release()``: free the program's state before the reference runs;
- ``checks(control)``: compare a sample of the answers drawn from the
  seed (or the index a timed build produced) with the reference; with
  ``control``, the control's answers stand in for the program's.

The drivers here: ``serve_closed_loop`` (closed-loop clients on
``QueryServer``), ``answer_batch`` (back-to-back ``answer_batch`` calls)
and ``build_index`` (back-to-back ``build_index``).
"""
from __future__ import annotations

import contextlib
import sys
import time

from portbench import discover, gen

RESULT_TIMEOUT_S = 120.0   # a request not answered by then has failed


def sync(device: str) -> None:
    if device.startswith("cuda"):
        import torch
        torch.cuda.synchronize()


class Driver:
    """State shared by the drivers: the run's configuration, mix, seed,
    device, the program adapter and what the window records.  ``pkg`` is
    the benchmark's directory, where the configuration's generator is
    found."""

    def __init__(self, prog, cfg: dict, mix: dict, seed: int, device: str,
                 pkg=discover.PKG):
        self.prog, self.cfg, self.mix = prog, cfg, mix
        self.seed, self.device, self.pkg = seed, device, pkg
        self.records: list = []
        self.n_checked = 0
        self.before: dict = {}
        self.after: dict = {}
        self.t0 = self.t_end = self.t_last = 0.0

    @contextlib.contextmanager
    def phase(self, name: str):
        """Time one step of the set-up (reported on standard error)."""
        t = time.perf_counter()
        yield
        print(f"portbench: set-up {name} {time.perf_counter() - t:.3f} s",
              file=sys.stderr)

    def make_graph(self) -> None:
        with self.phase("graph"):
            self.g = gen.make_graph(self.cfg, self.seed, self.pkg)
            self.pg = self.prog.graph(self.g)

    def build(self):
        with self.phase("build"):
            idx = self.prog.build(self.pg, self.cfg, self.device)
            sync(self.device)
        return idx

    def counters(self) -> dict:
        return self.prog.counters()

    def attempted(self) -> int:
        return len(self.records)

    def failed(self) -> int:
        return sum(1 for r in self.records if not r[-1])

    def release(self) -> None:
        """Free the program's state before the reference runs."""

    def _units(self, seconds: float, tracer, unit) -> None:
        """Run ``unit()`` back to back until ``seconds`` have passed (the
        unit in flight then finishes); with a tracer, profile the
        ``trace_units`` whole units that start first after a quarter of
        the window."""
        n_trace = self.mix.get("trace_units", 2)
        traced = 0
        self.t0 = time.perf_counter()
        self.t_end = self.t0 + seconds
        while time.perf_counter() < self.t_end:
            if tracer is not None and traced == 0 and not tracer.active \
                    and time.perf_counter() >= self.t0 + seconds / 4:
                tracer.start()
            self.records.append(unit())
            if tracer is not None and tracer.active:
                traced += 1
                if traced >= n_trace:
                    tracer.stop()
        if tracer is not None and tracer.active:
            tracer.stop()


