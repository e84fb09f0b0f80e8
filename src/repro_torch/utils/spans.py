"""Named spans over the port's host work, and the host reads of round-loop
flags.

``span(name, into=None, field=None)`` times a block of host work.  It takes
its start and end from ``time.perf_counter_ns`` and, given a stats object
and one of its float fields, adds the seconds there (``QueryStats.phase1_s``,
``ServeStats.batch_s``, ``BuildStats.dfs_s`` ...).  Only while
``torch.profiler`` runs does it also record ``repro_torch.<name>`` as a
plain CPU op (``_RecordFunctionFast``).  That op is no user annotation, so
the profiler makes no device-side event of it: a span names the host time
it covers in a trace and never counts as device work.  With no profiler
running a span costs one clock pair and one add.

``Syncs`` counts the host reads of a round loop's flags (each one waits
for the device's queued work) and the seconds the host waited in them;
each read is a span named ``sync``.  A loop returns its ``Syncs`` beside
its round count.

Span names are literals; the profiler's name of each is made once.
"""
from __future__ import annotations

import time

import torch
import torch.autograd.profiler as autograd_profiler

PREFIX = "repro_torch."
_NAMES: dict[str, str] = {}     # span name -> the profiler's op name


def _open_op(name: str):
    """Open the profiler's op of span ``name``."""
    full = _NAMES.get(name)
    if full is None:
        full = _NAMES.setdefault(name, PREFIX + name)
    op = torch._C._profiler._RecordFunctionFast(full)
    op.__enter__()
    return op


class span:
    """``with span(name, into, field) as s:`` times the block; ``s.seconds``
    holds its length once it ends, and ``into.field`` has grown by it."""

    __slots__ = ("name", "into", "field", "seconds", "_t0", "_op")

    def __init__(self, name: str, into=None, field: str | None = None):
        self.name, self.into, self.field = name, into, field
        self.seconds = 0.0
        self._op = None

    def __enter__(self) -> "span":
        if autograd_profiler._is_profiler_enabled:
            self._op = _open_op(self.name)
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.seconds = (time.perf_counter_ns() - self._t0) * 1e-9
        if self._op is not None:
            self._op.__exit__(None, None, None)
            self._op = None
        if self.into is not None:
            setattr(self.into, self.field,
                    getattr(self.into, self.field) + self.seconds)
        return False


class Syncs:
    """The host reads of one loop's flags: ``n`` of them, ``wait_s``
    seconds spent in them."""

    __slots__ = ("n", "wait_s")

    def __init__(self):
        self.n, self.wait_s = 0, 0.0

    def read(self, flags: torch.Tensor):
        """``flags.tolist()``, the loop's host sync, timed and counted."""
        with span("sync", self, "wait_s"):
            out = flags.tolist()
        self.n += 1
        return out
