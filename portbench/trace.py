"""What a ``--trace 1`` run records, and the reduction of it.

``Tracer`` wraps, from the benchmark's side, the three kernel entry
points whose rooflines the benchmark reads (``KERNEL_ENTRIES``) and the
server's batch call (``HOST``), whose thread starts and stops the
profiler in a served window.  A name that is missing raises: a renamed
entry point must not silence a metric.  A kernel call keeps its operand
``A`` (one reference per distinct operand) and the bytes of ``X`` and of
the output, while the profiler runs.

``torch.profiler`` runs over a steady stretch of the window.  From its
events ``summarize`` takes:

- ``busy_s``: the length of the *union* of the device's kernel, copy and
  set intervals inside the traced stretch (overlapping work counts once);
- ``device_ops``: device seconds by operation name;
- ``idle_gaps``: the stretches with no device work, split by the
  innermost host operation the profiler recorded in the profiling thread
  at each moment (``host: no torch op`` where none ran), summed by name;
- per kernel name: events and device seconds.

The profiler's clock is tied to ``time.perf_counter_ns`` by a marker the
tracing thread records inside the profile.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import threading
import time

# the program's call whose thread can host the profiler: a request to
# start or stop it is carried out there, between two calls (the server's
# scheduler thread launches every served kernel, and the profiler sees
# only the device work of the thread that started it)
HOST = ("launch.serve", "QueryServer", "_serve_batch")
# kernel entry point -> the name its launches count under
KERNEL_ENTRIES = {"frontier_step": "bitset_matmul",
                  "frontier_step_lanes": "lane_matmul",
                  "frontier_step_sparse": "block_sparse_matmul"}
MARK = "portbench.mark"
TOP = 10


@dataclasses.dataclass
class KernelCalls:
    """Calls of one kernel inside the traced stretch.  ``operands`` maps an
    operand's identity to ``[operand, calls, rows]``."""
    calls: int = 0
    x_bytes: int = 0
    out_bytes: int = 0
    operands: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    device_ops: list          # [[name, seconds], ...] by device time
    idle_gaps: list           # [[host op name, seconds], ...]
    kernel_events: dict       # device kernel name -> [events, seconds]
    calls: dict               # kernel -> KernelCalls


def union_length(intervals, lo: float, hi: float) -> float:
    """Length of the union of ``(start, end)`` intervals clipped to
    ``[lo, hi]``."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals, lo: float, hi: float) -> list:
    """The stretches of ``[lo, hi]`` that no interval covers."""
    out, cur = [], lo
    for s, e in sorted(intervals):
        if s > cur:
            out.append((cur, min(s, hi)))
        cur = max(cur, e)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(s, e) for s, e in out if e > s]


NO_OP = "host: no torch op"


def timeline(ops) -> list:
    """``(start, end, name)`` of the innermost of the nested ``(name,
    start, end)`` host ops at each time, in order and without overlap."""
    out, stack, t = [], [], None
    for name, s, e in sorted(ops, key=lambda o: (o[1], -o[2])):
        while stack and stack[-1][0] <= s:
            end, inner = stack.pop()
            if end > t:
                out.append((t, end, inner))
                t = end
        if stack and s > t:
            out.append((t, s, stack[-1][1]))
        stack.append((e, name))
        t = s if t is None else max(t, s)
    while stack:
        end, inner = stack.pop()
        if end > t:
            out.append((t, end, inner))
            t = end
    return out


def idle_by_op(idle, segments) -> dict:
    """Seconds of the ``idle`` stretches under each host op of the
    ``timeline`` ``segments``; what no op covers goes to ``NO_OP``."""
    out = collections.Counter()
    j = 0
    for gs, ge in idle:
        while j < len(segments) and segments[j][1] <= gs:
            j += 1
        covered, k = 0, j
        while k < len(segments) and segments[k][0] < ge:
            a, b = max(gs, segments[k][0]), min(ge, segments[k][1])
            if b > a:
                out[segments[k][2]] += (b - a) / 1e9
                covered += b - a
            k += 1
        if ge - gs > covered:
            out[NO_OP] += (ge - gs - covered) / 1e9
    return out


def short_name(name: str, width: int = 96) -> str:
    """A device op's name without return type and template arguments."""
    name = name.removeprefix("void ")
    cut = name.find("<")
    if cut > 0:
        name = name[:cut]
    cut = name.find("(")
    if cut > 0:
        name = name[:cut]
    return name[:width]


class Tracer:
    """Kernel-call recording plus the profiler, for one run."""

    def __init__(self):
        self.active = False
        self.host_thread = None
        self._pending = None
        self._served = threading.Event()
        self.calls: dict = collections.defaultdict(KernelCalls)
        self._lock = threading.Lock()
        self._undo: list = []
        self.prof = None

    # ------------------------------------------------------------ wrappers
    def install(self, program) -> None:
        """Wrap the server's batch call and the kernel entry points; a
        missing name raises ``AttributeError``."""
        import importlib
        mod_name, cls, name = HOST
        owner = getattr(importlib.import_module(
            f"{program.package}.{mod_name}"), cls)
        self._patch(owner, name, self._host(getattr(owner, name)))
        for entry, kernel in KERNEL_ENTRIES.items():
            fn = getattr(program.ops, entry)
            self._patch(program.ops, entry, self._kernel(kernel, fn))

    def uninstall(self) -> None:
        for owner, name, fn in reversed(self._undo):
            setattr(owner, name, fn)
        self._undo.clear()

    def _patch(self, owner, name, fn) -> None:
        self._undo.append((owner, name, getattr(owner, name)))
        setattr(owner, name, fn)

    def _host(self, fn):
        tracer = self

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if tracer._pending is not None:
                tracer._carry_out()
            return fn(*args, **kwargs)
        return wrapper

    def _kernel(self, kernel: str, fn):
        tracer = self

        @functools.wraps(fn)
        def wrapper(a, x, *args, **kwargs):
            out = fn(a, x, *args, **kwargs)
            if tracer.active and out.is_cuda:
                tracer.record_call(kernel, a, x, out)
            return out
        return wrapper

    def record_call(self, kernel: str, a, x, out) -> None:
        rows = int(out.shape[0])
        key = id(a) if not hasattr(a, "data_ptr") else (
            a.data_ptr(), tuple(a.shape))
        with self._lock:
            kc = self.calls[kernel]
            kc.calls += 1
            kc.x_bytes += x.numel() * x.element_size()
            kc.out_bytes += out.numel() * out.element_size()
            entry = kc.operands.setdefault(key, [a, 0, rows])
            entry[1] += 1

    # ------------------------------------------------------------ profiler
    @staticmethod
    def prepare() -> None:
        """Initialise the profiler once in this (the main) thread: its
        device tracing registers here, and a later start in the server's
        thread then takes no set-up of its own."""
        import torch
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    def request(self, what: str, timeout: float | None = 60.0) -> None:
        """Have the hosting thread start or stop the profiler at its next
        call; wait until it has, unless ``timeout`` is None."""
        self._served.clear()
        self._pending = what
        if timeout is not None:
            self.wait(timeout)

    def wait(self, timeout: float) -> None:
        if not self._served.wait(timeout):
            raise RuntimeError(
                f"no hosting call came to {self._pending} the profiler")

    def _carry_out(self) -> None:
        what, self._pending = self._pending, None
        if what == "start":
            self.start()
        elif what == "stop":
            self.stop()
        self._served.set()

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        t = time.perf_counter()
        self.prof.__enter__()
        self.start_s = time.perf_counter() - t
        with record_function(MARK):
            self.mark_ns = time.perf_counter_ns()
        self.t_start = time.perf_counter_ns()
        self.host_thread = threading.get_ident()
        self.active = True

    def stop(self) -> None:
        import torch
        torch.cuda.synchronize()
        self.t_stop = time.perf_counter_ns()
        self.active = False
        self.prof.__exit__(None, None, None)

    def release(self) -> None:
        """Drop the operands and the profile held for the readers."""
        self.calls.clear()
        self.prof = None

    def summarize(self) -> TraceSummary:
        events = self.prof.profiler.kineto_results.events()
        offset = mark_thread = None
        device, host = [], []
        for e in events:
            thread = getattr(e, "start_thread_id", None)
            thread = thread() if thread is not None else None
            if e.name() == MARK and offset is None:
                offset = e.start_ns() - self.mark_ns
                mark_thread = thread
            elif "CUDA" in str(e.device_type()):
                device.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                               e.name()))
            elif "CPU" in str(e.device_type()):
                host.append((e.name(), e.start_ns(),
                             e.start_ns() + e.duration_ns(), thread))
        if offset is None:
            raise RuntimeError("the profile holds no clock marker")
        lo, hi = self.t_start + offset, self.t_stop + offset
        ivals = [(s, e) for s, e, _ in device]
        busy = union_length(ivals, lo, hi)
        ops = collections.Counter()
        kernels: dict = collections.defaultdict(lambda: [0, 0.0])
        for s, e, name in device:
            if e <= lo or s >= hi:
                continue
            ops[short_name(name)] += (e - s) / 1e9
            k = kernels[name]
            k[0] += 1
            k[1] += (e - s) / 1e9
        # the host ops of the thread that recorded the marker (the one
        # that launches the traced work); every thread's where the
        # profiler names none
        host = [(n, s, e) for n, s, e, t in host
                if mark_thread is None or t == mark_thread]
        idle = idle_by_op(gaps(ivals, lo, hi), timeline(host))
        return TraceSummary(
            window_s=(hi - lo) / 1e9, busy_s=busy / 1e9,
            device_ops=[[n, v] for n, v in ops.most_common(TOP)],
            idle_gaps=[[n, v] for n, v in idle.most_common(TOP)],
            kernel_events=dict(kernels), calls=dict(self.calls))
