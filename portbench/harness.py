"""One run of one cell: discovery by name, set-up, window, readers, check.

Everything a cell is made of is found by the names ``BENCHMARK.json``
gives it (``discover``):

- ``configs/<config>.json``: the deployment (its ``generator``, graph,
  build and engine settings, backend), with its source and cuts;
- ``generators/<generator>.py``: ``make(cfg, seed)``, the graph;
- ``traffic/<traffic>.json``: the mix's parameters and its ``driver``;
- ``drivers/<driver>.py``: ``DRIVER``, how the mix drives the program;
- ``metrics/<metric>.py``: one reader per metric, ``read(run) -> float |
  None``; a name ``base.suffix`` falls back to ``metrics/<base>.py``.

So a new configuration, generator, mix, driver or metric is a new file
and an entry in ``BENCHMARK.json``; nothing here changes.
"""
from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path

from . import discover

PKG = discover.PKG
ROOT = PKG.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def find(items: list, name: str, what: str) -> dict:
    for it in items:
        if it["name"] == name:
            return it
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def load_config(name: str, pkg: Path = PKG) -> dict:
    return json.loads((Path(pkg) / "configs" / f"{name}.json").read_text())


def load_mix(name: str, pkg: Path = PKG) -> dict:
    return json.loads((Path(pkg) / "traffic" / f"{name}.json").read_text())


def reader_path(name: str, pkg: Path = PKG) -> Path:
    """``metrics/<name>.py``, else ``metrics/<base>.py`` for
    ``<base>.<suffix>``."""
    return discover.path_of("metrics", name, pkg, fallback=True)


def load_reader(name: str, pkg: Path = PKG):
    return discover.load("metrics", name, "read", pkg, fallback=True)


def load_driver(name: str, pkg: Path = PKG):
    """The driver class ``drivers/<name>.py`` defines."""
    return discover.load("drivers", name, "DRIVER", pkg)


def cell_metrics(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a cell reports: its end-to-end ones in a ``--trace 0``
    run, its per-layer ones in a ``--trace 1`` run.  A metric with a
    ``workloads`` key names its cells; a per-layer one without it goes
    wherever the end-to-end metric it moves is reported."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in moved
                             else [])]


@dataclasses.dataclass
class Run:
    """What the readers read: the cell, the driver's records and counter
    snapshots, the set-up time and, in a traced run, the trace."""
    cell: dict
    config: dict
    mix: dict
    seconds: float
    setup_s: float
    driver: object          # a drivers.Driver
    trace: object = None

    @property
    def records(self) -> list:
        return self.driver.records

    @property
    def delta(self) -> dict:
        b, a = self.driver.before, self.driver.after
        return {k: a[k] - b.get(k, 0) for k in a
                if isinstance(a[k], (int, float))}

    @property
    def units(self) -> int:
        """Completed units of work in the window (requests, batches or
        builds)."""
        return sum(1 for r in self.records if r[-1])


@dataclasses.dataclass
class Outcome:
    correct: bool
    attempted: int
    failed: int
    metrics: dict
    device: dict
    checks: list
    breakdown: dict | None = None

    def line(self) -> str:
        out = {"correct": self.correct, "attempted": self.attempted,
               "failed": self.failed, "metrics": self.metrics,
               "device": self.device}
        if self.breakdown is not None:
            out["breakdown"] = self.breakdown
        out["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                         for c in self.checks}
        return json.dumps(out)


def device_info(device: str) -> dict:
    import torch
    if not device.startswith("cuda"):
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}


def forbidden_modules(modules) -> list[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted({m for m in modules if m.split(".")[0] in FORBIDDEN})


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", t_start: float | None = None,
             root: Path = ROOT, pkg: Path = PKG, config: dict | None = None,
             prog=None, log=print) -> Outcome:
    """Run one cell end to end and return its outcome.  ``config``
    replaces the cell's configuration (the tests' small graphs) and
    ``prog`` the program adapter."""
    from . import program
    t_start = time.perf_counter() if t_start is None else t_start
    bench = load_benchmark(root)
    cell = find(bench["workloads"], cell_name, "workload")
    cfg = config or load_config(cell["config"], pkg)
    mix = load_mix(cell["traffic"], pkg)
    wanted = cell_metrics(bench, cell_name, trace)
    readers = {m["name"]: load_reader(m["name"], pkg) for m in wanted}
    t = time.perf_counter()
    prog = prog or program.load(root)
    log(f"portbench: set-up import {time.perf_counter() - t:.3f} s")
    if device.startswith("cuda"):
        import torch
        t = time.perf_counter()
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats()
        log(f"portbench: set-up cuda {time.perf_counter() - t:.3f} s")
    drv = load_driver(mix["driver"], pkg)(prog, cfg, mix, seed, device,
                                          pkg)
    tracer = None
    if trace:
        from .trace import Tracer
        tracer = Tracer()
        if device.startswith("cuda"):
            tracer.prepare()
        tracer.install(prog)
    try:
        drv.setup()
        setup_s = time.perf_counter() - t_start
        log(f"portbench: {cell_name} seed {seed}: set-up {setup_s:.3f} s")
        drv.window(seconds, tracer)
        dev = device_info(device)
        summary = None
        if tracer is not None:
            log(f"portbench: profiler start {tracer.start_s:.3f} s")
            summary = tracer.summarize()
        run = Run(cell, cfg, mix, seconds, setup_s, drv, summary)
        metrics = {}
        for m in wanted:
            val = readers[m["name"]](run)
            if val is not None:
                metrics[m["name"]] = {"value": val, "unit": m["unit"]}
        if summary is not None:
            summary.calls = {}      # the operands the readers needed
    finally:
        if tracer is not None:
            tracer.uninstall()
    breakdown = None
    if summary is not None:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
        breakdown = {"device_ops": summary.device_ops,
                     "idle_gaps": summary.idle_gaps}
        tracer.release()
    drv.release()
    if device.startswith("cuda"):
        import torch
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks = drv.checks()
    log(f"portbench: checked {drv.n_checked} answers in "
        f"{time.perf_counter() - t_check:.3f} s")
    return Outcome(correct=all(c.ok for c in checks),
                   attempted=drv.attempted(), failed=drv.failed(),
                   metrics=metrics, device=dev, checks=checks,
                   breakdown=breakdown)
