"""Benchmark of the PyTorch/CUDA port (``repro_torch``) on NVIDIA cards.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Runs one cell of ``BENCHMARK.json`` in this process on the card: set-up
(graph from the seed, build, warm-up), a window of ``--seconds``, then
the check of the answers against the plain reference.  The last line of
standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device`` (with ``busy_s`` and
``window_s`` when traced), ``breakdown`` when traced, and ``checks``
last: each compared number with its limit, also printed as the last lines
of standard error.  Without a card, or with fewer cards than the cell
asks for, it prints no result and exits with 2.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

T_START = time.perf_counter()

from . import harness  # noqa: E402  (the set-up clock starts above)

EXIT_NO_CARD, EXIT_FORBIDDEN = 2, 3


def cache_dirs() -> None:
    """Kernel build caches at fixed paths inside the checkout, so only the
    first run of a checkout compiles; the program's own kernel library
    lives at ``build/torch_kernels/`` of the checkout."""
    cache = harness.ROOT / "build" / "portbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    # the configuration states the engine backend; the program's own
    # override variable would replace it
    os.environ.pop("REPRO_ENGINE_BACKEND", None)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_dirs()
    bench = harness.load_benchmark()
    cell = harness.find(bench["workloads"], args.workload, "workload")
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA "
              f"card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return EXIT_NO_CARD
    out = harness.run_cell(
        args.workload, args.seed, args.seconds, bool(args.trace),
        t_start=T_START, log=lambda msg: print(msg, file=sys.stderr))
    found = harness.forbidden_modules(sys.modules)
    if found:
        print(f"portbench: the run loaded {', '.join(found)}",
              file=sys.stderr)
        return EXIT_FORBIDDEN
    for c in out.checks:
        print(f"check {c.name}: {c.value} (limit {c.limit})",
              file=sys.stderr)
    sys.stderr.flush()
    print(out.line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
