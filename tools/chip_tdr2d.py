#!/usr/bin/env python3
"""Phase 14 of ``chip_smoke.py`` alone, after the phase-1 build and answers
it is checked against.

    python3 tools/chip_tdr2d.py

Builds the kernels, runs phase 1 (``build_index`` and ``answer_batch`` on
the smoke graph, the default ``matmul`` backend) and then
``chip_smoke.tdr2d_phase``: the legacy executor on both backends (with B1
on one legacy frontier against its plain version), the 2-D closure on
four rank processes (``nccl`` with one card each when the machine has
four or more cards, else ``gloo`` on ``cuda:0``) at the layouts 4x1, 2x2
and 1x4, and the ``tdr-1d``/``tdr-2d``/``tdr-2d-w4`` perf iterations on
256 fake ranks of the card.  Prints the card's name and power limit first
and the B1 row as a JSON line, and exits non-zero when a check fails.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        return chip_smoke.fail("no CUDA device is available")
    from repro_torch import graph, pattern, tdr_build, tdr_query
    from repro_torch.kernels import _build, ops

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions exact
    _build.library()
    g = graph.erdos_renyi(chip_smoke.N_VERTICES, chip_smoke.AVG_DEGREE,
                          chip_smoke.N_LABELS, seed=0)
    queries = chip_smoke.make_queries(pattern, g.n_vertices, g.n_labels)
    t0 = time.perf_counter()
    ops.KERNEL_LAUNCHES.clear()
    idx = tdr_build.build_index(g, tdr_build.TDRConfig())
    stats = tdr_query.QueryStats()
    answers = tdr_query.answer_batch(idx, queries, exact_mode="auto",
                                     exact_chunk=chip_smoke.EXACT_CHUNK,
                                     stats=stats)
    torch.cuda.synchronize()
    print(f"phase 1: build and answers {time.perf_counter() - t0:.3f} s; "
          f"phase-2 jobs {stats.exact_jobs}, chunks compacted="
          f"{stats.compacted_chunks} full={stats.full_chunks}, rounds="
          f"{stats.exact_rounds}; fixpoint_rounds={idx.fixpoint_rounds}")
    rows: list = []
    record = chip_smoke.make_record(torch, rows, dict(ops.KERNEL_LAUNCHES))
    t0 = time.perf_counter()
    msg = chip_smoke.tdr2d_phase(torch, g, idx, queries, answers, record)
    print(f"phase 14: {time.perf_counter() - t0:.3f} s")
    if msg:
        return chip_smoke.fail(msg)
    print(json.dumps({"kernels": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
