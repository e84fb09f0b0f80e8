#!/usr/bin/env python3
"""Phase 11 of ``chip_smoke.py`` alone, after the phase-1 build and answers
it is checked against (about a minute and a half on one H100).

    python3 tools/chip_shard.py

Builds the kernels, runs phase 1 (``build_index`` and ``answer_batch`` on
the smoke graph, the default ``matmul`` backend) and then
``chip_smoke.shard_phase``: three rank processes, ``nccl`` with one card
each when the machine has three or more cards, else ``gloo`` on
``cuda:0``.  Prints the card's name and power limit first and exits
non-zero when a check fails.  For iterating on the sharded path, and for
running it across cards, without phases 2-10.
"""
from __future__ import annotations

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
    from repro_torch.kernels import _build

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    _build.library()
    g = graph.erdos_renyi(chip_smoke.N_VERTICES, chip_smoke.AVG_DEGREE,
                          chip_smoke.N_LABELS, seed=0)
    cfg = tdr_build.TDRConfig()
    queries = chip_smoke.make_queries(pattern, g.n_vertices, g.n_labels)
    t0 = time.perf_counter()
    idx = tdr_build.build_index(g, cfg)
    stats = tdr_query.QueryStats()
    answers = tdr_query.answer_batch(idx, queries, exact_mode="auto",
                                     exact_chunk=chip_smoke.EXACT_CHUNK,
                                     stats=stats)
    torch.cuda.synchronize()
    print(f"phase 1: build and answers {time.perf_counter() - t0:.3f} s; "
          f"chunks compacted={stats.compacted_chunks} "
          f"full={stats.full_chunks}, rounds={stats.exact_rounds}")
    t0 = time.perf_counter()
    msg = chip_smoke.shard_phase(torch, cfg, idx, answers, stats)
    print(f"phase 11: {time.perf_counter() - t0:.3f} s")
    return chip_smoke.fail(msg) if msg else 0


if __name__ == "__main__":
    sys.exit(main())
