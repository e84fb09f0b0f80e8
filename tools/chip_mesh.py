#!/usr/bin/env python3
"""Phase 13 of ``chip_smoke.py`` alone: the LM mesh layer on the card.

    python3 tools/chip_mesh.py

Prints the card's name and power limit first, then
``chip_smoke.mesh_phase``: phi3-mini-3.8b at its published widths (4
layers, seq_len 4,096, batch 2) for two train steps and one decode step
on a 1x1 ``DeviceMesh`` against the unmeshed port, the port's dry-run of
phi3-mini-3.8b x train_4k / decode_32k and ``tdr-graph`` on 256 fake
ranks of the card, and, with four cards, the 2x2 figure.  Exits non-zero
when a check fails.  Builds no kernel: the LM path has none.
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
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    msg = chip_smoke.mesh_phase(torch, {})
    print(f"phase 13: {time.perf_counter() - t0:.3f} s")
    return chip_smoke.fail(msg) if msg else 0


if __name__ == "__main__":
    sys.exit(main())
