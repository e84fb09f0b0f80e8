#!/usr/bin/env python3
"""Phase 12 of ``chip_smoke.py`` alone: the LM substrate on one card.

    python3 tools/chip_lm.py

Prints the card's name and power limit first, then
``chip_smoke.lm_phase``: the 8 reduced archs on the card against the
CPU, phi3-mini-3.8b at its published widths (4 layers, seq_len 4,096,
batch 2) through ``train_loop``, prefill and decode, and the restart
check.  Exits non-zero when a check fails.  Builds no kernel: the LM
path has none.
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
    msg = chip_smoke.lm_phase(torch)
    print(f"phase 12: {time.perf_counter() - t0:.3f} s")
    return chip_smoke.fail(msg) if msg else 0


if __name__ == "__main__":
    sys.exit(main())
