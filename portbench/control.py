"""Readings that set the limits of ``correct``: the program's and the
control's, on several seeds, at a cell's own size and load.

    python3 -m portbench.control --workload <cell> --seeds 1,2,3 \\
        --seconds 5 [--out FILE]

For each seed it runs the cell's set-up and a short window as the
benchmark does, then reads every compared number twice: from the
program's answers, and from the control's: the plain reference in the
program's place with the exactness the configurations state broken, as
the mix's ``control`` says (``check.control_answer``; a build's closures
stop short too).  One JSON line per seed.  The benchmark's own runs
never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from . import harness, program, run as run_mod


def readings(cell_name: str, seed: int, seconds: float, *,
             device: str = "cuda", config: dict | None = None,
             prog=None) -> dict:
    """``{"program": {...}, "control": {...}}`` of one seed."""
    bench = harness.load_benchmark()
    cell = harness.find(bench["workloads"], cell_name, "workload")
    cfg = config or harness.load_config(cell["config"])
    mix = harness.load_mix(cell["traffic"])
    prog = prog or program.load()
    drv = harness.load_driver(mix["driver"])(prog, cfg, mix, seed, device)
    drv.setup()
    drv.window(seconds)
    drv.release()
    got = {c.name: c.value for c in drv.checks()}
    ctl = {c.name: c.value for c in drv.checks(control=True)}
    return {"seed": seed, "checked": drv.n_checked, "program": got,
            "control": ctl}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    run_mod.cache_dirs()
    import torch
    if not torch.cuda.is_available():
        print("portbench.control: no CUDA card", file=sys.stderr)
        return run_mod.EXIT_NO_CARD
    sink = open(args.out, "a") if args.out else None
    try:
        for s in args.seeds.split(","):
            t = time.perf_counter()
            rec = readings(args.workload, int(s), args.seconds)
            rec["workload"] = args.workload
            rec["s"] = time.perf_counter() - t
            line = json.dumps(rec)
            print(line, flush=True)
            if sink:
                sink.write(line + "\n")
                sink.flush()
            torch.cuda.empty_cache()
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
