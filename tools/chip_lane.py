#!/usr/bin/env python3
"""B4 (``lane_matmul``) at every shape the port runs it, here or beside
another tree of the port.

    python3 tools/chip_lane.py               # this tree, once
    python3 tools/chip_lane.py OTHER_TREE    # OTHER, this, this, OTHER

Each run is a process of its own that builds the kernels of one tree
(``TREE/src/repro_torch``, into ``TREE/build/torch_kernels``), builds the
smoke graph's index on the card, runs ``dist_batch`` over the smoke run's
128 distance queries for the main-path operand (``lane_matmul`` call 200),
and then ``chip_smoke.lane_rows``: B4 on that operand, in
``Engine.propagate(sr=COUNT)`` and ``Engine.closure(sr=DIST8)`` over 256
sources on the full adjacency, and at 4096 x 4096, each against its plain
version.  With OTHER_TREE (for example a ``git archive`` of the parent
commit unpacked under ``build/``) the runs go in the order OTHER, this,
this, OTHER on the same card, and the last lines are each row's times
per run and the ``kernels`` rows of every run as JSON.  Prints the card's
name and power limit first; exits non-zero when a run fails.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


def one(tree: Path, out: Path) -> int:
    """One run on ``tree``'s port; writes its ``kernels`` rows to ``out``."""
    sys.path.insert(0, str(tree / "src"))
    import torch
    if not torch.cuda.is_available():
        return chip_smoke.fail("no CUDA device is available")
    from repro_torch import engine, graph, pattern, tdr_build, tdr_query
    from repro_torch.kernels import _build, ops

    torch.backends.cuda.matmul.allow_tf32 = False
    lib = _build.library()
    print(f"{tree}: kernel build {lib.build_seconds:.3f} s nvcc")
    g = graph.erdos_renyi(chip_smoke.N_VERTICES, chip_smoke.AVG_DEGREE,
                          chip_smoke.N_LABELS, seed=0)
    idx = tdr_build.build_index(g, tdr_build.TDRConfig())
    dq = chip_smoke.make_queries(pattern, g.n_vertices, g.n_labels, seed=1,
                                 per_family=chip_smoke.N_DIST_PER_FAMILY)
    spied = {"n": 0}
    lanes_fn = ops.frontier_step_lanes

    def spy(a, x, **kw):   # observes one call's operands; computes nothing
        spied["n"] += 1
        if spied["n"] == chip_smoke.SPY_CALL or "a" not in spied:
            spied["a"], spied["x"] = a, x
        return lanes_fn(a, x, **kw)

    ops.frontier_step_lanes = spy
    ops.KERNEL_LAUNCHES.clear()
    try:
        tdr_query.dist_batch(idx, dq, exact_chunk=chip_smoke.EXACT_CHUNK)
        torch.cuda.synchronize()
    finally:
        ops.frontier_step_lanes = lanes_fn
    n_dist = ops.KERNEL_LAUNCHES["lane_matmul"]
    rows: list = []
    record = chip_smoke.make_record(torch, rows, {})
    eng_s = engine.make_engine(g, backend="segment", device=idx.device)
    msg = chip_smoke.lane_rows(torch, g, idx.engine(), eng_s, spied["a"],
                               spied["x"], n_dist, record, rows)
    out.write_text(json.dumps(rows))
    return chip_smoke.fail(msg) if msg else 0


def main() -> int:
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    other = [Path(a).resolve() for a in sys.argv[1:2]]
    trees = [other[0], ROOT, ROOT, other[0]] if other else [ROOT]
    out_dir = ROOT / "build" / "chip_lane"
    out_dir.mkdir(parents=True, exist_ok=True)
    runs = []
    for i, tree in enumerate(trees):
        out = out_dir / f"run{i}.json"
        out.unlink(missing_ok=True)
        rc = subprocess.run([sys.executable, __file__, "--one", str(tree),
                             str(out)]).returncode
        if rc != 0:
            return chip_smoke.fail(f"run {i} on {tree} exited {rc}")
        runs.append((tree, json.loads(out.read_text())))
    print("B4 ms per run (" + ", ".join(
        "this" if t == ROOT else "other" for t, _ in runs) + "):")
    for k, r in enumerate(runs[0][1]):
        print(f"  {r['name']}: " + " / ".join(
            f"{rows[k]['ms']:.4f}" for _, rows in runs)
            + f"; bound {r['bound_ms']:.4f}")
    print(json.dumps({"runs": [{"tree": str(t), "kernels": rows}
                               for t, rows in runs]}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--one"]:
        sys.exit(one(Path(sys.argv[2]), Path(sys.argv[3])))
    sys.exit(main())
