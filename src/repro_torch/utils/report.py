"""Dry-run and roofline tables from the port's dry-run JSON.

A port of ``src/repro/utils/report.py``: the same tables in the same
layout, the roofline terms in the H100's constants (``utils/roofline.py``).
MODEL_FLOPS is recomputed from the current configs (6·N_active·D for
train, 2·N_active·D forward), so a formula fix needs no new trace; the
per-rank counts come from the stored records (``launch/dryrun.py``
writes them under the reference's ``hlo`` key).

Usage: PYTHONPATH=src python -m repro_torch.utils.report \
    build/dryrun.json [build/perf_iterations.json] > tables.md
"""
from __future__ import annotations

import json
import sys

from .. import configs
from ..configs.base import SHAPES
from . import roofline as roof


def model_flops_of(arch: str, shape_name: str) -> float:
    cfg = configs.get(arch)
    sh = SHAPES[shape_name]
    n_tokens = sh.global_batch * sh.seq_len if sh.kind != "decode" \
        else sh.global_batch
    n = cfg.n_active_params()
    return (6.0 if sh.kind == "train" else 2.0) * n * n_tokens


def derive(rec: dict) -> dict:
    """Recompute roofline columns from stored per-chip counts."""
    h = rec.get("hlo")
    if not h:
        return {}
    chips = rec["chips"]
    c = h["flops_per_chip"] / roof.PEAK_FLOPS
    m = h["hbm_bytes_per_chip"] / roof.HBM_BW
    k = h["collective_bytes_per_chip"] / roof.LINK_BW
    step = max(c, m, k, 1e-12)
    dom = {c: "compute", m: "memory", k: "collective"}[max(c, m, k)]
    if rec["arch"] == "tdr-graph":
        mf = rec.get("roofline", {}).get("model_flops", 0.0)
    else:
        mf = model_flops_of(rec["arch"], rec["shape"])
    return {
        "compute_s": c, "memory_s": m, "collective_s": k, "dominant": dom,
        "model_flops": mf,
        "ratio": mf / max(h["flops_per_chip"] * chips, 1.0),
        "mfu": mf / (chips * roof.PEAK_FLOPS * step),
        "step_s": step,
    }


def dryrun_table(results: list) -> str:
    out = ["| arch | shape | mesh | chips | compile s | peak GB/chip | "
           "HLO GFLOP/chip | HBM GB/chip | coll GB/chip |",
           "|---|---|---|---|---|---|---|---|---|"]
    for r in results:
        if "skipped" in r:
            out.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | — | "
                       f"SKIP ({r['skipped']}) | — | — | — | — |")
            continue
        h = r.get("hlo", {})
        mem = r["memory"]
        peak = mem.get("peak_gb", mem.get("temp_gb", 0)
                       + mem.get("argument_gb", 0))
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | {r['chips']} | "
            f"{r.get('compile_s', '—')} | {peak:.1f} | "
            f"{h.get('flops_per_chip', 0) / 1e9:.0f} | "
            f"{h.get('hbm_bytes_per_chip', 0) / 1e9:.0f} | "
            f"{h.get('collective_bytes_per_chip', 0) / 1e9:.1f} |")
    return "\n".join(out)


def roofline_table(results: list) -> str:
    out = ["| arch | shape | compute s | memory s | collective s | "
           "dominant | MODEL_FLOPS | useful ratio | roofline MFU |",
           "|---|---|---|---|---|---|---|---|---|"]
    for r in results:
        if "skipped" in r or not r.get("hlo"):
            continue
        d = derive(r)
        if r["arch"] == "tdr-graph":
            # OR-semiring work counts no matmul FLOPs; ratio/MFU are not
            # meaningful for the engine cell
            out.append(
                f"| {r['arch']} | {r['shape']} | {d['compute_s']:.3f} | "
                f"{d['memory_s']:.3f} | {d['collective_s']:.3f} | "
                f"**{d['dominant']}** | {d['model_flops']:.2e} | — | — |")
            continue
        out.append(
            f"| {r['arch']} | {r['shape']} | {d['compute_s']:.3f} | "
            f"{d['memory_s']:.3f} | {d['collective_s']:.3f} | "
            f"**{d['dominant']}** | {d['model_flops']:.2e} | "
            f"{d['ratio']:.2f} | {d['mfu']:.4f} |")
    return "\n".join(out)


def perf_table(perf: dict) -> str:
    out = ["| iteration | compute s | memory s | collective s | "
           "dominant | MFU |", "|---|---|---|---|---|---|"]
    for name, rec in perf["iterations"].items():
        d = derive(rec) if rec.get("hlo") and rec.get("arch") else \
            rec.get("roofline", {})
        out.append(f"| {name} | {d.get('compute_s', 0):.3f} | "
                   f"{d.get('memory_s', 0):.3f} | "
                   f"{d.get('collective_s', 0):.3f} | "
                   f"{d.get('dominant')} | {d.get('mfu', 0):.4f} |")
    return "\n".join(out)


def render(results: list, perf: dict | None = None) -> str:
    """The dry-run and roofline tables of each mesh in ``results`` (and
    the perf iterations' table) as markdown."""
    parts = []
    for mesh, title in (("single", "single-pod 16×16 = 256 chips"),
                        ("multi", "multi-pod 2×16×16 = 512 chips")):
        rows = [r for r in results if r.get("mesh") == mesh]
        if rows:
            parts += [f"## Dry-run ({title})\n", dryrun_table(rows),
                      f"\n## Roofline ({title}, H100)\n",
                      roofline_table(rows)]
    if perf:
        parts += ["\n## Perf iterations\n", perf_table(perf)]
    return "\n".join(parts)


def main(argv=None) -> None:
    args = sys.argv[1:] if argv is None else argv
    path = args[0] if args else "build/dryrun.json"
    with open(path) as f:
        results = json.load(f)["results"]
    perf = None
    if len(args) > 1:
        with open(args[1]) as f:
            perf = json.load(f)
    print(render(results, perf))


if __name__ == "__main__":
    main()
