"""What the benchmark loads and reads: never JAX or the JAX package, never
the old harness under ``benchmarks/``, and no result without the card or
without the program."""
from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

from portbench import harness

ROOT = harness.ROOT
SOURCES = sorted(p for p in harness.PKG.rglob("*.py")
                 if "tests" not in p.relative_to(harness.PKG).parts)


def imported_names(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


def test_forbidden_names_are_compared_whole():
    assert harness.forbidden_modules(
        ["repro_torch", "repro_torch.engine", "jaxtyping", "reprox",
         "numpy"]) == []
    assert harness.forbidden_modules(
        ["repro", "repro.core", "jax.numpy", "jaxlib", "flax.linen"]) == [
        "flax.linen", "jax.numpy", "jaxlib", "repro", "repro.core"]


def test_no_source_imports_jax_or_the_jax_package():
    for path in SOURCES:
        tops = {n.split(".")[0] for n in imported_names(path)}
        assert not tops & set(harness.FORBIDDEN), path


def test_the_reference_imports_nothing_of_the_program():
    for path in sorted((harness.PKG / "reference").glob("*.py")):
        tops = {n.split(".")[0] for n in imported_names(path)}
        assert tops <= {"__future__", "dataclasses", "re", "numpy"}, path
    # the generators make the inputs both sides read, from the reference's
    # graph type alone
    for path in sorted((harness.PKG / "generators").glob("*.py")):
        names = imported_names(path)
        tops = {n.split(".")[0] for n in names}
        assert tops <= {"__future__", "numpy", "portbench"}, path
        assert all(n.startswith("portbench.reference") for n in names
                   if n.startswith("portbench")), path


def test_nothing_reads_the_old_harness():
    for path in SOURCES:
        assert "benchmarks" not in path.read_text(), path


def test_a_run_loads_no_forbidden_module(tmp_path):
    """Every module a run of each cell imports, walked in a fresh
    process."""
    script = (
        "import sys, json\n"
        "from portbench import harness, run, control\n"
        "for w in harness.load_benchmark()['workloads']:\n"
        "    cfg = dict(harness.load_config(w['config']), n_vertices=256)\n"
        "    out = harness.run_cell(w['name'], 3, 0.5, False, device='cpu',\n"
        "                           config=cfg, log=lambda m: None)\n"
        "    assert out.correct, w['name']\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    mods = json.loads(res.stdout.strip().splitlines()[-1])
    assert "repro_torch.tdr_query" in mods
    assert harness.forbidden_modules(mods) == []


def test_no_card_no_result():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    res = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "er32k-matmul.serve", "--seed", str(2**31 + 1), "--seconds", "1",
         "--trace", "0"], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300)
    assert res.returncode == 2 and res.stdout.strip() == ""


def test_no_program_no_result(tmp_path):
    """A directory holding only ``BENCHMARK.json`` and the benchmark's
    files has no program to run."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.PKG, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    script = ("from portbench import harness\n"
              "out = harness.run_cell('er32k-matmul.build', 1, 0.5, False,"
              " device='cpu')\nprint(out.line())\n")
    res = subprocess.run([sys.executable, "-c", script], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode != 0 and res.stdout.strip() == ""
    assert "repro_torch" in res.stderr


def test_a_cell_runs_on_the_card(card):
    """The command as the check runs it, on a card (skips without one)."""
    res = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "er32k-matmul.build", "--seed", str(2**31 + 11), "--seconds", "3",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert list(line)[-1] == "checks"
