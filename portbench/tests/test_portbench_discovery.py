"""Cells are found by name: configurations, mixes and metric readers are
files, and ``BENCHMARK.json`` keeps to the benchmark's contract."""
from __future__ import annotations

import json
import re
import shutil

import pytest

from portbench import discover, harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = harness.load_benchmark()


def test_every_name_resolves_to_its_file():
    for c in BENCH["configs"]:
        assert (harness.ROOT / c["file"]).exists()
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert harness.load_config(c["name"])["name"] == c["name"]
        cfg = harness.load_config(c["name"])
        assert callable(discover.load("generators", cfg["generator"],
                                      "make"))
    for w in BENCH["workloads"]:
        mix = harness.load_mix(w["traffic"])
        assert isinstance(harness.load_driver(mix["driver"]), type)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(harness.load_reader(m["name"]))


def test_benchmark_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    configs = {c["name"] for c in BENCH["configs"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    used = set()
    for w in BENCH["workloads"]:
        assert w["config"] in configs and w["chips"] == 1
        assert len(w["why"]) <= 200
        used.add(w["config"])
        reported = harness.cell_metrics(BENCH, w["name"], False)
        assert "setup_s" in [m["name"] for m in reported]
        assert len(reported) >= 2
        assert harness.cell_metrics(BENCH, w["name"], True)
    assert used == configs
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", [cell])


def test_config_files_state_their_cuts():
    for c in BENCH["configs"]:
        cfg = harness.load_config(c["name"])
        assert cfg["source"] == c["source"] and len(c["source"]) <= 200
        assert cfg["reduced"] == c["reduced"]
        for key in cfg["reduced"]:
            assert key in cfg and NAME.match(key)
        assert "guarantees" in cfg and "assumed" in cfg


def test_reader_falls_back_to_the_base_name(tmp_path):
    pkg = tmp_path / "pkg"
    (pkg / "metrics").mkdir(parents=True)
    (pkg / "metrics" / "depth.py").write_text(
        "def read(run):\n    return 7.0\n")
    (pkg / "metrics" / "depth.deep.py").write_text(
        "def read(run):\n    return 9.0\n")
    assert harness.load_reader("depth.shallow", pkg)(None) == 7.0
    assert harness.load_reader("depth.deep", pkg)(None) == 9.0
    with pytest.raises(FileNotFoundError):
        harness.reader_path("absent.serve", pkg)


def test_a_new_cell_is_new_files_only(tmp_path, prog):
    """A configuration, a mix and a per-layer metric added as files, with
    entries in a ``BENCHMARK.json``, run without a change to the
    harness."""
    pkg = tmp_path / "portbench"
    shutil.copytree(harness.PKG, pkg,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    cfg = harness.load_config("er32k-matmul")
    cfg.update(name="er700-segment", n_vertices=700, backend="segment",
               reduced=["n_vertices"])
    (pkg / "configs" / "er700-segment.json").write_text(json.dumps(cfg))
    mix = harness.load_mix("batch")
    mix.update(batch=64, check=64)
    (pkg / "traffic" / "batch64.json").write_text(json.dumps(mix))
    (pkg / "metrics" / "batches.py").write_text(
        "def read(run):\n    return float(run.units)\n")
    bench = json.loads(json.dumps(BENCH))
    cell = "er700-segment.batch64"
    bench["configs"].append({"name": "er700-segment", "source": "x",
                             "file": "portbench/configs/er700-segment.json",
                             "reduced": ["n_vertices"], "why": "test"})
    bench["workloads"].append({"name": cell, "config": "er700-segment",
                               "traffic": "batch64", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] == "batch_qps":
            m["workloads"].append(cell)
    bench["per_layer"].append({"name": "batches.batch", "unit": "batches",
                               "better": "higher",
                               "source": "program_counter", "layer": "t",
                               "moves": "batch_qps", "workloads": [cell]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    out = harness.run_cell(cell, 5, 1.0, False, device="cpu", root=tmp_path,
                           pkg=pkg, prog=prog, log=lambda m: None)
    assert out.correct and out.attempted >= 64
    assert set(out.metrics) == {"batch_qps", "setup_s"}
    readers = harness.cell_metrics(bench, cell, True)
    assert [m["name"] for m in readers][-1] == "batches.batch"
    assert harness.load_reader("batches.batch", pkg) is not None


RING_GENERATOR = """
import numpy as np
from portbench.reference.graphs import from_triples


def make(cfg, seed):
    # a labelled ring with chords: every vertex reaches every other
    n, rng = cfg["n_vertices"], np.random.default_rng(seed)
    src = np.concatenate([np.arange(n), np.arange(n)])
    dst = np.concatenate([(np.arange(n) + 1) % n, (np.arange(n) * 7) % n])
    return from_triples(n, cfg["n_labels"], src, dst,
                        rng.integers(0, cfg["n_labels"], 2 * n))
"""

ONE_BY_ONE_DRIVER = """
import time

from portbench import check, gen
from portbench.drivers import Driver


class OneByOne(Driver):
    # answer_batch calls of one query each, back to back

    def setup(self):
        self.make_graph()
        self.index = self.build()

    def window(self, seconds, tracer=None):
        r = gen.rng(self.seed, gen.WINDOW)

        def unit():
            spec = gen.bool_queries(self.mix, 1, r, self.g)
            q = [self.prog.query(s, self.g.n_labels) for s in spec]
            t = time.perf_counter()
            ans = self.prog.answer_batch(self.index, q, self.cfg,
                                         self.device)
            return (spec, t, time.perf_counter(), ans.tolist(), True)

        self._units(seconds, tracer, unit)
        self.t_last = self.records[-1][2]

    def release(self):
        self.index = None

    def checks(self, control=False):
        items = [(s, a) for specs, _, _, ans, ok in self.records
                 for s, a in zip(specs, ans)]
        self.n_checked = len(items)
        wrong = check.wrong_answers(self.g, items, self.mix, control)
        return [check.Check("bool_wrong", int(wrong["bool"]), 0)]


DRIVER = OneByOne
"""


def digest(root):
    return {p.relative_to(root): p.read_bytes() for p in root.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_driver_and_generator_are_new_files_only(tmp_path, prog):
    """A driver and a graph generator added as files, named by a new mix
    and a new configuration, run without a change to any file there."""
    pkg = tmp_path / "portbench"
    shutil.copytree(harness.PKG, pkg,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = digest(pkg)
    (pkg / "generators" / "ring_chords.py").write_text(RING_GENERATOR)
    (pkg / "drivers" / "one_by_one.py").write_text(ONE_BY_ONE_DRIVER)
    cfg = dict(harness.load_config("er32k-matmul"), name="ring300",
               generator="ring_chords", n_vertices=300, backend="segment")
    (pkg / "configs" / "ring300.json").write_text(json.dumps(cfg))
    mix = dict(harness.load_mix("batch"), driver="one_by_one")
    (pkg / "traffic" / "one_by_one.json").write_text(json.dumps(mix))
    bench = json.loads(json.dumps(BENCH))
    cell = "ring300.one_by_one"
    bench["configs"].append({"name": "ring300", "source": "x",
                             "file": "portbench/configs/ring300.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": cell, "config": "ring300",
                               "traffic": "one_by_one", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] == "batch_qps":
            m["workloads"].append(cell)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    after = digest(pkg)
    assert {k: v for k, v in after.items() if k in before} == before
    assert len(after) == len(before) + 4
    out = harness.run_cell(cell, 2**33 + 1, 0.5, False, device="cpu",
                           root=tmp_path, pkg=pkg, prog=prog,
                           log=lambda m: None)
    assert out.correct and out.attempted > 1
    assert [c.name for c in out.checks] == ["bool_wrong"]
    assert set(out.metrics) == {"batch_qps", "setup_s"}
    with pytest.raises(FileNotFoundError):
        harness.load_driver("absent", pkg)
