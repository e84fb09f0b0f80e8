"""The plain reference and the generator, on small graphs on the CPU.

The reference imports nothing of the program; these tests hold it against
the program's own oracles and builds, which is where a reference that
drifted from the system's semantics would show."""
from __future__ import annotations

import collections

import numpy as np
import pytest

from portbench import check, discover, gen, harness
from portbench.reference import pcr, rpq, tdr

V, L = 300, 6
erdos_renyi = discover.load("generators", "erdos_renyi", "erdos_renyi")


@pytest.fixture(scope="module")
def pair(prog):
    g = erdos_renyi(V, 2.0, L, seed=11)
    return g, prog.graph(g)


def test_generator_equals_the_program_generator(prog):
    for seed in (0, 7, 2**31 + 5):
        g = erdos_renyi(1000, 4.0, 16, seed)
        pg = prog.graph_mod.erdos_renyi(1000, 4.0, 16, seed=seed)
        assert np.array_equal(g.indptr, pg.indptr)
        assert np.array_equal(g.indices, pg.indices)
        assert np.array_equal(g.labels, pg.labels)


def test_same_seed_same_inputs(pair):
    g, _ = pair
    mix = harness.load_mix("serve")
    a = gen.requests(mix, 96, gen.rng(2**40 + 3, 3), g,
                     gen.kind_shares(mix, 10))
    b = gen.requests(mix, 96, gen.rng(2**40 + 3, 3), g,
                     gen.kind_shares(mix, 10))
    c = gen.requests(mix, 96, gen.rng(2**40 + 4, 3), g,
                     gen.kind_shares(mix, 10))
    assert a == b and a != c


def test_mix_is_dealt_in_exact_blocks():
    mix = harness.load_mix("serve")
    g = erdos_renyi(5000, 4.0, 16, seed=2)
    reqs = gen.requests(mix, 320, gen.rng(1, 3), g,
                        gen.kind_shares(mix, 10))
    kinds = collections.Counter(r[0] for r in reqs)
    assert kinds == {"bool": 240, "dist": 30, "rpq": 30, "witness": 10,
                     "count": 10}
    for r in reqs:
        if r[0] in ("witness", "count"):
            assert r[3] in ("all_of", "none_of")
        if r[0] != "rpq":
            assert len(set(r[4])) == mix["family_labels"][r[3]]
    big = gen.kind_shares(mix, 800_000)
    assert "count" not in big and big["bool"] == 25
    batch = harness.load_mix("batch")
    qs = gen.bool_queries(batch, 512, gen.rng(9, 3), g)
    assert collections.Counter(q[3] for q in qs) == {
        "all_of": 128, "any_of": 128, "none_of": 128, "lcr": 128}


def test_pcr_reference_equals_the_program_oracle(pair, prog):
    g, pg = pair
    dfs = __import__(f"{prog.package}.dfs_baseline",
                     fromlist=["answer_pcr"])
    mix = dict(harness.load_mix("serve"), family_labels={
        "all_of": 2, "any_of": 3, "none_of": 2, "or_not": 3, "lcr": 2})
    fams = {"all_of": 1, "any_of": 1, "none_of": 1, "or_not": 1, "lcr": 1}
    specs = gen._pattern_specs(gen.rng(3), "bool",
                               gen.dealt(gen.rng(4), fams, 200), mix, g)
    specs.append(("bool", 5, 5, "all_of", (1, 2)))
    specs.append(("bool", 5, 5, "none_of", (1, 2)))
    for _, u, v, fam, labs in specs:
        p = prog.pattern(fam, labs, L)
        assert pcr.reach(g, u, v, fam, labs) == dfs.answer_pcr(pg, u, v, p)
        assert pcr.distance(g, u, v, fam, labs) == \
            dfs.shortest_pcr(pg, u, v, p)
        if fam in ("all_of", "none_of", "lcr"):
            assert pcr.count_walks(g, u, v, fam, labs, hops=4, cap=50) == \
                dfs.count_routes(pg, u, v, p, hops=4, cap=50)


def test_witness_check_accepts_only_shortest_valid_paths(pair):
    g, _ = pair
    keys = g.edge_keys()
    src = g.src
    e = 0
    u, v, lab = int(src[e]), int(g.indices[e]), int(g.labels[e])
    path = [(u, v, lab)]
    assert pcr.distance(g, u, v, "any_of", (lab,)) == 1
    assert pcr.check_witness(g, keys, u, v, "any_of", (lab,), path)
    assert not pcr.check_witness(g, keys, u, v, "any_of", (lab,), None)
    bad = [(u, v, (lab + 1) % L)]
    if pcr.distance(g, u, v, "any_of", ((lab + 1) % L,)) != 1 or \
            (u * V + v) * L + (lab + 1) % L not in set(keys.tolist()):
        assert not pcr.check_witness(g, keys, u, v, "any_of", (lab,), bad)


def test_rpq_reference_equals_the_program_oracle(pair, prog):
    g, pg = pair
    dfs = __import__(f"{prog.package}.dfs_baseline",
                     fromlist=["answer_rpq"])
    mix = harness.load_mix("serve")
    r = gen.rng(5)
    tmpl = gen.dealt(r, {i: t["weight"] for i, t in enumerate(mix["rpq"])},
                     240)
    specs = gen._rpq_specs(r, [mix["rpq"][i] for i in tmpl], mix, g)
    for _, u, v, text, _ in specs:
        assert rpq.reach(g, u, v, text) == \
            dfs.answer_rpq(pg, u, v, prog.rpq.parse(text)), text


def test_walk_endpoints_are_joined_by_a_matching_route():
    """A walk-drawn pair has a route of its pattern within the walk's
    hops (so a count is not 0) or a path spelling its regex; the serve
    mix gets true rpq answers and non-zero counts beyond the nullable
    ones."""
    g = erdos_renyi(2000, 4.0, 16, seed=5)
    mix = harness.load_mix("serve")
    walk = mix["walk_endpoints"]
    r = gen.rng(8)
    found = 0
    for fam, labs in [("all_of", (1, 2)), ("none_of", (3, 4))] * 20:
        got = gen.walk_pattern(r, g, fam, labs, walk["count"])
        if got is not None:
            found += 1
            assert pcr.count_walks(g, *got, fam, labs, cap=10**6,
                                   hops=walk["count"]["max_hops"]) >= 1
    assert found >= 30
    found = 0
    for t in [t for t in mix["rpq"] if t.get("walk")] * 10:
        text = t["regex"].format(1, 2, 3, 4, L=16)
        got = gen.walk_regex(r, g, text, walk["rpq"])
        if got is not None:
            found += 1
            assert rpq.reach(g, *got, text)
    assert found >= 20
    reqs = gen.requests(mix, 640, gen.rng(3, 3), g, gen.kind_shares(mix, 10))
    rpqs = [q for q in reqs if q[0] == "rpq" and q[1] != q[2]]
    counts = [q for q in reqs if q[0] == "count"]
    assert sum(rpq.reach(g, q[1], q[2], q[3]) for q in rpqs) >= \
        len(rpqs) // 3
    assert sum(check.reference_answer(g, q, mix) > 0 for q in counts) >= \
        len(counts) // 2


def test_index_planes_equal_a_program_build(pair, prog):
    g, pg = pair
    cfg = harness.load_config("er32k-matmul")
    for backend in ("segment", "matmul"):
        idx = prog.build(pg, dict(cfg, backend=backend), "cpu")
        want = tdr.build_planes(g, cfg["tdr_config"])
        for name in tdr.PLANES:
            assert tdr.equal(getattr(idx, name).numpy(), want[name]), name
        assert idx.fixpoint_rounds == want["fixpoint_rounds"]
    cut = tdr.build_planes(g, cfg["tdr_config"],
                           rounds_cut=want["fixpoint_rounds"] - 2)
    assert any(not tdr.equal(want[n], cut[n]) for n in tdr.PLANES)


def test_controls_come_out_not_correct(small, prog):
    """The control (the reference cut short) fails a number of every
    cell, where the program's answers pass."""
    from portbench import control
    for cell, n in (("er32k-matmul.batch", 4096),
                    ("er32k-matmul.build", 1024),
                    ("er32k-matmul.serve", 2048)):
        rec = control.readings(cell, 21, 1.0, device="cpu",
                               config=small(cell.split(".")[0], n),
                               prog=prog)
        assert not any(rec["program"].values()), rec
        assert any(rec["control"].values()), rec
        assert set(rec["control"]) == set(rec["program"])
        if cell.endswith(".serve"):
            assert rec["control"]["rpq_wrong"] > 0, rec
            assert rec["control"]["count_wrong"] > 0, rec


def test_dry_run_of_each_mix(small, prog):
    for w in harness.load_benchmark()["workloads"]:
        out = harness.run_cell(w["name"], 2**31 + 99, 1.0, False,
                               device="cpu", config=small(w["config"]),
                               prog=prog, log=lambda m: None)
        assert out.correct, (w["name"], out.checks)
        assert out.attempted > 0 and out.failed == 0
        assert "setup_s" in out.metrics and len(out.metrics) >= 2
        assert list(out.line().split('"checks"')[0]) and \
            out.line().rstrip("}").count('"checks"') == 1
        assert check.Check("x", 0, 0).ok and not check.Check("x", 1, 0).ok
