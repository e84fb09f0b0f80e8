"""The port's replicated serving tier against the JAX package's: the
log-tailing follower (``QueryServer.follow``), ``launch.fleet`` and
``launch.router``.

Twins of the reference's follower tests (``tests/test_fleet.py``) on
both backends, held against the port's DFS oracle and against the
reference's follower on the same store at the same LSN; stores written
by one package and tailed by the other; the follower's degraded path
under an injected ``update_index`` fault; router placement, wire
messages and re-dispatch against the reference's router on the same
members; and the multi-process smoke ``tests/torch_fleet_check.py``.
Every wait has a deadline, and a fixture stops every server a test
starts.
"""
import os
import subprocess
import sys
import threading
import time
from concurrent.futures import Future

import numpy as np
import pytest
import torch

from repro.core import graph as RG, pattern as RP, rpq as RR
from repro.core import tdr_build as RB
from repro.launch import fleet as rfleet, router as rrouter, serve as rserve
from repro_torch import dfs_baseline, graph as G, pattern as pat, rpq
from repro_torch import tdr_build
from repro_torch.launch import fleet, router, serve

CFG = tdr_build.TDRConfig(vtx_bits=64, g_max=4, k=3)
RCFG = RB.TDRConfig(vtx_bits=64, g_max=4, k=3)
N_V, N_L = 24, 4
WAIT_S = 120


@pytest.fixture
def servers():
    """Register each server a test makes; every one is stopped (without
    draining) at teardown, tail thread included."""
    live = []
    yield lambda srv: live.append(srv) or srv
    for srv in live:
        t = threading.Thread(target=srv.stop, kwargs={"drain": False},
                             daemon=True)
        t.start()
        t.join(WAIT_S)
        assert not t.is_alive(), "a server did not stop"


def _wait_until(pred, what, timeout=WAIT_S):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.005)


def _queries(rng, n=6):
    qs = []
    for i in range(n):
        u, v = int(rng.integers(N_V)), int(rng.integers(N_V))
        labs = rng.choice(N_L, size=2, replace=False).tolist()
        qs.append((u, v, [pat.all_of(labs), pat.any_of(labs),
                          pat.none_of(labs),
                          pat.parse(f"l{labs[0]} & !l{labs[1]}")][i % 4]))
    return qs


def _step(rng, g):
    """One update batch of inserts, deletions and label changes."""
    edges = list(zip(g.src.tolist(), g.indices.tolist(),
                     g.labels.tolist()))
    add, rem = [], []
    for _ in range(int(rng.integers(1, 4))):
        kind = int(rng.integers(4))
        if kind <= 1 or not edges:
            u, v = int(rng.integers(N_V)), int(rng.integers(N_V))
            if u != v:
                add.append((u, v, int(rng.integers(N_L))))
        else:
            u, v, lab = edges[int(rng.integers(len(edges)))]
            rem.append((u, v, lab))
            if kind == 3:
                add.append((u, v, (lab + 1) % N_L))
    return add, rem


def _ask(srv, qs, lsn, P=pat):
    """Every query through ``srv`` once it reached ``lsn``: ``(answers,
    stamped lsns)``.  ``P`` is the pattern module of the server's
    package (queries travel as pattern text, as on the wire)."""
    assert srv.wait_for_lsn(lsn, timeout=WAIT_S), \
        f"follower stuck below lsn {lsn}"
    got = [srv.submit(u, v, P.parse(pat.unparse(p)),
                      with_lsn=True).result(timeout=WAIT_S)
           for u, v, p in qs]
    return [a for a, _ in got], [s for _, s in got]


def _ref_follower(d, servers):
    srv = servers(rserve.QueryServer.follow(d, backend="segment",
                                            poll_s=0.01))
    return srv.start()


# ------------------------------------------------- in-process follower
@pytest.mark.parametrize("backend", ["segment", "matmul"])
def test_follower_tails_and_stamps_exact_lsn(backend, tmp_path, servers):
    """A ``QueryServer.follow`` replica over a shared store applies the
    writer's published sequence, answers with the oracle of the graph
    *at its stamped read LSN* (and as the reference's follower on the
    same store does), blocks consistent reads via ``wait_for_lsn``, and
    refuses local writes."""
    d = str(tmp_path / "store")
    rng = np.random.default_rng(3)
    g = G.random_graph("er", N_V, 2.0, N_L, seed=3)
    idx = tdr_build.build_index(g, CFG, backend=backend, device="cpu")
    fleet.init_store(idx, d)
    writer = fleet.FleetWriter(d, device="cpu")
    srv = servers(serve.QueryServer.follow(d, backend=backend,
                                           poll_s=0.01, device="cpu"))
    srv.start()
    ref = _ref_follower(d, servers)
    try:
        with pytest.raises(RuntimeError):
            srv.submit_update([(0, 1, 0)], [])
        graphs = [g]
        qs = _queries(rng)
        for step in range(4):
            add = []
            for _ in range(2):
                u, v = int(rng.integers(N_V)), int(rng.integers(N_V))
                if u != v:
                    add.append((u, v, int(rng.integers(N_L))))
            lsn = writer.publish(add, [])
            graphs.append(writer.graph)
            got, at = _ask(srv, qs, lsn)
            want, ref_at = _ask(ref, qs, lsn, RP)
            assert at == [lsn] * len(qs) and ref_at == at
            assert got == want, (step, got, want)
            assert got == [dfs_baseline.answer_pcr(graphs[lsn], u, v, p)
                           for u, v, p in qs], step
        assert srv.stats.applied_lsn == writer.last_lsn
        assert srv.index.device == torch.device("cpu")
    finally:
        writer.close()


@pytest.mark.parametrize("backend", ["segment", "matmul"])
def test_follower_survives_writer_compaction(backend, tmp_path, servers):
    """The writer checkpoints + compacts; a follower that attaches after
    the compaction picks the new snapshot, and one that is behind the
    compaction point re-bootstraps from it (``LogCompactedPast`` →
    ``_refollow``) and keeps serving — both as the reference's follower
    does."""
    d = str(tmp_path / "store")
    g = G.random_graph("er", N_V, 2.0, N_L, seed=5)
    idx = tdr_build.build_index(g, CFG, backend=backend, device="cpu")
    fleet.init_store(idx, d)
    writer = fleet.FleetWriter(d, device="cpu")
    behind = servers(serve.QueryServer.follow(d, backend=backend,
                                              poll_s=0.01, device="cpu"))
    try:
        for i in range(3):
            writer.publish([(i, i + 10, i % N_L)], [])
        cur = tdr_build.build_index(writer.graph, CFG, layout=idx.disc,
                                    backend=backend, device="cpu")
        assert writer.checkpoint(cur) == 3
        # the log is truncated only up to the *previous* snapshot (kept
        # as a corruption fallback): the base advances next checkpoint
        assert writer.log.base_lsn == 0
        for i in range(3):
            writer.publish([(i + 3, i + 13, i % N_L)], [])
        cur = tdr_build.build_index(writer.graph, CFG, layout=idx.disc,
                                    backend=backend, device="cpu")
        assert writer.checkpoint(cur) == 6
        assert writer.log.base_lsn == 3     # records <= 3 really dropped
        srv = servers(serve.QueryServer.follow(d, backend=backend,
                                               poll_s=0.01, device="cpu"))
        srv.start()
        # the stopped follower's cursor (lsn 0) predates the log base
        behind.start()
        ref = _ref_follower(d, servers)
        lsn = writer.publish([(20, 21, 0)], [])
        qs = [(20, 21, pat.any_of([0])), (0, 21, pat.all_of([0, 1])),
              (3, 16, pat.none_of([2]))]
        want = [dfs_baseline.answer_pcr(writer.graph, u, v, p)
                for u, v, p in qs]
        for s, P in ((srv, pat), (behind, pat), (ref, RP)):
            got, at = _ask(s, qs, lsn, P)
            assert at == [lsn] * len(qs) and got == want
        assert want[0] is True
        assert behind.stats.applied_lsn == lsn
    finally:
        writer.close()


@pytest.mark.parametrize("writer_pkg", ["port", "reference"])
def test_store_crosses_packages(writer_pkg, tmp_path, servers):
    """A store made by one package's ``init_store`` and ``FleetWriter``
    is tailed by both packages' followers, whose answers are equal (and
    the oracle's) at every LSN; the other package's writer then attaches
    to the store and reconstructs the same graph."""
    d = str(tmp_path / "store")
    rng = np.random.default_rng(21)
    g = G.random_graph("er", N_V, 2.0, N_L, seed=21)
    if writer_pkg == "port":
        fleet.init_store(tdr_build.build_index(g, CFG, device="cpu"), d)
        writer = fleet.FleetWriter(d, device="cpu")
    else:
        rg = RG.random_graph("er", N_V, 2.0, N_L, seed=21)
        rfleet.init_store(RB.build_index(rg, RCFG), d)
        writer = rfleet.FleetWriter(d)
    port = servers(serve.QueryServer.follow(d, backend="matmul",
                                            poll_s=0.01, device="cpu"))
    port.start()
    ref = _ref_follower(d, servers)
    qs = _queries(rng, 8)
    graphs = [g]
    try:
        for step in range(5):
            if step:
                add, rem = _step(rng, graphs[-1])
                lsn = writer.publish(add, rem)
                graphs.append(graphs[-1].apply_updates(add, rem).graph)
            else:
                lsn = 0
            got, at = _ask(port, qs, lsn)
            want, ref_at = _ask(ref, qs, lsn, RP)
            assert at == ref_at == [lsn] * len(qs)
            assert got == want == [
                dfs_baseline.answer_pcr(graphs[lsn], u, v, p)
                for u, v, p in qs], step
    finally:
        writer.close()
    other = rfleet.FleetWriter(d) if writer_pkg == "port" else \
        fleet.FleetWriter(d, device="cpu")
    try:
        assert other.last_lsn == len(graphs) - 1
        for f in ("indptr", "indices", "labels"):
            assert np.array_equal(getattr(other.graph, f),
                                  getattr(graphs[-1], f)), f
    finally:
        other.close()


@pytest.mark.parametrize("backend", ["segment", "matmul"])
def test_follower_degraded_path_redelivers(backend, tmp_path, servers,
                                           monkeypatch):
    """``update_index`` failing on the tail flips ``degraded``; reads keep
    answering at the last-good LSN; once the fault clears the record is
    re-delivered and applied, and ``degraded`` clears."""
    d = str(tmp_path / "store")
    g = G.random_graph("er", N_V, 2.0, N_L, seed=8)
    fleet.init_store(tdr_build.build_index(g, CFG, backend=backend,
                                           device="cpu"), d)
    writer = fleet.FleetWriter(d, device="cpu")
    srv = servers(serve.QueryServer.follow(
        d, backend=backend, poll_s=0.01, device="cpu", update_retries=0))
    srv.start()
    real = tdr_build.update_index
    armed = threading.Event()
    calls = []

    def faulty(*args, **kwargs):
        calls.append(armed.is_set())
        if armed.is_set():
            raise OSError("injected update_index fault")
        return real(*args, **kwargs)

    armed.set()
    monkeypatch.setattr(tdr_build, "update_index", faulty)
    qs = _queries(np.random.default_rng(8))
    try:
        lsn = writer.publish([(0, 5, 1), (5, 9, 2)], [(
            int(g.src[0]), int(g.indices[0]), int(g.labels[0]))])
        _wait_until(lambda: srv.stats.degraded, "degraded mode")
        assert srv.stats.update_failures >= 1
        got = [srv.submit(u, v, p, with_lsn=True).result(timeout=WAIT_S)
               for u, v, p in qs]
        assert [s for _, s in got] == [0] * len(qs)
        assert [a for a, _ in got] == [dfs_baseline.answer_pcr(
            g, u, v, p) for u, v, p in qs]
        armed.clear()
        assert srv.wait_for_lsn(lsn, timeout=WAIT_S)
        _wait_until(lambda: not srv.stats.degraded, "degraded to clear")
        assert calls.count(True) >= 1 and calls[-1] is False
        got, at = _ask(srv, qs, lsn)
        assert at == [lsn] * len(qs)
        assert got == [dfs_baseline.answer_pcr(writer.graph, u, v, p)
                       for u, v, p in qs]
    finally:
        writer.close()


# --------------------------------------------------------------- router
class _Member:
    """A replica handle as the router sees one: LSN, heartbeat queue
    depth, pending requests, and a pipe that records what it is sent."""

    def __init__(self, name, lsn=0, queued=0):
        self.name = name
        self.lsn = lsn
        self.queued = queued
        self.alive = True
        self.broken = False
        self.pending = {}
        self.sent = []
        self._on_event = None

    def send(self, msg):
        self.sent.append(msg)
        return not self.broken


class _Fleet:
    def __init__(self, members):
        self._all = members
        self.on_orphans = None

    def members(self, ready_only=True):
        return [m for m in self._all if m.alive]

    def _on_event(self, replica, msg):
        pass

    def _spawn_locked(self):
        raise AssertionError("no spawns in a placement test")


def _routers(specs, max_attempts=3):
    """The port's and the reference's router, each over its own copy of
    the members ``specs`` = [(lsn, queued, in-flight count)]."""
    out = []
    for mod in (router, rrouter):
        members = [_Member(i, lsn, q) for i, (lsn, q, _) in
                   enumerate(specs)]
        r = mod.FleetRouter(_Fleet(members), max_attempts=max_attempts)
        rid = 10_000
        for m, (_, _, n_in) in zip(members, specs):
            for _ in range(n_in):
                p = mod._Pending(rid, {}, Future())
                p.replica = m
                r._inflight[rid] = p
                rid += 1
        out.append((r, members))
    return out


@pytest.mark.parametrize("seed", range(6))
def test_router_pick_matches_reference(seed):
    """On the same members (LSN, heartbeat queue depth, router
    in-flight count), the port's ``_pick`` chooses the member the
    reference's does — fewest in-flight, queue depth as tiebreak, a
    ``min_lsn`` read redirected to the highest-LSN replica when none
    has caught up — and counts the same redirects."""
    rng = np.random.default_rng(seed)
    for _ in range(25):
        n = int(rng.integers(1, 6))
        specs = [tuple(int(x) for x in rng.integers(0, 4, size=3))
                 for _ in range(n)]
        (pr, _), (rr, _) = _routers(specs)
        for min_lsn in range(0, 6):
            assert pr._pick(min_lsn).name == rr._pick(min_lsn).name, \
                (specs, min_lsn)
        assert pr.redirected == rr.redirected
    (pr, _), (rr, _) = _routers([(2, 0, 0), (5, 3, 2), (5, 0, 2)])
    assert pr._pick(4).name == 2 and pr.redirected == 0
    assert pr._pick(7).name == 2 and pr.redirected == 1


def test_router_wire_matches_reference():
    """The router sends the reference's wire messages, byte for byte:
    patterns as ``pattern.unparse`` text, regexes as ``rpq.unparse``
    text, the kind, the bounds and the consistent-read fields."""
    texts = ["l0 & !l1", "(l2 | l3) & l0", "!l1"]
    sent = []
    for mod, P, R in ((router, pat, rpq), (rrouter, RP, RR)):
        r = mod.FleetRouter(_Fleet([_Member(0)]))
        for t in texts:
            r.submit(1, 2, P.parse(t))
            r.submit(3, 4, P.parse(t), kind="dist", k=5, min_lsn=7,
                     lsn_timeout=9.5)
            r.submit(5, 6, P.parse(t), kind="witness")
            r.submit(7, 8, P.parse(t), kind="count", hops=4)
        r.submit(0, 3, R.parse("l0 . (l1 | l2)*"), kind="rpq", min_lsn=2)
        sent.append([sorted(m.items()) for m in
                     r.fleet.members()[0].sent])
    assert sent[0] == sent[1]


def test_router_redispatch_matches_reference():
    """At-least-once dispatch: a dead member's orphans go to survivors,
    as the reference's router places them; a request that runs out of
    ``max_attempts`` fails with ``ReplicaDied``."""
    outcomes = []
    for (r, members), mod in zip(_routers([(0, 0, 0)] * 3), (fleet,
                                                              rfleet)):
        futs = [r.submit(i, i + 1, (pat if mod is fleet else RP).all_of(
            [0])) for i in range(6)]
        victim = members[1]
        victim.alive = False
        orphans = list(victim.pending.values())
        victim.pending.clear()
        r.fleet.on_orphans(orphans)
        placed = [sorted(m.pending) for m in members]
        for m in members:
            m.broken = True     # every pipe broken: attempts run out
        late = r.submit(9, 9, (pat if mod is fleet else RP).all_of([1]))
        with pytest.raises(mod.ReplicaDied):
            late.result(timeout=WAIT_S)
        outcomes.append((placed, r.redispatched, len(orphans),
                         [f.done() for f in futs]))
    assert outcomes[0] == outcomes[1]
    assert outcomes[0][1] == outcomes[0][2] > 0


def test_jsonable_answers():
    """Answers cross the wire as JSON values: numpy scalars and 0-d
    tensors become Python values, witness edges lists — as the
    reference's encoder gives for the values both packages produce."""
    vals = [True, 3, None, [], np.int64(4), np.bool_(False),
            [(1, 2, 0), (2, 5, 3)], np.float32(1.5)]
    assert [fleet._jsonable(v) for v in vals[:7]] == \
        [rfleet._jsonable(v) for v in vals[:7]]
    assert fleet._jsonable(np.float32(1.5)) == 1.5
    for t, want in ((torch.tensor(True), True),
                    (torch.tensor(7, dtype=torch.int64), 7),
                    (torch.tensor(-1, dtype=torch.int32), -1)):
        got = fleet._jsonable(t)
        assert got == want and type(got) is type(want)


# ------------------------------------------------------- process fleet
@pytest.mark.slow
def test_fleet_subprocess_sigkill_smoke():
    """Real multi-process fleet of the port: ``tests/torch_fleet_check.py``
    runs router + 3 port replica processes on the CPU, SIGKILLs a
    replica and the writer mid-stream, and asserts every answer equals
    the DFS oracle at its read LSN, on both backends."""
    here = os.path.dirname(os.path.abspath(__file__))
    src = os.path.join(os.path.dirname(here), "src")
    env = dict(os.environ)
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run(
        [sys.executable, os.path.join(here, "torch_fleet_check.py"),
         "segment", "matmul"],
        env=env, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    assert "torch fleet check OK" in r.stdout
