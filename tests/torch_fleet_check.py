"""Standalone replicated-fleet fault smoke of the PyTorch port (NOT
collected by pytest directly — ``tests/test_torch_fleet.py`` spawns it as
a slow test).  The port of ``tests/fleet_check.py``: the same legs, the
same update stream and queries, ``repro_torch`` replicas on the CPU
(``--device cpu``), and no JAX in any process.

One shared store, a router over **3 replica processes**, and a single
writer publishing a *deterministic* update stream, so the graph as of
every LSN is known in the parent.  Three legs per backend:

1. **Replica SIGKILL mid-stream** — queries are submitted continuously
   while the writer publishes; one replica is SIGKILLed with requests
   in flight.  Every answer (re-dispatched or not) must equal the DFS
   oracle *at its read LSN* — zero wrong answers — and the fleet must
   evict and re-spawn the victim.
2. **Consistent reads at a pinned LSN** — answers routed with
   ``min_lsn=L`` carry ``lsn >= L`` and are bit-identical to a single
   caught-up in-process follower (``QueryServer.follow``) asked the
   same questions.  An **RPQ sub-leg** routes ``kind="rpq"`` regex
   queries over the same wire (regex-text serialization round-trips
   through the replicas) and checks each LSN-stamped answer against the
   product-graph oracle at its read LSN.
3. **Writer SIGKILL** — a writer subprocess is SIGKILLed mid-publish; a
   new ``FleetWriter`` attaches to the store (torn tail truncated, as
   single-process recovery would), resumes the stream, and the replicas
   keep serving oracle-correct answers through the hand-off.

Steady under a loaded machine: every process runs one torch thread
(``OMP_NUM_THREADS=1``, inherited by the replicas), heartbeats may lag
for minutes before a replica counts as hung, and every wait is on a
condition or a line of output with a deadline, never a fixed number of
polls.

Run directly (both backends)::

    PYTHONPATH=src python tests/torch_fleet_check.py [segment] [matmul]
"""
import os
import signal
import subprocess
import sys
import threading
import time

os.environ["OMP_NUM_THREADS"] = "1"   # this process and every replica

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import dfs_baseline, graph as G  # noqa: E402
from repro_torch import pattern as pat, rpq, tdr_build  # noqa: E402
from repro_torch.launch import fleet as fleet_mod, serve  # noqa: E402
from repro_torch.launch.router import FleetRouter  # noqa: E402

CFG = tdr_build.TDRConfig(vtx_bits=64, g_max=4, k=3)
N_V, N_L, N_STEPS = 24, 4, 24
N_REPLICAS = 3
DEVICE = "cpu"
HB_TIMEOUT_S = 300.0   # a starved replica is slow, not hung
WAIT_S = 300.0


def wait_members(flt, cond, n):
    """Block until ``n`` replicas are ready (membership events notify
    ``cond``), or fail at the deadline."""
    with cond:
        ok = cond.wait_for(lambda: len(flt.members()) >= n, WAIT_S)
    assert ok, f"only {len(flt.members())} of {n} replicas ready"


def make_plan(seed: int):
    """Deterministic update stream: ``graphs[k]`` is the graph with the
    first ``k`` published updates applied — identical everywhere."""
    g = G.random_graph("er", N_V, 2.0, N_L, seed=seed)
    rng = np.random.default_rng(seed + 1)
    graphs, steps = [g], []
    for _ in range(N_STEPS):
        cur = graphs[-1]
        edges = list(zip(cur.src.tolist(), cur.indices.tolist(),
                         cur.labels.tolist()))
        add, rem = [], []
        for _ in range(int(rng.integers(1, 4))):
            kind = int(rng.integers(3))
            if kind <= 1 or not edges:
                u, v = int(rng.integers(N_V)), int(rng.integers(N_V))
                if u != v:
                    add.append((u, v, int(rng.integers(N_L))))
            else:
                rem.append(edges[int(rng.integers(len(edges)))])
        steps.append((add, rem))
        graphs.append(cur.apply_updates(add, rem).graph)
    return graphs, steps


def query_pool(seed: int, n: int = 8):
    rng = np.random.default_rng(seed + 2)
    qs = []
    for i in range(n):
        u, v = int(rng.integers(N_V)), int(rng.integers(N_V))
        labs = rng.choice(N_L, size=2, replace=False).tolist()
        p = [pat.all_of(labs), pat.any_of(labs), pat.none_of(labs),
             pat.parse(f"l{labs[0]} & !l{labs[1]}")][i % 4]
        qs.append((u, v, p))
    return qs


def rpq_pool():
    """Fixed regex pool with labels < N_L: lowered ((a|b)* → the LCR
    plan path), product-route (order-constrained), and unmatchable."""
    return [
        (0, 7, rpq.parse("(l0 | l1)*")),
        (3, 3, rpq.parse("l2*")),
        (1, 9, rpq.parse("l0 . (l1 | l2)*")),
        (5, 5, rpq.parse("l3 . l0")),
        (2, 11, rpq.parse("(l0 | l1 | l2 | l3)+")),
        (4, 8, rpq.parse("l1 . l2")),
    ]


def leg_rpq(router, writer, graphs):
    """Route kind="rpq" queries through the fleet wire; every stamped
    answer must equal the product-graph oracle at its read LSN, and
    pinned reads must carry lsn >= the pin."""
    L = writer.last_lsn
    futs = [(u, v, r, router.submit(u, v, r, kind="rpq"))
            for u, v, r in rpq_pool()]
    futs += [(u, v, r, router.submit(u, v, r, kind="rpq", min_lsn=L,
                                     lsn_timeout=WAIT_S))
             for u, v, r in rpq_pool()[:3]]
    for i, (u, v, r, f) in enumerate(futs):
        ans, lsn = f.result(timeout=WAIT_S)
        if i >= len(rpq_pool()):
            assert lsn >= L, f"pinned rpq read served at lsn {lsn} < {L}"
        want = dfs_baseline.answer_rpq(graphs[lsn], u, v, r)
        assert ans == want, \
            f"rpq: ({u},{v},{rpq.unparse(r)}) at lsn={lsn}: " \
            f"got {ans!r}, oracle {want!r}"
    return len(futs)


def check_at_lsn(graphs, u, v, p, ans, lsn, ctx):
    want = dfs_baseline.answer_pcr(graphs[lsn], u, v, p)
    assert ans == want, \
        f"{ctx}: ({u},{v},{pat.unparse(p)}) at lsn={lsn}: " \
        f"got {ans!r}, oracle {want!r}"


def writer_worker(directory: str, seed: int, first_step: int) -> None:
    """Leg-3 subprocess body: attach a writer and publish the tail of
    the deterministic stream, printing each acked LSN.  The parent
    SIGKILLs us mid-stream — no cleanup of any kind runs."""
    _, steps = make_plan(seed)
    w = fleet_mod.FleetWriter(directory, device=DEVICE)
    print("READY", flush=True)
    for add, rem in steps[first_step:]:
        lsn = w.publish(add, rem)
        print(f"LSN {lsn}", flush=True)
        time.sleep(0.05)
    print("DONE", flush=True)


def leg_replica_kill(router, flt, cond, writer, graphs, steps, qs, n_pub):
    """Publish ``n_pub`` updates while streaming queries; SIGKILL one
    replica with requests in flight.  Zero wrong answers allowed."""
    ev0, rs0 = flt.evictions, flt.respawns
    results = []   # (u, v, p, future)
    victim = flt.members()[0]
    for j in range(n_pub):
        writer.publish(*steps[writer.last_lsn])
        for u, v, p in qs:
            results.append((u, v, p, router.submit(u, v, p)))
        if j == n_pub // 2:
            victim.kill()   # mid-stream, answers in flight
    for u, v, p in qs:     # post-kill traffic
        results.append((u, v, p,
                        router.submit(u, v, p, min_lsn=writer.last_lsn,
                                      lsn_timeout=WAIT_S)))
    for u, v, p, f in results:
        ans, lsn = f.result(timeout=WAIT_S)
        check_at_lsn(graphs, u, v, p, ans, lsn, "replica-kill")
    wait_members(flt, cond, N_REPLICAS)
    assert flt.evictions > ev0, "victim was never evicted"
    assert flt.respawns > rs0, "victim was never re-spawned"
    return len(results)


def leg_consistent_reads(router, backend, directory, writer, graphs, qs):
    """Pinned reads at the tip LSN, bit-identical to one caught-up
    in-process follower asked the same questions."""
    L = writer.last_lsn
    futs = [(u, v, p, router.submit(u, v, p, min_lsn=L,
                                    lsn_timeout=WAIT_S))
            for u, v, p in qs]
    ref = serve.QueryServer.follow(directory, backend=backend,
                                   device=DEVICE)
    ref.start()
    try:
        assert ref.wait_for_lsn(L, timeout=WAIT_S), \
            "follower never caught up"
        for u, v, p, f in futs:
            ans, lsn = f.result(timeout=WAIT_S)
            assert lsn >= L, f"consistent read served at lsn {lsn} < {L}"
            check_at_lsn(graphs, u, v, p, ans, lsn, "consistent-read")
            ref_ans, ref_lsn = ref.submit(u, v, p, with_lsn=True).result(
                timeout=WAIT_S)
            assert ref_lsn >= L
            assert ans == ref_ans, \
                f"fleet {ans!r} != caught-up follower {ref_ans!r}"
    finally:
        ref.stop()
    return len(futs)


def leg_writer_kill(router, directory, graphs, steps, qs, seed,
                    first_step):
    """SIGKILL the writer process mid-publish; attach a fresh writer,
    resume the stream, and keep reading correctly throughout."""
    here = os.path.abspath(__file__)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(
        os.path.dirname(os.path.dirname(here)), "src") + os.pathsep + \
        env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, here, "--writer", directory, str(seed),
         str(first_step)],
        env=env, stdout=subprocess.PIPE, text=True)
    acked, killed = first_step, False
    for line in proc.stdout:
        line = line.strip()
        if line.startswith("LSN"):
            acked = int(line.split()[1])
            if acked >= first_step + 3:
                proc.send_signal(signal.SIGKILL)  # no cleanup runs
                killed = True
                break
        if line == "DONE":
            break
    proc.wait(timeout=WAIT_S)
    assert killed, "writer finished before the kill"

    # reads stay correct while the writer seat is empty
    for u, v, p in qs[:4]:
        ans, lsn = router.submit(u, v, p).result(timeout=WAIT_S)
        check_at_lsn(graphs, u, v, p, ans, lsn, "writer-dead")

    # the new writer sees the acked prefix (+ at most one in-flight
    # append the kill let land) and resumes the deterministic stream
    w2 = fleet_mod.FleetWriter(directory, device=DEVICE)
    try:
        k = w2.last_lsn
        assert k in (acked, acked + 1), \
            f"recovered writer at lsn {k}, acked {acked}"
        assert np.array_equal(w2.graph.indices, graphs[k].indices)
        assert np.array_equal(w2.graph.labels, graphs[k].labels)
        lsn2 = w2.publish(*steps[k])
        futs = [(u, v, p, router.submit(u, v, p, min_lsn=lsn2,
                                        lsn_timeout=WAIT_S))
                for u, v, p in qs]
        for u, v, p, f in futs:
            ans, lsn = f.result(timeout=WAIT_S)
            assert lsn >= lsn2
            check_at_lsn(graphs, u, v, p, ans, lsn, "writer-handoff")
    finally:
        w2.close()
    return k


def run_one(backend: str, workdir: str, seed: int) -> None:
    d = os.path.join(workdir, f"fleet-{backend}")
    graphs, steps = make_plan(seed)
    qs = query_pool(seed)
    idx0 = tdr_build.build_index(graphs[0], CFG, backend=backend,
                                 device=DEVICE)
    fleet_mod.init_store(idx0, d)
    writer = fleet_mod.FleetWriter(d, device=DEVICE)
    n_answers = 0
    cond = threading.Condition()

    def on_membership():
        with cond:
            cond.notify_all()

    with fleet_mod.Fleet(d, N_REPLICAS, backend, device=DEVICE, hb_s=0.1,
                         hb_timeout_s=HB_TIMEOUT_S) as flt:
        flt.on_membership = on_membership
        router = FleetRouter(flt)
        n_answers += leg_replica_kill(router, flt, cond, writer, graphs,
                                      steps, qs, n_pub=6)
        n_answers += leg_consistent_reads(router, backend, d, writer,
                                          graphs, qs)
        n_answers += leg_rpq(router, writer, graphs)
        first_step = writer.last_lsn
        writer.close()   # single-writer seat: release before the worker
        k = leg_writer_kill(router, d, graphs, steps, qs, seed,
                            first_step)
        print(f"[torch fleet] {backend}: {n_answers} streamed answers "
              f"oracle-correct at their read LSNs, "
              f"evictions={flt.evictions} respawns={flt.respawns} "
              f"redispatched={router.redispatched}, writer handed "
              f"off at lsn={k}")


def main() -> None:
    if len(sys.argv) > 1 and sys.argv[1] == "--writer":
        writer_worker(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]))
        return
    import tempfile
    torch.set_num_threads(1)
    backends = sys.argv[1:] or ["segment", "matmul"]
    with tempfile.TemporaryDirectory() as workdir:
        for backend in backends:
            run_one(backend, workdir, seed=9)
    print("torch fleet check OK")


if __name__ == "__main__":
    main()
