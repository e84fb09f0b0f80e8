"""Port durability against the JAX package's: ``snapshot`` save/load and
the ``deltalog`` write-ahead log, each in the reference's on-disk format.
A snapshot or a log written by either package loads into the other
bit-identically, both packages write the same bytes for the same index
and the same appends, every corruption raises a typed error, and
snapshot + log replay through the port's ``update_index`` equals a
layout-pinned rebuild of the final graph.  Exact equality throughout."""
import os
import threading
import time

import numpy as np
import pytest
import torch

import faultinject
from repro.core import (deltalog as rlog, graph as RG, snapshot as rsnap,
                        tdr_build as RB)
from repro_torch import (bitset, deltalog, dfs_baseline, graph as G,
                         pattern as pat, snapshot, tdr_build, tdr_query)

CFG = tdr_build.TDRConfig(vtx_bits=64, g_max=4, k=3)
RCFG = RB.TDRConfig(vtx_bits=64, g_max=4, k=3)
PLANES = ("h_vtx", "h_lab", "v_vtx", "v_lab", "n_out", "n_in", "push",
          "pop", "g_count", "base_v", "base_l", "base_r", "r_vtx",
          "r_lab", "r_in", "d_vtx", "d_lab")
REF_BACKEND = {"segment": "segment", "matmul": "pallas"}
N_V, N_L = 24, 4


def assert_planes_equal(a, b, ctx="", *, same_rounds=False):
    """Two indexes, of either package, hold the same bits everywhere;
    ``same_rounds`` for copies of one index (a warm-started update and a
    rebuild converge in different rounds)."""
    def arr(x):
        if isinstance(x, torch.Tensor):
            return x.cpu().numpy()
        return np.asarray(x)
    for p in PLANES:
        x, y = arr(getattr(a, p)), arr(getattr(b, p))
        assert x.shape == y.shape and np.array_equal(
            x.view(np.uint32), y.view(np.uint32)), f"{ctx}: plane {p}"
    for f in ("vtx_words", "lab_slot", "disc"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == np.asarray(y).dtype and np.array_equal(x, y), \
            f"{ctx}: {f}"
    for f in ("indptr", "indices", "labels"):
        assert np.array_equal(getattr(a.graph, f), getattr(b.graph, f)), f
    assert a.cfg.__dict__ == b.cfg.__dict__, ctx
    assert a.fixpoint_rounds == b.fixpoint_rounds or not same_rounds, ctx


def _random_step(rng, g):
    """One random update batch: inserts, deletes, label changes."""
    add, rem = [], []
    edges = list(zip(g.src.tolist(), g.indices.tolist(),
                     g.labels.tolist()))
    for _ in range(int(rng.integers(1, 4))):
        kind = int(rng.integers(4))
        if kind <= 1 or not edges:
            u, v = int(rng.integers(g.n_vertices)), \
                int(rng.integers(g.n_vertices))
            if u != v:
                add.append((u, v, int(rng.integers(g.n_labels))))
        elif kind == 2:
            rem.append(edges[int(rng.integers(len(edges)))])
        else:
            u, v, l = edges[int(rng.integers(len(edges)))]
            rem.append((u, v, l))
            add.append((u, v, int((l + 1) % g.n_labels)))
    return add, rem


def _check_oracle(idx, g, rng, backend):
    qs = []
    for i in range(6):
        u, v = int(rng.integers(g.n_vertices)), \
            int(rng.integers(g.n_vertices))
        labs = rng.choice(g.n_labels, size=2, replace=False).tolist()
        qs.append((u, v, [pat.all_of(labs), pat.any_of(labs),
                          pat.none_of(labs),
                          pat.parse(f"l{labs[0]} & !l{labs[1]}")][i % 4]))
    got = tdr_query.answer_batch(idx, qs, backend=backend, device="cpu")
    assert got.tolist() == [dfs_baseline.answer_pcr(g, u, v, p)
                            for u, v, p in qs]


def _build(g, backend=None, **kw):
    return tdr_build.build_index(g, CFG, backend=backend, device="cpu",
                                 **kw)


# ------------------------------------------------------------ snapshot
@pytest.mark.parametrize("backend", ["segment", "matmul"])
def test_snapshot_roundtrip_bit_identical(backend, tmp_path):
    """save -> load restores every plane, the frozen layout and the
    maintenance state: the restored index answers like the original and
    chains ``update_index`` bit-identically to a layout-pinned rebuild."""
    rng = np.random.default_rng(0)
    g = G.random_graph("er", N_V, 2.0, N_L, seed=0)
    idx = _build(g, backend)
    path = str(tmp_path / "snap.tdr")
    n_bytes = snapshot.save_index(idx, path, lsn=17)
    assert n_bytes == os.path.getsize(path)
    assert snapshot.peek_lsn(path) == 17
    idx2, lsn = snapshot.load_index(path, device="cpu")
    assert lsn == 17
    assert_planes_equal(idx, idx2, "roundtrip", same_rounds=True)
    for p in PLANES:
        assert getattr(idx2, p).dtype == torch.int32, p
    # the compressed-plane cache is seeded from the validated sections
    c1, c2 = idx.compressed_planes(), idx2.compressed_planes()
    assert all(c1[k].same_as(c2[k]) for k in c1)
    _check_oracle(idx2, g, rng, backend)
    # restored index updates exactly like the one that was saved
    add, rem = _random_step(rng, g)
    delta = idx2.graph.apply_updates(add, rem)
    upd = tdr_build.update_index(idx2, delta, backend=backend, device="cpu")
    assert_planes_equal(upd, _build(delta.graph, backend, layout=idx.disc),
                        "update-after-restore")


def test_snapshot_corruption_always_typed(tmp_path):
    """Random byte flips and truncations anywhere in a snapshot raise a
    typed ``SnapshotError``: a damaged file is never loaded."""
    g = G.random_graph("er", N_V, 2.0, N_L, seed=1)
    idx = _build(g, "segment")
    path = str(tmp_path / "snap.tdr")
    snapshot.save_index(idx, path, lsn=1)
    orig = open(path, "rb").read()
    rng = np.random.default_rng(2)
    bad = str(tmp_path / "bad.tdr")
    for trial in range(60):
        data = bytearray(orig)
        pos = int(rng.integers(len(data)))
        data[pos] ^= int(rng.integers(1, 256))
        with open(bad, "wb") as f:
            f.write(bytes(data))
        with pytest.raises(snapshot.SnapshotError):
            snapshot.load_index(bad, device="cpu")
    for trial in range(20):
        cut = int(rng.integers(0, len(orig)))
        with open(bad, "wb") as f:
            f.write(orig[:cut])
        with pytest.raises(snapshot.SnapshotError):
            snapshot.load_index(bad, device="cpu")


def test_snapshot_version_gate(tmp_path):
    g = G.fig2_example()
    idx = _build(g)
    path = str(tmp_path / "snap.tdr")
    snapshot.save_index(idx, path)
    data = bytearray(open(path, "rb").read())
    # bump the container version word (little-endian u32 after magic)
    data[len(snapshot.MAGIC)] = snapshot.VERSION + 1
    with open(path, "wb") as f:
        f.write(bytes(data))
    with pytest.raises(snapshot.SnapshotVersionMismatch):
        snapshot.load_index(path, device="cpu")
    assert (snapshot.MAGIC, snapshot.VERSION) == (rsnap.MAGIC, rsnap.VERSION)


# ------------------------------------------------- across the two packages
@pytest.mark.parametrize("backend", ["segment", "matmul"])
def test_snapshots_cross_packages_byte_identical(backend, tmp_path):
    """The same index saved by both packages gives byte-identical files;
    each loads the other's file bit-identically; after a chain of updates
    (whose carried compressed caches are what gets written) the files
    still agree byte for byte."""
    rng = np.random.default_rng(3)
    g = G.random_graph("pa", N_V, 2.0, N_L, seed=3)
    rg = RG.random_graph("pa", N_V, 2.0, N_L, seed=3)
    idx = _build(g, backend)
    ridx = RB.build_index(rg, RCFG, backend=REF_BACKEND[backend])
    for step in range(3):
        p_path = str(tmp_path / f"port{step}.tdr")
        r_path = str(tmp_path / f"ref{step}.tdr")
        assert snapshot.save_index(idx, p_path, lsn=step) == \
            rsnap.save_index(ridx, r_path, lsn=step)
        assert open(p_path, "rb").read() == open(r_path, "rb").read(), step
        from_ref, lsn = snapshot.load_index(r_path, device="cpu")
        assert lsn == step
        assert_planes_equal(from_ref, ridx, f"ref->port step={step}",
                            same_rounds=True)
        from_port, lsn = rsnap.load_index(p_path)
        assert lsn == step
        assert_planes_equal(idx, from_port, f"port->ref step={step}",
                            same_rounds=True)
        idx.compressed_planes()
        ridx.compressed_planes()
        add, rem = _random_step(rng, g)
        delta, rdelta = g.apply_updates(add, rem), rg.apply_updates(add, rem)
        idx = tdr_build.update_index(idx, delta, backend=backend,
                                     rebuild_threshold=2.0, device="cpu")
        ridx = RB.update_index(ridx, rdelta, backend=REF_BACKEND[backend],
                               rebuild_threshold=2.0)
        g, rg = delta.graph, rdelta.graph


def test_logs_cross_packages_byte_identical(tmp_path):
    """The same appends give byte-identical log files in both packages,
    and each package replays, tails and compacts the other's file."""
    rng = np.random.default_rng(9)
    batches = [(rng.integers(0, 20, (int(rng.integers(0, 4)), 3)),
                rng.integers(0, 20, (int(rng.integers(0, 3)), 3)))
               for _ in range(5)]
    p_path, r_path = str(tmp_path / "port.wal"), str(tmp_path / "ref.wal")
    with deltalog.DeltaLog(p_path) as plog, rlog.DeltaLog(r_path) as rl:
        for a, r in batches:
            assert plog.append(a, r) == rl.append(a, r)
    assert open(p_path, "rb").read() == open(r_path, "rb").read()
    for mine, theirs in ((deltalog, r_path), (rlog, p_path)):
        with mine.DeltaLog(theirs) as log:
            got = list(log.replay(0))
            assert [lsn for lsn, _, _ in got] == [1, 2, 3, 4, 5]
            for (_, a, r), (wa, wr) in zip(got, batches):
                assert np.array_equal(a, wa.reshape(-1, 3))
                assert np.array_equal(r, wr.reshape(-1, 3))
        assert [x[0] for x in mine.LogReader(theirs, after_lsn=3).poll()] \
            == [4, 5]
    with deltalog.DeltaLog(p_path) as plog, rlog.DeltaLog(r_path) as rl:
        assert plog.truncate_upto(2) == rl.truncate_upto(2) == 2
    assert open(p_path, "rb").read() == open(r_path, "rb").read()


@pytest.mark.parametrize("backend", ["segment", "matmul"])
def test_reference_snapshot_and_log_replay_into_the_port(backend, tmp_path):
    """A snapshot and a log written by the JAX package, loaded and
    replayed by the port, give the reference's own recovered index; the
    reverse direction too.  Both equal a layout-pinned port rebuild of
    the final graph."""
    rng = np.random.default_rng(21)
    rg = RG.random_graph("er", N_V, 2.0, N_L, seed=21)
    ridx = RB.build_index(rg, RCFG, backend=REF_BACKEND[backend])
    r_snap, r_wal = str(tmp_path / "ref.tdr"), str(tmp_path / "ref.wal")
    rsnap.save_index(ridx, r_snap, lsn=0)
    cur_g = rg
    with rlog.DeltaLog(r_wal) as log:
        for _ in range(3):
            add, rem = _random_step(rng, cur_g)
            d = cur_g.apply_updates(add, rem)
            log.append(d.added, d.removed)
            cur_g = d.graph

    def replay(snap_mod, log_mod, update, snap_path, wal_path, **kw):
        idx, lsn = snap_mod.load_index(snap_path, **kw)
        with log_mod.DeltaLog(wal_path) as log:
            for _, a, r in log.replay(lsn):
                idx = update(idx, idx.graph.apply_updates(a, r))
        return idx

    port = replay(snapshot, deltalog, lambda i, d: tdr_build.update_index(
        i, d, backend=backend, device="cpu"), r_snap, r_wal, device="cpu")
    ref = replay(rsnap, rlog, lambda i, d: RB.update_index(
        i, d, backend=REF_BACKEND[backend]), r_snap, r_wal)
    assert_planes_equal(port, ref, "ref files, port replay",
                        same_rounds=True)
    fin = G.Graph(cur_g.n_vertices, cur_g.n_labels, cur_g.indptr,
                  cur_g.indices, cur_g.labels)
    assert_planes_equal(port, _build(fin, backend, layout=np.asarray(
        ridx.disc)), "pinned rebuild")

    # the reverse: the port writes, the reference recovers
    p_snap, p_wal = str(tmp_path / "port.tdr"), str(tmp_path / "port.wal")
    g = G.random_graph("er", N_V, 2.0, N_L, seed=21)
    snapshot.save_index(_build(g, backend), p_snap, lsn=0)
    with deltalog.DeltaLog(p_wal) as plog, rlog.DeltaLog(r_wal) as rl:
        for rec in rl.records:
            plog.append(rec.added, rec.removed)
    ref2 = replay(rsnap, rlog, lambda i, d: RB.update_index(
        i, d, backend=REF_BACKEND[backend]), p_snap, p_wal)
    assert_planes_equal(port, ref2, "port files, ref replay",
                        same_rounds=True)


@pytest.mark.parametrize("backend", ["segment", "matmul"])
def test_snapshot_plus_log_replay_equals_pinned_rebuild(backend, tmp_path):
    """Recovery through the port alone: snapshot at LSN 2 of a chain of
    five updates, replay the log past it, equal to the live chain and to
    a layout-pinned rebuild of the final graph."""
    rng = np.random.default_rng(33)
    g = G.random_graph("pa", N_V, 2.0, N_L, seed=33)
    idx0 = cur = _build(g, backend)
    snap, wal = str(tmp_path / "s.tdr"), str(tmp_path / "w.wal")
    with deltalog.DeltaLog(wal) as log:
        for step in range(5):
            if step == 2:
                snapshot.save_index(cur, snap, lsn=log.last_lsn)
            add, rem = _random_step(rng, cur.graph)
            delta = cur.graph.apply_updates(add, rem)
            log.append(delta.added, delta.removed)
            cur = tdr_build.update_index(cur, delta, backend=backend,
                                         device="cpu")
    rec, lsn = snapshot.load_index(snap, device="cpu")
    assert lsn == 2
    with deltalog.DeltaLog(wal, create=False) as log:
        for _, a, r in log.replay(lsn):
            rec = tdr_build.update_index(rec, rec.graph.apply_updates(a, r),
                                         backend=backend, device="cpu")
    assert_planes_equal(rec, cur, "recovered vs live", same_rounds=True)
    assert_planes_equal(rec, _build(cur.graph, backend, layout=idx0.disc),
                        "recovered vs pinned rebuild")


# ----------------------------------------------------------- delta log
def _three_record_log(path):
    rng = np.random.default_rng(3)
    log = deltalog.DeltaLog(path)
    recs = []
    for _ in range(3):
        a = rng.integers(0, 20, size=(int(rng.integers(1, 4)), 3)
                         ).astype(np.int64)
        r = rng.integers(0, 20, size=(int(rng.integers(0, 2)), 3)
                         ).astype(np.int64)
        log.append(a, r)
        recs.append((a, r))
    log.close()
    return recs


def test_log_corruption_always_typed(tmp_path):
    """Any byte flip in a complete log file raises ``LogCorrupt`` on
    open; a truncation yields exactly the longest valid record prefix."""
    path = str(tmp_path / "wal")
    recs = _three_record_log(path)
    orig = open(path, "rb").read()
    rng = np.random.default_rng(4)
    bad = str(tmp_path / "bad.wal")
    for trial in range(60):
        data = bytearray(orig)
        pos = int(rng.integers(len(data)))
        data[pos] ^= int(rng.integers(1, 256))
        with open(bad, "wb") as f:
            f.write(bytes(data))
        with pytest.raises(deltalog.LogCorrupt):
            deltalog.DeltaLog(bad)

    hdr_len = len(deltalog.FILE_MAGIC) + deltalog._FHEAD.size
    probe = deltalog.DeltaLog(path)
    bounds = [r.offset for r in probe.records] + [len(orig)]
    probe.close()
    for trial in range(20):
        cut = int(rng.integers(0, len(orig)))
        with open(bad, "wb") as f:
            f.write(orig[:cut])
        if cut < hdr_len:
            with pytest.raises(deltalog.LogCorrupt):
                deltalog.DeltaLog(bad)
            continue
        log = deltalog.DeltaLog(bad)
        survive = sum(1 for b in bounds[1:] if b <= cut)
        got = list(log.replay(0))
        assert len(got) == survive
        for (lsn, a, r), (ea, er) in zip(got, recs):
            assert np.array_equal(a, ea) and np.array_equal(r, er)
        log.close()


def test_log_torn_tail_truncated_prior_replay(tmp_path):
    """A torn final record (crash mid-append) is cut on open; every
    prior record replays; appends resume at the right LSN."""
    path = str(tmp_path / "wal")
    recs = _three_record_log(path)
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(size - 5)   # tear into record 3
    log = deltalog.DeltaLog(path)
    assert log.truncated_bytes > 0
    assert [lsn for lsn, _, _ in log.replay(0)] == [1, 2]
    assert log.last_lsn == 2
    assert log.append(recs[2][0], recs[2][1]) == 3
    log.close()
    log = deltalog.DeltaLog(path)
    assert log.truncated_bytes == 0 and log.last_lsn == 3
    log.close()


def test_log_compaction_preserves_position(tmp_path):
    """truncate_upto drops folded records but the base LSN survives a
    reopen: a fully compacted log still knows where the sequence is."""
    path = str(tmp_path / "wal")
    _three_record_log(path)
    log = deltalog.DeltaLog(path)
    assert log.truncate_upto(3) == 3
    assert log.base_lsn == 3 and len(log) == 0
    log.close()
    log = deltalog.DeltaLog(path)
    assert log.base_lsn == 3 and log.last_lsn == 3
    assert log.append(np.zeros((1, 3), np.int64),
                      np.zeros((0, 3), np.int64)) == 4
    log.close()


# ------------------------------------------------------- reader basics
def R(*rows):
    """Edge rows as the int64 ``[N, 3]`` arrays the log stores."""
    return np.asarray(rows, dtype=np.int64).reshape(-1, 3)


def lsns(recs):
    return [lsn for lsn, _, _ in recs]


def test_reader_tails_exactly_once(tmp_path):
    """Two independent readers over one log each see every committed
    record exactly once, in order, as the writer appends."""
    log = deltalog.DeltaLog(str(tmp_path / "wal"))
    r1 = deltalog.LogReader(str(tmp_path / "wal"))
    r2 = deltalog.LogReader(str(tmp_path / "wal"))
    assert r1.poll() == [] and r2.poll() == []
    log.append(R((0, 1, 0)), R())
    log.append(R((1, 2, 1)), R((0, 1, 0)))
    got1 = r1.poll()
    assert lsns(got1) == [1, 2]
    assert np.array_equal(got1[1][1], R((1, 2, 1)))
    assert np.array_equal(got1[1][2], R((0, 1, 0)))
    assert r1.poll() == []
    log.append(R((2, 3, 2)), R())
    assert lsns(r1.poll()) == [3]
    assert lsns(r2.poll()) == [1, 2, 3]
    r3 = deltalog.LogReader(str(tmp_path / "wal"))
    assert lsns(r3.poll(max_records=2)) == [1, 2]
    assert lsns(r3.poll()) == [3]
    log.close()


def test_reader_seek_and_after_lsn(tmp_path):
    log = deltalog.DeltaLog(str(tmp_path / "wal"))
    for i in range(4):
        log.append(R((i, i + 1, 0)), R())
    r = deltalog.LogReader(str(tmp_path / "wal"), after_lsn=2)
    assert lsns(r.poll()) == [3, 4]
    r.seek(1)       # re-deliver (the failed-apply rewind path)
    assert lsns(r.poll()) == [2, 3, 4]
    log.close()


def test_reader_concurrent_writer_two_tails(tmp_path):
    """Concurrent writer + two tailing readers: each reader sees the dense
    committed sequence in order, never more than one record past the
    writer's ack frontier."""
    path = str(tmp_path / "wal")
    log = deltalog.DeltaLog(path)
    n_total, acked = 60, []

    def writer():
        for i in range(n_total):
            lsn = log.append(R((i % N_V, (i + 1) % N_V, i % N_L)), R())
            acked.append(lsn)
            if i % 7 == 0:
                time.sleep(0.001)

    seen = {0: [], 1: []}
    errs = []

    def tail(k):
        r = deltalog.LogReader(path)
        try:
            while len(seen[k]) < n_total:
                for lsn, _, _ in r.poll():
                    frontier = len(acked)
                    assert lsn <= frontier + 1, \
                        f"reader saw lsn {lsn}, writer acked {frontier}"
                    seen[k].append(lsn)
        except Exception as exc:  # noqa: BLE001 — re-raised in the test
            errs.append(exc)

    threads = [threading.Thread(target=tail, args=(k,)) for k in seen]
    for t in threads:
        t.start()
    writer()
    for t in threads:
        t.join(timeout=60)
    log.close()
    assert not errs, errs
    assert seen[0] == list(range(1, n_total + 1))
    assert seen[1] == list(range(1, n_total + 1))


@pytest.fixture
def port_seams(monkeypatch):
    """Point the fault-injection harness at the port's two modules."""
    monkeypatch.setattr(faultinject, "_MODULES", (snapshot, deltalog))


def _ops_per(tmp_path, n_appends):
    """Mutating-I/O ops for ``DeltaLog() + n appends`` (deterministic)."""
    plan = faultinject.FaultPlan(kind="count")
    with faultinject.inject(plan):
        log = deltalog.DeltaLog(str(tmp_path / "probe.wal"))
        for i in range(n_appends):
            log.append(R((i, i + 1, 0)), R())
    log.close()
    return plan.count


def test_reader_never_yields_torn_tail(tmp_path, port_seams):
    """A writer crash mid-append leaves a torn record on disk; no poll
    ever yields it, and after writer recovery (which truncates the tear)
    the reader picks up the recommitted LSN exactly once."""
    path = str(tmp_path / "wal")
    plan = faultinject.FaultPlan(nth=_ops_per(tmp_path, 2) + 1,
                                 kind="kill", partial_frac=0.5)
    with faultinject.inject(plan):
        log = deltalog.DeltaLog(path)
        log.append(R((0, 1, 0)), R())
        log.append(R((1, 2, 1)), R())
        with pytest.raises(OSError):
            log.append(R((2, 3, 2)), R())
    assert plan.fired
    r = deltalog.LogReader(path)
    assert lsns(r.poll()) == [1, 2]     # the torn lsn-3 is invisible
    assert r.poll() == []               # reads as "in progress", waits
    log2 = deltalog.DeltaLog(path)
    assert log2.last_lsn == 2
    log2.append(R((9, 10, 3)), R())
    got = r.poll()
    assert lsns(got) == [3]
    assert np.array_equal(got[0][1], R((9, 10, 3)))
    log2.close()


def test_reader_torn_mid_append_window(tmp_path):
    """Polls racing a single in-flight append: whatever prefix of the
    record bytes is visible, the reader reports nothing new rather than
    garbage (a copy truncated at every byte length)."""
    path = str(tmp_path / "wal")
    log = deltalog.DeltaLog(path)
    log.append(R((0, 1, 0)), R())
    base_len = os.path.getsize(path)
    log.append(R((1, 2, 1), (2, 3, 2)), R((0, 1, 0)))
    full = open(path, "rb").read()
    log.close()
    torn = str(tmp_path / "torn.wal")
    for cut in range(base_len, len(full)):
        with open(torn, "wb") as f:
            f.write(full[:cut])
        r = deltalog.LogReader(torn)
        assert lsns(r.poll()) == [1], f"cut at {cut} bytes"


def test_reader_detects_mid_log_corruption(tmp_path):
    """A payload-CRC failure behind later records cannot be an in-flight
    append: typed ``LogCorrupt``, never bad data."""
    path = str(tmp_path / "wal")
    log = deltalog.DeltaLog(path)
    hdr = os.path.getsize(path)
    log.append(R((0, 1, 0)), R())
    first_end = os.path.getsize(path)
    log.append(R((1, 2, 1)), R())
    log.close()
    data = bytearray(open(path, "rb").read())
    data[first_end - 3] ^= 0xFF         # flip a byte in record 1's payload
    with open(path, "wb") as f:
        f.write(bytes(data))
    r = deltalog.LogReader(path)
    with pytest.raises(deltalog.LogCorrupt):
        r.poll()
    assert hdr < first_end


def test_reader_pop_tail_retreat_is_corrupt(tmp_path):
    """``pop_tail`` under an active reader violates append-is-commit: a
    tip retreat below the cursor raises ``LogCorrupt``."""
    path = str(tmp_path / "wal")
    log = deltalog.DeltaLog(path)
    log.append(R((0, 1, 0)), R())
    lsn = log.append(R((1, 2, 1)), R())
    r = deltalog.LogReader(path)
    assert lsns(r.poll()) == [1, 2]
    log.pop_tail(lsn)
    with pytest.raises(deltalog.LogCorrupt):
        r.poll()
    log.close()


def test_reader_cursor_survives_compaction(tmp_path):
    """``truncate_upto`` at or behind the cursor is invisible to the
    reader; past the cursor it raises ``LogCompactedPast``."""
    path = str(tmp_path / "wal")
    log = deltalog.DeltaLog(path)
    for i in range(6):
        log.append(R((i, i + 1, 0)), R())
    r = deltalog.LogReader(path)
    assert lsns(r.poll(max_records=4)) == [1, 2, 3, 4]
    log.truncate_upto(3)                # behind the cursor: harmless
    assert lsns(r.poll()) == [5, 6]
    log.append(R((6, 7, 0)), R())
    assert lsns(r.poll()) == [7]
    behind = deltalog.LogReader(path, after_lsn=2)
    with pytest.raises(deltalog.LogCompactedPast):
        behind.poll()
    fresh = deltalog.LogReader(path)
    assert fresh.base_lsn == 3
    fresh.seek(3)
    assert lsns(fresh.poll()) == [4, 5, 6, 7]
    log.close()


def test_snapshot_save_is_atomic_under_a_crash(tmp_path, port_seams):
    """A crash at any mutating I/O boundary of ``save_index`` leaves
    either the previous snapshot or the new one under the final name,
    loadable and bit-identical, never a partial file (the port's I/O goes
    through the same seams as the reference's)."""
    g = G.random_graph("er", N_V, 2.0, N_L, seed=5)
    old, new = _build(g), _build(G.random_graph("er", N_V, 2.0, N_L,
                                                 seed=6))
    path = str(tmp_path / "snap.tdr")
    snapshot.save_index(old, path, lsn=1)
    n_ops = faultinject.count_ops(
        lambda: snapshot.save_index(new, str(tmp_path / "probe.tdr")))
    assert n_ops >= 2
    for nth in range(1, n_ops + 1):
        plan = faultinject.FaultPlan(nth=nth, kind="kill")
        with faultinject.inject(plan):
            with pytest.raises(OSError):
                snapshot.save_index(new, path, lsn=2)
        assert plan.fired
        got, lsn = snapshot.load_index(path, device="cpu")
        assert_planes_equal(got, {1: old, 2: new}[lsn], f"kill at op {nth}",
                            same_rounds=True)
        assert not [f for f in os.listdir(tmp_path) if ".tmp." in f]
        snapshot.save_index(old, path, lsn=1)
