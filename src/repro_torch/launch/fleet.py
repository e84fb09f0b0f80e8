"""Replicated PCR serving fleet over a shared delta log.

The multi-process tier above ``launch.serve``: one **writer** publishes
``GraphDelta`` batches to a shared, LSN-sequenced write-ahead log
(``repro_torch.deltalog``), and N **replica** processes each serve reads
from their own snapshot-restored ``QueryServer`` in follower mode
(``QueryServer.follow``) — bootstrapping from the newest snapshot in the
shared directory, tailing the log through ``update_index``, and
advertising their applied LSN.  A thin ``launch.router.FleetRouter``
load-balances submits by per-replica queue depth and implements
consistent reads ("answer as of LSN >= L").

The store is the JAX package's byte for byte (snapshots and log), and
so is the wire protocol below: a replica of either package serves a
store the other wrote.  Replicas run on the card unless the caller asks
for the CPU (``device=`` / ``--device``): each is its own process with
its own CUDA context and its own copy of the index.

Consistency contract (the JAX package's):

* **ack = commit.**  ``FleetWriter.publish`` returns once the record is
  fsync'd in the log; every replica applies exactly the committed
  record sequence in order (a torn in-flight append is invisible to
  ``deltalog.LogReader``), so any replica's served graph is always a
  *prefix* of the published sequence — the single-process
  acked/acked+1 invariant, replicated.
* **Read LSN is exact.**  Every answer is stamped with the
  ``applied_lsn`` of the index it was computed against
  (``submit(with_lsn=True)``); a consistent read at LSN >= L routed by
  the router is bit-identical to a single caught-up ``QueryServer``.
* **Crash = restart.**  A SIGKILLed replica loses nothing shared: the
  fleet evicts it (pipe EOF or heartbeat timeout) and can re-spawn a
  replacement that bootstraps from the newest snapshot + log tail.  A
  SIGKILLed *writer* leaves at worst a torn tail that both a new
  ``FleetWriter`` (via ``DeltaLog`` open) and every reader ignore.

Processes talk over the replica's stdin/stdout as newline-delimited
JSON (patterns ride as ``pattern.unparse`` text, regexes as
``rpq.unparse`` text): parent → replica
``{"op": "q" | "warm" | "stop", ...}``; replica → parent
``{"ev": "ready" | "hb" | "ans" | "warmed", ...}``.  Heartbeats carry
the applied LSN and local queue depth.  A replica's standard output
carries the protocol alone: anything else the process prints (warnings,
a kernel build) goes to its standard error.

Worker entry point (spawned by ``Fleet``, or by hand for debugging)::

    PYTHONPATH=src python -m repro_torch.launch.fleet --replica DIR \
        [--device cuda] [--backend segment] [--poll 0.02] [--hb 0.25]
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from .. import bitset
from .. import deltalog as deltalog_mod
from .. import pattern as pat
from .. import rpq as rpq_mod
from .. import snapshot as snapshot_mod
from . import serve


class ReplicaDied(RuntimeError):
    """The replica process went away (SIGKILL, crash, or eviction)
    before answering — the router re-dispatches the request."""


class FleetUnavailable(RuntimeError):
    """No live replica can take the request (all dead, or none can
    reach the requested LSN within the deadline)."""


def init_store(index, directory: str, *, lsn: int = 0) -> str:
    """Create a shared fleet store: ``snapshot-<lsn>.tdr`` of ``index``
    plus an (empty, or pre-existing) delta log replicas will tail.
    Returns the snapshot path."""
    os.makedirs(directory, exist_ok=True)
    log = deltalog_mod.DeltaLog(os.path.join(directory, serve.LOG_NAME))
    lsn = max(int(lsn), log.last_lsn)
    log.close()
    path = os.path.join(directory, f"snapshot-{lsn:016d}.tdr")
    snapshot_mod.save_index(index, path, lsn=lsn)
    return path


class FleetWriter:
    """The fleet's single writer: owns the shared log and the current
    graph, publishes effective deltas.  ``publish`` returning *is* the
    commit point — the record is fsync'd and every replica will apply
    it.  Attaching to an existing store (e.g. after a writer crash)
    reconstructs the current graph from the newest snapshot (loaded
    onto ``device``, the card by default; it raises without one) + log
    replay; any torn tail a dead writer left is truncated by the
    ``DeltaLog`` open, exactly as single-process recovery does."""

    def __init__(self, directory: str, *, device="cuda"):
        device = bitset.resolve_device(device)
        self.directory = directory
        self.log = deltalog_mod.DeltaLog(
            os.path.join(directory, serve.LOG_NAME))
        try:
            idx, snap_lsn = serve.QueryServer._newest_valid_snapshot(
                directory, self.log.base_lsn, device)
        except BaseException:
            self.log.close()
            raise
        g = idx.graph
        for _lsn, added, removed in self.log.replay(after_lsn=snap_lsn):
            g = g.apply_updates(added, removed).graph
        self.graph = g
        self._lock = threading.Lock()

    @property
    def last_lsn(self) -> int:
        return self.log.last_lsn

    def publish(self, edges_added=(), edges_removed=()) -> int:
        """Durably append one update; returns its LSN.  No-op deltas
        still consume an LSN (replicas apply them trivially), so the
        caller can always pin reads to the returned position."""
        with self._lock:
            delta = self.graph.apply_updates(edges_added, edges_removed)
            lsn = self.log.append(delta.added, delta.removed)
            self.graph = delta.graph
            return lsn

    def checkpoint(self, index) -> int:
        """Publish a new snapshot of ``index`` (which must be the index
        of the writer's current graph) and compact the log up to it,
        keeping the previous snapshot as a corruption fallback.
        Replicas whose cursor predates the compaction point re-bootstrap
        from this snapshot (``QueryServer._refollow``)."""
        with self._lock:
            lsn = self.log.last_lsn
            path = os.path.join(self.directory,
                                f"snapshot-{lsn:016d}.tdr")
            snapshot_mod.save_index(index, path, lsn=lsn)
            snaps = serve._snapshot_files(self.directory)
            for _, old in snaps[:-2]:
                os.unlink(old)
            self.log.truncate_upto(snaps[-2:][0][0])
            return lsn

    def close(self) -> None:
        self.log.close()


# --------------------------------------------------------------- replica
def _jsonable(val):
    """Answers over the wire: numpy scalars and 0-d tensors → Python,
    witness edge tuples → lists."""
    if isinstance(val, (bool, int, float, str)) or val is None:
        return val
    if isinstance(val, np.generic) or (
            isinstance(val, torch.Tensor) and val.dim() == 0):
        return val.item()
    if isinstance(val, (list, tuple)):
        return [_jsonable(v) for v in val]
    return val


def replica_worker(directory: str, backend: str | None, poll_s: float,
                   hb_s: float, device="cuda") -> None:
    """Replica process body: follow the shared store on ``device``, serve
    queries from stdin, heartbeat the applied LSN on stdout.  Exits on
    ``stop`` or stdin EOF (parent death)."""
    out_lock = threading.Lock()
    # the protocol keeps the original stdout; file descriptor 1 and
    # sys.stdout now lead to stderr, so no other output (a warning, a
    # library's print, a compiler's) can land inside a protocol line
    sys.stdout.flush()
    wire = os.fdopen(os.dup(1), "w")
    os.dup2(2, 1)
    sys.stdout = sys.stderr

    def emit(obj) -> None:
        with out_lock:
            wire.write(json.dumps(obj) + "\n")
            wire.flush()

    server = serve.QueryServer.follow(directory, backend=backend,
                                      poll_s=poll_s, device=device)
    server.start()
    stop_ev = threading.Event()

    def heartbeat() -> None:
        while not stop_ev.wait(hb_s):
            st = server.stats
            emit({"ev": "hb", "lsn": st.applied_lsn,
                  "queued": len(server._queue),
                  "degraded": st.degraded, "pid": os.getpid()})

    def answer(rid: int, msg: dict) -> None:
        try:
            kind = msg.get("kind", "bool")
            # rpq queries ship as regex text, every other kind as
            # pattern text — the kind field picks the parser
            p = rpq_mod.parse(msg["p"]) if kind == "rpq" \
                else pat.parse(msg["p"])
            min_lsn = int(msg.get("min_lsn") or 0)
            if min_lsn and not server.wait_for_lsn(
                    min_lsn, timeout=msg.get("lsn_timeout", 60.0)):
                raise TimeoutError(
                    f"replica did not reach lsn {min_lsn} "
                    f"(at {server.stats.applied_lsn})")
            fut = server.submit(
                int(msg["u"]), int(msg["v"]), p, kind=kind,
                hops=int(msg.get("hops", 8)),
                k=msg.get("k"), with_lsn=True)
        except Exception as exc:  # noqa: BLE001 — goes on the wire
            emit({"ev": "ans", "id": rid, "ok": False, "err": repr(exc)})
            return

        def done(f):
            try:
                val, lsn = f.result()
                emit({"ev": "ans", "id": rid, "ok": True,
                      "val": _jsonable(val), "lsn": lsn})
            except Exception as exc:  # noqa: BLE001
                emit({"ev": "ans", "id": rid, "ok": False,
                      "err": repr(exc)})
        fut.add_done_callback(done)

    hb = threading.Thread(target=heartbeat, daemon=True)
    hb.start()
    emit({"ev": "ready", "lsn": server.stats.applied_lsn,
          "pid": os.getpid()})
    try:
        for line in sys.stdin:
            line = line.strip()
            if not line:
                continue
            msg = json.loads(line)
            op = msg.get("op")
            if op == "q":
                rid = int(msg["id"])
                if msg.get("min_lsn"):
                    # a pinned read may have to wait for the log tail —
                    # off the stdin thread so later requests still flow
                    threading.Thread(target=answer, args=(rid, msg),
                                     daemon=True).start()
                else:
                    answer(rid, msg)
            elif op == "warm":
                # pre-compile the serving shapes by answering the pool
                # once; replies when every future resolved
                futs = [server.submit(int(u), int(v), pat.parse(ptxt))
                        for u, v, ptxt in msg["qs"]]
                for f in futs:
                    f.result(timeout=600)
                emit({"ev": "warmed", "lsn": server.stats.applied_lsn})
            elif op == "stop":
                break
    finally:
        stop_ev.set()
        server.stop(drain=False)


class Replica:
    """Parent-side handle on one replica subprocess: the JSON pipe, its
    reader thread, pending request futures, and liveness/LSN state."""

    def __init__(self, directory: str, backend: str | None = None, *,
                 device: str = "cuda", poll_s: float = 0.02,
                 hb_s: float = 0.25, name: str = "replica",
                 on_event=None, on_death=None):
        self.name = name
        self.lsn = -1            # last heartbeat/ready/answer LSN
        self.queued = 0
        self.ready = False
        self.alive = True
        self.last_hb = time.monotonic()
        self.pending: dict[int, object] = {}   # id -> router request
        self._on_event = on_event
        self._on_death = on_death
        self._wlock = threading.Lock()
        env = dict(os.environ)
        src = os.path.join(os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))))
        env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
        cmd = [sys.executable, "-m", "repro_torch.launch.fleet",
               "--replica", directory, "--device", str(device),
               "--poll", str(poll_s), "--hb", str(hb_s)]
        if backend:
            cmd += ["--backend", backend]
        self.proc = subprocess.Popen(
            cmd, env=env, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=None, text=True, bufsize=1)
        self._reader = threading.Thread(target=self._read_loop,
                                        name=f"{name}-rx", daemon=True)
        self._reader.start()

    @property
    def pid(self) -> int:
        return self.proc.pid

    def _read_loop(self) -> None:
        try:
            for line in self.proc.stdout:
                line = line.strip()
                if not line:
                    continue
                try:
                    msg = json.loads(line)
                except ValueError:
                    continue   # stray non-protocol output
                self.last_hb = time.monotonic()
                ev = msg.get("ev")
                if ev in ("hb", "ready", "warmed"):
                    self.lsn = max(self.lsn, int(msg.get("lsn", -1)))
                    self.queued = int(msg.get("queued", 0))
                    if ev == "ready":
                        self.ready = True
                if self._on_event is not None:
                    self._on_event(self, msg)
        finally:
            self._mark_dead()

    def _mark_dead(self) -> None:
        if not self.alive:
            return
        self.alive = False
        orphans = list(self.pending.values())
        self.pending.clear()
        if self._on_death is not None:
            self._on_death(self, orphans)

    def send(self, msg: dict) -> bool:
        """One protocol line to the replica; False if the pipe is gone
        (the reader thread will mark the replica dead)."""
        try:
            with self._wlock:
                self.proc.stdin.write(json.dumps(msg) + "\n")
                self.proc.stdin.flush()
            return True
        except (BrokenPipeError, OSError, ValueError):
            return False

    def kill(self) -> None:
        """SIGKILL — the fault-injection path (no cleanup of any kind
        runs in the replica; eviction happens via pipe EOF)."""
        try:
            self.proc.send_signal(signal.SIGKILL)
        except OSError:
            pass

    def stop(self, timeout: float = 30.0) -> None:
        self.send({"op": "stop"})
        try:
            self.proc.stdin.close()
        except OSError:
            pass
        try:
            self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait(timeout=10)


class Fleet:
    """Replica lifecycle manager: spawns N replicas over one shared
    store, watches health (pipe EOF fast path, heartbeat-staleness slow
    path), evicts dead replicas, and — with ``respawn=True`` — replaces
    them with a fresh process bootstrapped from the newest snapshot.
    Every replica serves on ``device`` (the card by default; the fleet
    raises without one before it spawns anything).  Query placement
    lives in ``launch.router.FleetRouter``."""

    def __init__(self, directory: str, n: int,
                 backend: str | None = None, *, device="cuda",
                 respawn: bool = True, poll_s: float = 0.02,
                 hb_s: float = 0.25, hb_timeout_s: float = 15.0):
        self.directory = directory
        self.backend = backend
        self.device = str(bitset.resolve_device(device))
        self.n = int(n)
        self.respawn = respawn
        self.poll_s = poll_s
        self.hb_s = hb_s
        self.hb_timeout_s = hb_timeout_s
        self._members: list[Replica] = []
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._stopping = False
        self._spawned = 0
        self._monitor: threading.Thread | None = None
        self.evictions = 0
        self.respawns = 0
        # router hooks (set by FleetRouter.attach)
        self.on_membership = None    # fn() — replica set / lsn changed
        self.on_orphans = None       # fn(list) — requests needing redispatch

    # ----------------------------------------------------------- lifecycle
    def start(self, ready_timeout_s: float = 300.0) -> "Fleet":
        with self._lock:
            for _ in range(self.n):
                self._members.append(self._spawn_locked())
        deadline = time.monotonic() + ready_timeout_s
        for r in list(self._members):
            while r.alive and not r.ready:
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"{r.name} not ready within {ready_timeout_s}s")
                time.sleep(0.05)
        self._monitor = threading.Thread(target=self._monitor_loop,
                                         name="fleet-monitor",
                                         daemon=True)
        self._monitor.start()
        return self

    def _spawn_locked(self) -> Replica:
        self._spawned += 1
        return Replica(self.directory, self.backend, device=self.device,
                       poll_s=self.poll_s, hb_s=self.hb_s,
                       name=f"replica-{self._spawned}",
                       on_event=self._on_event,
                       on_death=self._on_death)

    def stop(self) -> None:
        with self._lock:
            self._stopping = True
            members = list(self._members)
            self._cond.notify_all()
        for r in members:
            r.stop()
        if self._monitor is not None:
            self._monitor.join(timeout=10)
            self._monitor = None

    def __enter__(self) -> "Fleet":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ------------------------------------------------------------- health
    def _on_event(self, replica: Replica, msg: dict) -> None:
        if msg.get("ev") in ("hb", "ready") and self.on_membership:
            self.on_membership()

    def _on_death(self, replica: Replica, orphans: list) -> None:
        """Reader-thread EOF (or monitor eviction): drop the member,
        hand its in-flight requests back for redispatch, re-spawn."""
        with self._lock:
            if replica in self._members:
                self._members.remove(replica)
                self.evictions += 1
                if self.respawn and not self._stopping:
                    self._members.append(self._spawn_locked())
                    self.respawns += 1
        if self.on_membership:
            self.on_membership()
        if orphans and self.on_orphans:
            self.on_orphans(orphans)

    def _monitor_loop(self) -> None:
        """Slow-path health: a replica whose process died without pipe
        EOF, or whose heartbeats stopped (hung), is evicted here."""
        while True:
            with self._lock:
                if self._stopping:
                    return
                members = list(self._members)
            now = time.monotonic()
            for r in members:
                if not r.alive:
                    continue
                hung = r.ready and now - r.last_hb > self.hb_timeout_s
                if r.proc.poll() is not None or hung:
                    if hung:
                        r.kill()
                    r._mark_dead()
            time.sleep(self.hb_s)

    # -------------------------------------------------------------- state
    def members(self, ready_only: bool = True) -> list[Replica]:
        with self._lock:
            return [r for r in self._members
                    if r.alive and (r.ready or not ready_only)]

    def max_lsn(self) -> int:
        return max([r.lsn for r in self.members()] or [-1])

    def warm(self, queries, timeout_s: float = 600.0) -> None:
        """Broadcast a warm pool (each replica answers it once, compiling
        its serving shapes); blocks until every live replica confirms."""
        wire = [[int(u), int(v), pat.unparse(p)] for u, v, p in queries]
        waiting = {}
        ev = threading.Event()

        def on_warmed(replica, msg):
            if msg.get("ev") == "warmed":
                waiting.pop(id(replica), None)
                if not waiting:
                    ev.set()

        members = self.members()
        restore = {}
        for r in members:
            waiting[id(r)] = r
            prev = restore[id(r)] = r._on_event

            def chained(rep, msg, prev=prev):
                if prev:
                    prev(rep, msg)
                on_warmed(rep, msg)
            r._on_event = chained
            r.send({"op": "warm", "qs": wire})
        deadline = time.monotonic() + timeout_s
        while waiting and time.monotonic() < deadline:
            # a replica dying mid-warm must not hang the fleet
            for key, r in list(waiting.items()):
                if not r.alive:
                    waiting.pop(key, None)
            if ev.wait(0.1):
                break
        for r in members:
            r._on_event = restore[id(r)]


# ------------------------------------------------------------ CLI worker
def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--replica", metavar="DIR", required=True,
                    help="shared fleet store to follow")
    ap.add_argument("--device", default="cuda",
                    help="where the replica serves (default: the card; it "
                         "raises without one)")
    ap.add_argument("--backend", default=None)
    ap.add_argument("--poll", type=float, default=0.02,
                    help="log tail poll interval (s)")
    ap.add_argument("--hb", type=float, default=0.25,
                    help="heartbeat interval (s)")
    args = ap.parse_args()
    replica_worker(args.replica, args.backend, args.poll, args.hb,
                   args.device)


if __name__ == "__main__":
    main()
